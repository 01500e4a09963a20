"""The branch suite: post-processing of tube-like instances (axons, fibers)
on the host. The port of ``pytorch_connectomics_tpu/decoding/branch.py``:

- per-section analytics (:func:`section_components`,
  :func:`multi_component_sections`);
- ``branch_split``: under-segmented tubes split by the cue ladder (the
  component re-watershed here, the IoU change-point cut and the
  containment carve of :mod:`.branch_cues`);
- ``branch_merge``: over-segmented tubes joined by fragment completion,
  mutual-best IoU at z seams and velocity-projected bridging of weak gaps;
- ``branch_extend``, ``seg_2d`` (per-section components), ``branch_link``
  (sections linked into tracklets) and ``longrange_guided_split``.

Labels are (Z, Y, X); affinities (C, Z, Y, X) in x, y, z channel order,
each stored at its high-end voxel, so the z affinity is channel 2.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from ..ops.native import binary_dilation, binary_erosion, connected_components, remap, remove_small, renumber, watershed
from .registry import register_decoder

Box = Tuple[int, int, int, int, int, int]


def _volume(labels) -> np.ndarray:
    lab = np.asarray(labels)
    return (lab[0] if lab.ndim == 4 else lab).astype(np.uint32)


# -- section analytics ---------------------------------------------------------


def section_components(labels: np.ndarray) -> List[Dict[int, int]]:
    """Per z section: {instance id: its count of 2-D components}."""
    out = []
    for sec in labels:
        out.append({int(iid): int(ndimage.label(sec == iid)[1]) for iid in np.unique(sec) if iid != 0})
    return out


def multi_component_sections(labels: np.ndarray) -> Dict[int, List[int]]:
    """Instance -> the z sections where it has more than one 2-D component
    (the mark of a merge of two tubes)."""
    out: Dict[int, List[int]] = {}
    for z, counts in enumerate(section_components(labels)):
        for iid, n in counts.items():
            if n > 1:
                out.setdefault(iid, []).append(z)
    return out


# -- branch_split ------------------------------------------------------------------


def component_split(lab: np.ndarray, energy: Optional[np.ndarray] = None, min_size: int = 50) -> np.ndarray:
    """An instance with several 2-D components in a section is re-seeded
    from the 3-D components of its core (eroded once) and regrown by
    watershed (on ``energy``, else on its outside) inside its mask; pieces
    of ``min_size`` voxels or more take new ids in seed order, smaller ones
    keep the instance's id."""
    suspects = multi_component_sections(lab)
    if not suspects:
        return lab
    out = lab.copy()
    next_id = int(lab.max()) + 1
    for iid in suspects:
        m = lab == iid
        core, n = connected_components(binary_erosion(m, 1), 6)
        if n < 2:
            continue
        e = energy if energy is not None else (~m).astype(np.float32)
        grown = watershed(np.ascontiguousarray(e, np.float32), core, mask=m)
        for k in range(1, n + 1):
            piece = grown == k
            if piece.sum() < min_size:
                out[piece] = iid
            else:
                out[piece] = next_id
                next_id += 1
    return out


@register_decoder("branch_split")
def branch_split(labels, energy: Optional[np.ndarray] = None, min_size: int = 50, component: bool = True,
                 link_cut: bool = True, confident: bool = True, drop_thr: float = 0.25, w: int = 4,
                 link_min_size: int = 10000, min_frag: int = 6, recover: float = 0.4, host_both: bool = False,
                 gates: Optional[Dict] = None, **kw):
    """The split cues in order: the component re-watershed
    (:func:`component_split`), the IoU change-point cut
    (:func:`.branch_cues.link_cut_change`; ``drop_thr``, ``w``,
    ``link_min_size``, ``min_frag``, ``recover``) and the one-sided
    containment carve (:func:`.branch_cues.confident_parallel_split`;
    ``gates`` overrides its thresholds), each switchable; then renumbered."""
    from . import branch_cues

    out = _volume(labels).copy()
    if component:
        out = component_split(out, energy, min_size)
    if link_cut:
        out, _ = branch_cues.link_cut_change(out, drop_thr=drop_thr, w=w, min_size=link_min_size,
                                             min_frag=min_frag, recover=recover, inplace=True)
    if confident:
        out, _, _ = branch_cues.confident_parallel_split(out, host_both=host_both, inplace=True, **(gates or {}))
    out, _ = renumber(out)
    return out


# -- branch_merge ------------------------------------------------------------------


def _instance_stats(lab: np.ndarray) -> Tuple[Dict[int, Box], Dict[int, int]]:
    """{id: (z0, z1, y0, y1, x0, x1)} inclusive boxes and {id: voxels}, in id order."""
    counts = np.bincount(lab.ravel())
    bounds: Dict[int, Box] = {}
    sizes: Dict[int, int] = {}
    for iid, sl in enumerate(ndimage.find_objects(lab), start=1):
        if sl is not None:
            bounds[iid] = (sl[0].start, sl[0].stop - 1, sl[1].start, sl[1].stop - 1, sl[2].start, sl[2].stop - 1)
            sizes[iid] = int(counts[iid])
    return bounds, sizes


def _apply_union(lab: np.ndarray, parent: np.ndarray) -> np.ndarray:
    """Relabels through a parent table, following it three steps."""
    for _ in range(3):
        parent = parent[parent]
    return parent[lab]


def _grow2d(m: np.ndarray) -> np.ndarray:
    """A section mask dilated by one 4-connected ring."""
    return binary_dilation(m[None], 1)[0]


def complete_fragments(lab: np.ndarray, min_size: int = 80, zfrag_iou: float = 0.3) -> np.ndarray:
    """Each instance under ``min_size`` voxels or at most two sections thick
    joins the large instance it touches most in its sections (ties: the one
    met first), else the large instance on the slice beyond either z end
    whose IoU with its end section (over that instance's whole slice area)
    is best and above ``zfrag_iou``."""
    bounds, sizes = _instance_stats(lab)
    lut = np.arange(int(lab.max()) + 1, dtype=np.uint32)
    for iid, (z0, z1, y0, y1, x0, x1) in bounds.items():
        if sizes[iid] >= min_size and z1 - z0 + 1 > 2:
            continue
        wy, wx = slice(max(y0 - 1, 0), y1 + 2), slice(max(x0 - 1, 0), x1 + 2)
        contact: Counter = Counter()
        for z in range(z0, z1 + 1):
            win = lab[z, wy, wx]
            m = win == iid
            if not m.any():
                continue
            rim = win[_grow2d(m) & ~m]
            for nb in np.unique(rim):
                if nb > 0 and nb != iid and sizes.get(int(nb), 0) >= min_size:
                    contact[int(nb)] += int((rim == nb).sum())
        if contact:
            lut[iid] = contact.most_common(1)[0][0]
            continue
        best = None
        for end_z, adj_z in ((z0, z0 - 1), (z1, z1 + 1)):
            if not 0 <= adj_z < lab.shape[0]:
                continue
            m = lab[end_z, wy, wx] == iid
            if not m.any():
                continue
            adj = lab[adj_z, wy, wx]
            area = int(m.sum())
            for nb in np.unique(adj[_grow2d(m)]):
                nb = int(nb)
                if nb <= 0 or nb == iid or sizes.get(nb, 0) < min_size:
                    continue
                inter = int((m & (adj == nb)).sum())
                iou = inter / max(area + int((lab[adj_z] == nb).sum()) - inter, 1)
                if iou > zfrag_iou and (best is None or iou > best[0]):
                    best = (iou, nb)
        if best:
            lut[iid] = best[1]
    return _apply_union(lab, lut)


def _join_mutual(lab: np.ndarray, up: Dict[int, int], down: Dict[int, int]) -> Tuple[np.ndarray, int]:
    """Unites each a -> b of ``up`` whose ``down`` choice is a (the smaller
    root wins) -> (relabelled volume, merges)."""
    parent = np.arange(int(lab.max()) + 1, dtype=np.uint32)

    def root(i: int) -> int:
        while parent[i] != i:
            i = int(parent[i])
        return i

    merged = 0
    for a, b in up.items():
        if down.get(b) == a:
            ra, rb = root(a), root(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
                merged += 1
    return (_apply_union(lab, parent) if merged else lab), merged


def merge_mutual_iou(lab: np.ndarray, aff_z: Optional[np.ndarray], merge_iou: float = 0.5, margin: float = 0.15,
                     aff_lo: float = 0.05, min_ov: int = 4, min_size: int = 80, rounds: int = 3) -> np.ndarray:
    """Joins instances across z seams by mutual best IoU. For each instance
    of ``min_size`` voxels, at each z end, the candidates on the next slice
    (within its box) touch the end section's one-ring growth in ``min_ov``
    voxels or more, have a mean seam z affinity above ``aff_lo`` there (when
    ``aff_z`` is given) and an IoU with the end section above ``merge_iou``;
    the best must beat the runner-up by ``margin``, and a pair joins when
    each is the other's choice. Up to ``rounds`` rounds, until one joins
    nothing."""
    z_size = lab.shape[0]
    for _ in range(rounds):
        bounds, sizes = _instance_stats(lab)
        up: Dict[int, int] = {}
        down: Dict[int, int] = {}
        for a in (i for i in bounds if sizes[i] >= min_size):
            z0, z1, y0, y1, x0, x1 = bounds[a]
            wy, wx = slice(y0, y1 + 1), slice(x0, x1 + 1)
            for end_z, adj_z, choice in ((z1, z1 + 1, up), (z0, z0 - 1, down)):
                if not 0 <= adj_z < z_size:
                    continue
                m = lab[end_z, wy, wx] == a
                if not m.any():
                    continue
                grown = _grow2d(m)
                adj = lab[adj_z, wy, wx]
                seam = None if aff_z is None else aff_z[max(end_z, adj_z), wy, wx]
                scored: List[Tuple[float, float, int]] = []
                for b in np.unique(adj[grown & (adj > 0)]):
                    b = int(b)
                    if b == a:
                        continue
                    bm = adj == b
                    touch = grown & bm
                    if int(touch.sum()) < min_ov:
                        continue
                    zaff = 1.0
                    if seam is not None:
                        zaff = float(seam[touch].mean())
                        if zaff <= aff_lo:
                            continue
                    iou = int((m & bm).sum()) / max(int((m | bm).sum()), 1)
                    if iou > merge_iou:
                        scored.append((iou, zaff, b))
                if not scored:
                    continue
                scored.sort(reverse=True)
                if len(scored) > 1 and scored[0][0] - scored[1][0] < margin:
                    continue  # ambiguous: a false merge costs more than a split
                choice[a] = scored[0][2]
        lab, merged = _join_mutual(lab, up, down)
        if not merged:
            break
    return lab


def _end_velocity(lab, iid, z_end, direction, bounds, n: int = 4) -> np.ndarray:
    """The centroid's drift (dy, dx per +1 z) over the last ``n`` sections
    towards a tube end."""
    z0, z1, y0, y1, x0, x1 = bounds[iid]
    pts = []
    for k in range(n):
        z = z_end - direction * k
        if z0 <= z <= z1:
            m = lab[z, y0:y1 + 1, x0:x1 + 1] == iid
            if m.any():
                pts.append((z, *ndimage.center_of_mass(m)))
    if len(pts) < 2:
        return np.zeros(2)
    arr = np.asarray(pts, float)
    dz = arr[0, 0] - arr[-1, 0]
    return (arr[0, 1:] - arr[-1, 1:]) / (dz if dz else 1.0)


def _bridge_choice(lab, a, z_end, direction, bounds, caliber, fg_max, max_gap, min_iou, weak_lo, cal_ratio, dim_tol):
    """The (best IoU, runner-up IoU, id) of :func:`bridge_weak_gaps` from one
    end of ``a``, or None."""
    m = lab[z_end] == a
    if not m.any():
        return None
    vel = _end_velocity(lab, a, z_end, direction, bounds)
    best, runner, dim = None, 0.0, 0
    for gap in range(1, max_gap + 1):
        z = z_end + direction * gap
        if not 0 <= z < lab.shape[0]:
            break
        # the drift is per +1 z; the slice lies direction * gap away
        proj = np.roll(np.roll(m, int(round(vel[0] * direction * gap)), 0), int(round(vel[1] * direction * gap)), 1)
        if fg_max is not None:
            vals = fg_max[z][proj]
            if vals.size and float(np.percentile(vals, 75)) < weak_lo:
                dim += 1
                if dim > dim_tol:
                    break
            else:
                dim = 0
        for b in np.unique(lab[z][proj]):
            b = int(b)
            cal_b = caliber.get(b)
            if b <= 0 or b == a or cal_b is None:
                continue
            if not 1.0 / cal_ratio <= caliber[a] / max(cal_b, 1e-6) <= cal_ratio:
                continue
            bm = lab[z] == b
            iou = int((proj & bm).sum()) / max(int((proj | bm).sum()), 1)
            if iou < min_iou:
                continue
            if best is None or iou > best[0]:
                runner = best[0] if best else runner
                best = (iou, b)
            elif iou > runner:
                runner = iou
        if best is not None:
            return best[0], runner, best[1]
    return None


def bridge_weak_gaps(lab: np.ndarray, fg_max: Optional[np.ndarray], max_gap: int = 4, min_iou: float = 0.3,
                     weak_lo: float = 0.15, cal_ratio: float = 3.0, margin: float = 0.1, min_size: int = 200,
                     dim_tol: int = 1, rounds: int = 2) -> np.ndarray:
    """Joins tubes across gaps of up to ``max_gap`` sections: an end section
    of each instance of ``min_size`` voxels is shifted along its centroid's
    drift onto each slice beyond, nearest first, and matched by IoU (at
    least ``min_iou``) against instances whose caliber (voxels a section)
    is within ``cal_ratio`` of its own; the search stops at the first slice
    with a match, or after more than ``dim_tol`` slices in a row whose
    foreground (``fg_max``) under the shifted mask has its 75th percentile
    below ``weak_lo``. The best must beat the runner-up by ``margin``, and a
    pair joins when each is the other's choice. Up to ``rounds`` rounds."""
    for _ in range(rounds):
        bounds, sizes = _instance_stats(lab)
        cands = [i for i in bounds if sizes[i] >= min_size]
        caliber = {i: sizes[i] / (bounds[i][1] - bounds[i][0] + 1) for i in cands}
        up: Dict[int, int] = {}
        down: Dict[int, int] = {}
        for a in cands:
            for z_end, direction, choice in ((bounds[a][1], 1, up), (bounds[a][0], -1, down)):
                got = _bridge_choice(lab, a, z_end, direction, bounds, caliber, fg_max, max_gap, min_iou, weak_lo,
                                     cal_ratio, dim_tol)
                if got is not None and got[0] - got[1] >= margin:
                    choice[a] = got[2]
        lab, merged = _join_mutual(lab, up, down)
        if not merged:
            break
    return lab


@register_decoder("branch_merge")
def branch_merge(labels, affinity: Optional[np.ndarray] = None, merge_iou: float = 0.5, margin: float = 0.15,
                 aff_lo: float = 0.05, min_ov: int = 4, min_size: int = 80, rounds: int = 3, weak_max_gap: int = 4,
                 weak_min_iou: float = 0.3, weak_lo: float = 0.15, weak_cal_ratio: float = 3.0,
                 weak_margin: float = 0.1, weak_min_size: int = 200, weak_rounds: int = 2,
                 min_overlap: Optional[int] = None, max_gap: Optional[int] = None, **kw):
    """Repairs over-segmented tubes: :func:`complete_fragments`,
    :func:`merge_mutual_iou` (on ``affinity``'s z channel, 2 of x, y, z) and
    :func:`bridge_weak_gaps` (on the max of its three channels; a 3-D
    ``affinity`` serves as both), then renumbered. ``min_overlap`` and
    ``max_gap`` are the older names of ``min_ov`` and ``weak_max_gap``."""
    lab = _volume(labels).copy()
    if min_overlap is not None:
        min_ov = min_overlap
    if max_gap is not None:
        weak_max_gap = max_gap
    aff_z = fg_max = None
    if affinity is not None:
        aff = np.asarray(affinity, np.float32)
        if aff.ndim == 4 and aff.shape[0] >= 3:
            aff_z, fg_max = aff[2], aff[:3].max(axis=0)
        elif aff.ndim == 3:
            aff_z = fg_max = aff
    lab = complete_fragments(lab, min_size=min_size)
    lab = merge_mutual_iou(lab, aff_z, merge_iou=merge_iou, margin=margin, aff_lo=aff_lo, min_ov=min_ov,
                           min_size=min_size, rounds=rounds)
    lab = bridge_weak_gaps(lab, fg_max, max_gap=weak_max_gap, min_iou=weak_min_iou, weak_lo=weak_lo,
                           cal_ratio=weak_cal_ratio, margin=weak_margin, min_size=weak_min_size, rounds=weak_rounds)
    lab, _ = renumber(lab)
    return lab


# -- branch_extend, seg_2d, branch_link ------------------------------------------------


@register_decoder("branch_extend")
def branch_extend(labels, probability: Optional[np.ndarray] = None, threshold: float = 0.3, iterations: int = 3,
                  **kw):
    """Tube ends grown by watershed on 1 - ``probability`` into unlabelled
    voxels above ``threshold`` that lie within ``iterations`` rings of the
    labels; without ``probability`` the labels as they are."""
    lab = _volume(labels)
    if probability is None:
        return lab
    prob = np.asarray(probability)
    if prob.ndim == 4:
        prob = prob[0]
    allowed = (prob > threshold) & (lab == 0)
    grown = watershed((1.0 - prob).astype(np.float32), lab.copy(), mask=(lab > 0) | allowed)
    reach = binary_dilation(lab > 0, iterations)
    return np.where((grown > 0) & ((lab > 0) | (allowed & reach)), grown, lab).astype(np.uint32)


@register_decoder("seg_2d")
def seg_2d(pred, threshold: float = 0.5, min_size: int = 0, **kw):
    """The 2-D components of each section (channel 0 above ``threshold``),
    numbered on from the last section's; with ``min_size``, smaller ones
    dropped and the rest renumbered."""
    p = np.asarray(pred)
    if p.ndim == 4:
        p = p[0]
    out = np.zeros(p.shape, np.uint32)
    offset = 0
    for z in range(p.shape[0]):
        cc, n = ndimage.label(p[z] > threshold)
        out[z] = np.where(cc > 0, cc.astype(np.uint32) + offset, 0)
        offset += n
    if min_size:
        out, _ = remove_small(out, min_size)
        out, _ = renumber(out)
    return out


@register_decoder("branch_link")
def branch_link(labels, min_iou: float = 0.3, max_gap: int = 1, **kw):
    """Links section components into tracklets: a component and one on each
    of the next ``max_gap`` sections that it overlaps join when their IoU is
    at least ``min_iou`` (the smaller root wins); then renumbered."""
    lab = _volume(labels)
    parent: Dict[int, int] = {}

    def root(a: int) -> int:
        parent.setdefault(a, a)
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for z in range(lab.shape[0] - 1):
        for gap in range(1, max_gap + 1):
            if z + gap >= lab.shape[0]:
                break
            a_sec, b_sec = lab[z], lab[z + gap]
            for a in np.unique(a_sec):
                if a == 0:
                    continue
                m = a_sec == a
                for b in np.unique(b_sec[m]):
                    if b == 0:
                        continue
                    bm = b_sec == b
                    inter = int((m & bm).sum())
                    union = int(m.sum() + bm.sum()) - inter
                    if union and inter / union >= min_iou:
                        ra, rb = root(int(a)), root(int(b))
                        if ra != rb:
                            parent[max(ra, rb)] = min(ra, rb)
    mapping = {i: root(i) for i in list(parent) if root(i) != i}
    if mapping:
        lab = remap(lab, mapping)
    lab, _ = renumber(lab)
    return lab


# -- long-range guided split -------------------------------------------------------


@register_decoder("longrange_guided_split")
def longrange_guided_split(labels, affinity: Optional[np.ndarray] = None, guide_seg: Optional[np.ndarray] = None,
                           long_range_channels: Sequence[int] = (3, 4, 5), threshold: float = 0.3,
                           min_size: int = 100, min_parent_voxels: int = 1000, min_seed_voxels: int = 200,
                           min_seed_overlap_voxels: int = 100, min_seed_guide_fraction: float = 0.25,
                           min_seeds_in_parent: int = 2, max_splits_per_parent: int = 8, min_child_voxels: int = 1,
                           report_dir: Optional[str] = None, **kw):
    """False merges split by long-range evidence. With ``guide_seg`` (a
    segmentation from long-range-aware affinities), see
    :func:`_guided_split_by_seg`. Else, with ``affinity``: voxels whose
    weakest long-range affinity (``long_range_channels``) is below
    ``threshold`` are cut points; an instance whose other voxels fall into
    several 6-connected pieces is regrown from them by watershed on 1 - that
    affinity, the largest piece keeping its id and the others of
    ``min_size`` voxels taking new ones."""
    if guide_seg is not None:
        return _guided_split_by_seg(labels, guide_seg, min_parent_voxels, min_seed_voxels, min_seed_overlap_voxels,
                                    min_seed_guide_fraction, min_seeds_in_parent, max_splits_per_parent,
                                    min_child_voxels, report_dir)
    lab = _volume(labels)
    if affinity is None:
        return lab
    lr = np.asarray(affinity)[list(long_range_channels)].min(axis=0)
    strong = ~(lr < threshold)
    out = lab.copy()
    next_id = int(lab.max()) + 1
    for iid in np.unique(lab):
        if iid == 0:
            continue
        m = lab == iid
        pieces, n = connected_components(m & strong, 6)
        if n < 2:
            continue
        grown = watershed((1.0 - lr).astype(np.float32), pieces, mask=m)
        sizes = np.bincount(grown.ravel())
        for rank, k in enumerate((np.argsort(sizes[1:])[::-1] + 1)[:n]):
            piece = grown == k
            if rank == 0 or piece.sum() < min_size:
                continue
            out[piece] = next_id
            next_id += 1
    out, _ = renumber(out)
    return out


def _guided_split_by_seg(primary, guide_seg, min_parent_voxels: int, min_seed_voxels: int,
                         min_seed_overlap_voxels: int, min_seed_guide_fraction: float, min_seeds_in_parent: int,
                         max_splits_per_parent: int, min_child_voxels: int,
                         report_dir: Optional[str] = None) -> np.ndarray:
    """Each guide label of ``min_seed_voxels`` becomes a seed of the primary
    label it overlaps most (at least ``min_seed_overlap_voxels`` and
    ``min_seed_guide_fraction`` of the guide label). A parent of
    ``min_parent_voxels`` with ``min_seeds_in_parent`` seeds (its
    ``max_splits_per_parent`` largest overlaps kept) is split by nearest seed
    (Euclidean) in its box: the largest child keeps its id, the others of
    ``min_child_voxels`` take new ones (rows of ``report_dir``'s
    ``longrange_guided_split.csv``). Then renumbered."""
    lab = _volume(primary).copy()
    guide = _volume(guide_seg)
    parent_sizes = np.bincount(lab.ravel())
    guide_bounds, guide_sizes = _instance_stats(guide)
    seeds_by_parent: Dict[int, List[Tuple[int, int]]] = {}
    for gid, gsize in guide_sizes.items():
        if gsize < min_seed_voxels:
            continue
        z0, z1, y0, y1, x0, x1 = guide_bounds[gid]
        box = (slice(z0, z1 + 1), slice(y0, y1 + 1), slice(x0, x1 + 1))
        under = lab[box][guide[box] == gid]
        under = under[under > 0]
        if under.size == 0:
            continue
        counts = np.bincount(under)
        pid = int(counts.argmax())
        overlap = int(counts[pid])
        if overlap >= min_seed_overlap_voxels and overlap / gsize >= min_seed_guide_fraction:
            seeds_by_parent.setdefault(pid, []).append((gid, overlap))
    rows = []
    next_id = int(lab.max()) + 1
    for pid, seeds in sorted(seeds_by_parent.items()):
        if len(seeds) < min_seeds_in_parent or int(parent_sizes[pid]) < min_parent_voxels:
            continue
        seeds = sorted(seeds, key=lambda s: -s[1])[:max_splits_per_parent]
        pmask = lab == pid
        box = ndimage.find_objects(pmask.astype(np.uint8))[0]
        pm = pmask[box]
        markers = np.zeros(pm.shape, np.int32)
        for k, (gid, _) in enumerate(seeds, start=1):
            markers[(guide[box] == gid) & pm] = k
        if not (markers > 0).any():
            continue
        _, idx = ndimage.distance_transform_edt(markers == 0, return_indices=True)
        nearest = markers[tuple(idx)]
        nearest[~pm] = 0
        child_sizes = np.bincount(nearest.ravel())
        for rank, k in enumerate(np.argsort(child_sizes[1:])[::-1] + 1):
            child = nearest == k
            n_vox = int(child.sum())
            if rank == 0 or n_vox < min_child_voxels:
                continue
            lab[box][child] = next_id
            rows.append((pid, seeds[k - 1][0], next_id, n_vox))
            next_id += 1
    if report_dir and rows:
        import csv
        from pathlib import Path

        out = Path(report_dir)
        out.mkdir(parents=True, exist_ok=True)
        with (out / "longrange_guided_split.csv").open("w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["parent_id", "guide_id", "new_id", "voxels"])
            writer.writerows(rows)
    lab, _ = renumber(lab)
    return lab
