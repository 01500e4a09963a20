"""Cues that one tube label is really two, and where to put the cut.

Used by ``branch_split`` (:mod:`.branch`), after its component re-watershed:

- :func:`link_cut_change` cuts a label where the overlap of consecutive
  sections drops well below the overlaps around it: a tracklet that was
  linked to the wrong tube;
- :func:`confident_parallel_split` finds a tube that enters a larger host
  label and a tube that leaves it again within a short gap, in line and of
  the same calibre, and carves the hidden stretch out of the host slice by
  slice (:func:`split_pair`), declining wherever the carve degenerates.

:func:`sustained_area_bump` is analytics only: it reports runs of sections
whose area stands above the label's running median, away from its tapered
ends. The gates' defaults are the validated ones of the upstream reference
(below); every gate can be passed as a keyword, so small volumes can be
tested. Sections are the (Y, X) planes of a (Z, Y, X) label volume.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
from scipy import ndimage

from ..ops.native import watershed

# Validated gates of the upstream reference's split machinery
# (``connectomics/decoding/decoders/branch/split.py:79-90``).
# The change-point cut:
DROP_THR = 0.25  # dip below the median of the neighbouring seams
W = 4  # seams on each side of a seam that form its neighbourhood
MIN_SIZE = 10000  # voxels of a label worth cutting
MIN_SPAN = 20  # z extent of a label worth cutting
MIN_FRAG = 6  # present sections between cuts and from the ends
RECOVER = 0.4  # IoU two sections apart above which a dip is one bad section
# The containment pair:
CAND_MIN = 500  # voxels of a candidate tube (or CAND_SPAN sections)
CAND_SPAN = 8
HOST_MIN = 20000  # voxels of a host
IOMIN_HI = 0.6  # end section's overlap over the smaller area, at least
IOMAX_LO = 0.7  # and over the larger area, at most
MAX_SHIFT = 6  # centring shift of a section, voxels
MAX_GAP = 40  # sections between the two tubes' ends
CAL_RATIO = 2.2  # end areas' ratio, at most
COLLINEAR_NM = 900  # extrapolated centroids' offset at the gap's middle
TUBE_THR = 0.7  # median shifted IoU along a tube
STEP_LO = 0.4  # host's area step at a seam, in calibres
STEP_HI = 2.0
MIN_END_AREA = 50  # voxels of a tube's end section
# The carve:
ANCHOR_NM = 150  # waypoint's distance from the tubes' line
DRIFT_HI = 1.6  # carved area of a section, in calibres, at most
RES_NM = 9.0  # in-plane nm a voxel that the nm gates assume

_CARVE_GATES = {"drift_hi", "anchor_nm", "res_nm"}
_DETECT_GATES = {"cand_min", "cand_span", "host_min", "iomin_hi", "iomax_lo", "max_shift", "max_gap", "cal_ratio",
                 "collinear_nm", "tube_thr", "step_lo", "step_hi", "min_end_area", "res_nm"}


def seg_stats(seg: np.ndarray):
    """({label: (z0, z1, y0, y1, x0, x1)} inclusive boxes, {label: voxels})."""
    from .branch import _instance_stats

    return _instance_stats(seg)


# -- section geometry --------------------------------------------------------------


def _centroid(mask: np.ndarray) -> np.ndarray:
    return np.array(ndimage.center_of_mass(mask))


def _aligned(ref: np.ndarray, mov: np.ndarray, max_shift: int) -> np.ndarray:
    """``mov`` rolled so its centroid meets ``ref``'s, each axis's shift
    rounded and clamped to +-``max_shift``."""
    offset = np.clip(np.rint(_centroid(ref) - _centroid(mov)), -max_shift, max_shift).astype(int)
    return np.roll(mov, (int(offset[0]), int(offset[1])), axis=(0, 1))


def shifted_iou(a, b, *, max_shift: int = 5) -> float:
    """IoU of two section masks after centring ``b`` on ``a``; 0 if either is empty."""
    if not (a.any() and b.any()):
        return 0.0
    moved = _aligned(a, b, max_shift)
    return float(np.count_nonzero(a & moved) / max(np.count_nonzero(a | moved), 1))


def shifted_iomm(a, b, *, max_shift: int = 5) -> Tuple[float, float]:
    """(overlap over the smaller area, overlap over the larger) of two section
    masks after centring ``b`` on ``a``."""
    if not (a.any() and b.any()):
        return 0.0, 0.0
    overlap = float(np.count_nonzero(a & _aligned(a, b, max_shift)))
    small, large = sorted((int(a.sum()), int(b.sum())))
    return overlap / max(small, 1), overlap / max(large, 1)


def _pair_iou(first: np.ndarray, second: np.ndarray) -> np.ndarray:
    """IoU of stacks of masks, pair by pair along axis 0."""
    inter = np.count_nonzero(first & second, axis=(1, 2))
    union = np.count_nonzero(first | second, axis=(1, 2))
    return inter / np.maximum(union, 1)


# -- the change-point cut ------------------------------------------------------------


def _dips(iou: np.ndarray, skip_iou: np.ndarray, w: int, drop_thr: float, recover: float) -> List[Tuple[float, int]]:
    """(drop, index of the section after the seam) for every seam whose IoU
    is a local minimum lying ``drop_thr`` below the median of the ``w`` seams
    on each side, unless the sections on either side of the seam's later
    section still overlap by more than ``recover`` (``skip_iou``)."""
    n = len(iou)
    found = []
    for i in range(n):
        window = np.delete(iou[max(0, i - w):i + w + 1], min(i, w))
        if window.size == 0:
            continue
        drop = float(np.median(window)) - iou[i]
        left_ok = i == 0 or iou[i] <= iou[i - 1]
        right_ok = i == n - 1 or iou[i] <= iou[i + 1]
        if drop > drop_thr and left_ok and right_ok and not (i < len(skip_iou) and skip_iou[i] > recover):
            found.append((drop, i + 1))
    return found


def _spaced(dips: List[Tuple[float, int]], count: int, min_frag: int) -> List[int]:
    """Cut positions, deepest dip first (ties: the later one), each at least
    ``min_frag`` present sections from both ends and from every cut taken."""
    taken: List[int] = []
    for _, pos in sorted(dips, reverse=True):
        if min(pos, count - pos) >= min_frag and all(abs(pos - t) >= min_frag for t in taken):
            taken.append(pos)
    return taken


def link_cut_change(seg: np.ndarray, *, drop_thr: float = DROP_THR, w: int = W, min_size: int = MIN_SIZE,
                    min_span: int = MIN_SPAN, min_frag: int = MIN_FRAG, recover: float = RECOVER, stats=None,
                    inplace: bool = False) -> Tuple[np.ndarray, int]:
    """Cuts mis-linked tracklets: in each label of ``min_size`` voxels and
    ``min_span`` sections, the IoU of each present section with the next is
    tested as a change point (:func:`_dips`, :func:`_spaced`); every accepted
    cut starts a new label at its section, labels numbered on from the
    volume's largest id. ``stats`` is :func:`seg_stats` of ``seg`` where the
    caller has it. Returns (labels, cuts made)."""
    bounds, sizes = seg_stats(seg) if stats is None else stats
    seg = seg if inplace else np.array(seg, dtype=np.uint32, copy=True)
    cuts_made, next_id = 0, int(seg.max()) + 1
    for label, (z0, z1, y0, y1, x0, x1) in bounds.items():
        if label <= 0 or sizes.get(label, 0) < min_size or z1 - z0 + 1 < min_span:
            continue
        view = seg[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1]
        mine = view == label
        present = np.flatnonzero(mine.any(axis=(1, 2)))
        if len(present) < 2 * w + 2:
            continue
        stack = mine[present]
        cuts = _spaced(_dips(_pair_iou(stack[:-1], stack[1:]), _pair_iou(stack[:-2], stack[2:]), w, drop_thr,
                             recover), len(present), min_frag)
        if not cuts:
            continue
        piece = np.zeros(len(mine), np.int64)
        piece[present[cuts]] = 1
        piece = np.cumsum(piece)
        for zi in np.flatnonzero(piece):
            view[zi][mine[zi]] = next_id + piece[zi] - 1
        next_id += len(cuts)
        cuts_made += len(cuts)
    return seg, cuts_made


# -- the area bump (analytics) -------------------------------------------------------


def _true_runs(flags: np.ndarray) -> Iterator[Tuple[int, int]]:
    """(start, stop) of each run of True in a 1-D boolean array."""
    edges = np.diff(np.concatenate([[0], flags.astype(np.int8), [0]]))
    return zip(np.flatnonzero(edges == 1), np.flatnonzero(edges == -1))


def sustained_area_bump(seg: np.ndarray, *, ratio: float = 1.5, min_run: int = 3, taper: int = 5, w: int = 8,
                        min_size: int = CAND_MIN, min_span: int = MIN_SPAN, stats=None) -> List[Dict]:
    """Runs of at least ``min_run`` sections whose area is ``ratio`` times
    the median of the ``w`` sections on each side, among a label's present
    sections less ``taper`` at each end (ends taper naturally). Events
    ``{label, z_start, z_end, peak_ratio}``; nothing is cut."""
    events: List[Dict] = []
    bounds, sizes = seg_stats(seg) if stats is None else stats
    for label, (z0, z1, y0, y1, x0, x1) in bounds.items():
        if label <= 0 or sizes.get(label, 0) < min_size or z1 - z0 + 1 < max(min_span, 2 * taper + min_run):
            continue
        areas = np.count_nonzero(seg[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1] == label, axis=(1, 2))
        present = np.flatnonzero(areas)
        if len(present) < 2 * taper + min_run:
            continue
        inner = present[taper:len(present) - taper]
        area = areas[inner].astype(np.float64)
        rel = np.empty(len(area))
        for k in range(len(area)):
            around = np.delete(area[max(0, k - w):k + w + 1], min(k, w))
            rel[k] = area[k] / max(float(np.median(around)) if around.size else area[k], 1.0)
        for start, stop in _true_runs(rel >= ratio):
            if stop - start >= min_run:
                events.append(dict(label=int(label), z_start=int(z0 + inner[start]), z_end=int(z0 + inner[stop - 1]),
                                   peak_ratio=float(max(0.0, rel[start:stop].max()))))
    return events


# -- the containment pair --------------------------------------------------------------


def _tubeness(seg, label, box, max_shift, cache) -> float:
    """Median shifted IoU of a label's consecutive present sections, in its
    box padded by ``max_shift`` + 1 (clipped to the volume)."""
    if label not in cache:
        z0, z1, y0, y1, x0, x1 = box
        pad = max_shift + 1
        window = seg[z0:z1 + 1, max(y0 - pad, 0):min(y1 + 1 + pad, seg.shape[1]),
                     max(x0 - pad, 0):min(x1 + 1 + pad, seg.shape[2])] == label
        stack = window[window.any(axis=(1, 2))]
        ious = [shifted_iou(stack[i], stack[i + 1], max_shift=max_shift) for i in range(len(stack) - 1)]
        cache[label] = float(np.median(ious)) if ious else 0.0
    return cache[label]


def _drift(seg, label, z_end, step, box, n: int = 5) -> np.ndarray:
    """The centroid's (dy, dx) per +1 z over the last ``n`` sections of a
    label towards its end ``z_end`` (``step`` +1 at its top, -1 at its
    bottom); zero with fewer than two sections."""
    track = []
    for z in range(z_end, z_end - step * n, -step):
        if box[0] <= z <= box[1]:
            m = seg[z] == label
            if m.any():
                track.append((z, *ndimage.center_of_mass(m)))
    if len(track) < 2:
        return np.zeros(2)
    first, last = np.array(track[0]), np.array(track[-1])
    dz = first[0] - last[0]
    return (first[1:] - last[1:]) / (dz if dz else 1)


def _end_events(seg, bounds, sizes, gates):
    """The ends of candidate tubes that sink into a host, by host:
    ({host: [(tube, z_end, centroid, area, drift)]} for upper ends, the
    same for lower ends)."""
    depth = seg.shape[0]
    tops, bottoms = defaultdict(list), defaultdict(list)
    tube_cache: Dict[int, float] = {}
    for label, box in bounds.items():
        span = box[1] - box[0] + 1
        if label <= 0 or span < 2 or (sizes.get(label, 0) < gates["cand_min"] and span < gates["cand_span"]):
            continue
        for z_end, step, into in ((box[1], 1, tops), (box[0], -1, bottoms)):
            beyond = z_end + step
            if not 0 <= beyond < depth:
                continue
            end = seg[z_end] == label
            area = int(end.sum())
            if area < gates["min_end_area"]:
                continue
            under, counts = np.unique(seg[beyond][end], return_counts=True)
            keep = (under > 0) & (under != label)
            if not keep.any():
                continue
            host = int(under[keep][np.argmax(counts[keep])])
            if sizes.get(host, 0) < gates["host_min"]:
                continue
            over_min, over_max = shifted_iomm(end, seg[beyond] == host, max_shift=gates["max_shift"])
            if over_min < gates["iomin_hi"] or over_max > gates["iomax_lo"]:
                continue
            if _tubeness(seg, label, box, gates["max_shift"], tube_cache) < gates["tube_thr"]:
                continue
            into[host].append((label, z_end, _centroid(end), area, _drift(seg, label, z_end, step, box)))
    return tops, bottoms


def _host_step_ok(seg, host, z_in, z_out, calibre, lo, hi) -> bool:
    """The host's area grows by about a tube's calibre (``lo``..``hi``
    times) from section ``z_out`` to ``z_in``."""
    grow = int(np.count_nonzero(seg[z_in] == host)) - int(np.count_nonzero(seg[z_out] == host))
    return lo <= grow / calibre <= hi


def detect_confident(seg: np.ndarray, bounds, sizes, *, host_both: bool = False, cand_min: int = CAND_MIN,
                     cand_span: int = CAND_SPAN, host_min: int = HOST_MIN, iomin_hi: float = IOMIN_HI,
                     iomax_lo: float = IOMAX_LO, max_shift: int = MAX_SHIFT, max_gap: int = MAX_GAP,
                     cal_ratio: float = CAL_RATIO, collinear_nm: float = COLLINEAR_NM, tube_thr: float = TUBE_THR,
                     step_lo: float = STEP_LO, step_hi: float = STEP_HI, min_end_area: int = MIN_END_AREA,
                     res_nm: float = RES_NM) -> List[Dict]:
    """Pairs of a tube S1 whose upper end sinks into a host H (overlap over
    the smaller area at least ``iomin_hi``, over the larger at most
    ``iomax_lo``: a branch entering, not a continuation; S1's tubeness at
    least ``tube_thr``) and a tube S2 that rises out of H 1..``max_gap``
    sections higher, with areas within ``cal_ratio``, centroids extrapolated
    to the gap's middle within ``collinear_nm``, H present below the gap or
    above it (both with ``host_both``) and H's area stepping by
    ``step_lo``..``step_hi`` calibres at each seam where it is. One pair a
    tube pair, the most collinear; sorted by that offset. Candidates: labels
    of ``cand_min`` voxels or ``cand_span`` sections whose end section has
    ``min_end_area`` voxels; hosts of ``host_min`` voxels."""
    gates = dict(cand_min=cand_min, cand_span=cand_span, host_min=host_min, iomin_hi=iomin_hi, iomax_lo=iomax_lo,
                 max_shift=max_shift, tube_thr=tube_thr, min_end_area=min_end_area)
    tops, bottoms = _end_events(seg, bounds, sizes, gates)
    chosen: Dict[Tuple[int, int], Dict] = {}
    for host in set(tops) & set(bottoms):
        host_z0, host_z1 = bounds[host][0], bounds[host][1]
        for s1, z1, c1, a1, v1 in tops[host]:
            for s2, z2, c2, a2, v2 in bottoms[host]:
                if s1 == s2 or not 1 <= z2 - z1 <= max_gap or not 1 / cal_ratio <= a1 / max(a2, 1) <= cal_ratio:
                    continue
                mid = (z1 + z2) / 2
                p1, p2 = c1 + v1 * (mid - z1), c2 + v2 * (mid - z2)
                gap_yx = (p1 - p2) * res_nm
                off = float(np.hypot(gap_yx[0], gap_yx[1]))
                if off > collinear_nm:
                    continue
                below, above = host_z0 < z1 - 1, host_z1 > z2 + 1
                if not (below and above if host_both else below or above):
                    continue
                calibre = 0.5 * (a1 + a2)
                if below and not _host_step_ok(seg, host, z1 + 1, z1, calibre, step_lo, step_hi):
                    continue
                if above and not _host_step_ok(seg, host, z2 - 1, z2, calibre, step_lo, step_hi):
                    continue
                key = (min(s1, s2), max(s1, s2))
                if key not in chosen or off < chosen[key]["off"]:
                    chosen[key] = dict(H=host, S1=s1, S2=s2, z1=z1, z2=z2, c1=c1, c2=c2, a1=a1, a2=a2, off=off,
                                       cal=calibre)
    return sorted(chosen.values(), key=lambda pair: pair["off"])


# -- the two-sided carve ------------------------------------------------------------------


def gather_anchors(seg, f, bounds, sizes, *, anchor_nm: float = ANCHOR_NM, res_nm: float = RES_NM,
                   min_area: int = 50):
    """Waypoints inside the gap of a pair ``f`` of :func:`detect_confident`:
    on each section between its ends, the small label (at most 4 calibres of
    voxels, ``min_area``..2 calibres on the section; not H, S1 or S2) whose
    centroid lies nearest the straight S1-S2 line, within ``anchor_nm``.
    Returns ({z: centroid}, ends included, in z order; the labels used)."""
    z1, z2, c1, c2 = f["z1"], f["z2"], f["c1"], f["c2"]
    skip = {f["H"], f["S1"], f["S2"]}
    anchors = {z1: c1, z2: c2}
    used: Set[int] = set()
    for z in range(z1 + 1, z2):
        on_line = c1 + (c2 - c1) * ((z - z1) / max(z2 - z1, 1))
        nearest: Optional[Tuple[float, np.ndarray, int]] = None
        for label in np.unique(seg[z]).tolist():
            if label <= 0 or label in skip or sizes.get(label, 0) > 4 * f["cal"]:
                continue
            m = seg[z] == label
            if not min_area <= int(m.sum()) <= 2 * f["cal"]:
                continue
            c = _centroid(m)
            dist = float(np.hypot((c[0] - on_line[0]) * res_nm, (c[1] - on_line[1]) * res_nm))
            if dist <= anchor_nm and (nearest is None or dist < nearest[0]):
                nearest = (dist, c, label)
        if nearest is not None:
            anchors[z] = nearest[1]
            used.add(nearest[2])
    return dict(sorted(anchors.items())), used


def _centre_line(anchors: Dict[int, np.ndarray], z: int) -> np.ndarray:
    """The piecewise-linear path through the anchors at section ``z``
    (held at the first and last anchor outside them)."""
    zs = sorted(anchors)
    if z >= zs[-1]:
        return anchors[zs[-1]]
    i = int(np.searchsorted(zs, z))
    if i == 0:
        return anchors[zs[0]]
    za, zb = zs[i - 1], zs[i]
    return anchors[za] + (anchors[zb] - anchors[za]) * ((z - za) / (zb - za))


def _carve_section(host: np.ndarray, seed: np.ndarray) -> Tuple[np.ndarray, Tuple[slice, slice]]:
    """The tube's part of one host section: a two-marker watershed on the
    host's negated distance transform, the tube's marker the seed grown by
    one ring, the host's everything three rings or more away; the largest
    component of the tube's basin. Returns (mask, its crop of the section);
    an empty mask where a marker is empty."""
    ys, xs = np.flatnonzero(host.any(axis=1)), np.flatnonzero(host.any(axis=0))
    crop = (slice(max(int(ys[0]) - 3, 0), min(int(ys[-1]) + 4, host.shape[0])),
            slice(max(int(xs[0]) - 3, 0), min(int(xs[-1]) + 4, host.shape[1])))
    inside, core = host[crop], seed[crop]
    tube_marker = inside & ndimage.binary_dilation(core, iterations=1)
    host_marker = inside & ~ndimage.binary_dilation(core, iterations=3)
    tube_marker &= ~host_marker
    if not (tube_marker.any() and host_marker.any()):
        return np.zeros(inside.shape, bool), crop
    markers = np.where(tube_marker, 1, np.where(host_marker, 2, 0)).astype(np.uint32)
    energy = -ndimage.distance_transform_edt(inside).astype(np.float32)
    basin = watershed(energy[None], markers[None], mask=inside[None])[0] == 1
    parts, n = ndimage.label(basin)
    if n > 1:
        basin = parts == int(np.bincount(parts.ravel())[1:].argmax()) + 1
    return basin, crop


def split_pair(seg, f, bounds, sizes, *, drift_hi: float = DRIFT_HI, anchor_nm: float = ANCHOR_NM,
               res_nm: float = RES_NM) -> int:
    """Carves the pair ``f`` apart in place: S1's last section (eroded once
    where that leaves anything) is moved along the anchors' centre line
    onto each gap section that holds no anchor and cut out of H there
    (:func:`_carve_section`; a point grown two rings where the moved section
    misses H). The carved voxels, the anchors' labels and S2 become S1.
    Declines, changing nothing, when H is missing from a section, a seed or
    marker is empty, or a carve exceeds ``drift_hi`` calibres; also when
    there is nothing to carve and no anchor. Returns the sections carved (1
    for a join without carving), 0 when it declined."""
    s1, host, z1, z2, calibre = f["S1"], f["H"], f["z1"], f["z2"], f["cal"]
    anchors, anchor_labels = gather_anchors(seg, f, bounds, sizes, anchor_nm=anchor_nm, res_nm=res_nm)
    start = seg[z1] == s1
    template = ndimage.binary_erosion(start)
    if not template.any():
        template = start
    origin = _centroid(template)
    carved = []
    for z in range(z1 + 1, z2):
        if z in anchors:
            continue
        h = seg[z] == host
        if not h.any():
            return 0
        centre = _centre_line(anchors, z)
        dy, dx = (int(v) for v in np.rint(centre - origin))
        seed = np.roll(template, (dy, dx), axis=(0, 1)) & h
        if not seed.any():
            cy, cx = (int(v) for v in np.rint(centre))
            if 0 <= cy < h.shape[0] and 0 <= cx < h.shape[1] and h[cy, cx]:
                seed[cy, cx] = True
                seed = ndimage.binary_dilation(seed, iterations=2) & h
            if not seed.any():
                return 0
        basin, crop = _carve_section(h, seed)
        if not basin.any() or int(basin.sum()) > drift_hi * calibre:
            return 0
        cut = np.zeros(h.shape, bool)
        cut[crop] = basin
        carved.append((z, cut))
    if not carved and not anchor_labels:
        return 0
    for z, cut in carved:
        seg[z][cut] = s1
    seg[np.isin(seg, list(anchor_labels | {f["S2"]}))] = s1
    return len(carved) or 1


def confident_parallel_split(seg: np.ndarray, *, host_both: bool = False, stats=None, inplace: bool = False,
                             **gates) -> Tuple[np.ndarray, int, List[Dict]]:
    """Detects containment pairs (:func:`detect_confident`) and carves them
    (:func:`split_pair`), most collinear first, each tube in at most one
    carve and no host that was itself carved as a tube. ``gates``: the
    keywords of those two. Returns (labels, pairs carved, pairs found)."""
    unknown = set(gates) - _CARVE_GATES - _DETECT_GATES
    if unknown:
        raise TypeError(f"unknown gate(s) {sorted(unknown)}")
    bounds, sizes = seg_stats(seg) if stats is None else stats
    seg = seg if inplace else np.array(seg, dtype=np.uint32, copy=True)
    pairs = detect_confident(seg, bounds, sizes, host_both=host_both,
                             **{k: v for k, v in gates.items() if k in _DETECT_GATES})
    carve = {k: v for k, v in gates.items() if k in _CARVE_GATES}
    done: Set[int] = set()
    n = 0
    for pair in pairs:
        if done & {pair["S1"], pair["S2"], pair["H"]}:
            continue
        if split_pair(seg, pair, bounds, sizes, **carve):
            done |= {pair["S1"], pair["S2"]}
            n += 1
    return seg, n, pairs
