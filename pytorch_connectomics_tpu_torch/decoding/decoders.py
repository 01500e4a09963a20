"""Built-in decoders of the port: prediction maps -> instance labels, on
the host through the native ops (``ops/native.py``). The port of every
decoder of ``pytorch_connectomics_tpu/decoding/decoders.py``; the branch
suite is in :mod:`.branch`.

Prediction layout: (C, Z, Y, X) float32 probabilities (after the channel
activations).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy import ndimage

from ..data.targets.affinity import parse_offsets
from ..ops.native import (
    affinity_connected_components,
    agglomerate,
    agglomerate_multi,
    binary_dilation,
    binary_erosion,
    connected_components,
    mutex_watershed,
    remove_small,
    renumber,
    watershed,
)
from .registry import register_decoder


def _chan(pred: np.ndarray) -> np.ndarray:
    return pred if pred.ndim == 4 else pred[None]


@register_decoder("binary_cc")
def decode_binary_cc(pred, threshold=0.5, connectivity=6, min_size=0, **kw):
    """Channel 0 above ``threshold``, then connected components."""
    p = _chan(np.asarray(pred))
    labels, _ = connected_components(p[0] > threshold, connectivity)
    if min_size:
        labels, _ = remove_small(labels, min_size)
    return labels


@register_decoder("bcd_watershed")
def decode_bcd_watershed(pred, binary_threshold=0.9, boundary_threshold=0.85, seed_threshold=0.5, min_size=0, **kw):
    """Binary + contour + distance watershed, channels [binary, boundary,
    distance]: seeds are the connected cores where the binary map is above
    ``binary_threshold``, the boundary below ``1 - boundary_threshold`` and
    the distance above ``seed_threshold``; they grow by watershed on the
    negated distance (on the boundary map without a distance channel)
    inside the binary mask (> 0.5)."""
    p = _chan(np.asarray(pred, dtype=np.float32))
    binary, boundary = p[0], p[1]
    distance = p[2] if p.shape[0] > 2 else None
    fg = binary > 0.5
    core = (binary > binary_threshold) & (boundary < (1.0 - boundary_threshold))
    if distance is not None:
        core &= distance > seed_threshold
    seeds, _ = connected_components(core, 6)
    energy = boundary if distance is None else -distance
    labels = watershed(energy.astype(np.float32), seeds, mask=fg)
    if min_size:
        labels, _ = remove_small(labels, min_size)
    return labels


@register_decoder("distance_watershed")
def decode_distance_watershed(pred, seed_threshold=0.7, mask_threshold=0.0, min_size=0, tanh_input=False, **kw):
    """Watershed of a distance map (channel 0): seeds are the 6-connected
    components above ``seed_threshold``, grown down the distance inside the
    voxels above ``mask_threshold``."""
    dist = _chan(np.asarray(pred, dtype=np.float32))[0]
    seeds, _ = connected_components(dist > seed_threshold, 6)
    labels = watershed((-dist).astype(np.float32), seeds, mask=dist > mask_threshold)
    if min_size:
        labels, _ = remove_small(labels, min_size)
    return labels


@register_decoder("affinity_cc")
def decode_affinity_cc(pred, threshold=0.75, min_size=0, **kw):
    """Connected components over the three cardinal affinity channels'
    edges above ``threshold``."""
    p = _chan(np.asarray(pred, dtype=np.float32))
    labels, _ = affinity_connected_components(p[:3], threshold)
    if min_size:
        labels, _ = remove_small(labels, min_size)
    return labels


@register_decoder("waterz")
def decode_waterz(pred, threshold=0.5, fragments="watershed", fragment_threshold=0.5, min_size=0, thresholds=None,
                  return_all_thresholds=False, **kw):
    """Fragments, then mean-affinity agglomeration to ``threshold``.
    Fragments are affinity connected components above
    ``max(0.9, fragment_threshold)`` (``fragments="cc"``), or else a
    watershed of the smoothed mean affinity (Gaussian sigma 1) from seeds at
    its 3x3x3 maxima plateaus (within 1e-6), inside the voxels whose mean
    affinity is above ``fragment_threshold``. With ``thresholds=[...]`` and
    ``return_all_thresholds=True`` one region graph serves every threshold:
    returns {threshold: labels}. ``min_size`` removes smaller instances."""
    p = _chan(np.asarray(pred, dtype=np.float32))[:3]
    mean_aff = p.mean(axis=0)
    if fragments == "cc":
        frags, _ = affinity_connected_components(p, max(0.9, fragment_threshold))
    else:
        fg = mean_aff > fragment_threshold
        smooth = ndimage.gaussian_filter(mean_aff, 1.0)
        maxima = smooth > (ndimage.maximum_filter(smooth, size=3) - 1e-6)
        seeds, _ = connected_components(maxima & fg, 6)
        frags = watershed((-smooth).astype(np.float32), seeds, mask=fg)
    if thresholds is not None and return_all_thresholds:
        out = {}
        for thr, (labels, _) in agglomerate_multi(frags, p, thresholds).items():
            if min_size:
                labels, _ = remove_small(labels, min_size)
            out[thr] = labels
        return out
    labels, _ = agglomerate(frags, p, threshold)
    if min_size:
        labels, _ = remove_small(labels, min_size)
    return labels


@register_decoder("channel_gate")
def decode_channel_gate(pred, signal_channels=0, gate_channel=-1, **kw):
    """The ``signal_channels`` times the one ``gate_channel``; each is an
    int, a list of ints or a slice string such as ``"0:3"``."""
    from ..utils.slicing import parse_slice

    arr = _chan(np.asarray(pred))
    n = arr.shape[0]

    def channels(spec, what):
        if isinstance(spec, (int, np.integer)):
            idx = [int(spec) % n]
        elif isinstance(spec, str):
            idx = list(range(n))[parse_slice(spec)]
        else:
            idx = [int(i) % n for i in spec]
        if not idx:
            raise ValueError(f"channel_gate.{what} resolved to no channels")
        return idx

    sig = channels(signal_channels, "signal_channels")
    gate = channels(gate_channel, "gate_channel")
    if len(gate) != 1:
        raise ValueError(f"channel_gate.gate_channel must be one channel, got {gate}")
    return (arr[sig] * arr[gate[0]:gate[0] + 1]).astype(arr.dtype, copy=False)


@register_decoder("naive_waterz")
def naive_waterz(pred, chunk_depth=80, threshold=0.4, fragment_threshold=0.5, dust_remove_size=600, min_overlap=20,
                 iou_threshold=0.05, one_sided_threshold=0.95, one_sided_min_size=200, affinity_threshold=0.15, **kw):
    """waterz on z chunks of ``chunk_depth`` slices, each on its own, then
    the ids of two chunks merged across each seam: a pair of faces whose
    overlap has ``min_overlap`` voxels and a mean seam z-affinity of
    ``affinity_threshold`` merges when their face IoU reaches
    ``iou_threshold`` or when one face (both at least
    ``one_sided_min_size`` voxels) lies ``one_sided_threshold`` inside the
    other. Ids are numbered by the smallest id of each merged set."""
    p = _chan(np.asarray(pred, dtype=np.float32))[:3]
    nz = p.shape[1]
    chunks: List[np.ndarray] = []
    offsets: List[int] = []
    total = 0
    for z0 in range(0, nz, chunk_depth):
        seg = decode_waterz(p[:, z0:z0 + chunk_depth], threshold=threshold, fragment_threshold=fragment_threshold,
                            min_size=dust_remove_size).astype(np.uint64)
        chunks.append(seg)
        offsets.append(total)
        total += int(seg.max()) if seg.size else 0
    parent = np.arange(total + 1, dtype=np.int64)

    def root(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def shifted(seg, off):
        return seg + np.uint64(off) * (seg > 0)

    for i in range(len(chunks) - 1):
        lo, hi = shifted(chunks[i][-1], offsets[i]), shifted(chunks[i + 1][0], offsets[i + 1])
        # the seam's z affinity, stored at its high end (channel 2)
        aff = p[2, (i + 1) * chunk_depth] if p.shape[0] > 2 else np.ones_like(lo, np.float32)
        both = (lo > 0) & (hi > 0)
        if not both.any():
            continue
        base = np.uint64(int(hi[both].max()) + 1)
        keys, inv, overlap = np.unique(lo[both] * base + hi[both], return_inverse=True, return_counts=True)
        mean_aff = np.bincount(inv, weights=aff[both]) / overlap
        size_lo = dict(zip(*(v.tolist() for v in np.unique(lo[lo > 0], return_counts=True))))
        size_hi = dict(zip(*(v.tolist() for v in np.unique(hi[hi > 0], return_counts=True))))
        for key, ov, am in zip(keys.tolist(), overlap.tolist(), mean_aff.tolist()):
            if ov < min_overlap or am < affinity_threshold:
                continue
            a, b = int(key // int(base)), int(key % int(base))
            na, nb = size_lo[a], size_hi[b]
            contained = min(na, nb) >= one_sided_min_size and ov / min(na, nb) >= one_sided_threshold
            if ov / (na + nb - ov) >= iou_threshold or contained:
                ra, rb = root(a), root(b)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([root(i) for i in range(total + 1)], dtype=np.uint64)
    lut = np.zeros(total + 1, dtype=np.uint64)
    if total:
        lut[1:] = np.unique(roots[1:], return_inverse=True)[1].astype(np.uint64) + 1
    out = np.empty(p.shape[1:], dtype=np.uint32)
    for ci, seg in enumerate(chunks):
        out[ci * chunk_depth:ci * chunk_depth + len(seg)] = lut[shifted(seg, offsets[ci])].astype(np.uint32)
    return out


@register_decoder("mutex_watershed")
def decode_mutex_watershed(pred, offsets=None, min_size=0, **kw):
    """Seedless mutex watershed over short- and long-range affinities
    (``offsets`` per channel, default the three cardinal ones); voxels whose
    short-range affinities are all at most 0.05 are background."""
    p = _chan(np.asarray(pred, dtype=np.float32))
    offsets = [(0, 0, 1), (0, 1, 0), (1, 0, 0)][: p.shape[0]] if offsets is None else parse_offsets(offsets)
    labels, _ = mutex_watershed(p, offsets)
    short = p[: min(3, p.shape[0])].max(axis=0)
    labels, _ = renumber(np.where(short > 0.05, labels, 0).astype(np.uint32))
    if min_size:
        labels, _ = remove_small(labels, min_size)
    return labels


@register_decoder("polarity2instance")
def decode_polarity(pred, threshold=0.5, min_size=0, pair_distance=8, **kw):
    """Synaptic polarity (pre, post, union) -> synapse instances: 26-connected
    components of the union of the three channels above ``threshold`` (less
    than ``min_size`` voxels dropped, then renumbered); synapse k's pre
    voxels get 2k - 1 and its post voxels 2k, other voxels 0."""
    p = _chan(np.asarray(pred, dtype=np.float32))
    pre, post = p[0] > threshold, p[1] > threshold
    syn, _ = connected_components((p[2] > threshold) | pre | post, 26)
    if min_size:
        syn, _ = remove_small(syn, min_size)
        syn, _ = renumber(syn)
    out = np.zeros_like(syn)
    on = syn > 0
    out[on & pre] = syn[on & pre] * 2 - 1
    out[on & post] = syn[on & post] * 2
    return out


def grow_labels_bounded(labels: np.ndarray, fg: Optional[np.ndarray] = None, max_steps: int = 5) -> np.ndarray:
    """Grows labels into unlabelled voxels (of ``fg`` where given) by at most
    ``max_steps`` 6-connected rings; a voxel reached from several sides in
    one ring takes the first in the order z-, z+, y-, y+, x-, x+ of the
    neighbour it copies."""
    lab = np.asarray(labels, dtype=np.uint32).copy()
    free = lab == 0
    if fg is not None:
        free &= np.asarray(fg, bool)
    for _ in range(int(max_steps)):
        ring = np.zeros_like(lab)
        for axis in range(3):
            for shift in (1, -1):
                src = np.roll(lab, shift, axis=axis)
                face = [slice(None)] * 3
                face[axis] = slice(0, 1) if shift == 1 else slice(-1, None)
                src[tuple(face)] = 0  # no wrap-around
                take = free & (ring == 0) & (src > 0)
                ring[take] = src[take]
        grew = ring > 0
        if not grew.any():
            break
        lab[grew] = ring[grew]
        free &= ~grew
    return lab


@register_decoder("grow_bounded")
def decode_grow_bounded(labels, prediction=None, threshold=0.5, max_steps=5, **kw):
    """:func:`grow_labels_bounded` of the incoming labels: into the voxels
    whose mean affinity (of ``prediction``'s first three channels, a second
    graph input) is above ``threshold``, else into every unlabelled voxel."""
    lab = np.asarray(labels)
    if lab.ndim == 4:
        lab = lab[0]
    fg = None
    if prediction is not None:
        p = _chan(np.asarray(prediction, dtype=np.float32))
        fg = p[:min(3, p.shape[0])].mean(axis=0) > threshold
    return grow_labels_bounded(lab.astype(np.uint32), fg, max_steps)


@register_decoder("segmentation_grow")
def decode_grow(pred, markers=None, threshold=0.5, iterations=2, **kw):
    """Markers (default: the 6-connected components of the foreground eroded
    ``iterations`` times) grown by watershed on 1 - channel 0 inside the
    foreground (channel 0 above ``threshold``)."""
    p = _chan(np.asarray(pred, dtype=np.float32))
    fg = p[0] > threshold
    if markers is None:
        markers, _ = connected_components(binary_erosion(fg, iterations), 6)
    return watershed((1.0 - p[0]).astype(np.float32), np.asarray(markers, np.uint32), mask=fg)


@register_decoder("shape_smooth")
def decode_shape_smooth(labels, iterations=1, keep_vanishing=True, **kw):
    """Each instance opened (eroded, then dilated, ``iterations`` times) in
    its box padded by ``iterations``, keeping its id; with
    ``keep_vanishing`` an instance the opening erases stays as it was.
    Instances are written in id order, a later one over an earlier."""
    lab = np.asarray(labels)
    if lab.ndim == 4:
        lab = lab[0]
    lab = lab.astype(np.uint32)
    ids = np.unique(lab)
    back = None
    if len(ids) and int(ids.max()) > 4 * len(ids) + 64:
        # sparse ids: smooth dense ones, then map them back
        dense, _ = renumber(np.ascontiguousarray(lab))
        back = np.zeros(int(dense.max()) + 1, np.uint32)
        back[dense.ravel()] = lab.ravel()
        lab = dense
    out = np.zeros_like(lab)
    it = int(iterations)
    for iid, box in enumerate(ndimage.find_objects(lab.astype(np.int64)), start=1):
        if box is None:
            continue
        padded = tuple(slice(max(0, s.start - it), min(n, s.stop + it)) for s, n in zip(box, lab.shape))
        m = lab[padded] == iid
        opened = binary_dilation(binary_erosion(m, it), it)
        if keep_vanishing and not opened.any():
            opened = m
        out[padded][opened] = iid
    return out if back is None else back[out]


@register_decoder("threshold_mask")
def decode_threshold(pred, threshold=0.5, channel=0, **kw):
    """Channel ``channel`` above ``threshold`` as uint8."""
    p = _chan(np.asarray(pred))
    return (p[channel] > threshold).astype(np.uint8)
