"""Instance boundary, erosion and distance targets on the host, the port of
``instance_boundary_mask`` (with ``_boundary_shift`` and
``_boundary_morph``), ``erode_instances``, ``instance_edt`` (with
``_per_instance`` and ``_instance_edt_slice``), ``semantic_edt``,
``signed_distance``, ``skeleton_aware_edt`` and ``seg_erosion_instance`` in
``pytorch_connectomics_tpu/data/targets/distance.py:20-132,137-253``.

numpy and scipy's ``ndimage`` (its exact euclidean distance transform), as
the JAX package computes them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy import ndimage


def _per_instance(seg: np.ndarray) -> np.ndarray:
    ids = np.unique(seg)
    return ids[ids > 0]


def _instance_edt_slice(seg2d, normalize, sampling, bg_value):
    out = np.full(seg2d.shape, bg_value, dtype=np.float32)
    for iid in _per_instance(seg2d):
        m = seg2d == iid
        obj = ndimage.find_objects(m.astype(np.uint8))[0]
        d = ndimage.distance_transform_edt(m[obj], sampling=sampling[1:] if sampling else None)
        if normalize and d.max() > 0:
            d = d / d.max()
        out[obj] = np.where(m[obj], d.astype(np.float32), out[obj])
    return out


def instance_edt(
    seg: np.ndarray,
    mode: str = "3d",
    normalize: bool = True,
    sampling: Optional[Sequence[float]] = None,
    bg_value: float = 0.0,
) -> np.ndarray:
    """Each instance's euclidean distance to its own border, inside its
    bounding box, normalised to [0, 1] within the instance (per z slice with
    ``mode="2d"``); ``bg_value`` elsewhere."""
    seg = np.asarray(seg)
    if seg.ndim == 4:
        seg = seg[0]
    out = np.full(seg.shape, bg_value, dtype=np.float32)
    if mode == "2d":
        for z in range(seg.shape[0]):
            out[z] = _instance_edt_slice(seg[z], normalize, sampling, bg_value)
        return out
    for iid in _per_instance(seg):
        m = seg == iid
        obj = ndimage.find_objects(m.astype(np.uint8))[0]
        d = ndimage.distance_transform_edt(m[obj], sampling=sampling)
        if normalize and d.max() > 0:
            d = d / d.max()
        out[obj] = np.where(m[obj], d.astype(np.float32), out[obj])
    return out


def _instance_boxes(seg: np.ndarray):
    """[(id, bounding box)] of every positive id of a 3-D ``seg``, the boxes
    ``find_objects(seg == id)`` gives, from one ``find_objects`` pass: over
    the ids themselves where they are integers below 2^22, else over their
    ranks among the positive ids."""
    pos = seg > 0
    if seg.dtype.kind in "iub" and seg.size and seg.max() < (1 << 22):
        ids, lab = None, np.where(pos, seg, 0).astype(np.intp, copy=False)
    else:
        ids = _per_instance(seg)
        lab = np.where(pos, np.searchsorted(ids, seg) + 1, 0)
    boxes = ndimage.find_objects(lab)
    return [(i + 1 if ids is None else ids[i], b) for i, b in enumerate(boxes) if b is not None]


def semantic_edt(
    mask: np.ndarray,
    mode: str = "3d",
    normalize: bool = True,
    sampling: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """The foreground's euclidean distance to the background, normalised by
    its maximum (per z slice with ``mode="2d"``)."""
    mask = np.asarray(mask) > 0
    if mask.ndim == 4:
        mask = mask[0]
    if mode == "2d":
        d = np.stack([ndimage.distance_transform_edt(m) for m in mask]).astype(np.float32)
    else:
        d = ndimage.distance_transform_edt(mask, sampling=sampling).astype(np.float32)
    if normalize and d.max() > 0:
        d = d / d.max()
    return d


def signed_distance(seg: np.ndarray, mode: str = "3d", truncate: float = 8.0, per_instance: bool = True) -> np.ndarray:
    """Signed distance in [-1, 1]: the distance inside the foreground (with
    ``per_instance``, inside it less the boundaries between instances)
    minus the distance outside, each truncated at ``truncate`` voxels and
    divided by it."""
    seg = np.asarray(seg)
    if seg.ndim == 4:
        seg = seg[0]
    fg = seg > 0
    if per_instance:
        # boundaries between touching instances count as outside
        inside = ndimage.distance_transform_edt(fg & ~instance_boundary_mask(seg)).astype(np.float32)
    else:
        inside = ndimage.distance_transform_edt(fg).astype(np.float32)
    outside = ndimage.distance_transform_edt(~fg).astype(np.float32)
    sdt = np.clip(inside, 0, truncate) / truncate - np.clip(outside, 0, truncate) / truncate
    return sdt.astype(np.float32)


def skeleton_aware_edt(seg: np.ndarray, alpha: float = 0.8, bg_value: float = -1.0, mode: str = "3d") -> np.ndarray:
    """Each instance's distance to its border inside its bounding box,
    divided by its largest value (the medial ridge, which stands for the
    skeleton) and raised to ``alpha``; ``bg_value`` elsewhere."""
    seg = np.asarray(seg)
    if seg.ndim == 4:
        seg = seg[0]
    out = np.full(seg.shape, bg_value, dtype=np.float32)
    for iid, obj in _instance_boxes(seg):
        sub = seg[obj] == iid
        d = ndimage.distance_transform_edt(sub).astype(np.float32)
        ridge = float(d.max())
        if ridge <= 0:
            continue
        v = np.clip(d / ridge, 0.0, 1.0) ** alpha
        out[obj] = np.where(sub, v, out[obj])
    return out


def _boundary_shift(seg: np.ndarray, axes, edge_mode: str) -> np.ndarray:
    """Both voxels of every neighbouring pair along ``axes`` whose labels
    differ, by edge mode: ``all`` any change, ``seg-all`` changes touching
    foreground, ``seg-no-bg`` changes between two foreground instances."""
    boundary = np.zeros(seg.shape, dtype=bool)
    for ax in axes:
        a = np.swapaxes(seg, 0, ax)
        b = np.zeros_like(a, dtype=bool)
        lo, hi = a[:-1], a[1:]
        if edge_mode == "all":
            diff = lo != hi
        elif edge_mode == "seg-all":
            diff = (lo != hi) & ((lo > 0) | (hi > 0))
        elif edge_mode == "seg-no-bg":
            diff = (lo != hi) & (lo > 0) & (hi > 0)
        else:
            raise ValueError(f"unknown edge_mode {edge_mode!r}")
        b[1:] |= diff
        b[:-1] |= diff
        boundary |= np.swapaxes(b, 0, ax)
    return boundary


def _boundary_morph(seg: np.ndarray, thickness: int, edge_mode: str) -> np.ndarray:
    """Boundaries ``thickness`` thick by grey erosion/dilation over a box
    window of that edge."""
    if edge_mode == "all":
        eroded = ndimage.grey_erosion(seg, thickness, mode="reflect")
        return seg != eroded
    if edge_mode == "seg-all":
        eroded = ndimage.grey_erosion(seg, thickness, mode="reflect")
        return (seg > 0) & (seg != eroded)
    if edge_mode == "seg-no-bg":
        dilated = ndimage.grey_dilation(seg, thickness, mode="reflect")
        masked = np.where(seg > 0, dilated, np.inf)
        eroded = ndimage.grey_erosion(masked, thickness, mode="reflect")
        return (seg > 0) & (dilated != eroded)
    raise ValueError(f"unknown edge_mode {edge_mode!r}")


def instance_boundary_mask(
    seg: np.ndarray,
    thickness: int = 1,
    mode: str = "3d",
    edge_mode: Optional[str] = None,
) -> np.ndarray:
    """Boundary voxels between instances and background, over z, y and x
    (y and x with ``mode="2d"``). ``edge_mode=None``: any label change,
    restricted to foreground, dilated by ``thickness - 1`` face-connected
    steps inside the foreground (what the bcd decoder trains against);
    ``"all"``, ``"seg-all"``, ``"seg-no-bg"``: the shift rule above for
    ``thickness`` 1, box-window grey morphology (per z slice in 2-D)
    beyond."""
    seg = np.asarray(seg)
    if seg.ndim == 4:
        seg = seg[0]
    axes = (1, 2) if mode == "2d" else (0, 1, 2)
    if edge_mode is None:
        boundary = _boundary_shift(seg, axes, "all")
        boundary &= seg > 0
        if thickness > 1:
            st = ndimage.generate_binary_structure(3, 1)
            boundary = ndimage.binary_dilation(boundary, st, iterations=thickness - 1)
            boundary &= seg > 0
        return boundary
    if thickness == 1:
        return _boundary_shift(seg, axes, edge_mode)
    if mode == "2d":
        out = np.zeros(seg.shape, dtype=bool)
        for z in range(seg.shape[0]):
            out[z] = _boundary_morph(seg[z], thickness, edge_mode)
        return out
    return _boundary_morph(seg, thickness, edge_mode)


def erode_instances(seg: np.ndarray, iterations: int = 1, mode: str = "3d") -> np.ndarray:
    """Shrink each instance by clearing its boundary voxels
    (:func:`instance_boundary_mask`, thickness 1) ``iterations`` times."""
    if iterations <= 0:
        return seg
    seg = np.asarray(seg)
    squeeze = False
    if seg.ndim == 4:
        seg, squeeze = seg[0], True
    out = seg.copy()
    for _ in range(iterations):
        b = instance_boundary_mask(out, 1, mode)
        out = np.where(b, 0, out)
    return out[None] if squeeze else out


def seg_erosion_instance(seg: np.ndarray, tsz_h=1) -> np.ndarray:
    """Window erosion (JAX ``distance.py:214``): a voxel keeps its id only
    when the box window around it holds exactly one positive id. A scalar
    ``tsz_h`` erodes in-plane (window ``2h+1`` over the last two axes), a
    sequence per axis; negative ids (unlabeled) pass through."""
    seg = np.asarray(seg)
    if np.isscalar(tsz_h):
        w = 2 * int(tsz_h) + 1
        size = (1,) * (seg.ndim - 2) + (w, w)
    else:
        halves = tuple(int(h) for h in tsz_h)
        if len(halves) != seg.ndim:
            raise ValueError(f"tsz_h has {len(halves)} entries for a {seg.ndim}-D seg")
        size = tuple(2 * h + 1 for h in halves)
    # one positive id in the window: its max equals the min over positive ids
    # (background mapped above every id)
    sentinel = seg.max() + 1
    wmax = ndimage.maximum_filter(seg, size=size, mode="reflect")
    wmin = ndimage.minimum_filter(np.where(seg > 0, seg, sentinel), size=size, mode="reflect")
    return seg * ((wmax == wmin) | (seg < 0))
