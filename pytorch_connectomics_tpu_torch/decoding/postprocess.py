"""Decode post-processing, the port of
``pytorch_connectomics_tpu/decoding/postprocess.py``: the binary cleanup
chain, the split of disconnected instances, small-instance removal or
merging, large-instance removal and the axis transpose
(``apply_postprocessing``); the manual mask edits (binarize and median,
remove, add and merge masks, the EDT watershed split) and the greedy
stitching of 2-D labellings into 3-D instances. Host numpy/scipy plus the
native ops of :mod:`..ops.native`; the labels are the JAX package's, bit
for bit, new ids and dtypes included."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage

from ..config.schema import DecodingPostprocessConfig
from ..ops.native import connected_components, edt, remove_small, renumber, watershed

SMALL_INSTANCE_MODES = ("none", "background", "background_2d", "neighbor", "neighbor_2d")


def cast2dtype(segm: np.ndarray) -> np.ndarray:
    """Downcast a segmentation to the smallest unsigned dtype that holds its
    largest id."""
    max_id = int(segm.max()) if segm.size else 0
    for dt in (np.uint8, np.uint16, np.uint32):
        if max_id <= np.iinfo(dt).max:
            return segm.astype(dt)
    return segm.astype(np.uint64)


def remove_small_instances(labels: np.ndarray, min_size: int, mode: str = "background") -> np.ndarray:
    """Drop or merge the instances below ``min_size`` voxels: ``none``,
    ``background`` (to 0, then renumbered), ``background_2d`` (per z
    slice), ``neighbor`` (into the neighbour of greatest contact),
    ``neighbor_2d`` (per z slice)."""
    if mode not in SMALL_INSTANCE_MODES:
        raise ValueError(f"remove_small_instances mode {mode!r} not in {SMALL_INSTANCE_MODES}")
    if mode == "none" or not min_size:
        return labels
    if mode == "background":
        out, _ = remove_small(labels, min_size)
        return renumber(out)[0]
    if mode == "background_2d":
        out = np.asarray(labels, dtype=np.uint32).copy()
        for z in range(out.shape[0]):
            out[z] = remove_small(out[z], min_size)[0]
        return renumber(out)[0]
    if mode == "neighbor":
        return merge_small_objects(np.asarray(labels).copy(), min_size, do_3d=True)
    out = np.asarray(labels).copy()
    for z in range(out.shape[0]):
        out[z] = merge_small_objects(out[z].copy(), min_size, do_3d=False)
    return out


def merge_small_objects(segm: np.ndarray, thres_small: int, do_3d: bool = False) -> np.ndarray:
    """Merge each instance below ``thres_small`` voxels, in id order, into
    the id that covers most of its one-voxel ring (non-zero ids first; an
    instance ringed by background only becomes background). ``do_3d`` on a
    volume dilates in-plane ((1, 3, 3)). Works on ``segm`` in place and
    returns it."""
    struct = np.ones((1, 3, 3), bool) if (do_3d and segm.ndim == 3) else None
    # one compact relabel and one find_objects give every box; each merge
    # then touches only its own crop
    ids, inv, counts = np.unique(segm, return_inverse=True, return_counts=True)
    bboxes = list(ndimage.find_objects((inv + 1).reshape(segm.shape).astype(np.int32)))
    id2k = {int(i): k for k, i in enumerate(ids.tolist())}
    for k, (idx, cnt) in enumerate(zip(ids.tolist(), counts.tolist())):
        if idx == 0 or cnt >= thres_small or bboxes[k] is None:
            continue
        box = bboxes[k]
        # the box grown by 2 keeps the dilation local
        region = segm[tuple(slice(max(0, s.start - 2), min(n, s.stop + 2)) for s, n in zip(box, segm.shape))]
        mask = region == idx
        ring = ndimage.binary_dilation(mask, struct) & ~mask
        neighbors = region[ring]
        neighbors = neighbors[neighbors != idx]
        nonzero = neighbors[neighbors != 0]
        pool = nonzero if nonzero.size else neighbors
        if not pool.size:
            continue
        u, ct = np.unique(pool, return_counts=True)
        target = int(u[np.argmax(ct)])
        region[mask] = target
        # a small target handled later must see the extent it absorbed
        tk = id2k.get(target)
        if tk is not None and tk > k and bboxes[tk] is not None:
            bboxes[tk] = tuple(slice(min(a.start, b.start), max(a.stop, b.stop)) for a, b in zip(bboxes[tk], box))
    return segm


def remove_large_instances(segm: np.ndarray, max_size: int = 2000) -> np.ndarray:
    """Zero the instances of more than ``max_size`` voxels."""
    out = np.copy(segm)
    sizes = np.bincount(segm.ravel().astype(np.int64))
    out[(sizes > max_size)[segm.astype(np.int64)]] = 0
    return out


def cc_instance_filter(labels: np.ndarray, connectivity: int = 6) -> np.ndarray:
    """Split every instance into its connected pieces under
    ``connectivity``, each piece an id of its own, renumbered."""
    lab = np.asarray(labels, dtype=np.uint32)
    fg = lab > 0
    cc, _ = connected_components(fg, connectivity)
    combined = cc.astype(np.int64) * (int(lab.max()) + 1) + lab.astype(np.int64)
    _, inv = np.unique(combined, return_inverse=True)
    out = inv.reshape(lab.shape).astype(np.uint32)
    out[~fg] = 0
    return renumber(out)[0]


def binarize_and_median(pred: np.ndarray, size: Sequence[int] = (7, 7, 7), thres: float = 0.8) -> np.ndarray:
    """The mask ``pred > thres``, median-filtered over ``size`` (uint8)."""
    return ndimage.median_filter((np.asarray(pred) > thres).astype(np.uint8), size=tuple(size))


def remove_masks(vol: np.ndarray, indices: List[int]) -> np.ndarray:
    """Zero the instances ``indices`` of ``vol``, in place."""
    vol[np.isin(vol, np.asarray(indices, vol.dtype))] = 0
    return vol


def add_masks(vol_base: np.ndarray, vol: np.ndarray, indices: List[int]) -> np.ndarray:
    """Paste the instances ``indices`` of ``vol`` into ``vol_base`` (in
    place, over whatever is there) as new ids max + 1, max + 2, ... in
    order."""
    max_idx = int(vol_base.max())
    for i, idx in enumerate(indices):
        vol_base[vol == idx] = max_idx + i + 1
    return vol_base


def merge_masks(vol: np.ndarray, indices: List[List[int]]) -> np.ndarray:
    """Each group of ids becomes its first id, in place."""
    for group in indices:
        if group:
            vol[np.isin(vol, np.asarray(group, vol.dtype))] = group[0]
    return vol


def watershed_split(vol: np.ndarray, index: int, min_distance: int = 5) -> np.ndarray:
    """Split instance ``index`` of a 3-D ``vol`` (in place) by a watershed
    of its distance transform, seeded at the connected plateaus of distance
    peaks (maxima over a cube of side ``2 * min_distance + 1``); each part
    a new id above the volume's max, in the order of the seeds' ids. An
    instance with fewer than two seeds stays as it is."""
    if vol.ndim != 3:
        raise ValueError(f"watershed_split expects a 3-D label array, got {vol.shape}")
    max_idx = int(vol.max())
    mask = vol == index
    if not mask.any():
        return vol
    box = ndimage.find_objects(mask.astype(np.uint8))[0]
    box = tuple(slice(max(0, s.start - 1), min(dim, s.stop + 1)) for s, dim in zip(box, vol.shape))
    crop = mask[box]
    dist = edt(crop)
    fp = np.ones((2 * min_distance + 1,) * 3, bool)
    peaks = (dist >= ndimage.maximum_filter(dist, footprint=fp) - 1e-9) & crop & (dist > 0)
    markers, n = connected_components(peaks, 26)
    if n < 2:
        return vol
    parts = watershed((-dist).astype(np.float32), markers.astype(np.uint32), mask=crop)
    region = vol[box]
    part_ids = np.unique(parts)
    for i, pid in enumerate(part_ids[part_ids != 0].tolist()):
        region[parts == pid] = max_idx + i + 1
    vol[box] = region
    return vol


def intersection_over_union(masks_true: np.ndarray, masks_pred: np.ndarray) -> np.ndarray:
    """The IoU of every pair of ids, a (max true + 1, max pred + 1)
    float64 matrix whose row and column 0 are the background."""
    a = np.asarray(masks_true).ravel().astype(np.int64)
    b = np.asarray(masks_pred).ravel().astype(np.int64)
    na, nb = int(a.max()) + 1, int(b.max()) + 1
    overlap = np.bincount(a * nb + b, minlength=na * nb).reshape(na, nb).astype(np.float64)
    denom = overlap.sum(axis=0, keepdims=True) + overlap.sum(axis=1, keepdims=True) - overlap
    iou = np.zeros_like(overlap)
    np.divide(overlap, denom, out=iou, where=denom > 0)
    return iou


def stitch_3d(masks: np.ndarray, stitch_threshold: float = 0.25) -> np.ndarray:
    """Greedy z-stitching of a stack of 2-D labellings into 3-D instances
    (int64, so that new ids cannot wrap a small input dtype): each slice's
    label takes the label of the slice below with which its IoU is highest,
    where that IoU is at least ``stitch_threshold`` and the highest that
    label of the slice below has; the rest get new ids above every id so
    far."""
    masks = np.asarray(masks).astype(np.int64, copy=True)
    mmax = int(masks[0].max())
    seen_any = False
    for i in range(len(masks) - 1):
        iou = intersection_over_union(masks[i + 1], masks[i])[1:, 1:]
        if not iou.size:
            if seen_any:
                icount = int(masks[i + 1].max())
                lut = np.concatenate([[0], np.arange(mmax + 1, mmax + icount + 1, dtype=np.int64)])
                mmax += icount
                masks[i + 1] = lut[masks[i + 1]]
            else:
                mmax = int(masks[i + 1].max())
            continue
        iou[iou < stitch_threshold] = 0.0
        iou[iou < iou.max(axis=0)] = 0.0
        lut = iou.argmax(axis=1) + 1
        unmatched = np.nonzero(iou.max(axis=1) == 0.0)[0]
        lut[unmatched] = np.arange(mmax + 1, mmax + len(unmatched) + 1)
        mmax += len(unmatched)
        masks[i + 1] = np.concatenate([[0], lut])[masks[i + 1]]
        seen_any = True
    return masks


def apply_binary_postprocessing(pred: np.ndarray, config: Dict[str, Any]) -> np.ndarray:
    """Binary cleanup: binarize (``threshold`` on a probability map, > 0
    otherwise) -> median filter -> opening -> closing -> connected-component
    filtering (``connected_components``: ``connectivity``, ``min_size``,
    ``top_k``) -> uint8 mask."""
    arr = np.asarray(pred)
    thres = float(config.get("threshold", 0.5))
    mask = (arr > thres).astype(np.uint8) if arr.dtype.kind == "f" else (arr > 0).astype(np.uint8)
    size = config.get("median_filter_size")
    if size:
        mask = ndimage.median_filter(mask, size=tuple(size) if isinstance(size, (list, tuple)) else int(size))
    n_open = int(config.get("opening_iterations", 0))
    if n_open:
        mask = ndimage.binary_opening(mask, iterations=n_open).astype(np.uint8)
    n_close = int(config.get("closing_iterations", 0))
    if n_close:
        mask = ndimage.binary_closing(mask, iterations=n_close).astype(np.uint8)
    cc_cfg = config.get("connected_components")
    if cc_cfg:
        labels, _ = connected_components(mask > 0, int(cc_cfg.get("connectivity", 6)))
        min_size = int(cc_cfg.get("min_size", 0))
        if min_size:
            labels, _ = remove_small(labels, min_size)
        top_k = cc_cfg.get("top_k")
        if top_k:
            sizes = np.bincount(labels.ravel().astype(np.int64))
            sizes[0] = 0
            keep = np.argsort(sizes)[::-1][: int(top_k)]
            labels = np.where(np.isin(labels, keep[sizes[keep] > 0]), labels, 0)
        mask = (labels > 0).astype(np.uint8)
    return mask


def apply_postprocessing(labels: np.ndarray, cfg: Optional[DecodingPostprocessConfig]) -> np.ndarray:
    """The configured steps in order: binary chain, split of disconnected
    instances, small-instance removal, large-instance removal, transpose."""
    if cfg is None:
        return labels
    out = np.asarray(labels)
    if cfg.binary:
        out = apply_binary_postprocessing(out, dict(cfg.binary))
    if cfg.split_disconnected:
        out = cc_instance_filter(out, cfg.connectivity)
    if cfg.min_instance_size:
        out = remove_small_instances(out, cfg.min_instance_size, mode=cfg.small_instance_mode)
    if cfg.max_instance_size:
        out = remove_large_instances(out, cfg.max_instance_size)
    if cfg.transpose:
        out = np.transpose(out, cfg.transpose)
    return out
