"""Decode post-processing, the port of ``apply_postprocessing`` and what it
reaches in ``pytorch_connectomics_tpu/decoding/postprocess.py`` (:17-118,
:256-313): the binary cleanup chain, the split of disconnected instances,
small-instance removal or merging, large-instance removal and the axis
transpose. Host numpy/scipy plus the native ops of :mod:`..ops.native`;
the labels are the JAX package's, bit for bit. The manual mask edits and
the 2-D to 3-D stitching of that module are not ported."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
from scipy import ndimage

from ..config.schema import DecodingPostprocessConfig
from ..ops.native import connected_components, remove_small, renumber

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
