"""Polarity, small-object, flow and weight-map targets and the label
clean-ups on the host, the port of every function of
``pytorch_connectomics_tpu/data/targets/misc.py`` (``seg_to_polarity``
``:21``, ``seg_to_small_object``, ``seg_to_flow``, ``binary_ratio_weight``,
``unet3d_weight``, ``relabel_connected_components``, ``normalize_labels``,
``energy_quantize`` and ``decode_quantize``).

numpy and scipy's ``ndimage``, as the JAX package computes them: each
result is bit for bit JAX's.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _squeeze(seg: np.ndarray) -> np.ndarray:
    seg = np.asarray(seg)
    return seg[0] if seg.ndim == 4 else seg


def seg_to_polarity(seg: np.ndarray, exclusive: bool = False, dtype=np.float32) -> np.ndarray:
    """Synaptic polarity: odd ids are pre-, even ids post-synaptic.
    ``exclusive=False``: 3 channels (pre, post, union); ``True``: one int64
    class map {0: background, 1: pre, 2: post}."""
    seg = _squeeze(seg)
    pre = (seg > 0) & (seg % 2 == 1)
    post = (seg > 0) & (seg % 2 == 0)
    if exclusive:
        return np.maximum(pre.astype(np.int64), 2 * post.astype(np.int64))
    return np.stack([pre, post, pre | post]).astype(dtype)


def seg_to_small_object(seg: np.ndarray, size_threshold: int = 1000, dtype=np.float32) -> np.ndarray:
    """1 on the voxels of instances of fewer than ``size_threshold`` voxels."""
    seg = _squeeze(seg)
    ids, counts = np.unique(seg, return_counts=True)
    small = ids[(counts < size_threshold) & (ids > 0)]
    if not len(small):
        return np.zeros(seg.shape, dtype=dtype)
    lut = np.zeros(int(seg.max()) + 1, dtype=bool)
    lut[small.astype(np.int64)] = True
    return lut[seg].astype(dtype)


def seg_to_flow(seg: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(3, Z, Y, X) offsets of each voxel to its instance's centre of mass,
    each axis divided by the instance's largest offset on it."""
    seg = _squeeze(seg)
    out = np.zeros((3,) + seg.shape, dtype=dtype)
    coords = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in seg.shape], indexing="ij")
    for iid in np.unique(seg):
        if iid == 0:
            continue
        m = seg == iid
        com = [float(c[m].mean()) for c in coords]
        for d in range(3):
            v = com[d] - coords[d][m]
            out[d][m] = v / max(np.abs(v).max(), 1e-6)
    return out


def binary_ratio_weight(target: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Inverse class-frequency weights of ``target > 0`` (ones when one class
    is empty)."""
    fg = np.asarray(target) > 0
    n, pos = fg.size, int(fg.sum())
    if pos == 0 or pos == n:
        return np.ones(fg.shape, dtype=dtype)
    return np.where(fg, n / (2.0 * pos), n / (2.0 * (n - pos))).astype(dtype)


def unet3d_weight(seg: np.ndarray, w0: float = 10.0, sigma: float = 5.0, dtype=np.float32) -> np.ndarray:
    """The class-balance weights plus ``w0 exp(-d^2 / 2 sigma^2)`` on the
    background, ``d`` its distance to the nearest instance voxel."""
    seg = _squeeze(seg)
    base = binary_ratio_weight(seg > 0, dtype)
    bg = seg == 0
    if bg.any() and (~bg).any():
        d = ndimage.distance_transform_edt(bg)
        base = base + np.where(bg, w0 * np.exp(-(d**2) / (2.0 * sigma**2)), 0.0)
    return base.astype(dtype)


def relabel_connected_components(seg: np.ndarray, connectivity: int = 1) -> np.ndarray:
    """Each connected piece of each id its own label (touching pieces of
    different ids stay apart), compacted to 1..K."""
    seg = np.asarray(seg)
    squeeze = seg.ndim == 4
    if squeeze:
        seg = seg[0]
    st = ndimage.generate_binary_structure(seg.ndim, connectivity)
    cc, _ = ndimage.label(seg > 0, structure=st)
    combined = cc.astype(np.int64) * (int(seg.max()) + 1) + seg.astype(np.int64)
    relabeled = np.unique(combined, return_inverse=True)[1].reshape(seg.shape).astype(np.uint32)
    relabeled[seg == 0] = 0
    relabeled = np.unique(relabeled, return_inverse=True)[1].reshape(seg.shape).astype(np.uint32)
    return relabeled[None] if squeeze else relabeled


def normalize_labels(seg: np.ndarray) -> np.ndarray:
    """Ids mapped to 0..K in sorted order."""
    seg = np.asarray(seg)
    return np.unique(seg, return_inverse=True)[1].reshape(seg.shape).astype(np.uint32)


def energy_quantize(energy: np.ndarray, levels: int = 10) -> np.ndarray:
    """Class 0 for negative energy, classes 1..levels for [0, 1] in equal
    bins (1.0 in the top one)."""
    bins = np.concatenate([[-1.0], np.linspace(0.0, 1.0, levels + 1)])
    bins[-1] = 1.1
    return (np.digitize(np.asarray(energy, dtype=np.float32), bins) - 1).astype(np.int64)


def decode_quantize(output: np.ndarray, mode: str = "max", levels: int = 0) -> np.ndarray:
    """Class scores (C, Z, Y, X) back to energy: ``max`` the argmax level
    over ``levels``, ``mean`` the softmax-weighted level centres."""
    if mode not in ("max", "mean"):
        raise ValueError(f"decode_quantize mode must be max|mean, got {mode!r}")
    out = np.asarray(output, dtype=np.float32)
    c = out.shape[0]
    lv = int(levels) if levels else c
    if mode == "max":
        return np.argmax(out, axis=0).astype(np.float32) / float(lv)
    centers = np.linspace(-1.0 / lv, 1.0 - 1.0 / lv, c, dtype=np.float32)
    ex = np.exp(out - out.max(axis=0, keepdims=True))
    return np.tensordot(centers, ex / ex.sum(axis=0, keepdims=True), axes=(0, 0)).astype(np.float32)
