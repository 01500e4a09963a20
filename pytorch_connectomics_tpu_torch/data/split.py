"""Axis-range train/val split of one volume, the port of
``pytorch_connectomics_tpu/data/split.py:11-135`` (numpy, host side):
fractional or absolute ranges, ratio splits as slices or masks, and
centre padding of the validation slab up to the model's input size."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _resolve_range(rng: Sequence[float], size: int) -> Tuple[int, int]:
    lo, hi = rng
    if isinstance(lo, float) and 0.0 <= lo <= 1.0 and isinstance(hi, float) and hi <= 1.0:
        return int(round(lo * size)), int(round(hi * size))
    return int(lo), int(hi)


def split_volume(
    volume: np.ndarray,
    axis: int = 0,
    train_range: Optional[Sequence[float]] = None,
    val_range: Optional[Sequence[float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(train, val) slabs of ``volume`` along ``axis``. Ranges are fractions
    ([0.0, 0.8]) or voxel indices; with one range given the other is its
    complement, and with none the split is 0.8 / 0.2."""
    size = volume.shape[axis]
    if train_range is None and val_range is None:
        train_range = [0.0, 0.8]
    if train_range is not None:
        t_lo, t_hi = _resolve_range(train_range, size)
    if val_range is not None:
        v_lo, v_hi = _resolve_range(val_range, size)
        if train_range is None:
            t_lo, t_hi = (v_hi, size) if v_lo == 0 else (0, v_lo)
    else:
        v_lo, v_hi = (t_hi, size) if t_lo == 0 else (0, t_lo)

    def slab(lo, hi):
        sl = [slice(None)] * volume.ndim
        sl[axis] = slice(lo, hi)
        return volume[tuple(sl)]

    return slab(t_lo, t_hi), slab(v_lo, v_hi)


def split_slices(
    volume_shape: Sequence[int], train_ratio: float = 0.8, axis: int = 0, min_val_size: Optional[int] = None
) -> Tuple[Tuple[slice, ...], Tuple[slice, ...]]:
    """(train, val) slice tuples of a ratio split along ``axis``; the val
    slab keeps at least ``min_val_size`` voxels where given."""
    if not 0 < train_ratio < 1:
        raise ValueError(f"train_ratio must be in (0, 1), got {train_ratio}")
    ndim = len(volume_shape)
    if not 0 <= axis < ndim:
        raise ValueError(f"axis must be in [0, {ndim}), got {axis}")
    size = volume_shape[axis]
    train_size = int(size * train_ratio)
    if min_val_size is not None and size - train_size < min_val_size:
        train_size = max(1, size - min_val_size)
    train, val = [slice(None)] * ndim, [slice(None)] * ndim
    train[axis], val[axis] = slice(0, train_size), slice(train_size, size)
    return tuple(train), tuple(val)


def create_split_masks(
    volume_shape: Sequence[int], train_ratio: float = 0.8, axis: int = 0, min_val_size: Optional[int] = None,
    dtype=np.uint8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Binary (train, val) masks of a ratio split."""
    tr, va = split_slices(volume_shape, train_ratio, axis, min_val_size)
    train_mask, val_mask = np.zeros(tuple(volume_shape), dtype), np.zeros(tuple(volume_shape), dtype)
    train_mask[tr] = 1
    val_mask[va] = 1
    return train_mask, val_mask


def pad_volume_to_size(
    volume: np.ndarray, target_size: Sequence[int], mode: str = "reflect", constant_value: float = 0.0
) -> np.ndarray:
    """Centre-pad (never crop) a ``(C,) Z, Y, X`` volume up to
    ``target_size``."""
    has_channel = volume.ndim == len(target_size) + 1
    spatial = volume.shape[1:] if has_channel else volume.shape
    pads = [((t - s) // 2, (t - s) - (t - s) // 2) if t > s else (0, 0) for s, t in zip(spatial, target_size)]
    if not any(p != (0, 0) for p in pads):
        return volume
    if has_channel:
        pads = [(0, 0)] + pads
    np_mode = {"reflect": "reflect", "replicate": "edge", "constant": "constant", "circular": "wrap"}[mode]
    kw = {"constant_values": constant_value} if np_mode == "constant" else {}
    return np.pad(volume, pads, mode=np_mode, **kw)


def split_and_pad_volume(
    volume: np.ndarray,
    train_ratio: float = 0.8,
    target_size: Optional[Sequence[int]] = None,
    axis: int = 0,
    pad_mode: str = "reflect",
    min_val_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """A ratio split with the val slab padded up to ``target_size``."""
    has_channel = volume.ndim == 4
    tr, va = split_slices(volume.shape[1:] if has_channel else volume.shape, train_ratio, axis, min_val_size)
    if has_channel:
        tr, va = (slice(None),) + tr, (slice(None),) + va
    train_vol, val_vol = volume[tr], volume[va]
    if target_size is not None:
        val_vol = pad_volume_to_size(val_vol, target_size, mode=pad_mode)
    return train_vol, val_vol
