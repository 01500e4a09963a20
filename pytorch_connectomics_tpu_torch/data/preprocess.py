"""Intensity normalization (host-side, numpy): the port's copy of
``normalize_volume`` from ``pytorch_connectomics_tpu/data/preprocess.py``."""

from __future__ import annotations

import numpy as np


def smart_normalize(vol: np.ndarray) -> np.ndarray:
    """uint8/uint16 -> [0,1] by dtype range; float -> min-max if outside [0,1]."""
    if vol.dtype in (np.uint8, np.uint16):
        v = vol.astype(np.float32)
        v /= 255.0 if vol.dtype == np.uint8 else 65535.0  # in place: one volume-sized buffer
        return v
    v = vol.astype(np.float32)
    vmin, vmax = float(v.min()), float(v.max())
    if vmin >= 0.0 and vmax <= 1.0:
        return v
    if vmax > vmin:
        return (v - vmin) / (vmax - vmin)
    return np.zeros_like(v)


def zscore_normalize(vol: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    v = vol.astype(np.float32)
    return (v - v.mean()) / (v.std() + eps)


def percentile_normalize(vol: np.ndarray, lower: float = 0.5, upper: float = 99.5) -> np.ndarray:
    v = vol.astype(np.float32)
    lo, hi = np.percentile(v, [lower, upper])
    v = np.clip(v, lo, hi)
    return (v - lo) / max(1e-8, hi - lo)


def normalize_volume(vol: np.ndarray, method: str = "smart", clip_percentiles=None) -> np.ndarray:
    if clip_percentiles:
        vol = percentile_normalize(vol, *clip_percentiles)
        method = "none" if method in ("smart", "percentile") else method
    if method in ("smart", None, ""):
        return smart_normalize(vol)
    if method == "zscore":
        return zscore_normalize(vol)
    if method == "percentile":
        return percentile_normalize(vol)
    if method == "scale":
        return vol.astype(np.float32) / 255.0
    if method == "none":
        return vol.astype(np.float32)
    raise ValueError(f"unknown normalization '{method}'")
