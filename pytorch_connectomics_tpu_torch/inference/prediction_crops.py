"""Crops of a prediction before it is decoded (the port of
``pytorch_connectomics_tpu/inference/prediction_crops.py``): a symmetric
crop by ``crop_pad`` voxels an axis, and a mask that zeroes the border band
where long-range affinities have no neighbour inside the volume."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..data.targets.affinity import max_offset_pad


def _spatial_slices(shape, pad) -> tuple:
    return tuple(slice(p, n - p or None) for n, p in zip(shape, pad))


def crop_prediction(pred: np.ndarray, crop_pad: Sequence[int], channel_axis: int = -1) -> np.ndarray:
    """``pred`` less ``crop_pad`` (z, y, x) voxels at both ends of each
    spatial axis; channels last (``channel_axis`` -1) or first (0)."""
    pad = [int(c) for c in crop_pad]
    if channel_axis in (-1, pred.ndim - 1):
        return pred[_spatial_slices(pred.shape[:3], pad)]
    return pred[(slice(None),) + _spatial_slices(pred.shape[1:4], pad)]


def affinity_border_mask(shape_zyx: Sequence[int], offsets: Sequence[Union[str, Sequence[int]]]) -> np.ndarray:
    """(Z, Y, X) float32, 1 inside and 0 on the border band as deep as the
    largest offset on each axis."""
    mask = np.zeros(tuple(shape_zyx), np.float32)
    mask[_spatial_slices(shape_zyx, max_offset_pad(offsets))] = 1.0
    return mask


def apply_prediction_crops(pred: np.ndarray, crop_pad: Optional[Sequence[int]] = None,
                           affinity_offsets: Optional[Sequence] = None, channel_axis: int = -1) -> np.ndarray:
    """:func:`crop_prediction` by ``crop_pad``, then the prediction times
    :func:`affinity_border_mask` of ``affinity_offsets``, each where given."""
    out = pred
    if crop_pad:
        out = crop_prediction(out, crop_pad, channel_axis)
    if affinity_offsets:
        last = channel_axis in (-1, out.ndim - 1)
        mask = affinity_border_mask(out.shape[:3] if last else out.shape[1:], affinity_offsets)
        out = out * (mask[..., None] if last else mask[None])
    return out
