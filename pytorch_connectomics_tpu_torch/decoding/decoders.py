"""Built-in decoders of the port: prediction maps -> instance labels, on
the host through the native ops (``ops/native.py``). The port of
``binary_cc`` and ``bcd_watershed`` of
``pytorch_connectomics_tpu/decoding/decoders.py:43-79``; the other decoders
of the JAX package are not ported yet (``get_decoder`` raises).

Prediction layout: (C, Z, Y, X) float32 probabilities (after the channel
activations).
"""

from __future__ import annotations

import numpy as np

from ..ops.native import connected_components, remove_small, watershed
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
