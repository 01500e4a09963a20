"""Built-in decoders of the port: prediction maps -> instance labels, on
the host through the native ops (``ops/native.py``). The port of
``binary_cc``, ``bcd_watershed``, ``affinity_cc``, ``waterz``,
``mutex_watershed`` and ``polarity2instance`` of
``pytorch_connectomics_tpu/decoding/decoders.py`` (``:43-79,97-151,272-310``);
the other decoders of the JAX package are not
ported yet (``get_decoder`` raises).

Prediction layout: (C, Z, Y, X) float32 probabilities (after the channel
activations).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ..data.targets.affinity import parse_offsets
from ..ops.native import (
    affinity_connected_components,
    agglomerate,
    agglomerate_multi,
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
