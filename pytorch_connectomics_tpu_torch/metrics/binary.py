"""Binary segmentation metrics over logits or probabilities, in numpy (the
port of ``pytorch_connectomics_tpu/metrics/binary.py``)."""

from __future__ import annotations

import numpy as np


def _binarize(pred, target, threshold=0.5, from_logits=True):
    """Boolean maps; boolean inputs are taken as already binarised."""
    p, t = np.asarray(pred), np.asarray(target)
    if p.dtype != np.bool_:
        p = p.astype(np.float32)
        if from_logits:
            p = 1.0 / (1.0 + np.exp(-p))
        p = p > threshold
    return p, (t if t.dtype == np.bool_ else t > 0.5)


def _counts(pred, target, threshold, from_logits):
    """(|p|, |t|, |p & t|, voxels) of the binarised maps, exact integer counts."""
    p, t = _binarize(pred, target, threshold, from_logits)
    return np.count_nonzero(p), np.count_nonzero(t), np.count_nonzero(p & t), p.size


def jaccard_index(pred, target, threshold=0.5, from_logits=True, eps=1e-7) -> float:
    sp, st, inter, _ = _counts(pred, target, threshold, from_logits)
    return (inter + eps) / (sp + st - inter + eps)


def dice_coefficient(pred, target, threshold=0.5, from_logits=True, eps=1e-7) -> float:
    sp, st, inter, _ = _counts(pred, target, threshold, from_logits)
    return (2.0 * inter + eps) / (sp + st + eps)


def binary_accuracy(pred, target, threshold=0.5, from_logits=True) -> float:
    sp, st, inter, n = _counts(pred, target, threshold, from_logits)
    return (n - (sp + st - 2 * inter)) / n

