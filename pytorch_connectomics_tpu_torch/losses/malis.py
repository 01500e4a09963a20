"""Constrained MALIS loss, the port of ``malis_counts``, ``MalisLoss`` and
``malis_loss`` in ``pytorch_connectomics_tpu/losses/malis.py:42-159``.

The maximin pair counts are computed on the host by the native
``malis_counts`` (:mod:`..ops.native`) from the detached affinities, as
JAX's ``pure_callback`` computes them; they are constants of the loss,
which is then taken on the device:

    L = sum_e [ w_pos(e) (1 - a_e)^2 + w_neg(e) a_e^2 ] / max(1, sum w)

The positive pass counts same-segment pairs on ``min(a, gt_aff)``, the
negative pass cross-segment pairs on ``max(a, gt_aff)``. ``crop_size`` takes
one cube of that edge from each volume; JAX draws its origin from the fixed
key ``fold_in(PRNGKey(7), 0)``, the port from ``numpy``'s generator seeded 7
(a fixed origin per shape in both; the bits differ, ROADMAP C.4).
``host_seconds`` adds up the host's time in the counts.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.targets.affinity import seg_to_affinity
from ..ops import native

# host seconds spent in the pair counts since the last reset (the trainer's caller reads it)
host_seconds = 0.0


def malis_weights(aff: np.ndarray, seg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(w_pos, w_neg) of one volume: ``aff`` (3, Z, Y, X) in x, y, z order,
    ``seg`` (Z, Y, X)."""
    seg = seg.astype(np.uint32)
    gt_aff = seg_to_affinity(seg, ["0-0-1", "0-1-0", "1-0-0"])
    return (native.malis_counts(np.minimum(aff, gt_aff), seg, count_pos=True),
            native.malis_counts(np.maximum(aff, gt_aff), seg, count_pos=False))


def crop_origin(shape, crop_size: int):
    """The fixed crop origin of a (Z, Y, X) volume."""
    rng = np.random.default_rng(7)
    return [int(rng.integers(0, max(1, n - crop_size))) for n in shape]


class MalisLoss:
    """``(pred (N, Z, Y, X, C) logits or probabilities, seg (N, Z, Y, X[, 1]))
    -> scalar``; ``pred``'s channels 0-2 are the x, y, z affinities."""

    def __init__(self, sigmoid: bool = True, crop_size: Optional[int] = None, num_workers: int = 1):
        self.sigmoid = sigmoid
        self.crop_size = crop_size
        self.num_workers = max(1, int(num_workers))

    def __call__(self, pred, seg, weight=None, mask=None, **kw):
        global host_seconds
        p = pred.float()
        if self.sigmoid:
            p = torch.sigmoid(p)
        p_cf = p[..., :3].movedim(-1, 1)
        s = seg[..., 0] if seg.dim() == 5 else seg
        if self.crop_size:
            c = self.crop_size
            (z0, y0, x0), sizes = crop_origin(p_cf.shape[2:], c), [min(c, n) for n in p_cf.shape[2:]]
            p_cf = p_cf[:, :, z0:z0 + sizes[0], y0:y0 + sizes[1], x0:x0 + sizes[2]]
            s = s[:, z0:z0 + sizes[0], y0:y0 + sizes[1], x0:x0 + sizes[2]]
        t0 = time.perf_counter()
        aff_np = p_cf.detach().cpu().numpy()
        seg_np = s.detach().cpu().numpy()
        wp, wn = np.zeros_like(aff_np), np.zeros_like(aff_np)

        def one(b):
            wp[b], wn[b] = malis_weights(aff_np[b], seg_np[b])

        n = aff_np.shape[0]
        if self.num_workers > 1 and n > 1:
            with ThreadPoolExecutor(max_workers=min(self.num_workers, n)) as ex:
                list(ex.map(one, range(n)))
        else:
            for b in range(n):
                one(b)
        host_seconds += time.perf_counter() - t0
        w_pos = torch.from_numpy(wp).to(p_cf.device)
        w_neg = torch.from_numpy(wn).to(p_cf.device)
        total = torch.clamp(w_pos.sum() + w_neg.sum(), min=1.0)
        return (w_pos * (1.0 - p_cf) ** 2 + w_neg * p_cf**2).sum() / total


def malis_loss(pred, target, weight=None, mask=None, sigmoid=True, crop_size=None, num_workers=1, **kw):
    """The registry's form; ``target`` is the instance segmentation."""
    return MalisLoss(sigmoid=sigmoid, crop_size=crop_size, num_workers=num_workers)(pred, target, weight, mask)
