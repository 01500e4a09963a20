"""Loss zoo, the port of ``pytorch_connectomics_tpu/losses/zoo.py``
(``_masked_mean``, ``bce_with_logits``, ``auto_pos_weight``,
``per_channel_bce``, ``dice_loss``, ``mse_loss``, ``:18-108``,
``smooth_l1_loss``, ``:118-124``, and ``get_loss``, ``:292-320``).

Every loss takes ``(pred, target, weight=None, mask=None)`` with
channels-last ``(N, Z, Y, X, C)`` tensors and returns a float32 scalar.
``weight`` is a voxel-wise weight map, ``mask`` restricts the loss to valid
voxels; losses take logits. The names of the JAX registry that this slice
does not port raise ``NotImplementedError`` naming the loss.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _masked_mean(x, weight=None, mask=None):
    if weight is not None:
        x = x * weight
    if mask is not None:
        x = x * mask
        return x.sum() / torch.clamp(mask.sum(), min=1.0)
    return x.mean()


def bce_with_logits(pred, target, weight=None, mask=None, pos_weight=None, **kw):
    """Weighted binary cross-entropy on logits."""
    p = pred.float()
    t = target.float()
    log_p = F.logsigmoid(p)
    log_not_p = F.logsigmoid(-p)
    if pos_weight is not None:
        loss = -(pos_weight * t * log_p + (1.0 - t) * log_not_p)
    else:
        loss = -(t * log_p + (1.0 - t) * log_not_p)
    return _masked_mean(loss, weight, mask)


def auto_pos_weight(target, mask=None, clip: float = 100.0):
    """The neg/pos ratio of ``target > 0.5`` (over the voxels where ``mask >
    0`` when a mask is given), clipped to [1, clip]: ``pos_weight: auto``."""
    t = target > 0.5
    if mask is not None:
        valid = mask > 0
        pos = (t & valid).sum()
        neg = (~t & valid).sum()
    else:
        pos = t.sum()
        neg = t.numel() - pos
    return torch.clamp(neg / torch.clamp(pos, min=1.0), 1.0, clip)


def per_channel_bce(pred, target, weight=None, mask=None, auto_pos_weight_flag=True, **kw):
    """BCE on logits with a pos_weight per channel (the channel's neg/pos
    ratio over valid voxels, clipped to [1, 100]), then the masked mean."""
    p = pred.float()
    t = target.float()
    axes = tuple(range(p.dim() - 1))  # all but the channel
    tpos = t > 0.5
    if mask is not None:
        valid = mask > 0
        pos = (tpos & valid).sum(dim=axes)
        neg = (~tpos & valid).sum(dim=axes)
    else:
        pos = tpos.sum(dim=axes)
        neg = tpos.numel() / tpos.shape[-1] - pos
    if auto_pos_weight_flag:
        pw = torch.clamp(neg / torch.clamp(pos, min=1.0), 1.0, 100.0)
    else:
        pw = torch.ones_like(pos, dtype=torch.float32)
    loss = -(pw * t * F.logsigmoid(p) + (1.0 - t) * F.logsigmoid(-p))
    return _masked_mean(loss, weight, mask)


def mse_loss(pred, target, weight=None, mask=None, tanh=False, **kw):
    """Squared error of the logits (or of their tanh), masked mean."""
    p = pred.float()
    if tanh:
        p = torch.tanh(p)
    return _masked_mean((p - target.float()) ** 2, weight, mask)


def smooth_l1_loss(pred, target, weight=None, mask=None, beta=1.0, tanh=False, **kw):
    """Huber-style error of the logits (or of their tanh): quadratic below
    ``beta``, linear above; masked mean."""
    p = pred.float()
    if tanh:
        p = torch.tanh(p)
    d = (p - target.float()).abs()
    return _masked_mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta), weight, mask)


def dice_loss(pred, target, weight=None, mask=None, sigmoid=True, softmax=False,
              smooth_nr=1e-5, smooth_dr=1e-5, squared_pred=False, **kw):
    """Soft Dice (MONAI smoothing), per sample and channel, then averaged."""
    p = pred.float()
    t = target.float()
    if sigmoid:
        p = torch.sigmoid(p)
    elif softmax:
        p = torch.softmax(p, dim=-1)
    if mask is not None:
        p = p * mask
        t = t * mask
    axes = tuple(range(1, p.dim() - 1))  # spatial
    inter = (p * t).sum(dim=axes)
    if squared_pred:
        denom = (p * p).sum(dim=axes) + (t * t).sum(dim=axes)
    else:
        denom = p.sum(dim=axes) + t.sum(dim=axes)
    dice = (2.0 * inter + smooth_nr) / (denom + smooth_dr)
    return (1.0 - dice).mean()


def _not_ported(name: str) -> Callable:
    def fn(*args, **kwargs):
        raise NotImplementedError(f"loss '{name}' is not ported yet")

    fn.__name__ = name
    return fn


_PORTED: Dict[str, Callable] = {
    "WeightedBCEWithLogitsLoss": bce_with_logits,
    "BCEWithLogitsLoss": bce_with_logits,
    "PerChannelBCEWithLogitsLoss": per_channel_bce,
    "PerChannelBCE": per_channel_bce,
    "DiceLoss": dice_loss,
    "GeneralizedDiceLoss": dice_loss,
    "WeightedMSELoss": mse_loss,
    "MSELoss": mse_loss,
    "SmoothL1Loss": smooth_l1_loss,
}
_NOT_PORTED = (
    "MalisLoss", "WeightedMAELoss", "MAELoss", "L1Loss", "CrossEntropyLoss", "FocalLoss",
    "TverskyLoss", "SoftClDiceLoss", "ScnpLoss", "BinaryReg", "ForegroundDTConsistency",
    "ContourDTConsistency", "NonOverlapReg", "GANLoss",
)
LOSS_REGISTRY: Dict[str, Callable] = {**_PORTED, **{n: _not_ported(n) for n in _NOT_PORTED}}


def get_loss(name: str) -> Callable:
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss '{name}'; available: {sorted(LOSS_REGISTRY)}")
    fn = LOSS_REGISTRY[name]
    if name not in _PORTED:
        fn()  # raises NotImplementedError naming the loss
    return fn
