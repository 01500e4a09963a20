"""Loss zoo, the port of every loss of
``pytorch_connectomics_tpu/losses/zoo.py`` (``:18-283``) and its registry
and ``get_loss`` (``:286-320``); ``MalisLoss`` is :mod:`.malis`.

Every loss takes ``(pred, target, weight=None, mask=None)`` with
channels-last ``(N, Z, Y, X, C)`` tensors and returns a float32 scalar.
``weight`` is a voxel-wise weight map, ``mask`` restricts the loss to valid
voxels; losses take logits. ``contour_consistency`` takes a second
prediction in place of the target (the orchestrator's pred-vs-pred terms).
Min- and max-pools are ``F.max_pool3d`` with -inf padding, as JAX's
``reduce_window`` "SAME" windows.
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


def mae_loss(pred, target, weight=None, mask=None, tanh=False, **kw):
    """Absolute error of the logits (or of their tanh), masked mean."""
    p = pred.float()
    if tanh:
        p = torch.tanh(p)
    return _masked_mean((p - target.float()).abs(), weight, mask)


def cross_entropy_loss(pred, target, weight=None, mask=None, **kw):
    """Multi-class cross-entropy over the channels; ``target`` one-hot (as
    many channels as ``pred``) or a class map in its channel 0."""
    logp = torch.log_softmax(pred.float(), dim=-1)
    if target.shape[-1] == pred.shape[-1]:
        nll = -(target.float() * logp).sum(dim=-1)
    else:
        nll = -torch.gather(logp, -1, target[..., :1].long())[..., 0]
    if weight is not None and weight.shape[-1] == 1:
        weight = weight[..., 0]
    if mask is not None and mask.shape[-1] == 1:
        mask = mask[..., 0]
    return _masked_mean(nll, weight, mask)


def focal_loss(pred, target, weight=None, mask=None, alpha=0.25, gamma=2.0, **kw):
    p = torch.sigmoid(pred.float())
    t = target.float()
    pt = p * t + (1 - p) * (1 - t)
    at = alpha * t + (1 - alpha) * (1 - t)
    bce = -(t * torch.log(torch.clamp(p, min=1e-7)) + (1 - t) * torch.log(torch.clamp(1 - p, min=1e-7)))
    return _masked_mean(at * (1 - pt) ** gamma * bce, weight, mask)


def tversky_loss(pred, target, weight=None, mask=None, alpha=0.5, beta=0.5, sigmoid=True, smooth=1e-5, **kw):
    p = pred.float()
    if sigmoid:
        p = torch.sigmoid(p)
    t = target.float()
    if mask is not None:
        p, t = p * mask, t * mask
    axes = tuple(range(1, p.dim() - 1))
    tp = (p * t).sum(dim=axes)
    fp = (p * (1 - t)).sum(dim=axes)
    fn = ((1 - p) * t).sum(dim=axes)
    return (1.0 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)).mean()


def _max_pool(x: torch.Tensor, n: int) -> torch.Tensor:
    """Max over the ``n``-wide spatial window ("SAME", -inf outside) of a
    channels-last (N, [Z,] Y, X, C) tensor."""
    if x.dim() == 5:
        return F.max_pool3d(x.permute(0, 4, 1, 2, 3), n, 1, n // 2).permute(0, 2, 3, 4, 1)
    return F.max_pool2d(x.permute(0, 3, 1, 2), n, 1, n // 2).permute(0, 2, 3, 1)


def scnp_loss(pred, target, weight=None, mask=None, neighborhood_size=3, auto_pos_weight_flag=True, **kw):
    """Same-class neighbour penalisation: each voxel's logit replaced by its
    worst same-class neighbour in the ``N^3`` window (the least logit over
    foreground neighbours for foreground, the largest over background
    neighbours for background), then :func:`per_channel_bce`."""
    ns = int(neighborhood_size)
    if ns < 1 or ns % 2 == 0:
        raise ValueError(f"neighborhood_size must be a positive odd int, got {ns}")
    p = pred.float()
    t = target.float()
    fg = (t > 0.5).float()
    bg = 1.0 - fg
    large = 9999.0
    t1 = -_max_pool(-(p * fg + large * bg), ns)
    t2 = _max_pool(p * bg - large * fg, ns)
    return per_channel_bce(t1 * fg + t2 * bg, t, weight=weight, mask=mask, auto_pos_weight_flag=auto_pos_weight_flag)


def soft_skeletonize(img: torch.Tensor, num_iters: int = 5) -> torch.Tensor:
    """Soft skeleton of a (N, Z, Y, X, C) map by 3^3 min- and max-pools."""
    def erode(x):
        return -_max_pool(-x, 3)

    def opening(x):
        return _max_pool(erode(x), 3)

    skel = F.relu(img - opening(img))
    for _ in range(num_iters):
        img = erode(img)
        delta = F.relu(img - opening(img))
        skel = skel + F.relu(delta - skel * delta)
    return skel


def soft_cldice_loss(pred, target, weight=None, mask=None, num_iters=5, sigmoid=True, smooth=1.0, **kw):
    """Centreline Dice of the soft skeletons."""
    p = pred.float()
    if sigmoid:
        p = torch.sigmoid(p)
    t = target.float()
    sp, st = soft_skeletonize(p, num_iters), soft_skeletonize(t, num_iters)
    tprec = ((sp * t).sum() + smooth) / (sp.sum() + smooth)
    tsens = ((st * p).sum() + smooth) / (st.sum() + smooth)
    return 1.0 - 2.0 * tprec * tsens / (tprec + tsens)


def binary_reg(pred, target=None, weight=None, mask=None, **kw):
    """Pushes the sigmoid away from 0.5: mean of 1 / (|p - 0.5| + 0.01)."""
    p = torch.sigmoid(pred.float())
    return (1.0 / ((p - 0.5).abs() + 1e-2)).mean()


def foreground_dt_consistency(pred, target, weight=None, mask=None, **kw):
    """|sigmoid(pred) - (target > 0)|, masked mean."""
    p = torch.sigmoid(pred.float())
    return _masked_mean((p - (target.float() > 0).float()).abs(), weight, mask)


def contour_consistency(pred, pred2, weight=None, mask=None, **kw):
    """(min(1, the sum of sigmoid(pred)'s backward differences on z, y, x) -
    sigmoid(pred2))^2, masked mean: the contour where the mask changes."""
    p = torch.sigmoid(pred.float())
    c = torch.sigmoid(pred2.float())
    grad = sum((torch.diff(p, dim=d, prepend=p.narrow(d, 0, 1))).abs() for d in (1, 2, 3))
    return _masked_mean((torch.clamp(grad, 0.0, 1.0) - c) ** 2, weight, mask)


def nonoverlap_reg(pred, target=None, weight=None, mask=None, **kw):
    """Mean over voxels of the product of the channels' sigmoids."""
    return torch.sigmoid(pred.float()).prod(dim=-1).mean()


def gan_loss(pred, target, weight=None, mask=None, mode="lsgan", **kw):
    """LSGAN (squared error) or vanilla (BCE) loss on logits, target 0/1."""
    p, t = pred.float(), target.float()
    if mode == "lsgan":
        return ((p - t) ** 2).mean()
    return bce_with_logits(p, t)


def _malis(pred, target, weight=None, mask=None, **kw):
    from .malis import malis_loss

    return malis_loss(pred, target, weight, mask, **kw)


LOSS_REGISTRY: Dict[str, Callable] = {
    "MalisLoss": _malis,
    "WeightedBCEWithLogitsLoss": bce_with_logits,
    "BCEWithLogitsLoss": bce_with_logits,
    "PerChannelBCEWithLogitsLoss": per_channel_bce,
    "PerChannelBCE": per_channel_bce,
    "DiceLoss": dice_loss,
    "GeneralizedDiceLoss": dice_loss,
    "WeightedMSELoss": mse_loss,
    "MSELoss": mse_loss,
    "WeightedMAELoss": mae_loss,
    "MAELoss": mae_loss,
    "L1Loss": mae_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "CrossEntropyLoss": cross_entropy_loss,
    "FocalLoss": focal_loss,
    "TverskyLoss": tversky_loss,
    "SoftClDiceLoss": soft_cldice_loss,
    "ScnpLoss": scnp_loss,
    "BinaryReg": binary_reg,
    "ForegroundDTConsistency": foreground_dt_consistency,
    "ContourDTConsistency": contour_consistency,
    "NonOverlapReg": nonoverlap_reg,
    "GANLoss": gan_loss,
}


def get_loss(name: str) -> Callable:
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss '{name}'; available: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name]
