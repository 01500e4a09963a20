"""Loss orchestrator for plain weighted terms, the port of
``LossOrchestrator`` in ``pytorch_connectomics_tpu/losses/orchestrator.py:73-232``.

It compiles ``model.loss.losses`` once; ``orchestrator(outputs, targets,
mask, weight)`` returns ``(total, logs)`` with ``logs["loss_<Function>_<i>"]``
per term and ``logs["loss_total"]`` (tensors, still on the device). Terms
route channels with ``pred_slice``/``target_slice``/``mask_slice``, take a
numeric ``pos_weight`` and the batch's mask and spatial weight as the JAX
package does. Deep supervision, multi-head outputs, ``pos_weight: auto``,
pred-vs-pred terms and uncertainty/GradNorm balancing raise
``NotImplementedError``; affinity validity masks have no use until an
affinity target is ported (``data/targets`` raises on it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..utils.slicing import parse_slice
from .zoo import get_loss


def _channels(x: torch.Tensor, spec: Optional[str]) -> torch.Tensor:
    return x[..., parse_slice(spec)]


@dataclass
class CompiledTerm:
    name: str
    fn: Callable
    weight: float
    pred_slice: Optional[str]
    target_slice: Optional[str]
    mask_slice: Optional[str]
    kwargs: Dict[str, Any]
    # how the batch's spatial weight reaches the term: "weight" (default),
    # "mask" (folded into the loss mask) or "none"
    spatial_weight: Optional[str] = None


class LossOrchestrator:
    def __init__(self, loss_cfg):
        self.cfg = loss_cfg
        for flag, what in (
            (loss_cfg.deep_supervision, "deep supervision"),
            (loss_cfg.balancing.method, f"loss balancing '{loss_cfg.balancing.method}'"),
        ):
            if flag:
                raise NotImplementedError(f"{what} is not ported yet")
        self.terms = []
        for i, t in enumerate(loss_cfg.losses):
            for flag, what in (
                (t.head, "multi-head loss terms"),
                (t.pred2_slice, "pred-vs-pred loss terms"),
                (t.pos_weight == "auto", "pos_weight: auto"),
            ):
                if flag:
                    raise NotImplementedError(f"{what} ({t.function}) is not ported yet")
            if t.spatial_weight not in (None, "weight", "mask", "none"):
                raise ValueError(f"loss term {t.function}: spatial_weight must be weight|mask|none, got {t.spatial_weight!r}")
            kwargs = dict(t.kwargs or {})
            kwargs.update(getattr(t, "extra", None) or {})
            if t.pos_weight is not None:
                kwargs["pos_weight"] = float(t.pos_weight)
            self.terms.append(CompiledTerm(
                name=f"{t.function}_{i}", fn=get_loss(t.function), weight=float(t.weight),
                pred_slice=t.pred_slice, target_slice=t.target_slice, mask_slice=t.mask_slice,
                kwargs=kwargs, spatial_weight=t.spatial_weight,
            ))

    def _term_loss(self, term: CompiledTerm, pred, target, mask=None, weight=None):
        p = _channels(pred, term.pred_slice)
        t = _channels(target, term.target_slice)
        m = None
        if mask is not None:
            m = mask if mask.shape[-1] == 1 else _channels(mask, term.pred_slice)
        if term.mask_slice is not None:
            m2 = _channels(target, term.mask_slice)
            m = m2 if m is None else m * m2
        w = None
        if weight is not None and term.spatial_weight != "none":
            w = weight if weight.shape[-1] == 1 else _channels(weight, term.pred_slice)
            if term.spatial_weight == "mask":
                m = w if m is None else m * w
                w = None
        return term.fn(p, t, weight=w, mask=m, **term.kwargs)

    def compute(self, outputs, targets, mask=None, weight=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if isinstance(outputs, dict):
            raise NotImplementedError("multi-head and deep-supervision outputs are not ported yet")
        tgt = targets["label"] if isinstance(targets, dict) else targets
        logs: Dict[str, torch.Tensor] = {}
        total = None
        for term in self.terms:
            # a non-finite term propagates, so the trainer's finite check names it
            value = self._term_loss(term, outputs, tgt, mask, weight)
            logs[f"loss_{term.name}"] = value
            total = term.weight * value if total is None else total + term.weight * value
        logs["loss_total"] = total
        return total, logs

    __call__ = compute
