"""Train state and the train/val step functions, the port of
``create_train_state``, ``make_train_step`` and ``make_val_step`` in
``pytorch_connectomics_tpu/training/state.py:58-221``.

JAX's train state is an immutable pytree and its step a pure function; the
port keeps PyTorch's habit instead: :class:`TrainState` holds the model and
the optimizer, and a step updates the parameters, the optimizer moments and
the EMA copy in place (no second copy of the parameters).

One train step: forward (the model routes its stride-1 blocks through the
training block, since grad is enabled), loss orchestrator, backward, global
norm of the raw gradients, clip, the optimizer with the learning rate
``schedule(step) * lr_scale``, the EMA update, and the logs: every
``loss_*``, ``loss_total`` and ``grad_norm``, as 0-d tensors on the device
(the caller reads them when it logs). The val step runs under
``torch.no_grad()``, so the model runs the fused inference kernels.
GradNorm and uncertainty balancing and distillation raise
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..metrics.binary import binary_accuracy, dice_coefficient, jaccard_index
from .optim import Schedule, clip_by_global_norm_, global_norm, set_lr


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    lr_scale: float = 1.0


def create_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, ema: bool = False) -> TrainState:
    ema_params = {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
    return TrainState(model=model, optimizer=optimizer, ema=ema_params)


def make_train_step(
    orchestrator,
    schedule: Schedule,
    gradient_clip: Optional[float] = None,
    ema_decay: Optional[float] = None,
    balancing: Optional[str] = None,
    distill=None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``train_step(state, batch) -> logs``; ``batch`` holds ``image`` and
    ``label`` (and optionally ``mask``/``weight``), channels-last tensors on
    the model's device."""
    if balancing:
        raise NotImplementedError(f"loss balancing '{balancing}' is not ported yet")
    if distill is not None:
        raise NotImplementedError("distillation is not ported yet")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        out = model(batch["image"])
        total, logs = orchestrator(out, batch.get("label"), mask=batch.get("mask"), weight=batch.get("weight"))
        total.backward()
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        missing = [n for n, p in named if p.grad is None]
        if missing:
            raise RuntimeError(f"parameters without a gradient: {missing[:5]}")
        grads = [p.grad for _, p in named]
        norm = global_norm(grads)
        if gradient_clip:
            clip_by_global_norm_(grads, float(gradient_clip), norm)
        set_lr(opt, schedule(state.step) * state.lr_scale)
        opt.step()
        if state.ema is not None and ema_decay is not None:
            with torch.no_grad():
                ema = [state.ema[n] for n, _ in named]
                torch._foreach_lerp_(ema, [p.detach() for _, p in named], 1.0 - ema_decay)
        state.step += 1
        logs = {k: v.detach() for k, v in logs.items()}
        logs["grad_norm"] = norm
        return logs

    return train_step


def make_val_step(orchestrator, use_ema: bool = False) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, float]]:
    """``val_step(state, batch) -> logs``: ``val_loss`` and the loss terms,
    and ``val_jaccard``/``val_dice``/``val_accuracy`` of the first
    ``min(C_out, C_label)`` channels, as floats."""

    def val_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        model = state.model
        with torch.no_grad():
            if use_ema and state.ema is not None:
                out = torch.func.functional_call(model, state.ema, (batch["image"],))
            else:
                out = model(batch["image"])
            total, logs = orchestrator(out, batch.get("label"), mask=batch.get("mask"), weight=batch.get("weight"))
        res = {k: float(v) for k, v in logs.items()}
        if "label" in batch:
            t = batch["label"]
            c = min(out.shape[-1], t.shape[-1])
            p, t = out[..., :c].float().cpu().numpy(), t[..., :c].float().cpu().numpy()
            res["val_jaccard"] = float(jaccard_index(p, t))
            res["val_dice"] = float(dice_coefficient(p, t))
            res["val_accuracy"] = float(binary_accuracy(p, t))
        res["val_loss"] = float(total)
        return res

    return val_step
