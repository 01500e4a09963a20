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

Loss balancing (``model.loss.balancing.method``, JAX ``state.py:32-46,
84-190``): ``uncertainty`` trains a log-variance a term
(``TrainState.log_vars``, in the optimizer beside the model's parameters,
in the clip's global norm, outside the EMA); ``gradnorm`` and
``gradnorm_exact`` keep ``TrainState.balancer``, row 0 the term weights
the loss is taken with and row 1 the initial losses L_i(0) (the first
step's), and update it after the step from the step's losses (``exact``:
also from the norms of d loss_i / d output, one backward through the loss
only, ``torch.autograd.grad``), logging ``gradnorm_w_*`` (and
``gradnorm_g_*``). Distillation raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..losses.balancing import gradnorm_exact_weights, gradnorm_weights
from ..metrics.binary import binary_accuracy, dice_coefficient, jaccard_index
from .optim import Schedule, clip_by_global_norm_, global_norm, set_lr

BALANCING = (None, "uncertainty", "gradnorm", "gradnorm_exact")


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    lr_scale: float = 1.0
    # GradNorm: row 0 the term weights, row 1 the initial losses L_i(0)
    balancer: Optional[torch.Tensor] = None
    # uncertainty balancing: the trained log-variances, one a term
    log_vars: Optional[torch.nn.Parameter] = None


def make_log_vars(balancing: Optional[str], num_terms: int, device) -> Optional[torch.nn.Parameter]:
    """The uncertainty balancer's log-variances (zeros), else None; made
    before the optimizer, which trains them."""
    if balancing != "uncertainty":
        return None
    return torch.nn.Parameter(torch.zeros(num_terms, dtype=torch.float32, device=device))


def create_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, ema: bool = False,
                       gradnorm_terms: int = 0, log_vars: Optional[torch.nn.Parameter] = None) -> TrainState:
    ema_params = {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
    balancer = None
    if gradnorm_terms:
        dev = next(model.parameters()).device
        balancer = torch.stack([torch.ones(gradnorm_terms, device=dev), torch.zeros(gradnorm_terms, device=dev)])
    return TrainState(model=model, optimizer=optimizer, ema=ema_params, balancer=balancer, log_vars=log_vars)


def term_grad_norms(orchestrator, out, batch) -> torch.Tensor:
    """(terms,) norms of d loss_i / d output over every output leaf: the
    outputs detached, the loss terms taken again without weights, one
    backward through the loss a term."""
    with torch.enable_grad():
        o = {k: v.detach().requires_grad_() for k, v in out.items()} if isinstance(out, dict) \
            else out.detach().requires_grad_()
        _, lg = orchestrator(o, batch.get("label"), mask=batch.get("mask"), weight=batch.get("weight"))
        leaves = list(o.values()) if isinstance(o, dict) else [o]
        norms = []
        for t in orchestrator.terms:
            gs = torch.autograd.grad(lg[f"loss_{t.name}"], leaves, retain_graph=True, allow_unused=True)
            norms.append(global_norm([g if g is not None else torch.zeros_like(x) for g, x in zip(gs, leaves)]))
    return torch.stack(norms)


def make_train_step(
    orchestrator,
    schedule: Schedule,
    gradient_clip: Optional[float] = None,
    ema_decay: Optional[float] = None,
    balancing: Optional[str] = None,
    balancing_alpha: float = 1.5,
    balancing_lr: float = 0.025,
    distill=None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``train_step(state, batch) -> logs``; ``batch`` holds ``image`` and
    ``label`` (and optionally ``mask``/``weight``), channels-last tensors on
    the model's device."""
    if balancing not in BALANCING:
        raise ValueError(f"loss balancing must be one of {BALANCING}, got {balancing!r}")
    gradnorm = balancing in ("gradnorm", "gradnorm_exact")
    if distill is not None:
        raise NotImplementedError("distillation is not ported yet")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        out = model(batch["image"])
        term_w = state.balancer[0] if gradnorm and state.balancer is not None else None
        total, logs = orchestrator(out, batch.get("label"), mask=batch.get("mask"), weight=batch.get("weight"),
                                   balancer_params=state.log_vars, term_weights=term_w)
        total.backward()
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        missing = [n for n, p in named if p.grad is None]
        if missing:
            raise RuntimeError(f"parameters without a gradient: {missing[:5]}")
        grads = [p.grad for _, p in named]
        if state.log_vars is not None:
            if state.log_vars.grad is None:  # one term: the total does not take them
                state.log_vars.grad = torch.zeros_like(state.log_vars)
            grads.append(state.log_vars.grad)
        norm = global_norm(grads)
        if gradient_clip:
            clip_by_global_norm_(grads, float(gradient_clip), norm)
        set_lr(opt, schedule(state.step) * state.lr_scale)
        opt.step()
        if state.ema is not None and ema_decay is not None:
            with torch.no_grad():
                ema = [state.ema[n] for n, _ in named]
                torch._foreach_lerp_(ema, [p.detach() for _, p in named], 1.0 - ema_decay)
        logs = {k: v.detach() for k, v in logs.items()}
        if gradnorm and state.balancer is not None:
            term_losses = [logs[f"loss_{t.name}"] for t in orchestrator.terms]
            initial = torch.stack(term_losses) if state.step == 0 else state.balancer[1]
            if balancing == "gradnorm_exact":
                g_norms = term_grad_norms(orchestrator, out, batch)
                new_w = gradnorm_exact_weights(g_norms, term_losses, initial, state.balancer[0],
                                               alpha=balancing_alpha, lr=balancing_lr)
                for i, t in enumerate(orchestrator.terms):
                    logs[f"gradnorm_g_{t.name}"] = g_norms[i]
            else:
                new_w = gradnorm_weights(term_losses, initial, state.balancer[0], alpha=balancing_alpha,
                                         lr=balancing_lr)
            state.balancer = torch.stack([new_w, initial])
            for i, t in enumerate(orchestrator.terms):
                logs[f"gradnorm_w_{t.name}"] = new_w[i]
        state.step += 1
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
        out = out["out"] if isinstance(out, dict) and "out" in out else out
        if "label" in batch and not isinstance(out, dict):  # no binary metrics of task heads, as in JAX
            t = batch["label"]
            c = min(out.shape[-1], t.shape[-1])
            p, t = out[..., :c].float().cpu().numpy(), t[..., :c].float().cpu().numpy()
            res["val_jaccard"] = float(jaccard_index(p, t))
            res["val_dice"] = float(dice_coefficient(p, t))
            res["val_accuracy"] = float(binary_accuracy(p, t))
        res["val_loss"] = float(total)
        return res

    return val_step
