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
``gradnorm_g_*``).

The rest of JAX's step (``state.py:58-190``):
- ``augment_fn(batch, generator)`` (:mod:`..ops.augment`) runs on the
  batch before the forward, its generator on the batch's device seeded from
  ``seed`` and the step (:func:`step_generator`);
- ``accumulate`` k > 1 is ``optax.MultiSteps``: every micro-step takes the
  running mean of the raw gradients (``TrainState.accum``); the k-th clips
  that mean and applies it with the schedule at the update count
  ``step // k``. The step, the EMA (towards parameters that move every k
  steps), GradNorm's weights and the augmentation's generator advance every
  micro-step; ``grad_norm`` is the micro-step's own gradient's;
- ``distill`` (:class:`.distill.DistillSpec`): the frozen teacher's forward
  under ``no_grad`` and ``(1 - alpha) L + alpha L_distill``, logging
  ``loss_hard`` and ``loss_distill``;
- ``detect_anomaly`` raises ``FloatingPointError`` at the first module whose
  forward output holds a non-finite value, and autograd's anomaly mode at the
  first backward function that returns one (JAX's ``jax_debug_nans``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
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
    # gradient accumulation: the running mean of this cycle's gradients
    accum: Optional[List[torch.Tensor]] = None


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` for one step's draws, seeded from (seed,
    step) as JAX keys ``fold_in(PRNGKey(seed), step)``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0] >> 1))
    return g


def _finite_hook(name):
    def hook(module, args, out):
        leaves = out.values() if isinstance(out, dict) else (out if isinstance(out, (tuple, list)) else (out,))
        for t in leaves:
            if torch.is_tensor(t) and t.is_floating_point() and not torch.isfinite(t).all():
                raise FloatingPointError(f"non-finite value in the forward output of {name or 'the model'} "
                                         f"({type(module).__name__})")

    return hook


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
    augment_fn: Optional[Callable] = None,
    seed: int = 0,
    accumulate: int = 1,
    detect_anomaly: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``train_step(state, batch) -> logs``; ``batch`` holds ``image`` and
    ``label`` (and optionally ``mask``/``weight``), channels-last tensors on
    the model's device."""
    if balancing not in BALANCING:
        raise ValueError(f"loss balancing must be one of {BALANCING}, got {balancing!r}")
    gradnorm = balancing in ("gradnorm", "gradnorm_exact")
    k = max(1, int(accumulate))
    hooked: List[torch.nn.Module] = []

    def forward_loss(state, batch):
        model = state.model
        if detect_anomaly and model not in hooked:
            for name, mod in model.named_modules():
                mod.register_forward_hook(_finite_hook(name))
            hooked.append(model)
        out = model(batch["image"])
        term_w = state.balancer[0] if gradnorm and state.balancer is not None else None
        total, logs = orchestrator(out, batch.get("label"), mask=batch.get("mask"), weight=batch.get("weight"),
                                   balancer_params=state.log_vars, term_weights=term_w)
        if distill is not None:
            from .distill import soft_target_loss

            with torch.no_grad():
                teacher_out = distill.model(batch["image"])
            d_loss = soft_target_loss(out, teacher_out, temperature=distill.temperature, mode=distill.mode)
            logs["loss_hard"], logs["loss_distill"] = total, d_loss
            total = (1.0 - distill.alpha) * total + distill.alpha * d_loss
            logs["loss_total"] = total
        if detect_anomaly and not torch.isfinite(total):
            raise FloatingPointError(f"non-finite loss: {float(total)}")
        return out, total, logs

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        if augment_fn is not None:
            batch = augment_fn(batch, step_generator(seed, state.step, batch["image"].device))
        opt.zero_grad(set_to_none=True)
        if detect_anomaly:
            with torch.autograd.detect_anomaly(check_nan=True):
                out, total, logs = forward_loss(state, batch)
                total.backward()
        else:
            out, total, logs = forward_loss(state, batch)
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
        emit, count = True, state.step
        if k > 1:
            mini, count = state.step % k, state.step // k
            if state.accum is None:
                state.accum = [torch.zeros_like(g) for g in grads]
            with torch.no_grad():  # optax's running mean: acc + (g - acc) / (n + 1)
                for a, g in zip(state.accum, grads):
                    a.add_((g - a) / (mini + 1))
            emit = mini == k - 1
            if emit:
                for g, a in zip(grads, state.accum):
                    g.copy_(a)
                    a.zero_()
        if emit:
            if gradient_clip:
                clip_by_global_norm_(grads, float(gradient_clip), norm if k == 1 else global_norm(grads))
            set_lr(opt, schedule(count) * state.lr_scale)
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
