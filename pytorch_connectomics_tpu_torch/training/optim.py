"""Optimizer and learning-rate schedule, the port of ``build_schedule`` and
``build_optimizer`` in ``pytorch_connectomics_tpu/training/optim.py:20-142``.

A schedule is a plain ``count -> lr`` function with optax's formulas, where
``count`` is the 0-based number of updates already applied (optax evaluates
the schedule at the update's count, so the first update uses ``lr(0)``).
Every schedule of JAX's ``build_schedule``: constant, ``WarmupCosineLR``,
``CosineAnnealingLR``, ``CosineAnnealingWarmRestarts`` (optax's
``join_schedules`` of cosine decays of ``t_0``, ``t_0 t_mult``, ... steps),
``StepLR``, ``MultiStepLR``, ``WarmupMultiStepLR`` and
``ReduceLROnPlateau`` (a constant; the trainer scales it by its host
``lr_scale``).

The optimizers: ``torch.optim.AdamW``/``Adam``, whose update equals optax's
``adamw``/``adam`` (decoupled decay on the pre-update parameter, ``eps``
outside the square root), with parameter groups of optax's decay mask (a
parameter whose leaf name is a bias, ``bias`` or ``*_bias``, or that has at
most one dimension, norm scales, is not decayed); ``torch.optim.SGD``, whose
momentum buffer and coupled weight decay are optax's
``chain(add_decayed_weights, sgd)`` (every parameter decayed, as JAX's
chain has no mask); and :class:`Lamb`, optax's ``lamb``. The trainer sets
each group's ``lr`` from the schedule before every update.
Gradient accumulation (``accumulate_grad_batches``) is the train step's
(:mod:`.state`), with ``optax.MultiSteps``' semantics.

The global-norm clip is written out as ``optax.clip_by_global_norm``
computes it: the gradients are scaled by ``max / norm`` only when
``norm > max`` (``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6`` instead).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def build_schedule(opt_cfg, steps_per_epoch: int) -> Schedule:
    s = opt_cfg.scheduler
    base_lr = float(opt_cfg.optimizer.lr)
    name = (s.name or "").lower()
    total_steps = opt_cfg.max_steps or max(1, opt_cfg.max_epochs * steps_per_epoch)
    params = s.params or {}
    # scheduler.interval: "epoch" counts warmup/t_max in epochs, "step" in steps
    unit = 1 if s.interval == "step" else steps_per_epoch
    warmup_steps = s.warmup_steps
    if warmup_steps is None:
        warmup_steps = int(params.get("warmup_epochs", s.warmup_epochs) * unit)

    if name in ("", "none", "constant"):
        return lambda count: base_lr
    if name == "warmupcosinelr":
        min_lr = float(params.get("min_lr", s.min_lr))
        start = float(params.get("warmup_start_lr", s.warmup_start_lr))
        # a run shorter than its warmup: clamp so the decay stays positive
        warm = min(max(1, warmup_steps), max(1, total_steps - 1))
        warmup = _linear(start, base_lr, warm)
        decay = _cosine(base_lr, total_steps - warm, 0.0 if base_lr == 0.0 else min_lr / base_lr)
        return lambda count: warmup(count) if count < warm else decay(count - warm)
    if name == "cosineannealinglr":
        t_max = int(params.get("t_max", s.t_max or opt_cfg.max_epochs)) * unit
        return _cosine(base_lr, max(1, t_max), s.min_lr / base_lr if base_lr else 0.0)
    if name == "cosineannealingwarmrestarts":
        t, acc, pieces, boundaries = int(params.get("t_0", s.t_0 or 10)) * unit, 0, [], []
        while acc < total_steps:
            pieces.append(_cosine(base_lr, max(1, t)))
            acc += t
            boundaries.append(acc)
            t *= max(1, s.t_mult)
        return _join(pieces, boundaries[:-1])
    if name == "steplr":
        step_size = max(1, int(params.get("step_size", s.step_size)) * unit)
        return lambda count: base_lr * s.gamma ** (count // step_size)
    milestones = [int(m) * unit for m in (s.milestones or params.get("milestones", []))]
    if name == "multisteplr":
        return lambda count: base_lr * s.gamma ** sum(count >= m for m in milestones)
    if name == "warmupmultisteplr":
        start = float(params.get("warmup_start_lr", s.warmup_start_lr))

        def schedule(count):
            if count < warmup_steps:
                return start + (base_lr - start) * min(max(count / max(1, warmup_steps), 0.0), 1.0)
            return base_lr * s.gamma ** sum(count >= m for m in milestones)

        return schedule
    if name == "reducelronplateau":
        return lambda count: base_lr
    raise ValueError(f"unknown scheduler '{s.name}'")


def _join(pieces, boundaries) -> Schedule:
    """optax's ``join_schedules``: piece i from boundary i - 1 on, counted
    from that boundary."""
    def schedule(count):
        out = pieces[0](count)
        for b, piece in zip(boundaries, pieces[1:]):
            if count >= b:
                out = piece(count - b)
        return out

    return schedule


def decay_groups(named_params: Iterable[Tuple[str, torch.nn.Parameter]], weight_decay: float, no_decay_bias: bool):
    """Parameter groups of optax's decay mask."""
    decay: List[torch.nn.Parameter] = []
    keep: List[torch.nn.Parameter] = []
    for name, p in named_params:
        leaf = name.rsplit(".", 1)[-1]
        exempt = no_decay_bias and (leaf == "bias" or leaf.endswith("_bias") or p.dim() <= 1)
        (keep if exempt else decay).append(p)
    groups = [{"params": decay, "weight_decay": weight_decay}]
    if keep:
        groups.append({"params": keep, "weight_decay": 0.0})
    return groups


def build_optimizer(opt_cfg, model: torch.nn.Module, steps_per_epoch: int,
                    extra_params: Iterable[Tuple[str, torch.nn.Parameter]] = ()) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer, schedule). The optimizer's ``lr`` is set per step by the
    caller from ``schedule``. ``extra_params`` (name, parameter) train
    beside the model's, as the uncertainty balancer's log-variances do in
    JAX's ``{"model": ..., "balancer": ...}`` tree."""
    o = opt_cfg.optimizer
    schedule = build_schedule(opt_cfg, steps_per_epoch)
    name = o.name.lower()
    betas = (float(o.betas[0]), float(o.betas[1]))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad] + list(extra_params)
    if name == "adamw":
        groups = decay_groups(named, float(o.weight_decay), o.no_decay_bias)
        opt = torch.optim.AdamW(groups, lr=schedule(0), betas=betas, eps=float(o.eps))
    elif name == "adam":
        opt = torch.optim.Adam([p for _, p in named], lr=schedule(0), betas=betas, eps=float(o.eps))
    elif name == "sgd":
        opt = torch.optim.SGD([p for _, p in named], lr=schedule(0), momentum=float(o.momentum),
                              weight_decay=float(o.weight_decay))
    elif name == "lamb":
        opt = Lamb([p for _, p in named], lr=schedule(0), weight_decay=float(o.weight_decay))
    else:
        raise ValueError(f"unknown optimizer '{o.name}'")
    return opt, schedule


class Lamb(torch.optim.Optimizer):
    """optax's ``lamb`` (its defaults: b1 0.9, b2 0.999, eps 1e-6, no mask):
    Adam's bias-corrected step, plus ``weight_decay * p``, scaled per
    parameter by ``|p| / |update|`` (by 1 where either norm is 0), times
    ``lr``."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                if not st:
                    st["count"], st["mu"], st["nu"] = 0, torch.zeros_like(g), torch.zeros_like(g)
                st["count"] += 1
                st["mu"].mul_(b1).add_(g, alpha=1 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                # the bias corrections in float32, as optax takes them
                bc1, bc2 = (1 - torch.tensor(b, dtype=torch.float32) ** st["count"] for b in (b1, b2))
                u = (st["mu"] / bc1.to(g.device)) / (torch.sqrt(st["nu"] / bc2.to(g.device)) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p.float()
                pn, un = torch.linalg.vector_norm(p.float()), torch.linalg.vector_norm(u)
                ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                p.sub_((group["lr"] * ratio * u).to(p.dtype))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float, norm: torch.Tensor) -> None:
    """Scale ``grads`` in place by ``max_norm / norm`` where ``norm >
    max_norm`` (on the device: no host sync)."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for g in opt.param_groups:
        g["lr"] = lr

