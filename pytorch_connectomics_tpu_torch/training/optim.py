"""Optimizer and learning-rate schedule, the port of ``build_schedule`` and
``build_optimizer`` in ``pytorch_connectomics_tpu/training/optim.py:20-142``.

A schedule is a plain ``count -> lr`` function with optax's formulas, where
``count`` is the 0-based number of updates already applied (optax evaluates
the schedule at the update's count, so the first update uses ``lr(0)``).
The optimizer is ``torch.optim.AdamW``/``Adam``, whose update equals
optax's ``adamw``/``adam`` (decoupled decay on the pre-update parameter,
``eps`` outside the square root); the trainer sets each group's ``lr`` from
the schedule before every step. Parameter groups follow optax's decay mask:
a parameter whose leaf name is a bias (``bias``, ``*_bias``) or that has at
most one dimension (norm scales) is not decayed.

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
    raise NotImplementedError(f"scheduler '{s.name}' is not ported yet (constant, WarmupCosineLR, CosineAnnealingLR)")


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


def build_optimizer(opt_cfg, model: torch.nn.Module, steps_per_epoch: int) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer, schedule). The optimizer's ``lr`` is set per step by the
    caller from ``schedule``."""
    o = opt_cfg.optimizer
    if opt_cfg.accumulate_grad_batches > 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    schedule = build_schedule(opt_cfg, steps_per_epoch)
    name = o.name.lower()
    betas = (float(o.betas[0]), float(o.betas[1]))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if name == "adamw":
        groups = decay_groups(named, float(o.weight_decay), o.no_decay_bias)
        opt = torch.optim.AdamW(groups, lr=schedule(0), betas=betas, eps=float(o.eps))
    elif name == "adam":
        opt = torch.optim.Adam([p for _, p in named], lr=schedule(0), betas=betas, eps=float(o.eps))
    else:
        raise NotImplementedError(f"optimizer '{o.name}' is not ported yet (AdamW, Adam)")
    return opt, schedule


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

