"""Coherence checks across config sections before a run starts, the port of
``pytorch_connectomics_tpu/runtime/preflight.py``: raises on a config that
cannot run, returns (and logs) warnings for one that runs badly.

The activation-memory warning reads the card's memory
(``torch.cuda.mem_get_info``); on the CPU it gives no estimate.
"""

from __future__ import annotations

import logging
from glob import glob
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..config.schema import Config

logger = logging.getLogger(__name__)

_DS_ARCHS = {"mednext", "rsunet"}


def _device_memory_gb() -> float:
    """The card's total memory in GB; 0 without a CUDA device."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.mem_get_info()[1] / 1e9


def preflight_check(cfg: Config, mode: str = "train") -> List[str]:
    """Raises ``ValueError`` on an incoherent config, returns warnings
    otherwise."""
    warnings: List[str] = []
    m = cfg.model
    if m.loss.deep_supervision and m.arch.type not in _DS_ARCHS:
        raise ValueError(f"deep supervision is only supported for {_DS_ARCHS}, got {m.arch.type}")
    # a per-head loss term must name a declared head
    heads = {h.name for h in (m.mednext.heads or [])}
    for term in m.loss.losses:
        if term.head and heads and term.head not in heads:
            raise ValueError(f"loss term references unknown head '{term.head}'; heads: {sorted(heads)}")
    w = cfg.inference.window.window_size
    if w and list(w) != list(m.input_size):
        warnings.append(
            f"inference window {w} != model.input_size {m.input_size} (legal, but retracing happens per shape)"
        )
    ch = cfg.inference.chunked
    if ch.enabled and ch.chunk_size and w:
        for c, ww in zip(ch.chunk_size, w):
            if c < ww:
                raise ValueError(f"chunk_size {ch.chunk_size} smaller than window {w}")
    # the patchify stem's stride times the four encoder downsamples must
    # divide every axis, or the decoder's skip adds fail on their shapes
    if m.arch.type == "mednext" and getattr(m.mednext, "patchify_stem", False):
        stride = list(getattr(m.mednext, "patchify_stride", None) or (2, 2, 2))
        for size in filter(None, [m.input_size, w]):
            for s, n in zip(stride, size):
                if n % (s * 16):
                    raise ValueError(
                        f"patchify stem with stride {stride}: size {list(size)} axis {n} must be divisible by "
                        f"{s * 16} (stem stride x 16 for the 4 encoder downsamples)"
                    )
    warnings += _mutex_offset_issues(cfg)
    if mode == "train":
        dl = cfg.data.dataloader
        if dl.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if cfg.optimization.max_epochs < 1 and not cfg.optimization.max_steps:
            raise ValueError("need max_epochs or max_steps")
        targets = {t.name for t in (cfg.data.label_transform.targets or [])}
        if "affinity" in targets and m.out_channels < 3:
            warnings.append("affinity targets with <3 out_channels")
        warnings += _train_path_issues(cfg)
        ps = dl.patch_size or []
        if ps and min(ps) < 16 and min(ps) != 1:  # 1: a 2-D workload
            warnings.append(f"very small patch size {ps} (little spatial context)")
        if ps and max(ps) > 256:
            warnings.append(f"very large patch size {ps} (HBM pressure; watch for OOM)")
        lr = cfg.optimization.optimizer.lr
        if lr is not None and lr > 1e-2:
            warnings.append(f"learning rate {lr} is very high (instability risk)")
        if lr is not None and 0 < lr < 1e-6:
            warnings.append(f"learning rate {lr} is very low (training will crawl)")
        # a rough activation-memory estimate against the card's memory
        mem_gb = _device_memory_gb()
        if mem_gb:
            est_gb = dl.batch_size * float(np.prod(ps or m.input_size)) * m.in_channels * 4 * 10 / 1e9
            if est_gb > 0.8 * mem_gb:
                warnings.append(
                    f"estimated activation memory ~{est_gb:.1f} GB may exceed {mem_gb:.0f} GB HBM; reduce "
                    "batch/patch or enable remat"
                )
    if mode in ("tune", "tune-test") and not cfg.decoding.tuning.params:
        warnings.append("tune mode without decoding.tuning.params does nothing")
    for msg in warnings:
        logger.warning("preflight: %s", msg)
    return warnings


def _mutex_offset_issues(cfg: Config) -> List[str]:
    """A ``mutex_watershed`` step whose affinity offsets are all short-range
    has no repulsive edges: it reduces to plain agglomeration and
    over-merges."""
    mutex_steps = [s for s in cfg.decoding.steps or [] if (s.name or "") == "mutex_watershed"]
    if not mutex_steps:
        return []
    from ..data.targets.affinity import parse_offsets

    def long_range(offs) -> bool:
        try:
            parsed = parse_offsets(offs)
        except (ValueError, TypeError):
            return True  # malformed: the decoder raises its own error
        return any(max(abs(c) for c in o) > 1 for o in parsed)

    issues: List[str] = []
    for s in mutex_steps:
        # the step's offsets, else the affinity target's
        offs = (s.kwargs or {}).get("offsets")
        if offs is None:
            for t in cfg.data.label_transform.targets or []:
                if t.name == "affinity":
                    offs = (t.kwargs or {}).get("offsets")
        if offs is not None and not long_range(offs):
            issues.append(
                "mutex_watershed configured over short-range-only affinity "
                f"offsets {list(offs)}: no repulsive (long-range) edges — "
                "expect severe over-merging; add offsets with |component| > 1 "
                "(e.g. [0,0,-9], [0,-9,0], [-4,0,0])"
            )
    return issues


def _train_path_issues(cfg: Config) -> List[str]:
    """Train volumes that do not exist, or patterns that match nothing."""
    issues: List[str] = []
    for kind in ("image", "label"):
        value = getattr(cfg.data.train, kind)
        for raw in value if isinstance(value, list) else ([value] if value else []):
            raw = str(raw)
            if raw.startswith(("random://", "synthetic://")):
                continue
            raw = raw.split(":")[0]
            if "*" in raw or "?" in raw:
                if not glob(raw):
                    issues.append(f"train {kind} pattern matched no files: {raw}")
            elif not Path(raw).exists():
                issues.append(f"train {kind} not found: {raw}")
    return issues
