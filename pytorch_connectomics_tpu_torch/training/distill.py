"""Knowledge distillation from a frozen teacher, the port of
``DistillSpec``, ``soft_target_loss`` and ``build_distill_spec`` in
``pytorch_connectomics_tpu/training/distill.py:29-145``.

The loss is per-channel sigmoid distillation of matching heads,

    L_distill = T^2 BCE(student / T, sigmoid(teacher / T))

(``mode: mse``: the mean squared difference of the logits), and the train
step's total ``(1 - alpha) L_hard + alpha L_distill`` (:mod:`.state`).

The teacher is the student's ``ModelConfig`` with ``teacher_model`` merged
over it, its weights read as ``--checkpoint`` reads them
(``runtime/dispatch.load_weights``: a port checkpoint, a flax ``.npz``, a
torch state dict by name or a foreign torch file through the shape-bucket
matcher). JAX's own teachers, a flax msgpack file or an Orbax directory,
raise ``NotImplementedError`` naming the format (the port reads neither).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .checkpoint import STATE_FILE, is_checkpoint_dir

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DistillSpec:
    model: torch.nn.Module  # the frozen teacher, in eval mode
    alpha: float = 0.5
    temperature: float = 2.0
    # "sigmoid" (per-channel binary soft targets) or "mse" (logit matching)
    mode: str = "sigmoid"


def _main_output(out):
    """The full-resolution prediction(s): deep-supervision outputs dropped."""
    if isinstance(out, dict):
        main = {k: v for k, v in out.items() if not k.startswith("ds_")}
        return main["out"] if set(main) == {"out"} else main
    return out


def soft_target_loss(student_logits, teacher_logits, temperature: float = 2.0, mode: str = "sigmoid"):
    """The distillation loss of matching heads (tensors or dicts of
    tensors), averaged over the heads; the teacher's side is detached."""
    s, t = _main_output(student_logits), _main_output(teacher_logits)
    s_leaves = s if isinstance(s, dict) else {"out": s}
    t_leaves = t if isinstance(t, dict) else {"out": t}
    keys = sorted(set(s_leaves) & set(t_leaves))
    if not keys:
        raise ValueError(f"no matching heads between student {sorted(s_leaves)} and teacher {sorted(t_leaves)}")
    total = 0.0
    for k in keys:
        sl, tl = s_leaves[k].float(), t_leaves[k].detach().float()
        if mode == "mse":
            total = total + ((sl - tl) ** 2).mean()
            continue
        soft, z = torch.sigmoid(tl / temperature), sl / temperature
        bce = F.relu(z) - z * soft + torch.log1p(torch.exp(-z.abs()))
        total = total + temperature * temperature * bce.mean()
    return total / len(keys)


def load_teacher(model: torch.nn.Module, path: str | Path, cfg) -> Dict[str, Any]:
    """Fill ``model`` from the teacher checkpoint ``path``; returns what
    ``load_weights`` restored."""
    from ..runtime.dispatch import load_weights
    from .model_weights import TORCH_SUFFIXES

    p = Path(path)
    if p.is_dir() and not is_checkpoint_dir(p):
        raise NotImplementedError(f"teacher {p}: an Orbax checkpoint directory, which the port does not read "
                                  f"(a port checkpoint directory holds {STATE_FILE})")
    if p.is_file() and not str(p).endswith(TORCH_SUFFIXES + (".npz",)):
        raise NotImplementedError(f"teacher {p}: a flax msgpack file, which the port does not read "
                                  f"(give a port checkpoint, a flax .npz or a torch file {TORCH_SUFFIXES})")
    return load_weights(model, str(p), cfg)


def build_distill_spec(cfg, device=None) -> Optional[DistillSpec]:
    """The spec of ``cfg.optimization.distill``, None without a teacher
    checkpoint."""
    distill_cfg = cfg.optimization.distill
    if not distill_cfg.teacher_checkpoint:
        return None
    from ..config.schema import ModelConfig, build_dataclass, to_dict
    from ..models import build_model

    base = to_dict(cfg.model)

    def merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(base, dict(distill_cfg.teacher_model or {}))
    teacher = build_model(build_dataclass(ModelConfig, base), device=device, seed=cfg.system.seed)
    restored = load_teacher(teacher, distill_cfg.teacher_checkpoint, cfg)
    teacher.eval()
    teacher.requires_grad_(False)
    logger.info("distillation teacher: %s", restored)
    return DistillSpec(model=teacher, alpha=float(distill_cfg.alpha), temperature=float(distill_cfg.temperature),
                       mode=str(distill_cfg.mode))
