"""Model construction (the port of ``pytorch_connectomics_tpu/models/build.py``)."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn as nn

from ..config.schema import ModelConfig
from ..utils.device import resolve_device
from .registry import get_architecture

# architecture modules self-register on import
from . import mednext as _mednext  # noqa: F401
from . import rsunet as _rsunet  # noqa: F401


def init_model(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init in place, following flax's defaults: LeCun-normal kernels
    (normal truncated at 2 sigma, std sqrt(1/fan_in)), zero biases, unit
    norm scales. Weight shapes of ``conv_weight``/``head_weight`` of
    transposed convs are (I, O, k...); every other kernel is (O, I, k...)."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:  # norm scale
                p.fill_(1.0)
            else:
                transposed = p.dim() == 5 and _is_transposed(model, name)
                fan_in = p.shape[0 if transposed else 1] * math.prod(p.shape[2:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                p.copy_(torch.nn.init.trunc_normal_(
                    torch.empty(p.shape), std=std, a=-2 * std, b=2 * std, generator=g
                ))
    return model


def _is_transposed(model: nn.Module, name: str) -> bool:
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    if leaf == "head_weight":
        return True
    return leaf == "conv_weight" and bool(getattr(mod, "transpose", False))


def build_model(
    model_cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None, seed: int = 0
) -> nn.Module:
    """ModelConfig -> seeded-init module in eval mode on ``device`` (default
    ``cuda``; raises when there is no GPU and the CPU was not asked for)."""
    dev = resolve_device(device)
    model = init_model(get_architecture(model_cfg.arch.type)(model_cfg), seed)
    return model.to(dev).eval()

