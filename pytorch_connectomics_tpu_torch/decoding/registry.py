"""Decoder registry and the linear steps pipeline (the port of the steps
part of ``pytorch_connectomics_tpu/decoding/registry.py:19-56``).

Decoders take ``(prediction (C, Z, Y, X) float32, **kwargs)`` and return
labels ``(Z, Y, X)`` or an intermediate array for the next step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

_DECODERS: Dict[str, Callable] = {}


def register_decoder(name: str):
    def deco(fn):
        _DECODERS[name] = fn
        return fn

    return deco


def get_decoder(name: str) -> Callable:
    if name not in _DECODERS:
        raise NotImplementedError(f"decoder '{name}' is not ported yet; ported: {list_decoders()}")
    return _DECODERS[name]


def list_decoders() -> List[str]:
    return sorted(_DECODERS)


def run_steps(prediction: np.ndarray, steps: List[Any]) -> np.ndarray:
    """Each step's output feeds the next. A step is a ``DecodingStepConfig``
    or a dict with ``name``, ``kwargs`` and extra keys, which join the
    kwargs."""
    out = prediction
    for step in steps:
        name = step.name if hasattr(step, "name") else step["name"]
        kwargs = dict(getattr(step, "kwargs", None) or (step.get("kwargs") if isinstance(step, dict) else None) or {})
        extra = getattr(step, "extra", None) or {}
        kwargs.update({k: v for k, v in extra.items() if k not in ("name", "kwargs")})
        out = get_decoder(name)(out, **kwargs)
    return out
