"""Architecture registry (reference ``models/architectures/registry.py:17-106``).

Builders take ``(model_cfg: ModelConfig) -> torch.nn.Module``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}
_INFO: Dict[str, str] = {}


def register_architecture(name: str, info: str = ""):
    def deco(fn):
        _REGISTRY[name] = fn
        _INFO[name] = info or (fn.__doc__ or "").strip().split("\n")[0]
        return fn

    return deco


def get_architecture(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture '{name}'; available: {list_architectures()}")
    return _REGISTRY[name]


def list_architectures() -> List[str]:
    return sorted(_REGISTRY)


def architecture_info(name: str) -> str:
    return _INFO.get(name, "")
