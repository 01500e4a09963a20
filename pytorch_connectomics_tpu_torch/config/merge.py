"""Deep-merge utilities for the YAML config pipeline.

Merge semantics follow the reference's OmegaConf usage: nested dicts merge
recursively, lists and scalars replace wholesale (reference
``config/pipeline/config_io.py:59`` base-chain merge).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple


def deep_merge(base: Optional[Dict[str, Any]], over: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Return ``base`` updated by ``over`` (``over`` wins). Non-mutating."""
    if base is None:
        return copy.deepcopy(over) if over else {}
    if over is None:
        return copy.deepcopy(base)
    out = copy.deepcopy(base)
    for key, value in over.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def collect_paths(node: Any, prefix: str = "") -> Set[str]:
    """All dotted leaf paths present in a nested dict (for explicit-path
    precedence tracking, reference ``stage_resolver.py:20-46``)."""
    paths: Set[str] = set()
    if isinstance(node, dict):
        for key, value in node.items():
            sub = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(value, dict) and value:
                paths |= collect_paths(value, sub)
            else:
                paths.add(sub)
    return paths


def get_path(d: Dict[str, Any], path: str, default=None):
    node: Any = d
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def set_path(d: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split(".")
    node = d
    for part in parts[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            node[part] = nxt
        node = nxt
    node[parts[-1]] = value


def parse_cli_value(text: str) -> Any:
    """Parse a ``key=value`` CLI override value using YAML scalar rules."""
    import yaml

    try:
        return yaml.safe_load(text)
    except Exception:
        return text


def apply_overrides(d: Dict[str, Any], overrides: Iterable[str]) -> List[Tuple[str, Any]]:
    """Apply dotted-path ``key=value`` overrides in place; returns parsed pairs
    (reference ``config_io.py:351`` CLI merge)."""
    applied = []
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override '{item}' must look like key=value")
        key, _, raw = item.partition("=")
        value = parse_cli_value(raw)
        set_path(d, key.strip(), value)
        applied.append((key.strip(), value))
    return applied
