"""Unknown-key rejection for the free-form config blocks, the port of
``pytorch_connectomics_tpu/config/kwarg_validation.py``.

The augmentation transforms and the decoders take plain keyword arguments,
so their signatures are the schema: a config key that no implementation
accepts raises ``ConfigError`` when the config is validated, instead of
being dropped silently (a mistyped ``fragment_threshold`` would otherwise
decode at the default threshold).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Set

from .schema import ConfigError

# keys the builders read themselves, never passed to a transform
_BUILDER_KEYS = {"enabled"}


def _named_params(fn: Callable, skip_first: int, strict_var_kw: bool = False) -> Optional[Set[str]]:
    """The keyword-accepting parameters of ``fn`` past its first
    ``skip_first``; None where ``fn`` takes ``**kwargs`` (anything goes).
    With ``strict_var_kw`` a ``**kwargs`` is a sink that accepts nothing
    of its own: the decoders take one so that a step pipeline can hand
    every step one dict, not to accept any option."""
    names: Set[str] = set()
    for i, (name, p) in enumerate(inspect.signature(fn).parameters.items()):
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            if not strict_var_kw:
                return None
            continue
        if p.kind is inspect.Parameter.VAR_POSITIONAL or i < skip_first:
            continue
        names.add(name)
    return names


def augmentation_kwarg_schema() -> Dict[str, Optional[Set[str]]]:
    """transform name -> the config keys it accepts (None: free-form): the
    host transform's keywords (``data/augment/build.py::_ORDER``, whose
    transforms take ``(sample, rng, ...)``) joined with those of its device
    form's draw (``ops/augment.py``, ``<name>_draw(gen, n, shape, ...)``),
    since a block may drive either."""
    from ..data.augment.build import _ORDER
    from ..ops import augment as device

    schema: Dict[str, Optional[Set[str]]] = {}
    for key, fn, _ in _ORDER:
        names = _named_params(fn, skip_first=2)
        if names is not None:
            names.discard("other")
            names |= _BUILDER_KEYS
            draw = getattr(device, f"{key}_draw", None)
            dev = _named_params(draw, skip_first=3) if draw is not None else None
            if dev is not None:
                names |= dev
        schema[key] = names
    return schema


def validate_augmentation_config(aug_cfg: Any) -> List[str]:
    """Raise ``ConfigError`` on an unknown transform name or an unknown
    keyword inside a transform block; returns warnings."""
    if aug_cfg is None or not getattr(aug_cfg, "enabled", False):
        return []
    schema = augmentation_kwarg_schema()
    blocks: Dict[str, Any] = {name: getattr(aug_cfg, name) for name in schema if getattr(aug_cfg, name, None)}
    for name, block in (getattr(aug_cfg, "extra", None) or {}).items():
        if name in ("profile", "enabled", "on_device"):
            continue
        if name not in schema:
            raise ConfigError(f"augmentation: unknown transform '{name}' (known: {sorted(schema)})")
        if block:
            blocks[name] = block
    for name, block in blocks.items():
        allowed = schema[name]
        if allowed is None or not isinstance(block, dict):
            continue
        unknown = sorted(set(block) - allowed)
        if unknown:
            raise ConfigError(
                f"augmentation.{name}: unknown option(s) {unknown} (accepted: {sorted(allowed - _BUILDER_KEYS)})"
            )
    return []


def validate_decoding_config(dec_cfg: Any) -> List[str]:
    """Validate the decode steps' and graph nodes' names and keywords
    against the decoders' signatures (their first positionals are the
    inputs); returns warnings."""
    if dec_cfg is None or not getattr(dec_cfg, "enabled", False):
        return []
    from ..decoding import stage  # noqa: F401 - registers the decoders
    from ..decoding.registry import _DECODERS, _GRAPH_OPS

    def check(op_name: str, kwargs: Dict[str, Any], where: str, n_inputs: int = 1) -> None:
        fn = _DECODERS.get(op_name) or _GRAPH_OPS.get(op_name)
        if fn is None:
            raise ConfigError(f"{where}: unknown decoder/op '{op_name}' (known: {sorted(set(_DECODERS) | set(_GRAPH_OPS))})")
        # a decoder whose **kw is a real surface (abiss forwards any key
        # into the ABISS param file) opts out
        if getattr(fn, "__free_kwargs__", False):
            return
        allowed = _named_params(fn, skip_first=n_inputs, strict_var_kw=True)
        unknown = sorted(set(kwargs or {}) - allowed)
        if unknown:
            raise ConfigError(f"{where} ({op_name}): unknown option(s) {unknown} (accepted: {sorted(allowed)})")

    for i, step in enumerate(dec_cfg.steps or []):
        name = step.name if hasattr(step, "name") else step["name"]
        kwargs = dict(getattr(step, "kwargs", None) or {})
        extra = getattr(step, "extra", None) or {}
        kwargs.update({k: v for k, v in extra.items() if k not in ("name", "kwargs")})
        check(name, kwargs, f"decoding.steps[{i}]")
    for node, spec in ((dec_cfg.graph or {}).get("nodes") or {}).items():
        n_in = max(1, len(spec.get("inputs", []) or []))
        check(spec.get("op") or spec.get("name"), spec.get("kwargs", {}) or {}, f"decoding.graph.nodes[{node}]", n_in)
    return []
