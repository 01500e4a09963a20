"""Decoder registry, the linear steps pipeline and the graph evaluator (the
port of ``pytorch_connectomics_tpu/decoding/registry.py``).

Decoders take ``(prediction (C, Z, Y, X) float32, **kwargs)`` and return
labels ``(Z, Y, X)`` or an intermediate array for the next step; graph ops
combine the outputs of other nodes.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

_DECODERS: Dict[str, Callable] = {}
_GRAPH_OPS: Dict[str, Callable] = {}


def register_decoder(name: str):
    def deco(fn):
        _DECODERS[name] = fn
        return fn

    return deco


def register_graph_op(name: str):
    def deco(fn):
        _GRAPH_OPS[name] = fn
        return fn

    return deco


def get_decoder(name: str) -> Callable:
    if name not in _DECODERS:
        raise KeyError(f"unknown decoder '{name}'; available: {list_decoders()}")
    return _DECODERS[name]


def get_graph_op(op: str) -> Callable:
    """A graph node's op: a decoder or a graph op."""
    fn = _DECODERS.get(op) or _GRAPH_OPS.get(op)
    if fn is None:
        raise KeyError(f"unknown graph op '{op}'")
    return fn


def list_decoders() -> List[str]:
    return sorted(_DECODERS)


def run_steps(prediction: np.ndarray, steps: List[Any], timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Each step's output feeds the next. A step is a ``DecodingStepConfig``
    or a dict with ``name``, ``kwargs`` and extra keys, which join the
    kwargs. ``timings`` receives each step's seconds, keyed
    ``<index>.<name>``."""
    out = prediction
    for i, step in enumerate(steps):
        name = step.name if hasattr(step, "name") else step["name"]
        kwargs = dict(getattr(step, "kwargs", None) or (step.get("kwargs") if isinstance(step, dict) else None) or {})
        extra = getattr(step, "extra", None) or {}
        kwargs.update({k: v for k, v in extra.items() if k not in ("name", "kwargs")})
        t0 = time.perf_counter()
        out = get_decoder(name)(out, **kwargs)
        if timings is not None:
            timings[f"{i}.{name}"] = time.perf_counter() - t0
    return out


def run_graph(inputs: Dict[str, np.ndarray], graph: Dict[str, Any],
              timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Evaluates a graph ``{"nodes": {name: {op, inputs, kwargs}}, "output":
    name}`` (the last node when no output is named). A node's ``op`` is a
    decoder or a graph op, called with its inputs' values in order (a name
    of ``inputs`` or of another node) and its kwargs; each node runs once.
    ``timings`` receives each node's own seconds, keyed by node."""
    nodes = graph["nodes"]
    values: Dict[str, np.ndarray] = dict(inputs)

    def value(name: str) -> np.ndarray:
        if name not in values:
            spec = nodes[name]
            fn = get_graph_op(spec.get("op") or spec.get("name"))
            args = [value(i) for i in spec.get("inputs", [])]
            t0 = time.perf_counter()
            values[name] = fn(*args, **(spec.get("kwargs") or {}))
            if timings is not None:
                timings[name] = time.perf_counter() - t0
        return values[name]

    return value(graph.get("output") or list(nodes)[-1])


@register_graph_op("multiply")
def _op_multiply(a, b, **kw):
    return a * b


@register_graph_op("add")
def _op_add(a, b, **kw):
    return a + b


@register_graph_op("threshold")
def _op_threshold(a, threshold=0.5, **kw):
    return (a > threshold).astype(np.float32)


@register_graph_op("select_channels")
def _op_select_channels(a, channels="0:1", **kw):
    """The leading-axis slice ``channels`` (``"start:stop[:step]"`` or an index)."""
    from ..utils.slicing import parse_slice

    return a[parse_slice(str(channels))]


@register_graph_op("mask_apply")
def _op_mask_apply(a, mask, **kw):
    return a * (mask > 0)


@register_graph_op("decode_quantize")
def _op_decode_quantize(a, mode="max", levels=0, **kw):
    """Class scores of a quantized energy -> the continuous energy map."""
    from ..data.targets.misc import decode_quantize

    return decode_quantize(a, mode=mode, levels=levels)


@register_graph_op("combine_split")
def _op_combine_split(a, b, output_dtype="uint32", **kw):
    """The finest labelling both inputs agree on: nonzero only where both
    are, each distinct (a, b) pair one id, numbered 1.. in the order of the
    pair key a * (max b + 1) + b."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"combine_split shapes differ: {a.shape} vs {b.shape}")
    dtype = np.dtype(output_dtype)
    if not np.issubdtype(dtype, np.integer):
        raise TypeError(f"combine_split output_dtype must be integer, got {dtype}")
    out = np.zeros(a.shape, dtype)
    both = (a != 0) & (b != 0)
    if not both.any():
        return out
    ka, kb = a[both].astype(np.uint64), b[both].astype(np.uint64)
    base = int(kb.max()) + 1
    if int(ka.max()) * base + int(kb.max()) >= 2**64 - 1:
        raise OverflowError("combine_split pair key space exceeds uint64")
    _, ids = np.unique(ka * np.uint64(base) + kb, return_inverse=True)
    if int(ids.max()) + 1 > np.iinfo(dtype).max:
        raise OverflowError(f"combine_split produced {int(ids.max()) + 1} labels > {dtype} max")
    out[both] = ids.astype(dtype) + 1
    return out
