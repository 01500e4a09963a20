"""Target generation: a label-transform config -> ``seg (C, Z, Y, X) ->
target (C', Z, Y, X)`` float32, the port of ``build_target_fn`` in
``pytorch_connectomics_tpu/data/targets/build.py:38-55,127`` with
``seg_to_binary`` of ``targets/misc.py:17``.

This slice ports the ``binary`` target only; any other target name, and the
label clean-ups (normalisation, connected-component relabelling, erosion),
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def seg_to_binary(seg: np.ndarray, dtype=np.float32) -> np.ndarray:
    return (np.asarray(seg) > 0).astype(dtype)


def _binary(seg: np.ndarray) -> np.ndarray:
    b = seg_to_binary(seg)
    return b[None] if b.ndim == 3 else b


_TARGETS = {"binary": _binary}


def build_target_fn(cfg) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """Compile a ``LabelTransformConfig``; None when no target is configured
    (the label is used as it is)."""
    if cfg is None or not cfg.targets:
        return None
    for flag, what in (
        (cfg.normalize_labels, "normalize_labels"),
        (cfg.relabel_cc, "relabel_cc"),
        (cfg.erosion, "erosion"),
        (getattr(cfg, "erosion_window", None) is not None, "erosion_window"),
    ):
        if flag:
            raise NotImplementedError(f"label transform '{what}' is not ported yet")
    steps = []
    for t in cfg.targets:
        if t.name not in _TARGETS:
            raise NotImplementedError(f"target '{t.name}' is not ported yet (binary only)")
        steps.append(_TARGETS[t.name])

    def fn(seg: np.ndarray) -> np.ndarray:
        s = np.asarray(seg)
        if s.ndim == 4:
            s = s[0]
        return np.concatenate([f(s) for f in steps], axis=0).astype(np.float32)

    return fn
