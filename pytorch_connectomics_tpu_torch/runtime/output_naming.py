"""Deterministic artifact names (the port's copy of the prediction and
decoded naming of ``pytorch_connectomics_tpu/runtime/output_naming.py``):
a prediction's name encodes the checkpoint stem, the TTA pass count and the
head/channel selection; a decoded volume's name adds the decode recipe
(step names and kwargs) or the user's ``save_suffix``."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, Optional

# decode kwargs that never belong in a filename (paths, runtime context)
_IGNORED_DECODE_TAG_KEYS = {
    "candidate_output_path",
    "decision_output_path",
    "guide_affinity_path",
    "guide_prediction_path",
    "guide_seg_path",
    "primary_affinity_path",
    "receive_context",
    "report_dir",
    "tag",
}


def _sanitize(text: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._=]+", "-", text)
    return re.sub(r"-{2,}", "-", safe).strip("-")


def checkpoint_stem(checkpoint: Optional[str]) -> str:
    if not checkpoint:
        return "scratch"
    return _sanitize(Path(checkpoint).stem.replace("=", "-")) or "scratch"


def prediction_tag(
    checkpoint: Optional[str] = None,
    tta_passes: int = 1,
    head: Optional[str] = None,
    channels: Optional[List[int]] = None,
) -> str:
    parts = [checkpoint_stem(checkpoint)]
    if tta_passes > 1:
        parts.append(f"tta_x{tta_passes}")
    if head:
        parts.append(f"head_{head}")
    if channels:
        parts.append("ch" + "-".join(map(str, channels)))
    return "_".join(parts)


def prediction_filename(volume_name: str, tag: str) -> str:
    return f"{volume_name}_{tag}_prediction.h5"


def _decode_tokens(value: Any) -> List[str]:
    """Value tokens of a decode step's kwargs: dicts by sorted key (ignored
    keys dropped), lists in order, floats in ``%g``."""
    if hasattr(value, "items"):
        return [t for k, v in sorted(dict(value).items()) if k not in _IGNORED_DECODE_TAG_KEYS for t in _decode_tokens(v)]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _decode_tokens(v)]
    if isinstance(value, bool):
        return ["true" if value else "false"]
    if value is None:
        return ["none"]
    if isinstance(value, float):
        return [format(value, "g")]
    return [str(value)]


def _get(obj: Any, key: str) -> Any:
    return obj.get(key) if isinstance(obj, dict) else getattr(obj, key, None)


def format_decode_step_tag(step: Any) -> str:
    """``{name without 'decode_'}_{kwarg tokens}`` of one decode step; a
    ``tag`` kwarg replaces it."""
    name = _get(step, "name")
    if not name:
        return ""
    short = str(name).replace("decode_", "")
    kwargs = _get(step, "kwargs")
    if kwargs and hasattr(kwargs, "items") and dict(kwargs).get("tag"):
        return _sanitize(str(dict(kwargs)["tag"]))
    tokens = _decode_tokens(kwargs) if kwargs else []
    kw_tag = _sanitize("-".join(tokens)) if tokens else ""
    return f"{short}_{kw_tag}" if kw_tag else short


def format_decode_tag(decoding_cfg: Any) -> str:
    """The decode steps' tags joined by ``__``; '' without steps. (Graph
    decoding is not ported.)"""
    steps = _get(decoding_cfg, "steps") if decoding_cfg is not None else None
    return "__".join(t for t in (format_decode_step_tag(s) for s in steps or []) if t)


def decoded_filename(volume_name: str, tag: str, decode_tag: str = "decoded", decoding_cfg: Any = None) -> str:
    """Decoded-output name; with ``decoding_cfg`` it carries the user's
    ``save_suffix`` or else the decode recipe, so other decode parameters
    give another file."""
    if decoding_cfg is not None:
        suffix = _get(decoding_cfg, "save_suffix")
        suffix = (_sanitize(str(suffix).strip()) if suffix else "") or format_decode_tag(decoding_cfg)
        if suffix:
            decode_tag = f"decoded_{suffix}"
    return f"{volume_name}_{tag}_{decode_tag}.h5"


def volume_name_from_path(path: str) -> str:
    stem = Path(str(path).split(":")[0]).stem
    for suffix in ("_im", "_image", "_img"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    return stem
