"""Deterministic prediction artifact names (the port's copy of the
prediction-naming part of ``pytorch_connectomics_tpu/runtime/output_naming.py``):
the filename encodes the checkpoint stem, the TTA pass count and the
head/channel selection."""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional


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


def volume_name_from_path(path: str) -> str:
    stem = Path(str(path).split(":")[0]).stem
    for suffix in ("_im", "_image", "_img"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    return stem
