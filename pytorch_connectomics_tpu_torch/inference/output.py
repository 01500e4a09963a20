"""Prediction output transform and provenance-stamped saving (the port of
``apply_prediction_transform``/``save_prediction`` in
``pytorch_connectomics_tpu/inference/output.py``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..config.schema import InferenceOutputConfig
from ..data.io import save_volume


def apply_prediction_transform(pred: np.ndarray, out_cfg: InferenceOutputConfig) -> np.ndarray:
    """Intensity scale + dtype cast (e.g. scale 255 -> uint8)."""
    out = pred
    if out_cfg.scale:
        out = out * float(out_cfg.scale)
    if out_cfg.dtype:
        dt = np.dtype(out_cfg.dtype)
        if np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            out = np.clip(np.rint(out), info.min, info.max)
        out = out.astype(dt)
    return out


def save_prediction(
    path: str | Path,
    pred: np.ndarray,
    config_hash: str = "",
    checkpoint: str = "",
    head: str = "",
    extra_attrs: Optional[Dict[str, Any]] = None,
) -> Path:
    """Write a prediction with provenance attrs; predictions of untrained
    weights carry the ``random-init`` checkpoint sentinel. An ``.h5`` path is
    written as HDF5 where h5py is installed; without h5py the prediction goes
    to the same name with ``.npy`` and its attrs to ``.json`` beside it.
    Returns the path written."""
    attrs = {
        "config_hash": config_hash,
        "checkpoint": str(checkpoint) or "random-init",
        "head": head,
        "framework": "pytorch_connectomics_tpu_torch",
    }
    attrs.update(extra_attrs or {})
    path = stored_prediction_path(path)
    if path.suffix == ".npy":
        path.parent.mkdir(parents=True, exist_ok=True)
        path.with_suffix(".json").write_text(json.dumps(attrs, indent=2))
    save_volume(str(path), pred, attrs=attrs)
    return path


def stored_prediction_path(path: str | Path) -> Path:
    """Where :func:`save_prediction` writes ``path``: an ``.h5`` name
    becomes ``.npy`` where h5py is not installed."""
    path = Path(path)
    if path.suffix.lower() in (".h5", ".hdf5") and not h5py_available():
        return path.with_suffix(".npy")
    return path


def h5py_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True
