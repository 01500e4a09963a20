"""Prediction output transform, provenance-stamped saving and the
prediction cache's check (the port of ``apply_prediction_transform``,
``save_prediction`` and ``validate_prediction_cache`` in
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


def read_prediction_attrs(path: str | Path) -> Dict[str, Any]:
    """The provenance attrs of a stored prediction: an HDF5 dataset's
    attrs, or the ``.json`` beside an ``.npy``; raises ``FileNotFoundError``
    where a prediction has none."""
    from ..data.io import split_internal_path

    fpath, inner = split_internal_path(str(path))
    fpath = Path(fpath)
    if fpath.suffix == ".npy":
        meta = fpath.with_suffix(".json")
        if not meta.exists():
            raise FileNotFoundError(f"{fpath} has no attrs file {meta.name}")
        return json.loads(meta.read_text())
    if fpath.suffix.lower() in (".h5", ".hdf5"):
        import h5py

        from ..data.io import _h5_dataset_key

        with h5py.File(fpath, "r") as f:
            return dict(f[_h5_dataset_key(f, inner)].attrs)
    raise FileNotFoundError(f"{fpath} is a format without attrs")


def stamp_prediction_checkpoint(path: str | Path, checkpoint: str) -> None:
    """Rewrites the checkpoint attr of a stored prediction (``path`` as
    :func:`stored_prediction_path` gives it), where
    :func:`read_prediction_attrs` reads it. ``__incomplete__`` is what a
    chunked run that stopped before its last chunk leaves."""
    from ..data.io import _h5_dataset_key, split_internal_path

    fpath, inner = split_internal_path(str(stored_prediction_path(path)))
    fpath = Path(fpath)
    if fpath.suffix == ".npy":
        meta = fpath.with_suffix(".json")
        meta.write_text(json.dumps({**json.loads(meta.read_text()), "checkpoint": checkpoint}, indent=2))
        return
    import h5py

    with h5py.File(fpath, "a") as f:
        f[_h5_dataset_key(f, inner)].attrs["checkpoint"] = checkpoint


def validate_prediction_cache(path: str | Path, config_hash: Optional[str] = None,
                              checkpoint: Optional[str] = None) -> bool:
    """Whether the stored prediction at ``path`` may stand in for a new one:
    it exists and its attrs match the run (``path`` as
    :func:`stored_prediction_path` gives it). A prediction without attrs
    (an older cache, or a format without them) is accepted; an HDF5 file
    whose attrs cannot be read (truncated by a killed run) is not. With
    attrs:

    - checkpoint ``__incomplete__`` (a chunked run that stopped
      mid-write) is never accepted;
    - a recorded config hash (not empty) must equal ``config_hash`` where
      one is given;
    - with ``checkpoint`` given, a recorded checkpoint must equal it, an
      empty one reading as ``random-init``, as does an empty ``checkpoint``
      (the run has no weights). ``checkpoint=None`` skips the check (a
      decode-only caller without weights)."""
    from ..data.io import split_internal_path

    fpath = Path(split_internal_path(str(path))[0])
    if not fpath.exists():
        return False
    try:
        attrs = read_prediction_attrs(path)
    except (OSError, KeyError):
        return fpath.suffix.lower() not in (".h5", ".hdf5")
    if str(attrs.get("checkpoint", "")) == "__incomplete__":
        return False
    if config_hash and attrs.get("config_hash") not in ("", None, config_hash):
        return False
    if checkpoint is not None and "checkpoint" in attrs:
        if (str(attrs["checkpoint"]) or "random-init") != (str(checkpoint) or "random-init"):
            return False
    return True
