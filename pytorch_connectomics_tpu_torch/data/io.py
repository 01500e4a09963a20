"""Volume I/O for the port: ``.npy`` always, HDF5 (``.h5``/``.hdf5``, with
an optional ``file.h5:dataset`` suffix) when ``h5py`` is importable.

Counterpart of ``read_volume``/``save_volume`` in
``pytorch_connectomics_tpu/data/io.py`` for the formats the inference slice
reads and writes.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

_DEFAULT_H5_KEYS = ("main", "data", "image", "label", "raw", "volume", "seg")


def split_internal_path(path: str) -> Tuple[str, Optional[str]]:
    """``file.h5:dataset`` -> (file, dataset)."""
    m = re.match(r"^(.*\.(?:h5|hdf5))[:](.+)$", path)
    if m:
        return m.group(1), m.group(2)
    return path, None


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("reading or writing HDF5 volumes needs h5py") from e
    return h5py


def _h5_dataset_key(f, internal: Optional[str]) -> str:
    if internal:
        return internal
    keys = list(f.keys())
    for k in _DEFAULT_H5_KEYS:
        if k in f:
            return k
    if len(keys) == 1:
        return keys[0]
    raise KeyError(f"ambiguous HDF5 datasets {keys}; use 'file.h5:key'")


def read_volume(
    path: str, internal_path: Optional[str] = None, roi: Optional[Sequence[slice]] = None
) -> np.ndarray:
    """Read a full volume (or an ``roi`` slab)."""
    fpath, inner = split_internal_path(str(path))
    suffix = Path(fpath).suffix.lower()
    if suffix in (".h5", ".hdf5"):
        with _h5py().File(fpath, "r") as f:
            ds = f[_h5_dataset_key(f, internal_path or inner)]
            return ds[tuple(roi)] if roi else ds[:]
    if suffix == ".npy":
        vol = np.load(fpath)
        return vol[tuple(roi)] if roi else vol
    raise ValueError(f"unsupported volume format: {path} (the port reads .npy and .h5)")


def save_volume(
    path: str,
    volume: np.ndarray,
    internal_path: Optional[str] = None,
    compression: str = "gzip",
    attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a volume; HDF5 datasets carry ``attrs``."""
    fpath, inner = split_internal_path(str(path))
    suffix = Path(fpath).suffix.lower()
    Path(fpath).parent.mkdir(parents=True, exist_ok=True)
    if suffix in (".h5", ".hdf5"):
        with _h5py().File(fpath, "w") as f:
            kw: Dict[str, Any] = {}
            if compression and volume.nbytes > 1 << 20:
                kw["compression"] = compression
            ds = f.create_dataset(internal_path or inner or "main", data=volume, **kw)
            for k, v in (attrs or {}).items():
                ds.attrs[k] = v
        return
    if suffix == ".npy":
        np.save(fpath, volume)
        return
    raise ValueError(f"unsupported output format: {path} (the port writes .npy and .h5)")
