"""Volume I/O for the port: ``.npy`` always, HDF5 (``.h5``/``.hdf5``, with
an optional ``file.h5:dataset`` suffix) when ``h5py`` is importable, and
generated ``synthetic://`` volumes.

Counterpart of ``read_volume``/``save_volume`` in
``pytorch_connectomics_tpu/data/io.py`` for the formats the ported slices
read and write.
"""

from __future__ import annotations

import re
import threading
import zlib
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


_SYNTH_TASKS = ("em", "em2", "instance", "blobs")
_LABEL_TAGS = ("label", "_lb", "seg", "mask")


def parse_synthetic_url(path: str):
    """``synthetic://<task>/<name>?shape=Z,Y,X&seed=N&cells=K&elong=E`` ->
    (task, name, shape, seed, cells, elong). Without ``seed`` the seed is a
    hash of the task and the name with its role tags removed, so the image
    and label of one task share it."""
    body = path[len("synthetic://"):]
    shape, seed, cells, elong = (64, 128, 128), None, None, 1.0
    if "?" in body:
        body, qs = body.split("?", 1)
        m = re.search(r"shape=([\dx,]+)", qs)
        if m:
            shape = tuple(int(s) for s in re.split("[x,]", m.group(1)))
        m = re.search(r"seed=(\d+)", qs)
        if m:
            seed = int(m.group(1))
        m = re.search(r"cells=(\d+)", qs)
        if m:
            cells = int(m.group(1))
        m = re.search(r"elong=([\d.]+)", qs)
        if m:
            elong = float(m.group(1))
    task, _, name = body.partition("/")
    if task not in _SYNTH_TASKS:
        raise ValueError(f"unknown synthetic task '{task}' (one of {_SYNTH_TASKS})")
    if seed is None:
        base = (name or "x").lower()
        for tag in ("image", "label", "mask", "seg", "_im", "_lb"):
            base = base.replace(tag, "")
        seed = zlib.crc32((task + base).encode()) % (2**31)
    return task, name, tuple(shape), seed, cells, elong


# generated (image, label) pairs by (task, shape, seed): the image and label
# URLs of one task come from one generation
_SYNTH_CACHE: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}
_SYNTH_LOCK = threading.Lock()


def synthetic_task_volume(path: str, device=None) -> np.ndarray:
    """One role (image uint8 or label uint32) of a ``synthetic://`` task,
    generated on ``device`` (default the CPU) by :mod:`.synthetic`."""
    from .synthetic import synthetic_em_task

    task, name, shape, seed, _, _ = parse_synthetic_url(path)
    if task not in ("em", "em2"):
        raise NotImplementedError(f"synthetic task '{task}' is not ported yet (em and em2 only)")
    key = (task, shape, seed)
    with _SYNTH_LOCK:
        if key not in _SYNTH_CACHE:
            if len(_SYNTH_CACHE) >= 8:
                _SYNTH_CACHE.pop(next(iter(_SYNTH_CACHE)))
            _SYNTH_CACHE[key] = synthetic_em_task(task, shape, seed, device)
        img, lbl = _SYNTH_CACHE[key]
    return lbl if any(t in name.lower() for t in _LABEL_TAGS) else img


def read_volume(
    path: str, internal_path: Optional[str] = None, roi: Optional[Sequence[slice]] = None, device=None
) -> np.ndarray:
    """Read a full volume (or an ``roi`` slab). ``device`` is where a
    ``synthetic://`` volume is generated (default the CPU)."""
    if str(path).startswith("synthetic://"):
        vol = synthetic_task_volume(str(path), device)
        return vol[tuple(roi)] if roi else vol
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
