"""Volume I/O for the port: ``.npy`` always, HDF5 (``.h5``/``.hdf5``, with
an optional ``file.h5:dataset`` suffix) when ``h5py`` is importable, zarr
(``.zarr``/``.n5``, with an optional ``vol.zarr:array`` suffix) through
tensorstore when it is importable, and generated ``synthetic://`` volumes.
A format whose package is missing raises; nothing falls back.

Counterpart of ``read_volume``/``save_volume``/``probe_volume`` and the
tensorstore zarr readers and writers (``open_zarr``/``create_zarr``,
``data/io.py:283-370``) in ``pytorch_connectomics_tpu/data/io.py`` for the
formats the ported slices read and write, and of its ``random://`` volumes
(:func:`random_volume`).
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
    """``file.h5:dataset`` or ``vol.zarr:array`` -> (file, internal path)."""
    if "://" in path:
        return path, None
    m = re.match(r"^(.*\.(?:h5|hdf5|zarr|n5))[:](.+)$", path)
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


def _tensorstore(what: str = "zarr volumes"):
    try:
        import tensorstore
    except ImportError as e:
        raise RuntimeError(f"reading or writing {what} needs tensorstore") from e
    return tensorstore


class ZarrArray:
    """A window onto a tensorstore array: ``shape``, ``dtype``, reads by
    slicing, writes by slice assignment (each one waited for)."""

    def __init__(self, store):
        self._store = store

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._store.shape)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self._store.dtype.numpy_dtype)

    def __getitem__(self, item) -> np.ndarray:
        return np.asarray(self._store[item].read().result())

    def __setitem__(self, item, value) -> None:
        self._store[item].write(np.ascontiguousarray(value)).result()


def _zarr_kvstore(path: str, internal_path: Optional[str]) -> Dict[str, Any]:
    full = Path(path) / internal_path if internal_path else Path(path)
    return {"driver": "file", "path": str(full)}


def open_zarr(path: str, internal_path: Optional[str] = None) -> ZarrArray:
    """An existing zarr (v2, else v3) array."""
    ts = _tensorstore()
    spec = {"driver": "zarr", "kvstore": _zarr_kvstore(path, internal_path)}
    try:
        store = ts.open(spec, open=True).result()
    except Exception:
        spec["driver"] = "zarr3"
        store = ts.open(spec, open=True).result()
    return ZarrArray(store)


def create_zarr(
    path: str, shape: Sequence[int], dtype, chunks: Optional[Sequence[int]] = None,
    internal_path: Optional[str] = None,
) -> ZarrArray:
    """A new zarr v2 array (an existing one at ``path`` is replaced)."""
    ts = _tensorstore()
    spec = {
        "driver": "zarr",
        "kvstore": _zarr_kvstore(path, internal_path),
        "metadata": {"shape": list(shape), "chunks": list(chunks) if chunks else [min(64, s) for s in shape],
                     "dtype": np.dtype(dtype).str},
        "create": True,
        "delete_existing": True,
    }
    return ZarrArray(ts.open(spec).result())


def _is_zarr(fpath: str) -> bool:
    return Path(fpath).suffix.lower() in (".zarr", ".n5") or Path(fpath, ".zarray").exists()


_SYNTH_TASKS = ("em", "em2", "instance", "blobs")
_LABEL_TAGS = ("label", "_lb", "seg", "mask")


def random_volume(name: str, shape: Tuple[int, ...] = (64, 128, 128)) -> np.ndarray:
    """The ``random://<name>`` volume, the JAX package's ``synthetic_volume``
    (``data/io.py:59-100``) value for value: smooth noise from a numpy
    ``default_rng`` seeded by the crc32 of the name with its role tags
    removed (so an image and its label share one field), an 8^3 normal
    field resized by separable linear interpolation and scaled to [0, 1].
    Names with a label tag give the connected components (scipy's
    6-connected ``label``) of the field above 0.6 as uint32, others the
    field as uint8 (x 255)."""
    base = name.lower()
    for tag in ("image", "label", "mask", "seg", "_im", "_lb", "im", "lb"):
        base = base.replace(tag, "")
    rng = np.random.default_rng(zlib.crc32(base.encode()) % (2**31))
    vol = rng.normal(size=(8, 8, 8)).astype(np.float32)
    for axis, target in enumerate(shape):
        idx = np.linspace(0, vol.shape[axis] - 1, target)
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, vol.shape[axis] - 1)
        wshape = [1] * vol.ndim
        wshape[axis] = target
        w = (idx - lo).astype(np.float32).reshape(wshape)
        vol = np.take(vol, lo, axis=axis) * (1 - w) + np.take(vol, hi, axis=axis) * w
    vol = (vol - vol.min()) / max(1e-6, float(np.ptp(vol)))
    if any(tag in name.lower() for tag in _LABEL_TAGS):
        from scipy import ndimage

        return ndimage.label((vol > 0.6).astype(np.uint8))[0].astype(np.uint32)
    return (vol * 255).astype(np.uint8)


def parse_random_url(path: str) -> Tuple[str, Tuple[int, ...]]:
    """``random://<name>?shape=Z,Y,X`` -> (name, shape); default (64, 128, 128)."""
    body = path[len("random://"):]
    if "?" in body:
        body, qs = body.split("?", 1)
        m = re.search(r"shape=([\dx,]+)", qs)
        if m:
            return body, tuple(int(s) for s in re.split("[x,]", m.group(1)))
    return body, (64, 128, 128)




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


# generated (image, label) pairs by (task, shape, seed, cells, elongation): the image and label
# URLs of one task come from one generation
_SYNTH_CACHE: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}
_SYNTH_LOCK = threading.Lock()


def synthetic_task_volume(path: str, device=None) -> np.ndarray:
    """One role (image uint8 or label uint32) of a ``synthetic://`` task,
    generated on ``device`` (default the CPU) by :mod:`.synthetic`."""
    from .synthetic import synthetic_em_task

    task, name, shape, seed, cells, elong = parse_synthetic_url(path)
    key = (task, shape, seed, cells, elong)
    with _SYNTH_LOCK:
        if key not in _SYNTH_CACHE:
            if len(_SYNTH_CACHE) >= 8:
                _SYNTH_CACHE.pop(next(iter(_SYNTH_CACHE)))
            _SYNTH_CACHE[key] = synthetic_em_task(task, shape, seed, device, cells=cells, elongation=elong)
        img, lbl = _SYNTH_CACHE[key]
    return lbl if any(t in name.lower() for t in _LABEL_TAGS) else img


def read_volume(
    path: str, internal_path: Optional[str] = None, roi: Optional[Sequence[slice]] = None, device=None
) -> np.ndarray:
    """Read a full volume (or an ``roi`` slab). ``device`` is where a
    ``synthetic://`` volume is generated (default the CPU)."""
    if str(path).startswith("random://"):
        vol = random_volume(*parse_random_url(str(path)))
        return vol[tuple(roi)] if roi else vol
    if str(path).startswith("synthetic://"):
        vol = synthetic_task_volume(str(path), device)
        return vol[tuple(roi)] if roi else vol
    fpath, inner = split_internal_path(str(path))
    suffix = Path(fpath).suffix.lower()
    if suffix in (".h5", ".hdf5"):
        with _h5py().File(fpath, "r") as f:
            ds = f[_h5_dataset_key(f, internal_path or inner)]
            return ds[tuple(roi)] if roi else ds[:]
    if _is_zarr(fpath):
        arr = open_zarr(fpath, internal_path or inner)
        return arr[tuple(roi)] if roi else arr[...]
    if suffix == ".npy":
        vol = np.load(fpath, mmap_mode="r") if roi else np.load(fpath)
        return np.asarray(vol[tuple(roi)]) if roi else vol
    raise ValueError(f"unsupported volume format: {path} (the port reads .npy, .h5 and zarr)")


def probe_volume(path: str, internal_path: Optional[str] = None) -> Tuple[Tuple[int, ...], np.dtype]:
    """(shape, dtype) of a volume without reading it where the format
    allows (``random://``, ``synthetic://``, HDF5, zarr, ``.npy``)."""
    if path.startswith(("random://", "synthetic://")):
        name, shape = parse_random_url(path) if path.startswith("random://") else parse_synthetic_url(path)[1:3]
        label = any(t in name.lower() for t in _LABEL_TAGS)
        return tuple(shape), np.dtype(np.uint32 if label else np.uint8)
    fpath, inner = split_internal_path(path)
    suffix = Path(fpath).suffix.lower()
    if suffix in (".h5", ".hdf5"):
        with _h5py().File(fpath, "r") as f:
            ds = f[_h5_dataset_key(f, internal_path or inner)]
            return tuple(ds.shape), ds.dtype
    if _is_zarr(fpath):
        arr = open_zarr(fpath, internal_path or inner)
        return arr.shape, arr.dtype
    if suffix == ".npy":
        vol = np.load(fpath, mmap_mode="r")
        return tuple(vol.shape), vol.dtype
    vol = read_volume(path, internal_path)
    return vol.shape, vol.dtype


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
    if suffix in (".zarr", ".n5"):
        create_zarr(fpath, volume.shape, volume.dtype, internal_path=internal_path or inner)[...] = volume
        return
    if suffix == ".npy":
        np.save(fpath, volume)
        return
    raise ValueError(f"unsupported output format: {path} (the port writes .npy, .h5 and zarr)")
