"""Windowed reads of a volume by global (z, y, x) slices, the port of
``LazyVolumeAccessor`` (``pytorch_connectomics_tpu/inference/lazy.py:78-229``):
HDF5, zarr, ``.npy`` (memory-mapped), ``random://`` and ``synthetic://``
sources and tile grids (a tile-spec JSON, or a directory of numeric section
directories of ``<row>_<col>.png`` tiles; :mod:`..data.tiles`), with a
virtual axis transpose, a virtual pad, read-time scaling (``scale`` <= 1 a
axis: a native crop resampled linearly to the logical extent) and the
intensity normalisation applied to each read window on its own.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..data.io import (
    _h5_dataset_key,
    _h5py,
    _is_zarr,
    open_zarr,
    parse_random_url,
    probe_volume,
    random_volume,
    read_volume,
    split_internal_path,
    synthetic_task_volume,
)
from ..data.preprocess import normalize_volume


def is_tile_source(path: str) -> bool:
    """A tile-spec JSON or a directory that is not a zarr or n5 store."""
    p = Path(path)
    if "://" in path or ".zarr" in path or ".n5" in path:
        return False
    return p.suffix.lower() == ".json" or p.is_dir()


def _open_tile_source(path: str):
    """A tile-spec JSON, or a directory of numeric section directories
    whose first section's ``<row>_<col>.png`` tiles give the grid and the
    tile size, as a :class:`..data.tiles.TileVolume`."""
    from ..data.tiles import TileVolume

    p = Path(path)
    if p.suffix.lower() == ".json":
        return TileVolume(p)
    sections = sorted((d for d in p.iterdir() if d.is_dir() and d.name.isdigit()), key=lambda d: int(d.name))
    if not sections:
        raise ValueError(f"tile source {path}: no numeric section directories")
    first = sorted(sections[0].glob("*_*.png"))
    if not first:
        raise ValueError(f"tile source {path}: no '<row>_<col>.png' tiles")
    rows, cols = set(), set()
    for f in first:
        r, _, c = f.stem.partition("_")
        if r.isdigit() and c.isdigit():
            rows.add(int(r))
            cols.add(int(c))
    from PIL import Image

    with Image.open(first[0]) as im:
        th, tw = im.height, im.width
    grid = (max(rows) - min(rows) + 1, max(cols) - min(cols) + 1)
    spec = {
        "tile_size": [th, tw],
        "grid": list(grid),
        "sections": [[str(Path(s.name) / f"{r + min(rows)}_{c + min(cols)}.png") for r in range(grid[0])
                      for c in range(grid[1])] for s in sections],
    }
    return TileVolume(spec, root=p)


def _resize_linear(vol: np.ndarray, target: Tuple[int, ...]) -> np.ndarray:
    """Separable linear resample of a 3-D array to the ``target`` shape."""
    for axis, t in enumerate(target):
        n = vol.shape[axis]
        if n == t:
            continue
        idx = np.linspace(0, n - 1, t) if t > 1 else np.array([(n - 1) / 2.0])
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, n - 1)
        wshape = [1] * vol.ndim
        wshape[axis] = t
        w = (idx - lo).astype(np.float32).reshape(wshape)
        vol = np.take(vol, lo, axis=axis) * (1 - w) + np.take(vol, hi, axis=axis) * w
    return vol


class LazyVolumeAccessor:
    """Read windows of a volume in its padded, transposed and scaled frame;
    each read comes back normalised to float32 on its own statistics.
    ``device`` is where a ``synthetic://`` volume is generated."""

    def __init__(
        self,
        path: str,
        internal_path: Optional[str] = None,
        transpose: Optional[Sequence[int]] = None,
        pad: Optional[Sequence[int]] = None,
        normalize: str = "smart",
        pad_mode: str = "reflect",
        scale: Optional[Sequence[float]] = None,
        device=None,
    ):
        self.path = str(path)
        self.internal_path = internal_path
        self.transpose = tuple(transpose) if transpose else None
        self.pad = tuple(pad) if pad else (0, 0, 0)
        self.normalize = normalize
        self.pad_mode = pad_mode
        self.scale = tuple(float(s) for s in scale) if scale else None
        self.device = device
        if self.scale and any(s <= 0 or s > 1 for s in self.scale):
            raise ValueError(f"read scale must be in (0, 1], got {self.scale}")
        self._handle = None
        if is_tile_source(self.path):
            self._handle = _open_tile_source(self.path)
            base_shape, self.dtype = self._handle.shape, self._handle.dtype
        else:
            base_shape, self.dtype = probe_volume(self.path, internal_path)
        if self.transpose:
            base_shape = tuple(base_shape[a] for a in self.transpose)
        self.native_shape = base_shape
        if self.scale:
            base_shape = tuple(max(1, int(round(n * s))) for n, s in zip(base_shape, self.scale))
        self.base_shape = base_shape
        self.shape = tuple(s + 2 * p for s, p in zip(base_shape, self.pad))

    def open(self) -> None:
        """Open the source (a generated one is made now, on this thread);
        the first read opens it otherwise."""
        if self._handle is not None:
            return
        if is_tile_source(self.path):
            self._handle = _open_tile_source(self.path)
            return
        if self.path.startswith("random://"):
            self._handle = random_volume(*parse_random_url(self.path))
            return
        if self.path.startswith("synthetic://"):
            self._handle = synthetic_task_volume(self.path, self.device)
            return
        fpath, inner = split_internal_path(self.path)
        internal = self.internal_path or inner
        if fpath.endswith((".h5", ".hdf5")):
            f = _h5py().File(fpath, "r")
            self._handle = f[_h5_dataset_key(f, internal)]
        elif _is_zarr(fpath):
            self._handle = open_zarr(fpath, internal)
        elif fpath.endswith(".npy"):
            self._handle = np.load(fpath, mmap_mode="r")
        else:
            self._handle = read_volume(self.path, internal)

    def _storage_read(self, slices) -> np.ndarray:
        self.open()
        return np.asarray(self._handle[slices])

    def _native_read(self, sl) -> np.ndarray:
        """Read slices given in the transposed frame from storage."""
        if not self.transpose:
            return self._storage_read(tuple(sl))
        inv = np.argsort(self.transpose)
        return np.transpose(self._storage_read(tuple(sl[inv[d]] for d in range(3))), self.transpose)

    def read(self, slices: Sequence[slice]) -> np.ndarray:
        """A window in the padded frame, normalised float32."""
        base_sl, pads = [], []
        for sl, p, n in zip(tuple(slices), self.pad, self.base_shape):
            lo = (sl.start or 0) - p
            hi = (sl.stop if sl.stop is not None else (n + 2 * p)) - p
            base_sl.append(slice(max(0, lo), min(n, hi)))
            pads.append((max(0, -lo), max(0, hi - n)))
        raw = self._read_scaled(base_sl) if self.scale else self._native_read(base_sl)
        if any(p != (0, 0) for p in pads):
            raw = np.pad(raw, pads, mode={"reflect": "reflect", "replicate": "edge", "constant": "constant"}[
                self.pad_mode])
        return normalize_volume(raw, self.normalize)

    def _read_scaled(self, base_sl) -> np.ndarray:
        """The native crop covering logical slices, resampled to their
        extent."""
        native_sl, targets = [], []
        for sl, s, n in zip(base_sl, self.scale, self.native_shape):
            lo = int(np.floor(sl.start / s))
            native_sl.append(slice(lo, min(n, max(lo + 1, int(np.ceil(sl.stop / s))))))
            targets.append(max(0, sl.stop - sl.start))
        return _resize_linear(self._native_read(native_sl).astype(np.float32), tuple(targets))

    def read_all(self) -> np.ndarray:
        return self.read(tuple(slice(0, s) for s in self.shape))

    def close(self):
        h = self._handle
        if h is not None and hasattr(h, "file"):
            h.file.close()
        self._handle = None
