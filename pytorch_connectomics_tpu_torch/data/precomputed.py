"""Neuroglancer precomputed volumes through tensorstore's
``neuroglancer_precomputed`` driver, the port of
``pytorch_connectomics_tpu/data/precomputed.py``: the chunked inference's
``precomputed`` output and the ABISS bridge's affinity export. A layer is
stored x, y, z, channel; the functions here take and give (z, y, x) and
(c, z, y, x). Writes aligned to the storage chunks need no lock, so
shards may write disjoint chunks of one layer at once.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .io import _tensorstore as _io_tensorstore


def _tensorstore():
    return _io_tensorstore("neuroglancer precomputed volumes")


def kvstore_spec(path: str) -> dict:
    """A cloud path as a tensorstore kvstore spec: ``gs://`` (GCS),
    ``s3://``, ``http(s)://``, else a local directory."""
    p = str(path)
    if p.startswith("gs://"):
        bucket, _, inner = p[5:].partition("/")
        return {"driver": "gcs", "bucket": bucket, "path": inner}
    if p.startswith("s3://"):
        bucket, _, inner = p[5:].partition("/")
        return {"driver": "s3", "bucket": bucket, "path": inner}
    if p.startswith(("http://", "https://")):
        return {"driver": "http", "base_url": p}
    return {"driver": "file", "path": p}


def _scale_metadata(shape: Sequence[int], chunk_size: Sequence[int], resolution: Sequence[float]) -> dict:
    z, y, x = shape
    return {
        "size": [x, y, z],
        "resolution": [float(r) for r in reversed(list(resolution))],
        "chunk_size": list(reversed(list(chunk_size))),
        "encoding": "raw",
    }


def create_precomputed(
    path: str | Path,
    shape: Sequence[int],
    dtype,
    chunk_size: Sequence[int] = (64, 64, 64),
    resolution: Sequence[float] = (1.0, 1.0, 1.0),
    num_channels: int = 1,
    layer_type: str = "image",
) -> "PrecomputedVolume":
    """A new layer (an existing one is replaced) of (z, y, x) ``shape``,
    chunks and resolution given z, y, x."""
    spec = {
        "driver": "neuroglancer_precomputed",
        "kvstore": kvstore_spec(str(path)),
        "multiscale_metadata": {"type": layer_type, "data_type": np.dtype(dtype).name, "num_channels": num_channels},
        "scale_metadata": _scale_metadata(shape, chunk_size, resolution),
        "create": True,
        "delete_existing": True,
    }
    return PrecomputedVolume(_tensorstore().open(spec).result())


def append_scale(
    path: str | Path,
    shape: Sequence[int],
    dtype,
    chunk_size: Sequence[int],
    resolution: Sequence[float],
    num_channels: int = 1,
) -> "PrecomputedVolume":
    """Add a scale (a mip) to an existing layer, keyed by its resolution."""
    spec = {
        "driver": "neuroglancer_precomputed",
        "kvstore": kvstore_spec(str(path)),
        "scale_metadata": _scale_metadata(shape, chunk_size, resolution),
        "open": True,
        "create": True,
    }
    return PrecomputedVolume(_tensorstore().open(spec).result())


def open_precomputed(path: str | Path, resolution: Optional[Sequence[float]] = None) -> "PrecomputedVolume":
    """Open a layer; ``resolution`` (z, y, x) selects a scale."""
    spec = {"driver": "neuroglancer_precomputed", "kvstore": kvstore_spec(str(path)), "open": True}
    if resolution is not None:
        spec["scale_metadata"] = {"resolution": [float(r) for r in reversed(list(resolution))]}
    return PrecomputedVolume(_tensorstore().open(spec, open=True).result())


class PrecomputedVolume:
    """A (z, y, x), or (c, z, y, x) with more than one channel, view of an
    x, y, z, c tensorstore layer."""

    def __init__(self, store):
        self._store = store

    @property
    def shape(self) -> Tuple[int, ...]:
        x, y, z, c = self._store.shape
        return (z, y, x) if c == 1 else (c, z, y, x)

    def write(self, zyx_slices: Sequence[slice], vol: np.ndarray) -> None:
        sz, sy, sx = zyx_slices
        vol = np.asarray(vol)
        if vol.ndim == 3:
            vol = vol[None]
        self._store[sx, sy, sz, :].write(np.ascontiguousarray(np.transpose(vol, (3, 2, 1, 0)))).result()

    def read(self, zyx_slices: Sequence[slice]) -> np.ndarray:
        sz, sy, sx = zyx_slices
        out = np.transpose(np.asarray(self._store[sx, sy, sz, :].read().result()), (3, 2, 1, 0))
        return out[0] if out.shape[0] == 1 else out

    def __setitem__(self, zyx_slices, vol) -> None:
        # the chunked writer's channel-first slices: the channel slice is dropped
        if len(zyx_slices) == 4:
            zyx_slices = zyx_slices[1:]
        self.write(zyx_slices, vol)

    def __getitem__(self, zyx_slices) -> np.ndarray:
        return self.read(zyx_slices)


def abiss_affinity_convention(aff: np.ndarray) -> np.ndarray:
    """deepem affinities (channels x, y, z offsets, each edge at its high
    end) in ABISS's convention: channels reversed to z, y, x and each edge
    moved to the low end of its axis, the last plane zero."""
    rev = np.asarray(aff)[::-1]
    out = np.zeros_like(rev)
    for c in range(3):  # rev[0] is the z offset's channel, rev[1] y's, rev[2] x's
        idx = [slice(None)] * 3
        idx[c] = slice(0, -1)
        src = [slice(None)] * 3
        src[c] = slice(1, None)
        out[c][tuple(idx)] = rev[c][tuple(src)]
    return out
