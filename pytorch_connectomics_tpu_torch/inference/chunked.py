"""Chunk-grid inference for volumes larger than memory, the port of
``pytorch_connectomics_tpu/inference/chunked.py:30-241``: a grid of chunks
over the volume (:mod:`..chunked.grid`), each read with its halo through a
:class:`.lazy.LazyVolumeAccessor`, predicted by the sliding-window
predictor, and its core written into one output; a resume manifest
(:mod:`..chunked.manifest`) lets a later run skip the chunks written.

Reads run on a reader thread and writes on a writer thread while the
calling thread predicts, so every CUDA call stays on the calling thread.
An error on any of the three ends the run with that error; the bounded
queues between them never hold a thread once the run stops.

The output is HDF5 where h5py is installed, else an ``.npy`` memory map at
the name :func:`.output.stored_prediction_path` gives, its attributes in
the JSON file beside it; ``*.zarr`` and the neuroglancer ``precomputed``
output mode (a layer at ``output_path``, written chunk-aligned, no
attributes) need tensorstore. Until the last chunk is written the
attributes carry the checkpoint ``__incomplete__``.
:func:`stitch_shard_outputs` merges the files of independent chunk-grid
shards into one.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..chunked.grid import ChunkRef, build_chunk_grid, resolve_halo
from ..chunked.manifest import ResumeManifest
from ..config.schema import ChunkedConfig
from ..data.io import _h5py, create_zarr, open_zarr
from .lazy import LazyVolumeAccessor
from .output import stored_prediction_path
from .tta import TTAPredictor

logger = logging.getLogger(__name__)

INCOMPLETE = "__incomplete__"
FRAMEWORK = "pytorch_connectomics_tpu_torch"
_END = object()


def select_chunks_for_shard(chunks: List[ChunkRef], shard_id: Optional[int],
                            num_shards: Optional[int]) -> List[ChunkRef]:
    """The chunks of one independent shard, ``chunks[shard_id::num_shards]``."""
    if shard_id is None or not num_shards:
        return chunks
    return chunks[shard_id::num_shards]


def _final_attrs(signature: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    attrs = {k: v for k, v in (signature or {}).items()
             if isinstance(v, (str, int, float, bool, np.integer, np.floating))}
    attrs["checkpoint"] = str((signature or {}).get("checkpoint") or "random-init")
    attrs["framework"] = FRAMEWORK
    return attrs


class _NpyOutput:
    """A (C, Z, Y, X) ``.npy`` memory map with its attributes' JSON; an
    existing file of the right shape is reopened when resuming."""

    def __init__(self, path: Path, shape, dtype, reopen: bool):
        self.path, self.attrs_path = path, path.with_suffix(".json")
        mm = None
        if reopen and path.exists():
            mm = np.load(path, mmap_mode="r+")
            if mm.shape != tuple(shape) or mm.dtype != np.dtype(dtype):
                mm = None
        self.reopened = mm is not None
        self.array = mm if mm is not None else np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                                                          shape=tuple(shape))

    def stamp(self, attrs: Dict[str, Any]) -> None:
        self.attrs_path.write_text(json.dumps(attrs, indent=2, default=str))

    def __setitem__(self, sl, value) -> None:
        self.array[sl] = value

    def close(self) -> None:
        self.array.flush()
        del self.array


class _H5Output:
    def __init__(self, path: Path, shape, dtype, reopen: bool, internal_path: str, chunk_cfg: ChunkedConfig):
        self.file = _h5py().File(path, "a" if (reopen and path.exists()) else "w")
        self.reopened = internal_path in self.file and self.file[internal_path].shape == tuple(shape)
        if self.reopened:
            self.ds = self.file[internal_path]
        else:
            if internal_path in self.file:
                del self.file[internal_path]
            spatial = shape[1:]
            h5_chunks = chunk_cfg.h5_chunks or [1] + [min(128, s) for s in spatial]
            self.ds = self.file.create_dataset(
                internal_path, shape=tuple(shape), dtype=dtype,
                chunks=(1, *[min(int(c), s) for c, s in zip(h5_chunks[1:], spatial)]),
                compression="gzip" if chunk_cfg.output_mode == "stitch_h5" else None,
            )

    def stamp(self, attrs: Dict[str, Any]) -> None:
        for k in list(self.ds.attrs):
            del self.ds.attrs[k]
        for k, v in attrs.items():
            self.ds.attrs[k] = v
        self.file.flush()

    def __setitem__(self, sl, value) -> None:
        self.ds[sl] = value

    def close(self) -> None:
        self.file.close()


class _ZarrOutput:
    def __init__(self, path: Path, shape, dtype, reopen: bool, chunk):
        self.reopened = reopen and path.exists()
        if self.reopened:
            self.array = open_zarr(str(path))
        else:
            self.array = create_zarr(str(path), shape, dtype, chunks=[shape[0]] + [min(c, s) for c, s in
                                                                                  zip(chunk, shape[1:])])

    def stamp(self, attrs: Dict[str, Any]) -> None:
        pass

    def __setitem__(self, sl, value) -> None:
        self.array[sl] = value

    def close(self) -> None:
        pass


class _PrecomputedOutput:
    """A neuroglancer precomputed layer of ``shape[0]`` channels, its
    storage chunks the grid's chunks; an existing layer is reopened when
    resuming."""

    def __init__(self, path: Path, shape, dtype, reopen: bool, chunk):
        from ..data.precomputed import create_precomputed, open_precomputed

        self.reopened = reopen and (path / "info").exists()
        if self.reopened:
            self.volume = open_precomputed(path)
        else:
            self.volume = create_precomputed(path, shape[1:], dtype, chunk_size=[min(c, s) for c, s in
                                                                                 zip(chunk, shape[1:])],
                                             num_channels=shape[0])

    def stamp(self, attrs: Dict[str, Any]) -> None:
        pass

    def __setitem__(self, sl, value) -> None:
        self.volume[sl] = value

    def close(self) -> None:
        pass


def run_chunked_inference(
    predictor: TTAPredictor,
    accessor: LazyVolumeAccessor,
    output_path: str | Path,
    chunk_cfg: ChunkedConfig,
    out_channels: Optional[int] = None,
    shard_id: Optional[int] = None,
    num_shards: Optional[int] = None,
    signature: Optional[Dict[str, Any]] = None,
    output_dtype=np.float32,
    internal_path: str = "main",
) -> Path:
    """Predict ``accessor``'s volume chunk by chunk into one (C, Z, Y, X)
    output; returns the path written. With ``shard_id``/``num_shards`` only
    that shard's chunks are computed."""
    output_path = Path(output_path)
    vol_shape = accessor.shape
    window = predictor.engine.window
    chunk_size = tuple(chunk_cfg.chunk_size or [max(w * 2, 64) for w in window])
    chunks = build_chunk_grid(vol_shape, chunk_size, resolve_halo(chunk_cfg.halo, window, predictor.engine.overlap))
    if chunk_cfg.roi_filter and any(accessor.pad):
        # chunks whose core lies wholly in the virtual pad hold no data
        lo, hi = accessor.pad, [p + b for p, b in zip(accessor.pad, accessor.base_shape)]
        kept = [c for c in chunks if all(c.start[i] < hi[i] and c.stop[i] > lo[i] for i in range(3))]
        if len(kept) != len(chunks):
            logger.info("roi_filter: %d/%d chunks are pure padding, skipped", len(chunks) - len(kept), len(chunks))
        chunks = kept
    chunks = select_chunks_for_shard(chunks, shard_id, num_shards)
    if chunk_cfg.num_chunks_per_rank:
        chunks = chunks[: int(chunk_cfg.num_chunks_per_rank)]
    if out_channels is None:
        out_channels = predictor.engine.probe_out_channels(1)
    n_out = len(predictor.select_channel) if predictor.select_channel else out_channels

    manifest = None
    if chunk_cfg.resume:
        manifest = ResumeManifest(output_path.with_suffix(output_path.suffix + ".manifest.json"), signature or {})
    reopen = bool(manifest and manifest.completed)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    shape = (n_out,) + tuple(vol_shape)
    if chunk_cfg.output_mode == "precomputed":
        out = _PrecomputedOutput(output_path, shape, output_dtype, reopen, chunk_size)
    elif output_path.suffix == ".zarr":
        out = _ZarrOutput(output_path, shape, output_dtype, reopen, chunk_size)
    else:
        output_path = stored_prediction_path(output_path)
        if output_path.suffix == ".npy":
            out = _NpyOutput(output_path, shape, output_dtype, reopen)
        else:
            out = _H5Output(output_path, shape, output_dtype, reopen, internal_path, chunk_cfg)
    if manifest and reopen and not out.reopened:
        # the chunks the manifest lists are not in a file of this shape
        manifest.path.unlink()
        manifest = ResumeManifest(manifest.path, signature or {})
    try:
        # a crashed run's file never carries a real checkpoint: the sentinel
        # is written now and replaced once the last chunk is in
        out.stamp({"checkpoint": INCOMPLETE, "framework": FRAMEWORK})
        accessor.open()  # a synthetic:// source is made here, on this thread
        _run_chunks(predictor, accessor, out, chunks, manifest, n_out, out_channels)
        out.stamp(_final_attrs(signature))
    finally:
        out.close()
    return output_path


def _run_chunks(predictor, accessor, out, chunks, manifest, n_out, out_channels) -> int:
    """Reader thread -> predict here -> writer thread, through queues of
    two; returns the chunks computed."""
    todo = [c for c in chunks if not (manifest and manifest.is_done(c.key))]
    stop = threading.Event()
    errors: List[BaseException] = []
    read_q: "queue.Queue" = queue.Queue(maxsize=2)
    write_q: "queue.Queue" = queue.Queue(maxsize=2)
    busy = {"read": [], "predict": [], "write": 0.0}  # read/predict (start, end) intervals, write seconds

    def put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def take(q):
        while True:
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                if stop.is_set():
                    return _END

    def fail(e: BaseException) -> None:
        errors.append(e)
        stop.set()

    def reader():
        try:
            for chunk in todo:
                t0 = time.perf_counter()
                data = accessor.read(chunk.read_slices)
                busy["read"].append((t0, time.perf_counter()))
                if not put(read_q, (chunk, data)):
                    return
            put(read_q, _END)
        except BaseException as e:
            fail(e)

    def writer():
        try:
            while True:
                item = take(write_q)
                if item is _END:
                    return
                chunk, core, read_s, predict_s = item
                t0 = time.perf_counter()
                out[(slice(0, n_out),) + chunk.core_slices] = np.moveaxis(core, -1, 0)
                if manifest:
                    manifest.mark_done(chunk.key)
                write_s = time.perf_counter() - t0
                busy["write"] += write_s
                logger.info("chunk %s: read %.3fs, predict %.3fs, write %.3fs", chunk.key, read_s, predict_s,
                            write_s)
        except BaseException as e:
            fail(e)

    threads = [threading.Thread(target=reader, daemon=True), threading.Thread(target=writer, daemon=True)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    done = 0
    try:
        while not errors:
            item = take(read_q)
            if item is _END:
                break
            chunk, data = item
            t0 = time.perf_counter()
            pred = predictor.predict(data, out_channels=out_channels)  # (z, y, x, C) on the host
            t1 = time.perf_counter()
            busy["predict"].append((t0, t1))
            r0, r1 = busy["read"][done]
            if not put(write_q, (chunk, pred[chunk.local_core_slices], r1 - r0, t1 - t0)):
                break
            done += 1
        put(write_q, _END)
    except BaseException as e:
        fail(e)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    read_s = sum(b - a for a, b in busy["read"])
    overlap = sum(max(0.0, min(b, d) - max(a, c)) for a, b in busy["read"] for c, d in busy["predict"])
    logger.info("chunked: %d of %d chunks computed in %.3fs; read %.3fs (%.3fs of it under predicts), predict "
                "%.3fs, write %.3fs", done, len(chunks), time.perf_counter() - t_start, read_s, overlap,
                sum(b - a for a, b in busy["predict"]), busy["write"])
    return done


def _read_channel(path: Path, internal_path: str, c: int) -> np.ndarray:
    if path.suffix == ".npy":
        return np.asarray(np.load(path, mmap_mode="r")[c])
    with _h5py().File(path, "r") as f:
        return f[internal_path][c]


def stitch_shard_outputs(shard_paths: Sequence[str | Path], output_path: str | Path,
                         internal_path: str = "main") -> Path:
    """Merge the (C, Z, Y, X) outputs of independent chunk-grid shards
    (each holds its own chunks, zeros elsewhere) into one file: each
    shard's nonzero voxels in turn, a channel at a time. The shards are
    HDF5 or ``.npy`` as the chunked writer left them (a name is read as
    :func:`.output.stored_prediction_path` gives it); the output is written
    the same way, without attributes. Returns the path written."""
    sources = [stored_prediction_path(p) for p in shard_paths]
    output_path = stored_prediction_path(output_path)
    if sources[0].suffix == ".npy":
        first = np.load(sources[0], mmap_mode="r")
        shape, dtype = first.shape, first.dtype
        del first
    else:
        with _h5py().File(sources[0], "r") as f:
            shape, dtype = f[internal_path].shape, f[internal_path].dtype
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_path.suffix == ".npy":
        out = np.lib.format.open_memmap(output_path, mode="w+", dtype=dtype, shape=tuple(shape))
        f_out = None
    else:
        f_out = _h5py().File(output_path, "w")
        out = f_out.create_dataset(internal_path, shape=shape, dtype=dtype)
    try:
        for c in range(shape[0]):
            dst = np.zeros(shape[1:], dtype)
            for p in sources:
                src = _read_channel(p, internal_path, c)
                nz = src != 0
                dst[nz] = src[nz]
            out[c] = dst
    finally:
        if f_out is not None:
            f_out.close()
        else:
            out.flush()
            del out
    return output_path
