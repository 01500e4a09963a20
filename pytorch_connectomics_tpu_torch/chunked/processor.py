"""A chunked map over a volume with resume, the port of
``pytorch_connectomics_tpu/chunked/processor.py``: host-side precompute
(skeletons, distance targets) over volumes larger than memory. Chunks run
on a thread pool (the work is numpy, scipy or file reads, which release
the GIL); each result's core is written under a lock and marked done in
the manifest.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from .grid import ChunkRef, build_chunk_grid
from .manifest import ResumeManifest

logger = logging.getLogger(__name__)


class ChunkedProcessor:
    """Maps ``process_chunk`` (or ``process_fn(chunk_data, chunk) ->
    array``) over a chunk grid with crash-safe resume; each result's core
    goes to ``writer[core_slices]`` (anything that takes slice assignment:
    an h5py dataset, a memory map, a tensorstore view). With ``shard_id``
    and ``num_shards`` only ``chunks[shard_id::num_shards]`` run."""

    def __init__(
        self,
        vol_shape: Sequence[int],
        chunk_size: Sequence[int],
        halo: Sequence[int] = (0, 0, 0),
        manifest_path: Optional[str] = None,
        signature: Optional[Dict[str, Any]] = None,
        num_workers: int = 4,
        shard_id: Optional[int] = None,
        num_shards: Optional[int] = None,
    ):
        self.chunks = build_chunk_grid(vol_shape, chunk_size, halo)
        if shard_id is not None and num_shards and num_shards > 1:
            if not 0 <= shard_id < num_shards:
                raise ValueError(f"shard_id={shard_id} out of range for {num_shards}")
            self.chunks = self.chunks[shard_id::num_shards]
        self.manifest = ResumeManifest(manifest_path, signature) if manifest_path else None
        self.num_workers = max(1, num_workers)
        self._lock = threading.Lock()

    def process_chunk(self, data: np.ndarray, chunk: ChunkRef) -> np.ndarray:
        raise NotImplementedError("subclass ChunkedProcessor or pass process_fn")

    def run(self, reader: Callable[[tuple], np.ndarray], writer, process_fn: Optional[Callable] = None) -> int:
        """``reader(read_slices) -> array``; ``writer[core_slices] =
        result core``. Returns the chunks processed (those the manifest
        lists as done are skipped)."""
        fn = process_fn or self.process_chunk
        todo = [c for c in self.chunks if not (self.manifest and self.manifest.is_done(c.key))]
        logger.info("chunked run: %d/%d chunks to do", len(todo), len(self.chunks))

        def work(chunk: ChunkRef) -> None:
            core = fn(reader(chunk.read_slices), chunk)[tuple(chunk.local_core_slices)]
            with self._lock:
                writer[chunk.core_slices] = core
                if self.manifest:
                    self.manifest.mark_done(chunk.key)

        if self.num_workers == 1:
            for c in todo:
                work(c)
        else:
            with ThreadPoolExecutor(self.num_workers) as pool:
                list(pool.map(work, todo))
        return len(todo)
