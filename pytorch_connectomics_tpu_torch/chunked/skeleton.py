"""Chunked skeleton precompute, the port of
``pytorch_connectomics_tpu/chunked/skeleton.py``: each chunk's instances
skeletonised (the native TEASAR of :mod:`..metrics.skeleton`) and their
edges drawn, by instance id, into a uint32 volume; the halo keeps the
skeletons near a chunk's border stable.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..metrics.skeleton import Skeleton, skeletonize_volume
from .grid import ChunkRef
from .processor import ChunkedProcessor


def rasterize_skeletons(skeletons: Dict[int, Skeleton], shape) -> np.ndarray:
    """Each skeleton's edges drawn as straight voxel lines of its id into a
    uint32 volume of ``shape``."""
    out = np.zeros(tuple(shape), np.uint32)
    for iid, sk in skeletons.items():
        for a, b in sk.edges:
            pa, pb = sk.nodes[a], sk.nodes[b]
            pts = np.linspace(pa, pb, int(np.ceil(np.linalg.norm(pb - pa))) + 1)
            idx = np.clip(np.round(pts).astype(int), 0, np.asarray(shape) - 1)
            out[idx[:, 0], idx[:, 1], idx[:, 2]] = iid
    return out


class SkeletonVolumeProcessor(ChunkedProcessor):
    """A :class:`.processor.ChunkedProcessor` whose chunks are instance
    volumes and whose results are their rasterised skeletons."""

    def __init__(self, *args, stride=(2, 4, 4), anisotropy=(1.0, 1.0, 1.0), min_voxels: int = 50, **kw):
        super().__init__(*args, **kw)
        self.stride = stride
        self.anisotropy = anisotropy
        self.min_voxels = min_voxels

    def process_chunk(self, data: np.ndarray, chunk: ChunkRef) -> np.ndarray:
        skels = skeletonize_volume(data.astype(np.uint32), stride=self.stride, anisotropy=self.anisotropy,
                                   min_voxels=self.min_voxels)
        return rasterize_skeletons(skels, data.shape)
