"""The chunk grid over a large volume, the port of
``pytorch_connectomics_tpu/chunked/grid.py:11-71``: core regions that
tile the volume, each read with a halo clipped to the volume."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ChunkRef:
    """One chunk: its core region [start, stop) in the volume and the
    halo-extended region it is read from."""

    index: Tuple[int, int, int]
    start: Tuple[int, int, int]
    stop: Tuple[int, int, int]
    read_start: Tuple[int, int, int]
    read_stop: Tuple[int, int, int]

    @property
    def key(self) -> str:
        return "_".join(map(str, self.index))

    @property
    def core_slices(self):
        return tuple(slice(a, b) for a, b in zip(self.start, self.stop))

    @property
    def read_slices(self):
        return tuple(slice(a, b) for a, b in zip(self.read_start, self.read_stop))

    @property
    def local_core_slices(self):
        """The core region inside the read region."""
        return tuple(slice(s - rs, e - rs) for s, e, rs in zip(self.start, self.stop, self.read_start))


def resolve_halo(
    halo: Optional[Sequence[int]], window: Optional[Sequence[int]] = None, overlap: float = 0.5
) -> Tuple[int, ...]:
    """``halo`` as given, else half the windows' overlap margin."""
    if halo is not None:
        return tuple(int(h) for h in halo)
    if window is None:
        return (0, 0, 0)
    return tuple(int(round(w * overlap / 2)) for w in window)


def build_chunk_grid(
    vol_shape: Sequence[int], chunk_size: Sequence[int], halo: Sequence[int] = (0, 0, 0)
) -> List[ChunkRef]:
    """Chunks in z, y, x order; edge chunks are cut to the volume."""
    chunks: List[ChunkRef] = []
    counts = [max(1, -(-s // c)) for s, c in zip(vol_shape, chunk_size)]
    for iz in range(counts[0]):
        for iy in range(counts[1]):
            for ix in range(counts[2]):
                idx = (iz, iy, ix)
                start = tuple(i * c for i, c in zip(idx, chunk_size))
                stop = tuple(min(s, (i + 1) * c) for i, c, s in zip(idx, chunk_size, vol_shape))
                read_start = tuple(max(0, a - h) for a, h in zip(start, halo))
                read_stop = tuple(min(s, b + h) for b, h, s in zip(stop, halo, vol_shape))
                chunks.append(ChunkRef(idx, start, stop, read_start, read_stop))
    return chunks
