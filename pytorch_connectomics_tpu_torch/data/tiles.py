"""2-D tile-grid volumes, the port of ``pytorch_connectomics_tpu/data/tiles.py``:
each section stored as a grid of image tiles, stitched into (z, y, x) crops
when read. A tile spec::

    {"tile_size": [th, tw], "grid": [rows, cols], "dtype": "uint8", "sections": [
        ["z0_r0c0.png", "z0_r0c1.png", ...],   # row-major, one list a section
        ...
    ]}

Tiles are read through PIL as 8-bit grey, paths relative to the spec's
directory.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# tiles kept decoded, the oldest dropped first
_CACHE_TILES = 256


class TileVolume:
    """A lazy (Z, Y, X) view of a tiled stack of 2-D images."""

    def __init__(self, spec: Dict | str | Path, root: Optional[str | Path] = None):
        if not isinstance(spec, dict):
            path = Path(spec)
            root = root or path.parent
            spec = json.loads(path.read_text())
        self.spec = spec
        self.root = Path(root) if root else Path(".")
        self.tile_size = tuple(spec["tile_size"])
        self.grid = tuple(spec["grid"])
        self.sections: List[List[str]] = spec["sections"]
        self.shape = (len(self.sections), self.grid[0] * self.tile_size[0], self.grid[1] * self.tile_size[1])
        self.dtype = np.dtype(spec.get("dtype", "uint8"))
        self._cache: Dict[Tuple[int, int, int], np.ndarray] = {}

    def _load_tile(self, z: int, r: int, c: int) -> np.ndarray:
        key = (z, r, c)
        if key not in self._cache:
            from PIL import Image

            with Image.open(self.root / self.sections[z][r * self.grid[1] + c]) as im:
                self._cache[key] = np.asarray(im.convert("L"))
            if len(self._cache) > _CACHE_TILES:
                self._cache.pop(next(iter(self._cache)))
        return self._cache[key]

    def __getitem__(self, slices: Tuple[slice, ...]) -> np.ndarray:
        sz, sy, sx = slices
        z0, z1, _ = sz.indices(self.shape[0])
        y0, y1, _ = sy.indices(self.shape[1])
        x0, x1, _ = sx.indices(self.shape[2])
        th, tw = self.tile_size
        out = np.zeros((z1 - z0, y1 - y0, x1 - x0), self.dtype)
        for z in range(z0, z1):
            for r in range(y0 // th, (y1 - 1) // th + 1):
                for c in range(x0 // tw, (x1 - 1) // tw + 1):
                    ty0, tx0 = r * th, c * tw
                    # the tile's part of the request, in both frames
                    iy0, iy1 = max(y0, ty0), min(y1, ty0 + th)
                    ix0, ix1 = max(x0, tx0), min(x1, tx0 + tw)
                    if iy0 >= iy1 or ix0 >= ix1:
                        continue
                    tile = self._load_tile(z, r, c)
                    out[z - z0, iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = tile[iy0 - ty0:iy1 - ty0, ix0 - tx0:ix1 - tx0]
        return out


def write_tile_spec(path: str | Path, tile_size: Sequence[int], grid: Sequence[int], sections: List[List[str]],
                    dtype: str = "uint8") -> Path:
    """Write a tile spec JSON; returns its path."""
    p = Path(path)
    p.write_text(json.dumps({"tile_size": list(tile_size), "grid": list(grid), "sections": sections, "dtype": dtype},
                            indent=2))
    return p
