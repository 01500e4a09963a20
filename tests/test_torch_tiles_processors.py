"""Tile-grid sources and the chunk processors in the port against the JAX
package, on the same seeded arrays: ``TileVolume`` reads of a tile spec
(``write_tile_spec``'s file, its bytes too), the lazy accessor on a spec and
on a directory of sections (normalised reads, scaled and padded), the
``ChunkedProcessor`` map (threads, shards, resume) and the
``SkeletonVolumeProcessor``'s rasterised skeletons. Arrays equal bit for
bit."""

import json

import numpy as np
import pytest
from scipy import ndimage

from pytorch_connectomics_tpu.chunked import ChunkedProcessor as JaxChunkedProcessor
from pytorch_connectomics_tpu.chunked import SkeletonVolumeProcessor as JaxSkeletonVolumeProcessor
from pytorch_connectomics_tpu.chunked.skeleton import rasterize_skeletons as jax_rasterize
from pytorch_connectomics_tpu.data.tiles import TileVolume as JaxTileVolume
from pytorch_connectomics_tpu.data.tiles import write_tile_spec as jax_write_tile_spec
from pytorch_connectomics_tpu.inference.lazy import LazyVolumeAccessor as JaxLazyVolumeAccessor
from pytorch_connectomics_tpu.metrics.skeleton import skeletonize_volume as jax_skeletonize
from pytorch_connectomics_tpu_torch.chunked import ChunkedProcessor, SkeletonVolumeProcessor
from pytorch_connectomics_tpu_torch.chunked.skeleton import rasterize_skeletons
from pytorch_connectomics_tpu_torch.data.tiles import TileVolume, write_tile_spec
from pytorch_connectomics_tpu_torch.inference.lazy import LazyVolumeAccessor, is_tile_source

TILE = (8, 12)
GRID = (2, 3)


def write_tiles(root, z=3, offset=(0, 0)):
    """A seeded (z, 16, 36) uint8 stack as ``<z>/<row>_<col>.png`` tiles;
    rows and columns numbered from ``offset``."""
    from PIL import Image

    full = np.random.default_rng(z).integers(0, 255, (z, GRID[0] * TILE[0], GRID[1] * TILE[1]), dtype=np.uint8)
    for zi in range(z):
        (root / str(zi)).mkdir(parents=True)
        for r in range(GRID[0]):
            for c in range(GRID[1]):
                tile = full[zi, r * TILE[0]:(r + 1) * TILE[0], c * TILE[1]:(c + 1) * TILE[1]]
                Image.fromarray(tile).save(root / str(zi) / f"{r + offset[0]}_{c + offset[1]}.png")
    return full


WINDOWS = [(slice(0, 3), slice(0, 16), slice(0, 36)), (slice(1, 3), slice(3, 13), slice(5, 31)),
           (slice(2, 3), slice(8, 9), slice(12, 24)), (slice(0, 1), slice(15, 16), slice(0, 1))]


def test_tile_volume_matches_jax(tmp_path):
    full = write_tiles(tmp_path)
    sections = [[f"{z}/{r}_{c}.png" for r in range(GRID[0]) for c in range(GRID[1])] for z in range(3)]
    spec = write_tile_spec(tmp_path / "spec.json", TILE, GRID, sections)
    jspec = jax_write_tile_spec(tmp_path / "jspec.json", TILE, GRID, sections)
    assert spec.read_bytes() == jspec.read_bytes()
    tv, jtv = TileVolume(spec), JaxTileVolume(jspec)
    assert tv.shape == jtv.shape == full.shape and tv.dtype == jtv.dtype
    for sl in WINDOWS:
        got = tv[sl]
        assert got.dtype == np.uint8 and np.array_equal(got, jtv[sl]) and np.array_equal(got, full[sl])
    assert TileVolume(json.loads(spec.read_text()), root=tmp_path)[WINDOWS[1]].shape == (2, 10, 26)


@pytest.mark.parametrize("source", ["directory", "spec"])
def test_tile_sources_in_the_lazy_accessor_match_jax(tmp_path, source):
    full = write_tiles(tmp_path / "vol", offset=(1, 2) if source == "directory" else (0, 0))
    path = tmp_path / "vol"
    if source == "spec":
        path = write_tile_spec(tmp_path / "vol" / "spec.json", TILE, GRID,
                               [[f"{z}/{r}_{c}.png" for r in range(GRID[0]) for c in range(GRID[1])]
                                for z in range(3)])
    assert is_tile_source(str(path))
    for kw in ({"normalize": "none"}, {"normalize": "smart", "pad": (1, 2, 3)}, {"scale": (1.0, 0.5, 0.5)},
               {"transpose": (0, 2, 1), "normalize": "none"}):
        acc, jacc = LazyVolumeAccessor(str(path), **kw), JaxLazyVolumeAccessor(str(path), **kw)
        assert acc.shape == jacc.shape
        for frac in ((0, 1), (1, 2), (1, 3)):
            sl = tuple(slice(s * frac[0] // 4, s - s // 4 * (frac[1] - 1)) for s in acc.shape)
            got, want = acc.read(sl), jacc.read(sl)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        acc.close()
        assert np.array_equal(acc.read_all(), jacc.read_all())  # reopened after close
    assert np.array_equal(LazyVolumeAccessor(str(path), normalize="none").read_all(), full.astype(np.float32))


def smooth(shape, seed):
    return ndimage.gaussian_filter(np.random.default_rng(seed).standard_normal(shape), 1.0).astype(np.float32)


@pytest.mark.parametrize("workers,shard", [(1, None), (3, None), (2, (1, 3))])
def test_chunked_processor_matches_jax(tmp_path, workers, shard):
    vol = smooth((12, 40, 36), 0)
    kw = dict(halo=(2, 3, 3), num_workers=workers, shard_id=shard[0] if shard else None,
              num_shards=shard[1] if shard else None)

    def fn(data, chunk):
        return ndimage.gaussian_filter(data, 1.0) + chunk.index[0]

    outs = []
    for cls, name in ((ChunkedProcessor, "port"), (JaxChunkedProcessor, "jax")):
        out = np.zeros_like(vol)
        proc = cls(vol.shape, (6, 16, 16), manifest_path=str(tmp_path / f"{name}.json"), signature={"s": 1}, **kw)
        assert proc.run(lambda sl: vol[sl], out, process_fn=fn) == len(proc.chunks)
        assert cls(vol.shape, (6, 16, 16), manifest_path=str(tmp_path / f"{name}.json"), signature={"s": 1},
                   **kw).run(lambda sl: vol[sl], out, process_fn=fn) == 0  # resumed: nothing left
        outs.append(out)
    assert np.array_equal(outs[0], outs[1])
    assert np.count_nonzero(outs[0]) == (vol.size if shard is None else np.count_nonzero(outs[1]))
    with pytest.raises(ValueError, match="out of range"):
        ChunkedProcessor(vol.shape, (6, 16, 16), shard_id=3, num_shards=3)


def test_skeleton_processor_matches_jax():
    """Tubes, a bent instance and specks across a 2 x 2 x 2 chunk grid with
    halos: the rasterised skeletons bit for bit, and the whole volume's
    skeletons rasterised as JAX's are."""
    lab = np.zeros((16, 48, 48), np.uint32)
    lab[2:6, 4:44, 14:18] = 1
    lab[8:12, 30:34, 2:46] = 2
    lab[3:14, 20:24, 30:34] = 3
    lab[10:14, 6:10, 6:30] = 4
    lab[10:14, 6:20, 26:30] = 4
    rng = np.random.default_rng(0)
    specks = (rng.random(lab.shape) > 0.999) & (lab == 0)
    lab[specks] = 9
    outs = []
    for cls in (SkeletonVolumeProcessor, JaxSkeletonVolumeProcessor):
        out = np.zeros_like(lab)
        proc = cls(lab.shape, (8, 24, 24), halo=(2, 4, 4), stride=(1, 2, 2), min_voxels=10, num_workers=2)
        proc.run(reader=lambda sl: lab[sl], writer=out)
        outs.append(out)
    assert np.array_equal(outs[0], outs[1])
    assert set(np.unique(outs[0])) == {0, 1, 2, 3, 4}
    assert (outs[0][lab == 0] == 0).mean() > 0.95
    skels = jax_skeletonize(lab, stride=(1, 2, 2), min_voxels=10)
    assert np.array_equal(rasterize_skeletons(skels, lab.shape), jax_rasterize(skels, lab.shape))
