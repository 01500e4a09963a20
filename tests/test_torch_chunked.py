"""Chunked inference in the port against the JAX package on the CPU: the
chunk grid, halo and shard selection, the resume manifest, lazy reads
(HDF5, ``.npy``, ``random://``, zarr; virtual pad, transpose and read-time
scaling), ``run_chunked_inference`` of a tiny MedNeXt whose flax weights go
to the port through ``models/convert.py`` (f32, within 1e-5 of JAX's output),
its resume (exactly the chunks missing from the manifest are recomputed,
and the file comes out bit-equal), the ``__incomplete__`` sentinel, the
``.npy`` output without h5py, errors on the reader and writer threads, and
the axis-range train/val split."""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.chunked.grid import build_chunk_grid as jax_build_chunk_grid
from pytorch_connectomics_tpu.chunked.grid import resolve_halo as jax_resolve_halo
from pytorch_connectomics_tpu.chunked.manifest import ResumeManifest as JaxResumeManifest
from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.config.schema import ChunkedConfig as JaxChunkedConfig
from pytorch_connectomics_tpu.config.schema import build_dataclass as jax_build_dataclass
from pytorch_connectomics_tpu.data import split as jsplit
from pytorch_connectomics_tpu.data.io import read_volume as jax_read_volume
from pytorch_connectomics_tpu.data.pipeline import make_train_val_datasets as jax_make_train_val_datasets
from pytorch_connectomics_tpu.inference import InferenceManager as JaxInferenceManager
from pytorch_connectomics_tpu.inference import run_chunked_inference as jax_run_chunked_inference
from pytorch_connectomics_tpu.inference import select_chunks_for_shard as jax_select_chunks_for_shard
from pytorch_connectomics_tpu.inference.lazy import LazyVolumeAccessor as JaxLazyVolumeAccessor
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.models.build import init_model as jax_init
from pytorch_connectomics_tpu_torch.chunked import ResumeManifest, build_chunk_grid, resolve_halo
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.config.schema import ChunkedConfig, build_dataclass
from pytorch_connectomics_tpu_torch.data import split as psplit
from pytorch_connectomics_tpu_torch.data.io import read_volume, save_volume
from pytorch_connectomics_tpu_torch.data.pipeline import make_train_val_datasets
from pytorch_connectomics_tpu_torch.inference import InferenceManager, LazyVolumeAccessor, run_chunked_inference
from pytorch_connectomics_tpu_torch.inference import chunked as pchunked
from pytorch_connectomics_tpu_torch.inference import output as poutput
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import load_flax_params

NISB = "tutorials/neuron_nisb.yaml"
SNEMI_V1 = "tutorials/neuron_snemi_v1.yaml"
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "optimization.precision=32",
    "model.input_size=[16,16,16]",
    "inference.window.window_size=[16,16,16]",
    "inference.window.sw_batch_size=4",
]
CHUNKS = {"enabled": True, "chunk_size": [16, 24, 24], "halo": [2, 4, 4]}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch operations: one intra-op thread, as the other CPU
    parity tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def volume(tmp_path):
    """A seeded uint8 (16, 48, 44) volume as HDF5 and as .npy: four chunks,
    two of them cut at the x edge (two read shapes, so JAX compiles twice)."""
    vol = np.random.default_rng(0).integers(0, 256, (16, 48, 44), dtype=np.uint8)
    save_volume(str(tmp_path / "im.h5"), vol)
    np.save(tmp_path / "im.npy", vol)
    return vol


# ---------------------------------------------------------------------------
# grid, halo, manifest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,chunk,halo", [((96, 768, 768), (64, 512, 512), (8, 32, 32)),
                                              ((20, 40, 44), (16, 24, 20), (2, 4, 4)),
                                              ((8, 8, 8), (16, 16, 16), (0, 0, 0))])
def test_chunk_grid_matches_jax(shape, chunk, halo):
    got, want = build_chunk_grid(shape, chunk, halo), jax_build_chunk_grid(shape, chunk, halo)
    assert [(c.index, c.start, c.stop, c.read_start, c.read_stop, c.key) for c in got] == \
        [(c.index, c.start, c.stop, c.read_start, c.read_stop, c.key) for c in want]
    assert [(c.core_slices, c.read_slices, c.local_core_slices) for c in got] == \
        [(c.core_slices, c.read_slices, c.local_core_slices) for c in want]
    covered = np.zeros(shape[:1] + (1, 1), np.int32) if shape[0] > 64 else np.zeros(shape, np.int32)
    if covered.shape == tuple(shape):
        for c in got:
            covered[c.core_slices] += 1
        assert (covered == 1).all()
    for h, w, o in ((None, (32, 128, 128), 0.5), ([8, 32, 32], None, 0.5), (None, None, 0.5),
                    (None, (16, 16, 16), 0.25)):
        assert resolve_halo(h, w, o) == jax_resolve_halo(h, w, o)
    for shard, n in ((None, None), (0, 3), (2, 3)):
        assert [c.key for c in pchunked.select_chunks_for_shard(got, shard, n)] == \
            [c.key for c in jax_select_chunks_for_shard(want, shard, n)]


def test_manifest_matches_jax(tmp_path):
    sig = {"config_hash": "abc", "checkpoint": "run/last"}
    m, jm = ResumeManifest(tmp_path / "p.json", sig), JaxResumeManifest(tmp_path / "j.json", sig)
    for key in ("0_0_1", "0_0_0", "1_0_0"):
        m.mark_done(key)
        jm.mark_done(key)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert ResumeManifest(tmp_path / "p.json", sig).completed == {"0_0_1", "0_0_0", "1_0_0"}
    assert ResumeManifest(tmp_path / "p.json", sig).is_done("0_0_0")
    # another signature (other weights) starts from scratch and drops the file
    assert ResumeManifest(tmp_path / "p.json", {**sig, "checkpoint": "x"}).completed == set()
    assert not (tmp_path / "p.json").exists()
    assert list(tmp_path.glob("*.tmp")) == []


# ---------------------------------------------------------------------------
# lazy reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["h5", "npy", "random", "zarr"])
@pytest.mark.parametrize("kw", [{}, {"pad": [2, 4, 4]}, {"transpose": [0, 2, 1]}, {"scale": [1.0, 0.5, 0.75]},
                                {"pad": [1, 3, 2], "transpose": [1, 0, 2], "normalize": "zscore"}],
                         ids=["plain", "pad", "transpose", "scale", "pad_transpose_zscore"])
def test_lazy_reads_match_jax(tmp_path, volume, source, kw):
    if source == "zarr":
        pytest.importorskip("tensorstore")
        save_volume(str(tmp_path / "im.zarr"), volume)
    path = {"h5": tmp_path / "im.h5", "npy": tmp_path / "im.npy", "zarr": tmp_path / "im.zarr",
            "random": "random://lazy_image?shape=20,40,44"}[source]
    acc, jacc = LazyVolumeAccessor(str(path), **kw), JaxLazyVolumeAccessor(str(path), **kw)
    assert acc.shape == jacc.shape and acc.base_shape == jacc.base_shape and acc.dtype == jacc.dtype
    # boxes at the low and high edges (into the pad, where there is one) and inside
    for box in ((0, 3), (1, 1), (4, 2)):
        sl = tuple(slice(s * box[0] // 8, s - s * box[1] // 8) for s in acc.shape)
        got, want = acc.read(sl), jacc.read(sl)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(acc.read_all(), jacc.read_all())
    acc.close()
    jacc.close()


def test_tile_sources_raise(tmp_path):
    """Tile sources that cannot be read raise as the JAX package's do: a
    directory without numeric section directories when opened, a spec
    naming a tile that is not there when read."""
    (tmp_path / "empty").mkdir()
    for cls in (LazyVolumeAccessor, JaxLazyVolumeAccessor):
        with pytest.raises(ValueError, match="no numeric section directories"):
            cls(str(tmp_path / "empty"))
    (tmp_path / "tiles.json").write_text(json.dumps({"tile_size": [4, 4], "grid": [1, 1], "sections": [["a.png"]]}))
    for cls in (LazyVolumeAccessor, JaxLazyVolumeAccessor):
        acc = cls(str(tmp_path / "tiles.json"), normalize="none")
        assert acc.shape == (1, 4, 4)
        with pytest.raises(FileNotFoundError):
            acc.read_all()


# ---------------------------------------------------------------------------
# run_chunked_inference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny NISB MedNeXt in both packages on one set of flax weights,
    each behind its package's inference manager."""
    cfg, jcfg = load_config(NISB, overrides=TINY, mode="test"), jax_load_config(NISB, overrides=TINY, mode="test")
    jmodel = jax_build(jcfg.model)
    params = jax.tree.map(np.asarray, jax_init(jmodel, jcfg.model, jax.random.PRNGKey(0)))["params"]
    model = build_model(cfg.model, device="cpu")
    load_flax_params(model, params)
    model.eval()
    return InferenceManager(cfg, model, "cpu"), JaxInferenceManager(jcfg, jmodel), params


class Counting:
    """A predictor wrapper that counts its calls and can fail on one."""

    def __init__(self, predictor, fail_on=None):
        self.inner, self.calls, self.fail_on = predictor, 0, fail_on

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def predict(self, data, out_channels=None):
        self.calls += 1
        if self.calls == self.fail_on:
            raise RuntimeError("predict failed")
        return self.inner.predict(data, out_channels=out_channels)


def run_bounded(fn, seconds=60):
    """Run ``fn`` on a thread; fails if it has not returned in ``seconds``."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "the chunked run hung"
    if "error" in box:
        raise box["error"]
    return box["value"]


def test_run_chunked_inference_matches_jax_and_resumes(tmp_path, volume, tiny_models):
    manager, jmanager, params = tiny_models
    sig = {"config_hash": "h", "checkpoint": "weights.npz"}
    cfg, jcfg = build_dataclass(ChunkedConfig, CHUNKS), jax_build_dataclass(JaxChunkedConfig, CHUNKS)
    want_path = jax_run_chunked_inference(jmanager.predictor, params, JaxLazyVolumeAccessor(str(tmp_path / "im.h5")),
                                          tmp_path / "jax" / "pred.h5", jcfg, out_channels=3, signature=sig)
    counting = Counting(manager.predictor)
    path = run_chunked_inference(counting, LazyVolumeAccessor(str(tmp_path / "im.h5")), tmp_path / "port" / "pred.h5",
                                 cfg, out_channels=3, signature=sig)
    assert path == tmp_path / "port" / "pred.h5" and counting.calls == 4
    got, want = read_volume(str(path)), jax_read_volume(str(want_path))
    assert got.shape == want.shape == (3, 16, 48, 44) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    import h5py

    with h5py.File(path) as f:
        attrs = dict(f["main"].attrs)
    assert attrs["checkpoint"] == "weights.npz" and attrs["config_hash"] == "h"
    # a second run recomputes nothing; one manifest entry removed, exactly that chunk
    manifest = tmp_path / "port" / "pred.h5.manifest.json"
    for removed in ([], ["0_1_1"]):
        data = json.loads(manifest.read_text())
        data["done"] = [k for k in data["done"] if k not in removed]
        manifest.write_text(json.dumps(data))
        counting.calls = 0
        run_chunked_inference(counting, LazyVolumeAccessor(str(tmp_path / "im.h5")), path, cfg, out_channels=3,
                              signature=sig)
        assert counting.calls == len(removed)
        assert np.array_equal(read_volume(str(path)), got)
    # other weights: the manifest is dropped and every chunk recomputed
    counting.calls = 0
    run_chunked_inference(counting, LazyVolumeAccessor(str(tmp_path / "im.h5")), path, cfg, out_channels=3,
                          signature={**sig, "checkpoint": "other"})
    assert counting.calls == 4


def test_chunked_npy_output_without_h5py_and_the_incomplete_sentinel(tmp_path, volume, monkeypatch, tiny_models):
    """Without h5py the output is an .npy memory map with its attrs in the
    JSON beside it; a run that fails leaves ``__incomplete__`` there and a
    manifest of the chunks written, and a rerun finishes the rest."""
    monkeypatch.setattr(poutput, "h5py_available", lambda: False)
    manager, _, _ = tiny_models
    cfg = build_dataclass(ChunkedConfig, CHUNKS)
    sig = {"config_hash": "h", "checkpoint": ""}
    failing = Counting(manager.predictor, fail_on=3)
    with pytest.raises(RuntimeError, match="predict failed"):
        run_bounded(lambda: run_chunked_inference(failing, LazyVolumeAccessor(str(tmp_path / "im.npy")),
                                                  tmp_path / "pred.h5", cfg, out_channels=3, signature=sig))
    attrs = json.loads((tmp_path / "pred.json").read_text())
    assert attrs["checkpoint"] == pchunked.INCOMPLETE
    done = json.loads((tmp_path / "pred.h5.manifest.json").read_text())["done"]
    assert done == ["0_0_0", "0_0_1"]
    counting = Counting(manager.predictor)
    path = run_chunked_inference(counting, LazyVolumeAccessor(str(tmp_path / "im.npy")), tmp_path / "pred.h5", cfg,
                                 out_channels=3, signature=sig)
    assert path == tmp_path / "pred.npy" and counting.calls == 2
    assert json.loads((tmp_path / "pred.json").read_text())["checkpoint"] == "random-init"
    whole = build_dataclass(ChunkedConfig, {**CHUNKS, "resume": False})
    ref = run_chunked_inference(manager.predictor, LazyVolumeAccessor(str(tmp_path / "im.npy")), tmp_path / "ref.h5",
                                whole, out_channels=3, signature=sig)
    assert np.array_equal(np.load(path), np.load(ref))
    assert not (tmp_path / "ref.h5.manifest.json").exists()


@pytest.mark.parametrize("where", ["reader", "writer", "predict"])
def test_an_error_on_any_thread_ends_the_run(tmp_path, volume, where, tiny_models):
    manager, _, _ = tiny_models
    cfg = build_dataclass(ChunkedConfig, CHUNKS)
    acc = LazyVolumeAccessor(str(tmp_path / "im.npy"))
    predictor = Counting(manager.predictor, fail_on=2 if where == "predict" else None)
    if where == "reader":
        reads = []

        def read(sl, inner=acc.read):
            reads.append(sl)
            if len(reads) == 2:
                raise OSError("read failed")
            return inner(sl)

        acc.read = read
    if where == "writer":
        predictor.predict = lambda data, out_channels=None: np.zeros(data.shape + (2,), np.float32)
    match = {"reader": "read failed", "writer": "broadcast", "predict": "predict failed"}[where]
    with pytest.raises((OSError, TypeError, ValueError, RuntimeError), match=match):
        run_bounded(lambda: run_chunked_inference(predictor, acc, tmp_path / "pred.h5", cfg, out_channels=3))


def test_unported_outputs_raise(tmp_path, tiny_models, monkeypatch):
    """The precomputed output is ported; where tensorstore is missing it
    raises, naming what it needs, before a chunk is predicted."""
    import sys

    manager, _, _ = tiny_models
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    cfg = build_dataclass(ChunkedConfig, {**CHUNKS, "output_mode": "precomputed"})
    with pytest.raises(RuntimeError, match="needs tensorstore"):
        run_chunked_inference(manager.predictor, LazyVolumeAccessor("random://x_image?shape=8,16,16"),
                              tmp_path / "pred", cfg, out_channels=3)


def test_chunked_zarr_output(tmp_path, volume, tiny_models):
    pytest.importorskip("tensorstore")
    manager, _, _ = tiny_models
    cfg = build_dataclass(ChunkedConfig, {**CHUNKS, "resume": False})
    acc = LazyVolumeAccessor(str(tmp_path / "im.npy"))
    path = run_chunked_inference(manager.predictor, acc, tmp_path / "pred.zarr", cfg, out_channels=3)
    ref = run_chunked_inference(manager.predictor, acc, tmp_path / "pred.h5", cfg, out_channels=3)
    assert path == tmp_path / "pred.zarr" and np.array_equal(read_volume(str(path)), read_volume(str(ref)))


# ---------------------------------------------------------------------------
# the axis-range train/val split
# ---------------------------------------------------------------------------


def test_split_functions_match_jax():
    vol = np.arange(10 * 6 * 4).reshape(10, 6, 4)
    for axis, tr, va in ((0, None, None), (0, [0.0, 0.8], [0.8, 1.0]), (1, [2, 6], None), (2, None, [0, 1]),
                         (0, [0.3, 1.0], None)):
        for got, want in zip(psplit.split_volume(vol, axis, tr, va), jsplit.split_volume(vol, axis, tr, va)):
            assert np.array_equal(got, want)
    for args in (((10, 6, 4), 0.8, 0), ((10, 6, 4), 0.5, 2, 3), ((10, 6, 4), 0.9, 0, 4)):
        assert psplit.split_slices(*args) == jsplit.split_slices(*args)
        for got, want in zip(psplit.create_split_masks(*args), jsplit.create_split_masks(*args)):
            assert np.array_equal(got, want)
    for mode in ("reflect", "replicate", "constant", "circular"):
        for v in (vol, vol[None]):
            assert np.array_equal(psplit.pad_volume_to_size(v, (12, 9, 4), mode),
                                  jsplit.pad_volume_to_size(v, (12, 9, 4), mode))
            for got, want in zip(psplit.split_and_pad_volume(v, 0.7, (6, 8, 8), pad_mode=mode),
                                 jsplit.split_and_pad_volume(v, 0.7, (6, 8, 8), pad_mode=mode)):
                assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        psplit.split_slices((4, 4, 4), 1.5)


def test_snemi_v1_split_datasets_match_jax():
    """neuron_snemi_v1.yaml splits its one train volume 0.8 / 0.2 on z."""
    over = ["data.train.image=random://v1_image?shape=20,48,48", "data.train.label=random://v1_label?shape=20,48,48",
            "data.dataloader.patch_size=[4,32,32]"]
    cfg, jcfg = load_config(SNEMI_V1, overrides=over, mode="train"), jax_load_config(SNEMI_V1, overrides=over,
                                                                                      mode="train")
    assert cfg.data.split.enabled and not cfg.data.val.image
    (tr, va), (jtr, jva) = make_train_val_datasets(cfg), jax_make_train_val_datasets(jcfg)
    for got, want in ((tr, jtr), (va, jva)):
        assert len(got.images) == len(want.images) == 1
        assert np.array_equal(got.images[0], want.images[0]) and np.array_equal(got.labels[0], want.labels[0])
    assert tr.images[0].shape == (16, 48, 48) and va.images[0].shape == (4, 48, 48)
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        got, want = va.sample(rng), jva.sample(jrng)
        assert np.array_equal(got["image"], want["image"]) and np.array_equal(got["label"], want["label"])
