"""The port's volume io and intensity normalisation against the JAX package's."""

import numpy as np
import pytest

from pytorch_connectomics_tpu.data.io import read_volume as jax_read_volume
from pytorch_connectomics_tpu.data.preprocess import normalize_volume as jax_normalize_volume
from pytorch_connectomics_tpu_torch.data.io import read_volume, save_volume
from pytorch_connectomics_tpu_torch.data.preprocess import normalize_volume


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("method", ["smart", "zscore", "percentile", "scale", "none"])
def test_normalize_matches_jax(dtype, method):
    rng = np.random.default_rng(0)
    hi = np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) else 3.0
    vol = (rng.random((5, 6, 7)) * hi).astype(dtype)
    got, want = normalize_volume(vol, method), jax_normalize_volume(vol, method)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["vol.npy", "vol.h5", "vol.h5:raw"])
def test_io_roundtrip_and_jax_reads_it(tmp_path, name):
    vol = np.random.default_rng(1).integers(0, 255, (4, 5, 6), dtype=np.uint8)
    path = str(tmp_path / name)
    save_volume(path, vol, attrs={"k": "v"} if ".h5" in name else None)
    np.testing.assert_array_equal(read_volume(path), vol)
    np.testing.assert_array_equal(jax_read_volume(path), vol)
    np.testing.assert_array_equal(read_volume(path, roi=(slice(1, 3),)), vol[1:3])


def test_unsupported_formats_raise(tmp_path):
    with pytest.raises(ValueError):
        read_volume(str(tmp_path / "vol.tif"))
    with pytest.raises(ValueError):
        save_volume(str(tmp_path / "vol.zarr"), np.zeros((2, 2, 2)))


# ---------------------------------------------------------------------------
# training data: patch pipeline and synthetic volumes
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import torch  # noqa: E402

from pytorch_connectomics_tpu.config import load_config as jax_load_config  # noqa: E402
from pytorch_connectomics_tpu.data.pipeline import PatchPipeline as JaxPatchPipeline  # noqa: E402
from pytorch_connectomics_tpu.data.pipeline import build_dataset as jax_build_dataset  # noqa: E402
from pytorch_connectomics_tpu.data.synthetic_jax import synthetic_em_volume as jax_em  # noqa: E402
from pytorch_connectomics_tpu.data.synthetic_jax import synthetic_em_volume_v2 as jax_em2  # noqa: E402
from pytorch_connectomics_tpu_torch.config import load_config  # noqa: E402
from pytorch_connectomics_tpu_torch.data import synthetic  # noqa: E402
from pytorch_connectomics_tpu_torch.data.pipeline import PatchPipeline, build_dataset, build_pipelines  # noqa: E402

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"


def test_patch_pipeline_bit_identical_to_jax(tmp_path):
    """The same volume through both pipelines (reject sampling on, binary
    target) gives bit-identical batches."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (20, 48, 40), dtype=np.uint8)
    lbl = (rng.random((20, 48, 40)) > 0.97).astype(np.uint32) * rng.integers(1, 5, (20, 48, 40), dtype=np.uint32)
    np.save(tmp_path / "im.npy", img)
    np.save(tmp_path / "lb.npy", lbl)
    over = [f"data.train.image={tmp_path / 'im.npy'}", f"data.train.label={tmp_path / 'lb.npy'}",
            "data.dataloader.patch_size=[8,16,16]", "data.dataloader.batch_size=3"]
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    ours = PatchPipeline(build_dataset(cfg, cfg.data.train), 3, seed=cfg.system.seed, target_cfg=cfg.data.label_transform)
    ref = JaxPatchPipeline(jax_build_dataset(jcfg, jcfg.data.train), 3, seed=jcfg.system.seed,
                           target_cfg=jcfg.data.label_transform)
    for step in (0, 1, 7):
        got, want = ours.make_batch(step), ref.make_batch(step)
        assert set(got) == set(want) == {"image", "label"}
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape == (3, 8, 16, 16, 1)
            np.testing.assert_array_equal(got[k], want[k])
    batches = ours.iterate(5)  # the prefetch thread makes the same batches
    np.testing.assert_array_equal(next(batches)["image"], ref.make_batch(5)["image"])
    batches.close()


def test_configured_augmentation_raises():
    cfg = load_config(SYNTH, overrides=["data.augmentation.flip={enabled: true, prob: 0.5}"], mode="train")
    with pytest.raises(NotImplementedError, match="augmentation is not ported yet: flip"):
        build_pipelines(cfg, "cpu")


@pytest.mark.parametrize("v2", [True, False], ids=["em2", "em"])
def test_synthetic_transform_matches_jax_on_jax_draws(v2):
    """The port's transform fed the draws of JAX's own keys gives JAX's
    volume: float32 within 1e-5, labels identical."""
    shape = (12, 40, 36)
    key = jax.random.PRNGKey(7)
    fields = synthetic._V2_FIELDS if v2 else synthetic._V1_FIELDS
    ks = jax.random.split(key, 10 if v2 else 8)
    # key index of each draw in synthetic_jax.py:76-146
    slot = {"mito": 0, "cristae": 1, "distract": 2, "dtex": 7, "cyto": 3, "gain": 4}
    d = {k: jax.random.normal(ks[slot[k]], synthetic.low_shape(shape, fv)) for k, fv in fields.items()}
    d["slice_gain"] = jax.random.normal(ks[5], (shape[0], 1, 1))
    d["noise"] = jax.random.normal(ks[6], shape)
    if v2:
        d["shifts"] = jax.random.randint(ks[8], (shape[0], 2), -2, 3)
        d["zmiss"] = jax.random.randint(ks[9], (), 1, shape[0] - 1)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    want_img, want_lbl = (jax_em2 if v2 else jax_em)(key, shape)
    gen = synthetic.synthetic_em_volume_v2 if v2 else synthetic.synthetic_em_volume
    img, lbl = gen(draws, shape)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(want_lbl))


def test_synthetic_url_is_deterministic_per_seed():
    from pytorch_connectomics_tpu_torch.data import io

    url = "synthetic://em2/cli_train_{}?shape=8,24,20"
    img, lbl = read_volume(url.format("image")), read_volume(url.format("label"))
    assert img.dtype == np.uint8 and lbl.dtype == np.uint32 and img.shape == lbl.shape == (8, 24, 20)
    assert 0 < lbl.mean() < 0.5
    io._SYNTH_CACHE.clear()
    np.testing.assert_array_equal(read_volume(url.format("image")), img)
    a, _ = synthetic.synthetic_em_task("em2", (8, 24, 20), seed=3)
    b, _ = synthetic.synthetic_em_task("em2", (8, 24, 20), seed=4)
    assert not np.array_equal(a, b)
    with pytest.raises(NotImplementedError):
        read_volume("synthetic://instance/x_image?shape=8,8,8")
