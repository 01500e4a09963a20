"""End to end: the port's CLI ``--mode test --device cpu`` on a tiny .npy
volume against the JAX package's test pipeline on the same weights (the fast
recipe cut to a tiny MedNeXt in f32, flip TTA over y/x). The JAX params go
to the port as a flax-params .npz through ``--checkpoint``."""

import jax
import numpy as np
import pytest

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.data.io import read_volume as jax_read_volume
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.models.build import init_model as jax_init
from pytorch_connectomics_tpu.runtime.test_pipeline import run_test_pipeline as jax_run_test_pipeline
from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.inference import output as port_output
from pytorch_connectomics_tpu_torch.models.convert import flatten_flax
from pytorch_connectomics_tpu_torch.runtime.cli import main

FAST = "tutorials/mito_lucchi_tpu_fast.yaml"


def _overrides(image, label):
    return [
        f"data.test.image={image}",
        f"data.test.label={label}",
        "model.mednext.size=custom",
        "model.mednext.base_channels=8",
        "model.mednext.exp_ratio=2",
        "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
        "optimization.precision=32",
        "inference.window.window_size=[16,32,32]",
        "inference.window.sw_batch_size=2",
        "inference.test_time_augmentation.flip_axes=xy",
    ]


@pytest.fixture
def volume(tmp_path):
    rng = np.random.default_rng(0)
    image, label = tmp_path / "tiny_im.npy", tmp_path / "tiny_mito.npy"
    np.save(image, rng.integers(0, 256, (20, 40, 36), dtype=np.uint8))
    np.save(label, (rng.random((20, 40, 36)) > 0.6).astype(np.uint8))
    return image, label


def test_cli_test_mode_matches_jax_pipeline(tmp_path, volume):
    over = _overrides(*volume)
    cfg = jax_load_config(FAST, overrides=over, mode="test")
    model = jax_build(cfg.model)
    params = jax.tree.map(np.asarray, jax_init(model, cfg.model, jax.random.PRNGKey(0)))["params"]
    ckpt = tmp_path / "weights.npz"
    np.savez(ckpt, **flatten_flax(params))
    want_metrics = jax_run_test_pipeline(cfg, model, params, tmp_path / "jax", checkpoint=str(ckpt))
    res = main(["--config", FAST, "--mode", "test", "--device", "cpu", "--checkpoint", str(ckpt),
                "--output-dir", str(tmp_path / "port"), *over])
    name = "tiny_weights_tta_x4_prediction.h5"
    want = jax_read_volume(str(tmp_path / "jax" / name))
    got = read_volume(str(tmp_path / "port" / name))
    assert got.shape == want.shape == (1, 20, 40, 36)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(res["metrics"]["tiny"]["jaccard"] - want_metrics["tiny"]["jaccard"]) < 1e-3
    assert (tmp_path / "port" / "metrics.json").exists()


def test_cli_writes_npy_prediction_without_h5py(tmp_path, volume, monkeypatch):
    monkeypatch.setattr(port_output, "h5py_available", lambda: False)
    over = _overrides(*volume) + ["inference.test_time_augmentation.enabled=false"]
    res = main(["--config", FAST, "--mode", "test", "--device", "cpu", "--output-dir", str(tmp_path / "out"), *over])
    pred = np.load(tmp_path / "out" / "tiny_scratch_prediction.npy")
    assert pred.shape == (1, 20, 40, 36) and np.isfinite(pred).all() and 0 <= pred.min() <= pred.max() <= 1
    assert (tmp_path / "out" / "tiny_scratch_prediction.json").exists()
    assert 0 <= res["metrics"]["tiny"]["jaccard"] <= 1
