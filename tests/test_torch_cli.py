"""End to end: the port's CLI ``--mode test --device cpu`` on a tiny .npy
volume against the JAX package's test pipeline on the same weights (the fast
recipe cut to a tiny MedNeXt in f32, flip TTA over y/x). The JAX params go
to the port as a flax-params .npz through ``--checkpoint``."""

import json

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


SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"
TINY_TRAIN = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "optimization.precision=32",
    "model.input_size=[16,32,32]",
    "inference.window.window_size=[16,32,32]",
    "inference.window.sw_batch_size=2",
    "data.test.image=synthetic://em2/cli_test_image?shape=16,40,36",
    "data.test.label=synthetic://em2/cli_test_label?shape=16,40,36",
]


def test_cli_train_then_test_restores_the_checkpoint(tmp_path):
    """--mode train --device cpu for two steps on the synthetic recipe cut
    to a tiny model, then --mode test without --checkpoint: the test leg
    finds the train leg's last checkpoint and restores its weights."""
    import json

    import torch

    from pytorch_connectomics_tpu_torch.training.checkpoint import CheckpointManager

    over = TINY_TRAIN + [
        f"save_path={tmp_path / 'runs'}",
        "data.train.image=synthetic://em2/cli_train_image?shape=16,48,48",
        "data.train.label=synthetic://em2/cli_train_label?shape=16,48,48",
        "data.dataloader.batch_size=2", "data.dataloader.patch_size=[16,32,32]",
        "optimization.n_steps_per_epoch=2", "optimization.max_epochs=1",
        "monitor.logging.scalar.loss_every_n_steps=1",
    ]
    res = main(["--config", SYNTH, "--mode", "train", "--device", "cpu", *over])
    run_dir = tmp_path / "runs" / res["run_dir"].split("/")[-1]
    assert res["train_stats"]["steps"] == 2
    assert (run_dir / "config.yaml").exists()
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss_total"] for r in recs if "train_loss_total" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    last = run_dir / "checkpoints" / "last"
    assert res["checkpoint"] == str(last) and (last / "state.pt").exists()
    meta = CheckpointManager.read_metadata(last)
    assert meta["step"] == 2 and meta["config_hash"] == res["config_hash"]
    saved = CheckpointManager.load(last)
    test = main(["--config", SYNTH, "--mode", "test", "--device", "cpu", *over])
    assert test["restored"]["checkpoint"] == str(last) and test["restored"]["step"] == 2
    assert test["restored"]["config_hash"] == res["config_hash"]
    assert test["run_dir"] == str(run_dir / "test")
    assert 0 <= test["metrics"]["synthetic"]["jaccard"] <= 1
    pred = read_volume(str(run_dir / "test" / "synthetic_last_tta_x2_prediction.h5"))
    assert pred.shape == (1, 16, 40, 36) and np.isfinite(pred).all()
    # the restored weights are the trained ones, not the seeded init
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.models import build_model

    init = build_model(load_config(SYNTH, overrides=over, mode="test").model, device="cpu", seed=42).state_dict()
    assert any(not torch.equal(init[k], v) for k, v in saved["model"].items())


NUCMM = "tutorials/nuc_nucmm.yaml"
TINY_NUCMM = [
    "model.rsunet.width=[8,12]",
    "optimization.precision=32",
    "model.input_size=[16,16,16]",
    "inference.window.window_size=[16,16,16]",
    "inference.window.sw_batch_size=4",
]


def test_cli_nucmm_test_mode_matches_jax_pipeline(tmp_path):
    """--mode test --device cpu of the NucMM-Z recipe (RSUNet, bcd decode,
    instance metrics) cut to a tiny f32 RSUNet, against the JAX package's
    test pipeline on the same flax weights and the same seeded volume: the
    prediction within f32 tolerance, the decoded labels identical,
    instance_f1 and ap reported. The tolerance, atol 1e-4 on probabilities:
    the sums run in another order, and GroupNorm's fast variance E[x^2] -
    E[x]^2 cancels on this input (mean 0.67, spread 0.14 after
    normalisation), which magnifies those differences (the logits of one
    window agree to 1.1e-5 of their largest magnitude; on zero-mean input
    to 1.8e-6)."""
    from scipy import ndimage

    image, label = tmp_path / "nuc_im.npy", tmp_path / "nuc_label.npy"
    np.save(image, read_volume("synthetic://em2/nuc_image?shape=24,48,48"))
    np.save(label, ndimage.label(read_volume("synthetic://em2/nuc_label?shape=24,48,48") > 0)[0].astype(np.uint32))
    over = TINY_NUCMM + [f"data.test.image={image}", f"data.test.label={label}"]
    cfg = jax_load_config(NUCMM, overrides=over, mode="test")
    model = jax_build(cfg.model)
    params = jax.tree.map(np.asarray, jax_init(model, cfg.model, jax.random.PRNGKey(0)))["params"]
    ckpt = tmp_path / "weights.npz"
    np.savez(ckpt, **flatten_flax(params))
    jax_run_test_pipeline(cfg, model, params, tmp_path / "jax", checkpoint=str(ckpt))
    res = main(["--config", NUCMM, "--mode", "test", "--device", "cpu", "--checkpoint", str(ckpt),
                "--output-dir", str(tmp_path / "port"), *over])
    got = read_volume(str(tmp_path / "port" / "nuc_weights_prediction.h5"))
    want = jax_read_volume(str(tmp_path / "jax" / "nuc_weights_prediction.h5"))
    assert got.shape == want.shape == (3, 24, 48, 48)
    np.testing.assert_allclose(got, want, atol=1e-4)
    name = "nuc_weights_decoded_bcd_watershed_0.9-0.85-0.5.h5"
    np.testing.assert_array_equal(read_volume(str(tmp_path / "port" / name)),
                                  jax_read_volume(str(tmp_path / "jax" / name)))
    metrics = json.loads((tmp_path / "port" / "metrics.json").read_text())["nuc"]
    assert {"instance_f1", "ap"} <= metrics.keys() and metrics == res["metrics"]["nuc"]
