"""The RSUNet recipes through the port's CLI on the CPU at tiny widths and
volumes: ``tutorials/neuron_snemi.yaml`` train -> test (flip TTA over the
nine affinity channels, min ensemble, waterz, adapted Rand and VOI) -> tune
-> tune-test; its test leg against the JAX package's test pipeline on the
same flax weights; and the train legs of ``tutorials/nuc_nucmm.yaml`` (bcd
targets, ``pos_weight: auto``, tanh MSE) and
``tutorials/neuron_snemi_efficient.yaml``. The volumes are seeded
``synthetic://instance`` (SNEMI) and ``synthetic://em2`` with
connected-component labels (NucMM-Z)."""

import json

import jax
import numpy as np
import pytest
import torch
import yaml

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.data.io import read_volume as jax_read_volume
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.models.build import init_model as jax_init
from pytorch_connectomics_tpu.runtime.test_pipeline import run_test_pipeline as jax_run_test_pipeline
from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.models.convert import flatten_flax
from pytorch_connectomics_tpu_torch.runtime.cli import main

SNEMI = "tutorials/neuron_snemi.yaml"
EFFICIENT = "tutorials/neuron_snemi_efficient.yaml"
NUCMM = "tutorials/nuc_nucmm.yaml"
TINY_SNEMI = [
    "model.rsunet.width=[8,12,16]",
    "model.rsunet.down_factors=[[1,2,2],[1,2,2]]",
    "optimization.precision=32",
    "model.input_size=[8,32,32]",
    "inference.window.window_size=[8,32,32]",
    "inference.window.sw_batch_size=4",
]
TRAIN = ["data.dataloader.batch_size=2", "optimization.n_steps_per_epoch=2", "optimization.max_epochs=1"]
VOL = "data.{}.{}=synthetic://instance/{}_{}?shape={}&seed={}"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch operations: one intra-op thread under the parallel
    test run, as the other CLI-leg tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vol(split, tag, shape, seed):
    return [VOL.format(split, "image", tag, "image", shape, seed), VOL.format(split, "label", tag, "label", shape, seed)]


def _losses(run):
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return [r["train_loss_total"] for r in rows if "train_loss_total" in r]


def test_cli_snemi_train_test_tune_tune_test(tmp_path):
    """The SNEMI recipe's four legs as shipped apart from widths, sizes and
    steps: train (2 steps; aff9 with erosion, per-channel BCE with auto pos
    weight, aug_em_neuron); test with flip TTA xy (4 variants, affinity
    realignment, min ensemble), waterz, adapted Rand and VOI; tune (3 TPE
    trials, adapted Rand) on volume A; tune-test with the study on volume B."""
    common = ["--device", "cpu", *TINY_SNEMI, f"save_path={tmp_path}"]
    train = main(["--config", SNEMI, "--mode", "train", *common, *TRAIN, "data.dataloader.patch_size=[8,32,32]",
                  *_vol("train", "t", "16,48,48", 21)])
    run = tmp_path / train["run_dir"].split("/")[-1]
    assert (run / "checkpoints" / "last").is_dir()
    losses = _losses(run)
    assert losses and all(np.isfinite(v) for v in losses)
    test = main(["--config", SNEMI, "--mode", "test", *common, *_vol("test", "b", "12,40,40", 23)])
    assert test["restored"]["step"] == 2
    scores = test["metrics"]["synthetic"]
    assert {"adapted_rand", "voi", "voi_split", "voi_merge"} <= set(scores)
    assert all(np.isfinite(v) for v in scores.values())
    pred = read_volume(str(run / "test" / "synthetic_last_tta_x4_prediction.h5"))
    assert pred.shape == (9, 12, 40, 40) and 0 <= pred.min() <= pred.max() <= 1
    tune = main(["--config", SNEMI, "--mode", "tune", "--tune-trials", "3", *common, *_vol("test", "a", "12,40,40", 22)])
    study = yaml.safe_load(open(tune["best_params"]).read())
    assert study["n_trials"] == 3 and study["metric"] == "adapted_rand" and len(study["trials"]) == 3
    assert set(study["best_params"]) == {"steps.0.kwargs.threshold"}
    res = main(["--config", SNEMI, "--mode", "tune-test", "--params", tune["best_params"], *common,
                *_vol("test", "b", "12,40,40", 23)])
    assert res["run_dir"] == str(run / "tune-test")
    assert {"adapted_rand", "voi"} <= set(res["metrics"]["synthetic"])


def test_cli_snemi_test_leg_matches_jax_pipeline(tmp_path):
    """``--mode test`` of the SNEMI recipe (tiny f32 RSUNet, flip TTA xy over
    nine affinity channels with the realignment, min ensemble, sigmoid)
    against the JAX package's test pipeline on the same flax weights and
    volume: the ensembled prediction within 1e-4 (sums in another order,
    through GroupNorm's fast variance as in the NucMM-Z test) under the
    same name."""
    image, label = tmp_path / "snemi_im.npy", tmp_path / "snemi_label.npy"
    np.save(image, read_volume("synthetic://instance/im?shape=12,40,40&seed=31"))
    np.save(label, read_volume("synthetic://instance/lb?shape=12,40,40&seed=31"))
    over = TINY_SNEMI + [f"data.test.image={image}", f"data.test.label={label}", "decoding.enabled=false",
                         "evaluation.enabled=false"]
    cfg = jax_load_config(SNEMI, overrides=over, mode="test")
    model = jax_build(cfg.model)
    params = jax.tree.map(np.asarray, jax_init(model, cfg.model, jax.random.PRNGKey(0)))["params"]
    ckpt = tmp_path / "weights.npz"
    np.savez(ckpt, **flatten_flax(params))
    jax_run_test_pipeline(cfg, model, params, tmp_path / "jax", checkpoint=str(ckpt))
    main(["--config", SNEMI, "--mode", "test", "--device", "cpu", "--checkpoint", str(ckpt),
          "--output-dir", str(tmp_path / "port"), *over])
    name = "snemi_weights_tta_x4_prediction.h5"
    got, want = read_volume(str(tmp_path / "port" / name)), jax_read_volume(str(tmp_path / "jax" / name))
    assert got.shape == want.shape == (9, 12, 40, 40)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_cli_nucmm_train(tmp_path):
    """The NucMM-Z train leg (bcd targets: binary, 2-D instance boundary and
    EDT; loss_bcd with ``pos_weight: auto`` and tanh MSE) for 2 steps on a
    seeded em2 volume with connected-component labels: finite losses of
    every term, a checkpoint."""
    from scipy import ndimage

    image, label = tmp_path / "nuc_im.npy", tmp_path / "nuc_label.npy"
    np.save(image, read_volume("synthetic://em2/nuc_image?shape=24,48,48"))
    np.save(label, ndimage.label(read_volume("synthetic://em2/nuc_label?shape=24,48,48") > 0)[0].astype(np.uint32))
    res = main(["--config", NUCMM, "--mode", "train", "--device", "cpu", "model.rsunet.width=[8,12]",
                "optimization.precision=32", "model.input_size=[16,16,16]", "data.dataloader.patch_size=[16,16,16]",
                *TRAIN, f"data.train.image={image}", f"data.train.label={label}", f"save_path={tmp_path}"])
    run = tmp_path / res["run_dir"].split("/")[-1]
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    terms = [k for r in rows for k in r if k.startswith("train_loss_")]
    assert {"train_loss_WeightedBCEWithLogitsLoss_2", "train_loss_WeightedMSELoss_4", "train_loss_total"} <= set(terms)
    assert all(np.isfinite(r[k]) for r in rows for k in terms if k in r)
    assert (run / "checkpoints" / "last").is_dir()


def test_cli_snemi_efficient_train(tmp_path):
    """The throughput-first SNEMI recipe (aug_light, batch 16 cut to 2)
    trains for 2 steps with finite losses."""
    res = main(["--config", EFFICIENT, "--mode", "train", "--device", "cpu", "model.rsunet.width=[8,12]",
                "model.rsunet.down_factors=[[1,2,2]]", "optimization.precision=32", "model.input_size=[8,32,32]",
                "data.dataloader.patch_size=[8,32,32]", *TRAIN, *_vol("train", "t", "16,48,48", 24),
                f"save_path={tmp_path}"])
    run = tmp_path / res["run_dir"].split("/")[-1]
    losses = _losses(run)
    assert losses and all(np.isfinite(v) for v in losses)
