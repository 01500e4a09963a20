"""A tiny CLI drive of ``tutorials/neuron_nisb.yaml`` on the CPU: a narrow
MedNeXt on small ``synthetic://instance`` volumes, train (3 steps) -> tune
on ``nerl`` (3 trials, chunked prediction of volume A) -> tune-test on
volume B chunk by chunk (several chunks an axis, edge chunks cut), with
``affinity_cc`` and ``min_instance_size`` post-processing, NERL, ERL and
VOI in the report; a second tune-test run on a prediction stamped
incomplete resumes and recomputes no chunk, and the
chunked test leg's prediction matches the JAX package's test pipeline on
the same weights."""

import logging

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
from pytorch_connectomics_tpu_torch.inference.output import stamp_prediction_checkpoint
from pytorch_connectomics_tpu_torch.models.convert import flatten_flax
from pytorch_connectomics_tpu_torch.runtime.cli import main

NISB = "tutorials/neuron_nisb.yaml"
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "optimization.precision=32",
    "model.input_size=[16,16,16]",
    "inference.window.window_size=[16,16,16]",
    "inference.window.sw_batch_size=4",
    "inference.chunked.chunk_size=[16,24,24]",
    "inference.chunked.halo=[2,4,4]",
]
VOL = "data.{}.{}=synthetic://instance/{}_{}?shape={}&seed={}"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch operations: one intra-op thread, as the other CLI
    tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Chunks(logging.Handler):
    """The chunked runs' summaries (chunks computed, chunks in the grid)."""

    def __init__(self):
        super().__init__()
        self.runs = []

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("chunked: "):
            self.runs.append(record.args[:2])


def test_cli_train_tune_on_nerl_chunked_tune_test(tmp_path):
    common = ["--device", "cpu", *TINY, f"save_path={tmp_path}"]
    train = main(["--config", NISB, "--mode", "train", *common, "data.dataloader.batch_size=2",
                  "data.dataloader.patch_size=[16,16,16]", "optimization.n_steps_per_epoch=3",
                  "optimization.max_epochs=1", VOL.format("train", "image", "t", "image", "16,40,40", 21),
                  VOL.format("train", "label", "t", "label", "16,40,40", 21)])
    run = tmp_path / train["run_dir"].split("/")[-1]
    assert (run / "checkpoints" / "last").is_dir()
    chunks = Chunks()
    port_log = logging.getLogger("pytorch_connectomics_tpu_torch")
    level = port_log.level
    port_log.addHandler(chunks)
    port_log.setLevel(logging.INFO)
    try:
        vol_a = [VOL.format("test", k, "a", k, "16,40,40", 22) for k in ("image", "label")]
        tune = main(["--config", NISB, "--mode", "tune", "--tune-trials", "3", *common, *vol_a])
        study = yaml.safe_load(open(tune["best_params"]).read())
        assert study["metric"] == "nerl" and study["direction"] == "maximize" and len(study["trials"]) == 3
        assert set(study["best_params"]) == {"steps.0.kwargs.threshold"}
        assert all(0 <= t["value"] <= 1 for t in study["trials"])
        assert chunks.runs == [(4, 4)]  # 1 x 2 x 2 chunks over 16 x 40 x 40
        vol_b = [VOL.format("test", k, "b", k, "20,52,44", 23) for k in ("image", "label")]
        legs = []
        for _ in range(2):
            legs.append(main(["--config", NISB, "--mode", "tune-test", "--params", tune["best_params"], *common,
                              *vol_b]))
            # as if the run had stopped before its final stamp: the next one
            # resumes through the manifest instead of taking the cache
            stamp_prediction_checkpoint(run / "tune-test" / "synthetic_last_prediction.h5", "__incomplete__")
    finally:
        port_log.removeHandler(chunks)
        port_log.setLevel(level)
    # B: 2 x 3 x 2 chunks, every axis with a cut edge chunk; the second run resumes all of them
    assert chunks.runs[1:] == [(12, 12), (0, 12)]
    for res in legs:
        scores = res["metrics"]["synthetic"]
        assert {"nerl", "erl", "voi", "voi_split", "voi_merge"} <= set(scores)
        assert 0 <= scores["nerl"] <= 1 and all(np.isfinite(v) for v in scores.values())
    assert legs[0]["metrics"] == legs[1]["metrics"]
    pred = read_volume(str(run / "tune-test" / "synthetic_last_prediction.h5"))
    assert pred.shape == (3, 20, 52, 44) and 0 <= pred.min() <= pred.max() <= 1
    decoded = read_volume(str(next((run / "tune-test").glob("synthetic_last_decoded_affinity_cc_*.h5"))))
    sizes = np.bincount(decoded.ravel())[1:]
    assert decoded.shape == (20, 52, 44) and (sizes[sizes > 0] >= 200).all()  # min_instance_size


def test_chunked_test_leg_matches_jax_pipeline(tmp_path):
    """``--mode test`` with chunked inference against the JAX package's
    test pipeline on the same flax weights and volume: the chunk-by-chunk
    prediction within 1e-4 (f32 sums in another order, through GroupNorm's
    fast variance, as in the SNEMI test leg's comparison) under the same
    name."""
    image = tmp_path / "nisb_im.npy"
    np.save(image, read_volume("synthetic://instance/im?shape=16,48,44&seed=31"))
    over = TINY + [f"data.test.image={image}", "decoding.enabled=false", "evaluation.enabled=false"]
    cfg = jax_load_config(NISB, overrides=over, mode="test")
    model = jax_build(cfg.model)
    params = jax.tree.map(np.asarray, jax_init(model, cfg.model, jax.random.PRNGKey(0)))["params"]
    ckpt = tmp_path / "weights.npz"
    np.savez(ckpt, **flatten_flax(params))
    jax_run_test_pipeline(cfg, model, params, tmp_path / "jax", checkpoint=str(ckpt))
    main(["--config", NISB, "--mode", "test", "--device", "cpu", "--checkpoint", str(ckpt), "--output-dir",
          str(tmp_path / "port"), *over])
    name = "nisb_weights_prediction.h5"
    got, want = read_volume(str(tmp_path / "port" / name)), jax_read_volume(str(tmp_path / "jax" / name))
    assert got.shape == want.shape == (3, 16, 48, 44)
    np.testing.assert_allclose(got, want, atol=1e-4)
