"""The port's decode tuning against the JAX package on the CPU: the tuner
(every sampler, the median and Hyperband pruners, a multi-metric study, the
per-trial timeout), ``run_tuning`` and ``apply_best_params`` on one saved prediction,
the tuned-params names, and a tiny CLI drive of
``tutorials/synthetic_instance_tune_tpu.yaml``: train -> tune -> tune-test
with ``--best-params``."""

import time

import numpy as np
import pytest
import torch
import yaml
from scipy import ndimage

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.config.loader import config_hash as jax_config_hash
from pytorch_connectomics_tpu.config.schema import TuningConfig as JaxTuningConfig
from pytorch_connectomics_tpu.config.schema import build_dataclass as jax_build_dataclass
from pytorch_connectomics_tpu.config.schema import to_dict as jax_to_dict
from pytorch_connectomics_tpu.decoding.tuning import DecodingTuner as JaxDecodingTuner
from pytorch_connectomics_tpu.decoding.tuning import compute_segmentation_metric as jax_segmentation_metric
from pytorch_connectomics_tpu.inference.output import save_prediction as jax_save_prediction
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.runtime import output_naming as jnaming
from pytorch_connectomics_tpu.runtime.tune_runner import apply_best_params as jax_apply_best_params
from pytorch_connectomics_tpu.runtime.tune_runner import run_tuning as jax_run_tuning
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.config.schema import TuningConfig, build_dataclass, to_dict
from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
from pytorch_connectomics_tpu_torch.decoding.tuning import DecodingTuner, compute_segmentation_metric
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.runtime import output_naming as pnaming
from pytorch_connectomics_tpu_torch.runtime.cli import main
from pytorch_connectomics_tpu_torch.runtime.tune_runner import apply_best_params, run_tuning

TUNE = "tutorials/synthetic_instance_tune_tpu.yaml"
PARAMS = [
    {"name": "a", "low": 0.1, "high": 0.9},
    {"name": "b", "type": "int", "low": 0, "high": 200, "step": 20},
    {"name": "c", "low": 1e-3, "high": 1.0, "log": True},
    {"name": "d", "type": "categorical", "choices": ["x", "y", "z"]},
]
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


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small torch operations; under the parallel test
    run (several workers of one thread per core each) torch's spinning
    intra-op threads made them about 25x slower, so they run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _score(params):
    """A deterministic objective with a minimum inside the space."""
    bonus = {"x": 0.0, "y": 0.3, "z": 0.1}[params["d"]]
    return (params["a"] - 0.6) ** 2 + (params["b"] - 80) ** 2 / 1e4 + abs(np.log10(params["c"]) + 1) + bonus


def objective(params, report=None):
    """Three intermediate reports of a running value, then the score."""
    v = _score(params)
    if report is not None:
        for k in range(3):
            report(k, v * (1.0 + 0.1 * (2 - k)))
    return v


def multi_objective(params):
    return [_score(params), (params["a"] - 0.2) ** 2 + params["b"] / 400.0]


def _tuners(**cfg):
    d = {"params": PARAMS, "seed": 7, **cfg}
    return build_dataclass(TuningConfig, d), jax_build_dataclass(JaxTuningConfig, d)


def _trials(tuner):
    return [(t.number, t.params, t.value, t.values, t.state) for t in tuner.trials]


@pytest.mark.parametrize("sampler, n", [("tpe", 14), ("random", 10), ("grid", 40), ("cmaes", 18)])
@pytest.mark.parametrize("pruner", [None, "median", "hyperband"], ids=["nopruner", "median", "hyperband"])
def test_tuner_proposes_jax_trial_sequence(tmp_path, sampler, n, pruner):
    """One seed gives JAX's trials (params, values, pruned states), best
    params and study YAML, for each sampler without a pruner, with the
    median pruner and with the Hyperband pruner."""
    ours_cfg, ref_cfg = _tuners(sampler=sampler, n_trials=n, pruner=pruner, direction="minimize", metric="voi")
    ours, ref = DecodingTuner(ours_cfg, objective), JaxDecodingTuner(ref_cfg, objective)
    best, want = ours.optimize(), ref.optimize()
    assert _trials(ours) == _trials(ref)
    assert len(ours.trials) == n and best.params == want.params
    if pruner:
        assert "pruned" in {t.state for t in ours.trials}
    got_yaml = ours.save_study(tmp_path / "ours.yaml").read_text()
    assert got_yaml == ref.save_study(tmp_path / "ref.yaml").read_text()


def test_multi_metric_study_matches_jax(tmp_path):
    """Two metrics: the TPE surrogate over the Pareto rank, the front and
    the YAML's multi-objective keys are JAX's."""
    ours_cfg, ref_cfg = _tuners(sampler="tpe", n_trials=14, metrics=["voi", "adapted_rand"],
                                directions=["minimize", "minimize"])
    ours, ref = DecodingTuner(ours_cfg, multi_objective), JaxDecodingTuner(ref_cfg, multi_objective)
    assert ours.optimize().params == ref.optimize().params
    assert _trials(ours) == _trials(ref)
    assert [t.number for t in ours.best_trials] == [t.number for t in ref.best_trials]
    assert len(ours.best_trials) > 1
    got = yaml.safe_load(ours.save_study(tmp_path / "ours.yaml").read_text())
    assert got == yaml.safe_load(ref.save_study(tmp_path / "ref.yaml").read_text())
    assert {"pareto_front", "best_values", "metrics", "directions"} <= set(got)


def _slow_on_high_b(params):
    if params["b"] >= 160:
        time.sleep(30)
    return _score(params)


def test_trial_timeout_fires_in_a_forked_process():
    """With ``timeout_per_trial`` each trial runs in a forked child: fast
    trials return their values unchanged, a trial past the limit is cut at
    the limit and recorded as failed, and the study goes on."""
    cfg, _ = _tuners(sampler="random", n_trials=8, timeout_per_trial=1.0)
    plain, _ = _tuners(sampler="random", n_trials=8)
    t0 = time.monotonic()
    tuner = DecodingTuner(cfg, _slow_on_high_b)
    tuner.optimize()
    took = time.monotonic() - t0
    ref = DecodingTuner(plain, _score)
    ref.optimize()
    slow = [t for t in ref.trials if t.params["b"] >= 160]
    assert slow and len(slow) < len(ref.trials)
    assert took < 2.0 * len(slow) + 10
    for got, want in zip(tuner.trials, ref.trials):
        assert got.params == want.params
        if want.params["b"] >= 160:
            assert got.state == "failed" and got.value == float("inf") and 0.9 < got.duration < 5
        else:
            assert got.state == "complete" and got.value == want.value


def test_nerl_metric_is_not_ported():
    """The tuner's ``nerl`` (``neuron_nisb.yaml`` tunes on it, maximised)
    against the JAX package's on a synthetic://instance ground truth and
    its eroded, partly merged segmentation; the name is kept from when the
    metric raised."""
    _, gt = synthetic_em_task("instance", (16, 48, 48), seed=3)
    seg = np.where(ndimage.binary_erosion(gt > 0), gt, 0).astype(np.uint32)
    ids = np.unique(gt)
    seg[gt == ids[2]] = ids[1]
    got, want = compute_segmentation_metric("nerl", seg, gt), jax_segmentation_metric("nerl", seg, gt)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert 0 < got < 1 and compute_segmentation_metric("nerl", gt, gt) == pytest.approx(1.0, abs=1e-12)
    tuning = load_config("tutorials/neuron_nisb.yaml", mode="tune").decoding.tuning
    assert tuning.metric == "nerl" and tuning.direction == "maximize"
    assert compute_segmentation_metric("voi", gt, gt) == 0.0


def test_tuned_params_names_match_jax():
    for tag, ckpt in (("scratch", None), ("last_tta_x4", "run/checkpoints/last"), ("best", "best")):
        assert pnaming.tuned_params_filename(tag) == jnaming.tuned_params_filename(tag)
        assert pnaming.tuned_params_candidates(tag, ckpt) == jnaming.tuned_params_candidates(tag, ckpt)


# ---------------------------------------------------------------------------
# run_tuning / apply_best_params on one saved prediction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [False, True], ids=["per-trial", "batch-thresholds"])
def test_run_tuning_matches_jax_on_a_saved_prediction(tmp_path, batch):
    """The port predicts tune volume A with a tiny seeded model and tunes
    waterz on it; the JAX package tunes on the same prediction (saved into
    its run dir as a cache hit). Same trials, best params, YAML and patched
    decoding config."""
    img, lbl = synthetic_em_task("instance", (16, 40, 36), seed=22)
    np.save(tmp_path / "volA_im.npy", img)
    np.save(tmp_path / "volA_lb.npy", lbl)
    over = TINY + [f"data.test.image={tmp_path / 'volA_im.npy'}", f"data.test.label={tmp_path / 'volA_lb.npy'}",
                   "decoding.tuning.n_trials=10"]
    if batch:
        over.append("decoding.tuning.batch_thresholds=[0.3,0.5,0.7]")
    cfg, jcfg = load_config(TUNE, overrides=over, mode="tune"), jax_load_config(TUNE, overrides=over, mode="tune")
    model = build_model(cfg.model, device="cpu", seed=0)
    study = run_tuning(cfg, model, tmp_path / "port", device="cpu")
    assert study.name == "scratch_best_params.yaml"
    pred = read_volume(str(tmp_path / "port" / "volA_scratch_prediction.h5"))
    assert pred.shape == (3, 16, 40, 36) and 0 <= pred.min() <= pred.max() <= 1
    jax_save_prediction(tmp_path / "jax" / "volA_scratch_prediction.h5", pred, jax_config_hash(jcfg), "", "scratch")
    jstudy = jax_run_tuning(jcfg, jax_build(jcfg.model), None, tmp_path / "jax")
    got, want = yaml.safe_load(study.read_text()), yaml.safe_load(jstudy.read_text())
    assert got["best_params"] == want["best_params"]
    assert [t["params"] for t in got["trials"]] == [t["params"] for t in want["trials"]]
    np.testing.assert_allclose([t["value"] for t in got["trials"]], [t["value"] for t in want["trials"]],
                               rtol=1e-12)
    if batch:
        assert "steps.0.kwargs.threshold" in got["best_params"]
        assert got["best_user_attrs"]["best_threshold"] == want["best_user_attrs"]["best_threshold"]
    patched, jpatched = apply_best_params(cfg, study), jax_apply_best_params(jcfg, jstudy)
    assert to_dict(patched.decoding) == jax_to_dict(jpatched.decoding)
    kwargs = patched.decoding.steps[0].kwargs
    assert all(kwargs[k.split(".")[-1]] == v for k, v in got["best_params"].items())


# ---------------------------------------------------------------------------
# the three CLI legs
# ---------------------------------------------------------------------------


def test_cli_train_tune_tune_test(tmp_path):
    """train (3 steps) -> tune on volume A (3 trials, the train leg's
    checkpoint auto-resolved) -> tune-test with ``--best-params`` on
    volume B: the files each leg writes and the metric keys."""
    common = ["--device", "cpu"]
    over = TINY + [f"save_path={tmp_path}"]
    vol = "data.{}.{}=synthetic://instance/{}_{}?shape=16,40,36&seed={}"
    train = main(["--config", TUNE, "--mode", "train", *common, *over, "data.dataloader.batch_size=2",
                  "data.dataloader.patch_size=[16,16,16]", "optimization.n_steps_per_epoch=3",
                  "optimization.max_epochs=1", vol.format("train", "image", "t", "image", 21),
                  vol.format("train", "label", "t", "label", 21)])
    run = tmp_path / train["run_dir"].split("/")[-1]
    assert (run / "checkpoints" / "last").is_dir() and (run / "metrics.jsonl").exists()
    vol_a = [vol.format("test", "image", "a", "image", 22), vol.format("test", "label", "a", "label", 22)]
    tune = main(["--config", TUNE, "--mode", "tune", "--tune-trials", "3", *common, *over, *vol_a])
    assert tune["run_dir"] == str(run / "tune") and tune["restored"]["step"] == 3
    study = yaml.safe_load(open(tune["best_params"]).read())
    assert tune["best_params"] == str(run / "tune" / "last_best_params.yaml")
    assert study["n_trials"] == 3 and study["metric"] == "voi" and len(study["trials"]) == 3
    assert set(study["best_params"]) == {f"steps.0.kwargs.{k}" for k in ("threshold", "fragment_threshold",
                                                                          "min_size")}
    assert (run / "tune" / "synthetic_last_prediction.h5").exists()
    vol_b = [vol.format("test", "image", "b", "image", 23), vol.format("test", "label", "b", "label", 23)]
    res = main(["--config", TUNE, "--mode", "tune-test", "--params", tune["best_params"], *common, *over, *vol_b])
    assert res["best_params"] == tune["best_params"] and res["run_dir"] == str(run / "tune-test")
    scores = res["metrics"]["synthetic"]
    assert {"adapted_rand", "voi", "voi_split", "voi_merge"} <= set(scores)
    assert all(np.isfinite(v) for v in scores.values())
    kw = study["best_params"]
    decoded = list((run / "tune-test").glob("synthetic_last_decoded_waterz_*.h5"))
    assert len(decoded) == 1 and f"{kw['steps.0.kwargs.min_size']}" in decoded[0].name
    assert (run / "tune-test" / "metrics.json").exists()


def test_cli_tune_test_tunes_first_without_best_params(tmp_path):
    """``--mode tune-test`` without ``--best-params`` tunes on the test
    volume first (an untrained model here: no checkpoint under save_path),
    then tests with the study it wrote."""
    vol = [f"data.test.{k}=synthetic://instance/a_{k}?shape=16,40,36&seed=22" for k in ("image", "label")]
    res = main(["--config", TUNE, "--mode", "tune-test", "--tune-trials", "2", "--device", "cpu", *TINY,
                f"save_path={tmp_path}", *vol])
    assert res["run_dir"] == str(tmp_path / "tune-test") and "restored" not in res
    assert res["best_params"] == str(tmp_path / "tune-test" / "scratch_best_params.yaml")
    study = yaml.safe_load(open(res["best_params"]).read())
    assert study["n_trials"] == 2
    assert {"adapted_rand", "voi"} <= set(res["metrics"]["synthetic"])
