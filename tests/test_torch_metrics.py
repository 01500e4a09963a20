"""The port's binary metrics and evaluation stage against the JAX package's."""

import numpy as np
import pytest

from pytorch_connectomics_tpu.config.schema import EvaluationConfig as JaxEvaluationConfig
from pytorch_connectomics_tpu.evaluation.stage import compute_test_metrics as jax_compute_test_metrics
from pytorch_connectomics_tpu.metrics import binary as jb
from pytorch_connectomics_tpu_torch.config.schema import EvaluationConfig
from pytorch_connectomics_tpu_torch.evaluation.stage import compute_test_metrics, run_evaluation_stage
from pytorch_connectomics_tpu_torch.metrics import binary as tb


@pytest.mark.parametrize("fn", ["jaccard_index", "dice_coefficient", "binary_accuracy"])
@pytest.mark.parametrize("from_logits", [True, False])
def test_binary_metrics_match_jax(fn, from_logits):
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((6, 7, 8)).astype(np.float32) * (1 if from_logits else 0.3) + (0 if from_logits else 0.5)
    target = (rng.random((6, 7, 8)) > 0.6).astype(np.float32)
    got = getattr(tb, fn)(pred, target, from_logits=from_logits)
    want = getattr(jb, fn)(pred, target, from_logits=from_logits)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=1e-6)


@pytest.mark.parametrize("layout", ["zyxc", "czyx"])
def test_evaluation_stage_matches_jax(layout, tmp_path):
    rng = np.random.default_rng(1)
    prob = rng.random((5, 6, 7, 1)).astype(np.float32)
    if layout == "czyx":
        prob = np.moveaxis(prob, -1, 0)
    gt = (rng.random((5, 6, 7)) > 0.5).astype(np.uint8) * 3
    metrics = ["jaccard", "dice", "accuracy"]
    got = compute_test_metrics(prob, None, gt, metrics)
    want = jax_compute_test_metrics(prob, None, gt, metrics)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    res = run_evaluation_stage(prob, None, gt, EvaluationConfig(enabled=True, metrics=metrics), tmp_path, "vol")
    assert res == got and (tmp_path / "metrics.json").exists() and (tmp_path / "vol_metrics.txt").exists()
    assert JaxEvaluationConfig().enabled == EvaluationConfig().enabled
