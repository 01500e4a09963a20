"""NERL in the port against the JAX package on the same seeded labels: the
skeletons of every instance (native TEASAR and the MST approximation:
equal nodes and edges), ERL / NERL and the skeleton VOI (f64, rtol
1e-12), the evaluation report's ``nerl``/``erl`` with ``cfg.nerl``'s
anisotropy, and the raise for a metric the port does not know. The
tuner's ``nerl`` is held to the JAX package's in ``test_torch_tuning.py``."""

import numpy as np
import pytest
from scipy import ndimage

from pytorch_connectomics_tpu.evaluation.stage import compute_test_metrics as jax_compute_test_metrics
from pytorch_connectomics_tpu.metrics import nerl as jnerl
from pytorch_connectomics_tpu.metrics import skeleton as jskel
from pytorch_connectomics_tpu.ops import native as jnative
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
from pytorch_connectomics_tpu_torch.evaluation.stage import compute_test_metrics, run_evaluation_stage
from pytorch_connectomics_tpu_torch.metrics import compute_nerl, expected_run_length, skeleton_voi, skeletonize_volume
from pytorch_connectomics_tpu_torch.metrics import skeleton as pskel

NISB = "tutorials/neuron_nisb.yaml"


@pytest.fixture(scope="module")
def gt():
    """A synthetic://instance ground truth (elongated neurites) with a
    background margin and sparse ids."""
    _, lbl = synthetic_em_task("instance", (20, 56, 56), seed=3)
    lbl = lbl.copy()
    lbl[:, :4] = 0
    return np.where(lbl > 0, lbl * 1000 + 7, 0).astype(np.uint32)


def segmentation(gt, seed):
    """``gt`` with some instances cut in two along z, two pairs merged and
    the borders of the rest eroded into background."""
    rng = np.random.default_rng(seed)
    seg = gt.astype(np.uint64).copy()
    ids = np.unique(gt[gt > 0])
    for i in rng.choice(ids, 3, replace=False):
        cut = (gt == i) & (np.arange(gt.shape[0])[:, None, None] >= gt.shape[0] // 2)
        seg[cut] = i + 1
    a, b, c, d = rng.choice(ids, 4, replace=False)
    seg[gt == b], seg[gt == d] = a, c
    seg[~ndimage.binary_erosion(gt > 0)] = 0
    return seg.astype(np.uint32)


def test_the_jax_reference_runs_the_native_teasar():
    assert jnative.get_lib() is not None  # else the JAX package's teasar would fall back to MST


@pytest.mark.parametrize("method", ["teasar", "mst"])
def test_skeletons_match_jax(gt, method):
    got = skeletonize_volume(gt, method=method, anisotropy=(2.0, 1.0, 1.0))
    want = jskel.skeletonize_volume(gt, method=method, anisotropy=(2.0, 1.0, 1.0))
    assert list(got) == list(want) and len(got) >= 8
    for i in got:
        assert np.array_equal(got[i].nodes, want[i].nodes) and np.array_equal(got[i].edges, want[i].edges)
        assert got[i].total_length == want[i].total_length > 0
    one = pskel.skeletonize_instance(gt == list(got)[0], method=method)
    jone = jskel.skeletonize_instance(gt == list(got)[0], method=method)
    assert np.array_equal(one.nodes, jone.nodes) and np.array_equal(one.edges, jone.edges)
    assert pskel.skeletonize_instance(np.zeros((3, 4, 5), bool), method=method) is None


def test_skeleton_method_is_explicit():
    with pytest.raises(ValueError, match="method"):
        pskel.skeletonize_instance(np.ones((3, 4, 5), bool), method="kimimaro")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nerl_and_skeleton_voi_match_jax(gt, seed):
    seg = segmentation(gt, seed)
    got, want = compute_nerl(seg, gt), jnerl.compute_nerl(seg, gt)
    assert set(got) == set(want) == {"erl", "max_erl", "nerl"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    assert 0 < got["nerl"] < 1
    assert compute_nerl(gt, gt)["nerl"] == pytest.approx(1.0, abs=1e-12)
    sk = jskel.skeletonize_volume(gt)
    for merge_penalty in (True, False):
        np.testing.assert_allclose(expected_run_length(seg, sk, merge_penalty),
                                   jnerl.expected_run_length(seg, sk, merge_penalty), rtol=1e-12)
    np.testing.assert_allclose(skeleton_voi(seg, sk), jnerl.skeleton_voi(seg, sk), rtol=1e-12)
    assert skeleton_voi(seg, {}) == (0.0, 0.0) and expected_run_length(seg, {}) == (0.0, 0.0)
    with pytest.raises(ValueError, match="gt"):
        compute_nerl(seg)


def test_evaluation_reports_nerl_and_erl_as_jax(gt, tmp_path):
    """Fault C.7: the port's report held no ``nerl``/``erl``."""
    seg = segmentation(gt, 4)
    metrics = ["nerl", "voi", "adapted_rand"]
    for nerl_cfg in (None, {"anisotropy": [2.0, 1.0, 1.0]}):
        got = compute_test_metrics(None, seg, gt, metrics, nerl_cfg)
        want = jax_compute_test_metrics(None, seg, gt, metrics, nerl_cfg)
        assert set(got) == set(want) >= {"nerl", "erl", "voi"}
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    cfg = load_config(NISB, mode="test").evaluation
    assert cfg.metrics == ["nerl", "voi"]
    report = run_evaluation_stage(None, seg, gt, cfg, tmp_path, "b")
    assert {"nerl", "erl", "voi"} <= set(report) and "nerl: " in (tmp_path / "b_metrics.txt").read_text()


@pytest.mark.parametrize("metric", ["tube_length", "skeleton_f1"])
def test_evaluation_raises_for_a_metric_it_does_not_know(gt, metric):
    with pytest.raises(NotImplementedError, match=metric):
        compute_test_metrics(None, gt, gt, ["voi", metric])
