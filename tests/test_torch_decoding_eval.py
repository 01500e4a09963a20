"""The port's evaluation additions against the JAX package's on the same
seeded labels: the tube QC and its summary, skeleton-mask and curvilinear
metrics, the oracle metrics, error analysis, the report files (metrics
text and JSON, tube npz, the summary over volumes), the evaluation stage's
``tube`` metric, the experiment log, the prediction cache's rules and the
prediction crops. Floats within 1e-6 relative, files byte for byte."""

from types import SimpleNamespace

import numpy as np
import pytest
from scipy import ndimage

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.decoding.experiment_log import ExperimentLog as JaxExperimentLog
from pytorch_connectomics_tpu.evaluation import error_analysis as jea
from pytorch_connectomics_tpu.evaluation import report as jrep
from pytorch_connectomics_tpu.evaluation.stage import run_evaluation_stage as jax_run_evaluation_stage
from pytorch_connectomics_tpu.inference import output as jout
from pytorch_connectomics_tpu.inference import prediction_crops as jcrops
from pytorch_connectomics_tpu.metrics import oracle as jor
from pytorch_connectomics_tpu.metrics import tube as jtube
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.decoding.experiment_log import ExperimentLog
from pytorch_connectomics_tpu_torch.evaluation import error_analysis as pea
from pytorch_connectomics_tpu_torch.evaluation import report as prep
from pytorch_connectomics_tpu_torch.evaluation.stage import run_evaluation_stage
from pytorch_connectomics_tpu_torch.inference import output as pout
from pytorch_connectomics_tpu_torch.inference import prediction_crops as pcrops
from pytorch_connectomics_tpu_torch.metrics import oracle as por
from pytorch_connectomics_tpu_torch.metrics import tube as ptube

TUBE = "tutorials/tube_analysis.yaml"


def _smooth(rng, shape, sigma):
    f = ndimage.gaussian_filter(rng.standard_normal(shape), sigma)
    return (f - f.mean()) / f.std()


def label_pair(seed=0, shape=(20, 48, 48)):
    """(seg, gt): gt the components of a smooth field, seg those of the
    field shifted and cut at another level, some ids merged."""
    rng = np.random.default_rng(seed)
    f = _smooth(rng, shape, 1.5)
    gt = ndimage.label(f > 0.9)[0].astype(np.uint32)
    seg = ndimage.label(np.roll(f, 1, axis=2) > 0.7)[0]
    return np.where(seg % 5 == 2, seg + 1, seg).astype(np.uint32), gt


def tubes(seed=0, shape=(24, 40, 40)):
    """Tube labels: drifting disks, some short, some touching the border,
    one with a bump and one with two components in a few sections."""
    rng = np.random.default_rng(seed)
    lab = np.zeros(shape, np.uint32)
    yy, xx = np.mgrid[:shape[1], :shape[2]]
    for t in range(1, 8):
        cy, cx, r = rng.uniform(2, shape[1] - 2), rng.uniform(2, shape[2] - 2), rng.uniform(1.5, 4)
        z0 = int(rng.integers(0, shape[0] - 3))
        z1 = min(shape[0], z0 + int(rng.integers(2, 20)))
        for z in range(z0, z1):
            rr = r * (2.2 if t == 3 and z == (z0 + z1) // 2 else 1)
            lab[z][((yy - cy - 0.3 * (z - z0)) ** 2 + (xx - cx) ** 2 <= rr * rr) & (lab[z] == 0)] = t
    zs = np.flatnonzero((lab == 2).any(axis=(1, 2)))[:4]
    lab[zs, 0:2, 36:39] = 2  # a second component of tube 2 in its first sections
    return lab


def close_dict(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_tube_metrics_match_jax(seed, tmp_path):
    lab = tubes(seed)
    for kw in (dict(), dict(min_length=4, border_patch_max=30, bump_ratio=1.5, max_components_ratio=0.0)):
        got, want = ptube.tube_instance_qc(lab, **kw), jtube.tube_instance_qc(lab, **kw)
        assert list(got) == list(want)
        for i in want:
            close_dict(got[i], want[i])
        close_dict(ptube.tube_qc_summary(lab, **kw), jtube.tube_qc_summary(lab, **kw))
    summary = ptube.tube_qc_summary(lab, min_length=4, bump_ratio=1.5)
    assert summary["n_instances"] == 7 and summary["n_multi_component"] >= 1
    assert ptube.tube_qc_summary(np.zeros((2, 4, 4), np.uint32)) == {"n_instances": 0.0}
    skel = lab > 0
    moved = np.roll(skel, 1, axis=1)
    for tol in (0, 1, 2):
        close_dict(ptube.skeleton_mask_metrics(moved, skel, tol), jtube.skeleton_mask_metrics(moved, skel, tol))
        close_dict(ptube.curvilinear_f1(moved, skel, tol), jtube.curvilinear_f1(moved, skel, tol))
    paths = []
    for name, vol in (("p", moved), ("g", skel)):
        np.save(tmp_path / f"{name}.npy", vol.astype(np.uint8))
        paths.append(str(tmp_path / f"{name}.npy"))
    got = ptube.evaluate_curvilinear_pairs([paths[0]], [paths[1]], 1)
    want = jtube.evaluate_curvilinear_pairs([paths[0]], [paths[1]], 1)
    assert got.keys() == want.keys() == {"p"}
    close_dict(got["p"], want["p"])


@pytest.mark.parametrize("seed", [0, 3])
def test_oracle_and_error_analysis_match_jax(seed):
    seg, gt = label_pair(seed)
    assert np.array_equal(por.oracle_merge(seg, gt), jor.oracle_merge(seg, gt))
    np.testing.assert_allclose(por.adapted_rand_oracle(seg, gt), jor.adapted_rand_oracle(seg, gt), rtol=1e-6)
    close_dict(por.voi_oracle(seg, gt), jor.voi_oracle(seg, gt))
    assert pea.segment_size_stats(seg) == pytest.approx(jea.segment_size_stats(seg), rel=1e-6)
    assert pea.segment_size_stats(np.zeros((2, 2), np.uint32)) == {"num_segments": 0}
    for kw in (dict(), dict(top=3, min_overlap=5)):
        assert pea.split_merge_attribution(seg, gt, **kw) == jea.split_merge_attribution(seg, gt, **kw)
    got, want = pea.dust_removal_sweep(seg, gt), jea.dust_removal_sweep(seg, gt)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        close_dict(g, w)
    got, want = pea.oracle_study(seg, gt, top_k=4), jea.oracle_study(seg, gt, top_k=4)
    assert got.keys() == want.keys()
    for k in want:
        close_dict(got[k], want[k])
    assert pea.scan_z_discontinuities(seg, top=5) == jea.scan_z_discontinuities(seg, top=5)
    skeletons = {i: SimpleNamespace(nodes=np.argwhere(gt == i)[::7].astype(float) + 0.2)
                 for i in np.unique(gt)[1:12]}
    skeletons[99] = SimpleNamespace(nodes=np.array([[0.0, 0.0, 0.0]]))
    assert pea.skeleton_ownership(seg, skeletons, 2) == jea.skeleton_ownership(seg, skeletons, 2)
    got = pea.analyze_segmentation(seg, gt, top=5, oracle=True, dust=True, z_scan=True)
    want = jea.analyze_segmentation(seg, gt, top=5, oracle=True, dust=True, z_scan=True)
    assert got.keys() == want.keys()
    for k in ("adapted_rand", "voi_split", "voi_merge"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    for k in ("matching", "pred_stats", "gt_stats", "worst_splits", "worst_merges", "z_discontinuities"):
        assert got[k] == pytest.approx(want[k], rel=1e-6)


def test_report_files_match_jax(tmp_path):
    lab = tubes(2)
    per = jtube.tube_instance_qc(lab)
    cfg = {"min_length": 16, "bump_ratio": 3.0}
    got = prep.save_tube_instances(tmp_path / "p", "vol", per, volume_shape=lab.shape, config=cfg)
    want = jrep.save_tube_instances(tmp_path / "j", "vol", per, volume_shape=lab.shape, config=cfg)
    assert got.name == want.name == "eval_vol_tube_instances.npz"
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k], equal_nan=True)
    for name, metrics in (("a", {"voi": 1.25, "adapted_rand": 0.5}), ("b", {"voi": 0.75, "nerl": 0.3})):
        prep.write_metrics_report(tmp_path / "p", name, metrics)
        jrep.write_metrics_report(tmp_path / "j", name, metrics)
    assert prep.aggregate_metrics_summary(tmp_path / "p").name == "metrics_summary.json"
    jrep.aggregate_metrics_summary(tmp_path / "j")
    for f in ("a_metrics.txt", "b_metrics.txt", "metrics.json", "metrics_summary.json", "metrics_summary.txt"):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    assert prep.aggregate_metrics_summary(tmp_path / "none") is None


def test_tube_metric_matches_jax_evaluation_stage(tmp_path):
    """``tube_analysis.yaml``'s evaluation (``metrics: [tube]`` with its
    ``tube`` knobs): the ``tube_*`` counts, the npz and the report."""
    lab = tubes(4)
    gt = np.zeros_like(lab)
    cfg, jcfg = load_config(TUBE, mode="test").evaluation, jax_load_config(TUBE, mode="test").evaluation
    got = run_evaluation_stage(None, lab, gt, cfg, tmp_path / "p", "vol")
    want = jax_run_evaluation_stage(None, lab, gt, jcfg, str(tmp_path / "j"), "vol")
    close_dict(got, want)
    assert got["tube_n_instances"] == 7
    for f in ("vol_metrics.txt", "metrics.json"):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    with np.load(tmp_path / "p" / "eval_vol_tube_instances.npz") as g, \
            np.load(tmp_path / "j" / "eval_vol_tube_instances.npz") as w:
        assert all(np.array_equal(g[k], w[k]) for k in w.files) and sorted(g.files) == sorted(w.files)
    cfg.metrics = ["tube", "voi"]
    jcfg.metrics = ["tube", "voi"]
    seg, gt = label_pair(1)
    close_dict(run_evaluation_stage(None, seg, gt, cfg), jax_run_evaluation_stage(None, seg, gt, jcfg))


def test_experiment_log_matches_jax(tmp_path):
    for cls, name in ((ExperimentLog, "p"), (JaxExperimentLog, "j")):
        log = cls(tmp_path / name / "log.jsonl")
        assert log.entries() == [] and log.best("voi") is None
        log.append("tune", "abc", {"t": 0.3}, {"voi": 1.5, "nerl": 0.2})
        log.append("tune", "abc", {"t": 0.5}, {"voi": 0.9})
        log.append("decode", metrics={"voi": 0.9, "nerl": 0.4}, notes="same voi")
    p, j = ExperimentLog(tmp_path / "p" / "log.jsonl"), JaxExperimentLog(tmp_path / "j" / "log.jsonl")
    strip = lambda rows: [{k: v for k, v in r.items() if k != "time"} for r in rows]  # noqa: E731
    assert strip(p.entries()) == strip(j.entries())
    for metric, minimize in (("voi", True), ("nerl", False), ("voi", False)):
        assert strip([p.best(metric, minimize)]) == strip([j.best(metric, minimize)])


def test_prediction_cache_rules(tmp_path):
    """``validate_prediction_cache``: held to JAX's on HDF5 files, and the
    same rules on the ``.npy`` + ``.json`` the port writes without h5py."""
    pytest.importorskip("h5py")
    pred = np.random.default_rng(0).random((2, 4, 8, 8)).astype(np.float32)
    cases = [("run.ckpt", "h1", "run.ckpt", "h1"), ("run.ckpt", "h1", "other.ckpt", "h1"),
             ("", "h1", "", "h1"), ("", "h1", "run.ckpt", "h1"), ("run.ckpt", "h1", "run.ckpt", "h2"),
             ("run.ckpt", "", "run.ckpt", "h2"), ("__incomplete__", "h1", None, "h1"),
             ("run.ckpt", "h1", None, None)]
    for i, (stored_ckpt, stored_hash, ckpt, chash) in enumerate(cases):
        h5, npy = tmp_path / f"c{i}.h5", tmp_path / f"c{i}.npy"
        jout.save_prediction(h5, pred, stored_hash, stored_ckpt)
        pout.save_prediction(npy, pred, stored_hash, stored_ckpt)
        if stored_ckpt == "__incomplete__":  # stamped afterwards, as a chunked run that stopped leaves it
            jout.save_prediction(h5, pred, stored_hash, "run.ckpt")
            pout.save_prediction(npy, pred, stored_hash, "run.ckpt")
            for path in (h5, npy):
                pout.stamp_prediction_checkpoint(path, "__incomplete__")
        want = jout.validate_prediction_cache(h5, chash, ckpt)
        assert pout.validate_prediction_cache(h5, chash, ckpt) == want
        assert pout.validate_prediction_cache(npy, chash, ckpt) == want, cases[i]
    assert [jout.validate_prediction_cache(tmp_path / f"c{i}.h5", c[3], c[2]) for i, c in enumerate(cases)] == \
        [True, False, True, False, False, True, False, True]
    assert not pout.validate_prediction_cache(tmp_path / "missing.npy", "h1", "")
    np.save(tmp_path / "bare.npy", pred)  # no attrs file: an older cache, accepted
    assert pout.validate_prediction_cache(tmp_path / "bare.npy", "h1", "run.ckpt")


@pytest.mark.parametrize("spread", [1, 100003])
def test_segmentation_scores_match_jax_on_both_count_paths(spread):
    """adapted Rand and VOI equal JAX's with the seg ids dense (the pair
    counts from a count table) and spread past 2^24 pairs (from a sort)."""
    from pytorch_connectomics_tpu.metrics import seg as jseg
    from pytorch_connectomics_tpu_torch.metrics import seg as pseg

    seg, gt = label_pair(3)
    seg = seg * np.uint32(spread)
    assert ((int(gt.max()) + 1) * (int(seg.max()) + 1) > 1 << 24) == (spread > 1)
    assert pseg.adapted_rand(seg, gt, all_stats=True) == jseg.adapted_rand(seg, gt, all_stats=True)
    assert pseg.voi(seg, gt) == jseg.voi(seg, gt)


def test_prediction_crops_match_jax():
    rng = np.random.default_rng(5)
    last = rng.random((12, 20, 16, 3)).astype(np.float32)
    first = np.moveaxis(last, -1, 0)
    offsets = ["0-0-1", "0-1-0", "1-0-0", "0-0-4", "0-3-0", "2-0-0"]
    for pred, axis in ((last, -1), (first, 0)):
        for kw in (dict(crop_pad=[1, 2, 3]), dict(affinity_offsets=offsets), dict(crop_pad=[2, 0, 1],
                                                                                    affinity_offsets=offsets)):
            got = pcrops.apply_prediction_crops(pred, channel_axis=axis, **kw)
            assert np.array_equal(got, jcrops.apply_prediction_crops(pred, channel_axis=axis, **kw))
        assert np.array_equal(pcrops.crop_prediction(pred, [0, 1, 0], axis),
                              jcrops.crop_prediction(pred, [0, 1, 0], axis))
    assert np.array_equal(pcrops.affinity_border_mask((6, 10, 10), offsets),
                          jcrops.affinity_border_mask((6, 10, 10), offsets))
