"""The port's host decode path against the JAX package's on the same seeded
inputs: the native ops (``ops/native.py``, the port's own binding of
``csrc/pytc_ops.cpp``), the ``bcd_watershed`` and ``binary_cc`` decoders
and the decoding stage (identical labels), the instance metrics (equal to
1e-12: the same counts, summed in another order), the evaluation stage's
instance branch and the decoded file name."""

import numpy as np
import pytest
from scipy import ndimage

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.decoding import decoders as jdec
from pytorch_connectomics_tpu.decoding.stage import run_decoding_stage as jax_run_decoding_stage
from pytorch_connectomics_tpu.evaluation.stage import compute_test_metrics as jax_compute_test_metrics
from pytorch_connectomics_tpu.metrics import seg as jseg
from pytorch_connectomics_tpu.ops import native as jnative
from pytorch_connectomics_tpu.runtime.output_naming import decoded_filename as jax_decoded_filename
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.decoding import decoders as pdec
from pytorch_connectomics_tpu_torch.decoding import get_decoder, run_decoding_stage
from pytorch_connectomics_tpu_torch.evaluation.stage import compute_test_metrics
from pytorch_connectomics_tpu_torch.metrics import seg as pseg
from pytorch_connectomics_tpu_torch.ops import native
from pytorch_connectomics_tpu_torch.runtime.output_naming import decoded_filename

NUCMM = "tutorials/nuc_nucmm.yaml"


def _smooth(rng, shape, sigma):
    f = ndimage.gaussian_filter(rng.standard_normal(shape), sigma)
    return (f - f.mean()) / f.std()


def bcd_prediction(seed=0, shape=(32, 64, 64)):
    """Seeded (3, Z, Y, X) bcd map with blob-like nuclei: binary and
    distance high in the blobs' cores, boundary high at their rims."""
    rng = np.random.default_rng(seed)
    f = _smooth(rng, shape, 3.0)
    binary = 1 / (1 + np.exp(-4 * (f - 0.3)))
    boundary = np.exp(-8 * (f - 0.3) ** 2) * 0.9 + 0.05 * rng.random(shape)
    distance = np.tanh(2 * (f - 0.6))
    return np.stack([binary, boundary, distance]).astype(np.float32)


def label_pair(seed=0, shape=(24, 40, 40)):
    """(seg, gt) instance volumes that overlap partly: gt from the
    components of a smooth field, seg from the same field shifted and
    thresholded elsewhere, with a few ids merged."""
    rng = np.random.default_rng(seed)
    f = _smooth(rng, shape, 1.5)
    gt, _ = ndimage.label(f > 1.0)
    seg, _ = ndimage.label(np.roll(f, 1, axis=2) > 0.8)
    seg = np.where(seg % 7 == 3, seg + 1, seg)
    return seg.astype(np.uint32), gt.astype(np.uint32)


def test_native_ops_match_jax():
    rng = np.random.default_rng(3)
    fg = _smooth(rng, (20, 30, 40), 2.0) > 0.3
    for conn in (6, 18, 26):
        got, n = native.connected_components(fg, conn)
        want, m = jnative.connected_components(fg, conn)
        assert n == m > 1 and np.array_equal(got, want)
    energy = _smooth(rng, fg.shape, 1.5).astype(np.float32)
    seeds, _ = native.connected_components(energy < -1.2, 6)
    assert np.array_equal(native.watershed(energy, seeds, mask=fg | (seeds > 0)),
                          jnative.watershed(energy, seeds, mask=fg | (seeds > 0)))
    assert np.array_equal(native.watershed(energy, seeds), jnative.watershed(energy, seeds))
    for k in (1, 30):
        got, gk = native.remove_small(seeds, k)
        want, wk = jnative.remove_small(seeds, k)
        assert gk == wk and np.array_equal(got, want)
    got, gn = native.renumber(seeds * 5)
    want, wn = jnative.renumber(seeds * 5)
    assert gn == wn and np.array_equal(got, want)


def test_native_library_is_built_outside_csrc():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.parent.name == "build"
    native.get_lib()
    assert path.exists() and "csrc" not in path.parts


@pytest.mark.parametrize("seed", [0, 1])
def test_bcd_watershed_labels_identical(seed):
    pred = bcd_prediction(seed)
    got = get_decoder("bcd_watershed")(pred, binary_threshold=0.9, boundary_threshold=0.85, seed_threshold=0.5)
    want = jdec.decode_bcd_watershed(pred, binary_threshold=0.9, boundary_threshold=0.85, seed_threshold=0.5)
    assert len(np.unique(want)) > 5 and np.array_equal(got, want)
    got = pdec.decode_bcd_watershed(pred[:2], min_size=20)  # no distance channel, dusting
    assert np.array_equal(got, jdec.decode_bcd_watershed(pred[:2], min_size=20))
    assert np.array_equal(pdec.decode_binary_cc(pred, threshold=0.6, min_size=5),
                          jdec.decode_binary_cc(pred, threshold=0.6, min_size=5))


def test_decoding_stage_matches_jax():
    cfg, jcfg = load_config(NUCMM, mode="test"), jax_load_config(NUCMM, mode="test")
    pred = bcd_prediction(2)
    want = jax_run_decoding_stage(pred, jcfg.decoding)
    assert np.array_equal(run_decoding_stage(pred, cfg.decoding), want)
    # channel-last input, as inference hands it over
    assert np.array_equal(run_decoding_stage(np.moveaxis(pred, 0, -1), cfg.decoding), want)
    cfg.decoding.steps = []  # binary_cc by default
    jcfg.decoding.steps = []
    assert np.array_equal(run_decoding_stage(pred, cfg.decoding), jax_run_decoding_stage(pred, jcfg.decoding))


@pytest.mark.parametrize("what", ["qc", "graph", "streamed", "branch_merge", "decoder"])
def test_decoding_stage_refuses_what_is_not_ported(what):
    """What the decoding stages refuse, as the JAX package's do: the
    streamed stage takes one ``affinity_cc`` or ``waterz`` step and no QC
    mask or graph; a decoder that no registry names raises ``KeyError``."""
    from pytorch_connectomics_tpu.decoding.stage import run_streamed_decoding_stage as jax_streamed
    from pytorch_connectomics_tpu_torch.decoding import run_streamed_decoding_stage

    cfg, jcfg = load_config(NUCMM, mode="test").decoding, jax_load_config(NUCMM, mode="test").decoding
    pred = bcd_prediction(0, (4, 8, 8))
    if what == "decoder":
        for c, run in ((cfg, run_decoding_stage), (jcfg, jax_run_decoding_stage)):
            c.steps[0].name = "no_such_decoder"
            with pytest.raises(KeyError, match="no_such_decoder"):
                run(pred, c)
        return
    for c in (cfg, jcfg):
        if what == "qc":
            c.steps[0].name = "affinity_cc"
            c.qc.enabled = True
        elif what == "graph":
            c.graph = {"nodes": {"x": {"op": "affinity_cc", "inputs": ["prediction"]}}, "output": "x"}
        elif what == "branch_merge":
            c.steps[0].name = "waterz"
            c.steps.append(type(c.steps[0])(name="branch_merge"))
    reader = lambda sl: pred[(slice(None),) + tuple(sl)]  # noqa: E731
    for stage, c in ((run_streamed_decoding_stage, cfg), (jax_streamed, jcfg)):
        with pytest.raises(ValueError, match="decoding.streamed"):
            stage(reader, pred.shape[1:], c)


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_instance_metrics_match_jax(seed):
    seg, gt = label_pair(seed)
    if seed == 2:  # ids far apart: the sorted path of the pair counts
        seg = np.where(seg > 0, seg + 1_000_000, 0).astype(np.uint32)
    for t in (0.3, 0.5, 0.75):
        got, want = pseg.instance_matching(seg, gt, t), jseg.instance_matching(seg, gt, t)
        assert got.keys() == want.keys() and (want["tp"] > 0 or t > 0.5)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert pseg.average_precision(seg, gt) == pytest.approx(jseg.average_precision(seg, gt), rel=1e-12, abs=1e-12)
    assert pseg.adapted_rand(seg, gt, all_stats=True) == pytest.approx(jseg.adapted_rand(seg, gt, all_stats=True),
                                                                       rel=1e-12, abs=1e-12)
    assert pseg.voi(seg, gt) == pytest.approx(jseg.voi(seg, gt), rel=1e-12, abs=1e-12)


def test_instance_metrics_without_instances():
    empty, (_, gt) = np.zeros((4, 5, 6), np.uint32), label_pair(0, (4, 5, 6))
    for seg, g in ((empty, gt), (gt, empty), (empty, empty)):
        assert pseg.instance_matching(seg, g) == jseg.instance_matching(seg, g)
        assert pseg.average_precision(seg, g) == jseg.average_precision(seg, g)
        assert pseg.adapted_rand(seg, g) == jseg.adapted_rand(seg, g)
        assert pseg.voi(seg, g) == jseg.voi(seg, g)


def test_evaluation_instance_branch_matches_jax():
    seg, gt = label_pair(5)
    metrics = ["instance_f1", "ap", "adapted_rand", "voi", "panoptic_quality", "jaccard"]
    prob = (gt > 0).astype(np.float32)[..., None] * 0.8
    got = compute_test_metrics(prob, seg, gt, metrics)
    want = jax_compute_test_metrics(prob, seg, gt, metrics)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert "ap" not in compute_test_metrics(prob, None, gt, metrics)


@pytest.mark.parametrize("change", ["none", "save_suffix", "kwargs"])
def test_decoded_filename_matches_jax(change):
    cfg, jcfg = load_config(NUCMM, mode="test"), jax_load_config(NUCMM, mode="test")
    for c in (cfg, jcfg):
        if change == "save_suffix":
            c.decoding.save_suffix = "run 1"
        elif change == "kwargs":
            c.decoding.steps[0].kwargs["min_size"] = 8
    got = decoded_filename("vol", "ckpt_tta_x4", decoding_cfg=cfg.decoding)
    assert got == jax_decoded_filename("vol", "ckpt_tta_x4", decoding_cfg=jcfg.decoding)
    assert decoded_filename("vol", "t") == jax_decoded_filename("vol", "t")
