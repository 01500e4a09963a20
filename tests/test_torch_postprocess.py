"""The port's decode post-processing against the JAX package's on the same
seeded labels and probability maps: ``apply_postprocessing`` with each of
its steps and every ``small_instance_mode``, all steps together, the
binary cleanup chain, the helpers each step runs, and the decoding stage
and the waterz batch objective with post-processing configured. Labels
must be equal bit for bit, dtype included."""

import numpy as np
import pytest
from scipy import ndimage

from pytorch_connectomics_tpu.config.schema import DecodingPostprocessConfig as JaxPostConfig
from pytorch_connectomics_tpu.config.schema import build_dataclass as jax_build_dataclass
from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.decoding import postprocess as jpp
from pytorch_connectomics_tpu.decoding.stage import run_decoding_stage as jax_run_decoding_stage
from pytorch_connectomics_tpu.decoding.tuning import make_waterz_batch_objective as jax_waterz_objective
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.config.schema import DecodingPostprocessConfig, build_dataclass, to_dict
from pytorch_connectomics_tpu_torch.decoding import postprocess as pp
from pytorch_connectomics_tpu_torch.decoding import run_decoding_stage
from pytorch_connectomics_tpu_torch.decoding.tuning import make_waterz_batch_objective

NISB = "tutorials/neuron_nisb.yaml"
TUNE = "tutorials/synthetic_instance_tune_tpu.yaml"


def instance_labels(seed=0, shape=(12, 40, 36)):
    """Seeded uint32 instances: components of a smooth field at many sizes,
    some ids shared by two far-apart pieces (disconnected instances), and
    specks of 1-6 voxels."""
    rng = np.random.default_rng(seed)
    f = ndimage.gaussian_filter(rng.standard_normal(shape), 1.5)
    lab, n = ndimage.label(f > 0.05)
    lab = np.where(lab > 0, (lab % max(2, n // 2)) + 1, 0).astype(np.uint32)
    specks = rng.random(shape) > 0.995
    lab[specks] = rng.integers(n + 5, n + 40, int(specks.sum()))
    return lab


def prob_map(seed=0, shape=(12, 40, 36)):
    rng = np.random.default_rng(seed)
    f = ndimage.gaussian_filter(rng.standard_normal(shape), 2.0)
    return (1 / (1 + np.exp(-6 * f)) + 0.1 * rng.random(shape)).astype(np.float32).clip(0, 1)


BINARY = {"threshold": 0.55, "median_filter_size": [1, 3, 3], "opening_iterations": 1, "closing_iterations": 1,
          "connected_components": {"connectivity": 26, "min_size": 20, "top_k": 3}}
CASES = {
    **{f"small_{m}": {"min_instance_size": 25, "small_instance_mode": m} for m in pp.SMALL_INSTANCE_MODES},
    "split_6": {"split_disconnected": True},
    "split_26": {"split_disconnected": True, "connectivity": 26},
    "large": {"max_instance_size": 300},
    "transpose": {"transpose": [2, 0, 1]},
    "all": {"split_disconnected": True, "min_instance_size": 40, "small_instance_mode": "neighbor",
            "max_instance_size": 2000, "transpose": [0, 2, 1]},
}


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_postprocessing_matches_jax(case, seed):
    labels = instance_labels(seed)
    cfg = build_dataclass(DecodingPostprocessConfig, CASES[case])
    jcfg = jax_build_dataclass(JaxPostConfig, CASES[case])
    got, want = pp.apply_postprocessing(labels.copy(), cfg), jpp.apply_postprocessing(labels.copy(), jcfg)
    assert_same(got, want)
    if case not in ("transpose", "small_none"):
        assert not np.array_equal(got, labels)  # each of the others changes the labels


@pytest.mark.parametrize("binary", [BINARY, {"threshold": 0.4}, {"median_filter_size": 3, "closing_iterations": 2},
                                    {"connected_components": {"min_size": 50}}],
                         ids=["all", "threshold", "median_close", "cc"])
def test_binary_chain_matches_jax(binary):
    pred = prob_map(3)
    assert_same(pp.apply_binary_postprocessing(pred, binary), jpp.apply_binary_postprocessing(pred, binary))
    cfg = build_dataclass(DecodingPostprocessConfig, {"binary": binary, "split_disconnected": True})
    jcfg = jax_build_dataclass(JaxPostConfig, {"binary": binary, "split_disconnected": True})
    assert_same(pp.apply_postprocessing(pred, cfg), jpp.apply_postprocessing(pred, jcfg))
    # integer input binarizes at > 0
    labels = instance_labels(4)
    assert_same(pp.apply_binary_postprocessing(labels, binary), jpp.apply_binary_postprocessing(labels, binary))


def test_helpers_match_jax():
    labels = instance_labels(5)
    for k in (1, 7, 30):
        assert_same(pp.merge_small_objects(labels.copy(), k, do_3d=True),
                    jpp.merge_small_objects(labels.copy(), k, do_3d=True))
        assert_same(pp.merge_small_objects(labels[3].copy(), k), jpp.merge_small_objects(labels[3].copy(), k))
        assert_same(pp.remove_large_instances(labels, 10 * k), jpp.remove_large_instances(labels, 10 * k))
    for conn in (6, 18, 26):
        assert_same(pp.cc_instance_filter(labels, conn), jpp.cc_instance_filter(labels, conn))
    for top in (0, 200, 70000, 2**33):
        seg = np.array([[[0, top]]], np.uint64)
        assert_same(pp.cast2dtype(seg), jpp.cast2dtype(seg))
    with pytest.raises(ValueError, match="mode"):
        pp.remove_small_instances(labels, 5, "sideways")


def _affinities(seed, shape=(16, 64, 64)):
    """Noisy cardinal affinities of the components of a smooth field."""
    rng = np.random.default_rng(seed)
    lab = ndimage.label(ndimage.gaussian_filter(rng.standard_normal(shape), 3.0) > 0.02)[0]
    aff = np.stack([(lab == np.roll(lab, 1, axis=a)) & (lab > 0) for a in (2, 1, 0)]).astype(np.float32)
    return np.clip(aff * 0.8 + 0.3 * rng.random(aff.shape, dtype=np.float32), 0, 1)


def test_decoding_stage_with_postprocessing_matches_jax():
    """neuron_nisb.yaml's decode as shipped: affinity_cc at 0.75, then
    ``min_instance_size: 200``."""
    aff = _affinities(6)
    cfg, jcfg = load_config(NISB, mode="test").decoding, jax_load_config(NISB, mode="test").decoding
    assert cfg.postprocessing.min_instance_size == 200
    got, want = run_decoding_stage(aff, cfg), jax_run_decoding_stage(aff, jcfg)
    assert_same(got, want)
    assert got.max() > 1


def test_waterz_batch_objective_postprocesses_as_jax():
    aff = _affinities(7)
    gt = instance_labels(7, aff.shape[1:])
    d = to_dict(load_config(TUNE, mode="tune").decoding)
    d.pop("tuning", None)
    d["postprocessing"] = {"min_instance_size": 400, "split_disconnected": True}
    params = {"steps.0.kwargs.fragment_threshold": 0.6}
    got = make_waterz_batch_objective(aff, gt, d, "voi", [0.3, 0.6])(params)
    want = jax_waterz_objective(aff, gt, d, "voi", [0.3, 0.6])(params)
    assert got[1]["best_threshold"] == want[1]["best_threshold"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    d["postprocessing"] = {}
    assert make_waterz_batch_objective(aff, gt, d, "voi", [0.3, 0.6])(params)[0] != got[0]


# the manual mask edits and the 2-D -> 3-D stitching: labels bit for bit,
# new ids and dtypes included

def _dumbbells(seed, dtype=np.uint32):
    """Instances 1 and 2 each two cubes joined by a one-voxel bridge, beside
    seeded specks of other ids."""
    rng = np.random.default_rng(seed)
    vol = np.zeros((9, 12, 30), dtype)
    for iid, (y0, x0) in ((1, (1, 1)), (2, (6, 2))):
        vol[1:6, y0:y0 + 5, x0:x0 + 5] = iid
        vol[1:6, y0:y0 + 5, x0 + 10 + seed:x0 + 15 + seed] = iid
        vol[3, y0 + 2, x0 + 5:x0 + 10 + seed] = iid
    specks = (rng.random(vol.shape) > 0.98) & (vol == 0)
    vol[specks] = rng.integers(3, 9, int(specks.sum()))
    return vol


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.int64])
@pytest.mark.parametrize("seed", [0, 1])
def test_mask_edits_match_jax(seed, dtype):
    vol = _dumbbells(seed, dtype)
    other = instance_labels(seed, vol.shape).astype(dtype)
    for got, want in (
        (pp.remove_masks(vol.copy(), [1, 5, 77]), jpp.remove_masks(vol.copy(), [1, 5, 77])),
        (pp.add_masks(vol.copy(), other, [2, 3, 4]), jpp.add_masks(vol.copy(), other, [2, 3, 4])),
        (pp.merge_masks(vol.copy(), [[2, 1], [], [7, 3, 4]]), jpp.merge_masks(vol.copy(), [[2, 1], [], [7, 3, 4]])),
    ):
        assert_same(got, want)
        assert not np.array_equal(got, vol)
    for index, md in ((1, 2), (2, 1), (2, 3), (42, 2)):
        got, want = pp.watershed_split(vol.copy(), index, md), jpp.watershed_split(vol.copy(), index, md)
        assert_same(got, want)
    assert int(pp.watershed_split(vol.copy(), 1, 2).max()) > int(vol.max())  # split into new ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binarize_iou_and_stitch_match_jax(seed):
    prob = prob_map(seed)
    for size, thres in (((3, 3, 3), 0.5), ((1, 5, 5), 0.7)):
        assert_same(pp.binarize_and_median(prob, size, thres), jpp.binarize_and_median(prob, size, thres))
    a, b = instance_labels(seed), instance_labels(seed + 10)
    got, want = pp.intersection_over_union(a, b), jpp.intersection_over_union(a, b)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # 2-D labellings a section, uint8 so that the new ids pass its max; an empty section in the middle
    stack = np.stack([ndimage.label(s)[0] for s in prob > 0.6]).astype(np.uint8)
    stack[4] = 0
    for thr in (0.1, 0.25, 0.6):
        got, want = pp.stitch_3d(stack, thr), jpp.stitch_3d(stack, thr)
        assert_same(got, want)
        assert got.dtype == np.int64
