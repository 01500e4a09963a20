"""The port's polarity, LSD and other host targets, label clean-ups,
``polarity2instance`` and MALIS against the JAX package's, on the CPU at
tiny sizes: targets, label transforms and decoded labels bit for bit, the
MALIS counts bit for bit (both call the same native library) and the MALIS
loss and its gradient within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.data.targets import build as jbuild
from pytorch_connectomics_tpu.data.targets import distance as jdist
from pytorch_connectomics_tpu.data.targets import lsd as jlsd
from pytorch_connectomics_tpu.data.targets import misc as jmisc
from pytorch_connectomics_tpu.decoding.decoders import decode_polarity as jax_polarity
from pytorch_connectomics_tpu.losses import malis as jmalis
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.data.targets import build as pbuild
from pytorch_connectomics_tpu_torch.data.targets import distance as pdist
from pytorch_connectomics_tpu_torch.data.targets import lsd as plsd
from pytorch_connectomics_tpu_torch.data.targets import misc as pmisc
from pytorch_connectomics_tpu_torch.decoding.registry import get_decoder
from pytorch_connectomics_tpu_torch.losses import malis as pmalis
from pytorch_connectomics_tpu_torch.losses.zoo import get_loss
from pytorch_connectomics_tpu_torch.ops import native

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"


def _seg(seed, shape=(6, 14, 12), ids=7):
    """Blocky instances (ids 1..ids on a coarse grid, a third background),
    some ids split in two pieces."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, ids + 1, (shape[0] // 2 + 1, shape[1] // 3 + 1, shape[2] // 3 + 1))
    coarse[rng.random(coarse.shape) < 0.3] = 0
    seg = coarse.repeat(2, 0).repeat(3, 1).repeat(3, 2)[: shape[0], : shape[1], : shape[2]]
    return seg.astype(np.uint32)


TARGETS = [
    ("polarity", {}), ("polarity", {"exclusive": True}), ("small_object", {"size_threshold": 40}),
    ("flow", {}), ("binary_ratio_weight", {}), ("unet3d_weight", {"w0": 5.0, "sigma": 2.0}),
    ("lsd", {"sigma": (2.0, 2.0, 2.0)}),
]


@pytest.mark.parametrize("name,kw", TARGETS, ids=[f"{n}{'-' + '-'.join(map(str, k)) if k else ''}" for n, k in TARGETS])
def test_target_matches_jax(name, kw):
    seg = _seg(1)
    want, got = jbuild._TARGETS[name](seg, **kw), pbuild._TARGETS[name](seg, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(components="0129", voxel_size=(2.0, 1.0, 1.0)), dict(mode="sphere", sigma=2.0),
                                dict(downsample=2, sigma=2.0), dict(sigma=1.5)], ids=["subset", "sphere", "down", "2d"])
def test_lsd_options_match_jax(kw):
    seg = _seg(2, shape=(6, 12, 12))
    if "downsample" not in kw and kw.get("sigma") == 1.5:
        seg = seg[0]  # 2-D descriptors
    np.testing.assert_array_equal(plsd.seg_to_lsd(seg, **kw), jlsd.seg_to_lsd(seg, **kw))


@pytest.mark.parametrize("fn", ["relabel_connected_components", "normalize_labels"])
def test_label_cleanups_match_jax(fn):
    seg = _seg(3) * 3  # sparse ids
    np.testing.assert_array_equal(getattr(pmisc, fn)(seg), getattr(jmisc, fn)(seg))
    np.testing.assert_array_equal(getattr(pmisc, fn)(seg[None]), getattr(jmisc, fn)(seg[None]))


@pytest.mark.parametrize("tsz", [1, (0, 1, 2)], ids=["inplane", "peraxis"])
def test_erosion_window_matches_jax(tsz):
    seg = _seg(4).astype(np.int64)
    seg[0, :2, :2] = -1  # unlabeled voxels pass through
    np.testing.assert_array_equal(pdist.seg_erosion_instance(seg, tsz), jdist.seg_erosion_instance(seg, tsz))


def test_quantizers_match_jax():
    e = np.random.default_rng(0).uniform(-1, 1.0, (4, 5, 6)).astype(np.float32)
    e[0, 0, 0] = 1.0
    np.testing.assert_array_equal(pmisc.energy_quantize(e, 8), jmisc.energy_quantize(e, 8))
    scores = np.random.default_rng(1).standard_normal((9, 3, 4, 5)).astype(np.float32)
    for mode in ("max", "mean"):
        np.testing.assert_array_equal(pmisc.decode_quantize(scores, mode, 8), jmisc.decode_quantize(scores, mode, 8))


def test_target_fn_with_cleanups_matches_jax():
    """The whole label transform: normalize_labels, relabel_cc, erosion and
    erosion_window, then the stacked polarity, small-object and flow
    targets, and the channel spans."""
    over = ["data.label_transform.targets=[{name: polarity}, {name: small_object, kwargs: {size_threshold: 30}}, "
            "{name: flow}]", "data.label_transform.normalize_labels=true", "data.label_transform.relabel_cc=true",
            "data.label_transform.erosion=1", "data.label_transform.erosion_window=1"]
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    seg = _seg(5)[None] * 5
    got = pbuild.build_target_fn(cfg.data.label_transform)(seg)
    np.testing.assert_array_equal(got, jbuild.build_target_fn(jcfg.data.label_transform)(seg))
    assert got.shape == (7,) + seg.shape[1:]
    assert pbuild.target_channel_spans(cfg.data.label_transform) == jbuild.target_channel_spans(jcfg.data.label_transform)


@pytest.mark.parametrize("min_size", [0, 12])
def test_polarity2instance_matches_jax(min_size):
    rng = np.random.default_rng(min_size)
    pred = rng.random((3, 8, 20, 20)).astype(np.float32) ** 3
    pred[:, 2:5, 4:9, 4:12] += 0.6
    want = jax_polarity(pred, threshold=0.5, min_size=min_size)
    got = get_decoder("polarity2instance")(pred, threshold=0.5, min_size=min_size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 2


def _aff(seed, seg):
    rng = np.random.default_rng(seed)
    return rng.random((3,) + seg.shape).astype(np.float32)


@pytest.mark.parametrize("count_pos", [True, False], ids=["pos", "neg"])
def test_malis_counts_match_jax(count_pos):
    seg = _seg(6, shape=(4, 9, 9), ids=4)
    aff = _aff(6, seg)
    got = native.malis_counts(aff, seg, count_pos)
    np.testing.assert_array_equal(got, jmalis.malis_counts(aff, seg, count_pos))
    assert got.sum() > 0


@pytest.mark.parametrize("crop", [None, 4])
def test_malis_loss_and_gradient_match_jax(crop):
    """The loss and d loss / d pred; with ``crop_size`` the port's origin is
    its own fixed draw, so JAX is fed that crop uncropped."""
    segs = np.stack([_seg(s, shape=(5, 9, 9), ids=4) for s in (7, 8)])
    pred = np.random.default_rng(9).standard_normal((2, 5, 9, 9, 3)).astype(np.float32)
    p, s = pred, segs[..., None]
    if crop:
        z0, y0, x0 = pmalis.crop_origin(pred.shape[1:4], crop)
        sl = (slice(None), slice(z0, z0 + crop), slice(y0, y0 + crop), slice(x0, x0 + crop))
        p, s = pred[sl], s[sl]

    def jloss(x):
        return jmalis.MalisLoss(sigmoid=True)(x, jnp.asarray(s))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(p))
    t = torch.from_numpy(pred).requires_grad_()
    got = get_loss("MalisLoss")(t, torch.from_numpy(segs[..., None]), crop_size=crop, num_workers=2)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    g = t.grad.numpy()
    if crop:
        assert np.all(np.delete(g.reshape(2, -1, 3), np.ravel_multi_index(
            np.indices((crop,) * 3).reshape(3, -1) + np.array([[z0], [y0], [x0]]), pred.shape[1:4]), axis=1) == 0)
        g = g[sl]
    np.testing.assert_allclose(g, np.asarray(want_g), rtol=1e-5, atol=1e-7)
