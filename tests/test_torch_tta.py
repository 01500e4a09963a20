"""The port's TTA against the JAX package's: variant enumeration (with
deduplication), variant application and inversion, per-channel activations,
per-channel-slice ensembling, and TTAPredictor end to end on the window
engines with a fixed linear apply_fn. The port's functions take tensors, the
JAX package's numpy arrays; both get the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config.schema import TTAConfig as JaxTTAConfig
from pytorch_connectomics_tpu.inference import tta as jt
from pytorch_connectomics_tpu.inference import window as jw
from pytorch_connectomics_tpu_torch.config.schema import TTAConfig
from pytorch_connectomics_tpu_torch.inference import tta as tt
from pytorch_connectomics_tpu_torch.inference import window as tw
from test_torch_window import _ramp, linear_fns

VARIANT_CASES = [
    dict(flip_axes="all"),
    dict(flip_axes="xy"),
    dict(flip_axes=None),
    dict(flip_axes=[[0], [1, 2]]),
    dict(flip_axes="all", rotation90=True),
    dict(flip_axes="xy", rotation_planes=[[0, 1], [1, 2]], rotation_k=[1, 2]),
    dict(transforms=[{"flip": [0]}, {"rot": 2}, {"flip": [1, 2]}, {"rotation90_k": 1, "plane": [0, 2]}]),
]


@pytest.mark.parametrize("case", VARIANT_CASES, ids=range(len(VARIANT_CASES)))
def test_variants_match_jax(case):
    got = tt.enumerate_tta_variants(**case)
    assert got == jt.enumerate_tta_variants(**case)
    vol = np.arange(4 * 4 * 4 * 2, dtype=np.float32).reshape(4, 4, 4, 2)
    for v in got:
        out = tt.apply_variant(torch.from_numpy(vol), v)
        np.testing.assert_array_equal(out.numpy(), jt.apply_variant(vol, v))
        np.testing.assert_array_equal(tt.invert_variant(out, v).numpy(), vol)


@pytest.mark.parametrize("case", VARIANT_CASES, ids=range(len(VARIANT_CASES)))
def test_invert_matches_jax(case):
    """Inversion of a (Z, Y, X, C) prediction with unequal sides, so a
    rotation in any plane changes the shape."""
    pred = np.random.default_rng(3).standard_normal((3, 5, 7, 2)).astype(np.float32)
    for v in tt.enumerate_tta_variants(**case):
        fwd = jt.apply_variant(pred, v)
        got = tt.invert_variant(torch.from_numpy(fwd.copy()), v)
        np.testing.assert_array_equal(got.numpy(), jt.invert_variant(fwd, v))


def test_flip_all_has_eight_variants():
    assert len(tt.enumerate_tta_variants("all")) == 8


@pytest.mark.parametrize(
    "acts",
    ["sigmoid", "tanh", "softmax", None, [{"channels": ":", "activation": "sigmoid"}],
     [["0:2", "sigmoid"], ["2:3", "tanh"]], [{"channels": "-1:", "activation": "softmax"}]],
    ids=range(7),
)
def test_channel_activations_match_jax(acts):
    pred = np.random.default_rng(0).standard_normal((3, 4, 5, 3)).astype(np.float32) * 3
    got = tt.apply_channel_activations(torch.from_numpy(pred), acts)
    np.testing.assert_allclose(got.numpy(), jt.apply_channel_activations(pred, acts), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["mean", "min", "max", [["0:1", "min"], ["1:", "mean"]]], ids=range(4))
def test_ensemble_matches_jax(mode):
    rng = np.random.default_rng(1)
    preds = [rng.standard_normal((3, 4, 5, 2)).astype(np.float32) for _ in range(5)]
    got = tt.ensemble((torch.from_numpy(p) for p in preds), mode)
    np.testing.assert_array_equal(got.numpy(), jt.ensemble(preds, mode))


@pytest.mark.parametrize("flip_axes,act", [("all", "sigmoid"), ("xy", None)])
def test_predictor_matches_jax(flip_axes, act):
    window = (8, 12, 10)
    jfn, tfn = linear_fns(window)
    kw = dict(window=window, overlap=0.25, sw_batch_size=4)
    vol = np.random.default_rng(2).random((14, 20, 18)).astype(np.float32)
    want = jt.TTAPredictor(
        jw.SlidingWindowEngine(jfn, **kw), JaxTTAConfig(enabled=True, flip_axes=flip_axes), activations=act
    ).predict(None, vol, out_channels=2)
    pred = tt.TTAPredictor(
        tw.SlidingWindowEngine(tfn, device="cpu", **kw), TTAConfig(enabled=True, flip_axes=flip_axes), activations=act
    )
    got = pred.predict(vol, out_channels=2)
    assert pred.num_variants == (8 if flip_axes == "all" else 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


AFF_GROUPS = [{"start": 1, "end": 4, "offsets": [(0, 0, 2), (0, -3, 0), (1, 0, 0)], "mode": "deepem"}]


def test_unported_tta_modes_raise():
    """Patch-local TTA is not ported; rotations over affinity channels raise
    in both packages (a rotation permutes offset channels)."""
    eng = tw.SlidingWindowEngine(linear_fns((8, 8, 8))[1], window=(8, 8, 8), device="cpu")
    with pytest.raises(NotImplementedError):
        tt.TTAPredictor(eng, TTAConfig(enabled=True, patch_first_local=True))
    with pytest.raises(ValueError, match="rotation90"):
        tt.TTAPredictor(eng, TTAConfig(enabled=True, rotation90=True), affinity_groups=AFF_GROUPS)
    jeng = jw.SlidingWindowEngine(linear_fns((8, 8, 8))[0], window=(8, 8, 8))
    with pytest.raises(ValueError, match="rotation90"):
        jt.TTAPredictor(jeng, JaxTTAConfig(enabled=True, rotation90=True), affinity_groups=AFF_GROUPS)


@pytest.mark.parametrize("flipped", [(), (2,), (1,), (1, 2), (0, 1, 2)], ids=str)
@pytest.mark.parametrize("lead", [(), (2,)], ids=["zyxc", "nzyxc"])
def test_affinity_flip_align_matches_jax(flipped, lead):
    """Each affinity channel shifted by its offset along every flipped axis,
    zero-filled; offsets of both signs, one as long as the z extent less one; a
    group that starts past channel 0 and a leading batch axis. Bit-equal."""
    offsets = [(0, 0, 2), (0, -3, 0), (1, 0, 0), (5, 0, -1), (0, 5, 5)]
    aff = np.random.default_rng(3).random((*lead, 6, 9, 8, 7)).astype(np.float32)
    want = np.asarray(jt.affinity_flip_align(aff, flipped, offsets, channel_slice=(2, 7)))
    got = tt.affinity_flip_align(torch.from_numpy(aff), flipped, offsets, (2, 7))
    np.testing.assert_array_equal(got.numpy(), want)


def affinity_fns(window):
    """(jax apply_fn, torch apply_fn) of four channels, none symmetric under
    a flip: a voxel map, then three affinity-like maps of voxel and ramp."""
    ramp = _ramp(window)

    def jax_fn(params, w):
        r = jnp.asarray(ramp)
        return jnp.concatenate([w * 2.0 + 1.0, w * -0.5 + r, (w - 0.5) * r, w * 0.7 - r * 0.2], -1)

    tr = torch.from_numpy(ramp)

    def torch_fn(w):
        return torch.cat([w * 2.0 + 1.0, w * -0.5 + tr, (w - 0.5) * tr, w * 0.7 - tr * 0.2], -1)

    return jax_fn, torch_fn


@pytest.mark.parametrize("mode,act", [("min", "sigmoid"), ("mean", None), ([["0:1", "mean"], ["1:", "min"]], "sigmoid")],
                         ids=["min", "mean", "mixed"])
def test_predictor_with_affinity_groups_matches_jax(mode, act):
    """Flip xy TTA (4 variants) over a prediction whose channels 1-3 are
    affinities: each flipped variant realigned on its raw output, then
    activated and ensembled, as JAX's serial predictor does."""
    window = (8, 12, 10)
    jfn, tfn = affinity_fns(window)
    kw = dict(window=window, overlap=0.25, sw_batch_size=4)
    vol = np.random.default_rng(4).random((14, 20, 18)).astype(np.float32)
    cfg = dict(enabled=True, flip_axes="xy", ensemble_mode=mode)
    want = jt.TTAPredictor(jw.SlidingWindowEngine(jfn, **kw), JaxTTAConfig(**cfg), activations=act,
                           affinity_groups=AFF_GROUPS).predict(None, vol, out_channels=4)
    pred = tt.TTAPredictor(tw.SlidingWindowEngine(tfn, device="cpu", **kw), TTAConfig(**cfg), activations=act,
                           affinity_groups=AFF_GROUPS)
    got = pred.predict(vol, out_channels=4)
    plain = tt.TTAPredictor(tw.SlidingWindowEngine(tfn, device="cpu", **kw), TTAConfig(**cfg), activations=act)
    assert pred.num_variants == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(plain.predict(vol, out_channels=4) - want)[..., 1:].max() > 1e-2  # the realignment matters
