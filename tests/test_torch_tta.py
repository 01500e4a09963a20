"""The port's TTA against the JAX package's: variant enumeration (with
deduplication), variant application and inversion, per-channel activations,
per-channel-slice ensembling, and TTAPredictor end to end on the window
engines with a fixed linear apply_fn. The port's functions take tensors, the
JAX package's numpy arrays; both get the same seeded inputs."""

import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config.schema import TTAConfig as JaxTTAConfig
from pytorch_connectomics_tpu.inference import tta as jt
from pytorch_connectomics_tpu.inference import window as jw
from pytorch_connectomics_tpu_torch.config.schema import TTAConfig
from pytorch_connectomics_tpu_torch.inference import tta as tt
from pytorch_connectomics_tpu_torch.inference import window as tw
from test_torch_window import linear_fns

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


def test_unported_tta_modes_raise():
    eng = tw.SlidingWindowEngine(linear_fns((8, 8, 8))[1], window=(8, 8, 8), device="cpu")
    with pytest.raises(NotImplementedError):
        tt.TTAPredictor(eng, TTAConfig(enabled=True, patch_first_local=True))
    with pytest.raises(NotImplementedError):
        tt.TTAPredictor(eng, TTAConfig(enabled=True), affinity_outputs=True)
