"""The port's sliding-window engines against the JAX package's, on the CPU:
the snap-grid engine (non-dividing stride), the parity-group engine
(dividing stride), grow-to-ROI padding and ``predict_volume_device``, with a
fixed position-dependent linear ``apply_fn`` and with the tiny MedNeXt on
weights carried over by the bridge. f32; tolerances from summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pytorch_connectomics_tpu.inference import window as jw
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.models.build import init_model as jax_init
from pytorch_connectomics_tpu_torch.inference import window as tw
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import load_flax_params


def _ramp(window):
    z, y, x = np.meshgrid(*(np.arange(w) / w for w in window), indexing="ij")
    return (z + 2 * y - x).astype(np.float32)[..., None]


def linear_fns(window):
    """(jax apply_fn(params, w), torch apply_fn(w)): two output channels,
    one a voxel map, one a position ramp, so blending placement matters."""
    ramp = _ramp(window)

    def jax_fn(params, w):
        return jnp.concatenate([w * 2.0 + 1.0, w * -0.5 + jnp.asarray(ramp)], -1)

    tramp = torch.from_numpy(ramp)

    def torch_fn(w):
        return torch.cat([w * 2.0 + 1.0, w * -0.5 + tramp], -1)

    return jax_fn, torch_fn


def _vol(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


ENGINE_CASES = [
    # (volume, window, overlap, stride, blending, border_mask, sw_batch)
    ((20, 30, 25), (8, 12, 10), 0.25, None, "bump", None, 4),  # snap grid
    ((20, 30, 25), (8, 12, 10), 0.25, None, "constant", None, 3),
    ((19, 23, 21), (8, 12, 10), 0.0, (5, 7, 6), "gaussian", (1, 2, 1), 5),  # snap grid, border mask
    ((18, 20, 22), (8, 8, 8), 0.5, (4, 4, 4), "bump", None, 4),  # dividing stride
    ((17, 16, 13), (8, 8, 8), 0.0, (8, 8, 8), "bump", None, 2),  # dividing, no overlap
    ((6, 20, 9), (8, 12, 10), 0.25, None, "bump", None, 2),  # smaller than the window
]


@pytest.mark.parametrize("vol_shape,window,overlap,stride,blending,border,sw", ENGINE_CASES)
def test_engine_matches_jax(vol_shape, window, overlap, stride, blending, border, sw):
    jfn, tfn = linear_fns(window)
    kw = dict(window=window, overlap=overlap, stride=stride, blending=blending, sw_batch_size=sw, border_mask=border)
    vol = _vol(vol_shape)
    want = jw.SlidingWindowEngine(jfn, **kw)(None, vol, out_channels=2)
    got = tw.SlidingWindowEngine(tfn, device="cpu", **kw)(vol, out_channels=2)
    assert got.shape == want.shape == (*vol_shape, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "vol_shape,window,stride",
    [((20, 30, 25), (8, 12, 10), (6, 9, 8)), ((18, 20, 22), (8, 8, 8), (4, 4, 4)), ((6, 9, 7), (8, 12, 10), (6, 9, 8))],
    ids=["snap", "dividing", "small"],
)
def test_predict_volume_device_matches_jax(vol_shape, window, stride):
    jfn, tfn = linear_fns(window)
    vol = _vol((*vol_shape, 1), 1)
    want = np.asarray(jw.predict_volume_device(None, jnp.asarray(vol), jfn, window, stride, 3, 2))
    got = tw.predict_volume_device(tfn, torch.from_numpy(vol), window, stride, 3, 2).numpy()
    assert got.shape == want.shape == (*vol_shape, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_engine_with_tiny_mednext_matches_jax():
    cfg = graft._flagship_cfg(tiny=True)
    jm = jax_build(cfg)
    params = jax.tree.map(np.asarray, jax_init(jm, cfg, jax.random.PRNGKey(0)))
    model = build_model(cfg, device="cpu")
    load_flax_params(model, params["params"])
    kw = dict(window=(16, 32, 32), overlap=0.25, sw_batch_size=2)
    vol = _vol((20, 36, 40), 2)
    want = jw.SlidingWindowEngine(lambda p, w: jm.apply(p, w), **kw)(params, vol, out_channels=1)
    got = tw.SlidingWindowEngine(model, device="cpu", **kw)(vol, out_channels=1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_snap_normaliser_is_cached_per_shape_and_grid():
    _, tfn = linear_fns((8, 12, 10))
    eng = tw.SlidingWindowEngine(tfn, window=(8, 12, 10), overlap=0.25, device="cpu")
    vol = _vol((20, 30, 25))
    a = eng(vol, out_channels=2)
    eng(vol, out_channels=2)
    assert len(eng._invw_cache) == 1
    eng(_vol((21, 30, 25)), out_channels=2)
    assert len(eng._invw_cache) == 2
    np.testing.assert_array_equal(a, eng(vol, out_channels=2))


@pytest.mark.parametrize("mode", ["reflect", "replicate", "constant"])
def test_device_pad_matches_numpy(mode):
    vol = _vol((3, 5, 4, 2), 3)
    pads = [(2, 5), (0, 9), (4, 1)]
    want = np.pad(vol, pads + [(0, 0)], mode={"replicate": "edge"}.get(mode, mode))
    got = tw._pad_device(torch.from_numpy(vol), pads, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["reflect", "replicate", "constant"])
def test_pad_volume_to_roi_matches_jax(mode):
    vol = _vol((5, 14, 9, 2), 4)
    got, got_pads = tw.pad_volume_to_roi(vol, (8, 12, 10), mode)
    want, want_pads = jw.pad_volume_to_roi(vol, (8, 12, 10), mode)
    np.testing.assert_array_equal(got, want)
    assert got_pads == want_pads


def test_grid_and_importance_match_jax():
    for args in [((165, 1024, 768), (96, 128, 96), 0.125), ((50, 40, 30), (16, 16, 16), 0.5)]:
        np.testing.assert_array_equal(tw.compute_window_grid(*args), jw.compute_window_grid(*args))
    for blending in ("bump", "gaussian", "constant", "distance"):
        np.testing.assert_array_equal(tw.importance_map((8, 12, 10), blending), jw.importance_map((8, 12, 10), blending))
    assert len(tw.compute_window_grid((165, 1024, 768), (96, 128, 96), 0.125)) == 162
