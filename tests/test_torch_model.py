"""The port's MedNeXt against flax ``MedNeXt.apply`` on the tiny config of
``__graft_entry__._flagship_cfg(tiny=True)``, weights carried over by
``models/convert.py`` (stock 1x1x1 stem and the bf16 case of the (1,2,2)
stem; the f32 patchify stems are in test_torch_model_patchify.py). f32: rtol 1e-4 and atol 1e-4 * max|ref|;
bf16 (rounding at other places in the two frameworks): atol 5e-2 * max|ref|."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.models.build import init_model as jax_init
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import flatten_flax, load_flax_params


def tiny_cfg(dtype="float32", stride=None):
    cfg = graft._flagship_cfg(tiny=True)
    cfg.compute_dtype = dtype
    if stride:
        cfg.mednext.patchify_stem = True
        cfg.mednext.patchify_stride = list(stride)
    return cfg


def run_pair(cfg, shape, seed=0, via_npz=None):
    cfg.input_size = list(shape[1:4])
    jm = jax_build(cfg)
    params = jax.tree.map(np.asarray, jax_init(jm, cfg, jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jm.apply(params, x))
    model = build_model(cfg, device="cpu", seed=seed + 1)
    if via_npz is not None:
        np.savez(via_npz, **flatten_flax(params))
        load_flax_params(model, via_npz)
    else:
        load_flax_params(model, params["params"])
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        plain = model(torch.from_numpy(x), plain=True)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, plain, rtol=0, atol=0)  # CPU runs the plain versions
    return got.numpy(), ref


def assert_close(got, ref, dtype):
    assert got.shape == ref.shape
    top = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * top)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * top)


def test_stock_stem_f32_matches_flax_via_npz(tmp_path):
    got, ref = run_pair(tiny_cfg(), (2, 16, 32, 32, 1), via_npz=tmp_path / "params.npz")
    assert_close(got, ref, "float32")


def test_patchify_122_bf16_matches_flax():
    got, ref = run_pair(tiny_cfg("bfloat16", (1, 2, 2)), (1, 16, 32, 32, 1), seed=5)
    assert_close(got, ref, "bfloat16")


def test_bridge_rejects_a_mismatched_tree(tmp_path):
    cfg = tiny_cfg()
    tree = {"stem": {"kernel": np.zeros((1, 1, 1, 1, 16), np.float32), "bias": np.zeros(16, np.float32)}}
    with pytest.raises(KeyError):
        load_flax_params(build_model(cfg, device="cpu"), tree)


def test_unported_options_raise():
    """Deep supervision, 2-D mode and kernel 5 are ported (the parity tests
    are tests/test_torch_mednext_2d.py, test_torch_mednext_k5.py and
    test_torch_deep_supervision.py): they build and run; an unknown patchify
    head still raises."""
    x = torch.zeros((1, 16, 16, 16, 1))
    for field, value in (("deep_supervision", True), ("dim", "2d"), ("kernel_size", 5)):
        cfg = tiny_cfg()
        setattr(cfg.mednext, field, value)
        with torch.no_grad():
            out = build_model(cfg, device="cpu")(x)
        if field == "deep_supervision":
            assert sorted(out) == ["ds_0", "ds_1", "ds_2", "out"] and out["ds_0"].shape[1] == 8
        else:
            assert out.shape == (1, 16, 16, 16, cfg.out_channels)
    cfg = tiny_cfg()
    cfg.mednext.patchify_stem, cfg.mednext.patchify_head = True, "conv"
    with pytest.raises(ValueError):
        build_model(cfg, device="cpu")
