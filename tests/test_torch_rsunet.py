"""The port's RSUNet and its layers against the JAX package's flax modules
on the CPU, weights carried over by ``models/convert.py``. f32: relative
error 1e-5 of max |ref| (sums in another order); bf16: 3% of max |ref|
(the frameworks round at other places: jax.image.resize rounds after each
axis, the port once; a rounding flip early in the net travels through
every later layer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.models import layers as jl
from pytorch_connectomics_tpu.models.rsunet import RSUNet as JaxRSUNet
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models import layers as pl_
from pytorch_connectomics_tpu_torch.models.convert import flatten_flax, load_flax_params
from pytorch_connectomics_tpu_torch.models.rsunet import RSUNet

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _jax_groups(c, groups=8):
    g = min(groups, c)
    while c % g != 0:
        g -= 1
    return g


@pytest.mark.parametrize("c", [28, 36, 48, 64, 12, 20])
def test_group_count_follows_jax(c):
    assert pl_.Norm(c, "group", 8).groups == _jax_groups(c)
    assert pl_.Norm(c, "group").groups == c  # MedNeXt's blocks: one group per channel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [28, 36, 20])
def test_group_norm_matches_flax(c, dtype):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 3, 4, 5, c)).astype(np.float32) * 2 + 1
    jn = jl.Norm("group", 8, dtype=jnp.dtype(dtype))
    params = jn.init(jax.random.PRNGKey(0), jnp.asarray(x, dtype))
    scale, bias = rng.standard_normal(c).astype(np.float32), rng.standard_normal(c).astype(np.float32)
    params = {"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}
    want = np.asarray(jn.apply(params, jnp.asarray(x, dtype)).astype(jnp.float32))
    n = pl_.Norm(c, "group", 8)
    with torch.no_grad():
        n.weight.copy_(torch.from_numpy(scale))
        n.bias.copy_(torch.from_numpy(bias))
        got = n(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    # f32: sums in another order; bf16: the same f32 statistics, one rounding
    # of the output, so at most one ulp apart
    tol = 1e-5 * np.abs(want).max() if dtype == "float32" else 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factors", [(2, 2, 2), (1, 2, 2)])
def test_resample_matches_jax(factors, dtype):
    x = np.random.default_rng(1).standard_normal((1, 4, 5, 6, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    down = np.asarray(jl.downsample(xj, factors).astype(jnp.float32))
    np.testing.assert_array_equal(pl_.downsample(xt, factors).float().numpy(), down)
    up = np.asarray(jl.upsample_trilinear(xj, factors).astype(jnp.float32))
    got = pl_.upsample_trilinear(xt, factors).float().numpy()
    # f32: interpolation weights 1/4, 3/4 in another order; bf16: JAX rounds
    # after each axis, the port once, up to two ulps apart
    tol = 1e-6 * np.abs(up).max() if dtype == "float32" else 2.0 ** (np.floor(np.log2(np.abs(up).max())) - 6)
    assert got.shape == up.shape and np.abs(got - up).max() <= tol


def _pair(kw, dtype, shape, seed=0, bias_scale=0.1):
    """flax RSUNet params (nonzero biases, so the bias path is checked), its
    output, and the port's RSUNet loaded with them."""
    jm = JaxRSUNet(in_channels=1, out_channels=3, dtype=jnp.dtype(dtype), **kw)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    rng = np.random.default_rng(seed + 1)
    flat = {k: v + bias_scale * rng.standard_normal(v.shape).astype(np.float32) if k.endswith("bias") else v
            for k, v in flatten_flax(params).items()}
    params = {}
    for k, v in flat.items():
        node = params
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)), np.float32)
    model = RSUNet(in_channels=1, out_channels=3, dtype=getattr(torch, dtype), **kw)
    load_flax_params(model, params)
    return model, x, want, flat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "kw,shape",
    [
        (dict(width=(12, 20, 28), iso=True), (2, 8, 16, 16, 1)),  # 6, 5 and 7 groups
        (dict(width=(8, 12, 16), depth_2d=1, down_factors=[[1, 2, 2], [2, 2, 2]]), (1, 6, 16, 12, 1)),  # SNEMI shape
    ],
    ids=["iso", "aniso"],
)
def test_rsunet_matches_flax(kw, shape, dtype):
    model, x, want, _ = _pair(kw, dtype, shape)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (*shape[:4], 3)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), (err, np.abs(want).max())


def test_resblock_conv_names():
    """flax names a ResBlock's second 3^3 conv Conv_1 when a 1x1x1 skip
    conv exists (the skip is Conv_0) and Conv_0 when none does; the bridge
    maps each to its own port weight."""
    model, _, _, flat = _pair(dict(width=(8, 12), iso=True), "float32", (1, 4, 8, 8, 1))
    assert flat["ResBlock_0/Conv_0/kernel"].shape == (3, 3, 3, 8, 8) and "ResBlock_0/Conv_1/kernel" not in flat
    assert flat["ResBlock_1/Conv_0/kernel"].shape == (1, 1, 1, 8, 12)  # bottleneck 8 -> 12: the skip
    assert flat["ResBlock_1/Conv_1/kernel"].shape == (3, 3, 3, 12, 12)
    assert flat["Conv_0/kernel"].shape == (1, 1, 1, 12, 8)  # decoder 1x1x1, top level
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["bottleneck.skip.weight"].numpy(), flat["ResBlock_1/Conv_0/kernel"][0, 0, 0].T)
    np.testing.assert_array_equal(
        sd["bottleneck.conv2.weight"].numpy(), np.transpose(flat["ResBlock_1/Conv_1/kernel"], (4, 3, 0, 1, 2))
    )
    np.testing.assert_array_equal(
        sd["enc.0.conv2.weight"].numpy(), np.transpose(flat["ResBlock_0/Conv_0/kernel"], (4, 3, 0, 1, 2))
    )
    assert model.enc[0].skip is None and model.bottleneck.skip is not None


def test_nucmm_config_builds_and_refuses_training():
    """The NucMM-Z config builds; under grad (training) the 3^3 convs run
    through the conv's autograd Function and every parameter gets a
    gradient, as the plain path's; with deep supervision it returns a dict,
    ``out`` alone at one level (the heads sit on levels above the finest)."""
    cfg = load_config("tutorials/nuc_nucmm.yaml", overrides=["model.rsunet.width=[8,12]"], mode="test")
    model = build_model(cfg.model, device="cpu", seed=0)
    assert isinstance(model, RSUNet) and model.factors == [(2, 2, 2)]
    assert [model.stem.norm.groups, model.bottleneck.norm2.groups] == [8, 6]
    x = torch.zeros((1, 8, 8, 8, 1))
    out = model(x)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    model.zero_grad(set_to_none=True)
    out = model(x, plain=True)  # the plain path stays differentiable
    out.sum().backward()
    assert model.stem.conv.weight.grad is not None
    cfg.model.loss.deep_supervision = True
    out = build_model(cfg.model, device="cpu")(x)
    assert list(out) == ["out"] and out["out"].shape == (1, 8, 8, 8, cfg.model.out_channels)
