"""The port's convolution placement, GroupNorm and GELU against the flax
modules the JAX MedNeXt uses, in f32 on the CPU. Pins the hazards of
flax's SAME rule: ConvTranspose(k=3, s=2) pads the dilated input (2, 1) and
correlates with the unflipped kernel; the stride-2 k3 depthwise conv pads
(0, 1) on even sizes; the k2 (1,2,2) head and the k1 residual transposes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pytorch_connectomics_tpu_torch.models.convert import conv_kernel, conv_transpose_kernel, linear_kernel
from pytorch_connectomics_tpu_torch.models.layers import (
    Norm,
    conv3d_same,
    conv_transpose3d_same,
    get_act,
    same_pads,
)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flax(module, x):
    params = module.init(__import__("jax").random.PRNGKey(1), jnp.asarray(x))
    return params["params"], np.asarray(module.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize(
    "kernel,stride,shape",
    [
        ((3, 3, 3), (2, 2, 2), (1, 3, 4, 5, 6)),  # up block of MedNeXt
        ((2, 2, 2), (2, 2, 2), (2, 3, 4, 2, 5)),  # (2,2,2) patchify head
        ((1, 2, 2), (1, 2, 2), (1, 4, 3, 5, 4)),  # (1,2,2) patchify head
        ((1, 1, 1), (2, 2, 2), (1, 3, 2, 4, 6)),  # strided residual of an up block
    ],
)
def test_conv_transpose_same_matches_flax(kernel, stride, shape):
    x = _x(shape)
    p, want = _flax(nn.ConvTranspose(7, kernel_size=kernel, strides=stride, padding="SAME"), x)
    got = conv_transpose3d_same(
        torch.from_numpy(x), conv_transpose_kernel(p["kernel"]), torch.from_numpy(np.asarray(p["bias"])), stride
    ).numpy()
    assert got.shape == want.shape == (shape[0], *(n * s for n, s in zip(shape[1:4], stride)), 7)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_conv_transpose_k3s2_is_not_symmetric_padding():
    """padding=1, output_padding=1 shifts the output by one voxel."""
    x = _x((1, 4, 4, 4, 3))
    p, want = _flax(nn.ConvTranspose(3, kernel_size=(3, 3, 3), strides=(2, 2, 2), padding="SAME"), x)
    naive = torch.nn.functional.conv_transpose3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), conv_transpose_kernel(p["kernel"]),
        torch.from_numpy(np.asarray(p["bias"])), stride=2, padding=1, output_padding=1,
    ).permute(0, 2, 3, 4, 1).numpy()
    assert np.abs(naive - want).max() > 1e-2


@pytest.mark.parametrize("shape", [(1, 8, 6, 4, 5), (1, 7, 5, 9, 5)], ids=["even", "odd"])
def test_strided_depthwise_same_matches_flax(shape):
    x = _x(shape, 2)
    c = shape[-1]
    p, want = _flax(nn.Conv(c, (3, 3, 3), strides=(2, 2, 2), padding="SAME", feature_group_count=c), x)
    got = conv3d_same(
        torch.from_numpy(x), conv_kernel(p["kernel"]), torch.from_numpy(np.asarray(p["bias"])), (2, 2, 2), groups=c
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert same_pads(8, 3, 2) == (0, 1) and same_pads(7, 3, 2) == (1, 1)


@pytest.mark.parametrize("stride", [(2, 2, 2), (1, 2, 2)])
def test_patchify_stem_matches_flax(stride):
    x = _x((2, 4, 6, 8, 1), 3)
    k = tuple(1 if s == 1 else 2 for s in stride)
    p, want = _flax(nn.Conv(5, k, strides=stride, padding="SAME"), x)
    got = conv3d_same(torch.from_numpy(x), conv_kernel(p["kernel"]), torch.from_numpy(np.asarray(p["bias"])), stride)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_pointwise_conv_as_linear_matches_flax():
    x = _x((1, 3, 4, 5, 6), 4)
    p, want = _flax(nn.Conv(9, (1, 1, 1)), x)
    got = torch.nn.functional.linear(
        torch.from_numpy(x), linear_kernel(p["kernel"]), torch.from_numpy(np.asarray(p["bias"]))
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_per_channel_groupnorm_matches_flax():
    x = _x((2, 3, 4, 5, 6), 5) * 3 + 1
    p, want = _flax(nn.GroupNorm(num_groups=6), x)
    rng = np.random.default_rng(6)
    scale, bias = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    want = np.asarray(nn.GroupNorm(num_groups=6).apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))
    norm = Norm(6)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert norm.eps == 1e-6


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(get_act("gelu")(torch.from_numpy(x)).numpy(), np.asarray(nn.gelu(jnp.asarray(x))), atol=1e-6)
