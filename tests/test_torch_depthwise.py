"""The port's depthwise 3^3 conv (``ops/depthwise.py``) against the JAX
package on the CPU: the plain version against the TPU kernel
``depthwise3x3_pallas`` in interpret mode and against the XLA path of
``depthwise3x3``; the autograd Function's ``dx``, ``dw`` and ``db`` against
``jax.vjp`` of the XLA depthwise conv; ``gradcheck`` in float64. Weights move
between flax's ``(3, 3, 3, 1, C)`` and the port's ``(C, 1, 3, 3, 3)``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pytorch_connectomics_tpu.ops import depthwise_pallas as dp
from pytorch_connectomics_tpu_torch.ops import depthwise as dw


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.random((3, 3, 3, 1, c)) - 0.5).astype(np.float32)  # flax layout
    b = rng.standard_normal(c).astype(np.float32)
    return x, w, b


def _port_w(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2))))


def _xla_conv(x, w, b):
    out = jax.lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        feature_group_count=x.shape[-1], precision=jax.lax.Precision.HIGHEST,
    )
    return out + b


def test_plain_matches_pallas_interpret(interpret_mode):
    x, w, b = _inputs((2, 6, 9, 33, 16))
    want = np.asarray(dp.depthwise3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), block=(4, 4, 16)))
    got = dw.depthwise3x3_plain(torch.from_numpy(x), _port_w(w), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_wrapper_matches_xla_path(bias):
    x, w, b = _inputs((2, 5, 7, 6, 24), seed=1)
    want = np.asarray(dp.depthwise3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None, force_pallas=False))
    got = dw.depthwise3x3(torch.from_numpy(x), _port_w(w), torch.from_numpy(b) if bias else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_function_gradients_match_jax_vjp():
    x, w, b = _inputs((2, 4, 5, 6, 8), seed=2)
    up = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(_xla_conv, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = (np.asarray(a) for a in vjp(jnp.asarray(up)))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _port_w(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    (dw.depthwise_conv3x3(xt, wt, bt) * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=1e-5, atol=1e-5 * np.abs(jdx).max())
    np.testing.assert_allclose(wt.grad.numpy(), np.transpose(jdw, (4, 3, 0, 1, 2)), rtol=1e-5, atol=1e-5 * np.abs(jdw).max())
    np.testing.assert_allclose(bt.grad.numpy(), jdb, rtol=1e-5, atol=1e-5 * np.abs(jdb).max())


def test_gradcheck_float64():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 3, 3, 4, 3))).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((3, 1, 3, 3, 3))).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal(3)).requires_grad_(True)
    assert torch.autograd.gradcheck(dw.depthwise_conv3x3, (x, w, b))


def test_wgrad_plain_is_the_weight_gradient():
    """The explicit 27-tap sum equals autograd's weight and bias gradient of
    the plain forward."""
    x, w, b = _inputs((2, 3, 4, 5, 6), seed=5)
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(x.shape).astype(np.float32))
    wt, bt = _port_w(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    (dw.depthwise3x3_plain(torch.from_numpy(x), wt, bt) * dy).sum().backward()
    gw, gb = dw.depthwise3x3_wgrad(torch.from_numpy(x), dy)
    torch.testing.assert_close(gw, wt.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gb, bt.grad, rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_grad():
    x, w, b = _inputs((1, 3, 3, 3, 4))
    xt = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        dw.depthwise3x3(xt, _port_w(w))
    with pytest.raises(RuntimeError, match="no backward pass"):
        dw.depthwise3x3_wgrad(xt, xt)
