"""The port's fused MedNeXt block (plain versions of the two CUDA kernels)
against the JAX package's Pallas kernels, run in Pallas TPU interpret mode
on the CPU, and against its pure-XLA ``reference_block``.

Layouts: the JAX kernels take (B, Z, Y, C, X); the port takes channels-last
(B, Z, Y, X, C). Weights: w_dw (3,3,3,C) -> (C,1,3,3,3), w1 (C,R) -> (R,C),
w2 (R,Cout) -> (Cout,R). Tolerance: f32, atol 2e-4 (the JAX tests' own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_connectomics_tpu.ops.fused_block_pallas import (
    dw_stats as jax_dw_stats,
    fused_mednext_block,
    reference_block,
    to_cf,
)
from pytorch_connectomics_tpu_torch.ops import fused_block as fb

SHAPES = [((1, 6, 7, 8, 10), 8, 16), ((2, 5, 4, 16, 24), 16, 32)]


def _jax_params(seed, c, r, cout=None):
    cout = cout or c
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        w_dw=(rng.standard_normal((3, 3, 3, c)) * 0.3).astype(f),
        b_dw=(rng.standard_normal(c) * 0.1).astype(f),
        gamma=(1.0 + 0.1 * rng.standard_normal(c)).astype(f),
        beta=(0.1 * rng.standard_normal(c)).astype(f),
        w1=(rng.standard_normal((c, r)) / np.sqrt(c)).astype(f),
        b1=(0.1 * rng.standard_normal(r)).astype(f),
        w2=(rng.standard_normal((r, cout)) / np.sqrt(r)).astype(f),
        b2=(0.1 * rng.standard_normal(cout)).astype(f),
    )


def _port_params(p):
    t = torch.from_numpy
    return dict(
        w_dw=t(np.ascontiguousarray(p["w_dw"].transpose(3, 0, 1, 2)[:, None])),
        gamma=t(p["gamma"]),
        beta=t(p["beta"]),
        w1=t(np.ascontiguousarray(p["w1"].T)),
        b1=t(p["b1"]),
        w2=t(np.ascontiguousarray(p["w2"].T)),
        b2=t(p["b2"]),
    )


def _x(shape, seed=0):
    """(B, Z, Y, C, X) numpy input and its channels-last torch twin."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 2, 4, 3)))


@pytest.mark.parametrize("shape,c,r", SHAPES)
def test_dw_stats_matches_pallas(shape, c, r):
    x, xt = _x(shape)
    p = _jax_params(1, c, r)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_dw_stats(to_cf(jnp.asarray(x)), jnp.asarray(p["w_dw"]), shape[2], shape[4]))
    got = fb.dw_stats(xt, _port_params(p)["w_dw"]).numpy()
    assert got.shape == (shape[0], 2, c)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("shape,c,r", SHAPES)
def test_block_matches_pallas_and_reference(shape, c, r):
    x, xt = _x(shape, 2)
    p = _jax_params(3, c, r)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(fused_mednext_block(jnp.asarray(x), **jp))
    ref = np.asarray(reference_block(jnp.asarray(x), **jp))
    got = fb.fused_mednext_block(xt, **_port_params(p)).numpy().transpose(0, 1, 2, 4, 3)
    np.testing.assert_allclose(got, pallas, atol=2e-4)
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_block_changing_channels_matches_pallas():
    """Cout != C: no residual, as the Pallas apply kernel."""
    shape, c, r, cout = (1, 4, 5, 8, 6), 8, 16, 12
    x, xt = _x(shape, 4)
    p = _jax_params(5, c, r, cout)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(fused_mednext_block(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()}))
    got = fb.fused_mednext_block(xt, **_port_params(p)).numpy().transpose(0, 1, 2, 4, 3)
    assert got.shape == (1, 4, 5, cout, 6)
    np.testing.assert_allclose(got, pallas, atol=2e-4)


def test_chained_blocks_match_reference():
    c, r = 8, 16
    x, xt = _x((1, 5, 6, c, 12), 6)
    p1, p2 = _jax_params(7, c, r), _jax_params(8, c, r)
    j = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    want = np.asarray(reference_block(reference_block(jnp.asarray(x), **j(p1)), **j(p2)))
    got = fb.fused_mednext_block(fb.fused_mednext_block(xt, **_port_params(p1)), **_port_params(p2))
    np.testing.assert_allclose(got.numpy().transpose(0, 1, 2, 4, 3), want, atol=5e-4)


def test_bf16_plain_rounds_like_the_kernel():
    """bf16 input: output in bf16, within a few bf16 ulps of the f32 block."""
    x, xt = _x((1, 4, 6, 16, 8), 9)
    p = _port_params(_jax_params(10, 16, 32))
    got = fb.fused_mednext_block(xt.bfloat16(), **p)
    want = fb.fused_mednext_block(xt.bfloat16().float(), **p)
    assert got.dtype == torch.bfloat16
    top = want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


def test_cpu_tensors_run_plain_without_counting():
    fb.reset_launch_counts()
    x, xt = _x((1, 4, 4, 8, 4))
    fb.fused_mednext_block(xt, **_port_params(_jax_params(0, 8, 16)))
    assert fb.dw_stats.launches == 0 and fb.fused_block_apply.launches == 0


def test_non_cpu_tensor_never_falls_back():
    """Any tensor off the CPU goes to the kernel path: here (no CUDA build
    tools, a meta tensor) that raises instead of computing the plain version."""
    x = torch.empty((1, 4, 4, 4, 16), device="meta")
    w = torch.empty((16, 1, 3, 3, 3), device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        fb.dw_stats(x, w)
    with pytest.raises(TypeError):
        fb.dw_stats(x.half(), w)
