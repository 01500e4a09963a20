"""The port's fused MLP with residual and pointwise conv
(``ops/fused_mlp.py``, plain path on the CPU) against the JAX package's
``fused_mlp_residual`` run in interpret mode, on the same seeded inputs.
Tolerances: f32, 1e-5 of the summed magnitudes (the products sum in another
order and tanh is another implementation); bf16, two ulps at the output's
largest magnitude (the hidden activation and the output are rounded to
bf16, so a value can land an ulp apart at each rounding)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pytorch_connectomics_tpu.ops import fused_mlp_pallas as fm
from pytorch_connectomics_tpu_torch.ops import fused_mlp as tm


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(m, c, e, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((m, c)).astype(np.float32),
        (rng.standard_normal((c, e)) / np.sqrt(c)).astype(np.float32),
        (0.3 * rng.standard_normal(e)).astype(np.float32),
        (rng.standard_normal((e, c)) / np.sqrt(e)).astype(np.float32),
        (0.3 * rng.standard_normal(c)).astype(np.float32),
    )


def _magnitude(x, w1, b1, w2, b2):
    """|x| + |b2| + (|x| |w1| + |b1| + |h|) |w2|: what the f32 sums and the
    GELU's input and output can lose precision against."""
    h = np.asarray(torch.nn.functional.gelu(torch.from_numpy(x @ w1 + b1), approximate="tanh"))
    return np.abs(x) + np.abs(b2) + (np.abs(x) @ np.abs(w1) + np.abs(b1) + np.abs(h)) @ np.abs(w2)


def _check(got, want, dtype, args):
    if dtype == "float32":
        mag = _magnitude(*args)
        assert np.all(np.abs(got - want) <= 1e-5 * mag), (np.abs(got - want) / mag).max()
    else:
        tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 6)  # two bf16 ulps
        assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# (M, C, E, Pallas block_rows): M a multiple of the row block, M ragged
# against it, MedNeXt's expansion ratio 2 and a wider ratio
CASES = [(64, 16, 32, 32), (37, 16, 48, 16), (50, 32, 64, 16), (9, 48, 192, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "M{}-C{}-E{}-rows{}".format(*c))
def test_fused_mlp_matches_jax(interpret_mode, case, dtype):
    m, c, e, rows = case
    args = _inputs(m, c, e, seed=m + c + e)
    x, w1, b1, w2, b2 = args
    jdt = jnp.dtype(dtype)
    want = fm.fused_mlp_residual(
        jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1), jnp.asarray(w2, jdt), jnp.asarray(b2),
        block_rows=rows,
    )
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = tm.fused_mlp_residual(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w1).to(tdt), torch.from_numpy(b1),
        torch.from_numpy(w2).to(tdt), torch.from_numpy(b2),
    )
    assert got.dtype == tdt and got.shape == (m, c)
    if dtype == "bfloat16":  # the rounded operands both sides multiply
        args = (_bf16(x), _bf16(w1), b1, _bf16(w2), b2)
    _check(got.float().numpy(), want, dtype, args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_ndhwc_matches_jax(interpret_mode, dtype):
    """The NDHWC wrappers flatten (B, Z, Y, X) to rows: 2*3*4*5 = 120 rows,
    ragged against the block of 32."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 4, 5, 16)).astype(np.float32)
    _, w1, b1, w2, b2 = _inputs(1, 16, 32, seed=8)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = fm.fused_mlp_residual_ndhwc(
        jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1), jnp.asarray(w2, jdt), jnp.asarray(b2),
        block_rows=32,
    )
    want = np.asarray(want.astype(jnp.float32))
    got = tm.fused_mlp_residual_ndhwc(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w1).to(tdt), torch.from_numpy(b1),
        torch.from_numpy(w2).to(tdt), torch.from_numpy(b2),
    )
    assert got.shape == x.shape and got.dtype == tdt
    flat = x.reshape(-1, 16)
    args = (flat, w1, b1, w2, b2) if dtype == "float32" else (_bf16(flat), _bf16(w1), b1, _bf16(w2), b2)
    _check(got.float().numpy().reshape(-1, 16), want.reshape(-1, 16), dtype, args)


def test_fused_mlp_bf16_biases_are_used_in_f32(interpret_mode):
    """Biases given in x's dtype are widened exactly, as ``.astype(f32)``
    does in the Pallas body."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(16, 16, 32, seed=3))
    xb, w1b, w2b = x.bfloat16(), w1.bfloat16(), w2.bfloat16()
    got = tm.fused_mlp_residual(xb, w1b, b1.bfloat16(), w2b, b2.bfloat16())
    want = tm.fused_mlp_residual(xb, w1b, b1.bfloat16().float(), w2b, b2.bfloat16().float())
    assert torch.equal(got, want)


def test_fused_mlp_refuses_grad_and_mixed_dtypes():
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(8, 16, 32, seed=1))
    with pytest.raises(RuntimeError, match="no backward pass"):
        tm.fused_mlp_residual(x, w1.clone().requires_grad_(True), b1, w2, b2)
    with pytest.raises(RuntimeError, match="no backward pass"):
        tm.pointwise(x.clone().requires_grad_(True), w1.t().contiguous())
    with torch.no_grad():
        assert tm.fused_mlp_residual(x, w1.clone().requires_grad_(True), b1, w2, b2).shape == (8, 16)
    # jnp.dot would promote mixed dtypes: a different function, refused
    with pytest.raises(TypeError, match="x's dtype"):
        tm.fused_mlp_residual(x, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(TypeError, match="x's dtype"):
        tm.fused_mlp_residual(x.bfloat16(), w1.bfloat16(), b1, w2, b2)
    with pytest.raises(TypeError, match="x's dtype"):
        tm.pointwise(x.bfloat16(), w1.t().contiguous())
    with pytest.raises(ValueError):
        tm.fused_mlp_residual(x, w1, b1, w2.t().contiguous(), b2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pointwise_is_the_first_product(dtype):
    """``pointwise(x, w)`` is ``x @ w.T`` rounded once: against numpy in f64
    on the rounded operands (f32: 1e-6 of the summed magnitudes; bf16: one
    rounding of the exact sum, so half an ulp, with one ulp allowed)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    w = (rng.standard_normal((48, 32)) / np.sqrt(32)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = tm.pointwise(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert got.shape == (2, 3, 4, 48) and got.dtype == tdt
    xr, wr = (x, w) if dtype == "float32" else (_bf16(x), _bf16(w))
    want = xr.astype(np.float64) @ wr.T.astype(np.float64)
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert np.all(err <= 1e-6 * (np.abs(xr) @ np.abs(wr).T))
    else:
        assert np.all(err <= 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7) + 1e-30)
