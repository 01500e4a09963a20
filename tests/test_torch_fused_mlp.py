"""The port's fused MLP with residual and pointwise conv
(``ops/fused_mlp.py``, plain path on the CPU) against the JAX package's
``fused_mlp_residual`` run in interpret mode, on the same seeded inputs.
Tolerances: f32, 1e-5 of the summed magnitudes (the products sum in another
order and tanh is another implementation); bf16, two ulps at the output's
largest magnitude (the hidden activation and the output are rounded to
bf16, so a value can land an ulp apart at each rounding)."""

import functools
import importlib.util
from pathlib import Path

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
# against it, MedNeXt's expansion ratio 2 and a wider ratio, and widths that
# are not multiples of 16 (the kernel pads its weights to the plan's widths)
CASES = [(64, 16, 32, 32), (37, 16, 48, 16), (50, 32, 64, 16), (9, 48, 192, 8), (40, 24, 40, 16), (9, 8, 24, 8)]


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


# ---------------------------------------------------------------------------
# the planner (pure Python, the same on any machine)
# ---------------------------------------------------------------------------

# (M, C, E): MedNeXt-S's five widths at the fast recipe's batch-16 row counts,
# and the microbench's stage 0 (8 x 112^3 rows)
WIDTHS = [(4718592, 32, 64), (589824, 64, 128), (73728, 128, 256), (9216, 256, 512), (1152, 512, 1024),
          (11239424, 32, 64)]
SMS = 132
# the SMs clusters of a size can reach (16-18 SMs a GPC: two clusters of 8 a
# GPC, one of 16), as the planner's model takes them
CLUSTER_SMS = {1: 132, 2: 132, 4: 128, 8: 128, 16: 112}
DTYPES = [torch.bfloat16, torch.float32]


def _card_shapes():
    """(M, C, E) of the card tests' shape list and forced plans."""
    spec = importlib.util.spec_from_file_location("card_tests", Path(__file__).with_name("test_torch_kernels_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.MLP_SHAPES, mod.FORCED


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("width", WIDTHS, ids=lambda w: "M{}-C{}-E{}".format(*w))
def test_kernel_plan_fits_and_fills_the_card(width, dtype):
    """The plan's shared memory fits a block; the weights' padded widths
    cover C and E; its blocks give every SM of the card work (a cluster's
    blocks count once a tile; the warp kernel's blocks hold eight 16-row
    fragments)."""
    m, c, e = width
    p = tm.kernel_plan(m, c, e, dtype)
    assert p["smem_bytes"] == tm.plan_smem(p) <= 232448
    assert p["cq"] >= c and p["eq"] >= e
    if dtype == torch.float32:
        units, sms = p["tiles"] * (p["cq"] // p["cb"]), SMS
    elif p["wk"]:
        units, sms = -(-m // 16) // 8, SMS
    else:
        units, sms = p["tiles"] * p["cs"], CLUSTER_SMS[p["cs"]]
    assert units >= sms, p


@pytest.mark.parametrize("width", WIDTHS, ids=lambda w: "M{}-C{}-E{}".format(*w))
def test_kernel_plan_clusters_split_e_once(width):
    """bf16: a cluster of 1, 2, 4 or 8 blocks, and 16 only where 8 blocks
    cannot keep their slices of W1 and W2 in shared memory; the blocks'
    E-slices cover the padded E exactly once, each with real hidden units."""
    m, c, e = width
    p = tm.kernel_plan(m, c, e, torch.bfloat16)
    assert p["cs"] in (1, 2, 4, 8, 16)
    if p["cs"] == 16:
        assert 4 * p["cq"] * p["eq"] // 8 > 232448, p
    slices = [range(r * p["es"], (r + 1) * p["es"]) for r in range(p["cs"])]
    assert sorted(i for s in slices for i in s) == list(range(p["eq"]))
    assert all(s.start < e for s in slices)
    assert p["es"] % p["ec"] == 0 and p["ec"] % 16 == 0


def test_every_plan_fits_shared_memory():
    """Every plan the planner offers at the five widths fits a block and
    holds together: resident weights or a ring of two streamed chunks beside
    two x slots, the warps' rows and columns, a cluster's tile rows."""
    for m, c, e in WIDTHS:
        for dtype in DTYPES:
            for p in tm.plans(m, c, e, dtype):
                assert p["smem_bytes"] == tm.plan_smem(p) <= 232448
                if dtype == torch.float32:
                    assert p["bm"] == 16 * p["rh"] * 256 // (4 * p["eh"]) and p["eq"] % p["eh"] == 0
                    continue
                assert p["mf"] * p["wn"] == 8 and p["bm"] == 16 * p["mf"]
                assert p["npw"] * p["wn"] >= p["cq"] // 16 and p["npw"] <= p["np"]
                assert p["nbuf"] == 1 and p["ec"] == p["es"] or p["nbuf"] == 2 and p["xr"] == 2
                if p["cs"] > 1:
                    assert p["np"] == 8 and p["bm"] >= p["cs"]


def test_a_plan_exists_for_every_card_test_shape():
    """Every (M, C, E) that the card tests run has a plan in both dtypes,
    and every forced plan of theirs is one the planner offers."""
    shapes, forced = _card_shapes()
    for m, c, e in shapes:
        for dtype in DTYPES:
            assert tm.kernel_plan(m, c, e, dtype)["smem_bytes"] <= 232448
    for m, c, e, dtype, want in forced:
        assert any(all(p[k] == v for k, v in want.items()) for p in tm.plans(m, c, e, dtype)), (m, c, e, want)


def test_kernel_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(RuntimeError, match="shape not supported"):
        tm.kernel_plan(16, 2048, 16, torch.bfloat16)
    with pytest.raises(TypeError):
        tm.kernel_plan(16, 32, 64, torch.float16)
    with pytest.raises(ValueError):
        tm.kernel_plan(0, 32, 64, torch.bfloat16)
