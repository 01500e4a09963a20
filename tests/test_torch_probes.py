"""The port's probe kernels (``ops/probes.py``, and the pointwise, depthwise
and dense 3^3 conv ops that stand in for the other prototypes; plain paths
on the CPU) against every Pallas kernel of the TPU probe scripts, run in
interpret mode at tiny shapes on the same seeded inputs.

The scripts run their TPU workloads when imported, so each kernel is taken
from its file with ``ast`` (never imported) and executed in a namespace of
its own. The CF-layout prototypes (the depthwise stencil of
``tpu_vpu_probe.py`` and the tap-matmul conv of
``tpu_bf16_experiments2.py``) are compared on the interior they define:
their halo planes and pad lanes carry no function.

Tolerances: the probe kernels exactly (see each test); the convolutions, f32
1e-5 of the summed magnitudes (sums in another order), bf16 two ulps at the
output's largest magnitude."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pytorch_connectomics_tpu.ops.fused_block_pallas import from_cf, to_cf
from pytorch_connectomics_tpu_torch.ops import conv3d as c3
from pytorch_connectomics_tpu_torch.ops import depthwise as dwk
from pytorch_connectomics_tpu_torch.ops import fused_mlp as tm
from pytorch_connectomics_tpu_torch.ops import probes

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
DTYPES = ["float32", "bfloat16"]


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def script_defs(name, *funcs, nested_in=None, **env):
    """The named functions of ``scripts/<name>`` (from inside function
    ``nested_in`` if given), executed without running the script."""
    tree = ast.parse((SCRIPTS / name).read_text())
    body = tree.body
    if nested_in:
        body = next(n for n in body if isinstance(n, ast.FunctionDef) and n.name == nested_in).body
    defs = [n for n in body if isinstance(n, ast.FunctionDef) and n.name in funcs]
    assert sorted(d.name for d in defs) == sorted(funcs), f"{name} no longer defines {funcs}"
    ns = dict(functools=functools, jax=jax, jnp=jnp, np=np, pl=pl, pltpu=pltpu, LANE=128, **env)
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(SCRIPTS / name), "exec"), ns)
    return ns


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jt(a, dtype):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _two_ulps(want):
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 6)


# ---------------------------------------------------------------------------
# FMA-rate probes (rows 6a, 6b)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_fma_chain_matches_the_vpu_probe(interpret_mode, dtype):
    """``_fma_kernel`` of ``tpu_vpu_probe.py:44``, 256 steps. Exact: under
    XLA on the CPU the f32 body ``acc + a * m`` contracts into one fused
    multiply-add per step, and the bf16 body rounds each step. The pins
    below show which: rounding the f32 product separately, or keeping the
    bf16 chain in f32 and rounding once, gives another result."""
    ns = script_defs("tpu_vpu_probe.py", "_fma_kernel")
    a = _rand((8, 128), seed=0)
    aj, at = _jt(a, dtype)
    f = pl.pallas_call(functools.partial(ns["_fma_kernel"], inner=256), out_shape=jax.ShapeDtypeStruct(aj.shape, aj.dtype))
    want = _np(f(aj))
    got = probes.fma_chain(at, 256)
    assert got.dtype == at.dtype and np.array_equal(_np(got), want)
    m = probes.multipliers(256, at.dtype).tolist()
    if dtype == "float32":
        per_op = torch.zeros_like(at)
        for mi in m:
            per_op = per_op + at * mi
        assert np.abs(_np(per_op) - want).max() > 0
    else:
        assert all(mi == 1.0 for mi in m)
        once = (at.float() * 256).bfloat16()
        assert np.abs(_np(once) - want).max() > 0


def test_fma_chain_refuses_bf16_steps_past_one():
    """Past 3907 steps a bf16 multiplier rounds above 1.0, where the
    kernel's single rounding and the body's two would differ."""
    assert bool((probes.multipliers(probes.BF16_MAX_INNER, torch.bfloat16) == 1).all())
    assert not bool((probes.multipliers(probes.BF16_MAX_INNER + 1, torch.bfloat16) == 1).all())
    a = torch.ones(16, dtype=torch.bfloat16)
    assert probes.fma_chain(a, 3907).float().max().item() == 256  # 256 + 1 rounds back to 256
    with pytest.raises(ValueError, match="3907"):
        probes.fma_chain(a, 3908)
    with pytest.raises(ValueError):
        probes.fma_chain(torch.ones(16), probes.MAX_INNER + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fma27_matches_the_microbench_vpu_probe(interpret_mode, dtype):
    """``vpu_kernel``/``vpu_probe`` of ``tpu_microbench.py:163,171`` (nested
    in its ``main``), the taps in SMEM. bf16 exact. f32 within 27 roundings
    of the summed magnitudes (27 * 2**-24 of sum |x w_t|): XLA on the CPU
    contracts some of the 27 steps into fused multiply-adds and not others,
    so neither the all-FMA chain the kernel runs nor per-op rounding
    matches it bit for bit (measured: within 2.4e-7 at outputs near 5)."""
    ns = script_defs("tpu_microbench.py", "vpu_kernel", "vpu_probe", nested_in="main", Y=8, XC=128)
    x = _rand((3, 8, 128), seed=1)
    w = _rand((27, 1), seed=2, scale=0.3)
    xj, xt = _jt(x, dtype)
    want = _np(ns["vpu_probe"](xj, jnp.asarray(w)))
    got = probes.fma27(xt, torch.from_numpy(w))
    assert got.dtype == xt.dtype
    if dtype == "bfloat16":
        assert np.array_equal(_np(got), want)
    else:
        mag = np.abs(_np(xt))[..., None] * np.abs(w[:, 0])
        assert np.all(np.abs(_np(got) - want) <= 27 * 2.0**-24 * mag.sum(-1))


# ---------------------------------------------------------------------------
# data movement (rows 7b, 7c, 7g)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,offset,circular", [("copy", 0, False), ("roll", 5, True), ("slice", -128, False)])
def test_lane_shift_matches_the_probe_kernel(interpret_mode, dtype, op, offset, circular):
    """``_probe_kernel`` of ``tpu_bf16_experiments.py:66``: a copy,
    ``pltpu.roll(a, 5)`` and ``jnp.pad(a[:, 128:])`` (a zero-filled shift
    that reads x + 128). Exact."""
    ns = script_defs("tpu_bf16_experiments.py", "_probe_kernel")
    aj, at = _jt(_rand((32, 384), seed=3), dtype)
    f = pl.pallas_call(functools.partial(ns["_probe_kernel"], op=op), out_shape=jax.ShapeDtypeStruct(aj.shape, aj.dtype))
    assert np.array_equal(_np(probes.lane_shift(at, offset, circular)), _np(f(aj)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_shift_matches_the_scratch_kernel(interpret_mode, dtype):
    """``_scratch_kernel`` of ``tpu_bf16_experiments.py:87`` stages three
    rolls in scratch and returns ``roll(a, 1)``. Exact."""
    ns = script_defs("tpu_bf16_experiments.py", "_scratch_kernel")
    aj, at = _jt(_rand((32, 256), seed=4), dtype)
    f = pl.pallas_call(
        ns["_scratch_kernel"], out_shape=jax.ShapeDtypeStruct(aj.shape, aj.dtype),
        scratch_shapes=[pltpu.VMEM((96, 256), aj.dtype)],
    )
    assert np.array_equal(_np(probes.lane_shift(at, 1, circular=True)), _np(f(aj)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_shift_matches_shift_lanes(interpret_mode, dtype):
    """``_shift_kernel`` of ``tpu_bf16_experiments2.py:68``:
    ``shift_lanes(a, 1)`` reads x + 1 with zero fill. Exact."""
    ns = script_defs("tpu_bf16_experiments2.py", "_shift_kernel", "shift_lanes")
    aj, at = _jt(_rand((16, 200), seed=5), dtype)
    f = pl.pallas_call(ns["_shift_kernel"], out_shape=jax.ShapeDtypeStruct(aj.shape, aj.dtype))
    assert np.array_equal(_np(probes.lane_shift(at, -1)), _np(f(aj)))
    for off in (-3, 0, 2):  # the function's other offsets, outside a kernel
        want = ns["shift_lanes"](aj, off, aj.shape[-1])
        assert np.array_equal(_np(probes.lane_shift(at, -off)), _np(want))


def test_lane_shift_plain_edges():
    x = torch.arange(12.0).reshape(2, 6)
    assert torch.equal(probes.lane_shift(x, 6), torch.zeros_like(x))
    assert torch.equal(probes.lane_shift(x, -9), torch.zeros_like(x))
    assert torch.equal(probes.lane_shift(x, 8, circular=True), torch.roll(x, 2, -1))
    assert torch.equal(probes.lane_shift(x, 2)[:, 2:], x[:, :4])


# ---------------------------------------------------------------------------
# the CF prototypes (rows 7a, 7d, 7e, 7f, 7h)
# ---------------------------------------------------------------------------

B, Z, Y, X, C = 1, 2, 3, 5, 8


def _cf_input(dtype, seed):
    """(x_cf for the prototype, channels-last torch x): x is (B, Z, Y, C, X)
    in the scripts' order before ``to_cf``."""
    x = _rand((B, Z, Y, C, X), seed)
    xj, xt = _jt(x, dtype)
    return to_cf(xj), xt.permute(0, 1, 2, 4, 3).contiguous()


def _interior(out_cf):
    """(B, Z, Y, X, C) interior of a CF output."""
    return _np(jnp.transpose(from_cf(out_cf, Y, X), (0, 1, 2, 4, 3)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_depthwise_matches_the_cf_stencil(interpret_mode, dtype):
    """``dw_cf`` of ``tpu_vpu_probe.py:102`` (kernel ``_dw_kernel``, lane
    rolls for x, lane slices for y, one block per z plane), no bias, against
    ``depthwise3x3`` on the interior."""
    ns = script_defs("tpu_vpu_probe.py", "_dw_kernel", "dw_cf")
    x_cf, xt = _cf_input(dtype, seed=6)
    w = _rand((27, C), seed=7, scale=0.3)  # tap t = (dz * 3 + dy) * 3 + dx
    want = _interior(ns["dw_cf"](x_cf, jnp.asarray(w), Y, Z))
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).reshape(C, 1, 3, 3, 3)
    got = dwk.depthwise3x3(xt, wt)
    assert got.dtype == xt.dtype
    got = _np(got)
    if dtype == "float32":
        mag = _np(dwk.depthwise3x3_plain(xt.abs(), wt.abs()))
        assert np.all(np.abs(got - want) <= 1e-5 * mag)
    else:
        assert np.abs(got - want).max() <= _two_ulps(want)


def _tap_weight(r, seed):
    """(wbig (9, R, 3C) of the tap-matmul prototypes, the same conv weight
    (R, C, 3, 3, 3)): wbig[dz * 3 + dy, r, dx * C + c] = w[r, c, dz, dy, dx]."""
    wbig = _rand((9, r, 3 * C), seed, scale=0.1)
    w = wbig.reshape(3, 3, r, 3, C).transpose(2, 4, 0, 1, 3)
    return wbig, torch.from_numpy(np.ascontiguousarray(w))


def test_the_first_tap_matmul_prototype_is_malformed(interpret_mode):
    """``apply_b16`` of ``tpu_bf16_experiments.py:146`` stores ``acc[:C]`` of
    shape (C, Y * 128) into a (C, (Y + 2) * 128) block: it does not run.
    ``apply_taps`` of ``tpu_bf16_experiments2.py:119`` is the script's own
    fixed version, and stands for it."""
    ns = script_defs("tpu_bf16_experiments.py", "_apply_b16_kernel", "apply_b16")
    x_cf, _ = _cf_input("float32", seed=8)
    wbig, _ = _tap_weight(16, seed=9)
    with pytest.raises(ValueError, match="shape"):
        ns["apply_b16"](x_cf, jnp.asarray(wbig), False, y_size=Y)


@pytest.mark.parametrize("variant", ["f32", "bf16-dot", "bf16-stage"])
def test_conv3d_matches_the_tap_matmul_prototype(interpret_mode, variant):
    """``apply_taps`` of ``tpu_bf16_experiments2.py:119``: a 3^3 conv C -> R
    as 9 tap matmuls over 3 lane-shifted copies, keeping the first C of R
    output channels; f32 operands, bf16 dot operands with an f32 output, or
    bf16 throughout. The port: ``conv3d_3x3`` C -> R, first C channels kept,
    in f32 or bf16 (whose output is rounded to bf16, two ulps from the
    f32 output of the bf16-dot variant)."""
    ns = script_defs("tpu_bf16_experiments2.py", "_apply_kernel", "apply_taps", "shift_lanes")
    r = 16
    dtype = "float32" if variant == "f32" else "bfloat16"
    x_cf, xt = _cf_input("float32" if variant != "bf16-stage" else "bfloat16", seed=10)
    wbig, w = _tap_weight(r, seed=11)
    wj = jnp.asarray(wbig, jnp.bfloat16 if variant == "bf16-stage" else jnp.float32)
    want = _interior(ns["apply_taps"](x_cf, wj, variant == "bf16-dot", y_size=Y))
    xt = xt.to(getattr(torch, dtype))
    got = c3.conv3d_3x3(xt, w)[..., :C]
    assert got.shape == (B, Z, Y, X, C)
    got = _np(got)
    if dtype == "float32":
        mag = _np(c3.conv3d_3x3_plain(xt.abs(), w.abs()))[..., :C]
        assert np.all(np.abs(got - want) <= 1e-5 * mag)
    else:
        assert np.abs(got - want).max() <= _two_ulps(want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("script,zb", [("tpu_bf16_experiments.py", None), ("tpu_bf16_experiments2.py", 2)])
def test_pointwise_matches_pw_cf(interpret_mode, dtype, script, zb):
    """``pw_cf`` of ``tpu_bf16_experiments.py:181`` and its z-blocked
    version of ``tpu_bf16_experiments2.py:171``: ``W (Cout, C) @ x`` per
    plane, f32 accumulation, no bias, against ``pointwise`` on the
    interior."""
    ns = script_defs(script, "_pw_kernel", "pw_cf")
    x_cf, xt = _cf_input(dtype, seed=12)
    wj, wt = _jt(_rand((16, C), seed=13, scale=0.3), dtype)
    out = ns["pw_cf"](x_cf, wj) if zb is None else ns["pw_cf"](x_cf, wj, zb)
    want = _interior(out)
    got = tm.pointwise(xt, wt)
    assert got.shape == (B, Z, Y, X, 16) and got.dtype == xt.dtype
    got = _np(got)
    if dtype == "float32":
        mag = _np(tm.pointwise_plain(xt.abs(), wt.abs()))
        assert np.all(np.abs(got - want) <= 1e-5 * mag)
    else:
        assert np.abs(got - want).max() <= _two_ulps(want)
