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


# ---------------------------------------------------------------------------
# the kernels' decomposition (csrc/mednext_block.cu) emulated in PyTorch
# ---------------------------------------------------------------------------
#
# Work items (b, segment, band), slabs staged with zero-filled halos into
# ring slots in the kernels' order, runs of three x outputs, per-item
# partial sums reduced in a fixed order; the apply pass's u tile of 16-row
# fragments, units of cs output channels, weight chunks of rc hidden units
# walked 16 at a time, the residual from the ring's centre slab, and only
# the band's rows inside the volume stored.


def _stage(xf, b, z, y0, g):
    """Slab z of the band at y0: (ty + 2, xp, C), zero outside the volume."""
    _, zs, ys, xs, c = xf.shape
    slab = torch.zeros(g["ty"] + 2, g["xp"], c)
    if 0 <= z < zs:
        lo, hi = max(y0 - 1, 0), min(y0 + g["ty"] + 1, ys)
        slab[lo - (y0 - 1) : hi - (y0 - 1), 1 : 1 + xs] = xf[b, z, lo:hi]
    return slab


def _stencil(slabs, taps, g):
    """dw(x) of every run output of the band: (ty, 3 * nrx, C), taps in the
    order dz, dy, dx."""
    ty, w = g["ty"], fb.RUN * g["nrx"]
    acc = torch.zeros(ty, w, taps.shape[0])
    for dz, s in enumerate(slabs):
        for dy in range(3):
            for dx in range(3):
                acc = acc + taps[:, dz * 9 + dy * 3 + dx] * s[dy : dy + ty, dx : dx + w]
    return acc


def _walk(x, plan, ring):
    """Yield (item, b, y0, z, slabs of z - 1 .. z + 1, refill) in the
    kernels' order; ``refill()`` stages slab z + 2 into the slot of z - 1
    (or z - 2 in a four-slot ring), as the kernel does after the stencil."""
    bsz, zs = x.shape[0], x.shape[1]
    g = fb.ring_geometry(x.shape, plan["ty"], plan["seg"])
    xf = x.float()
    for item in range(g["items"]):
        band, t = item % g["bands"], item // g["bands"]
        s, b = t % g["segs"], t // g["segs"]
        y0, z0 = band * g["ty"], s * g["seg"]
        z1 = min(z0 + g["seg"], zs)
        slots = [None] * ring
        for d in range(3):
            slots[d] = _stage(xf, b, z0 - 1 + d, y0, g)
        for z in range(z0, z1):
            def refill(z=z):
                if z + 2 <= z1:
                    slots[(z + 3 - z0) % ring] = _stage(xf, b, z + 2, y0, g)
            cur = [slots[(z - z0 + d) % ring] for d in range(3)]
            yield item, b, y0, z, cur, refill, g


def emulate_dw_stats(x, w_dw, plan):
    b, zs, ys, xs, c = x.shape
    taps = w_dw.float().reshape(c, 27)
    g = fb.ring_geometry(x.shape, plan["ty"], plan["seg"])
    partial = torch.zeros(g["items"], 2, c)
    ring = plan.get("ring", 4)
    for item, _, y0, _, slabs, refill, g in _walk(x, plan, ring):
        if ring == 4:
            refill()  # four slots: slab z + 2 is staged before the stencil of z
        t = _stencil(slabs, taps, g)[: min(g["ty"], ys - y0), :xs]
        if ring == 3:
            refill()
        partial[item, 0] += t.sum((0, 1))
        partial[item, 1] += (t * t).sum((0, 1))
    parts = partial.view(b, -1, 2, c)
    out = torch.zeros(b, 2, c)
    for p in range(parts.shape[1]):  # fixed order
        out += parts[:, p]
    return out


def emulate_apply(x, stats, w_dw, gamma, beta, w1, b1, w2, b2, plan, eps=fb.EPS):
    bsz, zs, ys, xs, c = x.shape
    r, cout = w1.shape[0], w2.shape[0]
    dt = x.dtype
    taps = w_dw.float().reshape(c, 27)
    n = zs * ys * xs
    mean = stats[:, 0] / n
    var = torch.clamp(stats[:, 1] / n - mean * mean, min=0.0)
    scale = gamma[None] * torch.rsqrt(var + eps)
    shift = beta[None] - mean * scale
    cs, rc = plan["cs"], plan["rc"]
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    out = torch.full((bsz, zs, ys, xs, cout), float("nan"), dtype=dt)
    for _, b, y0, z, slabs, refill, g in _walk(x, plan, fb.APPLY_RING):
        ty = g["ty"]
        mf = -(-ty * xs // 16)
        t = _stencil(slabs, taps, g)[:, :xs].reshape(ty * xs, c)
        u = torch.zeros(16 * mf, c)
        u[: ty * xs] = (t * scale[b] + shift[b]).to(dt).float()
        refill()  # the three-slot ring stages z + 2 after the stencil
        centre = slabs[1][1 : ty + 1, 1 : xs + 1].reshape(ty * xs, c)
        mv = min(ty, ys - y0) * xs
        for unit in range(mf * (cout // cs)):
            m0, n0 = (unit % mf) * 16, (unit // mf) * cs
            acc = torch.zeros(16, cs)
            for ch in range(r // rc):
                for rr in range(0, rc, 16):
                    k = ch * rc + rr
                    h = F.gelu(u[m0 : m0 + 16] @ w1f[k : k + 16].t() + b1[k : k + 16], approximate="tanh")
                    acc += h.to(dt).float() @ w2f[n0 : n0 + cs, k : k + 16].t()
            o = acc + b2[n0 : n0 + cs]
            if cout == c:
                rows = min(16, ty * xs - m0)
                o[:rows] += centre[m0 : m0 + rows, n0 : n0 + cs]
            for i in range(16):
                row = m0 + i
                if row < mv:
                    out[b, z, y0 + row // xs, row % xs, n0 : n0 + cs] = o[i].to(dt)
    return out


import torch.nn.functional as F  # noqa: E402

# (x shape, R, Cout, ty, seg, cs, rc): y not a multiple of ty, z not a
# multiple of seg, odd x, weights streamed in chunks and resident, a
# channel-changing block, several units across Cout
EMU_CASES = [
    ((2, 5, 7, 9, 16), 32, 16, 3, 2, 16, 16),
    ((1, 4, 6, 10, 32), 64, 48, 4, 3, 16, 64),
    ((1, 3, 5, 7, 32), 32, 32, 2, 1, 32, 32),
]
EMU_RINGS = {0: 4, 1: 3, 2: 4}  # the statistics pass's ring slots of each case


def _emu_inputs(shape, r, cout, dtype, seed):
    x, xt = _x((shape[0], shape[1], shape[2], shape[4], shape[3]), seed)
    p = _port_params(_jax_params(seed + 1, shape[4], r, cout))
    p.update(w1=p["w1"].to(dtype), w2=p["w2"].to(dtype))
    return x, xt.to(dtype), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "x".join(map(str, c[0])))
def test_emulated_decomposition_matches_plain(case, dtype):
    shape, r, cout, ty, seg, cs, rc = case
    _, xt, p = _emu_inputs(shape, r, cout, dtype, 11)
    plan = dict(ty=ty, seg=seg, cs=cs, rc=rc, ring=EMU_RINGS[EMU_CASES.index(case)])
    stats = emulate_dw_stats(xt, p["w_dw"], plan)
    want_stats = fb.dw_stats_plain(xt, p["w_dw"])
    mag = fb.dw_stats_plain(xt.abs(), p["w_dw"].abs())[:, :1] + want_stats[:, 1:]
    assert torch.all((stats - want_stats).abs() <= 1e-5 * mag)
    got = emulate_apply(xt, want_stats, **p, plan=plan)
    want = fb.fused_block_apply_plain(xt, want_stats, **p)
    assert not torch.isnan(got.float()).any()  # every output voxel written once
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    tol = 2e-4 if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(max(top, 1.0))) - 6)
    assert err <= tol, (err, tol)


def test_emulated_decomposition_matches_pallas():
    """The emulated kernels (the planner's own plan, and a ragged one)
    against the JAX package's Pallas kernels in interpret mode, float32."""
    shape, r, cout = (1, 5, 7, 9, 16), 32, 16
    x, xt, p = _emu_inputs(shape, r, cout, torch.float32, 21)
    jp = {k: jnp.asarray(v) for k, v in _jax_params(22, 16, r, cout).items()}
    with pltpu.force_tpu_interpret_mode():
        want_stats = np.asarray(jax_dw_stats(to_cf(jnp.asarray(x)), jp["w_dw"], shape[2], shape[3]))
        want = np.asarray(fused_mednext_block(jnp.asarray(x), **jp))
    pt = _port_params(_jax_params(22, 16, r, cout))
    for plan in (fb.apply_plan(shape, r, cout), dict(ty=3, seg=2, cs=16, rc=16)):
        stats = emulate_dw_stats(xt, pt["w_dw"], plan)
        np.testing.assert_allclose(stats.numpy(), want_stats, rtol=1e-5, atol=2e-4)
        got = emulate_apply(xt, stats, **pt, plan=plan)
        np.testing.assert_allclose(got.numpy().transpose(0, 1, 2, 4, 3), want, atol=2e-4)


# (C, R, (Z, Y, X)) of the stride-1 MedNeXt-S stages on the fast recipe's
# window after the (1, 2, 2) stem, at its batch of 16
FAST_STAGES = [(32, 64, (96, 64, 48)), (64, 128, (48, 32, 24)), (128, 256, (24, 16, 12)), (256, 512, (12, 8, 6)),
               (512, 1024, (6, 4, 3))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", FAST_STAGES, ids=lambda s: f"c{s[0]}")
def test_planner_covers_the_fast_recipe(stage, dtype):
    c, r, spatial = stage
    shape = (16, *spatial, c)
    plan = fb.kernel_plan(shape, dtype, r)
    for name in ("dw_stats", "fused_block_apply"):
        k = plan[name]
        if k["kernel"] == "f32_check":
            continue
        assert k["smem_bytes"] <= fb.MAX_SMEM
        g = fb.ring_geometry(shape, k["ty"], k["seg"])
        assert g["bands"] * k["ty"] >= spatial[1] and g["segs"] * k["seg"] >= spatial[0]
        assert g["items"] == k["items"] and g["xp"] >= spatial[2] + 2
    a = plan["fused_block_apply"]
    if dtype == torch.bfloat16:
        assert c % a["cs"] == 0 and r % a["rc"] == 0 and a["units"] == a["mf"] * a["ns"]
        assert a["smem_bytes"] == fb.apply_smem(shape, r, c, a["ty"], a["cs"], a["rc"])
    else:
        assert a["kernel"] == "f32_check"
    s = plan["dw_stats"]
    assert s["smem_bytes"] == fb.stats_smem(shape, 2 if dtype == torch.bfloat16 else 4, s["ty"], s["ring"])


def test_planner_takes_every_width():
    """Every width the wrappers take (C a multiple of 16 up to 1024) has a
    plan at MedNeXt's widest rows (X 3 at C 512; a ring slab holds whole
    rows of x); at X 5 the statistics pass takes every width in bf16, and
    in float32 every width whose haloed tile fitted the first design (C <=
    688: three z-runs of 16 + 2 X + 2 voxels)."""
    for c in range(16, 1025, 16):
        shape = (2, 3, 3, 5, c)
        assert fb.stats_plan(shape, torch.bfloat16)["smem_bytes"] <= fb.MAX_SMEM
        if 3 * (16 + 2 * 5 + 2) * c * 4 <= fb.MAX_SMEM:
            assert fb.stats_plan(shape, torch.float32)["smem_bytes"] <= fb.MAX_SMEM
        narrow = (2, 3, 3, 3, c)
        assert fb.stats_plan(narrow, torch.float32)["smem_bytes"] <= fb.MAX_SMEM
        assert fb.apply_plan(narrow, 4 * c, c)["smem_bytes"] <= fb.MAX_SMEM
