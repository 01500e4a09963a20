"""The depthwise kernels' decomposition (``csrc/depthwise3x3.cu`` on the
slab ring of ``csrc/ring.cuh``) emulated in PyTorch on the CPU, and the
planner that sizes it (``ops/depthwise.py::kernel_plan``).

The emulation walks the work items (b, segment, y band, x band) in the
kernels' order, stages slabs of x with zero-filled halos into ring slots (and, for
the weight gradient, slabs of dy at the band's outputs, zero outside the
volume, into a ring of two slots beside four x slots, one beside three),
runs the stencil over runs of three x outputs, stores only the band's
outputs inside the volume, stores the weight gradient's partials from the
active threads only (as ``lanes_of`` in ring.cuh assigns them), and sums the weight
gradient's per-slot and per-item partials in the kernels' fixed orders. It
is held against the plain versions at ragged plans, in both dtypes, and in
float32 against the TPU kernel ``depthwise3x3_pallas`` in interpret mode and
``jax.vjp`` of the XLA depthwise conv. Tolerances: bf16 two ulps at the
largest output (both sum in f32 and round once); f32 1e-5 of the summed
magnitudes (sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pytorch_connectomics_tpu.ops import depthwise_pallas as dp
from pytorch_connectomics_tpu_torch.ops import depthwise as dw
from pytorch_connectomics_tpu_torch.ops import fused_block as fb
from pytorch_connectomics_tpu_torch.tools import microbench
from test_torch_fused_block import TUTORIAL_WINDOWS, _stage, _window_id, check_tiling, item_origin, mednext_stages


def _stage_dy(df, b, z, y0, x0, g):
    """The dy slab of the band's outputs at z: (ty, tx, C), zero outside."""
    _, _, ys, xs, c = df.shape
    slab = torch.zeros(g["ty"], g["tx"], c)
    hi, xhi = min(y0 + g["ty"], ys), min(x0 + g["tx"], xs)
    slab[: hi - y0, : xhi - x0] = df[b, z, y0:hi, x0:xhi]
    return slab


def _walk(x, plan, dy=None):
    """Yield (item, b, y0, x0, z, x slabs of z - 1 .. z + 1, dy slab of z, g)
    in the kernels' order: x slab z in ring slot (z - z0 + 1) % ring, staged
    two steps ahead; dy slab z in slot (z - z0) % (ring - 2), staged one
    step ahead."""
    ring = plan["ring"]
    g = fb.ring_geometry(x.shape, plan["ty"], plan["seg"], plan.get("tx"))
    xf = x.float()
    df = None if dy is None else dy.float()
    for item in range(g["items"]):
        b, s, band, xband = item_origin(g, item)
        y0, x0, z0 = band * g["ty"], xband * g["tx"], s * g["seg"]
        z1 = min(z0 + g["seg"], x.shape[1])
        slots = [None] * ring
        dslots = [None] * (ring - 2)
        for d in range(3):
            slots[d] = _stage(xf, b, z0 - 1 + d, y0, x0, g)
        if df is not None:
            dslots[0] = _stage_dy(df, b, z0, y0, x0, g)
        for z in range(z0, z1):
            cur = [slots[(z - z0 + d) % ring] for d in range(3)]
            dcur = None if df is None else dslots[(z - z0) % (ring - 2)]
            yield item, b, y0, x0, z, cur, dcur, g
            if z + 2 <= z1:
                slots[(z + 3 - z0) % ring] = _stage(xf, b, z + 2, y0, x0, g)
            if df is not None and z + 1 < z1:
                dslots[(z + 1 - z0) % (ring - 2)] = _stage_dy(df, b, z + 1, y0, x0, g)


def emulate_fwd(x, w, bias, plan, mirror=False):
    """The forward kernel: every run output of each band row, the bias added
    in f32 and rounded once; only outputs inside the volume are stored."""
    _, _, ys, xs, c = x.shape
    taps = w.float().reshape(c, 27)
    if mirror:
        taps = taps.flip(1)
    bb = torch.zeros(c) if bias is None else bias.float()
    out = torch.full(x.shape, float("nan"), dtype=x.dtype)
    for _, b, y0, x0, z, slabs, _, g in _walk(x, plan):
        ty, wd = g["ty"], g["tx"]
        acc = torch.zeros(ty, wd, c)
        for dz, s in enumerate(slabs):
            for dy in range(3):
                for dx in range(3):
                    acc = acc + taps[:, dz * 9 + dy * 3 + dx] * s[dy : dy + ty, dx : dx + wd]
        yv, xv = min(ty, ys - y0), min(g["tw"], xs - x0)
        out[b, z, y0 : y0 + yv, x0 : x0 + xv] = (acc[:yv, :xv] + bb).to(x.dtype)
    return out


def _lanes(c):
    """Each thread's (channel pair, run slot, active) and the slot count tv,
    as ``lanes_of`` in ring.cuh: pt = min(C / 2, threads) pairs, tv =
    threads // pt slots; threads past tv * pt are inactive."""
    pt = min(c // 2, fb.THREADS)
    tv = fb.THREADS // pt
    return [(t % pt, t // pt, t // pt < tv) for t in range(fb.THREADS)], tv


def emulate_wgrad(x, dy, plan):
    """The weight-gradient kernels: per item, each run slot's 28 sums (run r
    belongs to slot r % tv), added in slot order into the item's partial
    (where one slot covers the band, each active thread stores its own
    pair's sums, and no pair is stored twice); the items' partials summed as
    32 interleaved sums (item i into sum i % 32), then those 32 in order.
    Returns (dw (C, 1, 3, 3, 3), db (C,))."""
    c = x.shape[-1]
    lanes, tv = _lanes(c)
    g0 = fb.ring_geometry(x.shape, plan["ty"], plan["seg"], plan.get("tx"))
    partial = torch.zeros(g0["items"], dw.ROWS, c)
    for item, _, _, _, _, slabs, d, g in _walk(x, plan, dy):
        ty, nrx = g["ty"], g["nrx"]
        runs = torch.zeros(ty * nrx, dw.ROWS, c)
        for dz, s in enumerate(slabs):
            for dyy in range(3):
                for dx in range(3):
                    prod = s[dyy : dyy + ty, dx : dx + fb.RUN * nrx] * d  # (ty, 3 nrx, C)
                    runs[:, dz * 9 + dyy * 3 + dx] = prod.reshape(ty * nrx, fb.RUN, c).sum(1)
        runs[:, 27] = d.reshape(ty * nrx, fb.RUN, c).sum(1)
        slots = torch.zeros(tv, dw.ROWS, c).index_add_(0, torch.arange(ty * nrx) % tv, runs)
        if tv == 1:
            stores = torch.zeros(c // 2, dtype=torch.int64)
            for p, _, active in lanes:
                if active:
                    partial[item, :, 2 * p : 2 * p + 2] += slots[0, :, 2 * p : 2 * p + 2]
                    stores[p] += 1
            assert torch.all(stores == 1), stores
            continue
        for r in range(tv):  # slot order
            partial[item] += slots[r]
    sums = torch.zeros(32, dw.ROWS, c)
    for i in range(g0["items"]):
        sums[i % 32] += partial[i]
    out = torch.zeros(dw.ROWS, c)
    for r in range(32):
        out += sums[r]
    return out[:27].t().reshape(c, 1, 3, 3, 3), out[27]


# (x shape, ty, seg, ring slots[, tx]): y not a multiple of ty, z not of seg,
# x not of 3, x = 1, batch 2, a band taller than the volume, one slab a
# segment, one slot a band with threads left over (C 272); bands of x that
# do not divide X, one a single run, with both ring sizes
RING_CASES = [
    ((2, 5, 7, 10, 16), 3, 2, 4),
    ((1, 4, 5, 1, 32), 2, 3, 3),
    ((2, 3, 4, 5, 48), 8, 1, 4),
    ((2, 6, 2, 2, 32), 1, 4, 3),
    ((2, 4, 3, 5, 272), 2, 2, 3),
    ((2, 5, 6, 13, 16), 4, 2, 4, 6),
    ((1, 4, 3, 11, 32), 2, 3, 3, 3),
    ((2, 3, 5, 8, 272), 2, 2, 4, 6),
]


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((c, 1, 3, 3, 3)) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    return x, dy, w, b


def _fwd_tol(x, w, want):
    if want.dtype == torch.float32:
        return 1e-5 * dw.depthwise3x3_plain(x.float().abs(), w.abs()).abs().max().item()
    top = want.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES, ids=lambda c: "x".join(map(str, c[0])))
def test_emulated_forward_matches_plain(case, dtype):
    shape, ty, seg, ring = case[:4]
    x, dy, w, b = _inputs(shape, dtype, 1)
    plan = dict(ty=ty, seg=seg, ring=ring, tx=case[4] if len(case) > 4 else None)
    for args, mirror, ref in (((x, w, b), False, (x, w, b)), ((dy, w, None), True, (dy, w.flip((2, 3, 4)), None))):
        got = emulate_fwd(*args, plan, mirror=mirror)
        want = dw.depthwise3x3_plain(*ref)
        assert not torch.isnan(got.float()).any()  # every output written
        err = (got.float() - want.float()).abs().max().item()
        tol = _fwd_tol(ref[0], ref[1], want)
        assert err <= tol, (mirror, err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES, ids=lambda c: "x".join(map(str, c[0])))
def test_emulated_wgrad_matches_plain(case, dtype):
    shape, ty, seg, ring = case[:4]
    x, dy, _, _ = _inputs(shape, dtype, 2)
    gw, gb = emulate_wgrad(x, dy, dict(ty=ty, seg=seg, ring=ring, tx=case[4] if len(case) > 4 else None))
    ww, wb = dw.depthwise3x3_wgrad_plain(x, dy)
    mw, mb = dw.depthwise3x3_wgrad_plain(x.float().abs(), dy.float().abs())
    assert torch.all((gw - ww).abs() <= 1e-5 * mw + 1e-6), ((gw - ww).abs() / mw).max().item()
    assert torch.all((gb - wb).abs() <= 1e-5 * mb + 1e-6), ((gb - wb).abs() / mb).max().item()


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _flax_w(w):
    """(C, 1, 3, 3, 3) -> flax's (3, 3, 3, 1, C)."""
    return jnp.asarray(np.transpose(w.numpy(), (2, 3, 4, 1, 0)))


def test_emulated_forward_matches_pallas(interpret_mode):
    """The emulated forward (the planner's plan and a ragged one) against the
    TPU kernel in interpret mode, float32."""
    shape = (2, 6, 9, 13, 16)
    x, _, w, b = _inputs(shape, torch.float32, 3)
    want = np.asarray(dp.depthwise3x3_pallas(jnp.asarray(x.numpy()), _flax_w(w), jnp.asarray(b.numpy()),
                                             block=(4, 4, 16)))
    tol = _fwd_tol(x, w, torch.from_numpy(want))
    for plan in (dw.kernel_plan(shape, torch.float32)["depthwise3x3"], dict(ty=4, seg=4, ring=3),
                 dict(ty=2, seg=3, ring=4, tx=6)):
        got = emulate_fwd(x, w, b, plan).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_emulated_gradients_match_jax_vjp():
    """The emulated input gradient (mirror flag) and weight gradient against
    ``jax.vjp`` of the XLA depthwise conv, float32."""
    shape = (2, 5, 7, 8, 16)
    x, dy, w, b = _inputs(shape, torch.float32, 4)

    def conv(xj, wj, bj):
        out = jax.lax.conv_general_dilated(
            xj, wj, (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            feature_group_count=shape[-1], precision=jax.lax.Precision.HIGHEST,
        )
        return out + bj

    _, vjp = jax.vjp(conv, jnp.asarray(x.numpy()), _flax_w(w), jnp.asarray(b.numpy()))
    jdx, jdw, jdb = (np.asarray(a) for a in vjp(jnp.asarray(dy.numpy())))
    for plan in (dict(ty=3, seg=2, ring=4), dict(ty=3, seg=2, ring=3, tx=3)):
        dx = emulate_fwd(dy, w, None, plan, mirror=True).numpy()
        np.testing.assert_allclose(dx, jdx, rtol=1e-5, atol=1e-5 * np.abs(jdx).max())
        gw, gb = emulate_wgrad(x, dy, plan)
        np.testing.assert_allclose(gw.numpy(), np.transpose(jdw, (4, 3, 0, 1, 2)), rtol=1e-5,
                                   atol=1e-5 * np.abs(jdw).max())
        np.testing.assert_allclose(gb.numpy(), jdb, rtol=1e-5, atol=1e-5 * np.abs(jdb).max())


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

# (B, Z, Y, X, C): the stride-1 MedNeXt-S training stages of both recipes,
# then the microbench's five stages (the first is 7a's shape)
TRAIN_SHAPES = [(dw.TRAIN_BATCH, *s, c) for stages in dw.TRAIN_STAGES.values() for s, c, _ in stages] + [
    (b, e, e, e, c) for b, e, c in microbench.STAGES
]


def _check_plan(shape, dtype, kind, p):
    es = 2 if dtype == torch.bfloat16 else 4
    assert p["smem_bytes"] <= fb.MAX_SMEM, (shape, p)
    g = fb.ring_geometry(shape, p["ty"], p["seg"], p["tx"])
    assert g["items"] == p["items"], (shape, p)
    assert g["bands"] * p["ty"] >= shape[2] and g["segs"] * p["seg"] >= shape[1]
    assert g["xbands"] * p["tx"] >= shape[3] and g["xp"] == p["tx"] + 2
    smem = (dw.fwd_smem if kind == 0 else dw.wgrad_smem)(shape, es, p["ty"], p["ring"], p["tx"])
    assert p["smem_bytes"] == smem and p["ring"] in (3, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_planner_covers_the_training_shapes(shape, dtype):
    plan = dw.kernel_plan(shape, dtype)
    assert set(plan) == set(dw.KERNEL_NAMES)
    for kind, name in enumerate(dw.KERNEL_NAMES):
        assert plan[name]["kernel"] == name
        _check_plan(shape, dtype, kind, plan[name])


# The plans (ty, seg, ring) the planner took before the ring had x bands, at
# the training shapes of both recipes (batch 8): forward and weight gradient
# in bf16, then in f32. Whole rows fit there, so they stay.
TRAIN_PLANS = {
    (64, 32, 32, 32): ((8, 8, 3), (8, 8, 3), (4, 16, 3), (4, 16, 3)),
    (32, 16, 16, 64): ((8, 2, 3), (8, 2, 3), (4, 4, 3), (4, 4, 3)),
    (16, 8, 8, 128): ((4, 1, 3), (4, 1, 3), (4, 1, 3), (8, 1, 3)),
    (8, 4, 4, 256): ((1, 1, 3), (2, 1, 3), (2, 1, 3), (2, 1, 3)),
    (4, 2, 2, 512): ((1, 1, 3), (1, 1, 3), (1, 1, 3), (1, 1, 3)),
    (96, 48, 48, 32): ((8, 2, 3), (4, 4, 3), (4, 4, 3), (2, 8, 3)),
    (48, 24, 24, 64): ((4, 1, 3), (4, 2, 3), (2, 2, 3), (2, 4, 3)),
    (24, 12, 12, 128): ((2, 1, 3), (12, 2, 3), (2, 1, 3), (1, 24, 3)),
    (12, 6, 6, 256): ((6, 1, 3), (6, 1, 3), (6, 1, 3), (2, 2, 3)),
    (6, 3, 3, 512): ((2, 1, 3), (2, 1, 3), (2, 1, 3), (2, 1, 3)),
}


@pytest.mark.parametrize("key", list(TRAIN_PLANS), ids=lambda k: "x".join(map(str, k)))
def test_planner_keeps_the_whole_row_plans(key):
    shape = (dw.TRAIN_BATCH, *key)
    got = [dw.plans(kind, shape, dtype)[0] for dtype in (torch.bfloat16, torch.float32) for kind in (0, 1)]
    assert [(p["ty"], p["seg"], p["ring"]) for p in got] == list(TRAIN_PLANS[key])
    assert all(p["tx"] == fb.whole_row(key[2]) for p in got)


# The plans (ty, seg, ring, tx) at the synthetic instance tune recipe's
# training stages (MedNeXt-S, stock stem, batch 8 of 32 x 64 x 64): forward
# and weight gradient in bf16, then in f32.
INSTANCE_PLANS = {
    (32, 64, 64, 32): ((4, 16, 3, 66), (4, 16, 3, 66), (2, 32, 3, 66), (1, 32, 3, 66)),
    (16, 32, 32, 64): ((4, 4, 3, 33), (4, 4, 3, 33), (2, 8, 3, 33), (1, 16, 3, 33)),
    (8, 16, 16, 128): ((4, 1, 3, 18), (4, 1, 3, 18), (1, 4, 3, 18), (1, 4, 3, 18)),
    (4, 8, 8, 256): ((1, 1, 3, 9), (2, 1, 3, 9), (1, 1, 3, 9), (2, 1, 3, 9)),
    (2, 4, 4, 512): ((1, 1, 3, 6), (1, 1, 3, 6), (1, 1, 3, 3), (1, 1, 3, 3)),
}


@pytest.mark.parametrize("key", list(INSTANCE_PLANS), ids=lambda k: "x".join(map(str, k)))
def test_planner_pins_the_instance_recipe_plans(key):
    shape = (8, *key)
    assert key in {sp + (c,) for sp, c, _ in mednext_stages((32, 64, 64), "S", (1, 1, 1))}
    got = [dw.plans(kind, shape, dtype)[0] for dtype in (torch.bfloat16, torch.float32) for kind in (0, 1)]
    assert [(p["ty"], p["seg"], p["ring"], p["tx"]) for p in got] == list(INSTANCE_PLANS[key])
    for p in got:
        check_tiling(shape, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", TUTORIAL_WINDOWS, ids=_window_id)
def test_planner_covers_every_tutorial_stage(window, dtype):
    """Both kernels find a plan at every stride-1 stage of MedNeXt on the
    tutorials' windows (batch 2), within shared memory, whose items tile the
    volume; x bands narrower than the row only where no whole-row plan
    leaves an SM room for two blocks (``fused_block._search``)."""
    for spatial, c, _ in mednext_stages(*window):
        shape = (2, *spatial, c)
        for kind in (0, 1):
            found = dw.plans(kind, shape, dtype)
            _check_plan(shape, dtype, kind, found[0])
            check_tiling(shape, found[0])
            whole = [p for p in found if p["tx"] == fb.whole_row(spatial[2])]
            if len(whole) < len(found):
                assert all(fb._resident(p["smem_bytes"], 2) < 2 for p in whole), (shape, kind)


def test_planner_takes_every_width():
    """Every width the wrappers take (C a multiple of 16 up to 512) has a
    plan of both kernels in both dtypes at X 2 and 3 (the fast recipe's
    narrowest rows); wider rows take x bands where whole ones do not fit
    (``test_planner_covers_every_tutorial_stage``)."""
    for c in range(16, dw.MAX_CHANNELS + 1, 16):
        for xs in (2, 3):
            shape = (2, 3, 3, xs, c)
            for dtype in (torch.float32, torch.bfloat16):
                plan = dw.kernel_plan(shape, dtype)
                for kind, name in enumerate(dw.KERNEL_NAMES):
                    _check_plan(shape, dtype, kind, plan[name])


def test_lanes_give_each_pair_and_slot_one_thread():
    """Every width the wrappers take: the active threads hold each (channel
    pair, run slot) once, and the inactive ones lie past them."""
    for c in range(16, dw.MAX_CHANNELS + 1, 16):
        lanes, tv = _lanes(c)
        held = sorted((p, slot) for p, slot, active in lanes if active)
        assert held == sorted((p, slot) for p in range(c // 2) for slot in range(tv)), c
        assert all(t >= tv * (c // 2) for t, (_, _, active) in enumerate(lanes) if not active), c


def test_planner_is_pure_and_sorted():
    """The same plans on every call, fastest first by the cost model."""
    shape = (8, 96, 48, 48, 32)
    for kind in (0, 1):
        a, b = dw.plans(kind, shape, torch.bfloat16), dw.plans(kind, shape, torch.bfloat16)
        assert a == b and a[0]["est_clk"] == min(p["est_clk"] for p in a)
