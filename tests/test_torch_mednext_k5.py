"""Kernel 5 in the port against the JAX package on the CPU: the fused
pair's plain versions at k 5 against JAX's Pallas kernels ``dw_stats`` and
``fused_mednext_block`` (k 5) in Pallas TPU interpret mode; the CUDA ring
kernels' k 5 walk (halo 2, rings of 6 or 5 slabs, the apply pass's 5)
emulated in PyTorch against the plain versions; the planners at every
stride-1 stage of the UpKern leg; MedNeXt at kernel 5 against flax in f32
and bf16; and one train step at kernel 5 with deep supervision against
JAX's ``make_train_step``.

Tolerances: the pair, f32, atol 2e-4 (the JAX tests' own); MedNeXt, f32
rtol 1e-4 and atol 1e-4 * max|ref|, bf16 atol 5e-2 * max|ref|; the train
step's losses rtol 1e-5 and its gradient norm rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.losses.orchestrator import LossOrchestrator as JaxOrchestrator
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.ops.fused_block_pallas import dw_stats as jax_dw_stats
from pytorch_connectomics_tpu.ops.fused_block_pallas import fused_mednext_block, reference_block, to_cf
from pytorch_connectomics_tpu.training.optim import build_optimizer as jax_build_optimizer
from pytorch_connectomics_tpu.training.state import create_train_state as jax_create_train_state
from pytorch_connectomics_tpu.training.state import make_train_step as jax_make_train_step
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import load_flax_params
from pytorch_connectomics_tpu_torch.ops import fused_block as fb
from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step
from test_torch_multitask import _jax_params

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "model.mednext.kernel_size=5",
    "optimization.precision=32",
    "model.input_size=[16,32,32]",
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pair_params(seed, c, r, k=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        w_dw=(rng.standard_normal((k, k, k, c)) * 0.3).astype(f),
        b_dw=(rng.standard_normal(c) * 0.1).astype(f),
        gamma=(1.0 + 0.1 * rng.standard_normal(c)).astype(f),
        beta=(0.1 * rng.standard_normal(c)).astype(f),
        w1=(rng.standard_normal((c, r)) / np.sqrt(c)).astype(f),
        b1=(0.1 * rng.standard_normal(r)).astype(f),
        w2=(rng.standard_normal((r, c)) / np.sqrt(r)).astype(f),
        b2=(0.1 * rng.standard_normal(c)).astype(f),
    )


def _port_pair_params(p):
    t = torch.from_numpy
    return dict(
        w_dw=t(np.ascontiguousarray(p["w_dw"].transpose(3, 0, 1, 2)[:, None])),
        gamma=t(p["gamma"]), beta=t(p["beta"]),
        w1=t(np.ascontiguousarray(p["w1"].T)), b1=t(p["b1"]),
        w2=t(np.ascontiguousarray(p["w2"].T)), b2=t(p["b2"]),
    )


# (B, Z, Y, C, X) of the JAX kernels, R: a small shape and
# a wider one whose x is no multiple of the ring's runs
PAIR_SHAPES = [((1, 6, 5, 8, 7), 16), ((2, 4, 6, 16, 10), 32)]


@pytest.mark.parametrize("shape,r", PAIR_SHAPES, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_k5_plain_pair_matches_pallas(shape, r):
    c = shape[3]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 2, 4, 3)))
    p = _jax_pair_params(2, c, r)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    with pltpu.force_tpu_interpret_mode():
        want_stats = np.asarray(jax_dw_stats(to_cf(jnp.asarray(x), 5), jp["w_dw"], shape[2], shape[4], k=5))
        want = np.asarray(fused_mednext_block(jnp.asarray(x), **jp, k=5))
    ref = np.asarray(reference_block(jnp.asarray(x), **jp, k=5))
    np.testing.assert_allclose(want, ref, atol=2e-4)  # the Pallas kernel against its own reference
    pt = _port_pair_params(p)
    stats = fb.dw_stats(xt, pt["w_dw"])
    np.testing.assert_allclose(stats.numpy(), want_stats, rtol=1e-5, atol=2e-4)
    got = fb.fused_mednext_block(xt, **pt)
    np.testing.assert_allclose(got.numpy().transpose(0, 1, 2, 4, 3), want, atol=2e-4)


# ---------------------------------------------------------------------------
# the k 5 ring walk of csrc/mednext_block.cu, emulated
# ---------------------------------------------------------------------------


def _stage(xf, b, z, y0, x0, g):
    """Slab z of the band at (y0, x0): (ty + 2h, xp, C), zero outside the volume."""
    _, zs, ys, xs, c = xf.shape
    h = g["hl"]
    slab = torch.zeros(g["ty"] + 2 * h, g["xp"], c)
    if 0 <= z < zs:
        lo, hi = max(y0 - h, 0), min(y0 + g["ty"] + h, ys)
        xlo, xhi = max(x0 - h, 0), min(x0 + g["tx"] + h, xs)
        slab[lo - (y0 - h):hi - (y0 - h), xlo - (x0 - h):xhi - (x0 - h)] = xf[b, z, lo:hi, xlo:xhi]
    return slab


def _walk(x, plan, ring, k):
    """(item, b, y0, x0, z, the k slabs of z - h .. z + h, refill, g) in the
    kernels' order: slab z in slot (z - z0 + h) % ring; ``refill()`` stages
    slab z + h + 1 into the slot of slab z - h - 1 (k + 1 slots, before the
    stencil) or z - h (k slots, after it)."""
    zs = x.shape[1]
    g = fb.ring_geometry(x.shape, plan["ty"], plan["seg"], plan.get("tx"), k)
    h = g["hl"]
    xf = x.float()
    for item in range(g["items"]):
        xband, t = item % g["xbands"], item // g["xbands"]
        band, t = t % g["bands"], t // g["bands"]
        b, s = t // g["segs"], t % g["segs"]
        y0, x0, z0 = band * g["ty"], xband * g["tx"], s * g["seg"]
        z1 = min(z0 + g["seg"], zs)
        slots = [None] * ring
        for d in range(k):
            slots[d] = _stage(xf, b, z0 - h + d, y0, x0, g)
        for z in range(z0, z1):
            def refill(z=z):
                if z + 2 <= z1:
                    slots[(z + k - z0) % ring] = _stage(xf, b, z + h + 1, y0, x0, g)
            cur = [slots[(z - z0 + d) % ring] for d in range(k)]
            assert all(s is not None for s in cur)
            yield item, b, y0, x0, z, cur, refill, g


def _stencil(slabs, taps, g, k):
    ty, w = g["ty"], fb.RUN * g["nrx"]
    acc = torch.zeros(ty, w, taps.shape[0])
    for dz, s in enumerate(slabs):
        for dy in range(k):
            for dx in range(k):
                acc = acc + taps[:, (dz * k + dy) * k + dx] * s[dy:dy + ty, dx:dx + w]
    return acc


def emulate(x, w_dw, gamma, beta, plan, ring):
    """The statistics pass and the normalised stencil of the apply pass (the
    u tile, in f32) at k 5, each voxel written once."""
    b, zs, ys, xs, c = x.shape
    k = 5
    taps = fb.taps3d(w_dw).float().reshape(c, k ** 3)
    g0 = fb.ring_geometry(x.shape, plan["ty"], plan["seg"], plan.get("tx"), k)
    partial = torch.zeros(g0["items"], 2, c)
    for item, _, y0, x0, _, slabs, refill, g in _walk(x, plan, ring, k):
        if ring == k + 1:
            refill()
        t = _stencil(slabs, taps, g, k)[: min(g["ty"], ys - y0), : min(g["tw"], xs - x0)]
        if ring == k:
            refill()
        partial[item, 0] += t.sum((0, 1))
        partial[item, 1] += (t * t).sum((0, 1))
    stats = partial.view(b, -1, 2, c).sum(1)
    n = zs * ys * xs
    mean = stats[:, 0] / n
    scale = gamma[None] * torch.rsqrt(torch.clamp(stats[:, 1] / n - mean * mean, min=0.0) + fb.EPS)
    shift = beta[None] - mean * scale
    u = torch.full((b, zs, ys, xs, c), float("nan"))
    for _, bi, y0, x0, z, slabs, refill, g in _walk(x, plan, k, k):
        t = _stencil(slabs, taps, g, k)
        refill()
        yv, xv = min(g["ty"], ys - y0), min(g["tw"], xs - x0)
        centre = slabs[k // 2][g["hl"]:g["hl"] + yv, g["hl"]:g["hl"] + xv]
        torch.testing.assert_close(centre, x[bi, z, y0:y0 + yv, x0:x0 + xv].float(), rtol=0, atol=0)
        u[bi, z, y0:y0 + yv, x0:x0 + xv] = t[:yv, :xv] * scale[bi] + shift[bi]
    return stats, u


# (x shape, ty, seg, tx, statistics ring slots): y no multiple of ty, z no
# multiple of seg, odd x, bands of x that do not divide X, one of a single
# run, and 2-D taps (1, 5, 5) at Z 1
EMU_K5 = [((2, 5, 7, 9, 16), 3, 2, None, 6, (5, 5, 5)), ((1, 4, 6, 13, 16), 2, 3, 6, 5, (5, 5, 5)),
          ((1, 3, 5, 11, 16), 4, 2, 3, 6, (5, 5, 5)), ((2, 1, 9, 10, 16), 4, 1, 6, 5, (1, 5, 5))]


@pytest.mark.parametrize("case", EMU_K5, ids=lambda c: "x".join(map(str, c[0])) + f"-k{c[5][0]}")
def test_emulated_k5_ring_walk_matches_plain(case):
    shape, ty, seg, tx, ring, taps = case
    rng = np.random.default_rng(7)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, 1, *taps)) * 0.2).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    stats, u = emulate(x, w, gamma, beta, dict(ty=ty, seg=seg, tx=tx), ring)
    want = fb.dw_stats_plain(x, w)
    mag = fb.dw_stats_plain(x.abs(), w.abs())[:, :1] + want[:, 1:]
    assert torch.all((stats - want).abs() <= 1e-5 * mag)
    assert not torch.isnan(u).any()
    n = shape[1] * shape[2] * shape[3]
    mean = want[:, 0] / n
    scale = gamma[None] * torch.rsqrt(torch.clamp(want[:, 1] / n - mean * mean, min=0.0) + fb.EPS)
    t = F.conv3d(x.permute(0, 4, 1, 2, 3), fb.taps3d(w), padding=2, groups=c).permute(0, 2, 3, 4, 1)
    ref = t * scale[:, None, None, None] + (beta[None] - mean * scale)[:, None, None, None]
    torch.testing.assert_close(u, ref, rtol=1e-5, atol=1e-5)


# (C, R, (Z, Y, X)) of MedNeXt-S's stride-1 stages on the fast recipe's
# (96, 128, 96) window after its (1, 2, 2) stem: the UpKern leg at kernel 5
UPKERN_STAGES = [(32, 64, (96, 64, 48)), (64, 128, (48, 32, 24)), (128, 256, (24, 16, 12)), (256, 512, (12, 8, 6)),
                 (512, 1024, (6, 4, 3))]


@pytest.mark.parametrize("batch", [8, 16])
def test_k5_planners_cover_the_upkern_leg(batch):
    """At every stage of the leg's training (8) and test (16) batches both
    kernels have a plan at k 5 that fits shared memory, with k-slab rings;
    float32 statistics at C 512 run as two channel groups; the apply plans
    carry no W2 (read from global memory past k 3)."""
    for c, r, spatial in UPKERN_STAGES:
        shape = (batch, *spatial, c)
        for dtype in (torch.float32, torch.bfloat16):
            groups = fb.stats_groups(shape, dtype, 5)
            assert groups == (2 if (dtype == torch.float32 and c == 512) else 1), (shape, dtype)
            sp = fb.stats_plans((*shape[:4], c // groups), dtype, k=5)[0]
            assert sp["ring"] in (5, 6) and sp["smem_bytes"] <= fb.MAX_SMEM
        ap = fb.apply_plan(shape, r, c, k=5)
        assert ap["ring"] == 5 and ap["smem_bytes"] <= fb.MAX_SMEM
        assert ap["smem_bytes"] == fb.apply_smem(shape, r, c, ap["ty"], ap["cs"], ap["rc"], ap["tx"], 5)
        assert fb.apply_smem(shape, r, c, ap["ty"], ap["cs"], ap["rc"], ap["tx"], 3) > ap["smem_bytes"] - (
            5 * fb.ring_geometry(shape, ap["ty"], 1, ap["tx"], 5)["slab"] * 2)
    # k 3 keeps its plans: the k 5 parameters do not reach them
    assert fb.stats_plan((16, 96, 64, 48, 32), torch.bfloat16) == fb.stats_plan((16, 96, 64, 48, 32), torch.bfloat16, 3)


def test_wrappers_take_k5_and_2d_taps_and_refuse_others():
    x = torch.randn(1, 4, 5, 6, 16)
    for taps in ((5, 5, 5), (1, 5, 5), (1, 3, 3)):
        w = torch.randn(16, 1, *taps)
        got = fb.dw_stats(x, w)
        k = taps[-1]
        emb = torch.zeros(16, 1, k, k, k)
        emb[:, :, k // 2 if taps[0] == 1 else slice(None)] = w if taps[0] == k else w[:, :, 0]
        torch.testing.assert_close(got, fb.dw_stats_plain(x, emb), rtol=0, atol=0)
    with pytest.raises(ValueError):
        fb.taps3d(torch.zeros(16, 1, 3, 5, 5))
    with pytest.raises(ValueError):
        fb.taps3d(torch.zeros(16, 1, 4, 4, 4))


# ---------------------------------------------------------------------------
# MedNeXt at kernel 5
# ---------------------------------------------------------------------------


def _pair(dtype, shape=(1, 16, 32, 32, 1), seed=3, over=()):
    cfg = load_config(SYNTH, overrides=TINY + [f"model.compute_dtype={dtype}", *over], mode="train")
    jcfg = jax_load_config(SYNTH, overrides=TINY + [f"model.compute_dtype={dtype}", *over], mode="train")
    jm = jax_build(jcfg.model)
    params = _jax_params(jm, shape, seed)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": params}, x)  # jit: a tenth of the eager time on the CPU
    model = build_model(cfg.model, device="cpu", seed=0)
    load_flax_params(model, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    return cfg, model, got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mednext_k5_matches_flax(dtype):
    _, model, got, ref = _pair(dtype)
    assert model.enc[0].blocks[0].conv_weight.shape == (8, 1, 5, 5, 5)
    ref = np.asarray(ref)
    top = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * top)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-2 * top)


def test_k5_train_step_with_deep_supervision_matches_jax():
    """One jitted JAX ``make_train_step`` and one port train step of the
    tiny kernel-5 MedNeXt with deep supervision, same weights and batch:
    the total, each term, each ds scale's loss and the gradient norm."""
    over = ["model.loss.deep_supervision=true", "optimization.scheduler.warmup_steps=1"]
    shape = (2, 16, 32, 32, 1)
    jcfg = jax_load_config(SYNTH, overrides=TINY + over, mode="train")
    jm = jax_build(jcfg.model)
    params = _jax_params(jm, (1, *shape[1:]), 4)
    rng = np.random.default_rng(9)
    x = rng.random(shape, dtype=np.float32)
    y = (rng.random(shape) > 0.6).astype(np.float32)
    tx, _ = jax_build_optimizer(jcfg.optimization, jcfg.optimization.n_steps_per_epoch)
    jstate = jax_create_train_state(params, tx)
    jstep = jax.jit(jax_make_train_step(jm.apply, JaxOrchestrator(jcfg.model.loss), tx))
    _, want = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    want = {k: float(v) for k, v in want.items()}
    cfg = load_config(SYNTH, overrides=TINY + over, mode="train")
    model = build_model(cfg.model, device="cpu", seed=0)
    load_flax_params(model, params)
    orch = LossOrchestrator(cfg.model.loss)
    opt, schedule = build_optimizer(cfg.optimization, model, cfg.optimization.n_steps_per_epoch)
    state = create_train_state(model, opt)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val)
    got = step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert {f"loss_ds_{k}" for k in range(3)} <= set(want)
    for k, v in want.items():
        if k.startswith("loss_"):
            np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"], rtol=1e-4)
