"""The port's CUDA kernels (the fused MedNeXt block pair, the training
path's depthwise 3^3 conv and its weight gradient, RSUNet's dense 3^3 conv,
the fused MLP with residual and the pointwise conv, and the probe kernels)
against their plain PyTorch versions, on the card. Skipped where there is no CUDA device. This
file imports no JAX, so it also runs with ``--noconftest`` on a machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, c, r, cout, device):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return dict(
        w_dw=t(rng.standard_normal((c, 1, 3, 3, 3)) * 0.3),
        gamma=t(1.0 + 0.1 * rng.standard_normal(c)),
        beta=t(0.1 * rng.standard_normal(c)),
        w1=t(rng.standard_normal((r, c)) / np.sqrt(c)),
        b1=t(0.1 * rng.standard_normal(r)),
        w2=t(rng.standard_normal((cout, r)) / np.sqrt(r)),
        b2=t(0.1 * rng.standard_normal(cout)),
    )


# (B, Z, Y, X, C, R, Cout): the stage shapes of MedNeXt-S on the fast recipe
# at batch 2, plus ragged tiles, a channel-changing block, and y, z and x
# that no band, segment or run of three divides
SHAPES = [
    (2, 96, 64, 48, 32, 64, 32),
    (2, 48, 32, 24, 64, 128, 64),
    (2, 24, 16, 12, 128, 256, 128),
    (2, 12, 8, 6, 256, 512, 256),
    (2, 6, 4, 3, 512, 1024, 512),
    (3, 5, 7, 9, 16, 32, 16),
    (1, 4, 6, 10, 32, 64, 48),
    (2, 7, 10, 13, 32, 64, 32),
    (1, 5, 7, 11, 64, 256, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_plain(device, shape, dtype):
    b, z, y, xs, c, r, cout = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, z, y, xs, c), dtype=np.float32)).to(device, dtype)
    p = _params(rng, c, r, cout, device)
    stats = fb.dw_stats(x, p["w_dw"])
    want_stats = fb.dw_stats_plain(x, p["w_dw"])
    torch.cuda.synchronize()
    n = z * y * xs
    # f32 sums in another order: relative to the sum of magnitudes
    scale = fb.dw_stats_plain(x.abs(), p["w_dw"].abs())[:, :1].abs() + want_stats[:, 1:]
    assert torch.all((stats - want_stats).abs() <= 1e-5 * scale + 1e-3)
    p.update(w1=p["w1"].to(dtype), w2=p["w2"].to(dtype))
    out = fb.fused_block_apply(x, want_stats, **p)
    want = fb.fused_block_apply_plain(x, want_stats, **p)
    torch.cuda.synchronize()
    assert out.shape == (b, z, y, xs, cout) and out.dtype == dtype
    err = (out.float() - want.float()).abs().max().item()
    # f32: FMA order only. bf16: two bf16 ulps at the output's magnitude; the
    # kernel and the plain version sum in another order, so a value rounded to
    # bf16 (u, h, the output) can land one ulp apart
    top = want.float().abs().max().item()
    tol = 2e-4 if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(max(top, 1.0))) - 6)
    stats_err = ((stats - want_stats).abs() / scale).max().item()
    print(f"{shape} {dtype}: stats rel err {stats_err:.3g}, apply max err {err:.3g} (tol {tol:.3g})")
    assert err <= tol, (err, tol, n)


# ragged plans forced on the kernels: bands past the volume's y, segments
# past its z, odd x, streamed weight chunks of 16, 32 and 64 hidden units,
# units across Cout, and a width with no compile-time instance (48).
# (B, Z, Y, X, C, R, Cout), statistics (ty, seg, ring slots), apply (ty, seg, cs, rc)
FORCED = [
    ((2, 7, 10, 13, 32, 64, 32), (4, 3, 4), (4, 3, 32, 64)),
    ((1, 5, 7, 11, 64, 256, 64), (3, 2, 3), (3, 2, 32, 64)),
    ((2, 5, 3, 4, 256, 512, 256), (2, 2, 4), (2, 3, 128, 32)),
    ((1, 4, 5, 3, 48, 96, 48), (2, 3, 3), (5, 3, 16, 16)),
]


@pytest.mark.parametrize("case", FORCED, ids=lambda c: "x".join(map(str, c[0])))
def test_forced_ragged_plans_match_plain(device, case):
    (b, z, y, xs, c, r, cout), sp, ap = case
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, z, y, xs, c), dtype=np.float32)).to(device)
    p = _params(rng, c, r, cout, device)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        want_stats = fb.dw_stats_plain(xd, p["w_dw"])
        stats = fb.dw_stats(xd, p["w_dw"], plan=dict(zip(("ty", "seg", "ring"), sp)))
        torch.cuda.synchronize()
        scale = fb.dw_stats_plain(xd.abs(), p["w_dw"].abs())[:, :1].abs() + want_stats[:, 1:]
        assert torch.all((stats - want_stats).abs() <= 1e-5 * scale + 1e-3), (dtype, sp)
    xb = x.to(torch.bfloat16)
    pb = dict(p, w1=p["w1"].to(torch.bfloat16), w2=p["w2"].to(torch.bfloat16))
    want_stats = fb.dw_stats_plain(xb, p["w_dw"])
    out = fb.fused_block_apply(xb, want_stats, **pb, plan=dict(zip(("ty", "seg", "cs", "rc"), ap)))
    want = fb.fused_block_apply_plain(xb, want_stats, **pb)
    torch.cuda.synchronize()
    top = want.float().abs().max().item()
    tol = 2.0 ** (np.floor(np.log2(max(top, 1.0))) - 6)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol, ap)


def test_dw_stats_is_bit_identical_across_launches(device):
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((4, 24, 32, 24, 32), dtype=np.float32)).to(device, dtype)
        w = torch.from_numpy(rng.standard_normal((32, 1, 3, 3, 3)).astype(np.float32)).to(device)
        a, b = fb.dw_stats(x, w), fb.dw_stats(x, w)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


# (C, R, (Z, Y, X)) of the fast recipe's stride-1 stages, at batch 16
FAST_STAGES = [(32, 64, (96, 64, 48)), (64, 128, (48, 32, 24)), (128, 256, (24, 16, 12)), (256, 512, (12, 8, 6)),
               (512, 1024, (6, 4, 3))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_card_plan_matches_the_planner(device, dtype):
    for c, r, spatial in FAST_STAGES:
        shape = (16, *spatial, c)
        plan = fb.card_plan(shape, dtype, r)
        for name in ("dw_stats", "fused_block_apply"):
            k = plan[name]
            if "ty" not in k:
                continue
            assert k["card_smem_bytes"] == k["smem_bytes"] and k["card_items"] == k["items"], (shape, k)
            assert k["blocks_per_sm"] >= 1 and 1 <= k["grid"] <= k["items"], (shape, k)
        print(shape, dtype, plan)


def test_cuda_tensor_never_falls_back(device):
    x = torch.zeros((1, 4, 4, 4, 8), device=device)  # 8 channels: not taken
    with pytest.raises(ValueError):
        fb.dw_stats(x, torch.zeros((8, 1, 3, 3, 3), device=device))
    with pytest.raises(TypeError):
        fb.dw_stats(x.half(), torch.zeros((8, 1, 3, 3, 3), device=device))
    p = _params(np.random.default_rng(0), 16, 32, 16, device)
    xb = torch.zeros((1, 4, 4, 4, 16), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # float32 w1/w2 with bfloat16 x: no cast inside the wrapper
        fb.fused_block_apply(xb, fb.dw_stats(xb, p["w_dw"]), **p)


# ---------------------------------------------------------------------------
# depthwise 3^3 conv kernels (training path)
# ---------------------------------------------------------------------------

from pytorch_connectomics_tpu_torch.ops import depthwise as dwk  # noqa: E402

# (B, Z, Y, X, C): the stride-1 stage shapes of MedNeXt-S training on the
# Lucchi fast recipe's 96^3 patch after the (1, 2, 2) stem at batch 2, the
# synthetic recipe's bottleneck, and ragged shapes: y, z and x that no band,
# segment or run of three divides, x = 1, C 16, C 512, and C 272 and 400 (a
# channel pair a thread with threads left over, which must store nothing)
DW_SHAPES = [
    (2, 96, 48, 48, 32),
    (2, 48, 24, 24, 64),
    (2, 24, 12, 12, 128),
    (2, 12, 6, 6, 256),
    (2, 6, 3, 3, 512),
    (2, 4, 2, 2, 512),
    (3, 5, 7, 9, 16),
    (1, 3, 1, 2, 48),
    (2, 7, 10, 13, 32),
    (1, 9, 11, 5, 64),
    (2, 5, 3, 1, 16),
    (1, 3, 5, 7, 512),
    (2, 11, 13, 4, 48),
    (1, 3, 5, 7, 400),
    (2, 4, 3, 5, 272),
]


def _bf16_ulps(ref, n):
    top = ref.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 8 + n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DW_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_depthwise_kernels_match_plain(device, shape, dtype):
    c = shape[-1]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.standard_normal((c, 1, 3, 3, 3)).astype(np.float32) * 0.3).to(device)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(device)
    for args in ((x, w, b), (dy, w.flip((2, 3, 4)), None)):  # forward, input gradient
        got, want = dwk.depthwise3x3(*args), dwk.depthwise3x3_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        # f32: FMA order against the summed magnitudes. bf16: both sum in f32
        # and round once, so a value can land one ulp apart; two ulps at the
        # output's largest magnitude
        mag = dwk.depthwise3x3_plain(args[0].float().abs(), args[1].abs()).abs().max().item()
        tol = 1e-5 * mag if dtype == torch.float32 else _bf16_ulps(want, 2)
        assert err <= tol, (err, tol)
    gw, gb = dwk.depthwise3x3_wgrad(x, dy)
    ww, wb = dwk.depthwise3x3_wgrad_plain(x, dy)
    gw2, gb2 = dwk.depthwise3x3_wgrad(x, dy)
    torch.cuda.synchronize()
    assert gw.shape == (c, 1, 3, 3, 3) and gb.shape == (c,) and gw.dtype == gb.dtype == torch.float32
    # f32 sums of B*N products in another order, against the summed magnitudes
    mw, mb = dwk.depthwise3x3_wgrad_plain(x.float().abs(), dy.float().abs())
    assert torch.all((gw - ww).abs() <= 1e-5 * mw + 1e-6), ((gw - ww).abs() / mw).max().item()
    assert torch.all((gb - wb).abs() <= 1e-5 * mb + 1e-6), ((gb - wb).abs() / mb).max().item()
    assert torch.equal(gw, gw2) and torch.equal(gb, gb2)  # deterministic


# ragged plans forced on the depthwise kernels: bands past the volume's y,
# segments past its z, odd x, both ring sizes, widths with and without a
# compile-time instance. (B, Z, Y, X, C), (ty, seg, ring slots)
DW_FORCED = [
    ((2, 7, 10, 13, 32), (4, 3, 4)),
    ((1, 5, 7, 11, 64), (3, 2, 3)),
    ((2, 5, 3, 4, 256), (2, 2, 4)),
    ((1, 4, 5, 3, 48), (2, 3, 3)),
    ((2, 3, 2, 2, 512), (3, 2, 3)),
    ((1, 6, 9, 1, 16), (4, 4, 4)),
    ((2, 4, 3, 5, 272), (2, 2, 3)),
    ((1, 3, 5, 7, 400), (1, 2, 3)),
]


@pytest.mark.parametrize("case", DW_FORCED, ids=lambda c: "x".join(map(str, c[0])))
def test_depthwise_forced_ragged_plans_match_plain(device, case):
    shape, (ty, seg, ring) = case
    c = shape[-1]
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((c, 1, 3, 3, 3)).astype(np.float32) * 0.3).to(device)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(device)
    plan = dict(ty=ty, seg=seg, ring=ring)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
        dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
        for got, args in ((dwk.run_fwd(x, w, b, plan=plan), (x, w, b)),
                          (dwk.run_fwd(dy, w, mirror=True, plan=plan), (dy, w.flip((2, 3, 4)), None))):
            want = dwk.depthwise3x3_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            mag = dwk.depthwise3x3_plain(args[0].float().abs(), args[1].abs()).abs().max().item()
            tol = 1e-5 * mag if dtype == torch.float32 else _bf16_ulps(want, 2)
            assert err <= tol, (dtype, plan, err, tol)
        gw, gb = dwk.run_wgrad(x, dy, plan=plan)
        gw2, gb2 = dwk.run_wgrad(x, dy, plan=plan)
        ww, wb = dwk.depthwise3x3_wgrad_plain(x, dy)
        mw, mb = dwk.depthwise3x3_wgrad_plain(x.float().abs(), dy.float().abs())
        torch.cuda.synchronize()
        assert torch.all((gw - ww).abs() <= 1e-5 * mw + 1e-6), ((gw - ww).abs() / mw).max().item()
        assert torch.all((gb - wb).abs() <= 1e-5 * mb + 1e-6), ((gb - wb).abs() / mb).max().item()
        assert torch.equal(gw, gw2) and torch.equal(gb, gb2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_depthwise_mirror_flag_equals_flipped_taps(device, dtype):
    """The input gradient's mirror flag reads the taps the flip would give,
    in the same order: bit-identical to the forward on flipped taps."""
    rng = np.random.default_rng(6)
    for shape in ((2, 9, 10, 11, 32), (1, 4, 5, 6, 48)):
        c = shape[-1]
        dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
        w = torch.from_numpy(rng.standard_normal((c, 1, 3, 3, 3)).astype(np.float32)).to(device)
        got = dwk.depthwise3x3_input_grad(dy, w)
        want = dwk.depthwise3x3(dy, w.flip((2, 3, 4)))
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# ((Z, Y, X), C) of the stride-1 training stages of both recipes
DW_TRAIN = [(s, c) for stages in dwk.TRAIN_STAGES.values() for s, c, _ in stages]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_depthwise_card_plan_matches_the_planner(device, dtype):
    for spatial, c in DW_TRAIN + [((112, 112, 112), 32)]:
        shape = (dwk.TRAIN_BATCH, *spatial, c)
        plan = dwk.card_plan(shape, dtype)
        for name in dwk.KERNEL_NAMES:
            k = plan[name]
            assert k["card_smem_bytes"] == k["smem_bytes"] and k["card_items"] == k["items"], (shape, k)
            assert k["blocks_per_sm"] >= 1 and 1 <= k["grid"] <= k["items"], (shape, k)
        print(shape, dtype, plan)


def test_depthwise_function_backward_matches_plain_autograd(device):
    rng = np.random.default_rng(2)
    shape = (2, 6, 10, 12, 32)
    x0 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
    w0 = torch.from_numpy(rng.standard_normal((32, 1, 3, 3, 3)).astype(np.float32)).to(device)
    b0 = torch.from_numpy(rng.standard_normal(32).astype(np.float32)).to(device)
    up = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
    grads = []
    for fn in (dwk.depthwise_conv3x3, dwk.depthwise3x3_plain):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        (fn(x, w, b) * up).sum().backward()
        grads.append((x.grad, w.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def test_depthwise_never_falls_back(device):
    w = torch.zeros((8, 1, 3, 3, 3), device=device)
    with pytest.raises(ValueError):  # 8 channels: not taken
        dwk.depthwise3x3(torch.zeros((1, 4, 4, 4, 8), device=device), w)
    with pytest.raises(ValueError):  # more than 512 channels
        dwk.depthwise3x3_wgrad(*(torch.zeros((1, 2, 2, 2, 1024), device=device),) * 2)
    with pytest.raises(TypeError):
        dwk.depthwise3x3(torch.zeros((1, 4, 4, 4, 16), device=device).half(), torch.zeros((16, 1, 3, 3, 3), device=device))
    x = torch.zeros((1, 4, 4, 4, 16), device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        dwk.depthwise3x3(x, torch.zeros((16, 1, 3, 3, 3), device=device))


# ---------------------------------------------------------------------------
# dense 3^3 conv (RSUNet)
# ---------------------------------------------------------------------------

from pytorch_connectomics_tpu_torch.ops import conv3d as c3  # noqa: E402

# (B, Z, Y, X, Cin, Cout): every 3^3 conv of RSUNet on the NucMM-Z recipe's
# 64^3 window at batch 2 (stem; levels 0-3), then ragged shapes: x and y
# not multiples of the tile, odd and packed channel counts, Cout past one
# 64-channel slice, Cin past 64; then many more tiles than blocks (each
# block prefetches across several tiles), 7f's widths (32 -> 64) on a
# ragged x tile, and y not a multiple of the tile's rows with Cout 36 and
# 100 (not multiples of a warp's 32 channels)
CONV_SHAPES = [
    (2, 64, 64, 64, 1, 28),
    (2, 64, 64, 64, 28, 28),
    (2, 32, 32, 32, 28, 36),
    (2, 32, 32, 32, 36, 36),
    (2, 16, 16, 16, 36, 48),
    (2, 16, 16, 16, 48, 48),
    (2, 8, 8, 8, 48, 64),
    (2, 8, 8, 8, 64, 64),
    (1, 5, 9, 33, 8, 8),
    (3, 7, 5, 9, 3, 20),
    (1, 4, 6, 10, 16, 100),
    (1, 3, 5, 70, 96, 40),
    (2, 1, 1, 1, 1, 1),
    (3, 24, 40, 48, 16, 32),
    (1, 6, 13, 112, 32, 64),
    (1, 5, 13, 40, 36, 36),
    (1, 4, 11, 24, 28, 100),
]
# bf16 only: Cin 192, the widest the kernel takes, whose weight slice leaves
# room for one halo buffer only
CONV_SHAPES_BF16 = [
    (1, 3, 5, 20, 192, 24),
]


def _conv_inputs(shape, dtype, device, seed=3):
    b, z, y, xs, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, z, y, xs, cin), dtype=np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3, 3)).astype(np.float32) / np.sqrt(27 * cin)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(device)
    return x, w, bias


@pytest.mark.parametrize(
    "shape,dtype",
    [(s, d) for s in CONV_SHAPES for d in (torch.float32, torch.bfloat16)]
    + [(s, torch.bfloat16) for s in CONV_SHAPES_BF16],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else {torch.float32: "f32", torch.bfloat16: "bf16"}[v],
)
def test_conv3d_kernel_matches_plain(device, shape, dtype):
    x, w, bias = _conv_inputs(shape, dtype, device)
    for bb in (bias, None):
        got, want = c3.conv3d_3x3(x, w, bb), c3.conv3d_3x3_plain(x, w, bb)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (*shape[:4], shape[5]) and got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            # f32 sums in another order: 1e-5 of the summed magnitudes
            mag = c3.conv3d_3x3_plain(x.abs(), w.abs()) + (0 if bb is None else bb.abs())
            assert torch.all((got - want).abs() <= 1e-5 * mag + 1e-30), ((got - want).abs() / mag).max().item()
        else:
            # both sum in f32 and round (then add the bias and round again):
            # a value can land an ulp apart at each rounding, two ulps at the
            # output's largest magnitude
            assert err <= _bf16_ulps(want, 2), (err, _bf16_ulps(want, 2))
    wmat = c3.kernel_weight(w, dtype)
    assert torch.equal(c3.conv3d_3x3(x, w, bias, wmat=wmat), c3.conv3d_3x3(x, w, bias))


@pytest.mark.parametrize("shape", [(2, 16, 32, 64, 28, 28), (1, 6, 13, 112, 32, 64), (1, 3, 5, 20, 192, 24)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3d_two_launches_are_bit_identical(device, shape):
    x, w, bias = _conv_inputs(shape, torch.bfloat16, device, seed=5)
    wmat = c3.kernel_weight(w, torch.bfloat16)
    first = c3.conv3d_3x3(x, w, bias, wmat=wmat)
    assert torch.equal(first, c3.conv3d_3x3(x, w, bias, wmat=wmat))


@pytest.mark.parametrize("shape", CONV_SHAPES[:8] + [(8, 112, 112, 112, 32, 64), (3, 24, 40, 48, 16, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3d_plan_uses_wide_warp_tiles(device, shape):
    """bf16 with Cin >= 8 takes the tap-wise path, each warp owning at least
    32 voxels x min(Np, 32) channels; a tile that leaves room beside the
    weight slice for two halo buffers takes both."""
    b, z, y, xs, cin, cout = shape
    plan = c3.kernel_plan((b, z, y, xs, cin), cout, torch.bfloat16)
    assert plan["kernel"] == ("packed" if cin < 8 else "taps")
    assert plan["warp_m"] >= 32 and plan["warp_n"] >= min(-(-cout // 16) * 16, 32)
    assert plan["xs"] * plan["r"] == plan["warp_m"] * plan["warps_m"]
    if shape == (3, 24, 40, 48, 16, 32):
        assert plan["buffers"] == 2


def test_conv3d_plan_wide_input_takes_one_buffer(device):
    plan = c3.kernel_plan((1, 3, 5, 20, 192), 24, torch.bfloat16)
    assert plan["buffers"] == 1 and plan["smem_bytes"] <= 232448


def test_conv3d_takes_the_jax_layout(device):
    x, w, bias = _conv_inputs((1, 6, 7, 20, 28, 36), torch.bfloat16, device)
    got = c3.conv3d_3x3(x, w.permute(2, 3, 4, 1, 0).contiguous(), bias, layout="dhwio")
    assert torch.equal(got, c3.conv3d_3x3(x, w, bias))


def test_conv3d_never_falls_back(device):
    x, w, bias = _conv_inputs((1, 4, 4, 4, 16, 16), torch.float32, device)
    with pytest.raises(TypeError):
        c3.conv3d_3x3(x.half(), w)
    with pytest.raises(ValueError):  # input channels disagree with the weight
        c3.conv3d_3x3(x[..., :8].contiguous(), w)
    with pytest.raises(ValueError):  # not contiguous
        c3.conv3d_3x3(x.transpose(1, 2), w)
    with pytest.raises(ValueError):  # a weight matrix in another dtype
        c3.conv3d_3x3(x, w, wmat=c3.kernel_weight(w, torch.bfloat16))
    with pytest.raises(RuntimeError, match="shape not supported"):  # a weight matrix short of rows
        c3.conv3d_3x3(x, w, wmat=c3.kernel_weight(w, torch.float32)[:-16].contiguous())
    wide = torch.zeros((16, 128, 3, 3, 3), device=device)
    with pytest.raises(RuntimeError, match="shape not supported"):  # f32 weight slice beyond shared memory
        c3.conv3d_3x3(torch.zeros((1, 2, 2, 2, 128), device=device), wide)
    with pytest.raises(RuntimeError, match="no backward pass"):
        c3.conv3d_3x3(x, w.clone().requires_grad_(True))


# ---------------------------------------------------------------------------
# fused MLP with residual, pointwise conv, and the probe kernels
# ---------------------------------------------------------------------------

from pytorch_connectomics_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from pytorch_connectomics_tpu_torch.ops import probes  # noqa: E402

# (M, C, E): MedNeXt-S's five widths at ragged row counts, a width past one
# resident weight (streamed chunks), a chunk that does not divide E, widths
# that are not multiples of 16 (padded weights; x rows of 48, 16 and 14
# bytes in bf16), and the fast recipe's row counts at the two widths the
# planner splits across clusters
MLP_SHAPES = [(4099, 32, 64), (1000, 64, 128), (515, 128, 256), (300, 256, 512), (77, 512, 1024),
              (200, 48, 80), (33, 1024, 64), (200, 24, 40), (77, 8, 24), (50, 7, 13), (9216, 256, 512),
              (1152, 512, 1024)]


def _mlp_inputs(m, c, e, dtype, device, seed=4):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    return (t(rng.standard_normal((m, c)), dtype), t(rng.standard_normal((c, e)) / np.sqrt(c), dtype),
            t(0.3 * rng.standard_normal(e)), t(rng.standard_normal((e, c)) / np.sqrt(e), dtype),
            t(0.3 * rng.standard_normal(c)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MLP_SHAPES, ids=lambda s: "M{}-C{}-E{}".format(*s))
def test_fused_mlp_kernel_matches_plain(device, shape, dtype):
    x, w1, b1, w2, b2 = _mlp_inputs(*shape, dtype, device)
    got, want = fm.fused_mlp_residual(x, w1, b1, w2, b2), fm.fused_mlp_residual_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == dtype
    _check_mlp(got, want, x, w1, b1, w2, b2)


def _check_mlp(got, want, x, w1, b1, w2, b2):
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        # f32 sums in another order and another tanh: 1e-5 of the summed magnitudes
        h = torch.nn.functional.gelu(x @ w1 + b1, approximate="tanh")
        mag = x.abs() + b2.abs() + (x.abs() @ w1.abs() + b1.abs() + h.abs()) @ w2.abs()
        assert torch.all(err <= 1e-5 * mag), (err / mag).max().item()
    else:
        # the hidden activation and the output are rounded: two ulps at the largest output
        assert err.max().item() <= _bf16_ulps(want, 2), (err.max().item(), _bf16_ulps(want, 2))


# (M, C, E, dtype, what the forced plan has): every kind of plan the kernel
# takes, each forced through the wrapper's plan argument: the bf16 warp
# kernel (ragged M, widths not multiples of 16 and odd, stores through its
# tile or straight from the accumulators, C 128), the block
# kernel with resident weights and with a ring of two streamed chunks,
# clusters of 2, 4 (resident and streamed), 8 (resident and streamed) and
# 16 blocks, a cluster at widths that are not multiples of 16; f32 resident
# and read through L1, several column blocks, 16-row tiles
FORCED = [
    (4099, 32, 64, torch.bfloat16, dict(wk=1, de=0)),
    (4099, 32, 64, torch.bfloat16, dict(wk=1, de=1)),
    (1000, 64, 128, torch.bfloat16, dict(wk=1)),
    (200, 24, 40, torch.bfloat16, dict(wk=1)),
    (50, 7, 13, torch.bfloat16, dict(wk=1)),
    (515, 128, 256, torch.bfloat16, dict(wk=1)),
    (515, 128, 256, torch.bfloat16, dict(cs=1, wn=4, de=1)),
    (515, 128, 256, torch.bfloat16, dict(cs=1, nbuf=1)),
    (515, 128, 256, torch.bfloat16, dict(cs=1, nbuf=2)),
    (515, 128, 256, torch.bfloat16, dict(cs=1, nbuf=2, ec=32)),
    (300, 256, 512, torch.bfloat16, dict(cs=4, nbuf=1)),
    (515, 128, 256, torch.bfloat16, dict(cs=2)),
    (300, 256, 512, torch.bfloat16, dict(cs=4, nbuf=2)),
    (300, 256, 512, torch.bfloat16, dict(cs=8, nbuf=1)),
    (300, 256, 512, torch.bfloat16, dict(cs=8, nbuf=2)),
    (77, 512, 1024, torch.bfloat16, dict(cs=16)),
    (1001, 48, 80, torch.bfloat16, dict(cs=2, nbuf=1)),
    (200, 24, 40, torch.bfloat16, dict(cs=2)),
    (4099, 32, 64, torch.bfloat16, dict(wk=0, cs=1, nbuf=2, bm=32)),
    (1000, 64, 128, torch.float32, dict(resident=1)),
    (1000, 64, 128, torch.float32, dict(resident=0)),
    (515, 128, 256, torch.float32, dict(cb=64)),
    (77, 512, 1024, torch.float32, dict(bm=16, cb=128)),
    (200, 24, 40, torch.float32, dict(bm=64)),
]


def _forced_plan(m, c, e, dtype, want):
    return next(p for p in fm.plans(m, c, e, dtype) if all(p[k] == v for k, v in want.items()))


@pytest.mark.parametrize("case", FORCED, ids=lambda f: "M{}-C{}-E{}-{}-{}".format(
    *f[:3], str(f[3])[6:], "-".join(f"{k}{v}" for k, v in f[4].items())))
def test_fused_mlp_forced_plans_match_plain(device, case):
    """Each kind of plan against the plain version, and two launches of it
    bit-identical (a cluster sums its blocks' partials in rank order)."""
    m, c, e, dtype, want = case
    plan = _forced_plan(m, c, e, dtype, want)
    x, w1, b1, w2, b2 = _mlp_inputs(m, c, e, dtype, device)
    got = fm.fused_mlp_residual(x, w1, b1, w2, b2, plan=plan)
    again = fm.fused_mlp_residual(x, w1, b1, w2, b2, plan=plan)
    want_out = fm.fused_mlp_residual_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _check_mlp(got, want_out, x, w1, b1, w2, b2)


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_fused_mlp_cluster_split_is_bit_identical(device, cs):
    """At the fast recipe's C 256 and C 512 row counts, a plan that splits E
    across a cluster of ``cs`` blocks gives the same bits in three launches,
    and so does the planner's own plan."""
    for m, c, e in ((9216, 256, 512), (1152, 512, 1024)):
        plan = _forced_plan(m, c, e, torch.bfloat16, dict(cs=cs))
        x, w1, b1, w2, b2 = _mlp_inputs(m, c, e, torch.bfloat16, device)
        for p in (plan, None):
            outs = [fm.fused_mlp_residual(x, w1, b1, w2, b2, plan=p) for _ in range(3)]
            torch.cuda.synchronize()
            assert all(torch.equal(outs[0], o) for o in outs[1:])
        _check_mlp(outs[0], fm.fused_mlp_residual_plain(x, w1, b1, w2, b2), x, w1, b1, w2, b2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 5, 7, 9, 32, 32), (3, 33, 16, 48), (1000, 64, 16)], ids=str)
def test_pointwise_kernel_matches_plain(device, shape, dtype):
    *lead, c, cout = shape
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((*lead, c), dtype=np.float32)).to(device, dtype)
    w = torch.from_numpy((rng.standard_normal((cout, c)) / np.sqrt(c)).astype(np.float32)).to(device, dtype)
    got, want = fm.pointwise(x, w), fm.pointwise_plain(x, w)
    torch.cuda.synchronize()
    assert got.shape == (*lead, cout) and got.dtype == dtype
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert torch.all(err <= 1e-6 * fm.pointwise_plain(x.abs(), w.abs()) + 1e-30)
    else:
        assert err.max().item() <= _bf16_ulps(want, 1)


# (C, Cout): the weight held in registers as mma fragments (bf16, C and Cout
# up to 64) and read from shared memory (wider), with several column blocks
PW_WIDTHS = [(16, 16), (32, 32), (64, 64), (32, 96), (128, 48), (1024, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", PW_WIDTHS, ids=lambda w: "C{}-Cout{}".format(*w))
@pytest.mark.parametrize("rows", [1, 127, 129, 100003])
def test_pointwise_kernel_rows_and_widths(device, rows, width, dtype):
    c, cout = width
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(device, dtype)
    w = torch.from_numpy((rng.standard_normal((cout, c)) / np.sqrt(c)).astype(np.float32)).to(device, dtype)
    got, again, want = fm.pointwise(x, w), fm.pointwise(x, w), fm.pointwise_plain(x, w)
    torch.cuda.synchronize()
    assert got.shape == (rows, cout) and got.dtype == dtype
    assert torch.equal(got, again)  # two launches bit-identical
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert torch.all(err <= 1e-6 * fm.pointwise_plain(x.abs(), w.abs()) + 1e-30)
    else:
        assert err.max().item() <= _bf16_ulps(want, 1)


def test_fused_mlp_never_falls_back(device):
    x, w1, b1, w2, b2 = _mlp_inputs(64, 32, 64, torch.float32, device)
    with pytest.raises(TypeError):  # bf16 weights with f32 x
        fm.fused_mlp_residual(x, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(TypeError):
        fm.fused_mlp_residual(x.half(), w1.half(), b1, w2.half(), b2)
    # widths that are not multiples of 16: the kernel takes them (they raised before)
    x24, w124, w224 = x[:, :24].contiguous(), w1[:24].contiguous(), w2[:, :24].contiguous()
    got = fm.fused_mlp_residual(x24, w124, b1, w224, b2[:24])
    _check_mlp(got, fm.fused_mlp_residual_plain(x24, w124, b1, w224, b2[:24]), x24, w124, b1, w224, b2[:24])
    with pytest.raises(ValueError):  # not contiguous
        fm.pointwise(x.t(), torch.zeros((16, 64), device=device))
    with pytest.raises(RuntimeError, match="shape not supported"):  # bf16 C past 1024
        xb = torch.zeros((16, 2048), device=device, dtype=torch.bfloat16)
        fm.fused_mlp_residual(xb, torch.zeros((2048, 16), device=device, dtype=torch.bfloat16),
                              torch.zeros(16, device=device), torch.zeros((16, 2048), device=device, dtype=torch.bfloat16),
                              torch.zeros(2048, device=device))
    with pytest.raises(RuntimeError, match="no backward pass"):
        fm.fused_mlp_residual(x, w1.clone().requires_grad_(True), b1, w2, b2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 1024), (1000, 37)], ids=str)
def test_fma_chain_kernel_matches_plain(device, shape, dtype):
    a = torch.from_numpy(np.random.default_rng(6).standard_normal(shape, dtype=np.float32)).to(device, dtype)
    got, want = probes.fma_chain(a, 256), probes.fma_chain_plain(a, 256)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)  # one rounding a step both ways
    else:
        # one fmaf a step; the plain version rounds through float64, which can
        # differ at a float32 tie: a few ulps at the largest output
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fma27_kernel_matches_plain(device, dtype):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((5, 16, 389), dtype=np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.standard_normal(27).astype(np.float32) * 0.2).to(device)
    got, want = probes.fma27(x, w), probes.fma27_plain(x, w)
    # the taps as a (3, 3, 3) float32 tensor are used in place, and in another dtype converted
    taps = probes.fma27(x, w.reshape(3, 3, 3)), probes.fma27(x, w.double())
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert all(torch.equal(got, t) for t in taps)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_probe_launches_on_the_current_stream(device, dtype):
    """The FMA probes launch on the caller's current stream (the raw handle
    of the shared launch path) and count one launch each; a CUDA graph
    captures them."""
    a = torch.from_numpy(np.random.default_rng(9).standard_normal((64, 128), dtype=np.float32)).to(device, dtype)
    w = torch.full((27,), 0.5, device=device)
    want_chain, want_27 = probes.fma_chain(a, 64), probes.fma27(a, w)
    before = (probes.fma_chain.launches, probes.fma27.launches)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_chain, got_27 = probes.fma_chain(a, 64), probes.fma27(a, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_chain, g_27 = probes.fma_chain(a, 64), probes.fma27(a, w)
    graph.replay()
    torch.cuda.synchronize()
    assert (probes.fma_chain.launches, probes.fma27.launches) == (before[0] + 2, before[1] + 2)
    for got, want in ((got_chain, want_chain), (got_27, want_27), (g_chain, want_chain), (g_27, want_27)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lanes", [14592, 200, 37])
def test_lane_shift_kernel_matches_plain(device, dtype, lanes):
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((32, lanes), dtype=np.float32)).to(device, dtype)
    for off in (0, 1, 5, 8, 128, -1, -128, lanes, -lanes - 3, 3 * lanes + 2):
        for circ in (False, True):
            assert torch.equal(probes.lane_shift(x, off, circ), probes.lane_shift_plain(x, off, circ)), (off, circ)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 2**20 + 8), (5, 4104)], ids=str)
def test_lane_shift_unaligned_offsets_match_plain(device, dtype, shape):
    """Offsets that are not whole 16-byte pieces: each output piece is built
    from the two source pieces it spans, wrapped or zero-filled per piece."""
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(shape, dtype=np.float32)).to(device, dtype)
    for off in (1, 5, 7, -3, -129):
        for circ in (False, True):
            assert torch.equal(probes.lane_shift(x, off, circ), probes.lane_shift_plain(x, off, circ)), (off, circ)


def test_probes_never_fall_back(device):
    a = torch.zeros((4, 16), device=device)
    with pytest.raises(TypeError):
        probes.fma_chain(a.half())
    with pytest.raises(ValueError):
        probes.fma_chain(a.t())
    with pytest.raises(ValueError):
        probes.fma27(a, torch.zeros(26, device=device))
    with pytest.raises(TypeError):
        probes.lane_shift(a.double(), 1)
