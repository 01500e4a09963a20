"""The port's dense 3^3 conv (``ops/conv3d.py``, plain path on the CPU)
against the JAX package's ``conv3d_3x3_pallas`` run in interpret mode and
its XLA dispatcher ``conv3d_3x3(force_pallas=False)``, on the same seeded
inputs. Tolerances: f32, 1e-5 of the summed magnitudes (the sums run in
another order); bf16, two ulps at the output's largest magnitude (both
sum bf16 products exactly in f32, round, add the bias and round again, so a
value can land an ulp apart at each rounding)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pytorch_connectomics_tpu.ops import conv3d_pallas as cp
from pytorch_connectomics_tpu_torch.ops import conv3d as c3


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(shape, cout, seed, bias):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.5).astype(np.float32) if bias else None
    return x, w, b


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# (x shape, Cout, Pallas block, bias): aligned, the unaligned shape of
# tests/unit/test_pallas_conv.py, the stem's Cin = 1, RSUNet's 28 -> 36
CASES = [
    ((2, 8, 8, 32, 16), 8, (4, 4, 32), False),
    ((1, 5, 9, 33, 8), 8, (4, 4, 16), False),
    ((1, 4, 6, 16, 1), 28, (4, 2, 16), True),
    ((1, 4, 6, 10, 28), 36, (4, 2, 8), True),
    ((1, 4, 4, 16, 8), 4, (4, 4, 16), True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-{c[1]}" + ("-bias" if c[3] else ""))
def test_conv3d_matches_jax(interpret_mode, case, dtype):
    shape, cout, block, bias = case
    x, w, b = _inputs(shape, cout, seed=sum(shape) + cout, bias=bias)
    jdt = jnp.dtype(dtype)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    bj = None if b is None else jnp.asarray(b)
    want_pallas = np.asarray(cp.conv3d_3x3_pallas(xj, wj, bj, block=block).astype(jnp.float32))
    want_xla = np.asarray(cp.conv3d_3x3(xj, wj, bj, force_pallas=False).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = c3.conv3d_3x3(torch.from_numpy(x).to(tdt), torch.from_numpy(w), None if b is None else torch.from_numpy(b),
                        layout="dhwio")
    assert got.dtype == tdt and got.shape == (*shape[:4], cout)
    got = got.float().numpy()
    if dtype == "float32":
        mag = c3.conv3d_3x3_plain(torch.from_numpy(np.abs(x)), torch.from_numpy(np.abs(w)), layout="dhwio").numpy()
        mag = mag + (0 if b is None else np.abs(b))
        for want in (want_pallas, want_xla):
            assert np.all(np.abs(got - want) <= 1e-5 * mag), (np.abs(got - want) / mag).max()
    else:
        tol = 2.0 ** (np.floor(np.log2(np.abs(want_pallas).max())) - 6)  # two bf16 ulps
        for want in (want_pallas, want_xla):
            assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin", [1, 3, 8, 28, 36])
def test_kernel_weight_layout(cin, dtype):
    """The weight matrix the CUDA kernel takes, multiplied the way the
    kernel multiplies it (tap-wise over CP = Cin rounded up to 8 zero-padded
    channels, then zero rows to a multiple of 16; or one
    packed patch matrix of 27 * Cin columns), gives the plain conv: the
    layout contract of ``csrc/conv3d_3x3.cu`` checked on the CPU."""
    cout = 20
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((1, 3, 4, 5, cin)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3, 3)).astype(np.float32))
    wmat = c3.kernel_weight(w, dtype).double()
    assert wmat.shape[1] == 32 and torch.all(wmat[:, cout:] == 0)
    xp = torch.nn.functional.pad(x.double(), (0, 0, 1, 1, 1, 1, 1, 1))
    taps = [xp[:, dz : dz + 3, dy : dy + 4, dx : dx + 5] for dz in range(3) for dy in range(3) for dx in range(3)]
    if dtype == torch.bfloat16 and cin >= 8:
        cp_ = -(-cin // 8) * 8
        assert wmat.shape[0] == -(-27 * cp_ // 16) * 16 and torch.all(wmat[27 * cp_ :] == 0)
        out = sum(torch.nn.functional.pad(t, (0, cp_ - cin)) @ wmat[i * cp_ : (i + 1) * cp_] for i, t in enumerate(taps))
    else:
        patch = torch.cat(taps, dim=-1)
        assert wmat.shape[0] >= 27 * cin and (dtype == torch.float32 or wmat.shape[0] % 16 == 0)
        out = torch.nn.functional.pad(patch, (0, wmat.shape[0] - 27 * cin)) @ wmat
    want = c3.conv3d_3x3_plain(x.double(), w.to(dtype).double())
    torch.testing.assert_close(out[..., :cout], want, rtol=1e-12, atol=1e-12)


def test_conv3d_refuses_grad_and_bad_layout():
    """With grad enabled and a weight that requires grad the conv is
    differentiable (through ``Conv3x3Function``: dW equals autograd through
    the plain version); the backward wrappers themselves refuse grad; a bad
    layout still raises."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 2, 3, 2, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 4, 3, 3, 3)).astype(np.float32)).requires_grad_(True)
    y = c3.conv3d_3x3(x, w)
    assert y.grad_fn is not None
    y.square().sum().backward()
    got, w.grad = w.grad, None
    c3.conv3d_3x3_plain(x, w).square().sum().backward()
    torch.testing.assert_close(got, w.grad, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert c3.conv3d_3x3(x, w).shape == (1, 2, 3, 2, 5)
    with pytest.raises(RuntimeError, match="no backward pass"):
        c3.conv3d_3x3_wgrad(x, y)
    with pytest.raises(RuntimeError, match="no backward pass"):
        c3.conv3d_3x3_input_grad(y, w)
    with pytest.raises(ValueError):
        c3.conv3d_3x3_plain(x, torch.zeros((4, 4, 3, 3, 3)), layout="dhwio")


def _wgrad_emulate(x, dy, plan):
    """The bf16 weight-gradient kernel's decomposition (``csrc/conv3d_3x3.cu``,
    ``conv3d_wgrad_wgmma_kernel``) in f32 torch, on the layout
    :func:`conv3d.wgrad_geometry` gives: rows of a row block padded to 64
    (tap-major, CP = Cin rounded up to 8 channels a tap, Cin packed below
    8), N columns a slice, items in the kernel's order (row group, then row
    block, column slice, chunk), each summing its chunk's tiles into its
    partial rows and skipping the tiles whose z slice lies outside the
    volume with tap groups; then the sum kernel's fixed order (chunks q, q +
    32, ... per thread row q, then the 32 sums in order) and its map from
    rows to (tap, channel)."""
    b, z, y, xw, cin = x.shape
    cout = dy.shape[-1]
    geo = c3.wgrad_geometry(tuple(x.shape), cout, plan)
    n, slices, tr, rb = geo["n"], geo["slices"], geo["tap_rows"], geo["rows_per_block"]
    groups, xs, r, mt = plan["tap_groups"], plan["xs"], plan["r"], plan["m_tiles"]
    taps, cols = 27 // groups, slices * n
    ty, tx = -(-y // r), -(-xw // xs)
    xp = torch.zeros((b, z + 2, ty * r + 2, tx * xs + 2, tr))
    xp[:, 1 : z + 1, 1 : y + 1, 1 : xw + 1, :cin] = x
    dp = torch.zeros((b, z, ty * r, tx * xs, cols))
    dp[:, :, :y, :xw, :cout] = dy
    partial = torch.zeros((geo["chunks"], geo["rows_per_chunk"], cols))
    for item in range(geo["items"]):
        grp, rest = item % geo["row_groups"], item // geo["row_groups"]
        blk, rest = rest % groups, rest // groups
        sl, chunk = rest % slices, rest // slices
        lo, hi = grp * 2 * mt * 64, min(rb, (grp + 1) * 2 * mt * 64)
        rows = torch.arange(lo, hi)
        tl, ci = rows // tr, rows % tr
        live = tl < taps
        tap = blk * taps + torch.where(live, tl, 0)
        for t in range(chunk * geo["tiles_per_chunk"], min(geo["tiles"], (chunk + 1) * geo["tiles_per_chunk"])):
            tx_, rest = t % tx, t // tx
            ty_, rest = rest % ty, rest // ty
            zz, bb = rest % z, rest // z
            if groups == 3 and not 0 <= zz + blk - 1 < z:
                continue
            y0, x0 = ty_ * r, tx_ * xs
            # A[row][voxel] = x(voxel + tap - 1)[ci]: the padded volume at the tap's offset
            cells = xp[bb, zz:zz + 3, y0:y0 + r + 2, x0:x0 + xs + 2]
            a = torch.stack([cells[tp // 9, tp // 3 % 3 : tp // 3 % 3 + r, tp % 3 : tp % 3 + xs].reshape(r * xs, tr)
                             for tp in range(27)])[tap, :, ci] * live[:, None]
            d = dp[bb, zz, y0:y0 + r, x0:x0 + xs, sl * n : (sl + 1) * n].reshape(r * xs, n)
            partial[chunk, blk * rb + lo : blk * rb + hi, sl * n : (sl + 1) * n] += a @ d
    sums = [sum(partial[c] for c in range(q, geo["chunks"], 32)) for q in range(min(32, geo["chunks"]))]
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    out = torch.zeros((cout, cin, 27))
    for row in range(geo["rows_per_chunk"]):
        blk, rr = divmod(row, rb)
        tl, ci = divmod(rr, tr)
        if tl < taps and ci < cin:
            out[:, ci, blk * taps + tl] = total[row, :cout]
    return out.reshape(cout, cin, 3, 3, 3), geo


# (x shape, Cout, plan): tap groups with two row groups (CP 16, N 24); all 27
# taps of Cin 36 (CP 40, 1088 rows, three row groups of 3 M tiles a
# warpgroup); the packed stem; Cout 136 in two column slices of N 72 -> 80;
# more than 32 chunks (the sum's thread rows each add several); Cout 256 in
# two 128-column blocks (BasicUNet's bottleneck)
WGRAD_PLANS = [
    ((1, 3, 5, 18, 12), 20, dict(xs=16, r=2, m_tiles=1, tap_groups=3)),
    ((2, 2, 4, 9, 36), 28, dict(xs=16, r=4, m_tiles=3, tap_groups=1)),
    ((1, 4, 6, 16, 1), 28, dict(xs=16, r=3, m_tiles=1, tap_groups=1)),
    ((1, 2, 3, 16, 8), 136, dict(xs=16, r=2, m_tiles=2, tap_groups=3)),
    ((2, 4, 8, 40, 8), 16, dict(xs=16, r=1, m_tiles=1, tap_groups=3)),
    ((1, 2, 3, 16, 8), 256, dict(xs=16, r=2, m_tiles=1, tap_groups=3)),
]


@pytest.mark.parametrize("case", WGRAD_PLANS,
                         ids=["groups-12-20", "all-taps-36-28", "stem", "slices-136", "chunks", "slices-256"])
def test_wgrad_decomposition_matches_plain_and_jax(case):
    """The bf16 weight-gradient kernel's decomposition, emulated in f32
    (:func:`_wgrad_emulate`), against ``conv3d_3x3_wgrad_plain`` and against
    ``jax.vjp`` of flax's ``nn.Conv`` kernel gradient: 1e-5 of the summed
    magnitudes (the same products summed in another order). Also the
    geometry's padding: rows a block a multiple of 64, N the narrowest built
    width that holds Cout over its slices."""
    import flax.linen as nn

    shape, cout, plan = case
    rng = np.random.default_rng(sum(shape) + cout)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((*shape[:4], cout)).astype(np.float32)
    got, geo = _wgrad_emulate(torch.from_numpy(x), torch.from_numpy(g), plan)
    assert geo["rows_per_block"] % 64 == 0 and geo["rows_per_block"] - 64 < 27 // plan["tap_groups"] * geo["tap_rows"]
    assert geo["n"] == min(w for w in c3.WGRAD_WIDTHS if w >= -(-cout // geo["slices"]))
    cin = shape[-1]
    k = rng.standard_normal((3, 3, 3, cin, cout)).astype(np.float32)
    conv = nn.Conv(cout, (3, 3, 3), padding="SAME", use_bias=False)
    _, vjp = jax.vjp(lambda kk: conv.apply({"params": {"kernel": kk}}, jnp.asarray(x)), jnp.asarray(k))
    jdk = np.asarray(vjp(jnp.asarray(g))[0]).transpose(4, 3, 0, 1, 2)
    plain = c3.conv3d_3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    mag = c3.conv3d_3x3_wgrad_plain(torch.from_numpy(np.abs(x)), torch.from_numpy(np.abs(g))).numpy()
    for want in (plain, jdk):
        assert np.all(np.abs(got.numpy() - want) <= 1e-5 * mag + 1e-30), (np.abs(got.numpy() - want) / mag).max()
