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
