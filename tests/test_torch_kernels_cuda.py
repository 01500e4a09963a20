"""The MedNeXt block CUDA kernels against their plain PyTorch versions, on
the card. Skipped where there is no CUDA device. This file imports no JAX,
so it also runs with ``--noconftest`` on a machine without JAX:

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
# at batch 2, plus ragged tiles and a channel-changing block
SHAPES = [
    (2, 96, 64, 48, 32, 64, 32),
    (2, 48, 32, 24, 64, 128, 64),
    (2, 24, 16, 12, 128, 256, 128),
    (2, 12, 8, 6, 256, 512, 256),
    (2, 6, 4, 3, 512, 1024, 512),
    (3, 5, 7, 9, 16, 32, 16),
    (1, 4, 6, 10, 32, 64, 48),
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
