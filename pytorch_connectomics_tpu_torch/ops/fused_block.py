"""The fused MedNeXt block: a depthwise 3^3 conv, per-channel GroupNorm,
pointwise expand, tanh-GELU, pointwise compress and residual, as two
hand-written CUDA kernels (``csrc/mednext_block.cu``) with a plain PyTorch
version of each beside it.

- :func:`dw_stats` -> per-(b, c) ``[sum dw(x), sum dw(x)^2]`` over the volume
  (dw without bias): the GroupNorm statistics. Replaces the TPU kernel
  ``dw_stats`` of ``pytorch_connectomics_tpu/ops/fused_block_pallas.py:148``.
- :func:`fused_block_apply` -> ``x + W2 . gelu_tanh(W1 . GN(dw(x) + b_dw) + b1) + b2``
  given those statistics. Replaces ``fused_block_apply_cf`` (``:238``) with
  the GroupNorm folding of ``fold_block_weights`` (``:294``) done in-kernel.

Activations are channels-last ``(B, Z, Y, X, C)``, contiguous, float32 or
bfloat16. Weights keep PyTorch's layouts: ``w_dw`` ``(C, 1, 3, 3, 3)``,
``w1`` ``(R, C)``, ``w2`` ``(Cout, R)`` (``nn.Linear``), biases and norm
affine ``(n,)``. The kernels take ``w1`` and ``w2`` in x's dtype (the caller
casts them once, not per call) and the other parameters in float32.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its kernel launches in
its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

EPS = 1e-6  # flax GroupNorm epsilon


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"MedNeXt block kernels take float32 or bfloat16, got {t.dtype}")


def _check(code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"MedNeXt block kernel failed: {lib.mednext_error_string(code).decode()}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda_inputs(x: torch.Tensor, *others: torch.Tensor) -> None:
    _require(x.dim() == 5, f"x must be (B, Z, Y, X, C), got {tuple(x.shape)}")
    _require(x.is_contiguous(), "x must be contiguous channels-last (B, Z, Y, X, C)")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    c = x.shape[-1]
    _require(c % 16 == 0 and c <= 1024, f"channels must be a multiple of 16 up to 1024, got {c}")
    for t in others:
        _require(t.device == x.device, "all tensors must be on the device of x")
        _require(t.is_contiguous(), "weights must be contiguous")


# ---------------------------------------------------------------------------
# dw_stats
# ---------------------------------------------------------------------------


def dw_stats_plain(x: torch.Tensor, w_dw: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) float32 ``[sum, sumsq]`` of the bias-free depthwise 3^3 SAME
    conv of channels-last ``x``, in float32."""
    c = x.shape[-1]
    xf = x.float().permute(0, 4, 1, 2, 3)
    t = F.conv3d(xf, w_dw.float().reshape(c, 1, 3, 3, 3), padding=1, groups=c)
    return torch.stack([t.sum(dim=(2, 3, 4)), (t * t).sum(dim=(2, 3, 4))], dim=1)


def dw_stats(x: torch.Tensor, w_dw: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) float32 GroupNorm statistics of dw(x); see the module doc."""
    if x.device.type == "cpu":
        return dw_stats_plain(x, w_dw)
    _dtype_code(x)
    w = w_dw.float().reshape(x.shape[-1], 27).contiguous()
    _check_cuda_inputs(x, w)
    lib = build.load("mednext_block")
    b, z, y, xs, c = x.shape
    code = _dtype_code(x)
    parts = lib.mednext_stats_parts(b, z, y, xs, c, code)
    partial = torch.empty((b, parts, 2, c), device=x.device, dtype=torch.float32)
    out = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mednext_dw_stats(
        x.data_ptr(), w.data_ptr(), partial.data_ptr(), out.data_ptr(),
        code, b, z, y, xs, c, parts, stream,
    )
    _check(rc, lib)
    dw_stats.launches += 1
    return out


dw_stats.launches = 0


# ---------------------------------------------------------------------------
# fused_block_apply
# ---------------------------------------------------------------------------


def fused_block_apply_plain(
    x, stats, w_dw, gamma, beta, w1, b1, w2, b2, eps: float = EPS
) -> torch.Tensor:
    """The apply kernel's arithmetic in PyTorch: the normalised stencil and
    the hidden activation are rounded to x's dtype where the kernel stores
    them, matmuls and sums accumulate in float32."""
    b, z, y, xs, c = x.shape
    n = z * y * xs
    dt = x.dtype
    mean = stats[:, 0] / n
    var = torch.clamp(stats[:, 1] / n - mean * mean, min=0.0)
    scale = gamma.float()[None] * torch.rsqrt(var + eps)  # (B, C)
    shift = beta.float()[None] - mean * scale
    xf = x.float().permute(0, 4, 1, 2, 3)
    t = F.conv3d(xf, w_dw.float().reshape(c, 1, 3, 3, 3), padding=1, groups=c)
    t = t.permute(0, 2, 3, 4, 1)  # (B, Z, Y, X, C)
    u = (t * scale[:, None, None, None] + shift[:, None, None, None]).to(dt).float()
    h = F.gelu(u @ w1.to(dt).float().t() + b1.float(), approximate="tanh").to(dt).float()
    o = h @ w2.to(dt).float().t() + b2.float()
    if w2.shape[0] == c:
        o = o + x.float()
    return o.to(dt)


def fused_block_apply(
    x, stats, w_dw, gamma, beta, w1, b1, w2, b2, eps: float = EPS
) -> torch.Tensor:
    """(B, Z, Y, X, Cout) in x's dtype: the whole block given
    :func:`dw_stats` of x; see the module doc."""
    if x.device.type == "cpu":
        return fused_block_apply_plain(x, stats, w_dw, gamma, beta, w1, b1, w2, b2, eps)
    code = _dtype_code(x)
    b, z, y, xs, c = x.shape
    r, cout = w1.shape[0], w2.shape[0]
    _require(w1.shape == (r, c), f"w1 must be (R, C) = (*, {c}), got {tuple(w1.shape)}")
    _require(w2.shape == (cout, r), f"w2 must be (Cout, R) = (*, {r}), got {tuple(w2.shape)}")
    _require(r % 16 == 0 and (r <= 64 or r % 64 == 0), f"hidden width {r} not supported")
    _require(cout % 16 == 0, f"output channels must be a multiple of 16, got {cout}")
    _require(w1.dtype == x.dtype and w2.dtype == x.dtype, f"w1 and w2 must be {x.dtype} like x")
    w_dw = w_dw.reshape(c, 27)
    for t in (stats, w_dw, gamma, beta, b1, b2):
        _require(t.dtype == torch.float32, "stats, w_dw, norm affine and biases must be float32")
    _require(stats.shape == (b, 2, c), f"stats must be (B, 2, C), got {tuple(stats.shape)}")
    _check_cuda_inputs(x, stats, w_dw, gamma, beta, w1, b1, w2, b2)
    _require(w1.data_ptr() % 32 == 0 and w2.data_ptr() % 32 == 0, "weights must be 32-byte aligned")
    lib = build.load("mednext_block")
    out = torch.empty((b, z, y, xs, cout), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mednext_block_apply(
        x.data_ptr(), stats.data_ptr(), w_dw.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        code, b, z, y, xs, c, r, cout, ctypes.c_float(eps), stream,
    )
    _check(rc, lib)
    fused_block_apply.launches += 1
    return out


fused_block_apply.launches = 0


def fused_mednext_block(x, w_dw, gamma, beta, w1, b1, w2, b2, eps: float = EPS) -> torch.Tensor:
    """Statistics pass then apply pass: the block on channels-last x."""
    return fused_block_apply(x, dw_stats(x, w_dw), w_dw, gamma, beta, w1, b1, w2, b2, eps)


def fused_mednext_block_plain(x, w_dw, gamma, beta, w1, b1, w2, b2, eps: float = EPS) -> torch.Tensor:
    """Both plain versions, on any device."""
    return fused_block_apply_plain(x, dw_stats_plain(x, w_dw), w_dw, gamma, beta, w1, b1, w2, b2, eps)


KERNELS = (dw_stats, fused_block_apply)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
