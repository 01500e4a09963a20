"""The depthwise 3^3 SAME stride-1 convolution of the MedNeXt block's
training path, forward and backward, as two hand-written CUDA kernels
(``csrc/depthwise3x3.cu``) with a plain PyTorch version of each beside it.

- :func:`depthwise3x3` -> ``y = dw(x) + bias``: f32 accumulation, the bias
  added in f32 and one rounding to x's dtype. Replaces the TPU kernel
  ``depthwise3x3_pallas`` of
  ``pytorch_connectomics_tpu/ops/depthwise_pallas.py:62``. With the taps
  mirrored in z, y and x and no bias it is also the input gradient.
- :func:`depthwise3x3_wgrad` -> ``(dw, db)``: the weight gradient
  ``dw[c, t] = sum_{b,v} x[b, v + o_t, c] * dy[b, v, c]`` and the bias
  gradient ``db[c] = sum dy[..., c]``, summed in f32 in a fixed order (two
  runs give bit-identical results). The JAX package has no such kernel: XLA
  differentiates its depthwise conv.
- :class:`DepthwiseConv3x3Function` ties them into autograd: its backward
  returns ``(dx, dw, db)`` from the two kernels.

Activations are channels-last ``(B, Z, Y, X, C)``, contiguous, float32 or
bfloat16; the weight is PyTorch's ``(C, 1, 3, 3, 3)`` and the bias ``(C,)``,
both float32. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises. Each wrapper counts its kernel
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .fused_block import _check_cuda_inputs, _dtype_code, _require, refuse_grad

MAX_CHANNELS = 512


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 input (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _check(code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"depthwise 3^3 kernel failed: {lib.depthwise3x3_error_string(code).decode()}")


def _check_shape(x: torch.Tensor) -> None:
    _check_cuda_inputs(x)
    c = x.shape[-1]
    _require(c <= MAX_CHANNELS, f"channels must be at most {MAX_CHANNELS}, got {c}")


# ---------------------------------------------------------------------------
# forward / input gradient
# ---------------------------------------------------------------------------


def depthwise3x3_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv3d(groups=C)`` in float32 (float64 for float64 x), bias
    included, rounded once to x's dtype; channels-last in and out."""
    acc = _acc_dtype(x)
    c = x.shape[-1]
    y = F.conv3d(
        x.to(acc).permute(0, 4, 1, 2, 3), w.to(acc).reshape(c, 1, 3, 3, 3),
        None if bias is None else bias.to(acc), padding=1, groups=c,
    )
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def depthwise3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Z, Y, X, C) in x's dtype: the depthwise 3^3 SAME conv of x plus
    bias; see the module doc."""
    refuse_grad("depthwise3x3", x, w, bias)
    if x.device.type == "cpu":
        return depthwise3x3_plain(x, w, bias)
    code = _dtype_code(x)
    b, z, y, xs, c = x.shape
    _check_shape(x)
    _require(w.numel() == 27 * c, f"w must hold (C, 1, 3, 3, 3) = ({c}, 1, 3, 3, 3), got {tuple(w.shape)}")
    w27 = w.float().reshape(c, 27).contiguous()
    bias = None if bias is None else bias.float().contiguous()
    _require(bias is None or bias.shape == (c,), f"bias must be ({c},)")
    _check_cuda_inputs(x, w27, *(() if bias is None else (bias,)))
    lib = build.load("depthwise3x3")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.depthwise3x3_fwd(
        x.data_ptr(), w27.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        code, b, z, y, xs, c, stream,
    )
    _check(rc, lib)
    depthwise3x3.launches += 1
    return out


depthwise3x3.launches = 0


# ---------------------------------------------------------------------------
# weight and bias gradient
# ---------------------------------------------------------------------------


def depthwise3x3_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dw (C, 1, 3, 3, 3), db (C,))`` as the explicit sum over the 27
    shifted products, in float32 (float64 for float64 input)."""
    acc = _acc_dtype(x)
    _, z, y, xs, c = x.shape
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1, 1, 1))
    d = dy.to(acc)
    taps = [
        (xp[:, i : i + z, j : j + y, k : k + xs] * d).sum(dim=(0, 1, 2, 3))
        for i in range(3) for j in range(3) for k in range(3)
    ]
    return torch.stack(taps, dim=1).reshape(c, 1, 3, 3, 3), d.sum(dim=(0, 1, 2, 3))


def depthwise3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dw (C, 1, 3, 3, 3), db (C,))`` float32 gradients of the depthwise
    conv's weight and bias; see the module doc."""
    refuse_grad("depthwise3x3_wgrad", x, dy)
    if x.device.type == "cpu":
        return depthwise3x3_wgrad_plain(x, dy)
    code = _dtype_code(x)
    _require(dy.shape == x.shape and dy.dtype == x.dtype, "dy must have x's shape and dtype")
    _check_shape(x)
    _check_cuda_inputs(x, dy)
    _require(dy.data_ptr() % 16 == 0, "dy must be 16-byte aligned")
    b, z, y, xs, c = x.shape
    lib = build.load("depthwise3x3")
    parts = lib.depthwise3x3_wgrad_parts(b, z, y, xs, c, code)
    partial = torch.empty((b, parts, 28, c), device=x.device, dtype=torch.float32)
    out = torch.empty((28, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.depthwise3x3_wgrad(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), out.data_ptr(), code, b, z, y, xs, c, parts, stream,
    )
    _check(rc, lib)
    depthwise3x3_wgrad.launches += 1
    return out[:27].t().reshape(c, 1, 3, 3, 3), out[27]


depthwise3x3_wgrad.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class DepthwiseConv3x3Function(torch.autograd.Function):
    """``y = depthwise3x3(x, w, bias)`` whose backward runs the kernels:
    ``dx`` is :func:`depthwise3x3` of ``dy`` with the taps mirrored and no
    bias, ``(dw, db)`` is :func:`depthwise3x3_wgrad`. Saves ``x`` and ``w``."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return depthwise3x3(x, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = depthwise3x3(dy, w.flip((2, 3, 4))) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = depthwise3x3_wgrad(x, dy)
            dw = dw.to(w.dtype)
            db = db.to(w.dtype) if ctx.has_bias else None
        return dx, dw, db


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """The differentiable depthwise 3^3 conv through the kernels."""
    return DepthwiseConv3x3Function.apply(x, w, bias)


KERNELS = (depthwise3x3, depthwise3x3_wgrad)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
