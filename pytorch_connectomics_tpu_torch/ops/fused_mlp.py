"""The fused pointwise MLP with residual, and the pointwise (1x1x1) conv, as
hand-written CUDA kernels (``csrc/fused_mlp.cu``) with a plain PyTorch
version of each beside it.

- :func:`fused_mlp_residual` -> ``x + gelu_tanh(x @ w1 + b1) @ w2 + b2`` on
  rows ``x (M, C)``, with ``w1 (C, E)``, ``b1 (E,)``, ``w2 (E, C)``, ``b2
  (C,)``: the JAX package's signature and weight layout. Both products take
  operands in x's dtype and accumulate in f32; ``b1`` is added in f32 before
  the tanh-GELU; the hidden activation is rounded to x's dtype before the
  second product; ``b2`` and the residual are added in f32 and the result is
  rounded once. Replaces the TPU kernel ``fused_mlp_residual`` of
  ``pytorch_connectomics_tpu/ops/fused_mlp_pallas.py:40``;
  :func:`fused_mlp_residual_ndhwc` is its NDHWC wrapper (``:70``).
- :func:`pointwise` -> ``x @ w.T`` for ``x (..., C)`` and ``w (Cout, C)``,
  accumulated in f32 and rounded to x's dtype, no bias: the function of the
  pointwise probes ``pw_cf`` of ``scripts/tpu_bf16_experiments.py:181`` and
  ``scripts/tpu_bf16_experiments2.py:171``. Kernels of its own: float32 in
  register tiles on the CUDA cores (one ``fmaf`` a term in k order, no
  TF32), bfloat16 on the tensor cores.

The weights must be in x's dtype (the JAX op would promote mixed dtypes,
which is another function); the biases may be float32 or x's dtype and are
used in float32. The kernels take float32 or bfloat16 with C, E and Cout
multiples of 16 (E and Cout up to any width: the hidden units are walked in
chunks, the outputs in column blocks; C up to 1024 in bfloat16 and, in the
pointwise conv, 1536 in float32); the plain versions take any width.

Given CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute. Neither has a backward pass: called with grad
enabled on a tensor that requires grad, a wrapper raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .fused_block import _dtype_code, _require, refuse_grad


def _acc(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _check_weights(x: torch.Tensor, *ws: torch.Tensor) -> None:
    for w in ws:
        if w.dtype != x.dtype:
            raise TypeError(f"the weights must be in x's dtype {x.dtype}, got {w.dtype}")


def fused_mlp_residual_plain(x, w1, b1, w2, b2):
    """The kernel's arithmetic in PyTorch, in float32 (float64 for float64 x)."""
    acc = _acc(x)
    xf = x.to(acc)
    h = F.gelu(xf @ w1.to(acc) + b1.to(acc), approximate="tanh")
    y = h.to(x.dtype).to(acc) @ w2.to(acc) + b2.to(acc)
    return (xf + y).to(x.dtype)


def pointwise_plain(x, w):
    """``x @ w.T`` in float32 (float64 for float64 x), rounded to x's dtype."""
    acc = _acc(x)
    return (x.to(acc) @ w.to(acc).t()).to(x.dtype)


def _check(code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"fused MLP kernel failed: {lib.fused_mlp_error_string(code).decode()}")


def _check_tensors(x, c, n, *ts):
    _require(c % 16 == 0 and n % 16 == 0, "widths must be multiples of 16, got {} and {}", c, n)
    for t in ts:
        _require(t.device == x.device, "all tensors must be on the device of x")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0, "tensors must be contiguous and 16-byte aligned")


def fused_mlp_residual(x, w1, b1, w2, b2):
    """(M, C) in x's dtype: ``x + gelu_tanh(x @ w1 + b1) @ w2 + b2``; see the
    module doc."""
    refuse_grad("fused_mlp_residual", x, w1, b1, w2, b2)
    _require(x.dim() == 2, f"x must be (M, C), got {tuple(x.shape)}")
    m, c = x.shape
    _require(w1.dim() == 2 and w1.shape[0] == c, f"w1 must be ({c}, E), got {tuple(w1.shape)}")
    e = w1.shape[1]
    _require(w2.shape == (e, c), f"w2 must be ({e}, {c}), got {tuple(w2.shape)}")
    _require(b1.shape == (e,) and b2.shape == (c,), f"b1 must be ({e},) and b2 ({c},)")
    _check_weights(x, w1, w2)
    if x.device.type == "cpu":
        return fused_mlp_residual_plain(x, w1, b1, w2, b2)
    code = _dtype_code(x)
    out = torch.empty_like(x)
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    _check_tensors(x, c, e, x, w1, b1, w2, b2, out)
    lib = build.load("fused_mlp")
    ptr = [t.data_ptr() for t in (x, w1, b1, w2, b2, out)]
    _check(lib.fused_mlp_fwd(*ptr, code, m, c, e, build.stream(x.get_device())), lib)
    fused_mlp_residual.launches += 1
    return out


fused_mlp_residual.launches = 0


def fused_mlp_residual_ndhwc(x, w1, b1, w2, b2):
    """NDHWC wrapper: the leading dims of ``x (..., C)`` flattened to rows."""
    return fused_mlp_residual(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2).reshape(x.shape)


def pointwise(x, w):
    """(..., Cout) in x's dtype: ``x @ w.T``; see the module doc."""
    refuse_grad("pointwise", x, w)
    c = x.shape[-1]
    _require(w.dim() == 2 and w.shape[1] == c, f"w must be (Cout, {c}), got {tuple(w.shape)}")
    _check_weights(x, w)
    if x.device.type == "cpu":
        return pointwise_plain(x, w)
    code = _dtype_code(x)
    _require(x.is_contiguous(), "x must be contiguous (..., C)")
    cout = w.shape[0]
    out = torch.empty((*x.shape[:-1], cout), device=x.device, dtype=x.dtype)
    _check_tensors(x, c, cout, x, w, out)
    lib = build.load("fused_mlp")
    _check(lib.pointwise_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), code, x.numel() // c, c, cout,
                             build.stream(x.get_device())), lib)
    pointwise.launches += 1
    return out


pointwise.launches = 0

KERNELS = (fused_mlp_residual, pointwise)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
