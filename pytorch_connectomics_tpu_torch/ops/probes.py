"""Op-level measurement probes as hand-written CUDA kernels
(``csrc/probes.cu``), each with a plain PyTorch version beside it: the
functions of the Pallas kernels of the TPU probe scripts, which the port's
measurement entry points (``tools/``) run on the card.

- :func:`fma_chain` -> ``acc = acc + a * m_i`` for ``i < inner``, from zero,
  elementwise in a's dtype, with ``m_i`` the rounding of ``1 + i * 1e-6`` to
  that dtype. Replaces ``_fma_kernel`` of ``scripts/tpu_vpu_probe.py:44``.
  float32 rounds once per step (a fused multiply-add: the Pallas body under
  XLA contracts the multiply into the add); bfloat16 rounds once per step
  too, and every ``m_i`` is 1.0 there, so a step is ``bf16(acc + a)``; the
  kernel takes at most 3907 steps in bfloat16, where that holds.
- :func:`fma27` -> ``round(sum_t f32(x) * w[t])`` over the 27 float32 taps
  ``w``, one fused multiply-add per tap in tap order. Replaces
  ``vpu_kernel`` of ``scripts/tpu_microbench.py:163`` (in float32, XLA on
  the CPU contracts some of its 27 steps and not others: the two agree
  within the rounding of each step, bit for bit once rounded to bf16).
- :func:`lane_shift` -> ``out[..., i] = x[..., i - offset]`` along the last
  axis: circular (``torch.roll``) or with zero fill. Replaces the data
  movement probes of ``scripts/tpu_bf16_experiments.py:66,87`` (copy, roll
  by 5, ``jnp.pad(a[:, 128:])``, roll by 1 through scratch) and
  ``scripts/tpu_bf16_experiments2.py:68`` (``shift_lanes(a, 1)``): a TPU
  shift that reads ``x + off`` is ``lane_shift(x, -off)``. Offset 0 is a
  copy, the copy-bandwidth probe.

The kernels take contiguous float32 or bfloat16 tensors. Given CPU tensors a
wrapper runs the plain version; given CUDA tensors it launches its kernel or
raises. Each wrapper counts its launches in its ``launches`` attribute.
None has a backward pass: with grad enabled on a tensor that requires grad,
a wrapper raises.
"""

from __future__ import annotations

import functools

import torch

from . import build
from .fused_block import _dtype_code, _require, refuse_grad

MAX_INNER = 4096  # fma_chain steps the kernel takes (its multiplier table)
BF16_MAX_INNER = 3907  # steps whose bf16 multipliers 1 + i * 1e-6 all round to 1.0


def _check(code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"probe kernel failed: {lib.probes_error_string(code).decode()}")


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        _require(t.device == ts[0].device, "all tensors must be on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0, "tensors must be contiguous and 16-byte aligned")


def _fma_f64(x64: torch.Tensor, m: float, acc: torch.Tensor) -> torch.Tensor:
    """``fmaf(x, m, acc)`` for float32 values held in float64: the product
    is exact in float64 and the sum is rounded to float32 (through float64;
    the two roundings differ from one only at a float32 tie, which a test
    at these sizes has not met)."""
    return (x64 * m + acc).to(torch.float32).to(torch.float64)


# ---------------------------------------------------------------------------
# fma_chain
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def multipliers(inner: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``1 + i * 1e-6`` for ``i < inner``, rounded from Python floats to
    ``dtype``, as JAX rounds a weakly typed scalar to an array's dtype. Made
    once per (inner, dtype, device): the kernel's table is not uploaded
    again on every launch."""
    m = torch.tensor([1.0 + i * 1e-6 for i in range(inner)], dtype=torch.float64).to(dtype)
    return m if device is None else m.to(device)


def fma_chain_plain(a: torch.Tensor, inner: int = 256) -> torch.Tensor:
    m = multipliers(inner, a.dtype).tolist()
    if a.dtype == torch.float32:
        x = a.double()
        acc = torch.zeros_like(x)
        for mi in m:
            acc = _fma_f64(x, mi, acc)
        return acc.float()
    acc = torch.zeros_like(a)
    for mi in m:  # the Pallas body as written: each op rounds to a's dtype
        acc = acc + (a * mi)
    return acc


def fma_chain(a: torch.Tensor, inner: int = 256) -> torch.Tensor:
    """``a``'s shape and dtype: the FMA chain of ``inner`` steps; see the
    module doc."""
    refuse_grad("fma_chain", a)
    _require(1 <= inner <= MAX_INNER, f"inner must be in [1, {MAX_INNER}], got {inner}")
    # bf16: the kernel rounds a * m_i + acc once, the Pallas body a * m_i first;
    # the two agree while every m_i is 1.0
    _require(a.dtype != torch.bfloat16 or inner <= BF16_MAX_INNER, f"bfloat16 takes at most {BF16_MAX_INNER} steps")
    if a.device.type == "cpu":
        return fma_chain_plain(a, inner)
    code = _dtype_code(a)
    mul = multipliers(inner, a.dtype, a.device)
    out = torch.empty_like(a)
    _check_cuda(a, mul, out)
    lib = build.load("probes")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib.probes_fma_chain(a.data_ptr(), mul.data_ptr(), out.data_ptr(), code, a.numel(), inner, stream), lib)
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


# ---------------------------------------------------------------------------
# fma27
# ---------------------------------------------------------------------------


def fma27_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xf = x.double()
    acc = torch.zeros_like(xf)
    for t in w.reshape(27).float().tolist():
        acc = _fma_f64(xf, t, acc)
    return acc.to(x.dtype)


def fma27(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x``'s shape and dtype: ``round(sum_t f32(x) * w[t])`` over the 27
    taps of ``w`` (27 values, used in float32); see the module doc."""
    refuse_grad("fma27", x, w)
    _require(w.numel() == 27, f"w must hold 27 taps, got {tuple(w.shape)}")
    if x.device.type == "cpu":
        return fma27_plain(x, w)
    code = _dtype_code(x)
    w32 = w.reshape(27).float().contiguous()
    out = torch.empty_like(x)
    _check_cuda(x, w32, out)
    lib = build.load("probes")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib.probes_fma27(x.data_ptr(), w32.data_ptr(), out.data_ptr(), code, x.numel(), stream), lib)
    fma27.launches += 1
    return out


fma27.launches = 0


# ---------------------------------------------------------------------------
# lane_shift
# ---------------------------------------------------------------------------


def lane_shift_plain(x: torch.Tensor, offset: int, circular: bool) -> torch.Tensor:
    if circular:
        return torch.roll(x, offset, dims=-1)
    f = x.shape[-1]
    out = torch.zeros_like(x)
    if offset >= 0:
        if offset < f:
            out[..., offset:] = x[..., : f - offset]
    elif -offset < f:
        out[..., :offset] = x[..., -offset:]
    return out


def lane_shift(x: torch.Tensor, offset: int = 0, circular: bool = False) -> torch.Tensor:
    """``x``'s shape and dtype: ``x`` shifted by ``offset`` along its last
    axis (``out[..., i] = x[..., i - offset]``), circular or zero-filled."""
    refuse_grad("lane_shift", x)
    if x.device.type == "cpu":
        return lane_shift_plain(x, offset, circular)
    code = _dtype_code(x)
    f = x.shape[-1]
    _require(x.dim() >= 1 and f >= 1 and x.numel() >= 1, f"x must be non-empty, got {tuple(x.shape)}")
    _require(f < 2**31, f"the last axis must be shorter than 2**31, got {f}")
    offset = offset % f if circular else max(-f, min(f, offset))
    out = torch.empty_like(x)
    _check_cuda(x, out)
    lib = build.load("probes")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.probes_lane_shift(x.data_ptr(), out.data_ptr(), code, x.numel() // f, f, offset, int(circular), stream)
    _check(rc, lib)
    lane_shift.launches += 1
    return out


lane_shift.launches = 0

KERNELS = (fma_chain, fma27, lane_shift)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
