"""The dense 3^3 SAME stride-1 convolution of RSUNet, as a hand-written CUDA
kernel (``csrc/conv3d_3x3.cu``) with a plain PyTorch version beside it.

:func:`conv3d_3x3` -> ``out = round(conv(x, w)) + bias``, computed on
channels-last ``(B, Z, Y, X, Cin)`` activations with f32 accumulation; the
sum is rounded to x's dtype first and the bias is added after, in x's
dtype (bf16 rounds twice), as flax's ``nn.Conv`` and the TPU kernel do. The
weight is used in x's dtype (flax casts its kernel to the compute dtype).
Replaces the TPU kernel ``conv3d_3x3_pallas`` of
``pytorch_connectomics_tpu/ops/conv3d_pallas.py:84``.

The weight is PyTorch's ``(Cout, Cin, 3, 3, 3)`` (``layout="oidhw"``) or
the JAX package's ``(3, 3, 3, Cin, Cout)`` (``layout="dhwio"``). The kernel
takes it as the tap-major ``(27 * Cin, Cout)`` matrix of the TPU kernel,
zero-padded as :func:`kernel_weight` describes; a caller that keeps a
parameter builds that matrix once per parameter version and passes it as
``wmat`` (``models/rsunet.py``).

The kernel keeps the weight of at least 16 output channels (``27 * Cin *
16`` values) in shared memory next to the input tile, which bounds Cin: up
to 96 in float32 and 192 in bfloat16 (RSUNet's widths reach 64); a wider
input raises. The bf16 tensor-core kernel keeps two input tiles where they
fit beside the weight, so that the next tile's copies run under this
tile's products, and gives each warp 32 or 64 voxels x 32 to 64 output
channels; :func:`kernel_plan` reports the plan it takes for a shape.

Given CPU tensors the wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises. It counts its launches in
``conv3d_3x3.launches``. It has no backward pass: called with grad enabled
on a tensor that requires grad, it raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .fused_block import _dtype_code, _require, refuse_grad


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _dhwio(w: torch.Tensor, layout: str) -> torch.Tensor:
    _require(w.dim() == 5, f"w must be 5-D, got {tuple(w.shape)}")
    if layout == "oidhw":
        _require(tuple(w.shape[2:]) == (3, 3, 3), f"w must be (Cout, Cin, 3, 3, 3), got {tuple(w.shape)}")
        return w.permute(2, 3, 4, 1, 0)
    _require(layout == "dhwio", f"layout must be 'oidhw' or 'dhwio', got {layout!r}")
    _require(tuple(w.shape[:3]) == (3, 3, 3), f"w must be (3, 3, 3, Cin, Cout), got {tuple(w.shape)}")
    return w


def conv3d_3x3_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, layout: str = "oidhw"
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: 27 shifted slices of the
    zero-padded input, each times its tap's ``(Cin, Cout)`` weight in f32
    (f64 for f64 x), summed in tap order, rounded to x's dtype; then the
    bias added in x's dtype."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    wk = _dhwio(w, layout).to(x.dtype).to(acc)
    _, z, y, xs, _ = x.shape
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1, 1, 1))
    out = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                t = xp[:, dz : dz + z, dy : dy + y, dx : dx + xs] @ wk[dz, dy, dx]
                out = t if out is None else out + t
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def kernel_weight(w: torch.Tensor, dtype: torch.dtype, layout: str = "oidhw") -> torch.Tensor:
    """The weight matrix the kernel takes, in ``dtype``, zero-padded to
    ``Np = Cout`` rounded up to 16 columns. Rows, tap-major (tap = (dz*3 +
    dy)*3 + dx):

    - bf16, Cin >= 8: ``27 * CP`` rows, row ``tap * CP + ci``, CP = Cin
      rounded up to 8 (the tensor-core path takes 8 channels of one tap per
      half k-step), then zero rows up to a multiple of 16;
    - bf16, Cin < 8: ``KP`` rows, row ``tap * Cin + ci``, KP = 27 * Cin
      rounded up to 16 (taps and channels packed, as the stem's Cin = 1);
    - float32: ``27 * Cin`` rows, row ``tap * Cin + ci``.

    ``csrc/conv3d_3x3.cu`` (``weight_rows``) checks the same rule."""
    wk = _dhwio(w, layout).detach().to(dtype)
    cin, cout = wk.shape[3], wk.shape[4]
    np_ = _round_up(cout, 16)
    if dtype == torch.bfloat16 and cin >= 8:
        cp = _round_up(cin, 8)
        m = wk.new_zeros((_round_up(27 * cp, 16), np_))
        m[: 27 * cp].view(27, cp, np_)[:, :cin, :cout] = wk.reshape(27, cin, cout)
        return m
    rows = _round_up(27 * cin, 16) if dtype == torch.bfloat16 else 27 * cin
    m = wk.new_zeros((rows, np_))
    m[: 27 * cin, :cout] = wk.reshape(27 * cin, cout)
    return m


def kernel_plan(shape: tuple, cout: int, dtype: torch.dtype) -> dict:
    """The plan the kernel takes for x of ``shape`` (B, Z, Y, X, Cin) and
    ``cout`` output channels in ``dtype``: its tile (``xs`` x-voxels by
    ``r`` rows), channel slice ``nb`` and ``slices``, for the tap-wise
    kernel its warp tile (``warp_m`` voxels x ``warp_n`` channels), warps
    (``warps_m`` x ``warps_n``) and halo buffers, its shared memory, and
    which path (``taps``; ``packed`` for bf16 with Cin < 8; ``f32``).
    Needs the built library (a machine with the CUDA toolkit); raises for a
    shape the kernel does not take."""
    lib = build.load("conv3d_3x3")
    out = (ctypes.c_int * 11)()
    b, z, y, xs, cin = shape
    _check(lib.conv3d_3x3_plan(int(dtype == torch.bfloat16), b, z, y, xs, cin, cout, out), lib)
    v = list(out)
    return dict(xs=v[0], r=v[1], nb=v[2], slices=v[3], warp_m=16 * v[4], warp_n=8 * v[5], warps_m=v[6],
                warps_n=v[7], buffers=v[8], smem_bytes=v[9], kernel=("taps", "packed", "f32")[v[10]])


def _check(code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"conv3d 3^3 kernel failed: {lib.conv3d_3x3_error_string(code).decode()}")


def conv3d_3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    layout: str = "oidhw",
    wmat: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, Z, Y, X, Cout) in x's dtype: the 3^3 SAME stride-1 conv of
    channels-last x plus bias; see the module doc. ``wmat``: the matrix
    :func:`kernel_weight` builds from ``w`` for x's dtype, when the caller
    keeps one."""
    refuse_grad("conv3d_3x3", x, w, bias)
    if x.device.type == "cpu":
        return conv3d_3x3_plain(x, w, bias, layout)
    code = _dtype_code(x)
    _require(x.dim() == 5, f"x must be (B, Z, Y, X, Cin), got {tuple(x.shape)}")
    _require(x.is_contiguous(), "x must be contiguous channels-last (B, Z, Y, X, Cin)")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    b, z, y, xs, cin = x.shape
    wk = _dhwio(w, layout)
    _require(wk.shape[3] == cin, f"w has {wk.shape[3]} input channels, x has {cin}")
    cout = wk.shape[4]
    if wmat is None:
        wmat = kernel_weight(w, x.dtype, layout)
    _require(wmat.dtype == x.dtype, f"the weight matrix must be {x.dtype} like x")
    _require(wmat.dim() == 2 and wmat.shape[1] == _round_up(cout, 16), "the weight matrix has the wrong shape")
    if bias is not None:
        _require(bias.shape == (cout,), f"bias must be ({cout},)")
        bias = bias.float().contiguous()
    for t in (wmat,) + (() if bias is None else (bias,)):
        _require(t.device == x.device, "all tensors must be on the device of x")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0, "weights must be contiguous and 16-byte aligned")
    lib = build.load("conv3d_3x3")
    out = torch.empty((b, z, y, xs, cout), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.conv3d_3x3_fwd(
        x.data_ptr(), wmat.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        code, b, z, y, xs, cin, cout, wmat.shape[0], wmat.shape[1], stream,
    )
    _check(rc, lib)
    conv3d_3x3.launches += 1
    return out


conv3d_3x3.launches = 0

KERNELS = (conv3d_3x3,)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
