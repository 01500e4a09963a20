"""The dense 3^3 SAME stride-1 convolution of RSUNet, forward and backward,
as hand-written CUDA kernels (``csrc/conv3d_3x3.cu``) with a plain PyTorch
version of each beside it.

:func:`conv3d_3x3` -> ``out = round(conv(x, w)) + bias``, computed on
channels-last ``(B, Z, Y, X, Cin)`` activations with f32 accumulation; the
sum is rounded to x's dtype first and the bias is added after, in x's
dtype (bf16 rounds twice), as flax's ``nn.Conv`` and the TPU kernel do. The
weight is used in x's dtype (flax casts its kernel to the compute dtype).
Replaces the TPU kernel ``conv3d_3x3_pallas`` of
``pytorch_connectomics_tpu/ops/conv3d_pallas.py:84``.

The backward (the JAX package has no kernel for it: XLA differentiates the
conv, so the forward's function is the spec):

- :func:`conv3d_3x3_input_grad`: ``dx`` is the forward kernel on ``dy``
  with the taps mirrored and each tap's ``(Cin, Cout)`` block transposed
  (``w.transpose(0, 1).flip(2, 3, 4)`` in ``oidhw``), no bias; its launches
  count under :func:`conv3d_3x3` and, apart, under its own ``launches``.
- :func:`conv3d_3x3_wgrad`: ``dW[tap] = sum_v x(v + tap - 1)^T dy(v)`` in
  f32, a kernel of its own: per item (a chunk of tiles and a set of weight
  rows: one dz's taps with tap groups, 2 warpgroups x ``m_tiles`` x 64 rows)
  partial sums on ``wgmma`` over all of Cout, fed by a producer warpgroup's
  ring of staged tiles (bf16; exact f32 FMAs on the CUDA cores for float32), then
  their sum in a fixed order, so that every launch and every grid gives the
  same bits.
- the bias gradient is ``dy`` summed over voxels in f32 (plain PyTorch, as
  JAX computes it outside any kernel).
- :class:`Conv3x3Function` ties them into autograd; :func:`conv3d_3x3`
  called with grad enabled on a tensor that requires grad goes through it.

The weight is PyTorch's ``(Cout, Cin, 3, 3, 3)`` (``layout="oidhw"``) or
the JAX package's ``(3, 3, 3, Cin, Cout)`` (``layout="dhwio"``). The kernel
takes it as the tap-major ``(27 * Cin, Cout)`` matrix of the TPU kernel,
zero-padded as :func:`kernel_weight` describes; a caller that keeps a
parameter builds that matrix once per parameter version and passes it as
``wmat`` (``models/rsunet.py``, inference).

The forward kernel keeps the weight of at least 16 output channels (``27 *
Cin * 16`` values) in shared memory next to the input tile, which one
launch fits up to Cin 97 in float32 and 192 in bfloat16 (RSUNet's widths
reach 80). A wider input (the MONAI U-Nets reach 256, UNETR 384; for the
input gradient the forward's Cout) streams Cin in chunks, one launch a
chunk: the first stores its f32 sums in a scratch, the middle ones add to
it, the last adds its own, rounds once to x's dtype and adds the bias, so
the function is the same single f32 sum and rounding
(:func:`conv3d_3x3_chunked_plain` emulates it; :func:`kernel_plan` reports
``chunks`` and ``cin_chunk``). A Cin that fits takes one launch, with the
plan and bits it had before. The bf16 tensor-core kernel keeps two input tiles where they fit
beside the weight, so that the next tile's copies run under this tile's
products, and gives each warp 32 or 64 voxels x 32 to 64 output channels;
:func:`kernel_plan` and :func:`wgrad_plan` report the plans a shape takes.
The library caches each shape's plan and grid, so a launch does no
planning.

Given CPU tensors the wrappers run the plain versions; given CUDA tensors
they launch the kernels or raise. Each counts its launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .fused_block import _dtype_code, _require, refuse_grad

WGRAD_PLAN_FIELDS = ("xs", "r", "n", "slices", "stages", "m_tiles", "tap_groups", "rows_per_block", "row_groups",
                     "rows_per_chunk", "chunks", "tiles_per_chunk", "items", "smem_bytes", "grid", "partial_floats",
                     "kernel")
# the fields a caller may force through ``plan=`` (0 or missing: the planner's)
WGRAD_FORCED = ("xs", "r", "stages", "m_tiles", "tap_groups")
# wgmma's widths the weight-gradient kernel is built for, and the M tiles a
# warpgroup may hold at each (csrc/conv3d_3x3.cu: kWgN, wg_max_mt)
WGRAD_WIDTHS = (8, 16, 24, 32, 40, 48, 64, 80, 104, 128)


def wgrad_max_m_tiles(n: int) -> int:
    return 4 if 32 <= n <= 48 else 3 if n == 64 else 1 if n == 128 else 2


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _dhwio(w: torch.Tensor, layout: str) -> torch.Tensor:
    _require(w.dim() == 5, "w must be 5-D, got {}", w.shape)
    if layout == "oidhw":
        _require(w.shape[2:] == (3, 3, 3), "w must be (Cout, Cin, 3, 3, 3), got {}", w.shape)
        return w.permute(2, 3, 4, 1, 0)
    _require(layout == "dhwio", "layout must be 'oidhw' or 'dhwio', got {!r}", layout)
    _require(w.shape[:3] == (3, 3, 3), "w must be (3, 3, 3, Cin, Cout), got {}", w.shape)
    return w


def _oidhw(w: torch.Tensor, layout: str) -> torch.Tensor:
    """``w`` as ``(Cout, Cin, 3, 3, 3)`` (a view; differentiable)."""
    return _dhwio(w, layout).permute(4, 3, 0, 1, 2)


def mirror_weight(w: torch.Tensor) -> torch.Tensor:
    """The input gradient's weight: ``(Cout, Cin, 3, 3, 3)`` -> ``(Cin,
    Cout, 3, 3, 3)`` with the taps mirrored in z, y and x (tap t -> 26 - t)
    and each tap's block transposed."""
    return w.transpose(0, 1).flip(2, 3, 4)


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


def conv3d_3x3_chunked_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, cin_chunk: int = 128, layout: str = "oidhw"
) -> torch.Tensor:
    """The Cin-chunked kernel's arithmetic: each chunk of ``cin_chunk``
    input channels summed over its taps in f32, the chunks' sums added in
    order in f32, one rounding to x's dtype, then the bias in x's dtype."""
    wk = _dhwio(w, layout)
    total = None
    for c0 in range(0, x.shape[-1], cin_chunk):
        xc = x[..., c0 : c0 + cin_chunk].float() if x.dtype != torch.float64 else x[..., c0 : c0 + cin_chunk]
        part = conv3d_3x3_plain(xc, wk[:, :, :, c0 : c0 + cin_chunk].to(x.dtype), layout="dhwio")
        total = part if total is None else total + part
    out = total.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def conv3d_3x3_input_grad_plain(dy: torch.Tensor, w: torch.Tensor, layout: str = "oidhw") -> torch.Tensor:
    """``dx`` of the conv for output gradient ``dy``: :func:`conv3d_3x3_plain`
    of ``dy`` with :func:`mirror_weight`, no bias; rounded to dy's dtype."""
    return conv3d_3x3_plain(dy, mirror_weight(_oidhw(w, layout)))


def conv3d_3x3_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dW`` (Cout, Cin, 3, 3, 3) in f32 (f64 for f64 x): per tap, the
    shifted slice of the zero-padded x, as (voxels, Cin), transposed times
    dy as (voxels, Cout)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    _, z, y, xs, cin = x.shape
    cout = dy.shape[-1]
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1, 1, 1))
    d = dy.to(acc).reshape(-1, cout)
    taps = [
        xp[:, dz : dz + z, dy_ : dy_ + y, dx : dx + xs].reshape(-1, cin).t() @ d
        for dz in range(3) for dy_ in range(3) for dx in range(3)
    ]
    return torch.stack(taps, dim=-1).permute(1, 0, 2).reshape(cout, cin, 3, 3, 3)


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
    which path (``taps``; ``packed`` for bf16 with Cin < 8; ``f32``), the
    launches over Cin (``chunks``, 1 where the whole Cin fits) with
    ``cin_chunk`` channels each and the staging's ``copy_bytes``.
    Needs the built library (a machine with the CUDA toolkit); raises for a
    shape the kernel does not take."""
    lib = build.load("conv3d_3x3")
    out = (ctypes.c_int * 14)()
    b, z, y, xs, cin = shape
    _check(lib.conv3d_3x3_plan(int(dtype == torch.bfloat16), b, z, y, xs, cin, cout, out), lib)
    v = list(out)
    return dict(xs=v[0], r=v[1], nb=v[2], slices=v[3], warp_m=16 * v[4], warp_n=8 * v[5], warps_m=v[6],
                warps_n=v[7], buffers=v[8], smem_bytes=v[9], kernel=("taps", "packed", "f32")[v[10]],
                chunks=v[11], cin_chunk=v[12], copy_bytes=v[13])


def _check(code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"conv3d 3^3 kernel failed: {lib.conv3d_3x3_error_string(code).decode()}")


_PLANNER = (ctypes.c_int * len(WGRAD_FORCED))()


def _forced(plan: dict | None):
    """The forced weight-gradient fields (:data:`WGRAD_FORCED`) as the
    library takes them; zeros for the planner's."""
    return (ctypes.c_int * len(WGRAD_FORCED))(*(plan.get(k, 0) for k in WGRAD_FORCED)) if plan else _PLANNER


def wgrad_plan(shape: tuple, cout: int, dtype: torch.dtype, plan: dict | None = None) -> dict:
    """The plan :func:`conv3d_3x3_wgrad` takes for x of ``shape`` (B, Z, Y,
    X, Cin) and ``cout`` output channels in ``dtype`` on the current
    device: its tile (``xs`` x ``r``), product width ``n`` (bf16: wgmma's N,
    Cout rounded up to a width of :data:`WGRAD_WIDTHS`; f32: a column slice)
    and column ``slices``, ring ``stages`` (f32: 1), ``m_tiles`` a
    warpgroup, ``tap_groups`` (3: one dz's taps a row block; 1: all 27),
    ``rows_per_block`` (padded to 64), ``row_groups``, rows a chunk,
    ``chunks`` and ``tiles_per_chunk``, ``items``, shared memory, default
    ``grid``, the float32 scratch of the partials and the ``kernel``
    (``wgmma``, ``wgmma_packed`` for Cin < 8, ``f32``). Chunks and items
    follow from the shape alone. ``plan`` forces any of
    :data:`WGRAD_FORCED`; a plan that does not fit, or whose kernel is not
    built, raises. Needs the built library and the card."""
    lib = build.load("conv3d_3x3")
    out = (ctypes.c_longlong * len(WGRAD_PLAN_FIELDS))()
    b, z, y, xs, cin = shape
    _check(lib.conv3d_3x3_wgrad_plan(int(dtype == torch.bfloat16), b, z, y, xs, cin, cout, _forced(plan), out), lib)
    got = dict(zip(WGRAD_PLAN_FIELDS, out))
    got["kernel"] = ("wgmma", "wgmma_packed", "f32")[got["kernel"]]
    return got


def wgrad_geometry(shape: tuple, cout: int, plan: dict) -> dict:
    """The bf16 weight gradient's decomposition for x of ``shape`` (B, Z, Y,
    X, Cin), ``cout`` output channels and a ``plan`` of ``xs``, ``r``,
    ``m_tiles`` and ``tap_groups``: the fields of :func:`wgrad_plan` that
    follow from them (``n``, ``slices``, ``rows_per_block``, ``row_groups``,
    ``rows_per_chunk``, ``chunks``, ``tiles_per_chunk``, ``items``,
    ``partial_floats``) and ``tap_rows`` (CP = Cin rounded up to 8, or Cin
    below 8: the packed stem) and ``tiles``, computed as
    ``csrc/conv3d_3x3.cu`` (``plan_wgrad_wgmma``, ``wgrad_chunks``) does,
    without the card."""
    b, z, y, x, cin = shape
    slices = -(-cout // WGRAD_WIDTHS[-1])
    need = _round_up(-(-cout // slices), 8)
    n = next(w for w in WGRAD_WIDTHS if w >= need)
    tap_rows = cin if cin < 8 else _round_up(cin, 8)
    groups = plan["tap_groups"]
    rb = _round_up(27 // groups * tap_rows, 64)
    rows_p = groups * rb
    rg = -(-(rb // 64) // (2 * plan["m_tiles"]))
    tiles = b * z * -(-y // plan["r"]) * -(-x // plan["xs"])
    per = groups * rg * slices
    chunks = -(-2 * 132 // per)
    chunks = max(1, min(chunks, (64 << 20) // (rows_p * slices * n * 4), tiles))
    tpc = -(-tiles // chunks)
    chunks = -(-tiles // tpc)
    return dict(n=n, slices=slices, rows_per_block=rb, row_groups=rg, rows_per_chunk=rows_p, chunks=chunks,
                tiles_per_chunk=tpc, items=chunks * per, partial_floats=chunks * rows_p * slices * n,
                tap_rows=tap_rows, tiles=tiles)


def _launch_fwd(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor | None, cout: int) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors: x (B, Z, Y, X, Cin) and the
    weight matrix in x's dtype, bias float32 or None."""
    code = _dtype_code(x)
    _require(x.dim() == 5, "x must be (B, Z, Y, X, Cin), got {}", x.shape)
    _require(x.is_contiguous(), "x must be contiguous channels-last (B, Z, Y, X, Cin)")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    _require(wmat.dtype == x.dtype, "the weight matrix must be {} like x", x.dtype)
    _require(wmat.dim() == 2 and wmat.shape[1] == _round_up(cout, 16), "the weight matrix has the wrong shape")
    dev = x.get_device()
    if bias is not None:
        _require(bias.shape == (cout,), "bias must be ({},)", cout)
        if bias.dtype != torch.float32 or not bias.is_contiguous():
            bias = bias.float().contiguous()
    for t in (wmat,) if bias is None else (wmat, bias):
        _require(t.get_device() == dev, "all tensors must be on the device of x")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0, "weights must be contiguous and 16-byte aligned")
    b, z, y, xs, cin = x.shape
    lib = build.load("conv3d_3x3")
    out = torch.empty((b, z, y, xs, cout), device=x.device, dtype=x.dtype)
    key = (tuple(x.shape), cout, x.dtype, dev)
    chunks = _FWD_CHUNKS.get(key)
    if chunks is None:
        with torch.cuda.device(dev):
            chunks = _FWD_CHUNKS[key] = kernel_plan(tuple(x.shape), cout, x.dtype)["chunks"]
    part = None
    if chunks > 1 and x.dtype == torch.bfloat16:
        part = torch.empty((b, z, y, xs, cout), device=x.device, dtype=torch.float32)
    rc = lib.conv3d_3x3_fwd(
        x.data_ptr(), wmat.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), code, b, z, y, xs, cin, cout, wmat.shape[0], wmat.shape[1],
        build.stream(dev),
    )
    _check(rc, lib)
    conv3d_3x3.launches += 1
    return out


_FWD_CHUNKS: dict = {}


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
    keeps one. With grad enabled and an input that requires grad it runs
    through :class:`Conv3x3Function` (``wmat`` is then not used)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, bias)):
        return Conv3x3Function.apply(x, _oidhw(w, layout), bias)
    if x.device.type == "cpu":
        return conv3d_3x3_plain(x, w, bias, layout)
    wk = _dhwio(w, layout)
    _require(wk.shape[3] == x.shape[-1], "w has {} input channels, x has {}", wk.shape[3], x.shape[-1])
    if wmat is None:
        wmat = kernel_weight(w, x.dtype, layout)
    return _launch_fwd(x, wmat, bias, wk.shape[4])


conv3d_3x3.launches = 0


def conv3d_3x3_input_grad(dy: torch.Tensor, w: torch.Tensor, wmat: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Z, Y, X, Cin) in dy's dtype: the conv's input gradient, the
    forward kernel on ``dy`` with :func:`mirror_weight` of ``w`` (Cout, Cin,
    3, 3, 3), no bias. ``wmat``: :func:`kernel_weight` of the mirrored
    weight in dy's dtype, when the caller keeps one."""
    refuse_grad("conv3d_3x3_input_grad", dy, w)
    if dy.device.type == "cpu":
        return conv3d_3x3_input_grad_plain(dy, w)
    _require(w.dim() == 5 and w.shape[0] == dy.shape[-1], "w must be (Cout, Cin, 3, 3, 3) with Cout = {}",
             dy.shape[-1])
    if wmat is None:
        wmat = kernel_weight(mirror_weight(w), dy.dtype)
    out = _launch_fwd(dy, wmat, None, w.shape[1])
    conv3d_3x3_input_grad.launches += 1
    return out


conv3d_3x3_input_grad.launches = 0

_WGRAD_PLANS: dict = {}


def conv3d_3x3_wgrad(x: torch.Tensor, dy: torch.Tensor, grid: int | None = None,
                     plan: dict | None = None) -> torch.Tensor:
    """``dW`` (Cout, Cin, 3, 3, 3) float32: the weight gradient of the conv
    of x (B, Z, Y, X, Cin) whose output gradient is dy (B, Z, Y, X, Cout);
    see the module doc. ``grid``: the number of persistent blocks in place
    of the card's default (the result does not depend on it); ``plan``: any
    of :data:`WGRAD_FORCED` in the place of the planner's, for sweeps and
    tests (the partials follow the plan, so the sum's order changes)."""
    refuse_grad("conv3d_3x3_wgrad", x, dy)
    if x.device.type == "cpu":
        return conv3d_3x3_wgrad_plain(x, dy)
    code = _dtype_code(x)
    _require(x.dim() == 5 and dy.dim() == 5 and dy.shape[:4] == x.shape[:4],
             "x (B, Z, Y, X, Cin) and dy (B, Z, Y, X, Cout) must share (B, Z, Y, X): {} and {}", x.shape, dy.shape)
    _require(dy.dtype == x.dtype, "dy must be {} like x", x.dtype)
    dev = x.get_device()
    _require(dy.get_device() == dev, "all tensors must be on the device of x")
    for t in (x, dy):
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0, "x and dy must be contiguous and 16-byte aligned")
    b, z, y, xs, cin = x.shape
    cout = dy.shape[-1]
    key = (tuple(x.shape), cout, x.dtype, dev, None if plan is None else tuple(_forced(plan)))
    floats = _WGRAD_PLANS.get(key)
    if floats is None:
        with torch.cuda.device(dev):
            floats = _WGRAD_PLANS[key] = wgrad_plan(tuple(x.shape), cout, x.dtype, plan)["partial_floats"]
    lib = build.load("conv3d_3x3")
    partial = torch.empty(floats, device=x.device, dtype=torch.float32)
    out = torch.empty((cout, cin, 3, 3, 3), device=x.device, dtype=torch.float32)
    rc = lib.conv3d_3x3_wgrad(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), floats, out.data_ptr(), code, b, z, y, xs, cin, cout,
        grid or 0, _forced(plan), build.stream(dev),
    )
    _check(rc, lib)
    conv3d_3x3_wgrad.launches += 1
    return out


conv3d_3x3_wgrad.launches = 0


class Conv3x3Function(torch.autograd.Function):
    """``y = conv3d_3x3(x, w, bias)`` (``w`` the float32 parameter, Cout,
    Cin, 3, 3, 3) whose backward runs the kernels: ``dx`` is
    :func:`conv3d_3x3_input_grad` of ``dy`` (skipped where x needs no
    gradient, as the stem's data), ``dW`` is :func:`conv3d_3x3_wgrad`,
    ``db`` is ``dy`` summed in f32. Saves ``x`` and ``w``."""

    @staticmethod
    def forward(ctx, x, w, bias):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return conv3d_3x3(x, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv3d_3x3_input_grad(dy, w) if ctx.needs_input_grad[0] else None
        dw = conv3d_3x3_wgrad(x, dy).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = None
        if ctx.has_bias and ctx.needs_input_grad[2]:
            acc = torch.float64 if dy.dtype == torch.float64 else torch.float32
            db = dy.sum(dim=(0, 1, 2, 3), dtype=acc).to(w.dtype)
        return dx, dw, db


KERNELS = (conv3d_3x3, conv3d_3x3_wgrad)


def reset_launch_counts() -> None:
    for k in KERNELS + (conv3d_3x3_input_grad,):
        k.launches = 0
