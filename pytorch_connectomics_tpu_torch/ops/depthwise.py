"""The depthwise 3^3 SAME stride-1 convolution of the MedNeXt block's
training path, forward and backward, as two hand-written CUDA kernels
(``csrc/depthwise3x3.cu``) with a plain PyTorch version of each beside it.

- :func:`depthwise3x3` -> ``y = dw(x) + bias``: f32 accumulation, the bias
  added in f32 and one rounding to x's dtype. Replaces the TPU kernel
  ``depthwise3x3_pallas`` of
  ``pytorch_connectomics_tpu/ops/depthwise_pallas.py:62``. With the taps
  mirrored in z, y and x and no bias it is also the input gradient,
  :func:`depthwise3x3_input_grad`, whose launch sets the kernel's mirror
  flag, so the backward copies no taps.
- :func:`depthwise3x3_wgrad` -> ``(dw, db)``: the weight gradient
  ``dw[c, t] = sum_{b,v} x[b, v + o_t, c] * dy[b, v, c]`` and the bias
  gradient ``db[c] = sum dy[..., c]``, summed in f32 in a fixed order (every
  launch gives bit-identical results). The JAX package has no such kernel:
  XLA differentiates its depthwise conv.
- :class:`DepthwiseConv3x3Function` ties them into autograd: its backward
  returns ``(dx, dw, db)`` from the two kernels.

Both kernels march bands of y rows along segments of z through the slab ring
that the fused MedNeXt block pair uses (``csrc/ring.cuh``): persistent
blocks, the next slab staged under the current one's stencil, a thread per
channel pair and runs of three x outputs. :func:`kernel_plan` picks the band
rows, segment length and ring slots of each kernel per shape, with the
pair's geometry and stencil cost model (:mod:`.fused_block`);
:func:`card_plan` adds what the card reports for those plans.

Activations are channels-last ``(B, Z, Y, X, C)``, contiguous, float32 or
bfloat16, C a multiple of 16 up to 512; the weight is PyTorch's
``(C, 1, 3, 3, 3)`` and the bias ``(C,)``, both float32. A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its kernel or
raises. Each wrapper counts its kernel launches in its ``launches``
attribute (the input gradient's launches count under :func:`depthwise3x3`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .fused_block import (
    MAX_SMEM, RUN, SMS, THREADS, _align, _check_cuda_inputs, _dtype_code, _require, _resident, _sizes,
    _stencil_clk, _waves_time, refuse_grad, ring_geometry,
)

MAX_CHANNELS = 512
# ((Z, Y, X), C, blocks per step) of the stride-1 MedNeXt-S blocks in
# training, after the (1, 2, 2) stem: the synthetic recipe's 64^3 patch and
# the Lucchi fast recipe's 96^3 patch, both at batch TRAIN_BATCH. The shapes
# the planner must cover and its constants were fitted to.
TRAIN_BATCH = 8
TRAIN_STAGES = {
    "synthetic": [((64, 32, 32), 32, 4), ((32, 16, 16), 64, 4), ((16, 8, 8), 128, 4), ((8, 4, 4), 256, 4),
                  ((4, 2, 2), 512, 2)],
    "lucchi": [((96, 48, 48), 32, 4), ((48, 24, 24), 64, 4), ((24, 12, 12), 128, 4), ((12, 6, 6), 256, 4),
               ((6, 3, 3), 512, 2)],
}
ROWS = 28  # the weight gradient's sums a channel: 27 taps and the bias
KERNEL_NAMES = ("depthwise3x3", "depthwise3x3_wgrad")  # kind 0, kind 1
# The cost model's constants beside the pair's stencil and staging cost
# (fused_block._stencil_clk), fitted to the card's sweep of both kernels at
# the training shapes and 7a's (tools/depthwise_plans.py --sweep):
# an item's fixed cost in cycles of its block (its first three slabs'
# wait; a second block on the SM hides most of it, so it is far below the
# pair's ITEM_CLK); a block alone on its SM, for too few items, runs 1.3x
# slower a step (nothing hides its barriers and copies); a stored output
# value (bias add, rounding, its share of a 4-byte store) in thread
# instructions; the weight gradient's stencil against the forward's (45
# shared loads a run, not 15); an item's partial (its reduction through
# shared memory and its share of the second kernel) in cycles
ITEM_CLK = 500
LONE = 1.3
STORE_INSTR = 1.5
WGRAD_STENCIL = 1.4
PARTIAL_CLK = 1500


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 input (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _check(code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"depthwise 3^3 kernel failed: {lib.depthwise3x3_error_string(code).decode()}")


# ---------------------------------------------------------------------------
# the plan: band rows, segment length, ring slots
# ---------------------------------------------------------------------------


def fwd_smem(shape, es: int, ty: int, ring: int) -> int:
    """Shared memory of the forward kernel: its ring of ``ring`` slabs
    (``fwd_smem`` of the source)."""
    return _align(ring * ring_geometry(shape, ty, 1)["slab"] * es)


def wgrad_smem(shape, es: int, ty: int, ring: int) -> int:
    """Shared memory of the weight-gradient kernel (``wgrad_layout`` of the
    source): the x ring and the dy ring of slabs of the band's outputs (two
    beside four x slots, one beside three), or the run slots' float sums of
    an item where those are larger (they alias the rings once the item is
    done; none when one slot covers the band, at C above 256)."""
    c = shape[-1]
    g = ring_geometry(shape, ty, 1)
    rings = _align(ring * g["slab"] * es) + _align((ring - 2) * ty * RUN * g["nrx"] * c * es)
    tv = THREADS // min(c // 2, THREADS)
    return max(rings, _align(tv * ROWS * c * 4) if tv > 1 else 0)


def plans(kind: int, shape: Tuple[int, ...], dtype: torch.dtype) -> List[Dict]:
    """Every plan of kernel ``kind`` (0: forward / input gradient, 1: weight
    gradient) that fits, for x of ``shape`` in ``dtype``, fastest first by
    the cost model (``est_clk``): the pair's model of a slab step (its
    stencil and staging) and of blocks that share an SM sharing its time,
    plus the forward's stores, or the weight gradient's longer stencil, its
    dy slabs and its partials; an item's fixed cost; a block alone on its
    SM slower."""
    es = 2 if dtype == torch.bfloat16 else 4
    b, z, y, x, c = shape
    out = []
    for ring in (4, 3):
        for ty in _sizes(y):
            smem = (fwd_smem if kind == 0 else wgrad_smem)(shape, es, ty, ring)
            occ = _resident(smem, 2)
            if smem > MAX_SMEM or occ < 1:
                continue
            for seg in _sizes(z):
                g = ring_geometry(shape, ty, seg)
                step = _stencil_clk(g, c, es)
                outs = ty * g["nrx"] * RUN * c
                if kind == 0:
                    step += outs * STORE_INSTR / 128
                    fixed = ITEM_CLK
                else:
                    step = step * WGRAD_STENCIL + outs * es / 16 * 12 / 128
                    fixed = ITEM_CLK + PARTIAL_CLK
                share = min(occ, -(-g["items"] // SMS))
                cost = _waves_time(g["items"], occ, (min(seg, z) * step + fixed) * share)
                if occ > 1 and share < 2:  # (_waves_time counts occ == 1)
                    cost *= LONE
                out.append(dict(kernel=KERNEL_NAMES[kind], ty=ty, seg=seg, ring=ring, smem_bytes=smem,
                                items=g["items"], est_clk=round(cost)))
    _require(bool(out), "no {} plan fits shared memory for {}", KERNEL_NAMES[kind], shape)
    return sorted(out, key=lambda p: (p["est_clk"], p["smem_bytes"]))


def kernel_plan(shape: Tuple[int, ...], dtype: torch.dtype) -> Dict:
    """The plans both kernels take for x of ``shape`` in ``dtype`` (pure
    Python, the same on any machine), by kernel name."""
    shape = tuple(shape)
    return {name: plans(kind, shape, dtype)[0] for kind, name in enumerate(KERNEL_NAMES)}


def card_report(kind: int, shape, dtype: torch.dtype, plan: Dict, device: int) -> Dict:
    """What the card makes of ``plan`` for kernel ``kind``: its shared
    memory, items, resident blocks a SM, grid and registers a thread. The
    first report of a kernel on a device also lets it take all of the shared
    memory, which its launches need."""
    lib = build.load("depthwise3x3")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _check(lib.depthwise3x3_plan(kind, int(dtype == torch.bfloat16), *shape, plan["ty"], plan["seg"],
                                     plan["ring"], out), lib)
    return dict(card_smem_bytes=out[0], card_items=out[1], blocks_per_sm=out[2], grid=out[3], registers=out[4])


_PLANS: Dict[tuple, tuple] = {}


def _card_plan(kind: int, shape, dtype: torch.dtype, device: int) -> tuple:
    """(plan, grid, card report) of one kernel, from the planner and the
    card once per (kernel, shape, dtype, device); raises if the card's
    shared memory or items for the plan differ from the planner's."""
    key = (kind, shape, dtype, device)
    hit = _PLANS.get(key)
    if hit is not None:
        return hit
    plan = plans(kind, tuple(shape), dtype)[0]
    rep = card_report(kind, shape, dtype, plan, device)
    if rep["card_smem_bytes"] != plan["smem_bytes"] or rep["card_items"] != plan["items"]:
        raise RuntimeError(f"the card's report {rep} disagrees with the planner's {plan}")
    hit = _PLANS[key] = (plan, rep["grid"], rep)
    return hit


def card_plan(shape, dtype: torch.dtype, device: int = 0) -> Dict:
    """:func:`kernel_plan` with the card's report (:func:`card_report`) of
    each kernel's plan. Needs the built library and the card."""
    plan = kernel_plan(shape, dtype)
    for kind, name in enumerate(KERNEL_NAMES):
        plan[name].update(_card_plan(kind, tuple(shape), dtype, device)[2])
    return plan


def _plan_and_grid(kind: int, x: torch.Tensor, plan: Optional[Dict]) -> tuple:
    dev = x.get_device()
    if plan is None:
        plan, grid, _ = _card_plan(kind, x.shape, x.dtype, dev)
        return plan, grid, plan["items"], dev
    rep = card_report(kind, tuple(x.shape), x.dtype, plan, dev)
    return plan, rep["grid"], rep["card_items"], dev


def _check_x(x: torch.Tensor, *others: torch.Tensor) -> int:
    code = _dtype_code(x)
    _check_cuda_inputs(x, *others)
    _require(x.shape[-1] <= MAX_CHANNELS, "channels must be at most {}, got {}", MAX_CHANNELS, x.shape[-1])
    return code


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


def run_fwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, mirror: bool = False,
            plan: Optional[Dict] = None) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors: :func:`depthwise3x3`, or
    with ``mirror`` the taps read mirrored in z, y and x (the input
    gradient). ``plan`` (``ty``, ``seg``, ``ring``) replaces the planner's."""
    c = x.shape[-1]
    _require(w.numel() == 27 * c, "w must hold (C, 1, 3, 3, 3) = ({}, 1, 3, 3, 3), got {}", c, w.shape)
    if w.dtype != torch.float32 or not w.is_contiguous():
        w = w.float().contiguous()
    if bias is None:
        code = _check_x(x, w)
    else:
        if bias.dtype != torch.float32 or not bias.is_contiguous():
            bias = bias.float().contiguous()
        _require(bias.shape == (c,), "bias must be ({},), got {}", c, bias.shape)
        code = _check_x(x, w, bias)
    b, z, y, xs, _ = x.shape
    lib = build.load("depthwise3x3")
    plan, grid, _, dev = _plan_and_grid(0, x, plan)
    out = torch.empty_like(x)
    rc = lib.depthwise3x3_fwd(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), code, b, z, y, xs, c,
        plan["ty"], plan["seg"], plan["ring"], grid, int(mirror), build.stream(dev),
    )
    _check(rc, lib)
    depthwise3x3.launches += 1
    return out


def depthwise3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Z, Y, X, C) in x's dtype: the depthwise 3^3 SAME conv of x plus
    bias; see the module doc."""
    refuse_grad("depthwise3x3", x, w, bias)
    if x.is_cpu:
        return depthwise3x3_plain(x, w, bias)
    return run_fwd(x, w, bias)


depthwise3x3.launches = 0


def depthwise3x3_input_grad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, Z, Y, X, C) in dy's dtype: the depthwise conv's input gradient,
    dy through the taps mirrored in z, y and x, no bias (the forward kernel
    with its mirror flag; its launches count under :func:`depthwise3x3`)."""
    refuse_grad("depthwise3x3_input_grad", dy, w)
    if dy.is_cpu:
        return depthwise3x3_plain(dy, w.flip((2, 3, 4)))
    return run_fwd(dy, w, None, mirror=True)


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


def run_wgrad(x: torch.Tensor, dy: torch.Tensor, plan: Optional[Dict] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the weight-gradient kernels on CUDA tensors:
    :func:`depthwise3x3_wgrad`. ``plan`` (``ty``, ``seg``, ``ring``) replaces
    the planner's."""
    _require(dy.shape == x.shape and dy.dtype == x.dtype, "dy must have x's shape and dtype")
    code = _check_x(x, dy)
    _require(dy.data_ptr() % 16 == 0, "dy must be 16-byte aligned")
    b, z, y, xs, c = x.shape
    lib = build.load("depthwise3x3")
    plan, grid, items, dev = _plan_and_grid(1, x, plan)
    # the result, dw as (C, 27) then db, apart from the items' partials, so
    # that the gradients keep no scratch alive
    out = torch.empty(ROWS * c, device=x.device, dtype=torch.float32)
    partial = torch.empty(ROWS * c * items, device=x.device, dtype=torch.float32)
    rc = lib.depthwise3x3_wgrad(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), out.data_ptr(), code, b, z, y, xs, c,
        plan["ty"], plan["seg"], plan["ring"], grid, build.stream(dev),
    )
    _check(rc, lib)
    depthwise3x3_wgrad.launches += 1
    return out[: 27 * c].view(c, 1, 3, 3, 3), out[27 * c :]


def depthwise3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dw (C, 1, 3, 3, 3), db (C,))`` float32 gradients of the depthwise
    conv's weight and bias; see the module doc."""
    refuse_grad("depthwise3x3_wgrad", x, dy)
    if x.is_cpu:
        return depthwise3x3_wgrad_plain(x, dy)
    return run_wgrad(x, dy)


depthwise3x3_wgrad.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class DepthwiseConv3x3Function(torch.autograd.Function):
    """``y = depthwise3x3(x, w, bias)`` whose backward runs the kernels:
    ``dx`` is :func:`depthwise3x3_input_grad` of ``dy``, ``(dw, db)`` is
    :func:`depthwise3x3_wgrad`. Saves ``x`` and ``w``."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return depthwise3x3(x, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = depthwise3x3_input_grad(dy, w) if ctx.needs_input_grad[0] else None
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
