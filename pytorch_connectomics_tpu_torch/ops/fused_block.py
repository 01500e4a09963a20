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
bfloat16, C a multiple of 16 up to 1024. Weights keep PyTorch's layouts:
``w_dw`` ``(C, 1, 3, 3, 3)``, ``w1`` ``(R, C)``, ``w2`` ``(Cout, R)``
(``nn.Linear``), biases and norm affine ``(n,)``. The kernels take ``w1``
and ``w2`` in x's dtype (the caller casts them once, not per call) and the
other parameters in float32.

Both kernels (``dw_stats`` in both dtypes, ``fused_block_apply`` in bf16)
march bands of y rows and x columns along segments of z through a ring of
slabs in shared memory; :func:`kernel_plan` picks the band rows, the band
columns (the whole row wherever it leaves an SM room for two blocks, else
the cost model's best of every band width), the segment length, the output channels of a warp's unit and the
weight chunk per shape, from a cost model of the card, and :func:`card_plan`
adds what the card reports for that plan. The float32 apply pass is the
first design's kernel, kept as the arithmetic check.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its kernel launches in
its ``launches`` attribute. The pair has no backward pass: called with grad
enabled on a tensor that requires grad, a wrapper raises rather than return
a result cut off from the autograd graph (training runs the unfused block,
``models/mednext.py``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

EPS = 1e-6  # flax GroupNorm epsilon

# the kernels' constants (csrc/mednext_block.cu)
RUN = 3  # x outputs of a thread's run
APPLY_RING = 3  # slabs in the apply pass's ring (the statistics pass: 4, or 3 where 4 do not fit)
THREADS, WARPS = 256, 8
MAX_SMEM = 232448  # shared memory a block can take on an H100
SM_SMEM = 233472  # shared memory of an SM; each resident block also holds 1 KB
SMS = 132  # the H100 SXM's SMs, for the cost model only (the grid comes from the card)
# the cost model's fixed costs, in cycles of an SM: a work item (its three
# slabs' first wait, the statistics pass's reduction), a z step of the apply
# pass, a streamed weight chunk
ITEM_CLK, STEP_CLK, CHUNK_CLK = 3000, 10000, 1000


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"MedNeXt block kernels take float32 or bfloat16, got {t.dtype}")


def _check(code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"MedNeXt block kernel failed: {lib.mednext_error_string(code).decode()}")


def _require(cond: bool, msg: str, *args) -> None:
    """Raise ``ValueError(msg)`` unless ``cond``; with ``args``, ``msg`` is a
    format string filled in only when the check fails."""
    if not cond:
        raise ValueError(msg.format(*args) if args else msg)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad is enabled and any of ``tensors`` requires grad: the
    kernels write their outputs outside autograd."""
    if torch.is_grad_enabled():
        for t in tensors:
            if t is not None and t.requires_grad:
                raise RuntimeError(
                    f"{name} has no backward pass; call it under torch.no_grad() or torch.inference_mode()"
                )


def _check_cuda_inputs(x: torch.Tensor, *others: torch.Tensor) -> None:
    _require(x.dim() == 5, "x must be (B, Z, Y, X, C), got {}", x.shape)
    _require(x.is_contiguous(), "x must be contiguous channels-last (B, Z, Y, X, C)")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    c = x.shape[-1]
    _require(c % 16 == 0 and c <= 1024, "channels must be a multiple of 16 up to 1024, got {}", c)
    dev = x.get_device()
    for t in others:
        _require(t.get_device() == dev, "all tensors must be on the device of x")
        _require(t.is_contiguous(), "weights must be contiguous")


# ---------------------------------------------------------------------------
# the plan: band rows, band columns, segment length, unit width, weight chunk
# ---------------------------------------------------------------------------


def _align(n: int) -> int:
    return (n + 127) & ~127


def whole_row(x: int) -> int:
    """The band width of whole rows of ``x`` voxels: its runs of three."""
    return RUN * -(-x // RUN)


def band_widths(x: int) -> List[int]:
    """The band widths the planners try, widest first: the whole row, then
    the row split into n bands of as near equal runs as whole runs allow."""
    n = -(-x // RUN)
    return sorted({RUN * -(-n // k) for k in range(1, n + 1)}, reverse=True)


def _tx(plan: Dict, x: int) -> int:
    """A plan's band width; a plan without one takes whole rows."""
    return plan.get("tx") or whole_row(x)


def ring_geometry(shape: Tuple[int, ...], ty: int, seg: int, tx: Optional[int] = None) -> Dict[str, int]:
    """The walk of the ring kernels for x of ``shape`` (B, Z, Y, X, C): bands
    of ``ty`` rows and ``tx`` columns (a multiple of three; by default the
    whole row), segments of ``seg`` slabs; an item is (b, segment, y band, x
    band), numbered ``((b * segs + s) * bands + band) * xbands + xband``; a
    slab row holds ``xp`` voxels (the band's runs of three and one halo voxel
    each side), a band row ``tw`` outputs."""
    b, z, y, x, c = shape
    tx = whole_row(x) if tx is None else tx
    bands, xbands, segs = -(-y // ty), -(-x // tx), -(-z // seg)
    return dict(ty=ty, tx=tx, seg=seg, bands=bands, xbands=xbands, segs=segs, items=b * segs * bands * xbands,
                nrx=tx // RUN, xp=tx + 2, tw=min(tx, x), slab=(ty + 2) * (tx + 2) * c)


def _search(x: int, plans_at, every_width: bool = False) -> List[Dict]:
    """``plans_at(tx)`` for whole rows; and for every narrower band width
    where none fits, where every one fits only one block on an SM (a row
    so wide that its slabs fill shared memory: bands of one or two rows,
    their y halo staged two or three times over, whose x bands an H100
    runs 1.1-1.4x faster at the 256-wide stage 0), or with ``every_width``
    (the sweeps). Where whole rows leave room for two blocks they stay, so
    those shapes keep the plans and outputs of the ring before x bands."""
    widths = band_widths(x)
    found = plans_at(widths[0])
    if every_width or all(_resident(p["smem_bytes"], 2) < 2 for p in found):
        found += [p for tx in widths[1:] for p in plans_at(tx)]
    return found


def stats_smem(shape, es: int, ty: int, ring: int = 4, tx: Optional[int] = None) -> int:
    """Shared memory of the statistics kernel: its ring of ``ring`` slabs
    and the per-slot sums it reduces (``stats_smem`` of the source)."""
    c = shape[-1]
    pt = min(c // 2, THREADS)
    return _align(ring * ring_geometry(shape, ty, 1, tx)["slab"] * es) + _align((THREADS // pt) * 2 * c * 4)


def apply_smem(shape, r: int, cout: int, ty: int, cs: int, rc: int, tx: Optional[int] = None) -> int:
    """Shared memory of the bf16 apply kernel (``apply_layout`` of the
    source): a ring of three slabs, the u tile, the weights (whole, or a
    chunk of ``rc`` hidden units), the warps' output tiles."""
    c = shape[-1]
    g = ring_geometry(shape, ty, 1, tx)
    mf = -(-ty * g["tw"] // 16)
    return (_align(APPLY_RING * g["slab"] * 2) + _align(16 * mf * (c + 8) * 2)
            + _align(rc * (c + 8) * 2) + _align(cout * (rc + 8) * 2) + _align(WARPS * 16 * (cs + 8) * 2))


def _sizes(n: int):
    return sorted({min(n, 2 ** k) for k in range(8)} | {n})


def _resident(smem: int, cap: int) -> int:
    return max(0, min(cap, SM_SMEM // (smem + 1024)))


def _waves_time(items: int, occ: int, item_clk: float) -> float:
    """Cycles of the whole launch: waves of SMS x occ items, where an item
    takes ``item_clk`` cycles of its block; a block alone on its SM hides
    less of its barriers' and copies' latency."""
    return math.ceil(items / (SMS * occ)) * item_clk * (1.3 if occ == 1 else 1.0)


def _stencil_clk(g: Dict[str, int], c: int, es: int) -> float:
    """Issue cycles of one slab step's stencil and staging on an SM: about
    50 thread instructions an output value in bf16 (15 shared loads and their
    conversions, 27 FMAs per three outputs of a pair), 40 in f32, and 12 a
    16-byte copy; 128 thread instructions a cycle."""
    outs = g["ty"] * g["tx"] * c
    copies = g["slab"] * es / 16  # the halo columns an x band re-stages included
    return (outs * (50 if es == 2 else 40) + copies * 12) / 128


def stats_plans(shape: Tuple[int, ...], dtype: torch.dtype, every_width: bool = False) -> List[Dict]:
    """Every plan of the statistics kernel that fits, for x of ``shape`` in
    ``dtype``, fastest first by the cost model (``est_clk``); x bands
    narrower than the row as :func:`_search` allows."""
    es = 2 if dtype == torch.bfloat16 else 4

    def plans_at(tx):
        plans = []
        for ring in (4, 3):
            for ty in _sizes(shape[2]):
                smem = stats_smem(shape, es, ty, ring, tx)
                occ = _resident(smem, 2)
                if smem > MAX_SMEM or occ < 1:
                    continue
                for seg in _sizes(shape[1]):
                    g = ring_geometry(shape, ty, seg, tx)
                    # three slots expose the copies of each slab (one more barrier a
                    # step). Blocks that share an SM share its time, fixed costs
                    # included (the card's timings: 192 short items take 1.5x 96)
                    step = _stencil_clk(g, shape[-1], es) * (1.0 if ring == 4 else 1.15)
                    share = min(occ, -(-g["items"] // SMS))
                    cost = _waves_time(g["items"], occ, (min(seg, shape[1]) * step + ITEM_CLK) * share)
                    plans.append(dict(kernel="ring_stats", ty=ty, tx=tx, seg=seg, ring=ring, smem_bytes=smem,
                                      items=g["items"], parts=g["items"] // shape[0], est_clk=round(cost)))
        return plans

    plans = _search(shape[3], plans_at, every_width)
    _require(bool(plans), "no statistics plan fits shared memory for {}", shape)
    return sorted(plans, key=lambda p: p["est_clk"])


def stats_plan(shape: Tuple[int, ...], dtype: torch.dtype) -> Dict:
    """The statistics kernel's plan for x of ``shape`` in ``dtype``."""
    return stats_plans(shape, dtype)[0]


def _unit_widths(cout: int):
    return [cs for cs in (128, 64, 32, 16) if cout % cs == 0]


def apply_plans(shape: Tuple[int, ...], r: int, cout: int, every_width: bool = False) -> List[Dict]:
    """Every plan of the bf16 apply kernel that fits, for x of ``shape``, R
    hidden units and ``cout`` outputs, fastest first by the cost model: band
    rows and columns, segment length, output channels a warp's unit
    (``cs``), hidden units a weight chunk (``rc``, R when both weights stay
    resident in shared memory); x bands narrower than the row as
    :func:`_search` allows."""
    plans = _search(shape[3], lambda tx: _apply_plans_at(shape, r, cout, tx), every_width)
    _require(bool(plans), "no apply plan fits shared memory for {} (R {}, Cout {})", shape, r, cout)
    return sorted(plans, key=lambda p: (p["est_clk"], p["smem_bytes"]))


def _apply_plans_at(shape, r: int, cout: int, tx: int) -> List[Dict]:
    b, z, y, x, c = shape
    plans = []
    for cs in _unit_widths(cout):
        cap = 2 if cs <= 64 and c != 128 else 1  # __launch_bounds__ of the kernel (apply_min_blocks)
        for rc in [r] + [n for n in (64, 32, 16) if n < r and r % n == 0]:
            for ty in _sizes(y):
                smem = apply_smem(shape, r, cout, ty, cs, rc, tx)
                occ = _resident(smem, cap)
                if smem > MAX_SMEM or occ < 1:
                    continue
                mf = -(-ty * min(tx, x) // 16)
                units = mf * (cout // cs)
                rounds = -(-units // WARPS)
                # per 16 hidden units a unit takes 8 GELUs a thread (~10
                # instructions each) and C/8 + cs/8 mma.sync (about 2 cycles of
                # the SM each); one warp's chain waits on its MMAs (~32 cycles,
                # four or eight accumulators in flight: two blocks of 16 at once
                # where a chunk holds 32) and its GELUs. A streamed weight chunk
                # costs two barriers and a wait, a step two barriers and its
                # slab's wait. The constants are fitted to the card's timings
                # of many plans (tools/block_phases.py --sweep).
                issue = units * (r / 16) * (8 * 10 * 32 / 128 + (c / 8 + cs / 8) * 2)
                pairs = 2 if rc % 32 == 0 else 1
                chain = 3 * rounds * (r / 16) * ((c / 16) * 32 / ((2 if c <= 128 else 4) * pairs) + 60 + cs / 4)
                chunks = 0 if rc == r else rounds * (r // rc) * CHUNK_CLK
                for seg in _sizes(z):
                    g = ring_geometry(shape, ty, seg, tx)
                    step = occ * _stencil_clk(g, c, 2) + max(occ * issue, chain) + chunks + STEP_CLK
                    item = min(seg, z) * step + ITEM_CLK
                    cost = _waves_time(g["items"], occ, item)
                    plans.append(dict(kernel="ring_apply", ty=ty, tx=tx, seg=seg, ring=APPLY_RING, cs=cs,
                                      ns=cout // cs, mf=mf, units=units, rounds=rounds, rc=rc, resident=rc == r,
                                      smem_bytes=smem, items=g["items"], est_clk=round(cost)))
    return plans


def apply_plan(shape: Tuple[int, ...], r: int, cout: int) -> Dict:
    """The bf16 apply kernel's plan: the first of :func:`apply_plans`."""
    return apply_plans(shape, r, cout)[0]


def f32_chunk(r: int) -> int:
    """Hidden units a chunk of the float32 apply (``f32_rc`` of the source):
    all of R up to 64, else the largest of 64, 48, 32, 16 that divides R. Its
    sums run over R in order whatever the chunk."""
    return r if r <= 64 else next(n for n in (64, 48, 32, 16) if r % n == 0)


def kernel_plan(shape: Tuple[int, ...], dtype: torch.dtype, r: Optional[int] = None,
                cout: Optional[int] = None) -> Dict:
    """The plans the kernels take for x of ``shape`` in ``dtype`` (pure
    Python, the same on any machine): ``dw_stats``, and with ``r`` the
    apply pass's (``f32_check`` for float32, which keeps the first design)."""
    plan = {"dw_stats": stats_plan(tuple(shape), dtype)}
    if r is not None:
        cout = cout or shape[-1]
        plan["fused_block_apply"] = (apply_plan(tuple(shape), r, cout) if dtype == torch.bfloat16
                                     else dict(kernel="f32_check", rc=f32_chunk(r)))
    return plan


def card_report(kind: int, shape, dtype: torch.dtype, plan: Dict, device: int, r: int = 0, cout: int = 0) -> Dict:
    """What the card makes of ``plan`` for one kernel (kind 0: statistics, 1:
    bf16 apply, 2: the float32 apply, whose tiles follow from the shape):
    its shared memory, items, resident blocks a SM, grid and registers a
    thread. The first report of a kernel on a device also lets it take all
    of the shared memory, which its launches need."""
    lib = build.load("mednext_block")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _check(lib.mednext_ring_plan(kind, int(dtype == torch.bfloat16), *shape, r, cout, plan.get("ty", 1),
                                     _tx(plan, shape[3]), plan.get("seg", 1), plan.get("ring", 3), plan.get("cs", 0),
                                     plan.get("rc", 0), out), lib)
    return dict(card_smem_bytes=out[0], card_items=out[1], blocks_per_sm=out[2], grid=out[3], registers=out[4])


_PLANS: Dict[tuple, tuple] = {}


def _card_plan(kind: int, shape, dtype: torch.dtype, device: int, r: int = 0, cout: int = 0) -> tuple:
    """(plan, grid, card report) of one kernel, from the planner and the
    card once per (kernel, shape, dtype, device); raises if the card's
    shared memory or items for the plan differ from the planner's."""
    key = (kind, shape, dtype, device, r, cout)
    hit = _PLANS.get(key)
    if hit is not None:
        return hit
    plan = (stats_plan(shape, dtype) if kind == 0 else apply_plan(shape, r, cout) if kind == 1
            else dict(kernel="f32_check", rc=f32_chunk(r)))
    rep = card_report(kind, shape, dtype, plan, device, r, cout)
    if kind < 2 and (rep["card_smem_bytes"] != plan["smem_bytes"] or rep["card_items"] != plan["items"]):
        raise RuntimeError(f"the card's report {rep} disagrees with the planner's {plan}")
    hit = _PLANS[key] = (plan, rep["grid"], rep)
    return hit


def card_plan(shape, dtype: torch.dtype, r: Optional[int] = None, cout: Optional[int] = None,
              device: int = 0) -> Dict:
    """:func:`kernel_plan` with the card's report (:func:`card_report`) of
    each kernel's plan. Needs the built library and the card."""
    plan = kernel_plan(shape, dtype, r, cout)
    kinds = [("dw_stats", 0)]
    if r is not None:
        kinds.append(("fused_block_apply", 1 if dtype == torch.bfloat16 else 2))
    for name, kind in kinds:
        plan[name].update(_card_plan(kind, tuple(shape), dtype, device, r or 0, cout or shape[-1])[2])
    return plan


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


def dw_stats(x: torch.Tensor, w_dw: torch.Tensor, plan: Optional[Dict] = None) -> torch.Tensor:
    """(B, 2, C) float32 GroupNorm statistics of dw(x); see the module doc.
    ``plan`` (``ty``, ``seg``, ``ring``, and ``tx``, by default whole rows)
    replaces the planner's on the card, and its ``grid``, if given, the
    number of persistent blocks (the result does not depend on it)."""
    refuse_grad("dw_stats", x, w_dw)
    if x.is_cpu:
        return dw_stats_plain(x, w_dw)
    code = _dtype_code(x)
    b, z, y, xs, c = x.shape
    w = w_dw.reshape(c, 27)
    if w.dtype != torch.float32 or not w.is_contiguous():
        w = w.float().contiguous()
    _check_cuda_inputs(x, w)
    lib = build.load("mednext_block")
    dev = x.get_device()
    if plan is None:
        plan, grid, _ = _card_plan(0, x.shape, x.dtype, dev)
    else:
        rep = card_report(0, x.shape, x.dtype, plan, dev)  # also lets the kernel take its shared memory
        grid = plan.get("grid") or rep["grid"]
    n = b * 2 * c
    tx = _tx(plan, xs)
    parts = -(-z // plan["seg"]) * -(-y // plan["ty"]) * -(-xs // tx)
    buf = torch.empty(n * (parts + 1), device=x.device, dtype=torch.float32)
    out = buf[:n].view(b, 2, c)
    rc = lib.mednext_dw_stats(x.data_ptr(), w.data_ptr(), buf.data_ptr() + 4 * n, buf.data_ptr(), code, b, z, y, xs,
                              c, plan["ty"], tx, plan["seg"], plan["ring"], grid, build.stream(dev))
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
    x, stats, w_dw, gamma, beta, w1, b1, w2, b2, eps: float = EPS, plan: Optional[Dict] = None
) -> torch.Tensor:
    """(B, Z, Y, X, Cout) in x's dtype: the whole block given
    :func:`dw_stats` of x; see the module doc. ``plan`` (``ty``, ``seg``,
    ``cs``, ``rc``, and ``tx``, by default whole rows) replaces the
    planner's for bf16 on the card."""
    refuse_grad("fused_block_apply", x, stats, w_dw, gamma, beta, w1, b1, w2, b2)
    if x.is_cpu:
        return fused_block_apply_plain(x, stats, w_dw, gamma, beta, w1, b1, w2, b2, eps)
    code = _dtype_code(x)
    b, z, y, xs, c = x.shape
    r, cout = w1.shape[0], w2.shape[0]
    _require(w1.shape == (r, c), "w1 must be (R, C) = (*, {}), got {}", c, w1.shape)
    _require(w2.shape == (cout, r), "w2 must be (Cout, R) = (*, {}), got {}", r, w2.shape)
    _require(r % 16 == 0, "hidden width {} not supported", r)
    _require(cout % 16 == 0, "output channels must be a multiple of 16, got {}", cout)
    _require(w1.dtype == x.dtype and w2.dtype == x.dtype, "w1 and w2 must be {} like x", x.dtype)
    w_dw = w_dw.reshape(c, 27)
    _require(stats.dtype == w_dw.dtype == gamma.dtype == beta.dtype == b1.dtype == b2.dtype == torch.float32,
             "stats, w_dw, norm affine and biases must be float32")
    _require(stats.shape == (b, 2, c), "stats must be (B, 2, C), got {}", stats.shape)
    _check_cuda_inputs(x, stats, w_dw, gamma, beta, w1, b1, w2, b2)
    _require(w1.data_ptr() % 32 == 0 and w2.data_ptr() % 32 == 0, "weights must be 32-byte aligned")
    lib = build.load("mednext_block")
    dev = x.get_device()
    out = torch.empty((b, z, y, xs, cout), device=x.device, dtype=x.dtype)
    args = (x.data_ptr(), stats.data_ptr(), w_dw.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr())
    if code:
        if plan is None:
            plan, grid, _ = _card_plan(1, x.shape, x.dtype, dev, r, cout)
        else:
            grid = card_report(1, x.shape, x.dtype, plan, dev, r, cout)["grid"]
        rc = lib.mednext_apply_bf16(*args, b, z, y, xs, c, r, cout, plan["ty"], _tx(plan, xs), plan["seg"],
                                    plan["cs"], plan["rc"], grid, ctypes.c_float(eps), build.stream(dev))
    else:
        _card_plan(2, x.shape, x.dtype, dev, r, cout)  # once: lets the kernel take its shared memory
        rc = lib.mednext_block_apply_f32(*args, b, z, y, xs, c, r, cout, ctypes.c_float(eps), build.stream(dev))
    _check(rc, lib)
    fused_block_apply.launches += 1
    return out


fused_block_apply.launches = 0


def fused_mednext_block(x, w_dw, gamma, beta, w1, b1, w2, b2, eps: float = EPS) -> torch.Tensor:
    """Statistics pass then apply pass: the block on channels-last x."""
    refuse_grad("fused_mednext_block", x, w_dw, gamma, beta, w1, b1, w2, b2)
    return fused_block_apply(x, dw_stats(x, w_dw), w_dw, gamma, beta, w1, b1, w2, b2, eps)


def fused_mednext_block_plain(x, w_dw, gamma, beta, w1, b1, w2, b2, eps: float = EPS) -> torch.Tensor:
    """Both plain versions, on any device."""
    return fused_block_apply_plain(x, dw_stats_plain(x, w_dw), w_dw, gamma, beta, w1, b1, w2, b2, eps)


KERNELS = (dw_stats, fused_block_apply)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
