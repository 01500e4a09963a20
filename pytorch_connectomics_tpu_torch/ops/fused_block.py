"""The fused MedNeXt block: a depthwise k^3 conv (k 3 or 5), per-channel
GroupNorm, pointwise expand, tanh-GELU, pointwise compress and residual, as
two hand-written CUDA kernels (``csrc/mednext_block.cu``) with a plain
PyTorch version of each beside it. The plain versions take any odd k.

- :func:`dw_stats` -> per-(b, c) ``[sum dw(x), sum dw(x)^2]`` over the volume
  (dw without bias): the GroupNorm statistics. Replaces the TPU kernel
  ``dw_stats`` of ``pytorch_connectomics_tpu/ops/fused_block_pallas.py:148``.
- :func:`fused_block_apply` -> ``x + W2 . gelu_tanh(W1 . GN(dw(x) + b_dw) + b1) + b2``
  given those statistics. Replaces ``fused_block_apply_cf`` (``:238``) with
  the GroupNorm folding of ``fold_block_weights`` (``:294``) done in-kernel.

Activations are channels-last ``(B, Z, Y, X, C)``, contiguous, float32 or
bfloat16, C a multiple of 16 up to 1024. Weights keep PyTorch's layouts:
``w_dw`` ``(C, 1, kz, k, k)``, ``w1`` ``(R, C)``, ``w2`` ``(Cout, R)``
(``nn.Linear``), biases and norm affine ``(n,)``. The depthwise taps are
k^3 (``kz == k``) or the (1, k, k) taps of MedNeXt's 2-D mode (``kz == 1``),
which the wrappers embed in a k^3 tap set whose other z planes are zero, so
both run the same kernels (:func:`taps3d`); the sums gain only zero
products. The kernels take ``w1`` and ``w2`` in x's dtype (the caller casts
them once, not per call) and the other parameters in float32.

Both kernels (``dw_stats`` in both dtypes, ``fused_block_apply`` in bf16)
march bands of y rows and x columns along segments of z through a ring of
slabs in shared memory (k + 1 or k slabs, each with a halo of k // 2);
:func:`kernel_plan` picks the band rows, the band columns (the whole row
wherever it leaves an SM room for two blocks, else the cost model's best of
every band width), the segment length, the output channels of a warp's unit
and the weight chunk per shape and k, from a cost model of the card, and
:func:`card_plan` adds what the card reports for that plan. The float32
apply pass is the first design's kernel, kept as the arithmetic check.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its kernel launches in
its ``launches`` attribute, and by stencil edge in ``launches_k``. The pair
has no backward pass: called with grad enabled on a tensor that requires
grad, a wrapper raises rather than return a result cut off from the
autograd graph (training runs the unfused block, ``models/mednext.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

EPS = 1e-6  # flax GroupNorm epsilon

# the kernels' constants (csrc/mednext_block.cu)
RUN = 3  # x outputs of a thread's run
KERNELS_K = (3, 5)  # the stencil edges the kernels are built for
APPLY_RING = 3  # slabs in the apply pass's ring at k 3: k (the statistics pass: k + 1, or k where k + 1 do not fit)
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


def ring_geometry(shape: Tuple[int, ...], ty: int, seg: int, tx: Optional[int] = None, k: int = 3) -> Dict[str, int]:
    """The walk of the ring kernels of a k^3 stencil for x of ``shape`` (B,
    Z, Y, X, C): bands of ``ty`` rows and ``tx`` columns (a multiple of
    three; by default the whole row), segments of ``seg`` slabs; an item is
    (b, segment, y band, x band), numbered ``((b * segs + s) * bands + band)
    * xbands + xband``; a slab holds the band's rows with ``hl = k // 2``
    halo rows each side, a slab row ``xp`` voxels (the band's runs of three
    and ``hl`` halo voxels each side), a band row ``tw`` outputs."""
    b, z, y, x, c = shape
    tx = whole_row(x) if tx is None else tx
    h = k // 2
    bands, xbands, segs = -(-y // ty), -(-x // tx), -(-z // seg)
    return dict(ty=ty, tx=tx, seg=seg, bands=bands, xbands=xbands, segs=segs, items=b * segs * bands * xbands,
                nrx=tx // RUN, xp=tx + 2 * h, tw=min(tx, x), hl=h, slab=(ty + 2 * h) * (tx + 2 * h) * c)


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


def stats_smem(shape, es: int, ty: int, ring: int = 4, tx: Optional[int] = None, k: int = 3) -> int:
    """Shared memory of the statistics kernel: its ring of ``ring`` slabs
    and the per-slot sums it reduces (``stats_smem`` of the source)."""
    c = shape[-1]
    pt = min(c // 2, THREADS)
    return _align(ring * ring_geometry(shape, ty, 1, tx, k)["slab"] * es) + _align((THREADS // pt) * 2 * c * 4)


def apply_smem(shape, r: int, cout: int, ty: int, cs: int, rc: int, tx: Optional[int] = None, k: int = 3) -> int:
    """Shared memory of the bf16 apply kernel (``apply_layout`` of the
    source): a ring of k slabs, the u tile, the weights (whole, or a chunk
    of ``rc`` hidden units; past k 3 W1 only, W2 is read from global
    memory), the warps' output tiles."""
    c = shape[-1]
    g = ring_geometry(shape, ty, 1, tx, k)
    mf = -(-ty * g["tw"] // 16)
    w2 = _align(cout * (rc + 8) * 2) if k == 3 else 0
    return (_align(k * g["slab"] * 2) + _align(16 * mf * (c + 8) * 2)
            + _align(rc * (c + 8) * 2) + w2 + _align(WARPS * 16 * (cs + 8) * 2))


def _sizes(n: int):
    return sorted({min(n, 2 ** k) for k in range(8)} | {n})


def _resident(smem: int, cap: int) -> int:
    return max(0, min(cap, SM_SMEM // (smem + 1024)))


def _waves_time(items: int, occ: int, item_clk: float) -> float:
    """Cycles of the whole launch: waves of SMS x occ items, where an item
    takes ``item_clk`` cycles of its block; a block alone on its SM hides
    less of its barriers' and copies' latency."""
    return math.ceil(items / (SMS * occ)) * item_clk * (1.3 if occ == 1 else 1.0)


def _stencil_clk(g: Dict[str, int], c: int, es: int, k: int = 3) -> float:
    """Issue cycles of one slab step's stencil and staging on an SM: about
    50 thread instructions an output value in bf16 (15 shared loads and their
    conversions, 27 FMAs per three outputs of a pair), 40 in f32, and 12 a
    16-byte copy; 128 thread instructions a cycle. A k^3 stencil's work
    grows with its taps (k^3 / 27; at k 5 the taps are loads too)."""
    outs = g["ty"] * g["tx"] * c
    copies = g["slab"] * es / 16  # the halo columns an x band re-stages included
    return (outs * (50 if es == 2 else 40) * (k ** 3 / 27) + copies * 12) / 128


def stats_plans(shape: Tuple[int, ...], dtype: torch.dtype, every_width: bool = False, k: int = 3) -> List[Dict]:
    """Every plan of the statistics kernel of a k^3 stencil that fits, for
    x of ``shape`` in ``dtype``, fastest first by the cost model
    (``est_clk``); x bands narrower than the row as :func:`_search` allows."""
    es = 2 if dtype == torch.bfloat16 else 4

    def plans_at(tx):
        plans = []
        for ring in (k + 1, k):
            for ty in _sizes(shape[2]):
                smem = stats_smem(shape, es, ty, ring, tx, k)
                occ = _resident(smem, 2)
                if smem > MAX_SMEM or occ < 1:
                    continue
                for seg in _sizes(shape[1]):
                    g = ring_geometry(shape, ty, seg, tx, k)
                    # k slots expose the copies of each slab (one more barrier a
                    # step). Blocks that share an SM share its time, fixed costs
                    # included (the card's timings: 192 short items take 1.5x 96)
                    step = _stencil_clk(g, shape[-1], es, k) * (1.0 if ring == k + 1 else 1.15)
                    share = min(occ, -(-g["items"] // SMS))
                    cost = _waves_time(g["items"], occ, (min(seg, shape[1]) * step + ITEM_CLK) * share)
                    plans.append(dict(kernel="ring_stats", ty=ty, tx=tx, seg=seg, ring=ring, smem_bytes=smem,
                                      items=g["items"], parts=g["items"] // shape[0], est_clk=round(cost)))
        return plans

    plans = _search(shape[3], plans_at, every_width)
    _require(bool(plans), "no statistics plan fits shared memory for {}", shape)
    return sorted(plans, key=lambda p: p["est_clk"])


def stats_plan(shape: Tuple[int, ...], dtype: torch.dtype, k: int = 3) -> Dict:
    """The statistics kernel's plan for x of ``shape`` in ``dtype``."""
    return stats_plans(shape, dtype, k=k)[0]


@functools.lru_cache(maxsize=None)
def stats_groups(shape: Tuple[int, ...], dtype: torch.dtype, k: int = 3) -> int:
    """The channel groups of :func:`dw_stats`'s kernel (its grid's second
    axis, one launch): 1 where a plan fits all C, else the fewest equal
    groups (multiples of 16 channels) whose slabs fit (float32 at k 5 from
    C 512: the ring's k slabs of 5 x 7 voxels outgrow shared memory). The
    statistics are per channel, so the groups' results are the whole's."""
    c = shape[-1]
    for n in range(1, c // 16 + 1):
        if c % n == 0 and (c // n) % 16 == 0:
            try:
                stats_plans((*shape[:4], c // n), dtype, k=k)
                return n
            except ValueError:
                continue
    raise ValueError(f"no statistics plan fits shared memory for {shape} at k {k}")


def _unit_widths(cout: int):
    return [cs for cs in (128, 64, 32, 16) if cout % cs == 0]


def apply_plans(shape: Tuple[int, ...], r: int, cout: int, every_width: bool = False, k: int = 3) -> List[Dict]:
    """Every plan of the bf16 apply kernel that fits, for x of ``shape``, R
    hidden units and ``cout`` outputs, fastest first by the cost model: band
    rows and columns, segment length, output channels a warp's unit
    (``cs``), hidden units a weight chunk (``rc``, R when both weights stay
    resident in shared memory); x bands narrower than the row as
    :func:`_search` allows."""
    plans = _search(shape[3], lambda tx: _apply_plans_at(shape, r, cout, tx, k), every_width)
    _require(bool(plans), "no apply plan fits shared memory for {} (R {}, Cout {})", shape, r, cout)
    return sorted(plans, key=lambda p: (p["est_clk"], p["smem_bytes"]))


def _apply_plans_at(shape, r: int, cout: int, tx: int, k: int = 3) -> List[Dict]:
    b, z, y, x, c = shape
    plans = []
    for cs in _unit_widths(cout):
        # __launch_bounds__ of the kernel (apply_min_blocks; k 5 is built for the runtime C only)
        cap = 2 if cs <= 64 and (c != 128 or k != 3) else 1
        for rc in [r] + [n for n in (64, 32, 16) if n < r and r % n == 0]:
            for ty in _sizes(y):
                smem = apply_smem(shape, r, cout, ty, cs, rc, tx, k)
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
                    g = ring_geometry(shape, ty, seg, tx, k)
                    step = occ * _stencil_clk(g, c, 2, k) + max(occ * issue, chain) + chunks + STEP_CLK
                    item = min(seg, z) * step + ITEM_CLK
                    cost = _waves_time(g["items"], occ, item)
                    plans.append(dict(kernel="ring_apply", ty=ty, tx=tx, seg=seg, ring=k, cs=cs,
                                      ns=cout // cs, mf=mf, units=units, rounds=rounds, rc=rc, resident=rc == r,
                                      smem_bytes=smem, items=g["items"], est_clk=round(cost)))
    return plans


def apply_plan(shape: Tuple[int, ...], r: int, cout: int, k: int = 3) -> Dict:
    """The bf16 apply kernel's plan: the first of :func:`apply_plans`."""
    return apply_plans(shape, r, cout, k=k)[0]


def f32_chunk(r: int) -> int:
    """Hidden units a chunk of the float32 apply (``f32_rc`` of the source):
    all of R up to 64, else the largest of 64, 48, 32, 16 that divides R. Its
    sums run over R in order whatever the chunk."""
    return r if r <= 64 else next(n for n in (64, 48, 32, 16) if r % n == 0)


def kernel_plan(shape: Tuple[int, ...], dtype: torch.dtype, r: Optional[int] = None,
                cout: Optional[int] = None, k: int = 3) -> Dict:
    """The plans the kernels of a k^3 stencil take for x of ``shape`` in
    ``dtype`` (pure Python, the same on any machine): ``dw_stats`` (the plan
    of one of its ``groups`` channel groups, :func:`stats_groups`), and with
    ``r`` the apply pass's (``f32_check`` for float32, which keeps the first
    design)."""
    groups = stats_groups(tuple(shape), dtype, k)
    plan = {"dw_stats": dict(stats_plan((*shape[:4], shape[-1] // groups), dtype, k), groups=groups)}
    if r is not None:
        cout = cout or shape[-1]
        plan["fused_block_apply"] = (apply_plan(tuple(shape), r, cout, k) if dtype == torch.bfloat16
                                     else dict(kernel="f32_check", rc=f32_chunk(r)))
    return plan


def card_report(kind: int, shape, dtype: torch.dtype, plan: Dict, device: int, r: int = 0, cout: int = 0,
                k: int = 3) -> Dict:
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
                                     plan.get("rc", 0), k, out), lib)
    return dict(card_smem_bytes=out[0], card_items=out[1], blocks_per_sm=out[2], grid=out[3], registers=out[4])


_PLANS: Dict[tuple, tuple] = {}


def _card_plan(kind: int, shape, dtype: torch.dtype, device: int, r: int = 0, cout: int = 0, k: int = 3) -> tuple:
    """(plan, grid, card report) of one kernel, from the planner and the
    card once per (kernel, shape, dtype, device, k); raises if the card's
    shared memory or items for the plan differ from the planner's."""
    key = (kind, shape, dtype, device, r, cout, k)
    hit = _PLANS.get(key)
    if hit is not None:
        return hit
    plan = (stats_plan(shape, dtype, k) if kind == 0 else apply_plan(shape, r, cout, k) if kind == 1
            else dict(kernel="f32_check", rc=f32_chunk(r)))
    rep = card_report(kind, shape, dtype, plan, device, r, cout, k)
    if kind < 2 and (rep["card_smem_bytes"] != plan["smem_bytes"] or rep["card_items"] != plan["items"]):
        raise RuntimeError(f"the card's report {rep} disagrees with the planner's {plan}")
    hit = _PLANS[key] = (plan, rep["grid"], rep)
    return hit


def card_plan(shape, dtype: torch.dtype, r: Optional[int] = None, cout: Optional[int] = None,
              device: int = 0, k: int = 3) -> Dict:
    """:func:`kernel_plan` with the card's report (:func:`card_report`) of
    each kernel's plan. Needs the built library and the card."""
    plan = kernel_plan(shape, dtype, r, cout, k)
    kinds = [("dw_stats", 0)]
    if r is not None:
        kinds.append(("fused_block_apply", 1 if dtype == torch.bfloat16 else 2))
    for name, kind in kinds:
        sh = (*shape[:4], shape[-1] // plan["dw_stats"]["groups"]) if kind == 0 else tuple(shape)
        plan[name].update(_card_plan(kind, sh, dtype, device, r or 0, cout or shape[-1], k)[2])
    return plan


# ---------------------------------------------------------------------------
# dw_stats
# ---------------------------------------------------------------------------


def taps3d(w_dw: torch.Tensor) -> torch.Tensor:
    """The depthwise taps ``(C, 1, kz, k, k)`` as a k^3 tap set ``(C, 1, k,
    k, k)``: k^3 taps as they are; the (1, k, k) taps of MedNeXt's 2-D mode
    in the centre z plane, the other planes zero. Differentiable: the
    gradient of an embedded (1, k, k) set is the centre plane's."""
    kz, k = w_dw.shape[2], w_dw.shape[-1]
    _require(w_dw.dim() == 5 and w_dw.shape[1] == 1 and w_dw.shape[3] == k and k % 2 == 1 and kz in (1, k),
             "depthwise taps must be (C, 1, k, k, k) or (C, 1, 1, k, k) with k odd, got {}", tuple(w_dw.shape))
    if kz == k:
        return w_dw
    return F.pad(w_dw, (0, 0, 0, 0, k // 2, k // 2))


def _kernel_taps(w_dw: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(C, k^3) float32 contiguous taps for the kernels, and k."""
    w = taps3d(w_dw)
    k = w.shape[-1]
    _require(k in KERNELS_K, "the kernels take a depthwise k of 3 or 5, got {}", k)
    w = w.reshape(w.shape[0], k ** 3)
    if w.dtype != torch.float32 or not w.is_contiguous():
        w = w.float().contiguous()
    return w, k


def _dw_plain(x: torch.Tensor, w_dw: torch.Tensor) -> torch.Tensor:
    """The bias-free depthwise k^3 SAME conv of channels-last ``x`` in
    float32, channels first (B, C, Z, Y, X)."""
    w = taps3d(w_dw).float()
    k = w.shape[-1]
    return F.conv3d(x.float().permute(0, 4, 1, 2, 3), w, padding=k // 2, groups=x.shape[-1])


def dw_stats_plain(x: torch.Tensor, w_dw: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) float32 ``[sum, sumsq]`` of the bias-free depthwise k^3 SAME
    conv of channels-last ``x``, in float32."""
    t = _dw_plain(x, w_dw)
    return torch.stack([t.sum(dim=(2, 3, 4)), (t * t).sum(dim=(2, 3, 4))], dim=1)


def dw_stats(x: torch.Tensor, w_dw: torch.Tensor, plan: Optional[Dict] = None) -> torch.Tensor:
    """(B, 2, C) float32 GroupNorm statistics of dw(x); see the module doc.
    ``plan`` (``ty``, ``seg``, ``ring``, and ``tx``, by default whole rows;
    ``groups``, by default 1) replaces the planner's on the card, and its
    ``grid``, if given, the number of persistent blocks a channel group (the
    result does not depend on it)."""
    refuse_grad("dw_stats", x, w_dw)
    if x.is_cpu:
        return dw_stats_plain(x, w_dw)
    code = _dtype_code(x)
    b, z, y, xs, c = x.shape
    w, k = _kernel_taps(w_dw)
    _check_cuda_inputs(x, w)
    lib = build.load("mednext_block")
    dev = x.get_device()
    groups = stats_groups(tuple(x.shape), x.dtype, k) if plan is None else plan.get("groups", 1)
    _require(c % groups == 0, "{} channel groups do not divide C {}", groups, c)
    sh = (b, z, y, xs, c // groups)  # the plan is a group's
    if plan is None:
        plan, grid, _ = _card_plan(0, sh, x.dtype, dev, k=k)
    else:
        rep = card_report(0, sh, x.dtype, plan, dev, k=k)  # also lets the kernel take its shared memory
        grid = plan.get("grid") or rep["grid"]
    n = b * 2 * c
    tx = _tx(plan, xs)
    parts = -(-z // plan["seg"]) * -(-y // plan["ty"]) * -(-xs // tx)
    buf = torch.empty(n * (parts + 1), device=x.device, dtype=torch.float32)
    out = buf[:n].view(b, 2, c)
    rc = lib.mednext_dw_stats(x.data_ptr(), w.data_ptr(), buf.data_ptr() + 4 * n, buf.data_ptr(), code, b, z, y, xs,
                              c, groups, plan["ty"], tx, plan["seg"], plan["ring"], k, grid, build.stream(dev))
    _check(rc, lib)
    dw_stats.launches += 1
    dw_stats.launches_k[k] += 1
    return out


dw_stats.launches = 0
dw_stats.launches_k = dict.fromkeys(KERNELS_K, 0)


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
    t = _dw_plain(x, w_dw).permute(0, 2, 3, 4, 1)  # (B, Z, Y, X, C)
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
    w_dw, k = _kernel_taps(w_dw)
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
            plan, grid, _ = _card_plan(1, x.shape, x.dtype, dev, r, cout, k)
        else:
            grid = card_report(1, x.shape, x.dtype, plan, dev, r, cout, k)["grid"]
        rc = lib.mednext_apply_bf16(*args, b, z, y, xs, c, r, cout, plan["ty"], _tx(plan, xs), plan["seg"],
                                    plan["cs"], plan["rc"], k, grid, ctypes.c_float(eps), build.stream(dev))
    else:
        _card_plan(2, x.shape, x.dtype, dev, r, cout, k)  # once: lets the kernel take its shared memory
        rc = lib.mednext_block_apply_f32(*args, b, z, y, xs, c, r, cout, k, ctypes.c_float(eps), build.stream(dev))
    _check(rc, lib)
    fused_block_apply.launches += 1
    fused_block_apply.launches_k[k] += 1
    return out


fused_block_apply.launches = 0
fused_block_apply.launches_k = dict.fromkeys(KERNELS_K, 0)


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
        k.launches_k = dict.fromkeys(KERNELS_K, 0)
