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
  :func:`kernel_plan` picks the launch per (M, C, E, dtype) with a cost model
  of the card (rows a tile, the warps' rows and columns, the cluster that
  splits E, resident or streamed weights); :func:`card_plan` adds what the
  card reports for it.
- :func:`pointwise` -> ``x @ w.T`` for ``x (..., C)`` and ``w (Cout, C)``,
  accumulated in f32 and rounded to x's dtype, no bias: the function of the
  pointwise probes ``pw_cf`` of ``scripts/tpu_bf16_experiments.py:181`` and
  ``scripts/tpu_bf16_experiments2.py:171``. Kernels of its own: float32 in
  register tiles on the CUDA cores (one ``fmaf`` a term in k order, no
  TF32), bfloat16 on the tensor cores.

The weights must be in x's dtype (the JAX op would promote mixed dtypes,
which is another function); the biases may be float32 or x's dtype and are
used in float32. The fused MLP takes float32 or bfloat16 at any C and E (C
up to 1024 in bfloat16): the kernel takes the weights at the plan's padded
widths, which the MedNeXt widths are already, and the wrapper pads others
with zeros (a hidden unit past E gives gelu(0) = 0 against a zero row of
W2). The pointwise conv takes C and Cout multiples of 16 (C up to 1024 in
bfloat16 and 1536 in float32); the plain versions take any width.

Given CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute. Neither has a backward pass: called with grad
enabled on a tensor that requires grad, a wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .fused_block import MAX_SMEM, SM_SMEM, SMS, THREADS, WARPS, _align, _dtype_code, _require, refuse_grad

# the plan's fields, in the order of fmlp::PlanIn (csrc/fused_mlp.cu)
PLAN_FIELDS = ("bf16", "c", "e", "cq", "eq", "bm", "mf", "wn", "npw", "ka", "np", "cs", "es", "ec", "nbuf", "rh",
               "ro", "cb", "resident", "xr", "eh", "wk", "de")
CLUSTERS = (1, 2, 4, 8, 16)  # blocks a cluster; 16 takes the card's non-portable cluster size
# the cost model, in cycles of an SM at about 1.755 GHz: an mma.sync
# m16n8k16 with its share of ldmatrix traffic (about two cycles: shared
# memory's 128 bytes a cycle), tanh-GELU and an output value (thread
# instructions over 128 lanes), a stage's barrier and wait, a cluster's two
# barriers around the reduction, an x tile's copy latency; a float32 FMA (64
# a cycle); the copy rates of HBM and L2, bytes a cycle (fitted to card
# sweeps of the plans, tools/block_phases.py --source fused_mlp.cu --sweep)
MMA_CLK, GELU_INSTR, OUT_INSTR, STAGE_CLK, CLUSTER_CLK, X_LAT_CLK = 2.0, 12, 4, 600, 2000, 2000
FMA_PER_CLK, GELU_F32_INSTR = 64.0, 30
HBM_BYTES_CLK, L2_BYTES_CLK = 1700.0, 3400.0


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


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _ceil(n: int, k: int) -> int:
    return -(-n // k) * k


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _odd_stride(n: int) -> int:
    """A bf16 row stride of n values (a multiple of 8) widened to an odd
    multiple of 16 bytes (``odd_stride`` of the source)."""
    return n if (n // 8) % 2 else n + 8


def plan_smem(p: Dict) -> int:
    """Shared memory of a plan (``layout`` of the source): the bf16 warp
    kernel, the weights and each warp's ring of ``xr`` fragments and its tile;
    the bf16 block kernel, the ring of ``xr`` x tiles, the weight buffers (one
    resident, or a ring of two chunks), the epilogue's region (the
    warps' bf16 tiles, or the cluster's f32 partials) and, where ``wn`` warps
    share a row, its fragments' bf16 h tiles; f32, the two x tiles, the
    hidden chunk of ``eh`` units and, resident, W1 and W2."""
    cq, bm = p["cq"], p["bm"]
    if p["bf16"] and p["wk"]:  # the weights, then each warp's ring of xr fragments and its tile (not stored directly)
        wbuf = _align((cq * _odd_stride(p["ec"]) + p["ec"] * _odd_stride(cq)) * 2)
        return wbuf + WARPS * _align((p["xr"] * 16 * _odd_stride(cq) + (0 if p["de"] else 16 * _odd_stride(cq))) * 2)
    if p["bf16"]:
        wbuf = _align((cq * _odd_stride(p["ec"]) + p["ec"] * _odd_stride(cq)) * 2)
        epi = bm * (cq + 8) * 4 if p["cs"] > 1 else WARPS * 16 * _odd_stride(16 * p["npw"]) * 2
        hid = _align(p["mf"] * 16 * _odd_stride(p["ec"]) * 2) if p["wn"] > 1 else 0
        return _align(p["xr"] * bm * _odd_stride(cq) * 2) + p["nbuf"] * wbuf + _align(epi) + hid
    wbuf = _align(cq * p["eq"] * 4) if p["resident"] else 0
    return _align(2 * bm * (cq + 4) * 4) + _align(bm * (p["eh"] + 4) * 4) + 2 * wbuf


def _bf16_min_blocks(np_: int) -> int:
    """Resident blocks a SM the bf16 kernel is built for (its launch bounds)."""
    return 2 if np_ <= 4 else 1


def _sm_time(tiles: int, occ: int, tile_clk: float, cs: int = 1, lone: float = 1.3) -> float:
    """Cycles of a launch whose blocks take ``tiles`` tiles of ``tile_clk``
    cycles each (an SM's throughput): the tiles of the busiest SM, slower by
    ``lone`` where it holds a single block (eight warps hide little of their
    latency). Clusters of ``cs`` blocks are placed within a GPC (16-18 SMs
    each): 16-block clusters reach 112 SMs, 4- and 8-block ones 128."""
    sms = {16: 112, 8: 128, 4: 128}.get(cs, SMS)
    per_sm = -(-tiles // sms)
    return per_sm * tile_clk * (lone if min(occ, per_sm) == 1 else 1.0)


def _bf16_plans(m: int, c: int, e: int) -> List[Dict]:
    cq = _ceil(c, 16)
    nk = cq // 16
    ka = _pow2_at_least(max(nk, 2)) if cq <= 128 else 0
    hbm = (2 * m * c * 2 + 4 * c * e) / HBM_BYTES_CLK
    out = []
    # the warp kernel: resident weights, each warp on its own 16-row fragments
    # (C up to 128; there its stores go straight from the accumulators, so
    # that the weights and eight warps' rings fit); the deepest ring that
    # keeps the kernel's occupancy
    if cq <= 128:
        es = _ceil(e, 16)
        np_ = _pow2_at_least(max(nk, 2))
        blocks = _bf16_min_blocks(np_)
        # stores straight from the accumulators measured faster at 1-2 pairs and at 8
        # (C 32, C 128), through the warp's tile at 4 (C 64); the other way stays a plan
        direct = int(c % 2 == 0 and (nk <= 2 or nk > 4))
        for de in (direct, 1 - direct) if c % 2 == 0 else (0,):
            for xr in (4, 3, 2):
                p = dict(bf16=1, c=c, e=e, cq=cq, eq=es, bm=128, mf=8, wn=1, npw=nk, ka=np_, np=np_, cs=1, es=es,
                         ec=es, nbuf=1, rh=0, ro=0, cb=0, resident=1, xr=xr, eh=0, wk=1, de=de)
                smem = plan_smem(p)
                occ = min(blocks, SM_SMEM // (smem + 1024))
                if smem <= MAX_SMEM and occ == blocks:
                    frags = -(-m // 16)
                    mma = 2 * (es // 16) * (nk + nk)
                    frag = mma * MMA_CLK + 16 * es * GELU_INSTR / 128 + 16 * cq * OUT_INSTR / 128
                    compute = _sm_time(-(-frags // WARPS), occ, frag * WARPS) * (1 if de == direct else 1.1)
                    out.append(dict(p, smem_bytes=smem, tiles=-(-m // 128), est_occ=occ,
                                    est_clk=round(max(compute, hbm))))
                    break
    for cs in CLUSTERS:
        es = _ceil(-(-e // cs), 16)
        if cs > 1 and es * (cs - 1) >= e:  # a block of the cluster would have no real hidden unit
            continue
        eq = es * cs
        for mf in (8, 4, 2, 1):
            wn, bm = WARPS // mf, 16 * mf
            npw = -(-nk // wn)
            if bm < cs or npw > 8:
                continue
            np_ = 8 if cs > 1 else _pow2_at_least(max(npw, 2))  # the cluster's epilogue is built for 8 pairs
            chunks = [(es, 1)] + [(ec, 2) for ec in (128, 64, 32, 16) if ec < es and es % ec == 0]
            for ec, nbuf in chunks:
                nch = es // ec
                p = dict(bf16=1, c=c, e=e, cq=cq, eq=eq, bm=bm, mf=mf, wn=wn, npw=npw, ka=ka, np=np_, cs=cs, es=es,
                         ec=ec, nbuf=nbuf, rh=0, ro=0, cb=0, resident=int(nbuf == 1), xr=2, eh=0, wk=0, de=0)
                smem = plan_smem(p)
                if smem > MAX_SMEM:
                    continue
                occ = min(_bf16_min_blocks(np_), SM_SMEM // (smem + 1024))
                if occ < 1:
                    continue
                # resident weights: the deepest x ring (up to four tiles) that keeps the occupancy
                for deeper_xr in (4, 3) if nbuf == 1 else ():
                    deeper = plan_smem(dict(p, xr=deeper_xr))
                    if deeper <= MAX_SMEM and SM_SMEM // (deeper + 1024) >= occ:
                        p["xr"], smem = deeper_xr, deeper
                        break
                tiles = -(-m // bm)
                # WN > 1: each hidden block of a chunk computed once by one of the row's WN warps, which
                # then meet at a barrier (their shares and waits cost about 40% more MMA time, fitted)
                mma = WARPS * 2 * (nch * -(-(ec // 16) // wn) * nk + (es // 16) * npw) * (1.2 if wn > 1 else 1)
                tile = (mma * MMA_CLK + bm * es * GELU_INSTR / 128 + bm * cq * OUT_INSTR / 128 * (2 if cs > 1 else 1)
                        + nch * STAGE_CLK * (2 if wn > 1 else 1) + (CLUSTER_CLK if cs > 1 else 0))
                if nbuf > 1:  # every tile streams the block's weight slice from L2, an SM's share of its rate
                    tile += 4 * cq * es / (L2_BYTES_CLK / SMS)
                else:  # the x copies' latency, hidden behind xr - 1 tiles
                    tile += X_LAT_CLK / (p["xr"] - 1)
                compute = _sm_time(tiles * cs, occ, tile, cs)
                l2 = (m * cq * 2 * cs + (tiles * cs * 4 * cq * es if nbuf > 1 else 0)) / L2_BYTES_CLK
                # without a cluster, a warp of one or two pairs stores straight from its accumulators
                out.append(dict(p, de=int(cs == 1 and npw <= 2 and c % 2 == 0), smem_bytes=smem, tiles=tiles, est_occ=occ,
                                est_clk=round(max(compute, hbm, l2))))
    return out


def _f32_plans(m: int, c: int, e: int) -> List[Dict]:
    cq = _pow2_at_least(max(c, 16))
    out = []
    for bm in (128, 64, 32, 16):
        for rh in (8, 4, 2, 1):
            eh = 4 * THREADS * rh // bm  # the chunk that gives every thread RH rows x 4 hidden units
            if not 16 <= eh <= 512:
                continue
            eq = _ceil(e, eh)
            cb = cq
            while cb >= 16:
                txo = cb // 8
                tyo = THREADS // txo if txo <= THREADS else 0
                ro = bm // tyo if tyo and bm % tyo == 0 else 0
                if ro in (1, 2, 4, 8):
                    for resident in (1, 0):
                        if resident and 8 * cq * eq > 65536:
                            continue
                        p = dict(bf16=0, c=c, e=e, cq=cq, eq=eq, bm=bm, mf=0, wn=0, npw=0, ka=0, np=0, cs=1, es=0,
                                 ec=0, nbuf=0, rh=rh, ro=ro, cb=cb, resident=resident, xr=2, eh=eh, wk=0, de=0)
                        smem = plan_smem(p)
                        if smem > MAX_SMEM:
                            continue
                        regs = 8 * ro + 8 * rh + 40
                        occ = min(65536 // (THREADS * regs), SM_SMEM // (smem + 1024), 8)
                        tiles, ncb = -(-m // bm), cq // cb
                        # a thread's FMAs over its loads (of W1 and x, or of W2 and h) set the rate: the
                        # load pipe feeds about 8 FMAs a load at the CUDA cores' rate (fitted to a card
                        # sweep: 128-row tiles with resident weights at C 64, 16 x 512 tiles at C 512)
                        f1 = min(1.0, 4 * rh / (1 + rh / 4) / 8)
                        f2 = min(1.0, 8 * ro / (2 + ro / 4) / 8)
                        tile = (bm * cq * eq / f1 + bm * eq * cb / f2) / FMA_PER_CLK + bm * eq * GELU_F32_INSTR / 128
                        tile += (eq // eh) * STAGE_CLK
                        if not resident:  # the weights through L1 from L2, an SM's share of its rate
                            tile += (cq * eq + eq * cb) * 4 / (L2_BYTES_CLK / SMS)
                        compute = _sm_time(tiles * ncb, occ, tile, lone=1.0 if resident else 2.0)
                        hbm = (2 * m * c * 4 + 8 * c * e) / HBM_BYTES_CLK
                        out.append(dict(p, smem_bytes=smem, tiles=tiles, est_occ=occ,
                                        est_clk=round(max(compute, hbm))))
                cb //= 2
    return out


def plans(m: int, c: int, e: int, dtype: torch.dtype) -> List[Dict]:
    """Every plan of the fused MLP kernel for (M, C, E) in ``dtype`` that fits
    a block's shared memory, fastest first by the cost model (``est_clk``:
    the waves of tiles over the SMs, a tile's MMAs with their ldmatrix
    traffic, GELU, epilogue and stage barriers, or its FMAs; no less than
    the bytes over HBM's and L2's rates)."""
    _require(m >= 1 and c >= 1 and e >= 1, "the fused MLP needs rows and widths, got M {} C {} E {}", m, c, e)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fused MLP kernel takes float32 or bfloat16, got {dtype}")
    out = (_bf16_plans(m, c, e) if c <= 1024 else []) if dtype == torch.bfloat16 else _f32_plans(m, c, e)
    if not out:
        raise RuntimeError(f"shape not supported by the fused MLP kernel: no plan fits C {c}, E {e} in {dtype}")
    return sorted(out, key=lambda p: (p["est_clk"], p["smem_bytes"], -p["bm"]))


def kernel_plan(m: int, c: int, e: int, dtype: torch.dtype) -> Dict:
    """The plan the fused MLP takes for (M, C, E) in ``dtype`` (pure Python,
    the same on any machine): the first of :func:`plans`."""
    return plans(m, c, e, dtype)[0]


def _plan_array(plan: Dict):
    return (ctypes.c_int * len(PLAN_FIELDS))(*(int(plan[k]) for k in PLAN_FIELDS))


def card_report(plan: Dict, m: int, device: int) -> Dict:
    """What the card makes of ``plan`` at ``m`` rows: its shared memory,
    tiles, resident blocks a SM, blocks of the grid, clusters held at once
    and registers a thread. The first report of a kernel on a device also
    lets it take all of the shared memory, which its launches need."""
    lib = build.load("fused_mlp")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        _check(lib.fused_mlp_plan(_plan_array(plan), m, out), lib)
    return dict(card_smem_bytes=out[0], card_tiles=out[1], blocks_per_sm=out[2], grid=out[3], clusters=out[4],
                registers=out[5])


_PLANS: Dict[tuple, tuple] = {}


def _card_plan(m: int, c: int, e: int, dtype: torch.dtype, device: int) -> tuple:
    """(plan, its C array, card report) per (M, C, E, dtype, device), from the
    planner and the card once; raises if the card's shared memory or tiles
    differ from the planner's."""
    key = (m, c, e, dtype, device)
    hit = _PLANS.get(key)
    if hit is not None:
        return hit
    lib = build.load("fused_mlp")
    if lib.fused_mlp_plan_fields() != len(PLAN_FIELDS):
        raise RuntimeError("the fused MLP library's plan fields differ from PLAN_FIELDS")
    plan = kernel_plan(m, c, e, dtype)
    rep = card_report(plan, m, device)
    if rep["card_smem_bytes"] != plan["smem_bytes"] or rep["card_tiles"] != plan["tiles"]:
        raise RuntimeError(f"the card's report {rep} disagrees with the planner's {plan}")
    hit = _PLANS[key] = (plan, _plan_array(plan), rep)
    return hit


def card_plan(m: int, c: int, e: int, dtype: torch.dtype, device: int = 0) -> Dict:
    """:func:`kernel_plan` with the card's report (:func:`card_report`).
    Needs the built library and the card."""
    plan, _, rep = _card_plan(m, c, e, dtype, device)
    return {**plan, **rep}


def _padded(t: torch.Tensor, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous, zero-padded at the end of each axis to ``shape``."""
    if tuple(t.shape) == shape:
        return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()
    out = torch.zeros(shape, device=t.device, dtype=dtype)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def fused_mlp_residual(x, w1, b1, w2, b2, plan: Optional[Dict] = None):
    """(M, C) in x's dtype: ``x + gelu_tanh(x @ w1 + b1) @ w2 + b2``; see the
    module doc. ``plan`` (one of :func:`plans`) replaces the planner's."""
    refuse_grad("fused_mlp_residual", x, w1, b1, w2, b2)
    _require(x.dim() == 2, "x must be (M, C), got {}", x.shape)
    m, c = x.shape
    _require(w1.dim() == 2 and w1.shape[0] == c, "w1 must be ({}, E), got {}", c, w1.shape)
    e = w1.shape[1]
    _require(w2.shape == (e, c), "w2 must be ({}, {}), got {}", e, c, w2.shape)
    _require(b1.shape == (e,) and b2.shape == (c,), "b1 must be ({},) and b2 ({},)", e, c)
    _check_weights(x, w1, w2)
    if x.device.type == "cpu":
        return fused_mlp_residual_plain(x, w1, b1, w2, b2)
    _dtype_code(x)
    _require(x.is_contiguous() and x.data_ptr() % 16 == 0, "x must be contiguous and 16-byte aligned")
    dev = x.get_device()
    for t in (w1, b1, w2, b2):
        _require(t.get_device() == dev, "all tensors must be on the device of x")
    if plan is None:
        plan, arr, _ = _card_plan(m, c, e, x.dtype, dev)
    else:
        arr = _plan_array(plan)
        card_report(plan, m, dev)  # lets the plan's kernel take its shared memory
    cq, eq = plan["cq"], plan["eq"]
    w1, w2 = _padded(w1, (cq, eq), x.dtype), _padded(w2, (eq, cq), x.dtype)
    b1, b2 = _padded(b1, (eq,), torch.float32), _padded(b2, (cq,), torch.float32)
    out = torch.empty_like(x)
    lib = build.load("fused_mlp")
    _check(lib.fused_mlp_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                             out.data_ptr(), arr, m, build.stream(dev)), lib)
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
