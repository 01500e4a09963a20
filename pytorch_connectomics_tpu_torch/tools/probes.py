"""Op-level probes of the card's ceilings and of the TPU prototypes'
functions, the counterpart of ``scripts/tpu_vpu_probe.py`` and
``scripts/tpu_bf16_experiments.py``/``tpu_bf16_experiments2.py``. Channels
last throughout: the TPU's CF lane layout, 128-lane padding and halo planes
are not carried over.

- ``fma_chain_<dtype>_<rows>x<cols>``: a 256-step FMA chain a value through
  the port's kernel ``fma_chain``, at the script's (256, 1024) and at
  (16384, 4096), which fills all 132 SMs of an H100 many times over; T-FMA/s
  (one fused multiply-add a step; bf16 runs packed pairs).
- ``dw_stencil_<dtype>``: the depthwise 3^3 conv at (8, 112^3, 32) through
  ``depthwise3x3`` against ``F.conv3d(groups=C)``; T-FMA/s of its 27 taps a
  value (the script counted the TPU's pad lanes too).
- ``E1_<op>``, ``E1b_shift_<dtype>``: the data-movement probes at (32,
  14592) through ``lane_shift`` (copy, roll by 5, zero-filled shift by 128,
  roll by 1, zero-filled shift by 1): OK or failed against the plain
  version, with the one library call that computes each timed beside it
  (``Tensor.clone``, ``torch.roll``, ``F.pad`` of a slice), and the host
  time per call of both (``host_us``, ``library_host_us``: at this size a
  call is host work). ``copy_1GiB_bf16`` and ``roll5_1GiB_bf16``:
  ``lane_shift`` at offset 0 and as a roll by 5 on 1 GiB, GB/s (bytes read
  and written), with ``Tensor.copy_`` and ``torch.roll`` beside them.
- ``E2_<dtype>``: a 3^3 conv 32 -> 64 at (8, 112^3) through ``conv3d_3x3``,
  keeping the first 32 channels as the script does; T-MAC/s of the 27 taps
  x 64 x 32 MACs a voxel.
- ``E3_pw_<dtype>``: the pointwise conv 32 -> 32 at (8, 112^3) through
  ``pointwise``, GB/s (input read and output written), with ``F.linear``
  beside it.

The records of the port's kernels hold each output against its plain
version and carry its bound (see :mod:`..tools`).

Run: ``python -m pytorch_connectomics_tpu_torch.tools.probes [--device cpu]
[--small] [--out-dir DIR]``; see :mod:`..tools`.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops import conv3d, depthwise, fused_mlp, probes
from . import PEAK_BF16_CC, PEAK_BF16_TC, PEAK_F32, bf16_ulps, bound, randn, rate, setup

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
INNER = 256
TWO_ULPS = "2 bf16 ulps at the largest |plain output|"


def zero_shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``x`` shifted by ``offset`` along its last axis with zero fill, in one
    library call: ``F.pad`` of the kept slice, the scripts' own
    ``jnp.pad(a[:, k:])``. The yardstick of the zero-filled ``lane_shift``."""
    if offset > 0:
        return F.pad(x[..., : max(x.shape[-1] - offset, 0)], (min(offset, x.shape[-1]), 0))
    k = min(-offset, x.shape[-1])
    return F.pad(x[..., k:], (0, k))


def shift_bytes(x: torch.Tensor, offset: int, circular: bool) -> int:
    """Bytes a shift must move: every output written once, and the inputs
    it keeps read once (a zero-filled shift by k drops k of each row)."""
    f = x.shape[-1]
    kept = f if circular else f - min(abs(offset), f)
    return (x.numel() + x.numel() // f * kept) * x.element_size()


def shift_library(x: torch.Tensor, offset: int, circular: bool):
    """(name, call) of the one library call that computes ``lane_shift(x,
    offset, circular)``: ``Tensor.clone`` for the copy, ``torch.roll`` for a
    circular shift, ``F.pad`` of a slice for a zero-filled one."""
    if offset == 0:
        return "Tensor.clone", x.clone
    if circular:
        return "torch.roll", lambda: torch.roll(x, offset, -1)
    return "F.pad", lambda: zero_shift(x, offset)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args, dev, rec, gen = setup("probes", argv)
    small = args.small

    # the FMA rate: the script's shape, then one that fills the card; at the
    # script's shape a call is short, so its record also carries the device
    # time alone (one CUDA graph of the calls) and the host time per call
    for i, shape in enumerate(((8, 128), (64, 128)) if small else ((256, 1024), (16384, 4096))):
        for name, dtype in DTYPES.items():
            a = randn(gen, shape, dtype)
            n, es = a.numel(), a.element_size()
            if dtype == torch.float32:  # fmaf against fma in float64 rounded to float32 a step
                tol, rule = (lambda want: 1e-6 * want.abs().max().item()), "1e-6 of the largest |plain output|"
            else:
                tol, rule = 0.0, "exact: one rounding a step both ways"
            kern = lambda: probes.fma_chain(a, INNER)  # noqa: E731
            short = {} if i else {"device_ms": rec.device_ms(kern, 200), "host_us": rec.host_us(kern)}
            rec.kernel(
                {"name": f"fma_chain_{name}_{shape[0]}x{shape[1]}", "kernel": "fma_chain", "shape": list(shape),
                 "dtype": name, "inner": INNER, **short,
                 **bound(2 * n * es + INNER * es, 2 * n * INNER, PEAK_F32 if es == 4 else PEAK_BF16_CC)},
                kern, lambda: probes.fma_chain_plain(a, INNER), tol, rule, 20, 2,
                per_s={"tfma_s": n * INNER / 1e12},
            )
            del a

    # the depthwise stencil against the library's grouped conv
    b, s, c = (1, 6, 32) if small else (8, 112, 32)
    vox = b * s**3
    for name, dtype in DTYPES.items():
        x = randn(gen, (b, s, s, s, c), dtype)
        w = randn(gen, (c, 1, 3, 3, 3), scale=0.3)
        xn, wl = x.permute(0, 4, 1, 2, 3), w.to(dtype)
        if dtype == torch.float32:  # FMA order against the summed magnitudes
            tol = lambda want: 1e-5 * depthwise.depthwise3x3_plain(x.abs(), w.abs()).max().item()  # noqa: E731
            rule = "1e-5 of the largest summed magnitude"
        else:
            tol, rule = bf16_ulps, TWO_ULPS
        with torch.no_grad():
            lib = rec.time_ms(lambda: F.conv3d(xn, wl, padding=1, groups=c), 5)
            rec.kernel(
                {"name": f"dw_stencil_{name}", "kernel": "depthwise3x3", "shape": [b, s, s, s, c], "dtype": name,
                 "library": "F.conv3d(groups=C)", "library_ms": lib,
                 **bound(2 * vox * c * x.element_size() + 27 * c * 4, 54 * vox * c)},
                lambda: depthwise.depthwise3x3(x, w), lambda: depthwise.depthwise3x3_plain(x, w), tol, rule, 5,
                per_s={"tfma_s": 27 * vox * c / 1e12},
            )
        del x, xn

    # data movement: each TPU probe's function, exact against the plain
    # version, beside the one library call that computes it; at this size a
    # call is host work, so each record also carries the host time per call
    rows, lanes = (32, 384) if small else (32, 14592)
    ops = [("E1_copy", 0, False, "bf16"), ("E1_roll5", 5, True, "bf16"), ("E1_slice128", -128, False, "bf16"),
           ("E1_scratch_roll1", 1, True, "bf16"), ("E1b_shift_f32", -1, False, "f32"),
           ("E1b_shift_bf16", -1, False, "bf16")]
    for name, off, circ, dtype in ops:
        a = randn(gen, (rows, lanes), DTYPES[dtype])
        library, lib_fn = shift_library(a, off, circ)
        kern = lambda: probes.lane_shift(a, off, circ)  # noqa: E731
        out = {"name": name, "kernel": "lane_shift", "shape": [rows, lanes], "dtype": dtype,
               "offset": off, "circular": circ, **bound(shift_bytes(a, off, circ)),
               "library": library, "library_ms": rec.time_ms(lib_fn, 200),
               "host_us": rec.host_us(kern), "library_host_us": rec.host_us(lib_fn)}
        rec.kernel(out, kern, lambda: probes.lane_shift_plain(a, off, circ), 0.0, "exact", 200, 20)
    # 1 GiB of bf16: the copy (the card's copy bandwidth) and the roll by 5,
    # whose offset is not a multiple of a 16-byte piece
    n = 4096 if small else 2**29
    big = randn(gen, (n // 4096, 4096), torch.bfloat16)
    dst = torch.empty_like(big)
    moved = 2 * big.numel() * 2
    size = "small" if small else "1GiB"
    for name, off, library, lib_fn in (("copy", 0, "Tensor.copy_", lambda: dst.copy_(big)),
                                       ("roll5", 5, "torch.roll", lambda: torch.roll(big, 5, -1))):
        lib = rec.time_ms(lib_fn, 10)
        rec.kernel(
            {"name": f"{name}_{size}_bf16", "kernel": "lane_shift", "shape": list(big.shape), "dtype": "bf16",
             "offset": off, "circular": off != 0, "library": library, "library_ms": lib,
             "library_GBps": rate(moved, lib) / 1e9, **bound(moved)},
            lambda: probes.lane_shift(big, off, off != 0), lambda: probes.lane_shift_plain(big, off, off != 0),
            0.0, "exact", 10, per_s={"GBps": moved / 1e9},
        )
    del big, dst

    # E2: the tap-matmul conv 32 -> 64, first 32 channels kept
    r = 64
    for name, dtype in DTYPES.items():
        x = randn(gen, (b, s, s, s, c), dtype)
        w = randn(gen, (r, c, 3, 3, 3), scale=0.05)
        wmat = conv3d.kernel_weight(w, dtype)
        xn, wl = x.permute(0, 4, 1, 2, 3), w.to(dtype).contiguous(memory_format=torch.channels_last_3d)
        es = x.element_size()
        if dtype == torch.float32:  # sums in another order: 1e-5 of each output's summed magnitudes
            tol = lambda want: 1e-5 * conv3d.conv3d_3x3_plain(x.abs(), w.abs())[..., :c]  # noqa: E731
            rule = "1e-5 of each output's summed magnitudes"
        else:
            tol, rule = bf16_ulps, TWO_ULPS
        # f32 runs the CUDA-core check path, seconds a launch at this size
        reps = 3 if dtype == torch.bfloat16 else 1
        with torch.no_grad():
            lib = rec.time_ms(lambda: F.conv3d(xn, wl, padding=1), reps, 1)
            rec.kernel(
                {"name": f"E2_{name}", "kernel": "conv3d_3x3", "shape": [b, s, s, s, c], "dtype": name, "cin": c,
                 "cout": r, "kept": c, "library": "F.conv3d (all 64 channels)", "library_ms": lib,
                 **bound(vox * (c + r) * es + 27 * c * r * es, 2 * 27 * vox * c * r, PEAK_BF16_TC if es == 2 else PEAK_F32)},
                lambda: conv3d.conv3d_3x3(x, w, wmat=wmat)[..., :c], lambda: conv3d.conv3d_3x3_plain(x, w)[..., :c],
                tol, rule, reps, 1, per_s={"tmac_s": 27 * r * c * vox / 1e12},
            )
        del x, xn

    # E3: the pointwise conv 32 -> 32
    for name, dtype in DTYPES.items():
        x = randn(gen, (b, s, s, s, c), dtype)
        w = randn(gen, (c, c), dtype, 0.2)
        es = x.element_size()
        moved = 2 * x.numel() * es
        if dtype == torch.float32:  # sums in another order: 1e-6 of each output's summed magnitudes
            tol = lambda want: 1e-6 * fused_mlp.pointwise_plain(x.abs(), w.abs())  # noqa: E731
            rule = "1e-6 of each output's summed magnitudes"
        else:  # both round the f32 sum once
            tol, rule = (lambda want: bf16_ulps(want, 1)), "1 bf16 ulp at the largest |plain output|"
        with torch.no_grad():
            lib = rec.time_ms(lambda: F.linear(x, w), 5)
            rec.kernel(
                {"name": f"E3_pw_{name}", "kernel": "pointwise", "shape": [b, s, s, s, c], "dtype": name, "cout": c,
                 "library": "F.linear", "library_ms": lib, "library_GBps": rate(moved, lib) / 1e9,
                 **bound(moved + c * c * es, 2 * vox * c * c, PEAK_BF16_TC if es == 2 else PEAK_F32)},
                lambda: fused_mlp.pointwise(x, w), lambda: fused_mlp.pointwise_plain(x, w), tol, rule, 5,
                per_s={"GBps": moved / 1e9},
            )
        del x
    rec.save()
    return rec.records


if __name__ == "__main__":
    main(sys.argv[1:])
