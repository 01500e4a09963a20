"""Op-level micro-benchmarks of the MedNeXt hot path on the card, the
counterpart of ``scripts/tpu_microbench.py``, section by section:

1. ``matmul_8192_bf16``: one 8192^2 bf16 product (``torch.matmul``; the JAX
   script leaves it to XLA), TFLOP/s: the tensor cores' health.
2. ``dw3_<s>c<c>``: the depthwise 3^3 conv at MedNeXt-S's five stage shapes
   (batch 8 of 112^3 .. 7^3) through the port's kernel ``depthwise3x3``,
   with ``F.conv3d(groups=C)`` timed beside it as the library yardstick.
3. ``pw_pair_112c32``: the pointwise pair 32 -> 64 -> 32 at stage 0 as
   ``torch.matmul`` + tanh-GELU, as XLA runs it in the script; then
   ``fused_mlp_112c32``: the same products with biases and the residual in
   the port's fused kernel ``fused_mlp_residual``, beside the unfused cuBLAS
   sequence, each also timed on the device alone (one CUDA graph).
4. ``gn_112c32``: the per-channel GroupNorm at stage 0.
5. ``mednext_s_fwd_b8``: the port's MedNeXt-S (stock stem, bf16) forward at
   batch 8 of 112^3, and its rate in Mvox/s.
6. ``vpu_fma27_bf16``: 27 FMAs a value over (896, 128, 3584) bf16 through
   the port's kernel ``fma27``, FLOP and bytes counted as the script counts
   them.

The records of the port's kernels hold each output against its plain
version and carry its bound (see :mod:`..tools`).

Run: ``python -m pytorch_connectomics_tpu_torch.tools.microbench [--device
cpu] [--small] [--out-dir DIR]``; see :mod:`..tools`.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..config.schema import ModelConfig, build_dataclass
from ..models import build_model
from ..ops import depthwise, fused_mlp, probes
from . import PEAK_BF16_TC, bf16_ulps, bound, randn, rate, setup

# (batch, spatial edge, channels) of MedNeXt-S's stages on 112^3 input
STAGES = [(8, 112, 32), (8, 56, 64), (8, 28, 128), (8, 14, 256), (8, 7, 512)]
SMALL_STAGES = [(1, 8, 32), (1, 4, 64), (1, 4, 128), (1, 2, 256), (1, 2, 512)]
TWO_ULPS = "2 bf16 ulps at the largest |plain output|"


def mlp_bound(m: int, c: int, e: int, es: int) -> dict:
    """``bound`` of one fused MLP launch on m rows of element size es: x
    read and the output written once, both weights once, the biases in f32;
    the two products (4 m C E FLOP) on the bf16 tensor cores or, in f32,
    with the GELU (10 FLOP a hidden value) on the CUDA cores."""
    moved = 2 * m * c * es + 2 * c * e * es + (c + e) * 4
    mlp, gelu = 4 * m * c * e, 10 * m * e
    if es == 4:
        return bound(moved, mlp + gelu)
    return max(bound(moved, gelu), bound(moved, mlp, PEAK_BF16_TC), key=lambda b: b["bound_parts"]["ops"])


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args, dev, rec, gen = setup("microbench", argv)
    small = args.small

    # 1. tensor-core health
    n = 256 if small else 8192
    a = randn(gen, (n, n), torch.bfloat16)
    ms = rec.time_ms(lambda: a @ a)
    rec.emit({"name": f"matmul_{n}_bf16", "ms": ms, "tflops": rate(2 * n**3, ms) / 1e12})
    del a

    # 2. depthwise 3^3 at every stage shape
    for b, s, c in SMALL_STAGES if small else STAGES:
        x = randn(gen, (b, s, s, s, c), torch.bfloat16)
        w = randn(gen, (c, 1, 3, 3, 3), scale=0.3)
        xn, wl = x.permute(0, 4, 1, 2, 3), w.to(torch.bfloat16)
        vox = b * s**3
        reps = 10 if vox * c > 1e7 else 30
        with torch.no_grad():
            lib = rec.time_ms(lambda: F.conv3d(xn, wl, padding=1, groups=c), reps)
            rec.kernel(
                {"name": f"dw3_{s}c{c}", "kernel": "depthwise3x3", "shape": [b, s, s, s, c], "dtype": "bf16",
                 "library": "F.conv3d(groups=C)", "library_ms": lib, **bound(2 * vox * c * 2 + 27 * c * 4, 54 * vox * c)},
                lambda: depthwise.depthwise3x3(x, w), lambda: depthwise.depthwise3x3_plain(x, w), bf16_ulps, TWO_ULPS,
                reps, per_s={"tflops": vox * c * 27 * 2 / 1e12, "GBps": vox * c * 2 * 2 / 1e9},
            )
        del x, xn

    # 3. the pointwise pair at stage 0, then the fused kernel on the same widths
    b, s, c = SMALL_STAGES[0] if small else STAGES[0]
    r = 2 * c
    vox = b * s**3
    x = randn(gen, (b, s, s, s, c), torch.bfloat16)
    w1 = randn(gen, (c, r), torch.bfloat16, 1 / math.sqrt(c))
    w2 = randn(gen, (r, c), torch.bfloat16, 1 / math.sqrt(r))
    b1, b2 = randn(gen, (r,), scale=0.1), randn(gen, (c,), scale=0.1)

    def pair():
        h = F.gelu(x.reshape(vox, c) @ w1, approximate="tanh")
        return (h @ w2).reshape(x.shape)

    flops = vox * (c * r * 2) * 2
    with torch.no_grad():
        ms = rec.time_ms(pair, 5)
        rec.emit({"name": f"pw_pair_{s}c{c}", "ms": ms, "tflops": rate(flops, ms) / 1e12,
                  "GBps": rate(vox * c * 2 * 2, ms) / 1e9})
        b1d, b2d, xm = b1.to(x.dtype), b2.to(x.dtype), x.reshape(vox, c)

        def unfused():  # the cuBLAS sequence: addmm, gelu, addmm, add
            return xm + torch.addmm(b2d, F.gelu(torch.addmm(b1d, xm, w1), approximate="tanh"), w2)

        fused = lambda: fused_mlp.fused_mlp_residual_ndhwc(x, w1, b1, w2, b2)  # noqa: E731
        rec.kernel(
            {"name": f"fused_mlp_{s}c{c}", "kernel": "fused_mlp_residual", "rows": vox, "C": c, "E": r,
             "dtype": "bf16", "unfused_library": "addmm, gelu, addmm, add",
             "unfused_library_ms": rec.time_ms(unfused, 5), "unfused_library_device_ms": rec.device_ms(unfused, 5),
             "device_ms": rec.device_ms(fused, 5), **mlp_bound(vox, c, r, 2)},
            fused,
            lambda: fused_mlp.fused_mlp_residual_plain(xm, w1, b1, w2, b2).reshape(x.shape), bf16_ulps, TWO_ULPS, 5,
            per_s={"tflops": flops / 1e12, "GBps": vox * c * 2 * 2 / 1e9},
        )

    # 4. per-channel GroupNorm at stage 0 (f32 statistics, output in x's dtype)
    g, beta = torch.ones(c, device=dev), torch.zeros(c, device=dev)

    def gn():
        xf = x.float()
        var, mu = torch.var_mean(xf, dim=(1, 2, 3), keepdim=True, correction=0)
        return ((xf - mu) * torch.rsqrt(var + 1e-6) * g + beta).to(x.dtype)

    ms = rec.time_ms(gn, 5)
    rec.emit({"name": f"gn_{s}c{c}", "ms": ms, "GBps": rate(vox * c * 2 * 2, ms) / 1e9})
    del x

    # 5. the MedNeXt-S forward
    edge, batch = (16, 1) if small else (112, 8)
    cfg = build_dataclass(ModelConfig, {
        "arch": {"type": "mednext"}, "in_channels": 1, "out_channels": 1, "input_size": [edge] * 3,
        "mednext": {"size": "S", "kernel_size": 3}, "compute_dtype": "bfloat16",
    })
    model = build_model(cfg, device=dev, seed=0)
    xin = randn(gen, (batch, edge, edge, edge, 1))
    with torch.inference_mode():
        ms = rec.time_ms(lambda: model(xin), 3, 1)
    rec.emit({"name": f"mednext_s_fwd_b{batch}", "ms": ms, "mvox_s": rate(batch * edge**3, ms) / 1e6})
    del model, xin

    # 6. the FMA-rate probe: 27 taps a value
    nblk, yy, xc = (2, 8, 128) if small else (8 * 112, 128, 3584)
    xb = randn(gen, (nblk, yy, xc), torch.bfloat16)
    wts = randn(gen, (27,), scale=0.2)
    vals = nblk * yy * xc
    rec.kernel(
        {"name": "vpu_fma27_bf16", "kernel": "fma27", "shape": [nblk, yy, xc], "dtype": "bf16",
         **bound(vals * 2 * 2 + 27 * 4, vals * 27 * 2)},
        lambda: probes.fma27(xb, wts), lambda: probes.fma27_plain(xb, wts), 0.0,
        "exact: both round one f32 sum in tap order", 10, 2,
        per_s={"tflops": vals * 27 * 2 / 1e12, "GBps": vals * 2 * 2 / 1e9},
    )
    rec.save()
    return rec.records


if __name__ == "__main__":
    main(sys.argv[1:])
