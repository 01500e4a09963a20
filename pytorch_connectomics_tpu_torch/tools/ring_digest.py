"""Digests of the slab-ring kernels' outputs at fixed seeded inputs, so that
two trees of the port can be held to bit identity on one card.

    python -m pytorch_connectomics_tpu_torch.tools.ring_digest
    cd <other tree> && PYTHONPATH=. python <this tree>/pytorch_connectomics_tpu_torch/tools/ring_digest.py

Each case runs one kernel through the public wrappers only (so the script
also runs against an older tree of the port: run as a file, it imports the
package that ``PYTHONPATH`` names) on inputs drawn from a seed with numpy,
through the planner's plan: the MedNeXt pair at the fast recipe's stage 1
(batch 16 of (48, 32, 24), C 64, R 128) in bf16 and f32, and the depthwise
kernels at the Lucchi fast recipe's stage 1 (batch 8 of (48, 24, 24), C 64)
in bf16 and f32. It prints one JSON object, case name to the first 16 hex
digits of the SHA-256 of the output's bytes. ``DIGESTS`` holds the digests
of the tree before the ring had x bands (whose plans these shapes keep);
``chip_smoke.py`` holds the port to them. Needs the card and ``nvcc``.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict

import numpy as np
import torch

from pytorch_connectomics_tpu_torch.ops import depthwise as dwk
from pytorch_connectomics_tpu_torch.ops import fused_block as fb

PAIR_SHAPE, PAIR_R = (16, 48, 32, 24, 64), 128
DW_SHAPE = (8, 48, 24, 24, 64)
# the digests of the tree before x bands (NVIDIA H100 80GB HBM3)
DIGESTS: Dict[str, str] = {
    "dw_stats_bf16": "b366f49197bd9eb3", "fused_block_apply_bf16": "410b3f37dedfae92",
    "dw_stats_f32": "9d9013a7bd3c1e1f", "fused_block_apply_f32": "b590e92f9b6873dc",
    "depthwise3x3_bf16": "cc621b9830ab88c9", "depthwise3x3_input_grad_bf16": "ded6fd57e88975b7",
    "depthwise3x3_wgrad_bf16": "97d419cd3cc9acb4", "depthwise3x3_f32": "b2968d9c206353f5",
    "depthwise3x3_input_grad_f32": "3acd79df7052d607", "depthwise3x3_wgrad_f32": "6242ccca4fcf407b",
}


def _digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(dev) -> Dict[str, str]:
    """Case name -> digest of its output on device ``dev``."""
    out = {}
    rng = np.random.default_rng(11)
    c, r = PAIR_SHAPE[-1], PAIR_R

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = t(rng.standard_normal(PAIR_SHAPE))
    p = dict(w_dw=t(rng.standard_normal((c, 1, 3, 3, 3)) * 0.3), gamma=t(1 + 0.1 * rng.standard_normal(c)),
             beta=t(0.1 * rng.standard_normal(c)), w1=t(rng.standard_normal((r, c)) / np.sqrt(c)),
             b1=t(0.1 * rng.standard_normal(r)), w2=t(rng.standard_normal((c, r)) / np.sqrt(r)),
             b2=t(0.1 * rng.standard_normal(c)))
    with torch.inference_mode():
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            xd = x.to(dtype)
            pd = dict(p, w1=p["w1"].to(dtype), w2=p["w2"].to(dtype))
            stats = fb.dw_stats(xd, p["w_dw"])
            out[f"dw_stats_{name}"] = _digest(stats)
            out[f"fused_block_apply_{name}"] = _digest(fb.fused_block_apply(xd, stats, **pd))
        xw, dy = t(rng.standard_normal(DW_SHAPE)), t(rng.standard_normal(DW_SHAPE))
        w, b = t(rng.standard_normal((DW_SHAPE[-1], 1, 3, 3, 3)) * 0.3), t(rng.standard_normal(DW_SHAPE[-1]))
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            xd, dyd = xw.to(dtype), dy.to(dtype)
            out[f"depthwise3x3_{name}"] = _digest(dwk.depthwise3x3(xd, w, b))
            out[f"depthwise3x3_input_grad_{name}"] = _digest(dwk.depthwise3x3_input_grad(dyd, w))
            out[f"depthwise3x3_wgrad_{name}"] = _digest(*dwk.depthwise3x3_wgrad(xd, dyd))
    torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    print(json.dumps(digests(torch.device("cuda"))))
