"""Device-only times of the slab-ring kernels at fixed seeded inputs, so
that two trees of the port can be compared on one card in one call.

    python -m pytorch_connectomics_tpu_torch.tools.ring_times
    cd <other tree> && PYTHONPATH=. python <this tree>/pytorch_connectomics_tpu_torch/tools/ring_times.py

Like ``ring_digest.py``, each case runs one kernel through the public
wrappers only (so the script also runs against an older tree of the port:
run as a file, it imports the package that ``PYTHONPATH`` names), through
the planner's plan, on inputs drawn from a seed with numpy: the MedNeXt pair
at the fast recipe's stages 0 (batch 16 of (96, 64, 48), C 32, R 64) and 1
(batch 16 of (48, 32, 24), C 64, R 128) in bf16 and at stage 1 (batch 2) in
f32, and the depthwise forward and weight gradient in bf16 at batch 8 of
(64, 96, 96), C 32. Each time is ``tools.device_ms`` of 20 calls in one
CUDA graph. It prints one JSON object, case name to milliseconds. Run the
two trees in turns (A B B A) and read a difference against A's own spread.
Needs the card and ``nvcc``.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from pytorch_connectomics_tpu_torch.ops import depthwise as dwk
from pytorch_connectomics_tpu_torch.ops import fused_block as fb
from pytorch_connectomics_tpu_torch.tools import device_ms

PAIR_CASES = (("pair_s0_bf16", (16, 96, 64, 48, 32), 64, torch.bfloat16),
              ("pair_s1_bf16", (16, 48, 32, 24, 64), 128, torch.bfloat16),
              ("pair_s1_f32", (2, 48, 32, 24, 64), 128, torch.float32))
DW_SHAPE = (8, 64, 96, 96, 32)
REPS = 20


def times(dev) -> Dict[str, float]:
    """Case name -> device-only ms a call on device ``dev``."""
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev, dtype)

    out = {}
    with torch.inference_mode():
        for name, shape, r, dtype in PAIR_CASES:
            c = shape[-1]
            x = t(rng.standard_normal(shape), dtype)
            w = t(rng.standard_normal((c, 1, 3, 3, 3)) * 0.2)
            g, b = t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c))
            w1, b1 = t(rng.standard_normal((r, c)) * 0.1, dtype), t(0.1 * rng.standard_normal(r))
            w2, b2 = t(rng.standard_normal((c, r)) * 0.1, dtype), t(0.1 * rng.standard_normal(c))
            stats = fb.dw_stats(x, w)
            out[f"{name}_dw_stats"] = device_ms(lambda: fb.dw_stats(x, w), reps=REPS)
            out[f"{name}_apply"] = device_ms(lambda: fb.fused_block_apply(x, stats, w, g, b, w1, b1, w2, b2),
                                             reps=REPS)
        x = t(rng.standard_normal(DW_SHAPE), torch.bfloat16)
        w = t(rng.standard_normal((DW_SHAPE[-1], 1, 3, 3, 3)) * 0.2)
        out["dw_fwd_bf16"] = device_ms(lambda: dwk.depthwise3x3(x, w), reps=REPS)
        dy = dwk.depthwise3x3(x, w)
        out["dw_wgrad_bf16"] = device_ms(lambda: dwk.depthwise3x3_wgrad(x, dy), reps=REPS)
    return out


if __name__ == "__main__":
    print(json.dumps({k: round(v, 5) for k, v in times(torch.device("cuda")).items()}))
