"""Digests of the dense 3^3 conv kernel's forward outputs at fixed seeded
inputs, and the wrapper's host time a call, so that two trees of the port
can be held to bit identity and compared on one card.

    python -m pytorch_connectomics_tpu_torch.tools.conv3d_digest [--host]
    cd <other tree> && PYTHONPATH=. python <this tree>/pytorch_connectomics_tpu_torch/tools/conv3d_digest.py [--host]

Each case runs ``conv3d_3x3`` through its public signature only (so the
script also runs against an older tree of the port: run as a file, it
imports the package that ``PYTHONPATH`` names) on inputs drawn from a seed
with numpy, at one batch element of every 3^3 layer shape of RSUNet on the
SNEMI recipe (18 x 160 x 160 windows, (1, 2, 2) down factors, widths 36-80
past the 2-D level) and on the NucMM-Z recipe (64^3, widths 28-64, the Cin
1 stem), in bf16 and f32, with the weight matrix passed as the model passes
it. It prints one JSON object: ``digests``, case name to the first 16 hex
digits of the SHA-256 of the output's bytes, and with ``--host``
``host_us``, the wrapper's host microseconds a call (``tools.host_us``: 1000
calls without synchronising, then one) at each bf16 case of at most 8,000
voxels, where the device keeps pace with the host. ``DIGESTS`` holds
the digests of the tree before the wrapper took the shared launch path;
``tests/test_torch_kernels_cuda.py`` holds the port to them. Needs the card
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Dict

import numpy as np
import torch

from pytorch_connectomics_tpu_torch.ops import conv3d as c3

# (name, (Z, Y, X), Cin, Cout) at batch 1
CASES = [
    ("snemi_l1_28_36", (18, 80, 80), 28, 36), ("snemi_l1_36_36", (18, 80, 80), 36, 36),
    ("snemi_l2_36_48", (18, 40, 40), 36, 48), ("snemi_l2_48_48", (18, 40, 40), 48, 48),
    ("snemi_l3_48_64", (18, 20, 20), 48, 64), ("snemi_l3_64_64", (18, 20, 20), 64, 64),
    ("snemi_l4_64_80", (18, 10, 10), 64, 80), ("snemi_l4_80_80", (18, 10, 10), 80, 80),
    ("nucmm_stem_1_28", (64, 64, 64), 1, 28), ("nucmm_l0_28_28", (64, 64, 64), 28, 28),
    ("nucmm_l1_28_36", (32, 32, 32), 28, 36), ("nucmm_l3_48_64", (8, 8, 8), 48, 64),
]
# the digests of the tree before the shared launch path (NVIDIA H100 80GB HBM3)
DIGESTS: Dict[str, str] = {
    "snemi_l1_28_36_bf16": "70f0c9b754ba337d", "snemi_l1_28_36_f32": "47342d78d93fefc5",
    "snemi_l1_36_36_bf16": "f2b645c1fe9c80af", "snemi_l1_36_36_f32": "2f25971002861dd2",
    "snemi_l2_36_48_bf16": "79ffadd36427ef8b", "snemi_l2_36_48_f32": "b0919e8bc1e44e8e",
    "snemi_l2_48_48_bf16": "a98667f7afb762b4", "snemi_l2_48_48_f32": "9086015a21fe8f6e",
    "snemi_l3_48_64_bf16": "850a38dce9d36a6f", "snemi_l3_48_64_f32": "36adae672df518f4",
    "snemi_l3_64_64_bf16": "bb3aa11006ede95f", "snemi_l3_64_64_f32": "acbfbf4cb936ab8b",
    "snemi_l4_64_80_bf16": "679310c620ce365f", "snemi_l4_64_80_f32": "39f3d7244d67908f",
    "snemi_l4_80_80_bf16": "286e02c68a794ea8", "snemi_l4_80_80_f32": "2aa5b7ef1518593b",
    "nucmm_stem_1_28_bf16": "1ad75258d9445a77", "nucmm_stem_1_28_f32": "c7320bb0467be6ff",
    "nucmm_l0_28_28_bf16": "5712641283bb4b1f", "nucmm_l0_28_28_f32": "d9a76ea61242c85f",
    "nucmm_l1_28_36_bf16": "9671cacbf9534a52", "nucmm_l1_28_36_f32": "b787c8d2c3c9d31c",
    "nucmm_l3_48_64_bf16": "dec60c3a72016e88", "nucmm_l3_48_64_f32": "5b90faf49d5b691e",
}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def _host_us(fn, n: int = 1000) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def run(dev, host: bool = False) -> Dict[str, Dict[str, float]]:
    """``{"digests": {case: digest}}``, and with ``host`` ``"host_us"``."""
    out: Dict[str, Dict] = {"digests": {}}
    if host:
        out["host_us"] = {}
    rng = np.random.default_rng(13)
    with torch.inference_mode():
        for name, spatial, cin, cout in CASES:
            x = torch.from_numpy(rng.standard_normal((1, *spatial, cin), dtype=np.float32)).to(dev)
            w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32))
            b = torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32))
            w, b = w.to(dev), b.to(dev)
            for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                xd, wmat = x.to(dtype), c3.kernel_weight(w, dtype)
                out["digests"][f"{name}_{tag}"] = _digest(c3.conv3d_3x3(xd, w, b, wmat=wmat))
                if host and dtype == torch.bfloat16 and np.prod(spatial) <= 8000:
                    out["host_us"][name] = _host_us(lambda: c3.conv3d_3x3(xd, w, b, wmat=wmat))
    torch.cuda.synchronize()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", action="store_true", help="also time the wrapper's host microseconds a call")
    args = ap.parse_args(argv)
    print(json.dumps(run(torch.device("cuda"), args.host)))


if __name__ == "__main__":
    main()
