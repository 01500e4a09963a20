"""The dense 3^3 conv's weight-gradient kernel on the card: at each 3^3
layer shape of RSUNet training, its planner's plan and every tile it could
take (``xs`` voxels along x by ``r`` rows, one or two buffers) timed, the
data the planner's cost model is checked against.

    python -m pytorch_connectomics_tpu_torch.tools.conv3d_wgrad_plans [--shapes 0,1] [--reps 10]
        [--out-dir outputs]

``SHAPES`` are the layer shapes of the SNEMI recipe (batch 8 of 18 x 160 x
160, widths 28-80 past its 2-D level; 0-7) and of the NucMM-Z recipe (batch
8 of 64^3, widths 28-64, the Cin 1 stem; 8-15), in bf16; ``--shapes``
picks, default all. Tiles are those of ``xs`` 16 to 64 and ``r`` of 1, 2,
4, 8, 16 and 32 rows (and the whole of y) that fit, each with one and two
buffers, through the ``plan`` argument of ``conv3d_3x3_wgrad``; each result
is held against the planner's, relative to its largest value (the partials
follow the tile, so the sums run in another order). Each measurement is one
JSON line and ``<out-dir>/conv3d_wgrad_plans.jsonl``. Needs the card and
``nvcc``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..ops import conv3d as c3
from . import Recorder, time_ms

BATCH = 8
# ((Z, Y, X), Cin, Cout)
SHAPES = [
    ((18, 80, 80), 28, 36), ((18, 80, 80), 36, 36), ((18, 40, 40), 36, 48), ((18, 40, 40), 48, 48),
    ((18, 20, 20), 48, 64), ((18, 20, 20), 64, 64), ((18, 10, 10), 64, 80), ((18, 10, 10), 80, 80),
    ((64, 64, 64), 1, 28), ((64, 64, 64), 28, 28), ((32, 32, 32), 28, 36), ((32, 32, 32), 36, 36),
    ((16, 16, 16), 36, 48), ((16, 16, 16), 48, 48), ((8, 8, 8), 48, 64), ((8, 8, 8), 64, 64),
]


def tiles(spatial) -> List[dict]:
    """Every tile of the sweep for a volume of ``spatial``: x runs of 16 to
    64 voxels and row counts of powers of two up to 32 and the whole of y."""
    _, y, x = spatial
    out = []
    for xs in range(16, min(64, -(-x // 16) * 16) + 1, 16):
        for r in sorted({v for v in (1, 2, 4, 8, 16, 32, y) if v <= y}):
            for buffers in (2, 1):
                out.append(dict(xs=xs, r=r, buffers=buffers))
    return out


def sweep(rec: Recorder, spatial, cin: int, cout: int, dev, reps: int) -> None:
    shape = (BATCH, *spatial, cin)
    rng = np.random.default_rng(cin * 100 + cout)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((BATCH, *spatial, cout), dtype=np.float32)).to(dev, torch.bfloat16)
    ref = c3.conv3d_3x3_wgrad(x, dy)
    top = ref.abs().max().item()
    planner = c3.wgrad_plan(shape, cout, torch.bfloat16)
    rec.emit(dict(name=f"planner_{cin}_{cout}_{spatial[0]}x{spatial[1]}x{spatial[2]}", shape=list(shape), cout=cout,
                  plan=planner, ms=time_ms(lambda: c3.conv3d_3x3_wgrad(x, dy), reps, 2)))
    for tile in tiles(spatial):
        try:
            plan = c3.wgrad_plan(shape, cout, torch.bfloat16, tile)
        except RuntimeError:  # the tile does not fit shared memory
            continue
        got = c3.conv3d_3x3_wgrad(x, dy, plan=tile)
        rec.emit(dict(name=f"tile_{cin}_{cout}_{spatial[0]}x{spatial[1]}x{spatial[2]}", shape=list(shape), cout=cout,
                      plan=plan, rel_diff_to_planner=(got - ref).abs().max().item() / top,
                      ms=time_ms(lambda: c3.conv3d_3x3_wgrad(x, dy, plan=tile), reps, 2)))
    del x, dy, ref


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m pytorch_connectomics_tpu_torch.tools.conv3d_wgrad_plans")
    ap.add_argument("--shapes", default=None, help="comma-separated indices of SHAPES (default all)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out-dir", default="outputs")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    rec = Recorder("conv3d_wgrad_plans", dev, args.out_dir)
    picks = range(len(SHAPES)) if args.shapes is None else [int(i) for i in args.shapes.split(",")]
    for i in picks:
        sweep(rec, *SHAPES[i], dev, args.reps)
    rec.save()


if __name__ == "__main__":
    main()
