"""The dense 3^3 conv's weight-gradient kernel on the card: at each 3^3
layer shape of RSUNet training, its planner's plan and the plans of a grid
over the plan's parameters timed, the data the planner's cost model is
fitted to.

    python -m pytorch_connectomics_tpu_torch.tools.conv3d_wgrad_plans [--shapes 0,1] [--reps 10]
        [--tap-groups 1,3] [--m-tiles 1,2,3,4] [--stages 2,3,4] [--out-dir outputs]
    python -m pytorch_connectomics_tpu_torch.tools.conv3d_wgrad_plans --steps [--against TREE]
    python -m pytorch_connectomics_tpu_torch.tools.conv3d_wgrad_plans --fit outputs/conv3d_wgrad_plans.jsonl

``SHAPES`` are the layer shapes of the SNEMI recipe (batch 8 of 18 x 160 x
160, widths 28-80 past its 2-D level; 0-7) and of the NucMM-Z recipe (batch
8 of 64^3, widths 28-64, the Cin 1 stem; 8-15), in bf16; ``--shapes``
picks, default all. The grid: tap groups (3: one dz's taps a row block; 1:
all 27), M tiles a warpgroup (those built for the shape's N), ring stages,
and tiles of ``xs`` 16 to 128 voxels along x by ``r`` of 1, 2, 4, 8, 16 and
32 rows and the whole of y (at most 512 voxels), each forced through the
``plan`` argument of ``conv3d_3x3_wgrad``; a plan that does not fit shared
memory is skipped.
Each result is held against the planner's, relative to its largest value
(the partials follow the plan, so the sums run in another order).

``--steps`` times the planner's plan at every shape instead, beside its
bound and ``torch.nn.grad.conv3d_weight``, and sums each recipe's train step
(each shape times its launches a step: SNEMI's 14, NucMM-Z's 15). With
``--against TREE`` it also times the kernel of the checkout at ``TREE`` (its
package imported beside this one, its kernels built in its own ``build/``),
in turns with this one's: that tree, this, this, that tree; and holds the
two results against each other (relative to the largest value).

Each measurement is one JSON line and ``<out-dir>/conv3d_wgrad_plans.jsonl``.
Needs the card and ``nvcc``; ``--fit`` does not: it fits the planner's cost
constants (``csrc/conv3d_3x3.cu``, ``wgmma_cost``) to a sweep's records and
prints them with each shape's pick against its best.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import itertools
import json
import math
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..ops import conv3d as c3
from . import PEAK_BF16_TC, PEAK_BYTES, Recorder, time_ms

BATCH = 8
# ((Z, Y, X), Cin, Cout)
SHAPES = [
    ((18, 80, 80), 28, 36), ((18, 80, 80), 36, 36), ((18, 40, 40), 36, 48), ((18, 40, 40), 48, 48),
    ((18, 20, 20), 48, 64), ((18, 20, 20), 64, 64), ((18, 10, 10), 64, 80), ((18, 10, 10), 80, 80),
    ((64, 64, 64), 1, 28), ((64, 64, 64), 28, 28), ((32, 32, 32), 28, 36), ((32, 32, 32), 36, 36),
    ((16, 16, 16), 36, 48), ((16, 16, 16), 48, 48), ((8, 8, 8), 48, 64), ((8, 8, 8), 64, 64),
]
# launches of each shape in a train step: SNEMI's 14 (0-7), NucMM-Z's 15 (8-15)
LAUNCHES = [1, 3, 1, 3, 1, 3, 1, 1, 1, 4, 1, 3, 1, 3, 1, 1]


def tiles(spatial) -> List[tuple]:
    """The tiles of the grid for a volume of ``spatial``: x runs of 16 to 128
    voxels by row counts of powers of two up to 32 and the whole of y, at
    most 512 voxels."""
    _, y, x = spatial
    rows = sorted({v for v in (1, 2, 4, 8, 16, 32, y) if v <= y})
    return [(xs, r) for xs in range(16, min(128, -(-x // 16) * 16) + 1, 16) for r in rows if xs * r <= 512]


def sweep(rec: Recorder, spatial, cin: int, cout: int, dev, reps: int, groups, m_tiles, stages) -> None:
    shape = (BATCH, *spatial, cin)
    rng = np.random.default_rng(cin * 100 + cout)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((BATCH, *spatial, cout), dtype=np.float32)).to(dev, torch.bfloat16)
    ref = c3.conv3d_3x3_wgrad(x, dy)
    top = ref.abs().max().item()
    planner = c3.wgrad_plan(shape, cout, torch.bfloat16)
    name = f"{cin}_{cout}_{spatial[0]}x{spatial[1]}x{spatial[2]}"
    rec.emit(dict(name=f"planner_{name}", shape=list(shape), cout=cout, plan=planner,
                  ms=time_ms(lambda: c3.conv3d_3x3_wgrad(x, dy), reps, 2)))
    mts = [m for m in m_tiles if m <= (1 if cin < 8 else c3.wgrad_max_m_tiles(planner["n"]))]
    for tg, mt, st, (xs, r) in itertools.product(groups, mts, stages, tiles(spatial)):
        force = dict(xs=xs, r=r, stages=st, m_tiles=mt, tap_groups=tg)
        try:
            plan = c3.wgrad_plan(shape, cout, torch.bfloat16, force)
        except RuntimeError:  # the ring does not fit shared memory
            continue
        got = c3.conv3d_3x3_wgrad(x, dy, plan=force)
        rec.emit(dict(name=f"plan_{name}", shape=list(shape), cout=cout, plan=plan,
                      rel_diff_to_planner=(got - ref).abs().max().item() / top,
                      ms=time_ms(lambda: c3.conv3d_3x3_wgrad(x, dy, plan=force), reps, 2)))
    del x, dy, ref


def port_of(tree: str):
    """The ``ops.conv3d`` module of the checkout at ``tree``, imported beside
    this one under another package name."""
    pkg = Path(tree).resolve() / "pytorch_connectomics_tpu_torch"
    spec = importlib.util.spec_from_file_location("against_port", pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["against_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("against_port.ops.conv3d")


def steps(rec: Recorder, dev, reps: int, against: Optional[str]) -> None:
    """Each shape's planner plan timed (and the other tree's kernel in turns),
    then each recipe's step totals: every time the mean of its readings
    times the shape's launches a step."""
    other = port_of(against) if against else None
    totals = {}
    for i, (spatial, cin, cout) in enumerate(SHAPES):
        shape = (BATCH, *spatial, cin)
        rng = np.random.default_rng(cin * 100 + cout)
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
        dy = torch.from_numpy(rng.standard_normal((BATCH, *spatial, cout), dtype=np.float32)).to(dev, torch.bfloat16)
        n = BATCH * math.prod(spatial)
        bound = max((n * (cin + cout) * 2 + 27 * cin * cout * 4) / PEAK_BYTES, 54 * n * cin * cout / PEAK_BF16_TC) * 1e3
        xn, dyn = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        row = dict(name=f"step_{cin}_{cout}_{spatial[0]}x{spatial[1]}x{spatial[2]}", shape=list(shape), cout=cout,
                   recipe="snemi" if i < 8 else "nucmm", launches=LAUNCHES[i],
                   plan=c3.wgrad_plan(shape, cout, torch.bfloat16), bound_ms=bound,
                   library_ms=time_ms(lambda: torch.nn.grad.conv3d_weight(xn, (cout, cin, 3, 3, 3), dyn, padding=1),
                                      reps, 2))
        this = lambda: c3.conv3d_3x3_wgrad(x, dy)  # noqa: E731
        if other is None:
            row["ms"] = [time_ms(this, reps, 2)]
        else:
            that = lambda: other.conv3d_3x3_wgrad(x, dy)  # noqa: E731
            t = [time_ms(f, reps, 2) for f in (that, this, this, that)]
            row.update(ms=t[1:3], against_ms=[t[0], t[3]])
            got, ref = this(), that()
            row["rel_diff_to_against"] = (got - ref).abs().max().item() / ref.abs().max().item()
        rec.emit(row)
        tot = totals.setdefault(row["recipe"], dict(ms=0.0, bound_ms=0.0, library_ms=0.0, against_ms=0.0))
        for k in tot:
            if k in row:
                v = row[k]
                tot[k] += (sum(v) / len(v) if isinstance(v, list) else v) * row["launches"]
        del x, dy
    for recipe, tot in totals.items():
        if other is None:
            tot.pop("against_ms")
        rec.emit(dict(name=f"step_total_{recipe}", launches=sum(LAUNCHES[:8] if recipe == "snemi" else LAUNCHES[8:]),
                      **tot))


# the planner's cost constants as the source has them (kWgStepClk,
# kWgStepLat, kWgBytesClk, kWgTwoStages, kWgVisitClk), the fit's start; the
# clock that turns its clocks into ms; the SMs it spreads items over
COST = (0.417, 97.6, 13.1, 0.036, 4989.0)
CLOCK_HZ = 1.755e9
SMS = 132


def model_ms(c, rec) -> float:
    """``wgmma_cost`` of the record's plan in ms, with constants ``c``."""
    step, lat, bpc, two, visit_clk = c
    (b, z, _, _, cin), cout, p = rec["shape"], rec["cout"], rec["plan"]
    zs = 1 if p["tap_groups"] == 3 else 3
    width = max(p["n"], 32 + p["n"] / 2)
    cons = p["r"] * p["xs"] / 16 * (step * p["m_tiles"] * width + lat)
    prod = (2 * zs * (p["r"] + 2) * (p["xs"] + 2) * cin + 2 * p["r"] * p["xs"] * min(cout, p["n"])) / bpc
    visit = max(cons, prod) + (two * min(cons, prod) if p["stages"] < 3 else 0) + visit_clk
    tiles = b * z * -(-rec["shape"][2] // p["r"]) * -(-rec["shape"][3] // p["xs"])
    groups = 3 - 2 / z if zs == 1 else 1
    waves = math.ceil(p["items"] / SMS) / (p["items"] / SMS)
    return tiles * groups * p["row_groups"] * p["slices"] * visit * waves / SMS / CLOCK_HZ * 1e3


def fit(paths: List[str]) -> dict:
    """The cost constants fitted to the records of ``paths``: least squares
    of the log time (Nelder-Mead, from ``COST``) over the plans within twice
    their shape's best."""
    from scipy.optimize import minimize

    recs = [json.loads(line) for p in paths for line in Path(p).read_text().splitlines()]
    recs = [r for r in recs if r["name"].startswith(("plan_", "planner_"))]
    best = {}
    for r in recs:
        key = r["name"].split("_", 1)[1]
        best[key] = min(best.get(key, math.inf), r["ms"])
    near = [r for r in recs if r["ms"] <= 2 * best[r["name"].split("_", 1)[1]]]
    t = np.array([r["ms"] for r in near])

    def loss(c):
        return np.inf if min(c) < 0 else float(np.mean(np.log(np.array([model_ms(c, r) for r in near]) / t) ** 2))

    c = minimize(loss, COST, method="Nelder-Mead", options=dict(maxiter=4000, xatol=1e-3, fatol=1e-7)).x
    picks = {}
    for key in best:
        rs = [r for r in recs if r["name"].split("_", 1)[1] == key]
        pick = min(rs, key=lambda r: model_ms(c, r))
        picks[key] = dict(pick_ms=pick["ms"], best_ms=best[key],
                          pick={k: pick["plan"][k] for k in ("xs", "r", "stages", "m_tiles", "tap_groups")})
    return dict(constants=[float(v) for v in c], rms_log_err=math.sqrt(loss(c)), picks=picks)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m pytorch_connectomics_tpu_torch.tools.conv3d_wgrad_plans")
    ap.add_argument("--shapes", default=None, help="comma-separated indices of SHAPES (default all)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tap-groups", default="1,3", help="tap groups of the grid")
    ap.add_argument("--m-tiles", default="1,2,3,4", help="M tiles a warpgroup of the grid (those built for N)")
    ap.add_argument("--stages", default="2,3,4", help="ring stages of the grid")
    ap.add_argument("--steps", action="store_true", help="time the planner's plan a train step instead of a grid")
    ap.add_argument("--against", default=None, help="with --steps: another checkout whose kernel to time in turns")
    ap.add_argument("--fit", nargs="+", default=None, help="sweep records to fit the planner's cost constants to")
    ap.add_argument("--out-dir", default="outputs")
    args = ap.parse_args(argv)
    if args.fit:
        print(json.dumps(fit(args.fit), indent=1))
        return
    dev = torch.device("cuda")
    rec = Recorder("conv3d_wgrad_plans", dev, args.out_dir)
    if args.steps:
        steps(rec, dev, args.reps, args.against)
        rec.save()
        return
    picks = range(len(SHAPES)) if args.shapes is None else [int(i) for i in args.shapes.split(",")]
    ints = [[int(v) for v in a.split(",")] for a in (args.tap_groups, args.m_tiles, args.stages)]
    for i in picks:
        sweep(rec, *SHAPES[i], dev, args.reps, *ints)
    rec.save()


if __name__ == "__main__":
    main()
