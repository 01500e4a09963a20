"""The training path's depthwise kernels on the card: the host work a call
of ``depthwise3x3`` and ``depthwise3x3_wgrad`` and (``--sweep N``) each
kernel's N best plans by ``depthwise.plans`` timed, the data the planner's
constants are fitted to.

    python -m pytorch_connectomics_tpu_torch.tools.depthwise_plans [--sweep N] [--shapes 0,5] [--reps 20]
        [--out-dir outputs]

The host work a call (``tools.host_us``: 200 calls with no synchronisation,
fewer than the launch queue holds) is taken at (1, 4, 4, 8, 32) bf16
through the public wrappers only, so the same measurement also runs
against an older ``ops/depthwise.py``. With ``--sweep N`` each shape of
``SHAPES`` (0-4 the synthetic recipe's stride-1 training stages, 5-9 the
Lucchi fast recipe's, both at batch ``depthwise.TRAIN_BATCH``; 10 the probe
scripts' (8, 112^3, 32); ``--shapes`` picks, default all) times, in both
dtypes, each kernel's planner-best plan of every count of work items and
ring size through the ``plan`` argument of ``run_fwd`` and ``run_wgrad``.
The forward's output is compared bit for bit with the planner's plan's;
the weight gradient's, whose partials follow the plan, relative to its
largest value. Each measurement is one JSON line and
``<out-dir>/depthwise_plans.jsonl``. Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import depthwise as dwk
from . import Recorder, host_us, time_ms
from .block_phases import varied

# ((Z, Y, X), C): the training stages of both recipes, then the probe
# scripts' 112^3 at C 32 (row 7a of PERF.md)
SHAPES = [(s, c) for stages in dwk.TRAIN_STAGES.values() for s, c, _ in stages] + [((112, 112, 112), 32)]


def inputs(shape, dev):
    """x, dy of ``shape`` and the taps and bias, f32, from a seed."""
    rng = np.random.default_rng(shape[-1])
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((c, 1, 3, 3, 3)) * 0.3).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dev)
    return x, dy, w, b


def sweep(rec: Recorder, spatial, c: int, dev, n: int, reps: int) -> None:
    """Time ``n`` plans of each kernel (the planner's best of each count of
    work items and ring size, so that the sweep sees launches of every
    parallelism) at one shape, bf16 and f32."""
    shape = (dwk.TRAIN_BATCH, *spatial, c)
    x, dy, w, b = inputs(shape, dev)
    for dtype in (torch.bfloat16, torch.float32):
        xd, dyd = x.to(dtype), dy.to(dtype)
        ref, (rw, rb) = dwk.run_fwd(xd, w, b), dwk.run_wgrad(xd, dyd)
        top = max(rw.abs().max().item(), rb.abs().max().item())
        for kind, name in enumerate(dwk.KERNEL_NAMES):
            for i, plan in enumerate(varied(dwk.plans(kind, shape, dtype), ("items", "ring"), n)):
                if kind == 0:
                    fn = lambda: dwk.run_fwd(xd, w, b, plan=plan)  # noqa: E731
                    check = dict(same_as_planner=bool(torch.equal(fn(), ref)))
                else:
                    fn = lambda: dwk.run_wgrad(xd, dyd, plan=plan)  # noqa: E731
                    gw, gb = fn()
                    diff = max((gw - rw).abs().max().item(), (gb - rb).abs().max().item())
                    check = dict(rel_diff_to_planner=diff / top)
                ms = time_ms(fn, reps, 2)
                rec.emit(dict(name=f"sweep_{name}_c{c}_{spatial[0]}_{str(dtype)[6:]}_{i}", kernel=name, C=c,
                              shape=list(shape), dtype=str(dtype)[6:],
                              plan={k: plan[k] for k in ("ty", "seg", "ring", "items", "smem_bytes", "est_clk")},
                              **check, ms=ms))
        del xd, dyd, ref, rw, rb


def host(rec: Recorder, dev) -> None:
    """Host work a call of both wrappers at (1, 4, 4, 8, 32) bf16."""
    x, dy, w, b = (t.to(torch.bfloat16) if t.dim() == 5 else t for t in inputs((1, 4, 4, 8, 32), dev))
    for kname, fn in (("depthwise3x3", lambda: dwk.depthwise3x3(x, w, b)),
                      ("depthwise3x3_wgrad", lambda: dwk.depthwise3x3_wgrad(x, dy))):
        rec.emit(dict(name=f"host_{kname}", kernel=kname, shape=list(x.shape), dtype="bfloat16",
                      host_us=host_us(fn, 200, dev), ms=time_ms(fn, 200, 5)))


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(prog="python -m pytorch_connectomics_tpu_torch.tools.depthwise_plans")
    ap.add_argument("--sweep", type=int, default=0, help="time each shape's N best plans of each kernel")
    ap.add_argument("--shapes", default=None, help=f"indices into SHAPES to sweep (0-{len(SHAPES) - 1}, default all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out-dir", default="outputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("depthwise_plans measures the card: no CUDA device")
    dev = torch.device("cuda")
    rec = Recorder("depthwise_plans", dev, args.out_dir)
    picks = range(len(SHAPES)) if args.shapes is None else [int(i) for i in args.shapes.split(",")]
    with torch.inference_mode():
        for spatial, c in [SHAPES[i] for i in picks] if args.sweep else ():
            sweep(rec, spatial, c, dev, args.sweep, args.reps)
        host(rec, dev)
    rec.save()
    return rec.records


if __name__ == "__main__":
    main()
