"""Where a kernel spends its time: the kernel timed whole and cut short
after each of its phases, the host work per call of its wrappers, and
(``--sweep N``) the planner's N best plans timed on the card.

    python -m pytorch_connectomics_tpu_torch.tools.block_phases [--source mednext_block.cu|fused_mlp.cu]
        [--cut NAME=TEXT[+N][@STMT][;;TEXT...] ...] [--guard EXPR] [--stages 0,1] [--sweep N] [--no-cuts]
        [--out-dir outputs]

For each cut the tool copies the source (``ops/csrc/<source>``, default the
MedNeXt block pair's ``mednext_block.cu``) and its headers into
``build/block_phases/<name>/``, inserts ``if (EXPR) STMT;`` (``return`` by
default) after the first line of the source that holds TEXT (or N lines
below it; ``;;`` separates several insertions of one cut), builds the copy
with the port's ``nvcc`` flags (all copies at once), loads it in place of
the port's library and times the kernel through its wrapper: for the pair
``fused_block_apply`` at the fast recipe's stage shapes (batch 16, bf16),
for ``fused_mlp.cu`` ``fused_mlp_residual`` at MedNeXt-S's five widths on
the same recipe's batch-16 row counts (bf16). The guard (default ``eps >
0.f`` for the pair, ``g.M > 0`` for the fused MLP, each a kernel argument)
is true at run time but unknown to the compiler, so everything before the
cut is compiled and run as in the whole kernel. The default cuts are the
source's own ``// phase: <name> [statement]`` markers (a marker inside a
loop says ``continue``). A cut build is a measurement only: its output is
not the kernel's.

Then, with the port's own library, the host work of one call of each
wrapper (``tools.host_us``: 200 calls with no synchronisation, fewer than
the launch queue holds) at a small shape, and for the fused MLP the device
time alone (``tools.device_ms``) of the whole kernel at each width; for
the pair with ``--sweep N``, each stage's N best plans by the
planner's cost model of differing band heights, segments, rings, unit
widths and weight chunks (``fused_block.stats_plans``, ``apply_plans``) timed
through the wrappers' ``plan`` argument, each output compared with the
planner's own plan's (bit for bit: a plan moves work between blocks, not
the arithmetic of an output); for the fused MLP with ``--sweep N``, N plans
of each width (``fused_mlp.plans``), held against the plain version. Each
measurement is one JSON line, as in the other tools, and
``<out-dir>/block_phases.jsonl``; the compiler's register and spill report
of each build goes to standard output. Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import build, fused_block as fb, fused_mlp as fm
from . import Recorder, device_ms, host_us, time_ms

# (C, R, (Z, Y, X)) of the stride-1 MedNeXt-S stages on the fast recipe's
# (96, 128, 96) window after the (1, 2, 2) stem, as chip_smoke.py
STAGES = [(32, 64, (96, 64, 48)), (64, 128, (48, 32, 24)), (128, 256, (24, 16, 12)), (256, 512, (12, 8, 6)),
          (512, 1024, (6, 4, 3))]
BATCH = 16
WORK = build.BUILD_DIR.parent / "block_phases"


def marker_cuts(src: str) -> Dict[str, str]:
    """The ``// phase: <name> [statement]`` markers of a source, in order, as
    cuts (the marker's text, then ``@statement``)."""
    return {m.group(1): m.group(0) + "@" + (m.group(2) or "return")
            for m in re.finditer(r"// phase: (\w+)(?: (\w+))?", src)}


def cut_source(src: str, text: str, guard: str) -> str:
    """``src`` with ``if (guard) return;`` after the first line holding
    ``text``; ``text+N`` cuts N lines further down, ``text@continue`` runs
    ``continue`` instead of ``return``; ``;;`` separates several insertions,
    each made in the source as given."""
    lines = src.splitlines(keepends=True)
    at_lines = []
    for part in text.split(";;"):
        stmt = "return"
        if "@" in part:
            part, stmt = part.rsplit("@", 1)
        skip = 0
        m = re.fullmatch(r"(.*)\+(\d+)", part, re.S)
        if m:
            part, skip = m.group(1), int(m.group(2))
        hit = next((i for i, line in enumerate(lines) if part in line), None)
        if hit is None:
            raise ValueError(f"no line of the source holds {part!r}")
        at_lines.append((hit + skip + 1, f"  if ({guard}) {stmt};  // cut\n"))
    for at, line in sorted(at_lines, reverse=True):
        lines.insert(at, line)
    return "".join(lines)


def build_variants(source: str, cuts: Dict[str, str], guard: str) -> Dict[str, Path]:
    """Build the whole source ("full") and each cut copy, one nvcc each,
    all started together; returns the libraries' paths."""
    src_dir = build.CSRC
    name = Path(source).stem
    src = (src_dir / source).read_text()
    variants = {"full": src, **{n: cut_source(src, t, guard) for n, t in cuts.items()}}
    procs = {}
    for vname, text in variants.items():
        d = WORK / name / vname
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in build.LIBRARIES[name][1:]:
            shutil.copy(src_dir / header, d)
        (d / source).write_text(text)
        lib = d / f"lib{name}.so"
        cmd = [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o", str(lib), str(d / source)]
        procs[vname] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for vname, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {vname} failed:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {vname}: {line.strip()}", flush=True)
        paths[vname] = lib
    return paths


def forget_plans() -> None:
    """Drop the wrappers' cached plans: a newly loaded library's kernels take
    their shared memory when their plan is first asked for (wrappers that
    keep no plans, as the first designs', have nothing to drop)."""
    getattr(fb, "_PLANS", {}).clear()
    getattr(fm, "_PLANS", {}).clear()


def mlp_inputs(c: int, e: int, rows: int, dev, dtype=torch.bfloat16):
    """Seeded (x, w1, b1, w2, b2) of the fused MLP at width c -> e, as
    ``chip_smoke.py`` phase 12 makes them."""
    rng = np.random.default_rng(c)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    return (t(rng.standard_normal((rows, c)), dtype), t(rng.standard_normal((c, e)) / np.sqrt(c), dtype),
            t(0.3 * rng.standard_normal(e)), t(rng.standard_normal((e, c)) / np.sqrt(e), dtype),
            t(0.3 * rng.standard_normal(c)))


def mlp_sweep(rec: Recorder, c: int, e: int, rows: int, dev, n: int, reps: int) -> None:
    """Time ``n`` plans of the fused MLP at one width (``fused_mlp.plans``,
    the best of each kind by its cost model), bf16 and f32, each output held
    against the plain version (two bf16 ulps at the largest output; f32 1e-5
    of the largest summed magnitude)."""
    for dtype in (torch.bfloat16, torch.float32):
        args = mlp_inputs(c, e, rows, dev, dtype)
        want = fm.fused_mlp_residual_plain(*args).float()
        top = want.abs().max().item()
        tol = 2.0 ** (np.floor(np.log2(top)) - 6) if dtype == torch.bfloat16 else 1e-5 * (top + 10.0)
        keys = ("cs", "bm", "nbuf", "ec", "xr", "de") if dtype == torch.bfloat16 else ("bm", "cb", "resident")
        for i, plan in enumerate(varied(fm.plans(rows, c, e, dtype), keys, n)):
            got = fm.fused_mlp_residual(*args, plan=plan)
            err = (got.float() - want).abs().max().item()
            ms = time_ms(lambda: fm.fused_mlp_residual(*args, plan=plan), reps, 2)
            rec.emit(dict(name=f"sweep_mlp_c{c}_{str(dtype)[6:]}_{i}", kernel="fused_mlp_residual", C=c, E=e,
                          rows=rows, dtype=str(dtype)[6:], plan=plan, max_abs_err=err, ok=bool(err <= tol), ms=ms))
        del args, want


def stage_inputs(c: int, r: int, spatial, dev):
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.standard_normal((BATCH, *spatial, c), dtype=np.float32)).to(dev, torch.bfloat16)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    p = dict(
        w_dw=t(rng.standard_normal((c, 1, 3, 3, 3)) * 0.3), gamma=t(1.0 + 0.1 * rng.standard_normal(c)),
        beta=t(0.1 * rng.standard_normal(c)), w1=t(rng.standard_normal((r, c)) / np.sqrt(c)).to(torch.bfloat16),
        b1=t(0.1 * rng.standard_normal(r)), w2=t(rng.standard_normal((c, r)) / np.sqrt(r)).to(torch.bfloat16),
        b2=t(0.1 * rng.standard_normal(c)),
    )
    return x, fb.dw_stats_plain(x, p["w_dw"]), p


def varied(plans: List[Dict], keys, n: int) -> List[Dict]:
    """The ``n`` best plans that differ in ``keys`` (each the best of its
    kind by the cost model), so that a sweep sees more than one shape of
    work."""
    seen, out = set(), []
    for p in plans:
        k = tuple(p[key] for key in keys)
        if k not in seen:
            seen.add(k)
            out.append(p)
    return out[:n]


def sweep(rec: Recorder, c: int, r: int, spatial, dev, n: int, reps: int) -> None:
    """Time ``n`` plans of each kernel at one stage (the planner's best of
    each band height, and for the statistics pass of each ring and segment,
    for the apply pass of each unit width and weight chunk): bf16 and f32
    statistics, bf16 apply."""
    x, stats, p = stage_inputs(c, r, spatial, dev)
    shape = tuple(x.shape)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        ref = fb.dw_stats(xd, p["w_dw"])
        for i, plan in enumerate(varied(fb.stats_plans(shape, dtype), ("ty", "ring", "seg"), n)):
            same = bool(torch.equal(fb.dw_stats(xd, p["w_dw"], plan=plan), ref))
            ms = time_ms(lambda: fb.dw_stats(xd, p["w_dw"], plan=plan), reps, 2)
            rec.emit(dict(name=f"sweep_dw_stats_c{c}_{str(dtype)[6:]}_{i}", kernel="dw_stats", C=c, dtype=str(dtype)[6:],
                          plan={k: plan[k] for k in ("ty", "tx", "seg", "ring", "items", "smem_bytes", "est_clk")},
                          same_as_planner=same, ms=ms))
    ref = fb.fused_block_apply(x, stats, **p)
    for i, plan in enumerate(varied(fb.apply_plans(shape, r, c), ("ty", "cs", "rc"), n)):
        same = bool(torch.equal(fb.fused_block_apply(x, stats, **p, plan=plan), ref))
        ms = time_ms(lambda: fb.fused_block_apply(x, stats, **p, plan=plan), reps, 2)
        rec.emit(dict(name=f"sweep_apply_c{c}_{i}", kernel="fused_block_apply", C=c, dtype="bfloat16",
                      plan={k: plan[k] for k in ("ty", "tx", "seg", "cs", "rc", "units", "items", "smem_bytes",
                                                 "est_clk")}, same_as_planner=same, ms=ms))


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(prog="python -m pytorch_connectomics_tpu_torch.tools.block_phases")
    ap.add_argument("--source", default="mednext_block.cu", choices=("mednext_block.cu", "fused_mlp.cu"),
                    help="the kernel source to cut: the MedNeXt pair or the fused MLP")
    ap.add_argument("--cut", action="append", default=[],
                    help="NAME=TEXT[+N][@STMT]: STMT (return) after the first line holding TEXT (N lines further);"
                         " ';;' separates several insertions")
    ap.add_argument("--guard", default=None,
                    help="the cut's condition, true at run time and unknown to nvcc (default: eps > 0.f for the"
                         " pair, g.M > 0 for the fused MLP)")
    ap.add_argument("--stages", default=None, help="stages of the fast recipe to time (0-4; default 0,1 for the"
                                                   " pair, all five for the fused MLP)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", type=int, default=0, help="time each stage's N best plans of each kernel")
    ap.add_argument("--no-cuts", action="store_true", help="skip the cut builds")
    ap.add_argument("--out-dir", default="outputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("block_phases measures the card: no CUDA device")
    dev = torch.device("cuda")
    rec = Recorder("block_phases", dev, args.out_dir)
    mlp = args.source == "fused_mlp.cu"
    lib_name = Path(args.source).stem
    guard = args.guard or ("g.M > 0" if mlp else "eps > 0.f")
    cuts = dict(c.split("=", 1) for c in args.cut) or marker_cuts((build.CSRC / args.source).read_text())
    libs = {} if args.no_cuts else build_variants(args.source, cuts, guard)
    own = build.load(lib_name)
    stages = [STAGES[int(s)] for s in (args.stages or ("0,1,2,3,4" if mlp else "0,1")).split(",")]
    with torch.inference_mode():
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            build._declare(lib_name, lib)
            build._loaded[lib_name] = lib
            forget_plans()
            for c, r, spatial in stages:
                if mlp:
                    rows = BATCH * int(np.prod(spatial))
                    a = mlp_inputs(c, r, rows, dev)
                    ms = time_ms(lambda: fm.fused_mlp_residual(*a), args.reps, 2)
                    rec.emit(dict(name=f"mlp_{name}_c{c}", kernel="fused_mlp_residual", cut=name,
                                  cut_after=cuts.get(name), C=c, E=r, rows=rows, dtype="bfloat16", ms=ms))
                    del a
                    continue
                x, stats, p = stage_inputs(c, r, spatial, dev)
                ms = time_ms(lambda: fb.fused_block_apply(x, stats, **p), args.reps, 2)
                rec.emit(dict(name=f"apply_{name}_c{c}", kernel="fused_block_apply", cut=name,
                              cut_after=cuts.get(name), C=c, R=r, spatial=list(spatial), batch=BATCH,
                              dtype="bfloat16", ms=ms))
                del x, stats, p
        build._loaded[lib_name] = own
        forget_plans()
        if mlp:
            # the device time alone of each width (one CUDA graph of the
            # calls), beside the back-to-back time, with the port's library
            for c, r, spatial in stages:
                rows = BATCH * int(np.prod(spatial))
                for dtype in (torch.bfloat16, torch.float32):
                    a = mlp_inputs(c, r, rows, dev, dtype)
                    fn = lambda: fm.fused_mlp_residual(*a)  # noqa: E731
                    rec.emit(dict(name=f"mlp_device_c{c}_{str(dtype)[6:]}", kernel="fused_mlp_residual", C=c, E=r,
                                  rows=rows, dtype=str(dtype)[6:], ms=time_ms(fn, args.reps, 2),
                                  device_ms=device_ms(fn, args.reps)))
                    del a
                if args.sweep:
                    mlp_sweep(rec, c, r, rows, dev, args.sweep, args.reps)
            # host work per call: 256 rows of C 32; 200 calls, fewer than the
            # launch queue holds, so that the host never waits for the device
            a = mlp_inputs(32, 64, 256, dev)
            fn = lambda: fm.fused_mlp_residual(*a)  # noqa: E731
            rec.emit(dict(name="host_fused_mlp_residual", kernel="fused_mlp_residual", rows=256, C=32, E=64,
                          dtype="bfloat16", host_us=host_us(fn, 200, dev), ms=time_ms(fn, 200, 5)))
            rec.save()
            return rec.records
        for c, r, spatial in stages if args.sweep else ():
            sweep(rec, c, r, spatial, dev, args.sweep, args.reps)
        # host work per call: one batch element of 4 x 4 x 8 voxels, C 32; 200
        # calls (a few hundred launches), fewer than the launch queue holds,
        # so that the host never waits for the device
        x, stats, p = stage_inputs(32, 64, (4, 4, 8), dev)
        x = x[:1].contiguous()
        stats = stats[:1].contiguous()
        for kname, fn in (("dw_stats", lambda: fb.dw_stats(x, p["w_dw"])),
                          ("fused_block_apply", lambda: fb.fused_block_apply(x, stats, **p))):
            rec.emit(dict(name=f"host_{kname}", kernel=kname, shape=list(x.shape), dtype="bfloat16",
                          host_us=host_us(fn, 200, dev), ms=time_ms(fn, 200, 5)))
    rec.save()
    return rec.records


if __name__ == "__main__":
    main()
