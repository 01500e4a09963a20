"""Op-level measurement entry points of the port, the counterparts of the
JAX package's TPU probe scripts (``scripts/tpu_microbench.py``,
``scripts/tpu_vpu_probe.py``, ``scripts/tpu_bf16_experiments*.py``):

    python -m pytorch_connectomics_tpu_torch.tools.microbench [--device cpu] [--small]
    python -m pytorch_connectomics_tpu_torch.tools.probes [--device cpu] [--small]

Each prints one JSON line per measurement and writes them to
``<out-dir>/<name>.jsonl`` (default ``outputs/``). On the card, times come
from CUDA events over repeated launches after a warm-up; with ``--device
cpu`` they come from the host clock, and every record names its device and
clock, so a CPU number is never read as the card's. ``--small`` cuts every
shape to a few thousand elements (for the CPU tests).

Every record of one of the port's kernels holds the kernel's output against
its plain version on the same inputs (``max_abs_err``, the stated ``tol``
and ``status`` OK or failed), the plain version's time and the least time
the card could take (``bound_ms``, ``bound_by``, ``bound_parts``: the bytes
moved over the data-sheet memory rate, the operations over the data-sheet
peak of their type).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from ..utils.device import resolve_device

# peaks of one H100 SXM (NVIDIA data sheet, dense) that every bound divides
# by: HBM bytes/s, bf16 tensor-core FLOP/s, f32 CUDA-core FLOP/s, and packed
# bf16 FMA on the CUDA cores (Hopper architecture white paper, H100 SXM5,
# non-tensor BF16)
PEAK_BYTES = 3.35e12
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
PEAK_BF16_CC = 133.8e12


def parse_args(name: str, argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog=f"python -m pytorch_connectomics_tpu_torch.tools.{name}")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true", help="tiny shapes, for a quick run on the CPU")
    p.add_argument("--out-dir", default="outputs", help="directory of <name>.jsonl")
    return p.parse_args(argv)


class Recorder:
    """Prints each measurement as a JSON line and keeps it; ``save`` writes
    them all to ``<out_dir>/<name>.jsonl``."""

    def __init__(self, name: str, device: torch.device, out_dir: str):
        self.name, self.device, self.out_dir = name, device, Path(out_dir)
        self.records: List[Dict] = []
        self.kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        self.clock = "cuda_events" if device.type == "cuda" else "host"

    def emit(self, rec: Dict) -> Dict:
        """Print and keep ``rec``, with the device and clock its times come from."""
        rec = {**rec, "device": self.kind, "clock": self.clock}
        print(json.dumps(rec), flush=True)
        self.records.append(rec)
        return rec

    def save(self) -> Path:
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"{self.name}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in self.records))
        return path

    def time_ms(self, fn: Callable[[], object], reps: int = 10, warmup: int = 2) -> float:
        return time_ms(fn, reps, warmup, self.device)

    def kernel(self, rec: Dict, fn: Callable[[], torch.Tensor], plain: Callable[[], torch.Tensor], tol,
               rule: str, reps: int = 10, plain_reps: Optional[int] = None,
               per_s: Optional[Dict[str, float]] = None) -> Dict:
        """Emit ``rec`` for the kernel call ``fn``: the output of its first
        call (the warm-up) held against ``plain()``'s within ``tol`` (a
        number, a tensor of per-element limits, or a function of the plain
        output giving either; ``rule`` states it), then the mean times of
        ``reps`` more calls of ``fn`` and of ``plain_reps`` (default ``reps``)
        calls of ``plain``, and each ``per_s`` amount per second of the
        kernel's time."""
        got, want = fn(), plain()
        limit = tol(want) if callable(tol) else tol
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= limit).all())
        rec = {**rec, "max_abs_err": diff.max().item(), "tol": rule, "status": "OK" if ok else "failed"}
        del got, want, diff, limit
        rec["ms"] = self.time_ms(fn, reps, 1)
        rec["plain_ms"] = self.time_ms(plain, plain_reps or reps, 1)
        rec.update({k: rate(v, rec["ms"]) for k, v in (per_s or {}).items()})
        return self.emit(rec)


def time_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2, device: Optional[torch.device] = None) -> float:
    """Mean time of ``fn()`` over ``reps`` back-to-back calls after
    ``warmup`` calls: CUDA events on the card (the default), the host clock
    on the CPU."""
    for _ in range(warmup):
        fn()
    if device is not None and device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def bound(moved: float, ops: float = 0.0, peak: float = PEAK_F32) -> Dict:
    """The least time (ms) of work that moves ``moved`` bytes and does
    ``ops`` operations at ``peak`` a second: the larger of the two terms."""
    parts = {"bytes": moved / PEAK_BYTES * 1e3, "ops": ops / peak * 1e3}
    return {"bound_ms": max(parts.values()), "bound_by": "bytes" if parts["bytes"] >= parts["ops"] else "operations",
            "bound_parts": parts}


def bf16_ulps(want: torch.Tensor, n: int = 2) -> float:
    """``n`` units in the last place of bfloat16 at the largest ``|want|``."""
    top = want.float().abs().max().item()
    return n * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def setup(name: str, argv: Optional[List[str]]):
    """(args, device, recorder, seeded generator on the device)."""
    args = parse_args(name, argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # f32 products and convolutions in full f32, as the kernels compute them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    return args, dev, Recorder(name, dev, args.out_dir), gen


def randn(gen: torch.Generator, shape, dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """Seeded normal values made on the generator's device, in ``dtype``."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def rate(value: float, ms: float) -> float:
    """``value`` per second of ``ms``."""
    return value / (ms * 1e-3)
