"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile the port's CUDA kernels from the sources in the checkout
  3. kernels  each kernel against its plain PyTorch version at every shape
              the fast recipe launches (batch 16, bf16 and f32), with times
              (kernel, plain, bound, library yardstick) from CUDA events
  4. model    MedNeXt-S of the fast recipe at full width, seeded init: one
              (16, 96, 128, 96, 1) batch through the kernels and through the
              plain path; 18 launches of each kernel per forward
  5. slice    the port's CLI, --mode test, in-process, on seeded synthetic
              .npy volumes: the Lucchi++ test geometry 165x1024x768 without
              TTA, then 96x256x192 with flip TTA (8 variants); then the
              predict step alone at 165x1024x768, timed and profiled
  6. report   a {"kernels": [...]} line, then {"ok": true, "device": ...} last

Imports torch and the port only. Details go to build/chip_smoke/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
# peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
# (C, R, (Z, Y, X), blocks per forward) of the stride-1 MedNeXt-S blocks on
# the fast recipe's (96, 128, 96) window after the (1, 2, 2) stem
STAGES = [
    (32, 64, (96, 64, 48), 4),
    (64, 128, (48, 32, 24), 4),
    (128, 256, (24, 16, 12), 4),
    (256, 512, (12, 8, 6), 4),
    (512, 1024, (6, 4, 3), 2),
]
BATCH = 16
# limit of the bf16 model's kernel path against its plain path, as a share of
# max |plain output|; PERF.md gives the readings it was set from
MODEL_BF16_TOL = 0.02
RECIPE = ROOT / "tutorials" / "mito_lucchi_tpu_fast.yaml"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def block_params(rng, c, r, dev):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return dict(
        w_dw=t(rng.standard_normal((c, 1, 3, 3, 3)) * 0.3),
        gamma=t(1.0 + 0.1 * rng.standard_normal(c)),
        beta=t(0.1 * rng.standard_normal(c)),
        w1=t(rng.standard_normal((r, c)) / np.sqrt(c)),
        b1=t(0.1 * rng.standard_normal(r)),
        w2=t(rng.standard_normal((c, r)) / np.sqrt(r)),
        b2=t(0.1 * rng.standard_normal(c)),
    )


def bounds(c, r, spatial, es):
    """Least times (ms) of one launch of each kernel at batch BATCH, split
    into the bytes term (each input read once, each output written once,
    over the HBM rate) and the operations term (CUDA-core FLOP over the f32
    rate, tensor-core FLOP over the bf16 rate, whichever is larger)."""
    n = BATCH * math.prod(spatial)
    stencil = 2 * 27 * n * c
    stats = dict(
        bytes=(n * c * es + 27 * c * 4 + BATCH * 2 * c * 4) / PEAK_BYTES * 1e3,
        ops=(stencil + 3 * n * c) / PEAK_F32 * 1e3,
    )
    mlp, gelu = 2 * n * 2 * c * r, 10 * n * r
    apply_bytes = 2 * n * c * es + 27 * c * 4 + 2 * r * c * es + BATCH * 2 * c * 4
    if es == 2:
        ops = max((stencil + gelu) / PEAK_F32, mlp / PEAK_BF16_TC)
    else:
        ops = (stencil + gelu + mlp) / PEAK_F32
    return stats, dict(bytes=apply_bytes / PEAK_BYTES * 1e3, ops=ops * 1e3)


def library_block(x, p, eps):
    """The block as PyTorch library calls (the yardstick, never used by the
    port): conv3d(groups=C) + group_norm + linear + GELU + linear + residual,
    with every parameter already in x's dtype."""
    c = x.shape[-1]
    t = F.conv3d(x.permute(0, 4, 1, 2, 3), p["w_dw"], padding=1, groups=c)
    t = F.group_norm(t, c, p["gamma"], p["beta"], eps).permute(0, 2, 3, 4, 1)
    h = F.gelu(F.linear(t, p["w1"], p["b1"]), approximate="tanh")
    return x + F.linear(h, p["w2"], p["b2"])


def phase_kernels(fb, dev, report):
    log("== phase 3: kernels vs plain (batch 16) ==")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        es = 2 if dtype == torch.bfloat16 else 4
        for c, r, spatial, per_fwd in STAGES:
            rng = np.random.default_rng(c)
            x = torch.from_numpy(rng.standard_normal((BATCH, *spatial, c), dtype=np.float32)).to(dev, dtype)
            p = block_params(rng, c, r, dev)
            # cast once, as the model does: the timed windows hold the launches only
            p.update(w1=p["w1"].to(dtype), w2=p["w2"].to(dtype))
            lib_p = {k: v.to(dtype) for k, v in p.items()}
            stats = fb.dw_stats(x, p["w_dw"])
            want_stats = fb.dw_stats_plain(x, p["w_dw"])
            out = fb.fused_block_apply(x, want_stats, **p)
            want = fb.fused_block_apply_plain(x, want_stats, **p)
            torch.cuda.synchronize()
            # statistics: f32 sums in another order, relative to the summed magnitudes
            mag = fb.dw_stats_plain(x.abs(), p["w_dw"].abs())[:, :1] + want_stats[:, 1:]
            stats_abs = (stats - want_stats).abs().max().item()
            stats_rel = ((stats - want_stats).abs() / mag).max().item()
            if stats_rel > 1e-5:
                fail(f"dw_stats C={c} {dtype}: relative error {stats_rel:.3g} > 1e-5")
            err = (out.float() - want.float()).abs().max().item()
            # f32: FMA order. bf16: two bf16 ulps at the output's magnitude; the
            # kernel and the plain version sum in another order, so a value
            # rounded to bf16 (u, h, the output) can land one ulp apart
            top = want.float().abs().max().item()
            tol = 2e-4 if es == 4 else 2.0 ** (math.floor(math.log2(max(top, 1.0))) - 6)
            if err > tol:
                fail(f"fused_block_apply C={c} {dtype}: max error {err:.3g} > {tol:.3g}")
            reps = 20 if c >= 128 else 10
            b_stats, b_apply = bounds(c, r, spatial, es)
            row = dict(
                C=c, R=r, spatial=list(spatial), dtype=str(dtype).split(".")[-1], blocks_per_forward=per_fwd,
                dw_stats=dict(
                    ms=cuda_ms(lambda: fb.dw_stats(x, p["w_dw"]), reps),
                    plain_ms=cuda_ms(lambda: fb.dw_stats_plain(x, p["w_dw"]), reps),
                    bound_ms=max(b_stats.values()), bound_parts=b_stats, library_ms=None,
                    max_abs_err=stats_abs, max_rel_err=stats_rel,
                ),
                fused_block_apply=dict(
                    ms=cuda_ms(lambda: fb.fused_block_apply(x, want_stats, **p), reps),
                    plain_ms=cuda_ms(lambda: fb.fused_block_apply_plain(x, want_stats, **p), reps),
                    bound_ms=max(b_apply.values()), bound_parts=b_apply,
                    library_ms=cuda_ms(lambda: library_block(x, lib_p, fb.EPS), reps),
                    max_abs_err=err, tol=tol,
                ),
            )
            rows.append(row)
            s, a = row["dw_stats"], row["fused_block_apply"]
            log(
                f"C={c:4d} R={r:5d} {row['dtype']:8s} dw_stats {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
                f"bound {s['bound_ms']:.4f}, rel err {stats_rel:.2g}) | apply {a['ms']:.4f} ms (plain "
                f"{a['plain_ms']:.4f}, bound {a['bound_ms']:.4f}, library {a['library_ms']:.4f}, "
                f"err {err:.3g} <= {tol:.3g})"
            )
            del x, p, lib_p, stats, want_stats, out, want
    report["kernel_rows"] = rows
    return rows


def phase_model(fb, dev, report):
    log("== phase 4: MedNeXt-S forward, kernels vs plain ==")
    from pytorch_connectomics_tpu_torch.models import build_model

    cfg = load_model_config()
    model = build_model(cfg.model, device=dev, seed=0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 96, 128, 96, 1), dtype=np.float32)).to(dev)
    with torch.inference_mode():
        fb.reset_launch_counts()
        out = model(x)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in fb.KERNELS}
        if any(v != 18 for v in counts.values()):
            fail(f"one forward should launch each kernel 18 times, got {counts}")
        ref = model(x, plain=True)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        top = ref.abs().max().item()
        if not torch.isfinite(out).all() or out.shape != (BATCH, 96, 128, 96, 1):
            fail(f"model output not finite or of shape {tuple(out.shape)}")
        # bf16 through 18 blocks: ulp flips of rounded intermediates propagate
        tol = MODEL_BF16_TOL * max(top, 1.0)
        if err > tol:
            fail(f"model kernel path vs plain: max error {err:.3g} > {tol:.3g} ({MODEL_BF16_TOL:.0%} of max |ref|)")
        probes = fault_probes(model, x, ref)
        for name, perr in probes.items():
            log(f"fault probe ({name}): max error {perr:.4g} against the limit {tol:.4g}")
        if min(probes.values()) <= tol:
            fail(f"the model-level limit {tol:.3g} lets a fault probe pass: {probes}")
        ms = cuda_ms(lambda: model(x), reps=3, warmup=1)
        plain_ms = cuda_ms(lambda: model(x, plain=True), reps=3, warmup=1)
    log(f"bf16 batch 16: kernel path {ms:.2f} ms, plain path {plain_ms:.2f} ms, max err {err:.4g} (max |ref| {top:.3g})")
    # f32 model, batch 2, TF32 off: the kernels' arithmetic against plain
    cfg.model.compute_dtype = "float32"
    model32 = build_model(cfg.model, device=dev, seed=0)
    x2 = x[:2].contiguous()
    with torch.inference_mode():
        out32, ref32 = model32(x2), model32(x2, plain=True)
    err32 = (out32 - ref32).abs().max().item()
    top32 = ref32.abs().max().item()
    if err32 > 1e-3 * max(top32, 1.0):
        fail(f"f32 model kernel path vs plain: max error {err32:.3g} > 1e-3 of max |ref| {top32:.3g}")
    log(f"f32 batch 2: max err {err32:.4g} (max |ref| {top32:.3g})")
    report["model"] = dict(
        bf16_batch16_ms=ms, bf16_batch16_plain_ms=plain_ms, bf16_max_abs_err=err, bf16_max_abs_ref=top,
        bf16_tol=tol, fault_probe_max_abs_err=probes,
        f32_batch2_max_abs_err=err32, f32_max_abs_ref=top32, launches_per_forward=counts,
    )
    del model, model32, out, ref


def fault_probes(model, x, ref):
    """Max error against the sound plain path of the plain path with one
    deliberate fault each, the size of a kernel bug: a depthwise tap or a
    16-wide slice of the hidden dimension left out, in the first block of
    stage 0 and of the bottleneck. The model-level limit has to reject them."""
    probes = {}
    for where, blk in (("stage 0", model.enc[0].blocks[0]), ("bottleneck", model.bottleneck.blocks[0])):
        for fault, w, idx in (
            ("dw tap (0,0,0) dropped", blk.conv_weight, (slice(None), 0, 0, 0, 0)),
            ("hidden units 0:16 dropped", blk.pw2.weight, (slice(None), slice(0, 16))),
        ):
            with torch.inference_mode(False), torch.no_grad():
                saved = w[idx].clone()
                w[idx] = 0
            out = model(x, plain=True)
            with torch.inference_mode(False), torch.no_grad():
                w[idx] = saved
            probes[f"{fault}, {where}"] = (out - ref).abs().max().item()
    return probes


def load_model_config():
    """The fast recipe, as ``--mode test`` resolves it."""
    from pytorch_connectomics_tpu_torch.config import load_config

    return load_config(RECIPE, mode="test")


def synthetic_volume(shape, seed):
    """Seeded EM-like volume: smooth blobs as 'mitochondria', darker inside."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal(tuple(max(2, s // 8) for s in shape)).astype(np.float32)
    field = ndimage.zoom(coarse, [s / c for s, c in zip(shape, coarse.shape)], order=1)[: shape[0], : shape[1], : shape[2]]
    label = (field > 1.0).astype(np.uint8)
    img = 160.0 - 80.0 * label + 20.0 * rng.standard_normal(shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), label


def run_slice(fb, dev, shape, tta, work, seed):
    from pytorch_connectomics_tpu_torch.data.io import read_volume
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    name = f"syn{shape[0]}x{shape[1]}x{shape[2]}"
    img, label = synthetic_volume(shape, seed)
    np.save(work / f"{name}_im.npy", img)
    np.save(work / f"{name}_mito.npy", label)
    out_dir = work / f"out_{name}_tta{int(tta)}"
    args = parse_args([
        "--config", str(RECIPE), "--mode", "test", "--device", str(dev), "--output-dir", str(out_dir),
        f"data.test.image={work / f'{name}_im.npy'}", f"data.test.label={work / f'{name}_mito.npy'}",
        f"inference.test_time_augmentation.enabled={str(tta).lower()}",
    ])
    fb.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dispatch_runtime(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in fb.KERNELS}
    if any(v <= 0 for v in counts.values()):
        fail(f"the slice did not run through every kernel: {counts}")
    preds = sorted(p for p in out_dir.iterdir() if p.name.endswith(("_prediction.h5", "_prediction.npy")))
    pred = read_volume(str(preds[0]))
    if pred.shape != (1, *shape) or not np.isfinite(pred).all() or pred.min() < 0 or pred.max() > 1:
        fail(f"prediction {pred.shape} not finite in [0, 1] of shape (1, {shape})")
    metrics = res["metrics"][f"{name}"]
    if "jaccard" not in metrics:
        fail(f"no jaccard in {metrics}")
    mvox = math.prod(shape) / secs / 1e6
    log(
        f"slice {name} tta={tta} on {torch.cuda.get_device_name(0)}: {secs:.2f} s end to end ({mvox:.3f} Mvox/s), jaccard "
        f"{metrics['jaccard']:.4f}, launches {counts}, prediction {preds[0].name}"
    )
    return dict(shape=list(shape), tta=tta, seconds=secs, mvox_per_s=mvox, jaccard=metrics["jaccard"], launches=counts)


def phase_predict_profile(dev, work, shape, report):
    """The predict step alone (InferenceManager.predict, TTA off) on the
    slice's volume, warm, timed on the host clock, then once more under
    torch.profiler for the device's busy time and its top kernels."""
    from pytorch_connectomics_tpu_torch.data.preprocess import normalize_volume
    from pytorch_connectomics_tpu_torch.inference import InferenceManager
    from pytorch_connectomics_tpu_torch.models import build_model

    cfg = load_model_config()
    cfg.inference.test_time_augmentation.enabled = False
    model = build_model(cfg.model, device=dev, seed=cfg.system.seed)
    manager = InferenceManager(cfg, model, dev)
    name = f"syn{shape[0]}x{shape[1]}x{shape[2]}"
    vol = normalize_volume(np.load(work / f"{name}_im.npy"))
    manager.predict(vol)  # warm: cuDNN plans, the cached blend normaliser
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager.predict(vol)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        manager.predict(vol)
        torch.cuda.synchronize()
    prof_secs = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    from torch.autograd import DeviceType

    # kernel rows only: operator rows (aten::*) repeat their kernels' time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:8]
    mvox = math.prod(shape) / secs / 1e6
    log(f"predict {name} (TTA off, warm): {secs:.3f} s ({mvox:.2f} Mvox/s); under the profiler {prof_secs:.3f} s "
        f"with the device busy {busy:.3f} s ({100 * busy / prof_secs:.1f}%)")
    for e in top:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")
    ops = [e for e in prof.key_averages() if e.device_type != DeviceType.CUDA and dev_us(e) > 0]
    for e in sorted(ops, key=dev_us, reverse=True)[:6]:
        log(f"  op {dev_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")
    copies = sorted(
        (e for e in prof.key_averages(group_by_input_shape=True) if e.key == "aten::copy_" and dev_us(e) > 0),
        key=dev_us, reverse=True,
    )[:6]
    for e in copies:
        log(f"  copy_ {dev_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {str(e.input_shapes)[:110]}")
    report["predict"] = dict(
        shape=list(shape), seconds=secs, mvox_per_s=mvox, profiled_seconds=prof_secs, device_busy_seconds=busy,
        top_kernels=[dict(name=e.key, device_ms=dev_us(e) / 1e3, count=e.count) for e in top],
        top_copies=[dict(shapes=str(e.input_shapes), device_ms=dev_us(e) / 1e3, count=e.count) for e in copies],
    )
    del model, manager


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from pytorch_connectomics_tpu_torch.ops import build, fused_block as fb

    report = {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    report["nvidia_smi"] = smi
    for mod in ("yaml", "h5py"):
        try:
            __import__(mod)
            found = True
        except ImportError:
            found = False
        log(f"{mod} found: {found}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    log("== phase 2: build ==")
    t0 = time.perf_counter()
    build.build()
    report["build_seconds"] = time.perf_counter() - t0
    log(f"kernels built in {report['build_seconds']:.1f} s")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rows = phase_kernels(fb, dev, report)
    phase_model(fb, dev, report)

    log("== phase 5: CLI --mode test slice ==")
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    main_run = run_slice(fb, dev, (165, 1024, 768), False, work, seed=0)
    tta_run = run_slice(fb, dev, (96, 256, 192), True, work, seed=1)
    report["slice"] = [main_run, tta_run]
    phase_predict_profile(dev, work, (165, 1024, 768), report)

    source = "pytorch_connectomics_tpu_torch/ops/csrc/mednext_block.cu"
    replaces = {
        "dw_stats": "pytorch_connectomics_tpu/ops/fused_block_pallas.py:148",
        "fused_block_apply": "pytorch_connectomics_tpu/ops/fused_block_pallas.py:238",
    }
    kernels = []
    for name in ("dw_stats", "fused_block_apply"):
        bf16 = [r for r in rows if r["dtype"] == "bfloat16"]

        def per_forward(key):
            vals = [r[name][key] for r in bf16]
            if any(v is None for v in vals):
                return None
            return sum(v * r["blocks_per_forward"] for v, r in zip(vals, bf16))

        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces[name],
            launches=main_run["launches"][name],
            max_abs_err=max(r[name]["max_abs_err"] for r in bf16),
            ms=per_forward("ms"), plain_ms=per_forward("plain_ms"), bound_ms=per_forward("bound_ms"),
            bound_by="bytes" if sum(r[name]["bound_parts"]["bytes"] * r["blocks_per_forward"] for r in bf16)
            >= sum(r[name]["bound_parts"]["ops"] * r["blocks_per_forward"] for r in bf16) else "operations",
            library_ms=per_forward("library_ms"),
        ))
    report["kernels"] = kernels
    (work / "chip_smoke.json").write_text(json.dumps(report, indent=2))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
