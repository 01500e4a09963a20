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
  6. depthwise the training path's depthwise kernels (forward, input
              gradient with mirrored taps, weight gradient) against their
              plain versions at every stride-1 stage shape of MedNeXt-S
              training (batch 8) on the synthetic and the Lucchi fast
              recipes, bf16 and f32, with times (kernel, plain, bound,
              library yardstick); two weight-gradient runs bit-identical
  7. train    one MedNeXt-S train step at the Lucchi fast recipe's training
              shape (batch 8 of 96^3, bf16, outside_block remat): loss and
              per-leaf gradients of the kernel path against the plain path,
              with fault probes that the limit must reject; step time, peak
              memory and kernel launches per step
  8. cli      the port's CLI on tutorials/mito_synthetic_cli_fast_tpu.yaml:
              --mode train for 20 steps, then --mode test without
              --checkpoint, which restores the train leg's last checkpoint
  9. conv3d   RSUNet's dense 3^3 conv kernel against its plain version at
              every shape of RSUNet on the NucMM-Z recipe (batch 8 of 64^3,
              bf16 and f32), with times (kernel, plain, bound, F.conv3d)
 10. rsunet   RSUNet at full width ([28,36,48,64], iso), seeded init: one
              (8, 64, 64, 64, 1) batch through the kernel and through the
              plain path, bf16 and f32; 15 launches per forward; four fault
              probes that the bf16 limit must reject
 11. nucmm    the port's CLI, --mode test of tutorials/nuc_nucmm.yaml on a
              seeded synthetic 165x1024x768 volume with connected-component
              ground truth: prediction, bcd decode, instance metrics; then
              the predict step alone, timed and profiled
 12. probes   the measurement entry points (tools/microbench.py, tools/probes.py)
              once each, in-process, their kernels' launches counted from
              zero; each kernel record of theirs holds the kernel against
              its plain version at the shape it ran, with times (kernel,
              plain, bound, library), and any record that failed fails the
              phase; the card's measured ceilings from those records; then
              the fused MLP with residual against its plain version at
              MedNeXt-S's five widths (the fast recipe's batch-16 stage row
              counts, bf16 and f32), with times beside the unfused cuBLAS
              sequence
 13. report   a {"kernels": [...]} line, then {"ok": true, "device": ...} last

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

# the data-sheet peaks every bound divides by, and the one timer (CUDA events)
from pytorch_connectomics_tpu_torch.tools import PEAK_BF16_TC, PEAK_BYTES, PEAK_F32, time_ms

ROOT = Path(__file__).resolve().parent
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
SYNTH_RECIPE = ROOT / "tutorials" / "mito_synthetic_cli_fast_tpu.yaml"
# ((Z, Y, X), C, blocks per step) of the stride-1 MedNeXt-S blocks in
# training, after the (1, 2, 2) stem: the synthetic recipe's 64^3 patch and
# the Lucchi fast recipe's 96^3 patch, both at batch 8
TRAIN_BATCH = 8
TRAIN_STAGES = {
    "synthetic": [((64, 32, 32), 32, 4), ((32, 16, 16), 64, 4), ((16, 8, 8), 128, 4), ((8, 4, 4), 256, 4),
                  ((4, 2, 2), 512, 2)],
    "lucchi": [((96, 48, 48), 32, 4), ((48, 24, 24), 64, 4), ((24, 12, 12), 128, 4), ((12, 6, 6), 256, 4),
               ((6, 3, 3), 512, 2)],
}
# limits of the bf16 train step's kernel path against its plain path: the
# loss, relative; each gradient leaf, as the norm of the difference over the
# leaf's norm (conv_bias leaves, zero in exact arithmetic because GroupNorm
# follows the conv, over the largest leaf norm); PERF.md gives the readings
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 0.05
NUCMM = ROOT / "tutorials" / "nuc_nucmm.yaml"
NUCMM_BATCH = 8
NUCMM_SHAPE = (165, 1024, 768)
# ((Z, Y, X), Cin, Cout, launches per forward) of RSUNet's 3^3 convs on the
# NucMM-Z recipe's 64^3 window (width [28, 36, 48, 64], iso)
CONV_SHAPES = [
    ((64, 64, 64), 1, 28, 1),
    ((64, 64, 64), 28, 28, 4),
    ((32, 32, 32), 28, 36, 1),
    ((32, 32, 32), 36, 36, 3),
    ((16, 16, 16), 36, 48, 1),
    ((16, 16, 16), 48, 48, 3),
    ((8, 8, 8), 48, 64, 1),
    ((8, 8, 8), 64, 64, 1),
]
# limits of RSUNet's kernel path against its plain path, as shares of max
# |plain output|: bf16 set between the sound reading and the smallest fault
# probe, f32 for sums in another order; PERF.md gives the readings
RSUNET_BF16_TOL = 0.03
RSUNET_F32_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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
                    ms=time_ms(lambda: fb.dw_stats(x, p["w_dw"]), reps),
                    plain_ms=time_ms(lambda: fb.dw_stats_plain(x, p["w_dw"]), reps),
                    bound_ms=max(b_stats.values()), bound_parts=b_stats, library_ms=None,
                    max_abs_err=stats_abs, max_rel_err=stats_rel,
                ),
                fused_block_apply=dict(
                    ms=time_ms(lambda: fb.fused_block_apply(x, want_stats, **p), reps),
                    plain_ms=time_ms(lambda: fb.fused_block_apply_plain(x, want_stats, **p), reps),
                    bound_ms=max(b_apply.values()), bound_parts=b_apply,
                    library_ms=time_ms(lambda: library_block(x, lib_p, fb.EPS), reps),
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
        ms = time_ms(lambda: model(x), reps=3, warmup=1)
        plain_ms = time_ms(lambda: model(x, plain=True), reps=3, warmup=1)
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


def dev_us(e):
    """Device time (us) of a profiler row, across torch versions."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def phase_predict_profile(dev, work, shape, report, recipe=RECIPE, name=None, key="predict"):
    """The predict step alone (InferenceManager.predict, TTA off) on the
    slice's volume ``work/<name>_im.npy``, warm, timed on the host clock,
    then once more under torch.profiler for the device's busy time and its
    top kernels; recorded under ``report[key]``."""
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.preprocess import normalize_volume
    from pytorch_connectomics_tpu_torch.inference import InferenceManager
    from pytorch_connectomics_tpu_torch.models import build_model

    cfg = load_config(recipe, mode="test")
    cfg.inference.test_time_augmentation.enabled = False
    model = build_model(cfg.model, device=dev, seed=cfg.system.seed)
    manager = InferenceManager(cfg, model, dev)
    name = name or f"syn{shape[0]}x{shape[1]}x{shape[2]}"
    vol = normalize_volume(np.load(work / f"{name}_im.npy"), cfg.data.preprocessing.normalize)
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
    report[key] = dict(
        shape=list(shape), seconds=secs, mvox_per_s=mvox, profiled_seconds=prof_secs, device_busy_seconds=busy,
        top_kernels=[dict(name=e.key, device_ms=dev_us(e) / 1e3, count=e.count) for e in top],
        top_copies=[dict(shapes=str(e.input_shapes), device_ms=dev_us(e) / 1e3, count=e.count) for e in copies],
    )
    del model, manager


def dw_bounds(n, c, es):
    """Least times (ms) of one launch of the depthwise kernels on n voxels
    of c channels, as (bytes term, operations term): each input read once
    and each output written once over the HBM rate; 27 FMAs per value (and
    the bias sum for the weight gradient) over the f32 CUDA-core rate."""
    moved = 2 * n * c * es + 28 * c * 4
    fwd = dict(bytes=moved / PEAK_BYTES * 1e3, ops=54 * n * c / PEAK_F32 * 1e3)
    wgrad = dict(bytes=moved / PEAK_BYTES * 1e3, ops=55 * n * c / PEAK_F32 * 1e3)
    return fwd, wgrad


def phase_depthwise(dwk, dev, report):
    log("== phase 6: depthwise kernels vs plain (batch 8) ==")
    rows = []
    for recipe, stages in TRAIN_STAGES.items():
        for dtype in (torch.bfloat16, torch.float32):
            es = 2 if dtype == torch.bfloat16 else 4
            for spatial, c, per_step in stages:
                shape = (TRAIN_BATCH, *spatial, c)
                n = math.prod(shape[:4])
                rng = np.random.default_rng(c)
                x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                w = torch.from_numpy(rng.standard_normal((c, 1, 3, 3, 3)).astype(np.float32) * 0.3).to(dev)
                b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dev)
                wf = w.flip((2, 3, 4))
                row = dict(recipe=recipe, C=c, spatial=list(spatial), dtype=str(dtype).split(".")[-1],
                           blocks_per_step=per_step)
                for name, args in (("forward", (x, w, b)), ("input_grad", (dy, wf, None))):
                    got, want = dwk.depthwise3x3(*args), dwk.depthwise3x3_plain(*args)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    # f32: FMA order against the summed magnitudes; bf16: both sum
                    # in f32 and round once, two ulps at the largest output
                    mag = dwk.depthwise3x3_plain(args[0].float().abs(), args[1].abs()).abs().max().item()
                    top = want.float().abs().max().item()
                    tol = 1e-5 * mag if es == 4 else 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 6)
                    if err > tol:
                        fail(f"depthwise3x3 {name} {recipe} C={c} {dtype}: max error {err:.3g} > {tol:.3g}")
                    row[name] = dict(max_abs_err=err, tol=tol)
                    del got, want
                gw, gb = dwk.depthwise3x3_wgrad(x, dy)
                gw2, gb2 = dwk.depthwise3x3_wgrad(x, dy)
                ww, wb = dwk.depthwise3x3_wgrad_plain(x, dy)
                mw, mb = dwk.depthwise3x3_wgrad_plain(x.float().abs(), dy.float().abs())
                torch.cuda.synchronize()
                if not (torch.equal(gw, gw2) and torch.equal(gb, gb2)):
                    fail(f"depthwise3x3_wgrad {recipe} C={c} {dtype}: two runs differ")
                # f32 sums of B*N products in another order, against the summed magnitudes
                rel = max(((gw - ww).abs() / (mw + 1e-30)).max().item(), ((gb - wb).abs() / (mb + 1e-30)).max().item())
                if rel > 1e-5:
                    fail(f"depthwise3x3_wgrad {recipe} C={c} {dtype}: relative error {rel:.3g} > 1e-5")
                row["wgrad"] = dict(max_abs_err=max((gw - ww).abs().max().item(), (gb - wb).abs().max().item()),
                                    max_rel_err=rel, bit_identical=True)
                reps = 10 if n * c > 1e7 else 30
                xn, dyn, wd, bd = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3), w.to(dtype), b.to(dtype)
                b_fwd, b_wgrad = dw_bounds(n, c, es)
                row["forward"].update(
                    ms=time_ms(lambda: dwk.depthwise3x3(x, w, b), reps),
                    plain_ms=time_ms(lambda: dwk.depthwise3x3_plain(x, w, b), reps),
                    library_ms=time_ms(lambda: F.conv3d(xn, wd, bd, padding=1, groups=c), reps),
                    bound_ms=max(b_fwd.values()), bound_parts=b_fwd,
                )
                row["input_grad"].update(
                    ms=time_ms(lambda: dwk.depthwise3x3(dy, wf), reps),
                    plain_ms=time_ms(lambda: dwk.depthwise3x3_plain(dy, wf), reps),
                    library_ms=time_ms(lambda: torch.nn.grad.conv3d_input(xn.shape, wd, dyn, padding=1, groups=c), reps),
                    bound_ms=max(b_fwd.values()), bound_parts=b_fwd,
                )
                row["wgrad"].update(
                    ms=time_ms(lambda: dwk.depthwise3x3_wgrad(x, dy), reps),
                    plain_ms=time_ms(lambda: dwk.depthwise3x3_wgrad_plain(x, dy), reps),
                    library_ms=time_ms(lambda: torch.nn.grad.conv3d_weight(xn, w.shape, dyn, padding=1, groups=c), reps),
                    bound_ms=max(b_wgrad.values()), bound_parts=b_wgrad,
                )
                rows.append(row)
                f, g, wg = row["forward"], row["input_grad"], row["wgrad"]
                log(
                    f"{recipe:9s} C={c:3d} {row['dtype']:8s} fwd {f['ms']:.4f} ms (plain {f['plain_ms']:.4f}, bound "
                    f"{f['bound_ms']:.4f}, library {f['library_ms']:.4f}, err {f['max_abs_err']:.3g}) | dgrad "
                    f"{g['ms']:.4f} (library {g['library_ms']:.4f}) | wgrad {wg['ms']:.4f} ms (plain "
                    f"{wg['plain_ms']:.4f}, bound {wg['bound_ms']:.4f}, library {wg['library_ms']:.4f}, rel err {rel:.2g})"
                )
                del x, dy, xn, dyn, gw, gb, gw2, gb2, ww, wb, mw, mb
    report["depthwise_rows"] = rows
    return rows


def leaf_errors(got, want):
    """Per-leaf gradient error: |g - g_ref| / |g_ref| (norms), and for
    conv_bias leaves |g - g_ref| over the largest leaf norm."""
    top = max(g.norm().item() for g in want.values())
    out = {}
    for n, g in want.items():
        d = (got[n] - g).norm().item()
        out[n] = d / top if n.endswith("conv_bias") else d / max(g.norm().item(), 1e-30)
    return out


def phase_train_step(dwk, fb, dev, report):
    log("== phase 7: MedNeXt-S train step at the Lucchi fast recipe's training shape ==")
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
    from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

    cfg = load_config(RECIPE, mode="train")
    if cfg.model.mednext.checkpoint_style != "outside_block" or cfg.model.compute_dtype != "bfloat16":
        fail("the Lucchi fast recipe no longer trains bf16 with outside_block remat")
    model = build_model(cfg.model, device=dev, seed=0)
    orch = LossOrchestrator(cfg.model.loss)
    shape = (cfg.data.dataloader.batch_size, *cfg.data.dataloader.patch_size, 1)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    y = torch.from_numpy((rng.random(shape) > 0.8).astype(np.float32)).to(dev)

    def loss_and_grads(plain):
        model.zero_grad(set_to_none=True)
        loss, _ = orch(model(x, plain=plain), y)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    dwk.reset_launch_counts()
    fb.reset_launch_counts()
    loss_k, g_k = loss_and_grads(False)
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in dwk.KERNELS + fb.KERNELS}
    # 18 stride-1 blocks: forward, remat recompute and input gradient; one wgrad each
    if counts != {"depthwise3x3": 54, "depthwise3x3_wgrad": 18, "dw_stats": 0, "fused_block_apply": 0}:
        fail(f"one remat train step should launch depthwise3x3 54 and depthwise3x3_wgrad 18 times, got {counts}")
    loss_p, g_p = loss_and_grads(True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs = leaf_errors(g_k, g_p)
    worst = max(errs, key=errs.get)
    log(f"loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel err {loss_err:.3g}); worst leaf {worst} {errs[worst]:.4g}")
    if not math.isfinite(loss_k) or loss_err > TRAIN_LOSS_TOL:
        fail(f"train step loss: kernel {loss_k} vs plain {loss_p} (rel err {loss_err:.3g} > {TRAIN_LOSS_TOL})")
    if errs[worst] > TRAIN_GRAD_TOL:
        fail(f"train step gradient {worst}: error {errs[worst]:.3g} > {TRAIN_GRAD_TOL}")
    probes = {}
    for where, blk in (("stage 0", model.enc[0].blocks[0]), ("bottleneck", model.bottleneck.blocks[0])):
        for fault, w, idx in (
            ("dw tap (0,0,0) dropped", blk.conv_weight, (slice(None), 0, 0, 0, 0)),
            ("hidden units 0:16 dropped", blk.pw2.weight, (slice(None), slice(0, 16))),
        ):
            with torch.no_grad():
                saved = w[idx].clone()
                w[idx] = 0
            _, g_f = loss_and_grads(True)
            with torch.no_grad():
                w[idx] = saved
            perr = leaf_errors(g_f, g_p)
            probes[f"{fault}, {where}"] = max(perr.values())
    for name, perr in probes.items():
        log(f"fault probe ({name}): worst leaf error {perr:.4g} against the limit {TRAIN_GRAD_TOL}")
    if min(probes.values()) <= TRAIN_GRAD_TOL:
        fail(f"the gradient limit {TRAIN_GRAD_TOL} lets a fault probe pass: {probes}")
    # the full step (forward, backward, clip, AdamW) through the kernels
    opt, schedule = build_optimizer(cfg.optimization, model, 100)
    state = create_train_state(model, opt)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val)
    batch = {"image": x, "label": y}
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        logs = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(float(v)) for v in logs.values()):
        fail(f"train step logs not finite: {logs}")
    t0 = time.perf_counter()
    for _ in range(reps):
        loss_and_grads(True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"train step {shape} bf16 remat: {step_ms:.1f} ms (plain forward+backward {plain_ms:.1f} ms), "
        f"peak memory {peak / 2**30:.2f} GiB, launches per step {counts}")
    # one step under the profiler: the device's busy time and its top kernels
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    log(f"one step under the profiler: {prof_ms:.1f} ms, kernels {busy_ms:.1f} ms of device time")
    for e in top:
        log(f"  {dev_us(e) / 1e3:8.2f} ms  {e.count:5d}x  {e.key[:90]}")
    report["train_step"] = dict(
        shape=list(shape), step_ms=step_ms, plain_fwd_bwd_ms=plain_ms, peak_memory_bytes=peak,
        launches_per_step=counts, profiled_ms=prof_ms, device_busy_ms=busy_ms,
        top_kernels=[dict(name=e.key, device_ms=dev_us(e) / 1e3, count=e.count) for e in top], loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_err,
        grad_leaf_errors=errs, worst_leaf=worst, grad_tol=TRAIN_GRAD_TOL, fault_probe_leaf_errors=probes,
    )
    del model, opt, state, g_k, g_p


def phase_cli_train_test(dwk, fb, dev, work, report):
    log("== phase 8: CLI --mode train, then --mode test restoring it ==")
    import shutil

    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime
    from pytorch_connectomics_tpu_torch.training.checkpoint import is_checkpoint_dir

    run_root = work / "cli_train"
    shutil.rmtree(run_root, ignore_errors=True)
    flags = ["--config", str(SYNTH_RECIPE), "--device", str(dev)]
    train_args = parse_args(flags + [
        "--mode", "train", f"save_path={run_root}", "optimization.n_steps_per_epoch=20",
        "optimization.max_epochs=1", "monitor.logging.scalar.loss_every_n_steps=5",
    ])
    dwk.reset_launch_counts()
    fb.reset_launch_counts()
    res = dispatch_runtime(train_args)
    torch.cuda.synchronize()
    train_counts = {k.__name__: k.launches for k in dwk.KERNELS + fb.KERNELS}
    if any(k.launches <= 0 for k in dwk.KERNELS):
        fail(f"the train leg did not run through both depthwise kernels: {train_counts}")
    run_dir = Path(res["run_dir"])
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss_total"] for r in recs if "train_loss_total" in r]
    if len(losses) < 2 or not all(math.isfinite(v) for v in losses):
        fail(f"train leg losses missing or not finite: {losses}")
    ckpt = res["checkpoint"]
    if not ckpt or Path(ckpt).name != "last" or not is_checkpoint_dir(ckpt):
        fail(f"train leg left no last checkpoint: {ckpt}")
    st = res["train_stats"]
    fb.reset_launch_counts()
    test_res = dispatch_runtime(parse_args(flags + ["--mode", "test", f"save_path={run_root}"]))
    torch.cuda.synchronize()
    test_counts = {k.__name__: k.launches for k in fb.KERNELS}
    restored = test_res.get("restored") or {}
    if restored.get("checkpoint") != ckpt or restored.get("config_hash") != res["config_hash"]:
        fail(f"the test leg did not restore the train leg's checkpoint {ckpt}: {restored}")
    if any(v <= 0 for v in test_counts.values()):
        fail(f"the test leg did not run through the fused kernels: {test_counts}")
    metrics = next(iter(test_res["metrics"].values()))
    if "jaccard" not in metrics or not math.isfinite(metrics["jaccard"]):
        fail(f"test leg metrics: {metrics}")
    steps_per_s = st["steps"] / st["seconds"]
    host_ms = st["pipeline_host_seconds"] / max(1, st["pipeline_batches"]) * 1e3
    log(f"train leg: {st['steps']} steps in {st['seconds']:.2f} s ({steps_per_s:.3f} steps/s), pipeline host "
        f"{host_ms:.1f} ms per batch ({st['pipeline_batches']} batches), waited {st['data_wait_seconds']:.2f} s "
        f"for batches; losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches {train_counts}")
    log(f"test leg restored {restored['checkpoint']} (step {restored['step']}, config hash "
        f"{restored['config_hash']}): jaccard {metrics['jaccard']:.4f} (20 steps: measures nothing); "
        f"launches {test_counts}")
    report["cli"] = dict(train_stats=st, steps_per_s=steps_per_s, pipeline_host_ms_per_batch=host_ms,
                         losses=losses, train_launches=train_counts, test_launches=test_counts,
                         restored=restored, test_metrics=metrics)
    return train_counts


def conv_bounds(n, cin, cout, es):
    """Least times (ms) of one conv3d launch on n voxels, as (bytes term,
    operations term): input and weight read once and output written once
    over the HBM rate; 2 * 27 * Cin * Cout FLOP per voxel over the bf16
    tensor-core rate (f32: the CUDA-core rate)."""
    moved = n * (cin + cout) * es + 27 * cin * cout * es + cout * 4
    flop = 2 * 27 * n * cin * cout
    return dict(bytes=moved / PEAK_BYTES * 1e3, ops=flop / (PEAK_BF16_TC if es == 2 else PEAK_F32) * 1e3)


def phase_conv3d(c3, dev, report):
    log("== phase 9: conv3d kernel vs plain (batch 8, RSUNet on NucMM-Z) ==")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        es = 2 if dtype == torch.bfloat16 else 4
        for spatial, cin, cout, per_fwd in CONV_SHAPES:
            rng = np.random.default_rng(100 * cin + cout)
            x = torch.from_numpy(rng.standard_normal((NUCMM_BATCH, *spatial, cin), dtype=np.float32)).to(dev, dtype)
            w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32))
            w = w.to(dev)
            b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(dev)
            wmat = c3.kernel_weight(w, dtype)  # built once per parameter, as the model does
            got, want = c3.conv3d_3x3(x, w, b, wmat=wmat), c3.conv3d_3x3_plain(x, w, b)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if es == 4:
                # f32 sums in another order: 1e-5 of the summed magnitudes
                mag = c3.conv3d_3x3_plain(x.abs(), w.abs()) + b.abs()
                rel, tol = ((got - want).abs() / mag).max().item(), 1e-5
                bad = rel > tol
                del mag
            else:
                # both sum in f32, round, add the bias, round: two ulps at the largest output
                rel, tol = None, 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 6)
                bad = err > tol
            if bad:
                fail(f"conv3d_3x3 {spatial} {cin}->{cout} {dtype}: error {err:.3g} (relative {rel}) over {tol:.3g}")
            n = NUCMM_BATCH * math.prod(spatial)
            xn = x.permute(0, 4, 1, 2, 3)  # channels_last_3d, as the yardstick takes it
            wl, bl = w.to(dtype).contiguous(memory_format=torch.channels_last_3d), b.to(dtype)
            reps = 10 if n * max(cin, cout) > 1e7 else 30
            bnd = conv_bounds(n, cin, cout, es)
            row = dict(
                spatial=list(spatial), cin=cin, cout=cout, dtype=str(dtype).split(".")[-1],
                launches_per_forward=per_fwd,
                ms=time_ms(lambda: c3.conv3d_3x3(x, w, b, wmat=wmat), reps),
                plain_ms=time_ms(lambda: c3.conv3d_3x3_plain(x, w, b), reps),
                library_ms=time_ms(lambda: F.conv3d(xn, wl, bl, padding=1), reps),
                bound_ms=max(bnd.values()), bound_parts=bnd, max_abs_err=err, max_rel_err=rel, tol=tol,
            )
            rows.append(row)
            log(
                f"{str(spatial):14s} {cin:2d}->{cout:2d} {row['dtype']:8s} {row['ms']:.4f} ms (plain "
                f"{row['plain_ms']:.4f}, F.conv3d {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"{max(bnd, key=bnd.get)}) err {err:.3g} <= {tol:.3g}"
            )
            del x, w, got, want, xn, wl
    report["conv3d_rows"] = rows
    return rows


def nucmm_model(dev, dtype="bfloat16"):
    """(RSUNet of the NucMM-Z recipe at full width, its window): seeded
    init, with seeded nonzero conv biases (flax's init leaves them 0, and a
    bias left out by a kernel must show)."""
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.models.rsunet import Conv

    cfg = load_config(NUCMM, mode="test")
    cfg.model.compute_dtype = dtype
    model = build_model(cfg.model, device=dev, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                m.bias.copy_(0.5 * torch.randn(m.bias.shape, generator=g))
    return model, tuple(cfg.inference.window.window_size)


def rsunet_fault_probes(c3, model, x, ref):
    """Max error against the sound plain path of the plain path with one
    deliberate kernel-sized fault in every 3^3 conv: tap (0,0,0) dropped,
    input channel 0 dropped, the bias not added, the halo shifted by one
    voxel in x. The model-level limit has to reject each."""
    plain = c3.conv3d_3x3_plain

    def drop(w, idx):
        w = w.clone()
        w[idx] = 0
        return w

    faults = {
        "tap (0,0,0) dropped": lambda x, w, b=None, layout="oidhw": plain(x, drop(w, (slice(None), slice(None), 0, 0, 0)), b),
        "input channel 0 dropped": lambda x, w, b=None, layout="oidhw": plain(x, drop(w, (slice(None), 0)), b),
        "bias not added": lambda x, w, b=None, layout="oidhw": plain(x, w, None),
        "halo shifted by one in x": lambda x, w, b=None, layout="oidhw": plain(F.pad(x[:, :, :, 1:], (0, 0, 0, 1)), w, b),
    }
    probes = {}
    for name, fn in faults.items():
        c3.conv3d_3x3_plain = fn
        try:
            probes[name] = (model(x, plain=True) - ref).abs().max().item()
        finally:
            c3.conv3d_3x3_plain = plain
    return probes


def phase_rsunet(c3, dev, report):
    log("== phase 10: RSUNet forward at full width, kernel vs plain ==")
    model, window = nucmm_model(dev)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((NUCMM_BATCH, *window, 1), dtype=np.float32))
    x = x.to(dev)
    per_forward = 1 + 2 * (2 * len(model.enc) + 1)  # the stem, two per residual block
    with torch.inference_mode():
        c3.reset_launch_counts()
        out = model(x)
        torch.cuda.synchronize()
        launches = c3.conv3d_3x3.launches
        if launches != per_forward:
            fail(f"one RSUNet forward should launch conv3d_3x3 {per_forward} times, got {launches}")
        if out.shape != (NUCMM_BATCH, *window, 3) or not torch.isfinite(out).all():
            fail(f"RSUNet output not finite or of shape {tuple(out.shape)}")
        ref = model(x, plain=True)
        err, top = (out - ref).abs().max().item(), ref.abs().max().item()
        tol = RSUNET_BF16_TOL * top
        probes = rsunet_fault_probes(c3, model, x, ref)
        for name, perr in probes.items():
            log(f"fault probe ({name}): max error {perr:.4g} against the limit {tol:.4g}")
        if err > tol:
            fail(f"RSUNet bf16 kernel path vs plain: max error {err:.3g} > {tol:.3g} ({RSUNET_BF16_TOL:.0%} of max |ref|)")
        if min(probes.values()) <= tol:
            fail(f"the RSUNet limit {tol:.3g} lets a fault probe pass: {probes}")
        ms = time_ms(lambda: model(x), reps=5, warmup=2)
        plain_ms = time_ms(lambda: model(x, plain=True), reps=3, warmup=1)
    log(f"bf16 batch {NUCMM_BATCH} of {window}: kernel path {ms:.2f} ms, plain path {plain_ms:.2f} ms per forward, max err {err:.4g} "
        f"(max |ref| {top:.3g}); {launches} conv3d launches")
    model32, _ = nucmm_model(dev, "float32")
    with torch.inference_mode():
        out32, ref32 = model32(x), model32(x, plain=True)
    err32, top32 = (out32 - ref32).abs().max().item(), ref32.abs().max().item()
    if err32 > RSUNET_F32_TOL * top32:
        fail(f"RSUNet f32 kernel path vs plain: max error {err32:.3g} > {RSUNET_F32_TOL} of max |ref| {top32:.3g}")
    log(f"f32 batch {NUCMM_BATCH}: max err {err32:.4g} (max |ref| {top32:.3g})")
    report["rsunet"] = dict(
        bf16_ms=ms, bf16_plain_ms=plain_ms, bf16_max_abs_err=err, bf16_max_abs_ref=top, bf16_tol=tol,
        fault_probe_max_abs_err=probes, f32_max_abs_err=err32, f32_max_abs_ref=top32, launches_per_forward=launches,
    )
    del model, model32, out, ref, out32, ref32


def phase_nucmm(c3, dev, work, report):
    log("== phase 11: CLI --mode test of the NucMM-Z recipe ==")
    import logging
    import shutil

    from pytorch_connectomics_tpu_torch.data.io import read_volume
    from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
    from pytorch_connectomics_tpu_torch.models.rsunet import RSUNet
    from pytorch_connectomics_tpu_torch.ops import native
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    shape = NUCMM_SHAPE
    name = f"nuc{shape[0]}x{shape[1]}x{shape[2]}"
    t0 = time.perf_counter()
    img, lbl = synthetic_em_task("em2", shape, seed=3, device=dev)
    gt, n_gt = native.connected_components(lbl > 0, 6)  # instance ground truth
    np.save(work / f"{name}_im.npy", img)
    np.save(work / f"{name}_label.npy", gt)
    setup_s = time.perf_counter() - t0
    del img, lbl, gt
    out_dir = work / f"out_{name}"
    shutil.rmtree(out_dir, ignore_errors=True)
    args = parse_args([
        "--config", str(NUCMM), "--mode", "test", "--device", str(dev), "--output-dir", str(out_dir),
        f"data.test.image={work / f'{name}_im.npy'}", f"data.test.label={work / f'{name}_label.npy'}",
    ])
    records = []  # the test pipeline's own timing and decode log lines

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record)

    forwards = [0]

    def count(module, inputs):
        if isinstance(module, RSUNet):
            forwards[0] += 1

    grab, pipe_log = Grab(), logging.getLogger("pytorch_connectomics_tpu_torch.runtime.test_pipeline")
    pipe_log.addHandler(grab)
    hook = torch.nn.modules.module.register_module_forward_pre_hook(count)
    c3.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = dispatch_runtime(args)
        torch.cuda.synchronize()
    finally:
        hook.remove()
        pipe_log.removeHandler(grab)
    secs = time.perf_counter() - t0
    launches = c3.conv3d_3x3.launches
    per_forward = report["rsunet"]["launches_per_forward"]
    if launches <= 0 or launches != per_forward * forwards[0]:
        fail(f"the NucMM-Z test leg should launch conv3d_3x3 {per_forward} times per forward: {launches} "
             f"launches, {forwards[0]} forwards")
    timing = next(r.args for r in records if str(r.msg).startswith("timing["))
    dec_s, n_inst = next(r.args[1:] for r in records if str(r.msg).startswith("decode["))
    n_inst = int(n_inst)
    preds = sorted(p for p in out_dir.glob("*_prediction.*") if p.suffix in (".h5", ".npy"))
    decs = sorted(p for p in out_dir.glob("*_decoded_*") if p.suffix in (".h5", ".npy"))
    if not preds or not decs:
        fail(f"the NucMM-Z test leg wrote no prediction or decoded volume: {sorted(out_dir.iterdir())}")
    pred, decoded = read_volume(str(preds[0])), read_volume(str(decs[0]))
    if pred.shape != (3, *shape) or not np.isfinite(pred).all() or pred[:2].min() < 0 or pred[:2].max() > 1 \
            or np.abs(pred[2]).max() > 1:
        fail(f"prediction {pred.shape}: not finite, or not sigmoid/sigmoid/tanh channels of shape (3, {shape})")
    if decoded.shape != shape or decoded.dtype != np.uint32:
        fail(f"decoded volume {decoded.shape} {decoded.dtype}, expected {shape} uint32")
    metrics = res["metrics"][name]
    if not {"instance_f1", "ap"} <= metrics.keys():
        fail(f"no instance_f1/ap in {metrics}")
    mvox = math.prod(shape) / secs / 1e6
    _, read_s, pred_s, save_s, decode_s, eval_s = timing
    log(
        f"nucmm {name} on {torch.cuda.get_device_name(0)}: {secs:.2f} s end to end ({mvox:.3f} Mvox/s); "
        f"read+normalise {read_s:.2f} s, predict {pred_s:.2f} s, save {save_s:.2f} s, decode {decode_s:.2f} s "
        f"({n_inst} instances against {n_gt} in the ground truth), evaluate {eval_s:.2f} s; instance_f1 "
        f"{metrics['instance_f1']:.4f}, ap {metrics['ap']:.4f} (random weights: these measure nothing); "
        f"{forwards[0]} forwards, {launches} conv3d launches; volume and ground truth made in {setup_s:.1f} s"
    )
    report["nucmm"] = dict(
        shape=list(shape), seconds=secs, mvox_per_s=mvox, read_s=read_s, predict_s=pred_s, save_s=save_s,
        decode_s=decode_s, decode_logged_s=dec_s, evaluate_s=eval_s, instances=n_inst, gt_instances=n_gt,
        metrics=metrics, forwards=forwards[0], launches=launches, setup_s=setup_s,
        prediction=preds[0].name, decoded=decs[0].name,
    )
    del pred, decoded
    return launches


def phase_probes(dev, work, report):
    log("== phase 12: probes: the measurement entry points, then the fused MLP at MedNeXt-S's widths ==")
    from pytorch_connectomics_tpu_torch.ops import conv3d as c3, depthwise as dwk, fused_mlp as fm, probes as pk
    from pytorch_connectomics_tpu_torch.tools import microbench, probes as probe_tool, randn as seeded

    # the new kernels, and the earlier ones the probes run (the depthwise
    # stencil and tap-matmul prototypes) on the entry points' path
    kernels = fm.KERNELS + pk.KERNELS + (dwk.depthwise3x3, c3.conv3d_3x3)
    for mod in (fm, pk, dwk, c3):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    records = microbench.main(["--out-dir", str(work / "tools")]) + probe_tool.main(["--out-dir", str(work / "tools")])
    torch.cuda.synchronize()
    tools_s = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    if any(v <= 0 for v in counts.values()):
        fail(f"the measurement entry points did not run through every kernel they probe: {counts}")
    # each kernel record holds the kernel's output against its plain version
    bad = [r["name"] for r in records if ("kernel" in r and r["status"] != "OK")
           or not all(math.isfinite(v) for v in r.values() if isinstance(v, float))
           or not all(r[k] > 0 for k in r if k.endswith("ms") and r[k] is not None)]
    if bad:
        fail(f"measurement records failed their check or are not finite and positive: {bad}")
    by_name = {r["name"]: r for r in records}
    ceilings = dict(
        cublas_bf16_tflops=by_name["matmul_8192_bf16"]["tflops"],
        f32_tfma_s=by_name["fma_chain_f32_16384x4096"]["tfma_s"],
        bf16_packed_tfma_s=by_name["fma_chain_bf16_16384x4096"]["tfma_s"],
        copy_GBps=by_name["copy_1GiB_bf16"]["GBps"],
        copy_library_GBps=by_name["copy_1GiB_bf16"]["library_GBps"],
    )
    log(f"entry points ran in {tools_s:.1f} s; launches {counts}")
    for r in records:
        if "kernel" in r:
            lib = "none" if r.get("library_ms") is None else f"{r['library_ms']:.4f}"
            log(f"{r['name']:26s} {r['kernel']:18s} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {lib}, "
                f"bound {r['bound_ms']:.4f} {r['bound_by']}) err {r['max_abs_err']:.3g} (tol: {r['tol']})")
    log("measured ceilings: " + ", ".join(f"{k} {v:.2f}" for k, v in ceilings.items()))

    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    # the fused MLP at MedNeXt-S's widths, on the fast recipe's batch-16 stage row counts
    for dtype in (torch.bfloat16, torch.float32):
        es = 2 if dtype == torch.bfloat16 else 4
        for c, e, spatial, per_fwd in STAGES:
            m = BATCH * math.prod(spatial)
            x = seeded(gen, (m, c), dtype)
            w1, w2 = seeded(gen, (c, e), dtype, c ** -0.5), seeded(gen, (e, c), dtype, e ** -0.5)
            b1, b2 = seeded(gen, (e,), torch.float32, 0.3), seeded(gen, (c,), torch.float32, 0.3)
            got, want = fm.fused_mlp_residual(x, w1, b1, w2, b2), fm.fused_mlp_residual_plain(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if es == 4:
                # f32 sums in another order and another tanh: 1e-5 of the summed magnitudes
                h = F.gelu(x @ w1 + b1, approximate="tanh")
                mag = x.abs() + b2.abs() + (x.abs() @ w1.abs() + b1.abs() + h.abs()) @ w2.abs()
                rel, tol = (err / mag).max().item(), 1e-5
                bad = rel > tol
                del h, mag
            else:
                # the hidden activation and the output are rounded: two ulps at the largest output
                rel, tol = None, 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 6)
                bad = err.max().item() > tol
            if bad:
                fail(f"fused_mlp_residual C={c} E={e} {dtype}: error {err.max().item():.3g} (relative {rel}) over {tol:.3g}")
            b1d, b2d = b1.to(dtype), b2.to(dtype)

            def unfused():  # the cuBLAS sequence: addmm, gelu, addmm, add
                h = F.gelu(torch.addmm(b1d, x, w1), approximate="tanh")
                return x + torch.addmm(b2d, h, w2)

            reps = 10 if m * c > 1e7 else 30
            row = dict(
                kernel="fused_mlp_residual", C=c, E=e, rows=m, dtype=str(dtype).split(".")[-1], blocks_per_forward=per_fwd,
                ms=time_ms(lambda: fm.fused_mlp_residual(x, w1, b1, w2, b2), reps),
                plain_ms=time_ms(lambda: fm.fused_mlp_residual_plain(x, w1, b1, w2, b2), reps),
                unfused_library_ms=time_ms(unfused, reps), **microbench.mlp_bound(m, c, e, es),
                max_abs_err=err.max().item(), max_rel_err=rel, tol=tol,
            )
            rows.append(row)
            log(f"fused_mlp C={c:4d} E={e:5d} M={m:8d} {row['dtype']:8s} {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
                f"unfused cuBLAS {row['unfused_library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"{row['bound_by']}) err {row['max_abs_err']:.3g} <= {tol:.3g}")
            del x, got, want, err
    report["probes"] = dict(tools_seconds=tools_s, launches=counts, ceilings=ceilings, records=records,
                            fused_mlp_widths=rows)
    return records, counts


def probe_line_rows(records, counts):
    """The new kernels' entries of the kernels line, each from the record of
    the entry points' run at the shape it ran: the fused MLP at the
    microbench's stage 0 (8 x 112^3 rows, 32 -> 64, bf16), the pointwise
    conv 32 -> 32 in bf16, the FMA chain in f32 at the card-filling shape,
    the 27-tap FMA, and the lane shift as the 1 GiB copy."""
    src = "pytorch_connectomics_tpu_torch/ops/csrc/"
    by_name = {r["name"]: r for r in records}
    picks = (
        ("fused_mlp_residual", "fused_mlp.cu", "pytorch_connectomics_tpu/ops/fused_mlp_pallas.py:54", "fused_mlp_112c32"),
        ("pointwise", "fused_mlp.cu", "scripts/tpu_bf16_experiments.py:181", "E3_pw_bf16"),
        ("fma_chain", "probes.cu", "scripts/tpu_vpu_probe.py:58", "fma_chain_f32_16384x4096"),
        ("fma27", "probes.cu", "scripts/tpu_microbench.py:171", "vpu_fma27_bf16"),
        ("lane_shift", "probes.cu", "scripts/tpu_bf16_experiments.py:66", "copy_1GiB_bf16"),
    )
    out = []
    for name, file, replaces, record in picks:
        r = by_name[record]
        out.append(dict(
            name=name, route="cuda", source=src + file, replaces=replaces, launches=counts[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
        ))
    return out


def conv3d_line_row(rows, launches):
    """The conv3d kernel's entry of the kernels line, per RSUNet forward
    (batch 8 of 64^3, bf16): each shape's times times its launches."""
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]

    def per_forward(key):
        return sum(r[key] * r["launches_per_forward"] for r in bf16)

    def bound_part(kind):
        return sum(r["bound_parts"][kind] * r["launches_per_forward"] for r in bf16)

    return dict(
        name="conv3d_3x3", route="cuda", source="pytorch_connectomics_tpu_torch/ops/csrc/conv3d_3x3.cu",
        replaces="pytorch_connectomics_tpu/ops/conv3d_pallas.py:84", launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in bf16), ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
        bound_ms=per_forward("bound_ms"), bound_by="bytes" if bound_part("bytes") >= bound_part("ops") else "operations",
        library_ms=per_forward("library_ms"),
    )


def kernel_line_rows(rows, main_counts, dw_rows, dw_counts):
    source = "pytorch_connectomics_tpu_torch/ops/csrc/mednext_block.cu"
    replaces = {
        "dw_stats": "pytorch_connectomics_tpu/ops/fused_block_pallas.py:148",
        "fused_block_apply": "pytorch_connectomics_tpu/ops/fused_block_pallas.py:238",
    }
    kernels = []
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    for name in ("dw_stats", "fused_block_apply"):
        def per_forward(key):
            vals = [r[name][key] for r in bf16]
            if any(v is None for v in vals):
                return None
            return sum(v * r["blocks_per_forward"] for v, r in zip(vals, bf16))

        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces[name],
            launches=main_counts[name],
            max_abs_err=max(r[name]["max_abs_err"] for r in bf16),
            ms=per_forward("ms"), plain_ms=per_forward("plain_ms"), bound_ms=per_forward("bound_ms"),
            bound_by="bytes" if sum(r[name]["bound_parts"]["bytes"] * r["blocks_per_forward"] for r in bf16)
            >= sum(r[name]["bound_parts"]["ops"] * r["blocks_per_forward"] for r in bf16) else "operations",
            library_ms=per_forward("library_ms"),
        ))
    # the depthwise kernels per train step of the main path (synthetic
    # recipe, bf16, no remat): each stride-1 block launches depthwise3x3 for
    # its forward and its input gradient, and depthwise3x3_wgrad once
    main = [r for r in dw_rows if r["dtype"] == "bfloat16" and r["recipe"] == "synthetic"]
    for name, parts in (("depthwise3x3", ("forward", "input_grad")), ("depthwise3x3_wgrad", ("wgrad",))):
        def per_step(key, parts=parts):
            return sum(r[p][key] * r["blocks_per_step"] for r in main for p in parts)

        def bound_part(kind, parts=parts):
            return sum(r[p]["bound_parts"][kind] * r["blocks_per_step"] for r in main for p in parts)

        kernels.append(dict(
            name=name, route="cuda", source="pytorch_connectomics_tpu_torch/ops/csrc/depthwise3x3.cu",
            replaces="pytorch_connectomics_tpu/ops/depthwise_pallas.py:62", launches=dw_counts[name],
            max_abs_err=max(r[p]["max_abs_err"] for r in dw_rows if r["dtype"] == "bfloat16" for p in parts),
            ms=per_step("ms"), plain_ms=per_step("plain_ms"), bound_ms=per_step("bound_ms"),
            bound_by="bytes" if bound_part("bytes") >= bound_part("ops") else "operations",
            library_ms=per_step("library_ms"),
        ))
    return kernels


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    started = time.perf_counter()
    import threading

    from pytorch_connectomics_tpu_torch.ops import build, conv3d as c3, depthwise as dwk, fused_block as fb, native

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
    host = threading.Thread(target=native.build)  # the host decode ops, g++ beside the nvcc builds
    host.start()
    build.build()
    host.join()
    native.get_lib()
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

    dw_rows = phase_depthwise(dwk, dev, report)
    phase_train_step(dwk, fb, dev, report)
    train_counts = phase_cli_train_test(dwk, fb, dev, work, report)

    conv_rows = phase_conv3d(c3, dev, report)
    phase_rsunet(c3, dev, report)
    nucmm_launches = phase_nucmm(c3, dev, work, report)
    phase_predict_profile(dev, work, NUCMM_SHAPE, report, recipe=NUCMM, name="nuc{}x{}x{}".format(*NUCMM_SHAPE),
                          key="nucmm_predict")

    probe_records, probe_counts = phase_probes(dev, work, report)

    log("== phase 13: report ==")
    kernels = kernel_line_rows(rows, main_run["launches"], dw_rows, train_counts)
    kernels.append(conv3d_line_row(conv_rows, nucmm_launches))
    kernels += probe_line_rows(probe_records, probe_counts)
    report["total_seconds"] = time.perf_counter() - started
    log(f"chip_smoke ran in {report['total_seconds']:.1f} s")
    report["kernels"] = kernels
    (work / "chip_smoke.json").write_text(json.dumps(report, indent=2, default=lambda o: o.item()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
