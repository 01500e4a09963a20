"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--phases 9,10,12] [--phases instance] [--phases 15,16] [--phases unet] [--phases nisb]
                          [--phases multitask] [--phases mednext] [--phases training]

With --phases, only phases 1-2 and the listed ones of 3-21 run, and the
last line is the same {"ok": true, ...} object with the phases run; the
kernels line needs every phase and is printed by a full run only.

Phases (any failure exits non-zero; no phase catches its own failure):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile the port's CUDA kernels from the sources in the checkout
  3. kernels  each kernel against its plain PyTorch version at every shape
              the fast recipe launches (batch 16, bf16 and f32), with times
              (kernel, plain, bound, library yardstick) from CUDA events,
              and the plan each kernel took there (band rows, segment,
              ring, unit width, weight chunk; the card's shared memory,
              blocks a SM, grid, registers); then the pair at the stock
              stem's 256-wide windows (MedNeXt-S and -L stage 0 and
              bottleneck, x bands where whole rows do not fit or fit one
              block a SM), against plain and timed, and timed also under
              other plans (a forced plan of narrow x bands at stage 0, the
              cost model's best of every band width, the best whole-row
              plan); and
              the pair's outputs at a fast-recipe stage bit-identical to the
              tree before x bands (tools/ring_digest.py)
  4. model    MedNeXt-S of the fast recipe at full width, seeded init: one
              (16, 96, 128, 96, 1) batch through the kernels and through the
              plain path; 18 launches of each kernel per forward; then
              MedNeXt-S with the stock stem on a (2, 64, 256, 256, 1) batch,
              kernels against plain under the same limit
  5. slice    the port's CLI, --mode test, in-process, on seeded synthetic
              .npy volumes: the Lucchi++ test geometry 165x1024x768 without
              TTA, then 96x256x192 with flip TTA (8 variants); then the
              predict step alone at 165x1024x768, timed and profiled
  6. depthwise the training path's depthwise kernels (forward, input
              gradient with mirrored taps, weight gradient) against their
              plain versions at every stride-1 stage shape of MedNeXt-S
              training (batch 8) on the synthetic and the Lucchi fast
              recipes, bf16 and f32, with times (kernel, plain, bound,
              library yardstick) and the plan each kernel took there
              (band rows, segment, ring; the card's shared memory, blocks
              a SM, grid, registers); two weight-gradient runs bit-identical;
              then a 256-wide training patch's stage 0 and bottleneck (also
              timed under x bands, as phase 3), and the outputs at a
              Lucchi training stage bit-identical to the tree before x bands
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
              bf16 and f32), with times (kernel, plain, bound, F.conv3d),
              TFLOP/s and the ratio to F.conv3d
 10. rsunet   RSUNet at full width ([28,36,48,64], iso), seeded init: one
              (8, 64, 64, 64, 1) batch through the kernel and through the
              plain path, bf16 and f32; 15 launches per forward; four fault
              probes that the bf16 limit must reject
 11. nucmm    the port's CLI, --mode test of tutorials/nuc_nucmm.yaml on a
              seeded synthetic 96x640x640 volume with connected-component
              ground truth: prediction, bcd decode, instance metrics; then
              the predict step alone, timed and profiled
 12. probes   the measurement entry points (tools/microbench.py, tools/probes.py)
              once each, in-process, their kernels' launches counted from
              zero; each kernel record of theirs holds the kernel against
              its plain version at the shape it ran, with times (kernel,
              plain, bound, library; at the FMA chain's (256, 1024) also the
              device time alone and the host us a call), and any record that
              failed fails the phase; the card's measured ceilings from those
              records; then the fused MLP with residual against its plain
              version at MedNeXt-S's five widths (the fast recipe's batch-16
              stage row counts, bf16 and f32): its plan (the planner's, with
              the card's report), back-to-back and device-only times of the
              kernel and of the unfused cuBLAS sequence, and the host us a
              call
 13. recipe   the port's CLI on tutorials/mito_lucchi_tpu_fast.yaml as shipped
              (MedNeXt-S, (1,2,2) stem, bf16, outside_block remat, batch 8
              of 96^3, reject sampling, aug_strong on the host) on a seeded
              synthetic 165x1024x768 volume: --mode train for 12 steps with
              one sample thread, then with cfg.system.num_workers (steps/s,
              the pipeline's host ms per batch, the trainer's wait for data
              and its ms a step besides), then --mode test on a seeded
              165x1024x768 test volume restoring the second checkpoint
 14. instance the affinity instance chain of
              tutorials/synthetic_instance_tune_tpu.yaml (MedNeXt-S, stock
              stem, bf16, 3 affinity channels, batch 8 of 32x64x64): the
              block pair (bf16, f32) and the depthwise kernels (forward,
              input gradient, weight gradient; bf16, f32) against their
              plain versions at its stride-1 stage shapes, timed, with their
              plans; its forward, kernel path against plain (18 launches of
              each pair kernel); then through the CLI on the recipe's seeded
              synthetic://instance volumes, as shipped but for the train
              leg's depth: --mode train (75 steps; it ships 2 epochs of 150),
              --mode tune on volume A (24 TPE trials of
              waterz against VOI), --mode tune-test --best-params on the
              held-out volume B, and the same params on an untrained model's
              prediction of B; fails unless the trained VOI on B is below the
              untrained one's
 15. rsunet-train  RSUNet training's conv kernels: the forward bit-identical
              to the tree before the shared launch path, with the wrapper's
              host us a call (tools/conv3d_digest.py); the input gradient
              (the forward kernel, mirrored and transposed taps) and the
              weight-gradient kernel against their plain versions at every
              3^3 layer shape of the SNEMI recipe (batch 8 of 18x160x160) and
              of the NucMM-Z recipe (batch 8 of 64^3), bf16 and f32, timed in
              bf16 beside their bounds and one PyTorch call each; the weight
              gradient bit-identical across launches and grids; one SNEMI
              train step at full width (bf16, 9 affinity channels): loss and
              per-leaf gradients of the kernel path against the plain path,
              with fault probes the limit must reject, 14 launches of each
              kernel, step time, peak memory and a profile; one NucMM-Z step's
              launches (15, 14, 15)
 16. rsunet-recipes  tutorials/neuron_snemi.yaml through the CLI as shipped
              on seeded synthetic instance volumes made on the card: --mode
              train for 1 epoch of 30 steps (54x480x480), --mode tune on
              volume A (36x320x320, 12 of the 30 TPE trials, adapted Rand),
              --mode tune-test on the held-out B (flip TTA x4, min ensemble,
              waterz, adapted Rand and VOI), and the same params on an
              untrained model's prediction of B; fails unless the trained
              adapted Rand on B is below the untrained one's; then
              tutorials/nuc_nucmm.yaml --mode train for 10 steps on phase
              11's synthetic 96x640x640 volume
 17. unet     the MONAI U-Nets: the conv's kernels (forward, input gradient,
              weight gradient) against their plain versions at each of
              BasicUNet's 18 layer shapes on tutorials/vesicle_xm.yaml (bf16 at
              batch 8 of 16x128x128, timed beside bounds and one PyTorch call;
              f32 at batch 1), Cin 256 in Cin chunks and Cout 256 in column
              blocks; the stock BasicUNet forward and one train step, kernel
              path against plain path (18 forward, 17 input-gradient, 18
              weight-gradient launches; a fault probe the limit must reject),
              step time, peak memory and a profile; UNETR at the schema's
              stock knobs, one forward of batch 2 of 96^3 against plain; then
              through the CLI: tutorials/minimal.yaml train (4 steps) -> test
              (random:// test volumes named on the command line),
              tutorials/synthetic_blobs.yaml train (8 steps) -> test (bump
              blending, overlap 0.25) -> bcd decode -> adapted Rand and VOI,
              and tutorials/vesicle_xm.yaml train (10 steps) -> test (flip TTA
              xy, binary_cc, jaccard / instance F1) on seeded synthetic em2
              128x768x768 volumes (its datasets are not in the repository)
 18. nisb     tutorials/neuron_nisb.yaml (MedNeXt-L, bf16, 3 affinity channels,
              outside_block remat): the block pair (inference batch 8 of
              32x128x128) and the depthwise kernels (training batch 4), bf16
              and f32, against their plain versions at MedNeXt-L's five
              stride-1 stages, timed, with their plans (the C 512 / R 4096
              bottleneck's apply against its plain version logged); the
              forward (54 launches of each pair kernel) and one train step
              (162 depthwise and 54 weight-gradient launches; fault probes),
              kernel path against plain; then through the CLI on seeded
              synthetic://instance volumes made on the card: --mode train
              (2 epochs of 15 steps, 48x384x384), --mode tune on A
              (32x256x256, 3 of the 20 TPE trials on NERL), --mode tune-test
              on the held-out B (72x544x544) chunk by chunk at the shipped
              chunk size and halo (2x2x2 chunks, the last on each axis cut),
              and the same params on an untrained model's B (VOI through
              the CLI, NERL and ERL from the trained leg's skeletons of B's
              ground truth); the prediction
              stage again, resuming (0 chunks recomputed), and with one chunk
              off the manifest (that chunk alone, the file bit-equal); that
              chunk (cut on every axis) kernel path against plain; the whole-volume
              prediction against the chunked one (reported); one trial on A
              split into decode, post-processing, GT skeletons, ERL and VOI;
              fails unless the trained VOI on B is below the untrained one's
              and every NERL lies in [0, 1]
 19. multitask  multi-task MedNeXt-S: the block pair (betaseg's test batch 1 of
              192^3) and the depthwise kernels (its training batch 2 of 192^3,
              and tutorials/neuron_snemi_sdt_multitask.yaml's batch 8 of
              16x160x160, whose stage 0 holds the heads' blocks) against their
              plain versions, bf16, timed, with their plans; betaseg's 3-head
              forward (18 launches of each pair kernel), each head held to the
              f32 plain path as phase 18 holds NISB's, with fault probes; its
              train step as shipped (batch 2 of 192^3, remat: launches, time,
              peak memory); the multi-task step in f32 (per-leaf gradients
              kernel vs plain with fault probes and a bf16 control, the heads'
              launches counted apart inside the step,
              GradNorm's weights over three steps kernel vs plain) and in
              bf16, timed; then through the CLI on seeded volumes made on
              the card: tutorials/mito_betaseg.yaml as shipped but for the
              train leg's depth (2 epochs of 10 steps on synthetic://blobs
              192x256x256, separate objects as mitochondria are), --mode
              test on the held-out blobs 192x576x576 (windows
              of 192^3 at overlap 0.5, output_head aff_r1, affinity_cc,
              min_instance_size 200, adapted Rand, VOI, instance F1) and an
              untrained control (VOI); fails unless the trained VOI is below
              the control's; the host's target time a sample at 192^3; then
              the multi-task recipe at z 16 (its shipped 18 is no multiple of
              16) on synthetic://instance volumes: train (1 epoch of 10 steps
              on 32x480x480, GradNorm weights logged) and test with waterz on
              32x320x320, reported
 20. mednext  the rest of MedNeXt: the k 5 pair (bf16, f32) against its plain
              versions at the fast recipe's five stride-1 stages (batch 16)
              and the 2-D pair ((1, 3, 3) taps embedded in 3^3) at
              tutorials/mito_mitolab.yaml's (batch 16 of 1x256x256), timed
              beside bounds and the library block, with their plans; the k
              5, 2-D, refine-head and hybrid (w0 16) forwards, each held to
              its f32 plain path with fault probes, and the k 5 forward
              against k 3 at batch 16; then through the CLI: the fast
              recipe's UpKern leg (kernel 5 and deep supervision trained 3
              steps from phase 13's kernel-3 checkpoint, or from a 4-step
              kernel-3 leg run here when phase 13 did not run, on a seeded em2
              96x384x384 volume, then --mode test with flip TTA on phase 5's
              165x1024x768 volume, every
              stride-1 block through the k 5 pair), and mito_mitolab.yaml as
              shipped but for aug_standard's missing_section (ROADMAP C.11) on
              seeded em2 volumes made on the card (train 20 steps, test on
              24x1024x1024 with jaccard, dice and instance F1, the untrained
              control, and inference.direct_2d once; fails unless both
              trained legs' jaccard is above the control's)
 21. training the rest of training: tutorials/syn_cremi.yaml (MONAI U-Net
              [28,36,48,64,80], 2 residual units, bf16, batch 8 of
              16x160x160, aug_standard on the host, the polarity target, BCE
              with pos_weight auto plus Dice): the conv's kernels (forward,
              input gradient, weight gradient) against their plain versions
              at each of its stride-1 3^3 layer shapes (bf16, timed beside
              bounds and one PyTorch call), its forward and one train step
              (batch 4) kernel path against plain path (a fault probe; f32
              leaves at batch 2), launches per forward and per step; then through the
              CLI on seeded synthetic://blobs volumes made on the card (odd
              ids pre-, even post-synaptic): train 20 steps on 48x480x480
              (fails unless the loss stays finite and the mean of its last
              five steps is below that of its first five), test the
              held-out 32x320x320 (flip TTA xy, overlap 0.5,
              polarity2instance, instance F1) and the same untrained (instance
              F1 reported, not gated: the image carries no sign of an id's
              parity); the fast recipe's aug_strong on the card against the
              same applies on the CPU with the card's draws (geometric and
              masking transforms bit for bit, intensity within 1e-6) with no
              device-to-host copy, its train step timed with and without
              it, then its train leg (12 steps, phase 13's
              volume) with host augmentation as shipped and with
              data.augmentation.on_device=true (steps/s, wait, device step);
              tutorials/fiber_linghu.yaml's train leg (SoftClDiceLoss, 8 steps);
              the instance recipe's train leg with MalisLoss on its raw
              segmentation (2 steps, the host's pair-count seconds); 4 steps of
              syn_cremi under the step_lr (StepLR each step) and
              reduce_on_plateau (a validation each step, patience 0) profiles
 22. report   a {"kernels": [...]} line, then {"ok": true, "device": ...} last

Imports torch and the port only. Details go to build/chip_smoke/chip_smoke.json.
"""

from __future__ import annotations

import json
import logging
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
# limits of the bf16 train step's kernel path against its plain path: the
# loss, relative; each gradient leaf, as the norm of the difference over the
# leaf's norm (conv_bias leaves, zero in exact arithmetic because GroupNorm
# follows the conv, over the largest leaf norm); PERF.md gives the readings
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 0.05
NUCMM = ROOT / "tutorials" / "nuc_nucmm.yaml"
NUCMM_BATCH = 8
# phase 11's test volume (cut from the Lucchi++ test geometry 165x1024x768 to make room for phase 20, then
# from 128x768x768 for phase 21)
NUCMM_SHAPE = (96, 640, 640)
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


def device_randn(shape, seed, dev, dtype=torch.float32):
    """Seeded standard normal values made on the device (a host draw of a
    192^3 batch takes seconds)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def block_params(rng, c, r, dev, taps=(3, 3, 3)):
    """A block's parameters; ``taps`` the depthwise kernel's (kz, k, k), its
    values scaled to keep dw(x)'s spread at the 3^3 taps' 0.3."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return dict(
        w_dw=t(rng.standard_normal((c, 1, *taps)) * 0.3 * (27 / math.prod(taps)) ** 0.5),
        gamma=t(1.0 + 0.1 * rng.standard_normal(c)),
        beta=t(0.1 * rng.standard_normal(c)),
        w1=t(rng.standard_normal((r, c)) / np.sqrt(c)),
        b1=t(0.1 * rng.standard_normal(r)),
        w2=t(rng.standard_normal((c, r)) / np.sqrt(r)),
        b2=t(0.1 * rng.standard_normal(c)),
    )


def bounds(c, r, spatial, es, batch=BATCH, taps=27):
    """Least times (ms) of one launch of each kernel at ``batch``, split
    into the bytes term (each input read once, each output written once,
    over the HBM rate) and the operations term (CUDA-core FLOP over the f32
    rate, tensor-core FLOP over the bf16 rate, whichever is larger);
    ``taps`` the function's depthwise taps (27, 125, or a 2-D block's 9)."""
    n = batch * math.prod(spatial)
    stencil = 2 * taps * n * c
    stats = dict(
        bytes=(n * c * es + taps * c * 4 + batch * 2 * c * 4) / PEAK_BYTES * 1e3,
        ops=(stencil + 3 * n * c) / PEAK_F32 * 1e3,
    )
    mlp, gelu = 2 * n * 2 * c * r, 10 * n * r
    apply_bytes = 2 * n * c * es + taps * c * 4 + 2 * r * c * es + batch * 2 * c * 4
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
    pad = tuple(k // 2 for k in p["w_dw"].shape[2:])
    t = F.conv3d(x.permute(0, 4, 1, 2, 3), p["w_dw"], padding=pad, groups=c)
    t = F.group_norm(t, c, p["gamma"], p["beta"], eps).permute(0, 2, 3, 4, 1)
    h = F.gelu(F.linear(t, p["w1"], p["b1"]), approximate="tanh")
    return x + F.linear(h, p["w2"], p["b2"])


def pair_row(fb, dev, c, r, spatial, per_fwd, dtype, batch=BATCH, reps=None, taps=(3, 3, 3)):
    """The block pair at one stage: each kernel against its plain version
    (stated tolerances; fails the run beyond them), timed beside its plain
    version, its bound and the library yardstick, with the plan it took;
    ``taps``: (3, 3, 3), (5, 5, 5), or a 2-D block's (1, k, k), which the
    kernels take embedded in k^3."""
    es = 2 if dtype == torch.bfloat16 else 4
    rng = np.random.default_rng(c)
    x = device_randn((batch, *spatial, c), c, dev, dtype)
    p = block_params(rng, c, r, dev, taps)
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
    if not stats_rel <= 1e-5:  # written so that NaN fails
        fail(f"dw_stats C={c} {dtype} taps {taps}: relative error {stats_rel:.3g} > 1e-5")
    err = (out.float() - want.float()).abs().max().item()
    # f32: FMA order. bf16: two bf16 ulps at the output's magnitude; the
    # kernel and the plain version sum in another order, so a value
    # rounded to bf16 (u, h, the output) can land one ulp apart
    top = want.float().abs().max().item()
    tol = 2e-4 if es == 4 else 2.0 ** (math.floor(math.log2(max(top, 1.0))) - 6)
    if not err <= tol:
        fail(f"fused_block_apply C={c} {dtype} taps {taps}: max error {err:.3g} > {tol:.3g}")
    reps = reps or (20 if c >= 128 else 10)
    b_stats, b_apply = bounds(c, r, spatial, es, batch, math.prod(taps))
    row = dict(
        C=c, R=r, spatial=list(spatial), dtype=str(dtype).split(".")[-1], blocks_per_forward=per_fwd,
        taps=list(taps), batch=batch,
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
    # the plans the kernels took (ops/fused_block.py::kernel_plan) and the card's report of each
    row["plan"] = fb.card_plan(tuple(x.shape), dtype, r, k=taps[-1])
    for name, k in row["plan"].items():
        log(f"  plan {name}: " + ", ".join(f"{key} {val}" for key, val in k.items()))
    s, a = row["dw_stats"], row["fused_block_apply"]
    log(
        f"C={c:4d} R={r:5d} {row['dtype']:8s} taps {'x'.join(map(str, taps))} dw_stats {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
        f"bound {s['bound_ms']:.4f}, rel err {stats_rel:.2g}) | apply {a['ms']:.4f} ms (plain "
        f"{a['plain_ms']:.4f}, bound {a['bound_ms']:.4f}, library {a['library_ms']:.4f}, "
        f"err {err:.3g} <= {tol:.3g})"
    )
    del x, p, lib_p, stats, want_stats, out, want
    return row


def phase_kernels(fb, dev, report):
    log("== phase 3: kernels vs plain (batch 16) ==")
    rows = [pair_row(fb, dev, c, r, spatial, per_fwd, dtype)
            for dtype in (torch.bfloat16, torch.float32) for c, r, spatial, per_fwd in STAGES]
    report["kernel_rows"] = rows
    report["wide_pair_rows"] = phase_wide_pair(fb, dev)
    check_digests(dev, ("dw_stats", "fused_block_apply"), report)
    return rows


# (window, B, (Z, Y, X), C, R) of the stride-1 MedNeXt stages on the stock
# stem's 256-wide windows at the tutorials' inference batch: MedNeXt-S on
# neuron_liconn_mit's (64, 256, 256) (the bottleneck's whole rows do not fit
# shared memory: x bands) and MedNeXt-L on mitoem's (32, 256, 256) (R 4096
# at the bottleneck, R 96 at stage 0)
WIDE_STAGES = [
    ("S 64x256x256", 2, (64, 256, 256), 32, 64),
    ("S 64x256x256", 2, (4, 16, 16), 512, 1024),
    ("L 32x256x256", 4, (32, 256, 256), 32, 96),
    ("L 32x256x256", 4, (2, 16, 16), 512, 4096),
]
# plans of x bands narrower than the row (WIDE_TX), forced on the 256-wide
# stage 0: statistics and depthwise (ty, seg, ring), the bf16 apply (ty,
# seg, cs, rc)
WIDE_TX = 48
WIDE_RING_PLAN = dict(ty=2, seg=8, ring=3, tx=WIDE_TX)
WIDE_APPLY_PLAN = dict(ty=2, seg=8, cs=32, rc=32, tx=WIDE_TX)


def whole_rows(fb, plans, x):
    """The best of ``plans`` (the planner's, best first) that takes whole
    rows of ``x``, where the best of all bands x; else None."""
    whole = fb.whole_row(x)
    return None if plans[0]["tx"] == whole else next((p for p in plans if p["tx"] == whole), None)


def plan_keys(plan):
    """What a log and the report keep of a ring plan (None for none)."""
    keys = ("ty", "tx", "seg", "ring", "cs", "rc", "items", "est_clk")
    return None if plan is None else {k: plan[k] for k in keys if k in plan}


def stats_error(fb, x, w_dw, stats, want_stats):
    """dw_stats against its plain version: f32 sums in another order,
    relative to the summed magnitudes (max abs, max rel)."""
    mag = fb.dw_stats_plain(x.abs(), w_dw.abs())[:, :1] + want_stats[:, 1:]
    return (stats - want_stats).abs().max().item(), ((stats - want_stats).abs() / mag).max().item()


def apply_tol(want, es):
    """f32: FMA order. bf16: two bf16 ulps at the output's magnitude."""
    top = want.float().abs().max().item()
    return 2e-4 if es == 4 else 2.0 ** (math.floor(math.log2(max(top, 1.0))) - 6)


def phase_wide_pair(fb, dev):
    """The pair at the 256-wide windows' stages (WIDE_STAGES), bf16 and f32,
    against the plain versions with phase 3's tolerances, timed, with the
    plans taken; also timed under other plans: at stage 0 a forced plan of
    x bands WIDE_TX wide, the cost model's best of every band width
    (``every_width``) where it differs from the planner's, and the best
    whole-row plan where the planner bands x, so that a run shows whether
    the planner's choice between bands and rows holds on the card."""
    log("-- the pair at the stock stem's 256-wide windows --")
    rows = []
    for window, batch, spatial, c, r in WIDE_STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            es = 2 if dtype == torch.bfloat16 else 4
            rng = np.random.default_rng(c + r)
            x = torch.from_numpy(rng.standard_normal((batch, *spatial, c), dtype=np.float32)).to(dev, dtype)
            p = block_params(rng, c, r, dev)
            p.update(w1=p["w1"].to(dtype), w2=p["w2"].to(dtype))
            want_stats = fb.dw_stats_plain(x, p["w_dw"])
            want = fb.fused_block_apply_plain(x, want_stats, **p)
            tol = apply_tol(want, es)
            shape = tuple(x.shape)
            variants = [("planner", None, None)]
            if spatial[2] > WIDE_TX:
                variants.append((f"forced tx {WIDE_TX}", WIDE_RING_PLAN, WIDE_APPLY_PLAN if es == 2 else None))
            s_plans, a_plans = fb.stats_plans(shape, dtype), fb.apply_plans(shape, r, c) if es == 2 else None
            best = (fb.stats_plans(shape, dtype, every_width=True)[0],
                    fb.apply_plans(shape, r, c, every_width=True)[0] if es == 2 else None)
            if best != (s_plans[0], a_plans and a_plans[0]):
                variants.append(("best of every width", *best))
            rows_only = (whole_rows(fb, s_plans, spatial[2]), a_plans and whole_rows(fb, a_plans, spatial[2]))
            if rows_only != (None, None):
                variants.append(("best of whole rows", *rows_only))
            reps = 5
            row = None
            for name, s_plan, a_plan in variants:
                stats = fb.dw_stats(x, p["w_dw"], plan=s_plan)
                out = fb.fused_block_apply(x, want_stats, **p, plan=a_plan)
                torch.cuda.synchronize()
                stats_abs, stats_rel = stats_error(fb, x, p["w_dw"], stats, want_stats)
                err = (out.float() - want.float()).abs().max().item()
                what = f"{window} C={c} R={r} {dtype}" + ("" if name == "planner" else f" {name}")
                if not stats_rel <= 1e-5:  # written so that NaN fails
                    fail(f"dw_stats {what}: relative error {stats_rel:.3g} > 1e-5")
                if not err <= tol:
                    fail(f"fused_block_apply {what}: max error {err:.3g} > {tol:.3g}")
                s_ms = time_ms(lambda: fb.dw_stats(x, p["w_dw"], plan=s_plan), reps)
                if name != "planner":
                    # a kernel without a plan here (the float32 apply) is the planner's row's
                    a_ms = None if a_plan is None else time_ms(
                        lambda: fb.fused_block_apply(x, want_stats, **p, plan=a_plan), reps)
                    band = dict(variant=name, dw_stats_ms=None if s_plan is None else s_ms, apply_ms=a_ms,
                                dw_stats_plan=plan_keys(s_plan), apply_plan=plan_keys(a_plan))
                    row["other_plans"].append(band)
                    log(f"{what}: " + " | ".join(
                        f"{k} {t:.4f} ms ({q})" for k, t, q in (("dw_stats", band["dw_stats_ms"], band["dw_stats_plan"]),
                                                               ("apply", a_ms, band["apply_plan"])) if t is not None)
                        + f"; the planner's {row['dw_stats']['ms']:.4f} | {row['fused_block_apply']['ms']:.4f} ms")
                    continue
                a_ms = time_ms(lambda: fb.fused_block_apply(x, want_stats, **p), reps)
                b_stats, b_apply = bounds(c, r, spatial, es, batch)
                row = dict(
                    window=window, batch=batch, C=c, R=r, spatial=list(spatial), dtype=str(dtype).split(".")[-1],
                    plan=fb.card_plan(shape, dtype, r), other_plans=[],
                    dw_stats=dict(ms=s_ms, plain_ms=time_ms(lambda: fb.dw_stats_plain(x, p["w_dw"]), reps),
                                  bound_ms=max(b_stats.values()), bound_parts=b_stats,
                                  max_abs_err=stats_abs, max_rel_err=stats_rel),
                    fused_block_apply=dict(ms=a_ms,
                                           plain_ms=time_ms(lambda: fb.fused_block_apply_plain(x, want_stats, **p),
                                                            reps),
                                           bound_ms=max(b_apply.values()), bound_parts=b_apply,
                                           max_abs_err=err, tol=tol),
                )
                rows.append(row)
                for kname, k in row["plan"].items():
                    log(f"  plan {kname}: " + ", ".join(f"{key} {val}" for key, val in k.items()))
                sr, ar = row["dw_stats"], row["fused_block_apply"]
                log(f"{what}: dw_stats {sr['ms']:.4f} ms (plain {sr['plain_ms']:.4f}, bound {sr['bound_ms']:.4f}, "
                    f"rel err {stats_rel:.2g}) | apply {ar['ms']:.4f} ms (plain {ar['plain_ms']:.4f}, bound "
                    f"{ar['bound_ms']:.4f}, err {err:.3g} <= {tol:.3g})")
            del x, p, want_stats, want, stats, out
            torch.cuda.empty_cache()
    return rows


def check_digests(dev, prefixes, report):
    """The ring kernels at fixed seeded inputs against the digests of the
    tree before the ring had x bands (tools/ring_digest.py): bit identity
    where whole rows fit."""
    from pytorch_connectomics_tpu_torch.tools import ring_digest

    got = {k: v for k, v in ring_digest.digests(dev).items() if k.startswith(prefixes)}
    want = {k: v for k, v in ring_digest.DIGESTS.items() if k.startswith(prefixes)}
    report.setdefault("digests", {}).update(got)
    if got != want:
        fail(f"ring kernels' outputs differ from the tree before x bands: {got} != {want}")
    log(f"bit-identical to the tree before x bands: {sorted(got)}")


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
    del model, model32, out, ref, out32, ref32
    torch.cuda.empty_cache()
    report["model"]["stock_stem_wide"] = wide_forward(fb, dev)


# a window of neuron_liconn_mit's MedNeXt-S (stock stem), at its inference batch
WIDE_WINDOW, WIDE_BATCH = (64, 256, 256), 2


def wide_forward(fb, dev):
    """MedNeXt-S bf16 with the stock stem on one (64, 256, 256) window,
    batch 2: the fused kernels (x bands at the bottleneck) against the plain
    path, under phase 4's model limit."""
    from pytorch_connectomics_tpu_torch.models import build_model

    cfg = load_model_config()
    cfg.model.mednext.patchify_stem = False
    cfg.model.input_size = list(WIDE_WINDOW)
    model = build_model(cfg.model, device=dev, seed=0)
    shape = (WIDE_BATCH, *WIDE_WINDOW, 1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(shape, dtype=np.float32)).to(dev)
    with torch.inference_mode():
        fb.reset_launch_counts()
        out = model(x)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in fb.KERNELS}
        if any(v != 18 for v in counts.values()):
            fail(f"one stock-stem forward should launch each kernel 18 times, got {counts}")
        ref = model(x, plain=True)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        top = ref.abs().max().item()
        if not torch.isfinite(out).all() or out.shape != shape:
            fail(f"stock-stem model output not finite or of shape {tuple(out.shape)}")
        tol = MODEL_BF16_TOL * max(top, 1.0)
        if not err <= tol:
            fail(f"stock-stem model {shape}: kernel path vs plain max error {err:.3g} > {tol:.3g}")
        ms = time_ms(lambda: model(x), reps=3, warmup=1)
        plain_ms = time_ms(lambda: model(x, plain=True), reps=3, warmup=1)
    log(f"MedNeXt-S stock stem bf16 {shape}: kernel path {ms:.2f} ms, plain path {plain_ms:.2f} ms, "
        f"max err {err:.4g} <= {tol:.4g} (max |ref| {top:.3g}); launches {counts}")
    del model, x, out, ref
    torch.cuda.empty_cache()
    return dict(shape=list(shape), ms=ms, plain_ms=plain_ms, max_abs_err=err, max_abs_ref=top, tol=tol,
                launches_per_forward=counts)


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

    # kernel rows only: operator rows (aten::*) repeat their kernels' time;
    # one averaging pass (each walks every event of the predict)
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:8]
    mvox = math.prod(shape) / secs / 1e6
    log(f"predict {name} (TTA off, warm): {secs:.3f} s ({mvox:.2f} Mvox/s); under the profiler {prof_secs:.3f} s "
        f"with the device busy {busy:.3f} s ({100 * busy / prof_secs:.1f}%)")
    for e in top:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")
    ops = [e for e in averages if e.device_type != DeviceType.CUDA and dev_us(e) > 0]
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


def depthwise_row(dwk, dev, recipe, spatial, c, per_step, dtype, batch, reps=None):
    """The depthwise kernels at one training stage (forward, input gradient
    with mirrored taps, weight gradient twice, bit-identical), each against
    its plain version (stated tolerances; fails the run beyond them), timed
    beside its plain version, its bound and the library yardstick, with the
    plans they took."""
    es = 2 if dtype == torch.bfloat16 else 4
    shape = (batch, *spatial, c)
    n = math.prod(shape[:4])
    rng = np.random.default_rng(c)
    x, dy = device_randn(shape, c, dev, dtype), device_randn(shape, c + 1, dev, dtype)
    w = torch.from_numpy(rng.standard_normal((c, 1, 3, 3, 3)).astype(np.float32) * 0.3).to(dev)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dev)
    wf = w.flip((2, 3, 4))
    row = dict(recipe=recipe, C=c, spatial=list(spatial), dtype=str(dtype).split(".")[-1],
               blocks_per_step=per_step)
    # the input gradient: the kernel's mirror flag against the plain conv with flipped taps
    for name, fn, args in (("forward", dwk.depthwise3x3, (x, w, b)),
                           ("input_grad", dwk.depthwise3x3_input_grad, (dy, w))):
        want_args = args if name == "forward" else (dy, wf, None)
        got, want = fn(*args), dwk.depthwise3x3_plain(*want_args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # f32: FMA order against the summed magnitudes; bf16: both sum
        # in f32 and round once, two ulps at the largest output
        mag = dwk.depthwise3x3_plain(want_args[0].float().abs(), want_args[1].abs()).abs().max().item()
        top = want.float().abs().max().item()
        tol = 1e-5 * mag if es == 4 else 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 6)
        if not err <= tol:  # written so that NaN fails
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
    if not rel <= 1e-5:
        fail(f"depthwise3x3_wgrad {recipe} C={c} {dtype}: relative error {rel:.3g} > 1e-5")
    row["wgrad"] = dict(max_abs_err=max((gw - ww).abs().max().item(), (gb - wb).abs().max().item()),
                        max_rel_err=rel, bit_identical=True)
    reps = reps or (10 if n * c > 1e7 else 30)
    xn, dyn, wd, bd = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3), w.to(dtype), b.to(dtype)
    b_fwd, b_wgrad = dw_bounds(n, c, es)
    row["forward"].update(
        ms=time_ms(lambda: dwk.depthwise3x3(x, w, b), reps),
        plain_ms=time_ms(lambda: dwk.depthwise3x3_plain(x, w, b), reps),
        library_ms=time_ms(lambda: F.conv3d(xn, wd, bd, padding=1, groups=c), reps),
        bound_ms=max(b_fwd.values()), bound_parts=b_fwd,
    )
    row["input_grad"].update(
        ms=time_ms(lambda: dwk.depthwise3x3_input_grad(dy, w), reps),
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
    # the plans the kernels took (ops/depthwise.py::kernel_plan) and the card's report of each
    row["plan"] = dwk.card_plan(shape, dtype)
    for name, k in row["plan"].items():
        log(f"  plan {name}: " + ", ".join(f"{key} {val}" for key, val in k.items()))
    f, g, wg = row["forward"], row["input_grad"], row["wgrad"]
    log(
        f"{recipe:9s} C={c:3d} {row['dtype']:8s} fwd {f['ms']:.4f} ms (plain {f['plain_ms']:.4f}, bound "
        f"{f['bound_ms']:.4f}, library {f['library_ms']:.4f}, err {f['max_abs_err']:.3g}) | dgrad "
        f"{g['ms']:.4f} (library {g['library_ms']:.4f}) | wgrad {wg['ms']:.4f} ms (plain "
        f"{wg['plain_ms']:.4f}, bound {wg['bound_ms']:.4f}, library {wg['library_ms']:.4f}, rel err {rel:.2g})"
    )
    del x, dy, xn, dyn, gw, gb, gw2, gb2, ww, wb, mw, mb
    return row


def phase_depthwise(dwk, dev, report):
    log("== phase 6: depthwise kernels vs plain (batch 8) ==")
    rows = [depthwise_row(dwk, dev, recipe, spatial, c, per_step, dtype, dwk.TRAIN_BATCH)
            for recipe, stages in dwk.TRAIN_STAGES.items() for dtype in (torch.bfloat16, torch.float32)
            for spatial, c, per_step in stages]
    report["depthwise_rows"] = rows
    report["wide_depthwise_rows"] = phase_wide_depthwise(dwk, dev)
    check_digests(dev, ("depthwise3x3",), report)
    return rows


# ((Z, Y, X), C) of the stride-1 MedNeXt-S training stages on
# neuron_liconn_mit's (64, 256, 256) patch (stock stem, batch 2): the 256-wide
# stage 0 and the bottleneck (x bands in f32)
WIDE_DW = [((64, 256, 256), 32), ((4, 16, 16), 512)]
WIDE_DW_BATCH = 2


def phase_wide_depthwise(dwk, dev):
    """The depthwise kernels at WIDE_DW, bf16 and f32, against their plain
    versions with phase 6's tolerances, timed, with the plans taken; also
    timed under other plans, as :func:`phase_wide_pair`."""
    from pytorch_connectomics_tpu_torch.ops import fused_block as fb

    log("-- the depthwise kernels at a 256-wide training patch --")
    rows = []
    for spatial, c in WIDE_DW:
        shape = (WIDE_DW_BATCH, *spatial, c)
        n = math.prod(shape[:4])
        for dtype in (torch.bfloat16, torch.float32):
            es = 2 if dtype == torch.bfloat16 else 4
            rng = np.random.default_rng(c + 1)
            x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
            dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
            w = torch.from_numpy(rng.standard_normal((c, 1, 3, 3, 3)).astype(np.float32) * 0.3).to(dev)
            b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dev)
            wf = w.flip((2, 3, 4))
            want_f = dwk.depthwise3x3_plain(x, w, b)
            want_g = dwk.depthwise3x3_plain(dy, wf)
            ww, wb = dwk.depthwise3x3_wgrad_plain(x, dy)
            mw, mb = dwk.depthwise3x3_wgrad_plain(x.float().abs(), dy.float().abs())
            tols = []
            for args, want in (((x, w), want_f), ((dy, wf), want_g)):
                mag = dwk.depthwise3x3_plain(args[0].float().abs(), args[1].abs()).abs().max().item()
                top = want.float().abs().max().item()
                tols.append(1e-5 * mag if es == 4 else 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 6))
            variants = [("planner", None, None)]
            if spatial[2] > WIDE_TX:
                variants.append((f"forced tx {WIDE_TX}", WIDE_RING_PLAN, WIDE_RING_PLAN))
            found = [dwk.plans(kind, shape, dtype) for kind in (0, 1)]
            best = tuple(dwk.plans(kind, shape, dtype, every_width=True)[0] for kind in (0, 1))
            if best != tuple(f[0] for f in found):
                variants.append(("best of every width", *best))
            rows_only = tuple(whole_rows(fb, f, spatial[2]) for f in found)
            if rows_only != (None, None):
                variants.append(("best of whole rows", *rows_only))
            reps = 5
            row = None
            for name, f_plan, g_plan in variants:
                got_f = dwk.run_fwd(x, w, b, plan=f_plan)
                got_g = dwk.run_fwd(dy, w, mirror=True, plan=f_plan)
                gw, gb = dwk.run_wgrad(x, dy, plan=g_plan)
                torch.cuda.synchronize()
                errs = [(got_f.float() - want_f.float()).abs().max().item(),
                        (got_g.float() - want_g.float()).abs().max().item()]
                rel = max(((gw - ww).abs() / (mw + 1e-30)).max().item(), ((gb - wb).abs() / (mb + 1e-30)).max().item())
                what = f"C={c} {shape} {dtype}" + ("" if name == "planner" else f" {name}")
                for kname, err, tol in zip(("forward", "input_grad"), errs, tols):
                    if not err <= tol:  # written so that NaN fails
                        fail(f"depthwise3x3 {kname} {what}: max error {err:.3g} > {tol:.3g}")
                if not rel <= 1e-5:
                    fail(f"depthwise3x3_wgrad {what}: relative error {rel:.3g} > 1e-5")
                f_ms = time_ms(lambda: dwk.run_fwd(x, w, b, plan=f_plan), reps)
                g_ms = time_ms(lambda: dwk.run_wgrad(x, dy, plan=g_plan), reps)
                if name != "planner":
                    band = dict(variant=name, forward_ms=None if f_plan is None else f_ms,
                                wgrad_ms=None if g_plan is None else g_ms,
                                forward_plan=plan_keys(f_plan), wgrad_plan=plan_keys(g_plan))
                    row["other_plans"].append(band)
                    log(f"{what}: " + " | ".join(
                        f"{k} {t:.4f} ms ({q})" for k, t, q in (("fwd", band["forward_ms"], band["forward_plan"]),
                                                               ("wgrad", band["wgrad_ms"], band["wgrad_plan"]))
                        if t is not None) + f"; the planner's {row['forward']['ms']:.4f} | {row['wgrad']['ms']:.4f} ms")
                    continue
                b_fwd, b_wgrad = dw_bounds(n, c, es)
                row = dict(
                    C=c, spatial=list(spatial), batch=WIDE_DW_BATCH, dtype=str(dtype).split(".")[-1],
                    plan=dwk.card_plan(shape, dtype), other_plans=[],
                    forward=dict(ms=f_ms, plain_ms=time_ms(lambda: dwk.depthwise3x3_plain(x, w, b), reps),
                                 bound_ms=max(b_fwd.values()), bound_parts=b_fwd, max_abs_err=errs[0], tol=tols[0]),
                    input_grad=dict(ms=time_ms(lambda: dwk.depthwise3x3_input_grad(dy, w), reps),
                                    bound_ms=max(b_fwd.values()), max_abs_err=errs[1], tol=tols[1]),
                    wgrad=dict(ms=g_ms, plain_ms=time_ms(lambda: dwk.depthwise3x3_wgrad_plain(x, dy), reps),
                               bound_ms=max(b_wgrad.values()), bound_parts=b_wgrad, max_rel_err=rel),
                )
                rows.append(row)
                for kname, k in row["plan"].items():
                    log(f"  plan {kname}: " + ", ".join(f"{key} {val}" for key, val in k.items()))
                f, g, wg = row["forward"], row["input_grad"], row["wgrad"]
                log(f"{what}: fwd {f['ms']:.4f} ms (plain {f['plain_ms']:.4f}, bound {f['bound_ms']:.4f}) | dgrad "
                    f"{g['ms']:.4f} | wgrad {wg['ms']:.4f} ms (plain {wg['plain_ms']:.4f}, bound {wg['bound_ms']:.4f})")
            del x, dy, want_f, want_g, got_f, got_g, gw, gb, ww, wb, mw, mb
            torch.cuda.empty_cache()
    return rows


def leaf_errors(got, want, near_zero=lambda n: n.endswith("conv_bias")):
    """Per-leaf gradient error: |g - g_ref| / |g_ref| (norms), and for the
    leaves whose gradients nearly cancel (``near_zero``; MedNeXt's
    conv_bias, zero in exact arithmetic because GroupNorm follows the conv)
    |g - g_ref| over the largest leaf norm."""
    top = max(g.norm().item() for g in want.values())
    out = {}
    for n, g in want.items():
        d = (got[n] - g).norm().item()
        out[n] = d / top if near_zero(n) else d / max(g.norm().item(), 1e-30)
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


# the fast recipe's training leg as shipped, cut to FAST_STEPS steps, on
# seeded synthetic volumes of the Lucchi++ geometry
FAST_STEPS = 12  # cut from 20 (PR 11-17) to make room for phase 20
LUCCHI_SHAPE = (165, 1024, 768)


def phase_fast_recipe(dwk, fb, dev, work, report):
    log("== phase 13: the fast recipe trained as shipped through the CLI, then tested ==")
    import shutil

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    run_root = work / "fast_recipe"
    shutil.rmtree(run_root, ignore_errors=True)
    shape = "shape={},{},{}".format(*LUCCHI_SHAPE)
    over = [
        f"data.train.image=synthetic://em2/lucchi_train_image?{shape}&seed=11",
        f"data.train.label=synthetic://em2/lucchi_train_label?{shape}&seed=11",
        f"data.test.image=synthetic://em2/lucchi_test_image?{shape}&seed=12",
        f"data.test.label=synthetic://em2/lucchi_test_label?{shape}&seed=12",
        f"optimization.n_steps_per_epoch={FAST_STEPS}", "optimization.max_epochs=1",
        "monitor.logging.scalar.loss_every_n_steps=5",
    ]
    flags = ["--config", str(RECIPE), "--device", str(dev)]
    cfg = load_config(RECIPE, overrides=over, mode="train")
    aug, dl, m = cfg.data.augmentation, cfg.data.dataloader, cfg.model
    shipped = (aug.enabled and not aug.on_device and aug.elastic and aug.cut_blur and dl.batch_size == 8
               and list(dl.patch_size) == [96, 96, 96] and dl.reject_sampling.get("enabled")
               and m.compute_dtype == "bfloat16" and m.mednext.checkpoint_style == "outside_block"
               and m.mednext.patchify_stem and list(m.mednext.patchify_stride) == [1, 2, 2] and m.mednext.size == "S")
    if not shipped:
        fail("the fast recipe no longer trains MedNeXt-S bf16 (1,2,2) stem, remat, batch 8 of 96^3, aug_strong")
    threads = cfg.system.num_workers

    def train_leg(n):
        """The train leg with ``n`` sample threads: its trainer stats, its
        rate from step 5 on, its losses, its launches and its result."""
        dwk.reset_launch_counts()
        fb.reset_launch_counts()
        leg_over = over + [f"system.num_workers={n}", f"save_path={run_root / f'threads{n}'}"]
        res = dispatch_runtime(parse_args(flags + ["--mode", "train"] + leg_over))
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in dwk.KERNELS + fb.KERNELS}
        if any(k.launches <= 0 for k in dwk.KERNELS):
            fail(f"the fast recipe's train leg did not run through both depthwise kernels: {counts}")
        recs = [json.loads(line) for line in (Path(res["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train_loss_total"] for r in recs if "train_loss_total" in r]
        if len(losses) < 2 or not all(math.isfinite(v) for v in losses):
            fail(f"fast recipe train leg losses missing or not finite: {losses}")
        st = res["train_stats"]
        if st["steps"] != FAST_STEPS or not res["checkpoint"]:
            fail(f"fast recipe train leg: {st['steps']} steps, checkpoint {res['checkpoint']}")
        # the steps after step 5 (each logged rate covers the steps since the last log)
        rates = [(r["step"], r["train_steps_per_sec"]) for r in recs if "train_steps_per_sec" in r]
        late = [(s1 - s0, v) for (s0, _), (s1, v) in zip(rates, rates[1:]) if s0 >= 5]
        stats = dict(threads=n, train_stats=st, steps_per_s=st["steps"] / st["seconds"],
                     steady_steps_per_s=sum(k for k, _ in late) / sum(k / v for k, v in late),
                     pipeline_host_ms_per_batch=st["pipeline_host_seconds"] / max(1, st["pipeline_batches"]) * 1e3,
                     data_wait_ms_per_step=st["data_wait_seconds"] / st["steps"] * 1e3,
                     step_ms=(st["seconds"] - st["data_wait_seconds"]) / st["steps"] * 1e3, losses=losses,
                     launches=counts)
        log(f"train leg (aug_strong on the host, {n} sample thread(s)): {st['steps']} steps in {st['seconds']:.2f} s "
            f"({stats['steps_per_s']:.3f} steps/s, {stats['steady_steps_per_s']:.3f} from step 5), pipeline host "
            f"{stats['pipeline_host_ms_per_batch']:.1f} ms per batch ({st['pipeline_batches']} batches), waited "
            f"{stats['data_wait_ms_per_step']:.1f} ms a step for batches, {stats['step_ms']:.1f} ms a step besides; "
            f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts}")
        return stats, res

    # one sample thread, then the resolved count, whose checkpoint the test leg restores
    legs = {n: train_leg(n) for n in sorted({1, threads})}
    leg, res = legs[threads]
    fb.reset_launch_counts()
    test_over = over + [f"save_path={run_root / f'threads{threads}'}"]
    test_res = dispatch_runtime(parse_args(flags + ["--mode", "test"] + test_over))
    torch.cuda.synchronize()
    test_counts = {k.__name__: k.launches for k in fb.KERNELS}
    restored = test_res.get("restored") or {}
    if restored.get("checkpoint") != res["checkpoint"] or restored.get("step") != FAST_STEPS:
        fail(f"the fast recipe's test leg did not restore {res['checkpoint']}: {restored}")
    if any(v <= 0 for v in test_counts.values()):
        fail(f"the fast recipe's test leg did not run through the fused kernels: {test_counts}")
    metrics = next(iter(test_res["metrics"].values()))
    if "jaccard" not in metrics or not math.isfinite(metrics["jaccard"]):
        fail(f"fast recipe test leg metrics: {metrics}")
    log(f"test leg restored {restored['checkpoint']} (step {restored['step']}, config hash matches: "
        f"{restored.get('config_hash_matches')}, the recipe's train and test sections differ): jaccard "
        f"{metrics['jaccard']:.4f} ({FAST_STEPS} steps: measures nothing); launches {test_counts}")
    report["fast_recipe"] = dict(sample_threads=threads, legs={n: v[0] for n, v in legs.items()},
                                 train_launches=leg["launches"], test_launches=test_counts, restored=restored,
                                 test_metrics=metrics)


# the synthetic instance tune recipe (MedNeXt-S, stock stem, bf16, 3 affinity
# channels, batch 8 of (32, 64, 64)) and the (C, R, (Z, Y, X), blocks per
# forward or train step) of its stride-1 blocks
INSTANCE = ROOT / "tutorials" / "synthetic_instance_tune_tpu.yaml"
INSTANCE_BATCH = 8
# phase 14's train leg: one epoch of INSTANCE_STEPS steps (the recipe ships
# 2 x 150; cut to make room for phase 18)
INSTANCE_STEPS = 75
INSTANCE_STAGES = [
    (32, 64, (32, 64, 64), 4),
    (64, 128, (16, 32, 32), 4),
    (128, 256, (8, 16, 16), 4),
    (256, 512, (4, 8, 8), 4),
    (512, 1024, (2, 4, 4), 2),
]


class LogRecords(logging.Handler):
    """Keeps the port's log records whose message starts with one of
    ``prefixes``, for the numbers they carry in ``args``."""

    def __init__(self, prefixes):
        super().__init__()
        self.prefixes, self.records = prefixes, []

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith(self.prefixes):
            self.records.append(record)

    def take(self, prefix):
        got = [r.args for r in self.records if r.msg.startswith(prefix)]
        self.records = [r for r in self.records if not r.msg.startswith(prefix)]
        return got


def phase_instance(dwk, fb, dev, work, report):
    log("== phase 14: the affinity instance chain: kernels at its shapes, model, CLI train -> tune -> tune-test ==")
    import shutil

    import yaml

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.io import read_volume
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    out = report["instance"] = {}
    # (a) the kernels of this path at its stride-1 stage shapes (batch 8)
    out["pair_rows"] = [pair_row(fb, dev, c, r, spatial, per, dtype, INSTANCE_BATCH)
                        for dtype in (torch.bfloat16, torch.float32) for c, r, spatial, per in INSTANCE_STAGES]
    out["depthwise_rows"] = [depthwise_row(dwk, dev, "instance", spatial, c, per, dtype, INSTANCE_BATCH)
                             for dtype in (torch.bfloat16, torch.float32) for c, _, spatial, per in INSTANCE_STAGES]
    # (b) the 3-channel MedNeXt-S forward, kernel path against plain
    cfg = load_config(INSTANCE, mode="test")
    model = build_model(cfg.model, device=dev, seed=0)
    x = torch.from_numpy(np.random.default_rng(2).random((INSTANCE_BATCH, 32, 64, 64, 1), dtype=np.float32)).to(dev)
    with torch.inference_mode():
        fb.reset_launch_counts()
        y = model(x)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in fb.KERNELS}
        if any(v != 18 for v in counts.values()):
            fail(f"one forward should launch each kernel 18 times, got {counts}")
        ref = model(x, plain=True)
        err, top = (y - ref).abs().max().item(), ref.abs().max().item()
        tol = MODEL_BF16_TOL * max(top, 1.0)
        if not torch.isfinite(y).all() or y.shape != (INSTANCE_BATCH, 32, 64, 64, 3) or not err <= tol:
            fail(f"instance model {tuple(y.shape)}: kernel path vs plain max error {err:.3g} (limit {tol:.3g})")
        ms = time_ms(lambda: model(x), reps=5, warmup=1)
        plain_ms = time_ms(lambda: model(x, plain=True), reps=5, warmup=1)
    out["model"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, max_abs_ref=top, tol=tol,
                        launches_per_forward=counts)
    log(f"MedNeXt-S, 3 affinity channels, bf16 batch 8 of 32x64x64: kernel path {ms:.2f} ms, plain path {plain_ms:.2f} "
        f"ms, max err {err:.4g} <= {tol:.4g}")
    del model, x, y, ref
    torch.cuda.empty_cache()

    # (c) the recipe's three CLI legs as shipped; (d) the tuned params on an
    # untrained model's prediction of B as the control
    run_root, control_root = work / "instance", work / "instance_control"
    for d in (run_root, control_root):
        shutil.rmtree(d, ignore_errors=True)
    vol_b = yaml.safe_load(INSTANCE.read_text())["test"]["data"]["test"]
    held_out = [f"data.test.image={vol_b['image']}", f"data.test.label={vol_b['label']}"]
    flags = ["--config", str(INSTANCE), "--device", str(dev)]
    logs = LogRecords(("timing[", "trial %d/%d"))
    port_log = logging.getLogger("pytorch_connectomics_tpu_torch")
    port_log.addHandler(logs)
    try:
        dwk.reset_launch_counts()
        fb.reset_launch_counts()
        train = dispatch_runtime(parse_args(flags + ["--mode", "train", f"save_path={run_root}",
                                                     "optimization.max_epochs=1",
                                                     f"optimization.n_steps_per_epoch={INSTANCE_STEPS}"]))
        torch.cuda.synchronize()
        train_counts = {k.__name__: k.launches for k in dwk.KERNELS + fb.KERNELS}
        if any(k.launches <= 0 for k in dwk.KERNELS):
            fail(f"the instance train leg did not run through both depthwise kernels: {train_counts}")
        train_stats = train_leg_stats(train)
        st, losses = train_stats["train_stats"], train_stats["losses"]
        if st["steps"] != INSTANCE_STEPS or not train["checkpoint"] \
                or not all(math.isfinite(v) for v in losses):
            fail(f"instance train leg: {st['steps']} steps, checkpoint {train['checkpoint']}, losses {losses}")
        train_stats["launches"] = train_counts
        log(f"train leg: {st['steps']} steps in {st['seconds']:.2f} s ({train_stats['steps_per_s']:.3f} steps/s, "
            f"{train_stats['step_ms']:.1f} ms a step, {train_stats['data_wait_ms_per_step']:.1f} of it waiting for "
            f"batches; pipeline {train_stats['pipeline_host_ms_per_batch']:.1f} ms a batch); losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {train_counts}")

        def leg(mode, root, extra):
            fb.reset_launch_counts()
            t0 = time.perf_counter()
            res = dispatch_runtime(parse_args(flags + ["--mode", mode] + extra + [f"save_path={root}"]))
            torch.cuda.synchronize()
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = {k.__name__: k.launches for k in fb.KERNELS}
            if any(v <= 0 for v in res["launches"].values()):
                fail(f"the {mode} leg did not run through the fused kernels: {res['launches']}")
            return res

        tune = leg("tune", run_root, [])
        if (tune.get("restored") or {}).get("checkpoint") != train["checkpoint"]:
            fail(f"the tune leg did not restore {train['checkpoint']}: {tune.get('restored')}")
        study = yaml.safe_load(Path(tune["best_params"]).read_text())
        trials = [a[4] for a in logs.take("trial %d/%d")]
        (tune_timing,) = logs.take("timing[")
        if len(trials) != 24 or sum(t["state"] == "complete" for t in study["trials"]) < 1:
            fail(f"the tune leg ran {len(trials)} trials: {study['trials']}")
        test = leg("tune-test", run_root, ["--best-params", tune["best_params"], *held_out])
        (test_timing,) = logs.take("timing[")
        control = leg("tune-test", control_root, ["--best-params", tune["best_params"], *held_out])
        logs.take("timing[")
    finally:
        port_log.removeHandler(logs)
    if control.get("restored"):
        fail(f"the control restored a checkpoint: {control['restored']}")
    pred = read_volume(str(next(f for f in Path(test["run_dir"]).iterdir()
                                if f.name.endswith(("_prediction.h5", "_prediction.npy")))))
    if pred.shape != (3, 32, 128, 128) or not np.isfinite(pred).all() or pred.min() < 0 or pred.max() > 1:
        fail(f"tune-test prediction {pred.shape} not finite in [0, 1] of shape (3, 32, 128, 128)")
    scores, control_scores = (next(iter(r["metrics"].values())) for r in (test, control))
    for sc in (scores, control_scores):
        if not ({"voi", "adapted_rand"} <= set(sc) and all(math.isfinite(v) for v in sc.values())):
            fail(f"tune-test metrics: {sc}")
    # the chain learns on the card: the trained model's held-out VOI below the untrained one's
    if not scores["voi"] < control_scores["voi"]:
        fail(f"held-out VOI {scores['voi']:.4f} (trained) is not below {control_scores['voi']:.4f} (untrained)")
    names = ("read+normalise", "predict", "save", "decode", "evaluate")
    out.update(
        train=train_stats,
        tune=dict(seconds=tune["seconds"], timing=dict(zip(names, tune_timing[1:])), trial_seconds=trials,
                  mean_trial_seconds=sum(trials) / len(trials), best_params=study["best_params"],
                  best_voi_a=study["best_value"], launches=tune["launches"]),
        tune_test=dict(seconds=test["seconds"], timing=dict(zip(names, test_timing[1:])), metrics_b=scores,
                       launches=test["launches"]),
        control=dict(metrics_b=control_scores, launches=control["launches"]),
    )
    log(f"tune leg (volume A, {len(trials)} trials): {tune['seconds']:.2f} s, predict {tune_timing[2]:.3f} s, "
        f"{out['tune']['mean_trial_seconds']:.3f} s a trial; best VOI {study['best_value']:.4f} with "
        f"{study['best_params']}; launches {tune['launches']}")
    log(f"tune-test leg (held-out volume B): {test['seconds']:.2f} s, predict {test_timing[2]:.3f} s, decode "
        f"{test_timing[4]:.3f} s, evaluate {test_timing[5]:.3f} s; VOI {scores['voi']:.4f}, adapted Rand "
        f"{scores['adapted_rand']:.4f}; untrained control VOI {control_scores['voi']:.4f}, adapted Rand "
        f"{control_scores['adapted_rand']:.4f}")


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
            row["tflops"] = 2 * 27 * n * cin * cout / row["ms"] * 1e-9
            row["vs_library"] = row["ms"] / row["library_ms"]
            row["plan"] = c3.kernel_plan(tuple(x.shape), cout, dtype)
            rows.append(row)
            log(
                f"{str(spatial):14s} {cin:2d}->{cout:2d} {row['dtype']:8s} {row['ms']:.4f} ms (plain "
                f"{row['plain_ms']:.4f}, F.conv3d {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"{max(bnd, key=bnd.get)}) {row['tflops']:.1f} TFLOP/s, {row['vs_library']:.2f}x F.conv3d "
                f"err {err:.3g} <= {tol:.3g}"
            )
            log("    plan " + " ".join(f"{k}={v}" for k, v in row["plan"].items()))
            del x, w, got, want, xn, wl
    report["conv3d_rows"] = rows
    return rows


def nucmm_model(dev, dtype="bfloat16"):
    """(RSUNet of the NucMM-Z recipe at full width, its window): seeded
    init, with seeded nonzero conv biases (flax's init leaves them 0, and a
    bias left out by a kernel must show)."""
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.models.layers import Conv

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
    from pytorch_connectomics_tpu_torch.models.rsunet import RSUNet
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    shape = NUCMM_SHAPE
    name = f"nuc{shape[0]}x{shape[1]}x{shape[2]}"
    im, lb, setup_s = nucmm_volume(dev, work)
    n_gt = int(np.load(lb, mmap_mode="r").max())  # the components are numbered 1..n
    out_dir = work / f"out_{name}"
    shutil.rmtree(out_dir, ignore_errors=True)
    args = parse_args([
        "--config", str(NUCMM), "--mode", "test", "--device", str(dev), "--output-dir", str(out_dir),
        f"data.test.image={im}", f"data.test.label={lb}",
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


# RSUNet training (phases 15-16): the SNEMI recipe (width [28, 36, 48, 64,
# 80], (1, 2, 2) down factors, depth_2d 1, bf16, 9 affinity channels) on
# batch 8 of its (18, 160, 160) window, and the NucMM-Z recipe
SNEMI = ROOT / "tutorials" / "neuron_snemi.yaml"
SNEMI_BATCH = 8
# ((Z, Y, X), Cin, Cout, launches per step) of RSUNet's 3^3 convs on the
# SNEMI recipe's window (the (1, 3, 3) level 0 runs in F.conv3d)
SNEMI_CONV_SHAPES = [
    ((18, 80, 80), 28, 36, 1),
    ((18, 80, 80), 36, 36, 3),
    ((18, 40, 40), 36, 48, 1),
    ((18, 40, 40), 48, 48, 3),
    ((18, 20, 20), 48, 64, 1),
    ((18, 20, 20), 64, 64, 3),
    ((18, 10, 10), 64, 80, 1),
    ((18, 10, 10), 80, 80, 1),
]
# the CLI legs of phase 16: SNEMI train on a synthetic instance volume for
# SNEMI_EPOCHS x SNEMI_STEPS steps (cut from 10 epochs to make room for
# phase 18; the profile's 3 warmup epochs are clamped to the run), tune on
# volume A with SNEMI_TRIALS of the recipe's 30 trials, tune-test on the
# held-out B; NucMM-Z train for NUCMM_TRAIN_STEPS steps
SNEMI_TRAIN_SHAPE = (54, 480, 480)
SNEMI_TUNE_SHAPE = (36, 320, 320)
SNEMI_EPOCHS, SNEMI_STEPS, SNEMI_TRIALS = 1, 30, 12
NUCMM_TRAIN_STEPS = 10
# limits of the bf16 RSUNet train step's kernel path against its plain path:
# the loss, relative; each gradient leaf as the norm of the difference over
# the leaf's norm (the convs' biases, whose gradients GroupNorm nearly
# cancels, over the largest leaf norm); PERF.md gives the readings
RSUNET_TRAIN_LOSS_TOL = 1e-3
RSUNET_TRAIN_GRAD_TOL = 0.05


def conv_counts(c3):
    """The dense conv's launches since the last reset: forward (the input
    gradient's launches of the forward kernel taken out), input gradient and
    weight gradient."""
    return dict(forward=c3.conv3d_3x3.launches - c3.conv3d_3x3_input_grad.launches,
                input_grad=c3.conv3d_3x3_input_grad.launches, wgrad=c3.conv3d_3x3_wgrad.launches)


def wgrad_bounds(n, cin, cout, es):
    """Least times (ms) of one weight-gradient launch on n voxels, as (bytes
    term, operations term): x and dy read once and dW (f32) written once
    over the HBM rate; 2 * 27 * Cin * Cout FLOP per voxel over the bf16
    tensor-core rate (f32: the CUDA-core rate)."""
    moved = n * (cin + cout) * es + 27 * cin * cout * 4
    flop = 2 * 27 * n * cin * cout
    return dict(bytes=moved / PEAK_BYTES * 1e3, ops=flop / (PEAK_BF16_TC if es == 2 else PEAK_F32) * 1e3)


def conv_backward_row(c3, dev, recipe, spatial, cin, cout, per_step, dtype, batch):
    """The conv's three kernels at one layer shape of a training step: the
    forward, the input gradient (the forward kernel with mirrored,
    transposed taps) and the weight gradient, each held against its plain
    version (bf16 dx two ulps at the largest value, f32 1e-5 of the summed
    magnitudes; dW 1e-4 of the summed magnitudes), and in bf16 timed beside
    its plain version, its bound and one PyTorch call of the same function
    (F.conv3d, conv3d_input, conv3d_weight on channels-last)."""
    es = 2 if dtype == torch.bfloat16 else 4
    rng = np.random.default_rng(7 * cin + cout)
    x = torch.from_numpy(rng.standard_normal((batch, *spatial, cin), dtype=np.float32)).to(dev, dtype)
    dy = torch.from_numpy(rng.standard_normal((batch, *spatial, cout), dtype=np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(dev)
    what = f"{recipe} {spatial} {cin}->{cout} {str(dtype).split('.')[-1]}"
    got_g, want_g = c3.conv3d_3x3_input_grad(dy, w), c3.conv3d_3x3_input_grad_plain(dy, w)
    got_w, want_w = c3.conv3d_3x3_wgrad(x, dy), c3.conv3d_3x3_wgrad_plain(x, dy)
    torch.cuda.synchronize()
    err_g = (got_g.float() - want_g.float()).abs().max().item()
    if es == 4:
        mag = c3.conv3d_3x3_input_grad_plain(dy.abs(), w.abs())
        rel_g, tol_g = ((got_g - want_g).abs() / mag.clamp_min(1e-30)).max().item(), 1e-5
        bad = rel_g > tol_g
        del mag
    else:
        rel_g, tol_g = None, 2.0 ** (math.floor(math.log2(want_g.float().abs().max().item())) - 6)
        bad = err_g > tol_g
    if bad:
        fail(f"conv3d input gradient {what}: error {err_g:.3g} (relative {rel_g}) over {tol_g:.3g}")
    mag = c3.conv3d_3x3_wgrad_plain(x.abs(), dy.abs())
    # taps that read only the zero halo (z of 1) have no magnitude: there the error must be 0
    rel_w = ((got_w - want_w).abs() / mag.clamp_min(1e-30)).max().item()
    err_w = (got_w - want_w).abs().max().item()
    if not rel_w <= 1e-4:
        fail(f"conv3d_3x3_wgrad {what}: error {err_w:.3g}, relative to the summed magnitudes {rel_w:.3g} > 1e-4")
    del mag, want_g, want_w
    row = dict(recipe=recipe, spatial=list(spatial), cin=cin, cout=cout, dtype=str(dtype).split(".")[-1],
               launches_per_step=per_step, input_grad=dict(max_abs_err=err_g, max_rel_err=rel_g, tol=tol_g),
               wgrad=dict(max_abs_err=err_w, max_rel_err=rel_w, tol=1e-4))
    if es == 4:
        log(f"{what}: dx err {err_g:.3g} (relative {rel_g:.3g}), dW relative {rel_w:.3g}")
        return row
    n = batch * math.prod(spatial)
    xn, dyn = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)  # channels_last_3d, as the yardstick takes them
    wl, bl = w.to(dtype).contiguous(memory_format=torch.channels_last_3d), b.to(dtype)
    wmat = c3.kernel_weight(w, dtype)
    mmat = c3.kernel_weight(c3.mirror_weight(w), dtype)
    reps = 10 if n * max(cin, cout) > 1e7 else 30
    b_f, b_g, b_w = conv_bounds(n, cin, cout, es), conv_bounds(n, cout, cin, es), wgrad_bounds(n, cin, cout, es)
    row.update(
        forward=dict(ms=time_ms(lambda: c3.conv3d_3x3(x, w, b, wmat=wmat), reps),
                     library_ms=time_ms(lambda: F.conv3d(xn, wl, bl, padding=1), reps),
                     bound_ms=max(b_f.values()), bound_parts=b_f),
        input_grad=dict(row["input_grad"], ms=time_ms(lambda: c3.conv3d_3x3_input_grad(dy, w, wmat=mmat), reps),
                        plain_ms=time_ms(lambda: c3.conv3d_3x3_input_grad_plain(dy, w), 3),
                        library_ms=time_ms(lambda: torch.nn.grad.conv3d_input(xn.shape, wl, dyn, padding=1), reps),
                        bound_ms=max(b_g.values()), bound_parts=b_g),
        wgrad=dict(row["wgrad"], ms=time_ms(lambda: c3.conv3d_3x3_wgrad(x, dy), reps),
                   plain_ms=time_ms(lambda: c3.conv3d_3x3_wgrad_plain(x, dy), 3),
                   library_ms=time_ms(lambda: torch.nn.grad.conv3d_weight(xn, wl.shape, dyn, padding=1), reps),
                   bound_ms=max(b_w.values()), bound_parts=b_w, plan=c3.wgrad_plan(tuple(x.shape), cout, dtype)),
    )
    f, g, wg = row["forward"], row["input_grad"], row["wgrad"]
    log(f"{what}: fwd {f['ms']:.4f} ms (F.conv3d {f['library_ms']:.4f}, bound {f['bound_ms']:.4f}) | dx "
        f"{g['ms']:.4f} (plain {g['plain_ms']:.3f}, conv3d_input {g['library_ms']:.4f}, bound {g['bound_ms']:.4f}) | "
        f"dW {wg['ms']:.4f} (plain {wg['plain_ms']:.3f}, conv3d_weight {wg['library_ms']:.4f}, bound "
        f"{wg['bound_ms']:.4f} {max(b_w, key=b_w.get)}); dx err {err_g:.3g} <= {tol_g:.3g}, dW relative {rel_w:.3g}")
    log("    wgrad plan " + " ".join(f"{k}={v}" for k, v in wg["plan"].items()))
    return row


def rsunet_train_setup(recipe, dev, overrides=()):
    """(cfg, model, orchestrator, batch) of a recipe's RSUNet train step at
    full width on a seeded synthetic instance volume, batch 8 of its
    window, with the recipe's own targets."""
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
    from pytorch_connectomics_tpu_torch.data.targets.build import affinity_target_groups, build_target_fn
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model

    cfg = load_config(recipe, overrides=list(overrides), mode="train")
    model = build_model(cfg.model, device=dev, seed=0)
    orch = LossOrchestrator(cfg.model.loss, affinity_groups=affinity_target_groups(cfg.data.label_transform))
    z, y, x = cfg.data.dataloader.patch_size
    img, seg = synthetic_em_task("instance", (z, 2 * y, 4 * x), seed=5, device=dev)
    crops = [(slice(0, z), slice(i * y, (i + 1) * y), slice(j * x, (j + 1) * x)) for i in range(2) for j in range(4)]
    target = build_target_fn(cfg.data.label_transform)
    xs = np.stack([img[c] / np.float32(255.0) for c in crops])[..., None].astype(np.float32)
    ys = np.stack([np.moveaxis(target(seg[c]), 0, -1) for c in crops]).astype(np.float32)
    batch = {"image": torch.from_numpy(xs).to(dev), "label": torch.from_numpy(ys).to(dev)}
    return cfg, model, orch, batch


def phase_rsunet_train(c3, dev, report):
    log("== phase 15: RSUNet training: the conv's backward kernels at every layer shape, the SNEMI train step ==")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_connectomics_tpu_torch.tools import conv3d_digest
    from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
    from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

    out = report["rsunet_train"] = {}
    # (a) the forward through the cached launch path: its outputs are the
    # tree before's bit for bit, and the wrapper's host time a call
    dig = conv3d_digest.run(dev, host=True)
    if dig["digests"] != conv3d_digest.DIGESTS:
        bad = sorted(k for k, v in dig["digests"].items() if conv3d_digest.DIGESTS.get(k) != v)
        fail(f"conv3d_3x3 forward outputs differ from the tree before the shared launch path: {bad}")
    out["forward_host_us"] = dig["host_us"]
    log("conv3d_3x3 forward bit-identical to the tree before at 24 cases; host us a call: "
        + ", ".join(f"{k} {v:.1f}" for k, v in dig["host_us"].items()))
    # (b) the backward kernels at every 3^3 layer shape of both recipes
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for recipe, shapes in (("snemi", SNEMI_CONV_SHAPES), ("nucmm", CONV_SHAPES)):
            for spatial, cin, cout, per in shapes:
                rows.append(conv_backward_row(c3, dev, recipe, spatial, cin, cout, per, dtype, SNEMI_BATCH))
                torch.cuda.empty_cache()
    out["rows"] = rows
    # (c) the weight gradient is the same bits from launch to launch and on any grid
    for shape in ((SNEMI_BATCH, 18, 80, 80, 28, 36), (SNEMI_BATCH, 64, 64, 64, 1, 28)):
        for dtype in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(3)
            x = torch.from_numpy(rng.standard_normal(shape[:5], dtype=np.float32)).to(dev, dtype)
            dy = torch.from_numpy(rng.standard_normal((*shape[:4], shape[5]), dtype=np.float32)).to(dev, dtype)
            first = c3.conv3d_3x3_wgrad(x, dy)
            for grid in (None, 1, 7, 1000):
                if not torch.equal(first, c3.conv3d_3x3_wgrad(x, dy, grid=grid)):
                    fail(f"conv3d_3x3_wgrad {shape} {dtype} differs from launch to launch (grid {grid})")
    log("conv3d_3x3_wgrad bit-identical across launches and grids 1, 7, 1000 and the default")
    # (d) one SNEMI train step at full width: kernel path against plain, launches, time
    from pytorch_connectomics_tpu_torch.models.layers import Conv

    cfg, model, orch, batch = rsunet_train_setup(SNEMI, dev)
    biases = {f"{n}.bias" for n, m in model.named_modules() if isinstance(m, Conv)}
    x, y = batch["image"], batch["label"]
    if cfg.model.compute_dtype != "bfloat16" or x.shape != (SNEMI_BATCH, 18, 160, 160, 1) or y.shape[-1] != 9:
        fail(f"the SNEMI recipe no longer trains bf16 on batch 8 of (18, 160, 160) with 9 channels: {tuple(y.shape)}")

    def loss_and_grads(plain):
        model.zero_grad(set_to_none=True)
        loss, _ = orch(model(x, plain=plain), y)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    c3.reset_launch_counts()
    loss_k, g_k = loss_and_grads(False)
    torch.cuda.synchronize()
    counts = conv_counts(c3)
    if counts != dict(forward=14, input_grad=14, wgrad=14):
        fail(f"one SNEMI train step should launch 14 forward, 14 input-gradient and 14 weight-gradient convs: {counts}")
    loss_p, g_p = loss_and_grads(True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs = leaf_errors(g_k, g_p, biases.__contains__)
    worst = max(errs, key=errs.get)
    log(f"SNEMI step: loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel err {loss_err:.3g}); worst leaf {worst} "
        f"{errs[worst]:.4g} (limit {RSUNET_TRAIN_GRAD_TOL}); launches {counts}")
    if not math.isfinite(loss_k) or loss_err > RSUNET_TRAIN_LOSS_TOL:
        fail(f"SNEMI train step loss: kernel {loss_k} vs plain {loss_p} (rel err {loss_err:.3g})")
    if errs[worst] > RSUNET_TRAIN_GRAD_TOL:
        fail(f"SNEMI train step gradient {worst}: error {errs[worst]:.3g} > {RSUNET_TRAIN_GRAD_TOL}")
    # fault probes on the kernel path that the gradient limit must reject
    wgrad, igrad = c3.conv3d_3x3_wgrad, c3.conv3d_3x3_input_grad
    def drop_tap(xx, dd, grid=None):
        g = wgrad(xx, dd).clone()
        g[:, :, 0, 0, 0] = 0
        return g

    def unmirrored(dd, ww, wmat=None):
        return igrad(dd, ww.flip(2, 3, 4))

    faults = {"dW tap (0,0,0) dropped": ("conv3d_3x3_wgrad", drop_tap),
              "dx taps not mirrored": ("conv3d_3x3_input_grad", unmirrored)}
    drop_tap.launches = unmirrored.launches = 0  # the wrappers count under the names they replace
    probes = {}
    for name, (attr, fn) in faults.items():
        saved = getattr(c3, attr)
        setattr(c3, attr, fn)
        try:
            probes[name] = max(leaf_errors(loss_and_grads(False)[1], g_p, biases.__contains__).values())
        finally:
            setattr(c3, attr, saved)
        log(f"fault probe ({name}): worst leaf error {probes[name]:.4g} against the limit {RSUNET_TRAIN_GRAD_TOL}")
    if min(probes.values()) <= RSUNET_TRAIN_GRAD_TOL:
        fail(f"the gradient limit {RSUNET_TRAIN_GRAD_TOL} lets a fault probe pass: {probes}")
    opt, schedule = build_optimizer(cfg.optimization, model, cfg.optimization.n_steps_per_epoch)
    state = create_train_state(model, opt)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val)
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        logs = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(float(v)) for v in logs.values()):
        fail(f"SNEMI train step logs not finite: {logs}")
    t0 = time.perf_counter()
    for _ in range(2):
        loss_and_grads(True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 2 * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:12]
    # the weight gradient's wgmma kernels by name, in top_kernels where the twelve largest leave them out
    wg_events = [e for e in events if "conv3d_wgrad_wgmma_kernel" in e.key]
    if not wg_events:
        fail("the SNEMI step's profile shows no conv3d_wgrad_wgmma_kernel")
    top += [e for e in wg_events if e not in top]
    snemi_bf16 = [r for r in rows if r["recipe"] == "snemi" and r["dtype"] == "bfloat16"]
    per_step = {k: sum(r[k]["ms"] * r["launches_per_step"] for r in snemi_bf16)
                for k in ("forward", "input_grad", "wgrad")}
    log(f"SNEMI train step bf16 batch 8 of (18, 160, 160): {step_ms:.1f} ms (plain forward+backward {plain_ms:.1f} "
        f"ms), peak memory {peak / 2**30:.2f} GiB; the 3^3 convs' kernels a step: forward {per_step['forward']:.2f} "
        f"ms, input gradient {per_step['input_grad']:.2f} ms, weight gradient {per_step['wgrad']:.2f} ms")
    log(f"one step under the profiler: {prof_ms:.1f} ms, kernels {busy_ms:.1f} ms of device time; the weight "
        f"gradient's wgmma kernels {sum(dev_us(e) for e in wg_events) / 1e3:.2f} ms in "
        f"{sum(e.count for e in wg_events)} launches")
    for e in top:
        log(f"  {dev_us(e) / 1e3:8.2f} ms  {e.count:5d}x  {e.key[:90]}")
    out["snemi_step"] = dict(
        step_ms=step_ms, plain_fwd_bwd_ms=plain_ms, peak_memory_bytes=peak, launches_per_step=counts,
        kernel_ms_per_step=per_step, loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_err,
        grad_leaf_errors=errs, worst_leaf=worst, grad_tol=RSUNET_TRAIN_GRAD_TOL, fault_probe_leaf_errors=probes,
        profiled_ms=prof_ms, device_busy_ms=busy_ms,
        top_kernels=[dict(name=e.key, device_ms=dev_us(e) / 1e3, count=e.count) for e in top],
    )
    del model, opt, state, g_k, g_p, batch, x, y
    torch.cuda.empty_cache()
    # (e) one NucMM-Z train step: its launches (the stem's input gradient is skipped)
    cfg, model, orch, batch = rsunet_train_setup(NUCMM, dev)
    c3.reset_launch_counts()
    loss, _ = orch(model(batch["image"]), batch["label"])
    loss.backward()
    torch.cuda.synchronize()
    counts = conv_counts(c3)
    if counts != dict(forward=15, input_grad=14, wgrad=15) or not math.isfinite(loss.item()):
        fail(f"one NucMM-Z train step should launch 15, 14 and 15 convs with a finite loss: {counts}, {loss.item()}")
    log(f"NucMM-Z train step bf16 batch 8 of 64^3: loss {loss.item():.4f}, launches {counts}")
    out["nucmm_step"] = dict(loss=loss.item(), launches_per_step=counts)
    del model, batch, loss
    torch.cuda.empty_cache()
    return rows


# the MONAI U-Net recipes (phase 17)
VESICLE = ROOT / "tutorials" / "vesicle_xm.yaml"
MINIMAL = ROOT / "tutorials" / "minimal.yaml"
BLOBS = ROOT / "tutorials" / "synthetic_blobs.yaml"
VESICLE_BATCH = 8
VESICLE_SHAPE = (128, 768, 768)  # cut from 165x1024x768 to make room for phase 20
VESICLE_STEPS = 10
# ((Z, Y, X), Cin, Cout, launches per forward) of BasicUNet's 3^3 convs at
# vesicle_xm's (16, 128, 128) window, stock features [32, 32, 64, 128, 256, 32]:
# the encoder's two convs a level, then the decoder's (after the upcat)
UNET_CONV_SHAPES = [
    ((16, 128, 128), 1, 32, 1), ((16, 128, 128), 32, 32, 2), ((16, 128, 128), 64, 32, 1),
    ((8, 64, 64), 32, 32, 3), ((8, 64, 64), 64, 32, 1),
    ((4, 32, 32), 32, 64, 1), ((4, 32, 32), 64, 64, 2), ((4, 32, 32), 128, 64, 1),
    ((2, 16, 16), 64, 128, 1), ((2, 16, 16), 128, 128, 2), ((2, 16, 16), 256, 128, 1),
    ((1, 8, 8), 128, 256, 1), ((1, 8, 8), 256, 256, 1),
]
# limits of the U-Nets' kernel path against their plain path. bf16: the
# forward as a share of max |plain output|, the train step's loss (relative)
# and its whole gradient (the norm of the difference over all leaves over the
# norm of all leaves): a deep leaf's gradient is the small remainder of
# cancellations in the instance norms' backward, where one path's bf16
# roundings move it by 10-30% (PERF.md), so single leaves are held in f32:
# the f32 step's leaves each UNET_F32_GRAD_TOL over their norm or, under
# UNET_SMALL_LEAF of the largest leaf's norm (the conv biases that instance
# norm cancels), over that share of the largest (the same cancellations
# leave f32 sums in another order 0.3% apart there; a dropped tap moves a
# leaf about 20%). PERF.md gives the readings
UNET_BF16_TOL = 0.03
UNET_TRAIN_LOSS_TOL = 1e-3
UNET_TRAIN_GRAD_TOL = 0.05
UNET_SMALL_LEAF = 0.01
UNET_F32_GRAD_TOL = 1e-2


def unet_leaf_errors(got, want, floor):
    """Per-leaf |g - g_ref| / max(|g_ref|, floor * largest |g_ref|), each
    leaf's norm as a share of the largest, and the whole gradient's error
    |g - g_ref| / |g_ref| over all leaves."""
    top = max(g.norm().item() for g in want.values())
    errs = {n: (got[n] - g).norm().item() / max(g.norm().item(), floor * top) for n, g in want.items()}
    whole = math.sqrt(sum((got[n] - g).norm().item() ** 2 for n, g in want.items())
                      / sum(g.norm().item() ** 2 for g in want.values()))
    return errs, {n: g.norm().item() / top for n, g in want.items()}, whole


def unet_conv_row(c3, dev, spatial, cin, cout, per_fwd, dtype, batch, recipe="vesicle"):
    """The conv's three kernels at one BasicUNet layer shape: the forward
    against its plain version (bf16 two ulps at the largest output, f32 1e-5
    of the summed magnitudes) with its plan (Cin chunks past one launch's
    weight slice), then the input and weight gradients
    (:func:`conv_backward_row`: checked, and in bf16 timed)."""
    es = 2 if dtype == torch.bfloat16 else 4
    rng = np.random.default_rng(11 * cin + cout)
    x = torch.from_numpy(rng.standard_normal((batch, *spatial, cin), dtype=np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(dev)
    got, want = c3.conv3d_3x3(x, w, b), c3.conv3d_3x3_plain(x, w, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if es == 4:
        mag = c3.conv3d_3x3_plain(x.abs(), w.abs()) + b.abs()
        rel, tol = ((got - want).abs() / mag.clamp_min(1e-30)).max().item(), 1e-5
        bad = rel > tol
        del mag
    else:
        rel, tol = None, 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 6)
        bad = err > tol
    what = f"{recipe} {spatial} {cin}->{cout} {str(dtype).split('.')[-1]} batch {batch}"
    if bad:
        fail(f"conv3d_3x3 {what}: error {err:.3g} (relative {rel}) over {tol:.3g}")
    plan = c3.kernel_plan(tuple(x.shape), cout, dtype)
    plain_ms = time_ms(lambda: c3.conv3d_3x3_plain(x, w, b), 3) if es == 2 else None
    del x, w, b, got, want
    row = conv_backward_row(c3, dev, recipe, spatial, cin, cout, per_fwd, dtype, batch)
    row["forward"] = dict(row.get("forward", {}), max_abs_err=err, max_rel_err=rel, tol=tol, plan=plan,
                          plain_ms=plain_ms)
    log(f"    forward plan: {plan['chunks']} Cin chunk(s) of {plan['cin_chunk']}, tile {plan['xs']}x{plan['r']}, "
        f"warp {plan['warp_m']}x{plan['warp_n']}, {plan['buffers']} buffer(s); err {err:.3g} <= {tol:.3g}")
    return row


def unet_step_batch(cfg, dev):
    """Batch 8 of vesicle_xm's (16, 128, 128) patch from a seeded synthetic
    em2 volume made on the card, with the recipe's binary target."""
    from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
    from pytorch_connectomics_tpu_torch.data.targets.build import build_target_fn

    z, y, x = cfg.data.dataloader.patch_size
    img, lbl = synthetic_em_task("em2", (z, 2 * y, 4 * x), seed=5, device=dev)
    crops = [(slice(0, z), slice(i * y, (i + 1) * y), slice(j * x, (j + 1) * x)) for i in range(2) for j in range(4)]
    target = build_target_fn(cfg.data.label_transform)
    xs = np.stack([img[c] / np.float32(255.0) for c in crops])[..., None].astype(np.float32)
    ys = np.stack([np.moveaxis(target(lbl[c]), 0, -1) for c in crops]).astype(np.float32)
    return {"image": torch.from_numpy(xs).to(dev), "label": torch.from_numpy(ys).to(dev)}


def phase_unet(c3, dev, work, report):
    log("== phase 17: the MONAI U-Nets: BasicUNet's conv shapes, the vesicle_xm step, UNETR, the three recipes ==")
    import shutil

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.io import read_volume
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.models.layers import Conv
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime
    from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
    from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

    out = report["unet"] = {}
    t_phase = time.perf_counter()

    def lap(what):
        out.setdefault("seconds", {})[what] = time.perf_counter() - t_phase
        log(f"-- {what}: {out['seconds'][what]:.1f} s into phase 17")

    # (a) the conv's kernels at every BasicUNet layer shape: bf16 at the recipe's batch, f32 at batch 1
    rows = []
    for dtype, batch in ((torch.bfloat16, VESICLE_BATCH), (torch.float32, 1)):
        for spatial, cin, cout, per in UNET_CONV_SHAPES:
            rows.append(unet_conv_row(c3, dev, spatial, cin, cout, per, dtype, batch))
            torch.cuda.empty_cache()
    out["conv_rows"] = rows
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    per_fwd = {k: sum(r[k]["ms"] * r["launches_per_step"] for r in bf16) for k in ("forward", "input_grad", "wgrad")}
    per_fwd["stem_input_grad"] = sum(r["input_grad"]["ms"] for r in bf16 if r["cin"] == 1)  # not run in training
    bounds = {k: sum(r[k]["bound_ms"] * r["launches_per_step"] for r in bf16) for k in ("forward", "input_grad", "wgrad")}
    libs = {k: sum(r[k]["library_ms"] * r["launches_per_step"] for r in bf16) for k in ("forward", "input_grad", "wgrad")}
    out["kernel_ms_per_forward"], out["bound_ms_per_forward"], out["library_ms_per_forward"] = per_fwd, bounds, libs
    log("BasicUNet's 18 convs (bf16, batch 8 of 16x128x128) a forward: " + ", ".join(
        f"{k} {per_fwd[k]:.3f} ms (bound {bounds[k]:.3f}, library {libs[k]:.3f})"
        for k in ("forward", "input_grad", "wgrad")))
    lap("conv shapes")
    # (b) vesicle_xm at full width: the forward and one train step, kernel path against plain
    cfg = load_config(VESICLE, mode="train")
    m = cfg.model
    if (m.arch.type != "monai_basic_unet" or list(m.monai.features) != [32, 32, 64, 128, 256, 32]
            or m.compute_dtype != "bfloat16" or cfg.data.dataloader.batch_size != VESICLE_BATCH
            or list(cfg.data.dataloader.patch_size) != [16, 128, 128]):
        fail("vesicle_xm.yaml no longer trains the stock BasicUNet bf16 on batch 8 of 16x128x128")
    model = build_model(cfg.model, device=dev, seed=0)
    with torch.no_grad():  # seeded nonzero conv biases: a bias the kernel drops must show
        g = torch.Generator().manual_seed(1)
        for mod in model.modules():
            if isinstance(mod, Conv):
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=g))
    batch = unet_step_batch(cfg, dev)
    x, y = batch["image"], batch["label"]
    with torch.no_grad():
        c3.reset_launch_counts()
        got = model(x)
        torch.cuda.synchronize()
        fwd_counts = conv_counts(c3)
        want = model(x, plain=True)
        fwd_err = ((got - want).abs().max() / want.abs().max()).item()
        fwd_ms = time_ms(lambda: model(x), 5)
        plain_fwd_ms = time_ms(lambda: model(x, plain=True), 2)
    if fwd_counts != dict(forward=18, input_grad=0, wgrad=0):
        fail(f"one BasicUNet forward should launch conv3d_3x3 18 times: {fwd_counts}")
    if not torch.isfinite(got).all() or fwd_err > UNET_BF16_TOL:
        fail(f"BasicUNet forward kernel vs plain: {fwd_err:.4g} of max |plain| > {UNET_BF16_TOL}")
    log(f"vesicle_xm BasicUNet forward (bf16, batch 8 of 16x128x128): {fwd_ms:.2f} ms (plain path {plain_fwd_ms:.1f} "
        f"ms), kernel vs plain {fwd_err:.4g} of max |plain| (limit {UNET_BF16_TOL}), launches {fwd_counts}")
    del got, want
    orch = LossOrchestrator(cfg.model.loss)

    def loss_and_grads(plain, net=model, xx=x, yy=y):
        net.zero_grad(set_to_none=True)
        loss, _ = orch(net(xx, plain=plain), yy)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in net.named_parameters()}

    model.train()
    c3.reset_launch_counts()
    loss_k, g_k = loss_and_grads(False)
    torch.cuda.synchronize()
    counts = conv_counts(c3)
    if counts != dict(forward=18, input_grad=17, wgrad=18):
        fail(f"one vesicle_xm train step should launch 18 forward, 17 input-gradient and 18 weight-gradient convs: "
             f"{counts}")
    loss_p, g_p = loss_and_grads(True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs, shares, whole = unet_leaf_errors(g_k, g_p, UNET_SMALL_LEAF)
    worst = max(errs, key=errs.get)
    log(f"vesicle_xm step: loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel err {loss_err:.3g}); whole gradient "
        f"{whole:.4g} (limit {UNET_TRAIN_GRAD_TOL}); worst leaf {worst} {errs[worst]:.4g}; launches {counts}")
    log("  worst leaves (error, norm / largest): " + ", ".join(
        f"{n} {errs[n]:.3g} {shares[n]:.2g}" for n in sorted(errs, key=errs.get, reverse=True)[:6]))
    if not math.isfinite(loss_k) or loss_err > UNET_TRAIN_LOSS_TOL:
        fail(f"vesicle_xm train step loss: kernel {loss_k} vs plain {loss_p} (rel err {loss_err:.3g})")
    if whole > UNET_TRAIN_GRAD_TOL:
        fail(f"vesicle_xm train step gradient: error {whole:.3g} > {UNET_TRAIN_GRAD_TOL}")
    # a fault probe that the gradient limit must reject: a weight-gradient tap dropped
    wgrad = c3.conv3d_3x3_wgrad

    def drop_tap(xx, dd, grid=None):
        gg = wgrad(xx, dd).clone()
        gg[:, :, 0, 0, 0] = 0
        return gg

    drop_tap.launches = 0
    c3.conv3d_3x3_wgrad = drop_tap
    try:
        probe = unet_leaf_errors(loss_and_grads(False)[1], g_p, UNET_SMALL_LEAF)[2]
    finally:
        c3.conv3d_3x3_wgrad = wgrad
    log(f"fault probe (dW tap (0,0,0) dropped): whole gradient error {probe:.4g} against the limit "
        f"{UNET_TRAIN_GRAD_TOL}")
    if probe <= UNET_TRAIN_GRAD_TOL:
        fail(f"the gradient limit {UNET_TRAIN_GRAD_TOL} lets the dropped-tap probe pass: {probe}")
    opt, schedule = build_optimizer(cfg.optimization, model, cfg.optimization.n_steps_per_epoch)
    state = create_train_state(model, opt)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val)
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        logs = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(float(v)) for v in logs.values()):
        fail(f"vesicle_xm train step logs not finite: {logs}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:12]
    log(f"vesicle_xm train step: {step_ms:.1f} ms, peak memory {peak / 2**30:.2f} GiB; under the profiler the "
        f"kernels take {busy_ms:.1f} ms of device time")
    for e in top:
        log(f"  {dev_us(e) / 1e3:8.2f} ms  {e.count:5d}x  {e.key[:90]}")
    # the same step in f32 (batch 2; the f32 kernels): every leaf within UNET_F32_GRAD_TOL of the plain path
    fcfg = load_config(VESICLE, overrides=["optimization.precision=32"], mode="train")
    if fcfg.model.compute_dtype != "float32":
        fail(f"optimization.precision=32 gives compute dtype {fcfg.model.compute_dtype}")
    fmodel = build_model(fcfg.model, device=dev, seed=0)
    fmodel.load_state_dict(model.state_dict())
    fmodel.train()
    f_args = dict(net=fmodel, xx=x[:2].contiguous(), yy=y[:2].contiguous())
    c3.reset_launch_counts()
    floss_k, fg_k = loss_and_grads(False, **f_args)
    fcounts = conv_counts(c3)
    floss_p, fg_p = loss_and_grads(True, **f_args)
    ferrs, _, fwhole = unet_leaf_errors(fg_k, fg_p, UNET_SMALL_LEAF)
    fworst = max(ferrs, key=ferrs.get)
    floss_err = abs(floss_k - floss_p) / abs(floss_p)
    log(f"vesicle_xm step in f32 (batch 2): loss kernel {floss_k:.7f} plain {floss_p:.7f} (rel err {floss_err:.3g}); "
        f"worst leaf {fworst} {ferrs[fworst]:.3g} (limit {UNET_F32_GRAD_TOL}), whole gradient {fwhole:.3g}; launches "
        f"{fcounts}")
    if fcounts != dict(forward=18, input_grad=17, wgrad=18) or floss_err > 1e-5 or ferrs[fworst] > UNET_F32_GRAD_TOL:
        fail(f"vesicle_xm f32 step: launches {fcounts}, loss rel err {floss_err:.3g}, {fworst} {ferrs[fworst]:.3g}")
    del fmodel, fg_k, fg_p
    out["vesicle_step"] = dict(
        f32_loss_rel_err=floss_err, f32_worst_leaf=fworst, f32_worst_leaf_error=ferrs[fworst], f32_leaf_errors=ferrs,
        grad_whole_error=whole,
        forward_ms=fwd_ms, plain_forward_ms=plain_fwd_ms, forward_rel_err=fwd_err, forward_launches=fwd_counts,
        step_ms=step_ms, peak_memory_bytes=peak, launches_per_step=counts, loss_kernel=loss_k, loss_plain=loss_p,
        loss_rel_err=loss_err, grad_leaf_errors=errs, worst_leaf=worst, fault_probe_leaf_error=probe,
        device_busy_ms=busy_ms, top_kernels=[dict(name=e.key, device_ms=dev_us(e) / 1e3, count=e.count) for e in top],
    )
    del model, opt, state, g_k, g_p, batch, x, y
    torch.cuda.empty_cache()
    lap("vesicle step")
    # (c) UNETR at the schema's stock knobs: one forward, batch 2 of 96^3, kernel path against plain
    ucfg = load_config(VESICLE, overrides=["model.arch.type=monai_unetr", "model.input_size=[96,96,96]"], mode="train")
    unetr = build_model(ucfg.model, device=dev, seed=0)
    mu = ucfg.model.monai
    xu = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 96, 96, 96, 1), dtype=np.float32)).to(dev)
    with torch.no_grad():
        c3.reset_launch_counts()
        got = unetr(xu)
        torch.cuda.synchronize()
        ucounts = conv_counts(c3)
        want = unetr(xu, plain=True)
        uerr = ((got - want).abs().max() / want.abs().max()).item()
        ums = time_ms(lambda: unetr(xu), 5)
        uplain = time_ms(lambda: unetr(xu, plain=True), 2)
    if ucounts["forward"] != 9 or not torch.isfinite(got).all() or uerr > UNET_BF16_TOL:
        fail(f"UNETR forward: {ucounts} launches (9 expected), kernel vs plain {uerr:.4g} > {UNET_BF16_TOL}?")
    log(f"UNETR (hidden {mu.hidden_size}, {mu.num_layers} layers, {mu.num_heads} heads, mlp {mu.mlp_dim}, patch "
        f"{list(mu.patch_size)}, feature_size {mu.feature_size}) forward bf16 batch 2 of 96^3: {ums:.2f} ms (plain "
        f"{uplain:.1f}), kernel vs plain {uerr:.4g} of max |plain|, launches {ucounts}")
    out["unetr"] = dict(forward_ms=ums, plain_forward_ms=uplain, rel_err=uerr, launches=ucounts)
    del unetr, xu, got, want
    torch.cuda.empty_cache()
    lap("unetr")
    # (d) the recipes through the CLI
    logs_h = LogRecords(("timing[",))
    port_log = logging.getLogger("pytorch_connectomics_tpu_torch")
    port_log.addHandler(logs_h)

    def leg(recipe, mode, root, extra, steps=None):
        c3.reset_launch_counts()
        t0 = time.perf_counter()
        res = dispatch_runtime(parse_args(["--config", str(recipe), "--device", str(dev), "--mode", mode,
                                           f"save_path={root}"] + extra))
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = conv_counts(c3)
        if res["launches"]["forward"] <= 0 or (recipe == VESICLE and res["launches"]["forward"] % 18):
            fail(f"{recipe.name} --mode {mode} did not run its forwards through the conv kernel: {res['launches']}")
        if mode == "train":
            st = train_leg_stats(res)
            if st["train_stats"]["steps"] != steps or not res["checkpoint"] or not st["losses"] \
                    or not all(math.isfinite(v) for v in st["losses"]):
                fail(f"{recipe.name} train leg: {st['train_stats']['steps']} steps, checkpoint {res['checkpoint']}, "
                     f"losses {st['losses']}")
            if res["launches"]["wgrad"] <= 0 or res["launches"]["input_grad"] <= 0:
                fail(f"{recipe.name} train leg did not run the backward kernels: {res['launches']}")
            if recipe == VESICLE and res["launches"] != dict(forward=18 * steps, input_grad=17 * steps, wgrad=18 * steps):
                fail(f"the vesicle_xm train leg should launch 18 forward, 17 input-gradient and 18 weight-gradient "
                     f"convs a step for {steps} steps: {res['launches']}")
            res["stats"] = st
            log(f"{recipe.name} train: {steps} steps in {st['train_stats']['seconds']:.2f} s ({st['steps_per_s']:.3f} "
                f"steps/s, {st['step_ms']:.1f} ms a step, {st['data_wait_ms_per_step']:.1f} of it waiting; pipeline "
                f"{st['pipeline_host_ms_per_batch']:.1f} ms a batch); losses {st['losses'][0]:.4f} -> "
                f"{st['losses'][-1]:.4f}; launches {res['launches']}; {res['seconds']:.1f} s in all")
        else:
            timing = logs_h.take("timing[")
            res["timing"] = [dict(zip(("volume", "read+normalise", "predict", "save", "decode", "evaluate"), t))
                             for t in timing]
            metrics = next(iter(res["metrics"].values()))
            if not all(math.isfinite(v) for v in metrics.values()):
                fail(f"{recipe.name} test metrics: {metrics}")
            log(f"{recipe.name} test: {res['seconds']:.1f} s, timing {res['timing']}, metrics {metrics}, "
                f"launches {res['launches']}")
        return res

    legs = {}
    try:
        for recipe, tag in ((MINIMAL, "minimal"), (BLOBS, "blobs"), (VESICLE, "vesicle")):
            root = work / f"unet_{tag}"
            shutil.rmtree(root, ignore_errors=True)
            if recipe == VESICLE:
                shape = "shape={},{},{}".format(*VESICLE_SHAPE)
                train_extra = [f"data.train.image=synthetic://em2/vesicle_train_image?{shape}&seed=41",
                               f"data.train.label=synthetic://em2/vesicle_train_label?{shape}&seed=41",
                               f"optimization.n_steps_per_epoch={VESICLE_STEPS}", "optimization.max_epochs=1"]
                test_extra = [f"data.test.image=synthetic://em2/vesicle_test_image?{shape}&seed=42",
                              f"data.test.label=synthetic://em2/vesicle_test_label?{shape}&seed=42"]
                steps = VESICLE_STEPS
            elif recipe == MINIMAL:  # the recipe names no test volume: the test leg names random:// ones
                train_extra, steps = [], 4
                test_extra = ["data.test.image=random://minimal/test_image", "data.test.label=random://minimal/test_label"]
            else:
                train_extra, test_extra, steps = [], [], 8
            train = leg(recipe, "train", root, train_extra, steps)
            test = leg(recipe, "test", root, test_extra)
            if (test.get("restored") or {}).get("checkpoint") != train["checkpoint"]:
                fail(f"{recipe.name} test leg did not restore {train['checkpoint']}: {test.get('restored')}")
            pred = read_volume(str(next(f for f in Path(test["run_dir"]).iterdir()
                                        if f.name.endswith(("_prediction.h5", "_prediction.npy")))))
            if not np.isfinite(pred).all():
                fail(f"{recipe.name} prediction not finite")
            legs[tag] = dict(train=dict(train["stats"], seconds=train["seconds"], launches=train["launches"]),
                             test=dict(seconds=test["seconds"], timing=test["timing"], launches=test["launches"],
                                       metrics=next(iter(test["metrics"].values())), prediction_shape=list(pred.shape)))
            lap(tag)
    finally:
        port_log.removeHandler(logs_h)
    if "adapted_rand" not in legs["blobs"]["test"]["metrics"] or "jaccard" not in legs["vesicle"]["test"]["metrics"]:
        fail(f"recipe metrics: {legs['blobs']['test']['metrics']}, {legs['vesicle']['test']['metrics']}")
    if "_tta_x4_" not in next(f.name for f in (work / "unet_vesicle").rglob("*_prediction.*")):
        fail("the vesicle_xm test leg did not predict with the recipe's 4 flip variants")
    out["recipes"] = legs
    return rows


NISB = ROOT / "tutorials" / "neuron_nisb.yaml"
NISB_BATCH, NISB_TRAIN_BATCH = 8, 4
# (C, R, (Z, Y, X), blocks per forward) of MedNeXt-L's stride-1 blocks on the
# NISB recipe's (32, 128, 128) window (stock stem): 54 blocks
NISB_STAGES = [
    (32, 96, (32, 128, 128), 6),
    (64, 256, (16, 64, 64), 8),
    (128, 1024, (8, 32, 32), 16),
    (256, 2048, (4, 16, 16), 16),
    (512, 4096, (2, 8, 8), 8),
]
NISB_BLOCKS = sum(s[3] for s in NISB_STAGES)
# the MedNeXt-L forward: the kernel path's relative error against the f32
# plain path at most this many times the bf16 plain path's own
NISB_FWD_ERR_RATIO = 2.0
# the corner chunk of the tuned prediction (cut on every axis), kernel path
# against plain (two bf16 computations rounding at other points): the mean
# |difference| of the probabilities, and the share of voxels that differ by
# more than 0.05
NISB_CHUNK_MEAN_TOL = 2e-3
NISB_CHUNK_FAR_SHARE = 1e-4
# seeded synthetic://instance volumes made on the card (the NISB volumes are
# not in the repository): train, tune volume A, held-out volume B; B holds two
# of the recipe's (64, 512, 512) chunks on every axis, the second one cut
NISB_TRAIN_SHAPE = (48, 384, 384)
NISB_TUNE_SHAPE = (32, 256, 256)
NISB_TEST_SHAPE = (72, 544, 544)  # cut from (96, 768, 768) to make room for phase 20
NISB_EPOCHS, NISB_STEPS, NISB_TRIALS = 2, 15, 3
# the chunk the resume check drops from the manifest and the kernel path is
# held to the plain path on: the corner one, cut on every axis
NISB_DROPPED_CHUNK = "1_1_1"


def nisb_forward(fb, dev, out):
    """The 3-channel MedNeXt-L forward at batch 8, kernel path against plain.
    Both run bf16 and round at other points, and over 54 blocks the two
    drift apart by about the bf16 plain path's own error, so the kernel
    path is held to the f32 plain path: its relative error (norm of the
    difference over the norm) at most NISB_FWD_ERR_RATIO times the bf16
    plain path's."""
    import copy

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.models import build_model

    cfg = load_config(NISB, mode="test")
    model = build_model(cfg.model, device=dev, seed=0)
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.compute_dtype = "float32"
    model32 = build_model(cfg32.model, device=dev, seed=0)
    model32.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).random((NISB_BATCH, 32, 128, 128, 1), dtype=np.float32)).to(dev)
    with torch.inference_mode():
        fb.reset_launch_counts()
        y = model(x)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in fb.KERNELS}
        if any(v != NISB_BLOCKS for v in counts.values()):
            fail(f"one MedNeXt-L forward should launch each kernel {NISB_BLOCKS} times, got {counts}")
        ref = model(x, plain=True)
        ref32 = model32(x, plain=True).float()
        err, top = (y - ref).abs().max().item(), ref.abs().max().item()
        rel_k = ((y.float() - ref32).norm() / ref32.norm()).item()
        rel_p = ((ref.float() - ref32).norm() / ref32.norm()).item()
        if not torch.isfinite(y).all() or y.shape != (NISB_BATCH, 32, 128, 128, 3) \
                or not rel_k <= NISB_FWD_ERR_RATIO * rel_p:
            fail(f"MedNeXt-L {tuple(y.shape)}: kernel path's error against f32 {rel_k:.3g}, more than "
                 f"{NISB_FWD_ERR_RATIO} x the bf16 plain path's {rel_p:.3g}")
        ms = time_ms(lambda: model(x), reps=5, warmup=1)
        plain_ms = time_ms(lambda: model(x, plain=True), reps=3, warmup=1)
    out["model"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, max_abs_ref=top, rel_err_f32=rel_k,
                        plain_rel_err_f32=rel_p, err_ratio_limit=NISB_FWD_ERR_RATIO, launches_per_forward=counts)
    log(f"MedNeXt-L, 3 affinity channels, bf16 batch 8 of 32x128x128: kernel path {ms:.2f} ms, plain path "
        f"{plain_ms:.2f} ms; against the f32 plain path the kernel path's relative error {rel_k:.4g}, the bf16 plain "
        f"path's {rel_p:.4g} (limit {NISB_FWD_ERR_RATIO}x); max |kernel - plain| {err:.4g} of max |plain| {top:.4g}")
    del model, model32


def nisb_train_step(dwk, fb, dev, out):
    """One MedNeXt-L train step at the recipe's batch 4 of 32x128x128 (bf16,
    outside_block remat): loss and per-leaf gradients of the kernel path
    against the plain path, with fault probes the limit must reject; step
    time, peak memory and launches a step."""
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
    from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

    cfg = load_config(NISB, mode="train")
    if cfg.model.mednext.checkpoint_style != "outside_block" or cfg.model.compute_dtype != "bfloat16" \
            or cfg.data.dataloader.batch_size != NISB_TRAIN_BATCH:
        fail("neuron_nisb.yaml no longer trains bf16 at batch 4 with outside_block remat")
    model = build_model(cfg.model, device=dev, seed=0)
    orch = LossOrchestrator(cfg.model.loss)
    shape = (NISB_TRAIN_BATCH, *cfg.data.dataloader.patch_size)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random((*shape, 1), dtype=np.float32)).to(dev)
    y = torch.from_numpy((rng.random((*shape, 3)) > 0.5).astype(np.float32)).to(dev)

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
    # each stride-1 block: forward, remat recompute and input gradient; one weight gradient
    want = {"depthwise3x3": 3 * NISB_BLOCKS, "depthwise3x3_wgrad": NISB_BLOCKS, "dw_stats": 0, "fused_block_apply": 0}
    if counts != want:
        fail(f"one MedNeXt-L remat train step should launch {want}, got {counts}")
    loss_p, g_p = loss_and_grads(True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs = leaf_errors(g_k, g_p)
    worst = max(errs, key=errs.get)
    log(f"loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel err {loss_err:.3g}); worst leaf {worst} {errs[worst]:.4g}")
    if not math.isfinite(loss_k) or loss_err > TRAIN_LOSS_TOL:
        fail(f"MedNeXt-L train step loss: kernel {loss_k} vs plain {loss_p} (rel err {loss_err:.3g})")
    if errs[worst] > TRAIN_GRAD_TOL:
        fail(f"MedNeXt-L train step gradient {worst}: error {errs[worst]:.3g} > {TRAIN_GRAD_TOL}")
    probes = {}
    s0, bott = model.enc[0].blocks[0], model.bottleneck.blocks[0]
    for name, w, idx in (("dw tap (0,0,0) dropped, stage 0", s0.conv_weight, (slice(None), 0, 0, 0, 0)),
                         ("hidden units 0:16 dropped, bottleneck", bott.pw2.weight, (slice(None), slice(0, 16)))):
        with torch.no_grad():
            saved = w[idx].clone()
            w[idx] = 0
        _, g_f = loss_and_grads(True)
        with torch.no_grad():
            w[idx] = saved
        probes[name] = max(leaf_errors(g_f, g_p).values())
    log("fault probes (worst leaf error): " + ", ".join(f"{k} {v:.4g}" for k, v in probes.items()))
    if min(probes.values()) <= TRAIN_GRAD_TOL:
        fail(f"the gradient limit {TRAIN_GRAD_TOL} lets a fault probe pass: {probes}")
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
        fail(f"MedNeXt-L train step logs not finite: {logs}")
    out["train_step"] = dict(shape=list(shape), step_ms=step_ms, peak_memory_bytes=peak, launches_per_step=counts,
                             loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_err, grad_leaf_errors=errs,
                             worst_leaf=worst, grad_tol=TRAIN_GRAD_TOL, fault_probe_leaf_errors=probes)
    log(f"MedNeXt-L train step {shape} bf16 remat: {step_ms:.1f} ms, peak memory {peak / 2**30:.2f} GiB, "
        f"launches per step {counts}")
    del model, opt, state, g_k, g_p
    torch.cuda.empty_cache()


def phase_nisb(dwk, fb, dev, work, report):
    log("== phase 18: tutorials/neuron_nisb.yaml (MedNeXt-L, affinities): kernels at its shapes, forward, train "
        "step, CLI train -> tune on NERL -> chunked tune-test and the untrained control ==")
    import shutil

    import yaml

    from pytorch_connectomics_tpu_torch.chunked import build_chunk_grid
    from pytorch_connectomics_tpu_torch.data.io import read_volume
    from pytorch_connectomics_tpu_torch.data.preprocess import normalize_volume
    from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
    from pytorch_connectomics_tpu_torch.decoding.postprocess import apply_postprocessing
    from pytorch_connectomics_tpu_torch.decoding.registry import run_steps
    from pytorch_connectomics_tpu_torch.inference import InferenceManager, LazyVolumeAccessor
    from pytorch_connectomics_tpu_torch.metrics import expected_run_length, skeletonize_volume, voi
    from pytorch_connectomics_tpu_torch.metrics import nerl as nerl_module
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args, setup_config
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime, load_weights
    from pytorch_connectomics_tpu_torch.runtime.test_pipeline import run_test_pipeline
    from pytorch_connectomics_tpu_torch.runtime.tune_runner import apply_best_params

    out = report["nisb"] = {}
    t_phase = time.perf_counter()
    parts = out["part_seconds"] = {}
    last = [t_phase]

    def lap(what):
        now = time.perf_counter()
        parts[what] = now - last[0]
        last[0] = now
    # (a) the kernels of this path at MedNeXt-L's stride-1 stages: the pair at
    # the inference batch 8, the depthwise kernels at the training batch 4
    # f32 applies run the exact CUDA-core check path (73-123 ms a launch here): 3 timed calls
    out["pair_rows"] = [pair_row(fb, dev, c, r, spatial, per, dtype, NISB_BATCH,
                                 reps=3 if dtype == torch.float32 else None)
                        for dtype in (torch.bfloat16, torch.float32) for c, r, spatial, per in NISB_STAGES]
    for row in out["pair_rows"]:
        if row["C"] == 512:
            a = row["fused_block_apply"]
            log(f"bottleneck C 512 / R 4096 {row['dtype']}: fused_block_apply {a['ms']:.4f} ms against its plain "
                f"version's {a['plain_ms']:.4f} ms (bound {a['bound_ms']:.4f})")
    out["depthwise_rows"] = [depthwise_row(dwk, dev, "nisb", spatial, c, per, dtype, NISB_TRAIN_BATCH)
                             for dtype in (torch.bfloat16, torch.float32) for c, _, spatial, per in NISB_STAGES]
    lap("kernel_rows")
    # (b) the forward, (c) one train step
    nisb_forward(fb, dev, out)
    lap("forward")
    nisb_train_step(dwk, fb, dev, out)
    lap("train_step")

    # (d) the recipe's CLI legs as shipped, on volumes made on the card
    t0 = time.perf_counter()
    vols = {}
    for tag, shape, seed in (("train", NISB_TRAIN_SHAPE, 41), ("a", NISB_TUNE_SHAPE, 42), ("b", NISB_TEST_SHAPE, 43)):
        img, lbl = synthetic_em_task("instance", shape, seed=seed, device=dev)
        vols[tag] = (work / f"nisb_{tag}_im.npy", work / f"nisb_{tag}_label.npy")
        np.save(vols[tag][0], img)
        np.save(vols[tag][1], lbl)
    out["volumes_seconds"] = time.perf_counter() - t0
    lap("volumes")
    log(f"NISB volumes (synthetic instance: train {NISB_TRAIN_SHAPE}, A {NISB_TUNE_SHAPE}, B {NISB_TEST_SHAPE}) made "
        f"in {out['volumes_seconds']:.1f} s")
    shipped = yaml.safe_load(NISB.read_text())["default"]["inference"]["chunked"]
    grid = build_chunk_grid(NISB_TEST_SHAPE, shipped["chunk_size"], shipped["halo"])
    counts_a = [len({c.index[i] for c in grid}) for i in range(3)]
    if min(counts_a) < 2 or not all(c.stop[i] - c.start[i] < shipped["chunk_size"][i] for c in grid[-1:] for i in
                                    range(3)):
        fail(f"B {NISB_TEST_SHAPE} does not hold two chunks of {shipped['chunk_size']} an axis with a cut last one")
    run_root, control_root = work / "nisb", work / "nisb_control"
    for d in (run_root, control_root):
        shutil.rmtree(d, ignore_errors=True)

    def data(split, tag):
        return [f"data.{split}.image={vols[tag][0]}", f"data.{split}.label={vols[tag][1]}"]

    flags = ["--config", str(NISB), "--device", str(dev)]
    logs = LogRecords(("timing[", "trial %d/%d", "chunk ", "chunked: "))
    port_log = logging.getLogger("pytorch_connectomics_tpu_torch")
    port_log.addHandler(logs)
    try:
        dwk.reset_launch_counts()
        fb.reset_launch_counts()
        steps = NISB_EPOCHS * NISB_STEPS
        train = dispatch_runtime(parse_args(flags + [
            "--mode", "train", f"save_path={run_root}", f"optimization.max_epochs={NISB_EPOCHS}",
            f"optimization.n_steps_per_epoch={NISB_STEPS}", *data("train", "train")]))
        torch.cuda.synchronize()
        train_counts = {k.__name__: k.launches for k in dwk.KERNELS + fb.KERNELS}
        stats = train_leg_stats(train)
        if stats["train_stats"]["steps"] != steps or not train["checkpoint"] or not stats["losses"] \
                or not all(math.isfinite(v) for v in stats["losses"]):
            fail(f"NISB train leg: {stats['train_stats']['steps']} steps, checkpoint {train['checkpoint']}, "
                 f"losses {stats['losses']}")
        if train_counts["depthwise3x3"] != 3 * NISB_BLOCKS * steps \
                or train_counts["depthwise3x3_wgrad"] != NISB_BLOCKS * steps:
            fail(f"the NISB train leg should launch depthwise3x3 {3 * NISB_BLOCKS} and depthwise3x3_wgrad "
                 f"{NISB_BLOCKS} times a step for {steps} steps: {train_counts}")
        stats["launches"] = train_counts
        lap("train_leg")
        log(f"NISB train leg: {steps} steps in {stats['train_stats']['seconds']:.2f} s ({stats['steps_per_s']:.3f} "
            f"steps/s, {stats['step_ms']:.1f} ms a step, {stats['data_wait_ms_per_step']:.1f} of it waiting for "
            f"batches; pipeline {stats['pipeline_host_ms_per_batch']:.1f} ms a batch); losses "
            f"{stats['losses'][0]:.4f} -> {stats['losses'][-1]:.4f}; launches {train_counts}")

        def leg(mode, root, extra):
            fb.reset_launch_counts()
            t0 = time.perf_counter()
            res = dispatch_runtime(parse_args(flags + ["--mode", mode] + extra + [f"save_path={root}"]))
            torch.cuda.synchronize()
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = {k.__name__: k.launches for k in fb.KERNELS}
            if any(v <= 0 or v % NISB_BLOCKS for v in res["launches"].values()):
                fail(f"the {mode} leg did not run every stride-1 block through the fused kernels: {res['launches']}")
            return res

        tune = leg("tune", run_root, ["--tune-trials", str(NISB_TRIALS), *data("test", "a")])
        if (tune.get("restored") or {}).get("checkpoint") != train["checkpoint"]:
            fail(f"the tune leg did not restore {train['checkpoint']}: {tune.get('restored')}")
        study = yaml.safe_load(Path(tune["best_params"]).read_text())
        trials = [a[4] for a in logs.take("trial %d/%d")]
        (tune_timing,) = logs.take("timing[")
        logs.take("chunk ")
        logs.take("chunked: ")
        if len(trials) != NISB_TRIALS or study["metric"] != "nerl" or study["direction"] != "maximize" \
                or not all(0 <= t["value"] <= 1 for t in study["trials"] if t["state"] == "complete"):
            fail(f"the tune leg ran {len(trials)} trials on {study['metric']}: {study['trials']}")
        lap("tune_leg")
        bp = ["--best-params", tune["best_params"], *data("test", "b")]
        # the leg as shipped; the ground-truth skeletons its NERL makes are
        # kept (and timed) for the control's NERL
        made = {}

        def recording(gt, **kw):
            t0 = time.perf_counter()
            made["skeletons"] = skeletonize(gt, **kw)
            made["seconds"] = time.perf_counter() - t0
            return made["skeletons"]

        skeletonize = nerl_module.skeletonize_volume
        nerl_module.skeletonize_volume = recording
        try:
            test = leg("tune-test", run_root, bp)
        finally:
            nerl_module.skeletonize_volume = skeletonize
        (test_timing,) = logs.take("timing[")
        chunk_times = [dict(key=a[0], read_s=a[1], predict_s=a[2], write_s=a[3]) for a in logs.take("chunk ")]
        (summary,) = logs.take("chunked: ")
        if summary[:2] != (len(grid), len(grid)) or sorted(c["key"] for c in chunk_times) != sorted(c.key for c in grid):
            fail(f"the tune-test leg computed {summary[:2]} chunks, not all {len(grid)}: {chunk_times}")
        lap("tune_test_leg")
        # the control scores VOI through the CLI; its NERL and ERL come from
        # the trained leg's skeletons of the same ground truth (B's skeletons
        # take most of an evaluation's minute on the host)
        control = leg("tune-test", control_root, bp + ["evaluation.metrics=[voi]"])
        lap("control_leg")
        logs.take("timing[")
        logs.take("chunk ")
        logs.take("chunked: ")
        if control.get("restored"):
            fail(f"the control restored a checkpoint: {control['restored']}")

        # (e) resume: the tune-test leg's prediction stage again, with its
        # config (so its config hash) and checkpoint, then again with one
        # chunk taken off the manifest
        ckpt = test["restored"]["checkpoint"]
        cfg_b = apply_best_params(setup_config(parse_args(flags + ["--mode", "tune-test", *bp,
                                                                   f"save_path={run_root}"])), tune["best_params"])
        model = build_model(cfg_b.model, device=dev, seed=cfg_b.system.seed)
        load_weights(model, ckpt, cfg_b)
        run_dir = Path(test["run_dir"])
        pred_file = next(f for f in run_dir.iterdir() if f.name.endswith(("_prediction.h5", "_prediction.npy")))
        manifest = next(run_dir.glob("*_prediction.h5.manifest.json"))
        chunked = read_volume(str(pred_file)).copy()
        resumed = []
        for drop in ((), (NISB_DROPPED_CHUNK,)):
            m = json.loads(manifest.read_text())
            m["done"] = [k for k in m["done"] if k not in drop]
            manifest.write_text(json.dumps(m))
            fb.reset_launch_counts()
            run_test_pipeline(cfg_b, model, run_dir, ckpt, dev, mode="tune")
            (s,) = logs.take("chunked: ")
            keys = [a[0] for a in logs.take("chunk ")]
            logs.take("timing[")
            same = bool(np.array_equal(read_volume(str(pred_file)), chunked))
            resumed.append(dict(dropped=list(drop), computed=s[0], chunks=s[1], keys=keys, bit_equal=same,
                                launches=fb.fused_block_apply.launches))
            if s[0] != len(drop) or keys != list(drop) or not same:
                fail(f"resume with {list(drop)} off the manifest recomputed {s[0]} chunks {keys}, file bit-equal "
                     f"{same}")
        lap("resume")
    finally:
        port_log.removeHandler(logs)

    # (f) the corner chunk, kernel path against plain; the whole volume against the chunks (reported)
    manager = InferenceManager(cfg_b, model, dev)
    plain = InferenceManager(cfg_b, model, dev)
    plain.engine.apply_fn = lambda t: model(t, plain=True)
    corner = next(c for c in grid if c.key == NISB_DROPPED_CHUNK)
    data = LazyVolumeAccessor(str(vols["b"][0]), normalize=cfg_b.data.preprocessing.normalize).read(corner.read_slices)
    fb.reset_launch_counts()
    got = manager.predictor.predict(data, out_channels=3)
    k_launches = fb.fused_block_apply.launches
    want = plain.predictor.predict(data, out_channels=3)
    d = np.abs(got - want)
    thr = float(cfg_b.decoding.steps[0].kwargs["threshold"])
    corner_cmp = dict(max_abs_err=float(d.max()), mean_abs_err=float(d.mean()), far_share=float((d > 0.05).mean()),
                     flipped_share=float(((got > thr) != (want > thr)).mean()), mean_tol=NISB_CHUNK_MEAN_TOL,
                     far_share_tol=NISB_CHUNK_FAR_SHARE, launches=k_launches)
    del d
    log(f"chunk {corner.key} {data.shape}, kernel path vs plain: mean |diff| {corner_cmp['mean_abs_err']:.3g} "
        f"(limit {NISB_CHUNK_MEAN_TOL}), share above 0.05 {corner_cmp['far_share']:.3g} (limit {NISB_CHUNK_FAR_SHARE}), "
        f"max {corner_cmp['max_abs_err']:.4g}, affinities on the other side of the tuned threshold "
        f"{corner_cmp['flipped_share']:.3g}")
    if k_launches <= 0 or fb.fused_block_apply.launches != k_launches \
            or not corner_cmp["mean_abs_err"] <= NISB_CHUNK_MEAN_TOL \
            or not corner_cmp["far_share"] <= NISB_CHUNK_FAR_SHARE:
        fail(f"chunk {corner.key} kernel path vs plain beyond its limits: {corner_cmp}, launches {k_launches} then "
             f"{fb.fused_block_apply.launches}")
    lap("corner_chunk")
    t0 = time.perf_counter()
    whole = manager.predict(normalize_volume(np.load(vols["b"][0]), cfg_b.data.preprocessing.normalize))
    whole_s = time.perf_counter() - t0
    diff = np.abs(np.moveaxis(whole, -1, 0) - chunked)
    seam, seam_mean = float(diff.max()), float(diff.mean())
    del whole, chunked, diff
    lap("whole_volume")

    # (g) one trial on A, step by step, with the tuned params
    pred_a = read_volume(str(next(f for f in (Path(tune["run_dir"])).iterdir()
                                  if f.name.endswith(("_prediction.h5", "_prediction.npy")))))
    gt_a = np.load(vols["a"][1])
    split = {}
    t0 = time.perf_counter()
    labels = run_steps(pred_a, cfg_b.decoding.steps)
    split["decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = apply_postprocessing(labels, cfg_b.decoding.postprocessing)
    split["postprocess"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sk = skeletonize_volume(gt_a)
    split["gt_skeletons"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    erl, max_erl = expected_run_length(seg, sk)
    split["erl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    voi(seg, gt_a)
    split["voi"] = time.perf_counter() - t0
    lap("trial_split")

    scores, control_scores = (next(iter(r["metrics"].values())) for r in (test, control))
    # NERL and ERL from B's ground-truth skeletons: the control's, and the
    # trained leg's again, which must equal its evaluation's
    sk_b = made["skeletons"]
    erl_s = {}
    for name, res, sc in (("trained", test, dict(scores)), ("control", control, control_scores)):
        seg = read_volume(str(next(f for f in Path(res["run_dir"]).glob("*_decoded_*") if f.suffix in (".npy", ".h5"))))
        t0 = time.perf_counter()
        erl, max_erl = expected_run_length(seg, sk_b)
        erl_s[name] = time.perf_counter() - t0
        if name == "control":
            sc.update(nerl=erl / max_erl if max_erl > 0 else 0.0, erl=erl)
        elif abs(erl / max_erl - scores["nerl"]) > 1e-9 or abs(erl - scores["erl"]) > 1e-6 * max(1.0, erl):
            fail(f"B's NERL from the kept skeletons {erl / max_erl} (ERL {erl}) is not the evaluation's {scores}")
    for sc in (scores, control_scores):
        if not ({"nerl", "erl", "voi"} <= set(sc) and all(math.isfinite(v) for v in sc.values())
                and 0 <= sc["nerl"] <= 1):
            fail(f"tune-test metrics: {sc}")
    # the recipe learns on the card: the trained model's held-out VOI below the untrained one's
    if not scores["voi"] < control_scores["voi"]:
        fail(f"held-out VOI {scores['voi']:.4f} (trained) is not below {control_scores['voi']:.4f} (untrained)")
    names = ("read+normalise", "predict", "save", "decode", "evaluate")
    overlap = dict(zip(("computed", "chunks", "seconds", "read_s", "read_under_predict_s", "predict_s", "write_s"),
                       summary))
    out.update(
        train=stats,
        tune=dict(seconds=tune["seconds"], timing=dict(zip(names, tune_timing[1:])), trial_seconds=trials,
                  mean_trial_seconds=sum(trials) / len(trials), trial_split_seconds=split, best_params=study["best_params"],
                  best_nerl_a=study["best_value"], skeletons_a=len(sk), launches=tune["launches"]),
        tune_test=dict(seconds=test["seconds"], timing=dict(zip(names, test_timing[1:])), metrics_b=scores,
                       launches=test["launches"], chunks=chunk_times, chunked=overlap, resume=resumed,
                       corner_chunk=corner_cmp,
                       gt_skeletons_b=len(sk_b), gt_skeleton_seconds_b=made["seconds"], erl_seconds_b=erl_s,
                       whole_volume_seconds=whole_s, chunked_vs_whole_max_abs_diff=seam,
                       chunked_vs_whole_mean_abs_diff=seam_mean),
        control=dict(seconds=control["seconds"], metrics_b=control_scores, launches=control["launches"]),
        seconds=time.perf_counter() - t_phase,
    )
    log(f"tune leg (volume A, {len(trials)} trials on NERL): {tune['seconds']:.2f} s, predict {tune_timing[2]:.3f} s, "
        f"{out['tune']['mean_trial_seconds']:.3f} s a trial; best NERL {study['best_value']:.4f} with "
        f"{study['best_params']}; one trial on A: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f" ({len(sk)} skeletons)")
    for c in chunk_times:
        log(f"  chunk {c['key']}: read {c['read_s']:.3f} s, predict {c['predict_s']:.3f} s, write {c['write_s']:.3f} s")
    log(f"tune-test leg (held-out volume B {NISB_TEST_SHAPE}, {len(grid)} chunks of {shipped['chunk_size']} halo "
        f"{shipped['halo']}): {test['seconds']:.2f} s; chunked {overlap['seconds']:.3f} s, reads {overlap['read_s']:.3f} "
        f"s of which {overlap['read_under_predict_s']:.3f} s under predicts, predicts {overlap['predict_s']:.3f} s, "
        f"writes {overlap['write_s']:.3f} s; decode {test_timing[4]:.3f} s, evaluate {test_timing[5]:.3f} s (GT "
        f"skeletons {made['seconds']:.3f} s for {len(sk_b)} instances, ERL {erl_s['trained']:.3f} s); launches "
        f"{test['launches']}")
    log(f"resume: {resumed[0]['computed']} chunks recomputed with the manifest whole, {resumed[1]['computed']} "
        f"({resumed[1]['keys']}) with {NISB_DROPPED_CHUNK} off it, file bit-equal; whole-volume prediction {whole_s:.2f} s, |chunked - whole| max "
        f"{seam:.4g}, mean {seam_mean:.3g} (reported, not a gate)")
    log(f"held-out B: NERL {scores['nerl']:.4f}, ERL {scores['erl']:.2f}, VOI {scores['voi']:.4f}; untrained control "
        f"NERL {control_scores['nerl']:.4f}, ERL {control_scores['erl']:.2f}, VOI {control_scores['voi']:.4f}; "
        f"phase {out['seconds']:.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    del model, manager, plain
    torch.cuda.empty_cache()


BETASEG = ROOT / "tutorials" / "mito_betaseg.yaml"
MULTITASK = ROOT / "tutorials" / "neuron_snemi_sdt_multitask.yaml"
BETASEG_TEST_BATCH, BETASEG_TRAIN_BATCH, MULTITASK_BATCH = 1, 2, 8
# (C, R, (Z, Y, X), blocks per forward) of MedNeXt-S's stride-1 blocks on
# betaseg's 192^3 window (stock stem; its three heads have no blocks): 18
BETASEG_STAGES = [
    (32, 64, (192, 192, 192), 4),
    (64, 128, (96, 96, 96), 4),
    (128, 256, (48, 48, 48), 4),
    (256, 512, (24, 24, 24), 4),
    (512, 1024, (12, 12, 12), 2),
]
BETASEG_BLOCKS = sum(s[3] for s in BETASEG_STAGES)
# the SNEMI multi-task recipe runs at z 16: its shipped 18 x 160 x 160 is no
# multiple of 16, which MedNeXt's four down and up steps need (the JAX
# package raises there too); its two heads run one stage-0 block each
MULTITASK_PATCH = (16, 160, 160)
MULTITASK_SHAPE = [f"model.input_size=[{','.join(map(str, MULTITASK_PATCH))}]",
                   f"data.dataloader.patch_size=[{','.join(map(str, MULTITASK_PATCH))}]",
                   f"inference.window.window_size=[{','.join(map(str, MULTITASK_PATCH))}]"]
MULTITASK_STAGES = [(32, 64, MULTITASK_PATCH, 6), (64, 128, (8, 80, 80), 4), (128, 256, (4, 40, 40), 4),
                    (256, 512, (2, 20, 20), 4), (512, 1024, (1, 10, 10), 2)]
MULTITASK_HEAD_BLOCKS = 2
MULTITASK_BLOCKS = BETASEG_BLOCKS + MULTITASK_HEAD_BLOCKS
# the f32 multi-task step: every gradient leaf (phase 17's measure) within
# this of the plain path's: about ten times the worst sound reading (7e-6 to
# 1.7e-5 on the H100), under what a depthwise conv computed in bf16 inside
# the f32 path gives (the bf16 control among the fault probes); the loss
# within 1e-5, GradNorm's weights over three steps within 1e-4 of the plain
# path's. PERF.md gives the readings
MULTITASK_GRAD_TOL = 2e-4
MULTITASK_GRADNORM_TOL = 1e-4
# seeded volumes made on the card (the BetaSeg and SNEMI volumes are not in
# the repository): synthetic://blobs for betaseg's mitochondria (separate
# objects in background; on synthetic://instance, cells tiling the volume,
# 20 steps left one merged instance), synthetic://instance for SNEMI's neurons
BETASEG_TRAIN_SHAPE = (192, 256, 256)
BETASEG_TEST_SHAPE = (192, 576, 576)
MULTITASK_TRAIN_SHAPE = (32, 480, 480)
MULTITASK_TEST_SHAPE = (32, 320, 320)
BETASEG_EPOCHS, BETASEG_STEPS = 2, 10
MULTITASK_EPOCHS, MULTITASK_STEPS = 1, 10  # cut from 2 epochs to make room for phase 20


def head_errors(got, want, ref32):
    """Per head: the relative error (norm of the difference over the norm)
    of ``got`` and of ``want`` against the f32 plain path ``ref32``."""
    return {k: (((got[k].float() - ref32[k]).norm() / ref32[k].norm()).item(),
                ((want[k].float() - ref32[k]).norm() / ref32[k].norm()).item()) for k in ref32}


def betaseg_forward(fb, dev, out):
    """Betaseg's 3-head MedNeXt-S forward, bf16, batch 1 of 192^3: each
    head's kernel path held to the f32 plain path (relative error at most
    NISB_FWD_ERR_RATIO times the bf16 plain path's), 18 launches of each
    pair kernel, fault probes the limit must reject, time and peak memory."""
    import copy

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.models import build_model

    cfg = load_config(BETASEG, mode="test")
    heads = [(h.name, h.out_channels, h.num_blocks) for h in cfg.model.mednext.heads]
    if heads != [("aff_r1", 3, 0), ("aff_r5", 3, 0), ("sedt", 1, 0)] or cfg.model.compute_dtype != "bfloat16":
        fail(f"mito_betaseg.yaml no longer ships three bf16 heads of no block: {heads}")
    model = build_model(cfg.model, device=dev, seed=0)
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.compute_dtype = "float32"
    model32 = build_model(cfg32.model, device=dev, seed=0)
    model32.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).random((BETASEG_TEST_BATCH, *cfg.model.input_size, 1),
                                                         dtype=np.float32)).to(dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fb.reset_launch_counts()
        y = model(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = {k.__name__: k.launches for k in fb.KERNELS}
        if any(v != BETASEG_BLOCKS for v in counts.values()):
            fail(f"one betaseg forward should launch each kernel {BETASEG_BLOCKS} times, got {counts}")
        ref = model(x, plain=True)
        ref32 = {k: v.float() for k, v in model32(x, plain=True).items()}
        errs = head_errors(y, ref, ref32)
        for k, (rel_k, rel_p) in errs.items():
            if not torch.isfinite(y[k]).all() or y[k].shape[-1] != dict((h[0], h[1]) for h in heads)[k] \
                    or not rel_k <= NISB_FWD_ERR_RATIO * rel_p:
                fail(f"betaseg head {k} {tuple(y[k].shape)}: kernel path's error against f32 {rel_k:.3g}, more "
                     f"than {NISB_FWD_ERR_RATIO} x the bf16 plain path's {rel_p:.3g}")
        # faults the size of a kernel bug in the plain path: the limit must reject each on some head
        probes = {}
        for where, blk in (("stage 0", model.enc[0].blocks[0]), ("last decoder stage", model.dec[3].blocks[-1])):
            for fault, w, idx in (("dw tap (0,0,0) dropped", blk.conv_weight, (slice(None), 0, 0, 0, 0)),
                                  ("hidden units 0:16 dropped", blk.pw2.weight, (slice(None), slice(0, 16)))):
                with torch.inference_mode(False), torch.no_grad():
                    saved = w[idx].clone()
                    w[idx] = 0
                faulty = model(x, plain=True)
                with torch.inference_mode(False), torch.no_grad():
                    w[idx] = saved
                probes[f"{fault}, {where}"] = max(e[0] / (NISB_FWD_ERR_RATIO * errs[k][1])
                                                  for k, e in head_errors(faulty, ref, ref32).items())
                del faulty
        log("fault probes (largest head error over its limit): " + ", ".join(f"{k} {v:.3g}" for k, v in probes.items()))
        if min(probes.values()) <= 1.0:
            fail(f"the betaseg forward limit lets a fault probe pass: {probes}")
        ms = time_ms(lambda: model(x), reps=5, warmup=1)
        plain_ms = time_ms(lambda: model(x, plain=True), reps=2, warmup=1)
    out["forward"] = dict(ms=ms, plain_ms=plain_ms, peak_memory_bytes=peak, launches_per_forward=counts,
                          head_rel_err_f32={k: e[0] for k, e in errs.items()},
                          plain_head_rel_err_f32={k: e[1] for k, e in errs.items()},
                          err_ratio_limit=NISB_FWD_ERR_RATIO, fault_probe_ratios=probes)
    log(f"betaseg MedNeXt-S, 3 heads, bf16 batch 1 of 192^3: kernel path {ms:.2f} ms (plain {plain_ms:.2f}), peak "
        f"memory {peak / 2**30:.2f} GiB; per head the kernel path's relative error against f32 (the bf16 plain "
        "path's): " + ", ".join(f"{k} {e[0]:.4g} ({e[1]:.4g})" for k, e in errs.items()))
    del model, model32, y, ref, ref32
    torch.cuda.empty_cache()


def betaseg_train_step(dwk, fb, dev, out):
    """One betaseg train step as shipped (bf16, outside_block remat, batch 2
    of 192^3, the five loss terms on three heads): its loss against the
    plain path's, step time, peak memory and launches."""
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.targets.build import affinity_target_groups
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
    from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

    cfg = load_config(BETASEG, mode="train")
    if cfg.model.mednext.checkpoint_style != "outside_block" or cfg.data.dataloader.batch_size != BETASEG_TRAIN_BATCH:
        fail("mito_betaseg.yaml no longer trains at batch 2 with outside_block remat")
    model = build_model(cfg.model, device=dev, seed=0)
    orch = LossOrchestrator(cfg.model.loss, affinity_groups=affinity_target_groups(cfg.data.label_transform))
    shape = (BETASEG_TRAIN_BATCH, *cfg.data.dataloader.patch_size)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((*shape, 1), dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.concatenate([(rng.random((*shape, 6)) > 0.5).astype(np.float32),
                                         rng.uniform(-1, 1, (*shape, 1)).astype(np.float32)], -1)).to(dev)
    batch = {"image": x, "label": y}
    with torch.enable_grad():
        loss_p = orch(model(x, plain=True), y)[0].item()
    opt, schedule = build_optimizer(cfg.optimization, model, 100)
    state = create_train_state(model, opt)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val)
    dwk.reset_launch_counts()
    fb.reset_launch_counts()
    logs = step(state, batch)
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in dwk.KERNELS + fb.KERNELS}
    loss_k = float(logs["loss_total"])
    want = {"depthwise3x3": 3 * BETASEG_BLOCKS, "depthwise3x3_wgrad": BETASEG_BLOCKS, "dw_stats": 0,
            "fused_block_apply": 0}
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    if counts != want or not loss_err <= TRAIN_LOSS_TOL:
        fail(f"betaseg train step: launches {counts} (want {want}), loss kernel {loss_k} vs plain {loss_p}")
    torch.cuda.reset_peak_memory_stats()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        logs = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(float(v)) for v in logs.values()):
        fail(f"betaseg train step logs not finite: {logs}")
    out["train_step"] = dict(shape=list(shape), step_ms=step_ms, peak_memory_bytes=peak, launches_per_step=counts,
                             loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_err)
    log(f"betaseg train step {shape} bf16 remat: {step_ms:.1f} ms, peak memory {peak / 2**30:.2f} GiB, loss kernel "
        f"{loss_k:.6f} plain {loss_p:.6f}; launches per step {counts}")
    del model, opt, state, batch, x, y
    torch.cuda.empty_cache()


class PlainPath(torch.nn.Module):
    """A model whose forward is the plain path (the train step calls
    ``model(x)``)."""

    def __init__(self, model):
        super().__init__()
        self.m = model

    def forward(self, x):
        return self.m(x, plain=True)


def multitask_train_step(dwk, dev, out):
    """The SNEMI multi-task recipe's step (batch 8 of 16 x 160 x 160, heads
    of one block, GradNorm): in f32, every gradient leaf of the kernel path
    within MULTITASK_GRAD_TOL of the plain path's (with fault probes the
    limit must reject, a bf16 depthwise conv among them) and GradNorm's
    weights over three steps within MULTITASK_GRADNORM_TOL; launches a step,
    the heads' share counted in the same step; then the bf16 step as
    shipped, timed."""
    import copy

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.targets.build import affinity_target_groups
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
    from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

    def setup(extra=()):
        cfg = load_config(MULTITASK, overrides=MULTITASK_SHAPE + list(extra), mode="train")
        orch = LossOrchestrator(cfg.model.loss, affinity_groups=affinity_target_groups(cfg.data.label_transform))
        return cfg, orch

    # a constant lr of 1e-3 (the warmup starts at 1e-5): three steps move the GradNorm weights
    cfg, orch = setup(["optimization.precision=32", "optimization.scheduler.name=constant"])
    bal = cfg.model.loss.balancing
    if bal.method != "gradnorm" or [h.num_blocks for h in cfg.model.mednext.heads] != [1, 1]:
        fail(f"neuron_snemi_sdt_multitask.yaml no longer balances by gradnorm over heads of one block: {bal}")
    model = build_model(cfg.model, device=dev, seed=0)
    shape = (MULTITASK_BATCH, *MULTITASK_PATCH)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.random((*shape, 1), dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.concatenate([(rng.random((*shape, 3)) > 0.5).astype(np.float32),
                                         rng.uniform(-1, 1, (*shape, 1)).astype(np.float32)], -1)).to(dev)

    def loss_and_grads(plain):
        model.zero_grad(set_to_none=True)
        loss, _ = orch(model(x, plain=plain), y)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    def launches():
        return {k.__name__: k.launches for k in dwk.KERNELS}

    # the heads' share of the step: the counts where the heads take the last
    # decoder stage's output and where its gradient is whole (every head's
    # backward done); the loss between them launches none of these kernels
    marks = {}

    def at_heads(module, args, y):
        marks["forward"] = launches()
        y.register_hook(lambda g: marks.__setitem__("backward", launches()))

    hook = model.dec[-1].register_forward_hook(at_heads)
    dwk.reset_launch_counts()
    loss_k, g_k = loss_and_grads(False)
    torch.cuda.synchronize()
    hook.remove()
    counts = launches()
    head_counts = {k: marks["backward"][k] - marks["forward"][k] for k in counts}
    want = {"depthwise3x3": 2 * MULTITASK_BLOCKS, "depthwise3x3_wgrad": MULTITASK_BLOCKS}
    want_heads = {"depthwise3x3": 2 * MULTITASK_HEAD_BLOCKS, "depthwise3x3_wgrad": MULTITASK_HEAD_BLOCKS}
    if counts != want or head_counts != want_heads:
        fail(f"one multi-task f32 step should launch {want} ({want_heads} in the heads): {counts} ({head_counts})")
    loss_p, g_p = loss_and_grads(True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs, _, whole = unet_leaf_errors(g_k, g_p, UNET_SMALL_LEAF)
    worst = max(errs, key=errs.get)
    log(f"multi-task step in f32: loss kernel {loss_k:.7f} plain {loss_p:.7f} (rel err {loss_err:.3g}); worst leaf "
        f"{worst} {errs[worst]:.3g} (limit {MULTITASK_GRAD_TOL}), whole gradient {whole:.3g}; launches {counts}, "
        f"of them the heads' {head_counts}")
    if not loss_err <= 1e-5 or not errs[worst] <= MULTITASK_GRAD_TOL:
        fail(f"multi-task f32 step: loss rel err {loss_err:.3g}, {worst} {errs[worst]:.3g}")
    probes = {}
    for name, w, idx in (("dw tap (0,0,0) dropped, head aff", model.heads["aff"].blocks[0].conv_weight,
                          (slice(None), 0, 0, 0, 0)),
                         ("hidden units 0:16 dropped, bottleneck", model.bottleneck.blocks[0].pw2.weight,
                          (slice(None), slice(0, 16)))):
        with torch.no_grad():
            saved = w[idx].clone()
            w[idx] = 0
        g_f = loss_and_grads(True)[1]
        with torch.no_grad():
            w[idx] = saved
        probes[name] = max(unet_leaf_errors(g_f, g_p, UNET_SMALL_LEAF)[0].values())
    # the precision control: the plain path with its depthwise conv computed in bf16
    dw_plain = dwk.depthwise3x3_plain

    def dw_bf16(x, w, b):
        return dw_plain(x.bfloat16(), w.bfloat16(), b.bfloat16()).float()

    dwk.depthwise3x3_plain = dw_bf16
    try:
        g_f = loss_and_grads(True)[1]
    finally:
        dwk.depthwise3x3_plain = dw_plain
    probes["depthwise conv in bf16, plain path"] = max(unet_leaf_errors(g_f, g_p, UNET_SMALL_LEAF)[0].values())
    log("fault probes (worst leaf error): " + ", ".join(f"{k} {v:.4g}" for k, v in probes.items()))
    if min(probes.values()) <= MULTITASK_GRAD_TOL:
        fail(f"the gradient limit {MULTITASK_GRAD_TOL} lets a fault probe pass: {probes}")
    del g_k, g_p
    # GradNorm over three steps, kernel path and plain path from the same weights
    weights = {}
    for name, net in (("kernel", model), ("plain", PlainPath(copy.deepcopy(model)))):
        opt, schedule = build_optimizer(cfg.optimization, net, 100)
        state = create_train_state(net, opt, gradnorm_terms=orch.num_terms)
        step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val, balancing=bal.method,
                               balancing_alpha=bal.alpha, balancing_lr=bal.lr)
        weights[name] = [[float(v) for k, v in step(state, {"image": x, "label": y}).items()
                          if k.startswith("gradnorm_w_")] for _ in range(3)]
        del opt, state, net
    gn_err = max(abs(a - b) for sk, sp in zip(weights["kernel"], weights["plain"]) for a, b in zip(sk, sp))
    log(f"GradNorm weights over three f32 steps, kernel path {weights['kernel']}, plain {weights['plain']}: max "
        f"|difference| {gn_err:.3g} (limit {MULTITASK_GRADNORM_TOL})")
    if not gn_err <= MULTITASK_GRADNORM_TOL or abs(weights["kernel"][-1][0] - 1.0) < 1e-6:
        fail(f"GradNorm weights kernel {weights['kernel']} vs plain {weights['plain']}")
    del model
    # the bf16 step as shipped, timed
    cfg16, orch16 = setup()
    model = build_model(cfg16.model, device=dev, seed=0)
    opt, schedule = build_optimizer(cfg16.optimization, model, 100)
    state = create_train_state(model, opt, gradnorm_terms=orch16.num_terms)
    step = make_train_step(orch16, schedule, gradient_clip=cfg16.optimization.gradient_clip_val,
                           balancing=bal.method, balancing_alpha=bal.alpha, balancing_lr=bal.lr)
    batch = {"image": x, "label": y}
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        logs = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(float(v)) for v in logs.values()):
        fail(f"multi-task bf16 train step logs not finite: {logs}")
    out["multitask_step"] = dict(
        shape=list(shape), f32_loss_rel_err=loss_err, f32_worst_leaf=worst, f32_worst_leaf_error=errs[worst],
        f32_whole_grad_error=whole, grad_tol=MULTITASK_GRAD_TOL, fault_probe_leaf_errors=probes,
        launches_per_step=counts, head_launches_per_step=head_counts, gradnorm_weights=weights,
        gradnorm_max_abs_diff=gn_err, bf16_step_ms=step_ms, bf16_peak_memory_bytes=peak)
    log(f"multi-task bf16 step {shape}: {step_ms:.1f} ms, peak memory {peak / 2**30:.2f} GiB")
    del model, opt, state, batch, x, y
    torch.cuda.empty_cache()


def phase_multitask(dwk, fb, dev, work, report):
    log("== phase 19: multi-task MedNeXt: tutorials/mito_betaseg.yaml (3 heads) and "
        "tutorials/neuron_snemi_sdt_multitask.yaml (heads of one block, GradNorm): kernels at their shapes, "
        "forward, train steps, CLI train -> test and the untrained control ==")
    import shutil

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
    from pytorch_connectomics_tpu_torch.data.targets import build_target_fn
    from pytorch_connectomics_tpu_torch.data.targets.distance import skeleton_aware_edt
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    out = report["multitask"] = {}
    t_phase = time.perf_counter()
    parts = out["part_seconds"] = {}
    last = [t_phase]

    def lap(what):
        now = time.perf_counter()
        parts[what] = now - last[0]
        last[0] = now

    # (a) the kernels of these paths, bf16: the pair at betaseg's test batch 1
    # of 192^3, the depthwise kernels at its training batch 2 and at the
    # multi-task recipe's batch 8 (heads' blocks in its stage 0)
    out["pair_rows"] = [pair_row(fb, dev, c, r, sp, per, torch.bfloat16, BETASEG_TEST_BATCH, reps=3)
                        for c, r, sp, per in BETASEG_STAGES]
    lap("pair_rows")
    out["depthwise_rows"] = [depthwise_row(dwk, dev, "betaseg", sp, c, per, torch.bfloat16, BETASEG_TRAIN_BATCH, 3)
                             for c, _, sp, per in BETASEG_STAGES]
    lap("depthwise_rows")
    out["depthwise_rows"] += [depthwise_row(dwk, dev, "multitask", sp, c, per, torch.bfloat16, MULTITASK_BATCH, 5)
                              for c, _, sp, per in MULTITASK_STAGES]
    lap("multitask_depthwise_rows")
    betaseg_forward(fb, dev, out)
    lap("forward")
    betaseg_train_step(dwk, fb, dev, out)
    lap("train_step")
    multitask_train_step(dwk, dev, out)
    lap("multitask_step")

    # (b) the recipes' CLI legs on volumes made on the card
    vols, made = {}, {}
    out["volume_seconds"] = made
    for tag, task, shape, seed in (("train", "blobs", BETASEG_TRAIN_SHAPE, 61), ("b", "blobs", BETASEG_TEST_SHAPE, 62),
                                   ("mt_train", "instance", MULTITASK_TRAIN_SHAPE, 63),
                                   ("mt_b", "instance", MULTITASK_TEST_SHAPE, 64)):
        t0 = time.perf_counter()
        img, lbl = synthetic_em_task(task, shape, seed=seed, device=dev)
        vols[tag] = (work / f"mt_{tag}_im.npy", work / f"mt_{tag}_label.npy")
        np.save(vols[tag][0], img)
        np.save(vols[tag][1], lbl)
        made[tag] = time.perf_counter() - t0
    lap("volumes")
    log("volumes made on the card (s): " + ", ".join(f"{k} {v:.1f}" for k, v in made.items()))
    # the host's share of a betaseg sample (a batch makes two in two threads):
    # both targets of a 192^3 crop, and the skeleton-aware EDT alone
    seg = np.load(vols["train"][1])[:192, :192, :192]
    target = build_target_fn(load_config(BETASEG, mode="train").data.label_transform)
    t0 = time.perf_counter()
    target(seg)
    targets_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    skeleton_aware_edt(seg)
    skel_ms = (time.perf_counter() - t0) * 1e3
    out["host_targets_ms_per_sample"] = dict(both_targets=targets_ms, skeleton_aware_edt=skel_ms,
                                             instances=int(len(np.unique(seg)) - 1))
    log(f"betaseg targets on the host, one 192^3 sample ({out['host_targets_ms_per_sample']['instances']} "
        f"instances): {targets_ms:.0f} ms, the skeleton-aware EDT {skel_ms:.0f} ms of it")
    del seg
    lap("host_targets")

    logs = LogRecords(("timing[",))
    port_log = logging.getLogger("pytorch_connectomics_tpu_torch")
    port_log.addHandler(logs)

    def data(split, tag):
        return [f"data.{split}.image={vols[tag][0]}", f"data.{split}.label={vols[tag][1]}"]

    def train_leg(recipe, root, tag, epochs, steps, blocks, remat, extra=()):
        shutil.rmtree(root, ignore_errors=True)
        dwk.reset_launch_counts()
        # the losses (and GradNorm's weights) logged every 5 steps
        res = dispatch_runtime(parse_args(["--config", str(recipe), "--device", str(dev), "--mode", "train",
                                           *extra, f"save_path={root}", "monitor.logging.scalar.loss_every_n_steps=5",
                                           f"optimization.max_epochs={epochs}",
                                           f"optimization.n_steps_per_epoch={steps}", *data("train", tag)]))
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in dwk.KERNELS}
        stats = train_leg_stats(res)
        n = epochs * steps
        if stats["train_stats"]["steps"] != n or not res["checkpoint"] or not stats["losses"] \
                or not all(math.isfinite(v) for v in stats["losses"]):
            fail(f"{recipe.name} train leg: {stats['train_stats']['steps']} steps, checkpoint {res['checkpoint']}, "
                 f"losses {stats['losses']}")
        if counts != {"depthwise3x3": (3 if remat else 2) * blocks * n, "depthwise3x3_wgrad": blocks * n}:
            fail(f"the {recipe.name} train leg should launch the depthwise kernels {(3 if remat else 2) * blocks} and "
                 f"{blocks} times a step for {n} steps: {counts}")
        stats["launches"] = counts
        log(f"{recipe.name} train leg: {n} steps in {stats['train_stats']['seconds']:.2f} s "
            f"({stats['steps_per_s']:.3f} steps/s, {stats['step_ms']:.1f} ms a step, {stats['data_wait_ms_per_step']:.1f} "
            f"of it waiting for batches; pipeline {stats['pipeline_host_ms_per_batch']:.1f} ms a batch); losses "
            f"{stats['losses'][0]:.4f} -> {stats['losses'][-1]:.4f}; launches {counts}")
        return res, stats

    def test_leg(recipe, root, tag, blocks, extra=()):
        fb.reset_launch_counts()
        t0 = time.perf_counter()
        res = dispatch_runtime(parse_args(["--config", str(recipe), "--device", str(dev), "--mode", "test",
                                           *extra, f"save_path={root}", *data("test", tag)]))
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = {k.__name__: k.launches for k in fb.KERNELS}
        if any(v <= 0 or v % blocks for v in res["launches"].values()):
            fail(f"the {recipe.name} test leg did not run every stride-1 block through the fused kernels: "
                 f"{res['launches']}")
        (timing,) = logs.take("timing[")
        res["timing"] = dict(zip(("read+normalise", "predict", "save", "decode", "evaluate"), timing[1:]))
        scores = next(iter(res["metrics"].values()))
        if not scores or not all(math.isfinite(v) for v in scores.values()):
            fail(f"{recipe.name} test metrics: {scores}")
        log(f"{recipe.name} test leg ({'restored ' + str(res['restored']['checkpoint']) if res.get('restored') else 'untrained'}): "
            f"{res['seconds']:.2f} s = " + ", ".join(f"{k} {v:.3f}" for k, v in res["timing"].items())
            + f"; {scores}; launches {res['launches']}")
        return res, scores

    try:
        root, control_root = work / "betaseg", work / "betaseg_control"
        train, stats = train_leg(BETASEG, root, "train", BETASEG_EPOCHS, BETASEG_STEPS, BETASEG_BLOCKS, True)
        lap("train_leg")
        test, scores = test_leg(BETASEG, root, "b", BETASEG_BLOCKS)
        if (test.get("restored") or {}).get("checkpoint") != train["checkpoint"]:
            fail(f"the betaseg test leg did not restore {train['checkpoint']}: {test.get('restored')}")
        lap("test_leg")
        shutil.rmtree(control_root, ignore_errors=True)
        control, control_scores = test_leg(BETASEG, control_root, "b", BETASEG_BLOCKS, ["evaluation.metrics=[voi]"])
        if control.get("restored"):
            fail(f"the control restored a checkpoint: {control['restored']}")
        lap("control_leg")
        if not {"adapted_rand", "voi", "instance_f1"} <= set(scores) or not scores["voi"] < control_scores["voi"]:
            fail(f"betaseg held-out VOI {scores.get('voi')} (trained) is not below {control_scores.get('voi')} "
                 "(untrained)")
        mt_root = work / "snemi_multitask"
        mt_train, mt_stats = train_leg(MULTITASK, mt_root, "mt_train", MULTITASK_EPOCHS, MULTITASK_STEPS,
                                       MULTITASK_BLOCKS, False, MULTITASK_SHAPE)
        gradnorm_logs = [json.loads(line) for line in (Path(mt_train["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
        gradnorm_w = [{k: v for k, v in r.items() if k.startswith("train_gradnorm_w_")} for r in gradnorm_logs
                      if any(k.startswith("train_gradnorm_w_") for k in r)]
        if not gradnorm_w or len(gradnorm_w[-1]) != 2:
            fail(f"the multi-task train leg logged no GradNorm weights: {gradnorm_logs[:2]}")
        lap("multitask_train_leg")
        mt_test, mt_scores = test_leg(MULTITASK, mt_root, "mt_b", MULTITASK_BLOCKS, MULTITASK_SHAPE)
        lap("multitask_test_leg")
    finally:
        port_log.removeHandler(logs)
    out.update(
        train=stats, test=dict(seconds=test["seconds"], timing=test["timing"], metrics_b=scores,
                               launches=test["launches"]),
        control=dict(seconds=control["seconds"], timing=control["timing"], metrics_b=control_scores,
                     launches=control["launches"]),
        multitask_train=dict(**mt_stats, gradnorm_weights=gradnorm_w),
        multitask_test=dict(seconds=mt_test["seconds"], timing=mt_test["timing"], metrics=mt_scores,
                            launches=mt_test["launches"]),
        seconds=time.perf_counter() - t_phase,
    )
    log(f"betaseg held-out B {BETASEG_TEST_SHAPE}: VOI {scores['voi']:.4f}, adapted Rand {scores['adapted_rand']:.4f}, "
        f"instance F1 {scores['instance_f1']:.4f}; untrained control VOI {control_scores['voi']:.4f}; multi-task GradNorm weights at the end {gradnorm_w[-1]}; held-out "
        f"{mt_scores}; phase {out['seconds']:.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    torch.cuda.empty_cache()


# phase 20: the rest of MedNeXt. tutorials/mito_mitolab.yaml (2-D MedNeXt-S,
# stock stem, bf16, bcd) and the (C, R, (Z, Y, X), blocks per forward) of its
# stride-1 blocks on its (1, 256, 256) window
MITOLAB = ROOT / "tutorials" / "mito_mitolab.yaml"
MITOLAB_TEST_BATCH, MITOLAB_TRAIN_BATCH = 16, 32
MITOLAB_STAGES = [
    (32, 64, (1, 256, 256), 4),
    (64, 128, (1, 128, 128), 4),
    (128, 256, (1, 64, 64), 4),
    (256, 512, (1, 32, 32), 4),
    (512, 1024, (1, 16, 16), 2),
]
MEDNEXT_BLOCKS = 18  # stride-1 blocks of a MedNeXt-S forward
# the UpKern leg: kernel 5 trained from phase 13's kernel-3 checkpoint (or a
# short kernel-3 leg of UPKERN_SOURCE_STEPS when phase 13 did not run), then
# tested on phase 5's 165x1024x768 volume with the recipe's flip TTA. Its
# steps are cut from 20 to 3: kernel-5 training runs cuDNN's 5^3 depthwise conv,
# about 9 s a step at batch 8 of 96^3 (ROADMAP B.11)
UPKERN_STEPS, UPKERN_SOURCE_STEPS = 3, 4
UPKERN_TRAIN_SHAPE = (96, 384, 384)
K5_CHECK_BATCH = 4  # the k 5 forward's kernel path against the f32 plain path
# mito_mitolab's seeded synthetic em2 volumes (its h5 volumes are not in the repository)
MITOLAB_TRAIN_SHAPE = (32, 768, 768)
MITOLAB_TEST_SHAPE = (24, 1024, 1024)
MITOLAB_STEPS = 20


def forward_check(fb, dev, name, cfg, shape, k, blocks, seed):
    """One bf16 forward of the MedNeXt ``cfg`` builds (seeded init) on a
    seeded ``shape`` batch: ``blocks`` launches of each pair kernel at
    stencil edge ``k`` and none at the other; the kernel path held to the f32
    plain path (relative error at most NISB_FWD_ERR_RATIO times the bf16
    plain path's) with fault probes (a dropped depthwise tap, dropped hidden
    units, in stage 0 and the last decoder stage, as betaseg's) the limit
    must reject; times."""
    import copy

    from pytorch_connectomics_tpu_torch.models import build_model

    def main_out(y):
        return y["out"] if isinstance(y, dict) else y

    model = build_model(cfg.model, device=dev, seed=0)
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.compute_dtype = "float32"
    model32 = build_model(cfg32.model, device=dev, seed=0)
    model32.load_state_dict(model.state_dict())
    x = device_randn(shape, seed, dev)
    with torch.inference_mode():
        fb.reset_launch_counts()
        y = main_out(model(x))
        torch.cuda.synchronize()
        counts = {f"{kern.__name__}_k{kk}": n for kern in fb.KERNELS for kk, n in kern.launches_k.items()}
        want_counts = {f"{kern.__name__}_k{kk}": blocks if kk == k else 0 for kern in fb.KERNELS
                       for kk in kern.launches_k}
        if counts != want_counts:
            fail(f"{name}: one forward should launch each pair kernel {blocks} times at k {k}, got {counts}")
        ref = main_out(model(x, plain=True))
        ref32 = main_out(model32(x, plain=True)).float()

        def rel(a):
            return ((a.float() - ref32).norm() / ref32.norm()).item()

        rel_k, rel_p = rel(y), rel(ref)
        if not torch.isfinite(y).all() or y.shape[:4] != shape[:4] or not rel_k <= NISB_FWD_ERR_RATIO * rel_p:
            fail(f"{name} {tuple(y.shape)}: the kernel path's error against f32 {rel_k:.3g}, more than "
                 f"{NISB_FWD_ERR_RATIO} x the bf16 plain path's {rel_p:.3g}")
        probes = {}
        for where, blk in (("stage 0", model.enc[0].blocks[0]), ("last decoder stage", model.dec[3].blocks[-1])):
            for fault, w, idx in (("dw tap (0,0,0) dropped", blk.conv_weight, (slice(None), 0, 0, 0, 0)),
                                  ("hidden units 0:16 dropped", blk.pw2.weight, (slice(None), slice(0, 16)))):
                with torch.inference_mode(False), torch.no_grad():
                    saved = w[idx].clone()
                    w[idx] = 0
                probes[f"{fault}, {where}"] = rel(main_out(model(x, plain=True))) / (NISB_FWD_ERR_RATIO * rel_p)
                with torch.inference_mode(False), torch.no_grad():
                    w[idx] = saved
        if min(probes.values()) <= 1.0:
            fail(f"{name}: the forward limit lets a fault probe pass: {probes}")
        ms = time_ms(lambda: model(x), reps=3, warmup=1)
        plain_ms = time_ms(lambda: model(x, plain=True), reps=1, warmup=0)
    log(f"{name} bf16 {tuple(shape)}: kernel path {ms:.2f} ms (plain {plain_ms:.2f}); relative error against f32 "
        f"{rel_k:.4g} (bf16 plain {rel_p:.4g}); fault probes over the limit: "
        + ", ".join(f"{key} {v:.3g}" for key, v in probes.items()))
    del model, model32, x, y, ref, ref32
    torch.cuda.empty_cache()
    return dict(shape=list(shape), k=k, ms=ms, plain_ms=plain_ms, rel_err_f32=rel_k, plain_rel_err_f32=rel_p,
                err_ratio_limit=NISB_FWD_ERR_RATIO, fault_probe_ratios=probes, launches_per_forward=counts)


def mednext_test_leg(fb, dev, logs, recipe, root, name, k, extra=(), checkpoint=None):
    """``--mode test`` of ``recipe`` through the CLI: its seconds, the test
    pipeline's timing line, its metrics and the pair's launches by stencil
    edge (all at ``k``, a multiple of the forward's 18 blocks)."""
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    fb.reset_launch_counts()
    t0 = time.perf_counter()
    args = ["--config", str(recipe), "--device", str(dev), "--mode", "test", f"save_path={root}", *extra]
    if checkpoint:
        args[6:6] = ["--checkpoint", str(checkpoint)]
    res = dispatch_runtime(parse_args(args))
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    counts = res["launches"] = {f"{kern.__name__}_k{kk}": n for kern in fb.KERNELS
                                for kk, n in kern.launches_k.items()}
    if any((v <= 0 or v % MEDNEXT_BLOCKS) if key.endswith(f"_k{k}") else v for key, v in counts.items()):
        fail(f"the {name} test leg did not run every stride-1 block through the pair at k {k}: {counts}")
    (timing,) = logs.take("timing[")
    res["timing"] = dict(zip(("read+normalise", "predict", "save", "decode", "evaluate"), timing[1:]))
    scores = next(iter(res["metrics"].values()))
    if not scores or not all(math.isfinite(v) for v in scores.values()):
        fail(f"{name} test metrics: {scores}")
    res["scores"] = scores
    log(f"{name} test leg ({'restored ' + str(res['restored']['checkpoint']) if res.get('restored') else 'untrained'}):"
        f" {res['seconds']:.2f} s = " + ", ".join(f"{key} {v:.3f}" for key, v in res["timing"].items())
        + f"; {scores}; launches {counts}")
    return res


def phase_mednext(dwk, fb, dev, work, report):
    log("== phase 20: the rest of MedNeXt: the k 5 and 2-D pair at their stages, the k 5, 2-D, refine and hybrid "
        "forwards, the fast recipe's UpKern leg (k 3 -> k 5, deep supervision) and tutorials/mito_mitolab.yaml "
        "through the CLI ==")
    import copy
    import shutil

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    out = report["mednext"] = {}
    t_phase = time.perf_counter()
    parts = out["part_seconds"] = {}
    last = [t_phase]

    def lap(what):
        now = time.perf_counter()
        parts[what] = now - last[0]
        last[0] = now

    # (c) the k 5 pair at the fast recipe's stride-1 stages (batch 16) and the
    # 2-D pair, (1, 3, 3) taps embedded in 3^3, at mito_mitolab's (batch 16)
    out["k5_rows"] = [pair_row(fb, dev, c, r, sp, per, dt, BATCH, 3, (5, 5, 5))
                      for dt in (torch.bfloat16, torch.float32) for c, r, sp, per in STAGES]
    lap("k5_rows")
    out["two_d_rows"] = [pair_row(fb, dev, c, r, sp, per, dt, MITOLAB_TEST_BATCH, 3, (1, 3, 3))
                         for dt in (torch.bfloat16, torch.float32) for c, r, sp, per in MITOLAB_STAGES]
    lap("two_d_rows")
    fast = load_model_config()
    k3_cfg, k5_cfg = copy.deepcopy(fast), copy.deepcopy(fast)
    k5_cfg.model.mednext.kernel_size = 5
    window = (BATCH, *fast.inference.window.window_size, 1)  # the test leg's windows, as phase 4's
    out["forward"] = {"k5": forward_check(fb, dev, "MedNeXt-S k 5", k5_cfg, (K5_CHECK_BATCH, *window[1:]), 5,
                                          MEDNEXT_BLOCKS, 41)}
    # the k 5 forward against k 3 at the recipe's inference batch, in the same call
    from pytorch_connectomics_tpu_torch.models import build_model

    x = device_randn(window, 42, dev)
    for tag, cfg in (("k3", k3_cfg), ("k5", k5_cfg)):
        model = build_model(cfg.model, device=dev, seed=0)  # outside inference mode: its weights stay versioned
        with torch.inference_mode():
            out["forward"][f"{tag}_batch16_ms"] = time_ms(lambda: model(x), reps=5, warmup=1)
        del model
    log(f"MedNeXt-S bf16 batch 16 of {window[1:4]}: k 3 {out['forward']['k3_batch16_ms']:.2f} ms, k 5 "
        f"{out['forward']['k5_batch16_ms']:.2f} ms")
    del x
    mito = load_config(MITOLAB, mode="test")
    m = mito.model
    if not (str(m.mednext.dim).lower() == "2d" and m.mednext.size == "S" and m.mednext.kernel_size == 3
            and list(m.input_size) == [1, 256, 256] and m.compute_dtype == "bfloat16"
            and list(mito.inference.window.window_size) == [1, 256, 256] and mito.inference.window.overlap == 0.25
            and mito.inference.window.blending == "gaussian"
            and mito.inference.window.sw_batch_size == MITOLAB_TEST_BATCH
            and list(mito.evaluation.metrics) == ["jaccard", "dice", "instance_f1"]):
        fail("mito_mitolab.yaml no longer ships 2-D MedNeXt-S bf16 k 3 on (1, 256, 256) windows (overlap 0.25, "
             "gaussian, batch 16) with jaccard, dice and instance F1")
    out["forward"]["two_d"] = forward_check(fb, dev, "MedNeXt-S 2-D (mito_mitolab)", mito,
                                            (MITOLAB_TEST_BATCH, 1, 256, 256, 1), 3, MEDNEXT_BLOCKS, 43)
    refine, hybrid = copy.deepcopy(fast), copy.deepcopy(fast)
    refine.model.mednext.patchify_head = "refine"
    hybrid.model.mednext.patchify_full_res_width = 16
    out["forward"]["refine"] = forward_check(fb, dev, "MedNeXt-S refine head", refine, (4, *window[1:]), 3,
                                             MEDNEXT_BLOCKS, 44)
    out["forward"]["hybrid"] = forward_check(fb, dev, "MedNeXt-S hybrid (w0 16)", hybrid, (4, *window[1:]), 3,
                                             MEDNEXT_BLOCKS + 2, 45)
    lap("forwards")

    logs = LogRecords(("timing[",))
    port_log = logging.getLogger("pytorch_connectomics_tpu_torch")
    port_log.addHandler(logs)
    try:
        # seeded em2 volumes made on the card, stored as uint8: the UpKern
        # leg's train volume (5 steps take little of it) and mito_mitolab's;
        # the UpKern test volume is phase 5's 165x1024x768 slice (made here
        # when phase 5 did not run)
        from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task

        vols = {}
        made = out["volume_seconds"] = {}
        for tag, shape, seed in (("upkern_train", UPKERN_TRAIN_SHAPE, 11), ("mitolab_train", MITOLAB_TRAIN_SHAPE, 21),
                                 ("mitolab_test", MITOLAB_TEST_SHAPE, 22)):
            t0 = time.perf_counter()
            img, lbl = synthetic_em_task("em2", shape, seed=seed, device=dev)
            vols[tag] = (work / f"md_{tag}_im.npy", work / f"md_{tag}_label.npy")
            np.save(vols[tag][0], np.round(img * 255).astype(np.uint8))
            np.save(vols[tag][1], lbl)
            made[tag] = time.perf_counter() - t0
        name = "syn{}x{}x{}".format(*LUCCHI_SHAPE)
        vols["lucchi_test"] = (work / f"{name}_im.npy", work / f"{name}_mito.npy")
        if not all(p.exists() for p in vols["lucchi_test"]):
            t0 = time.perf_counter()
            img, lbl = synthetic_volume(LUCCHI_SHAPE, 0)
            np.save(vols["lucchi_test"][0], img)
            np.save(vols["lucchi_test"][1], lbl)
            made["lucchi_test"] = time.perf_counter() - t0
        lap("volumes")

        def split(name, tag):
            return [f"data.{name}.image={vols[tag][0]}", f"data.{name}.label={vols[tag][1]}"]

        # (a) the fast recipe's UpKern leg: kernel 5 from the kernel-3 checkpoint, deep supervision
        data = [*split("train", "upkern_train"), *split("test", "lucchi_test"),
                "optimization.max_epochs=1", "monitor.logging.scalar.loss_every_n_steps=5"]
        flags = ["--config", str(RECIPE), "--device", str(dev)]
        source = ((report.get("fast_recipe") or {}).get("restored") or {}).get("checkpoint")
        if not source:
            root = work / "upkern_source"
            shutil.rmtree(root, ignore_errors=True)
            res = dispatch_runtime(parse_args(flags + ["--mode", "train", f"save_path={root}", *data,
                                                       f"optimization.n_steps_per_epoch={UPKERN_SOURCE_STEPS}"]))
            source = res["checkpoint"]
        out["upkern_source"] = str(source)
        root = work / "upkern_k5"
        shutil.rmtree(root, ignore_errors=True)
        k5 = ["model.mednext.kernel_size=5", f"model.mednext.upkern_from={source}", "model.loss.deep_supervision=true",
              f"save_path={root}"]
        dwk.reset_launch_counts()
        res = dispatch_runtime(parse_args(flags + ["--mode", "train", *data, *k5,
                                                   f"optimization.n_steps_per_epoch={UPKERN_STEPS}"]))
        torch.cuda.synchronize()
        stats = train_leg_stats(res)
        up = res.get("upkern") or {}
        recs = [json.loads(line) for line in (Path(res["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
        ds_logged = sorted({key for r in recs for key in r if "loss_ds_" in key})
        if stats["train_stats"]["steps"] != UPKERN_STEPS or not res["checkpoint"] or not stats["losses"] \
                or not all(math.isfinite(v) for v in stats["losses"]) or up.get("inflated", 0) <= 0 \
                or up.get("kept") != 2 * 3 or not ds_logged:  # kept: the new ds heads' weights and biases
            fail(f"the UpKern train leg: {stats['train_stats']['steps']} steps, checkpoint {res['checkpoint']}, "
                 f"losses {stats['losses']}, UpKern {up}, ds losses logged {ds_logged}")
        # k 5 trains through conv3d_same(groups=C): no depthwise ring kernel
        stats["launches"] = {kern.__name__: kern.launches for kern in dwk.KERNELS}
        if any(stats["launches"].values()):
            fail(f"the k 5 train leg launched the 3^3 depthwise kernels: {stats['launches']}")
        stats["upkern"], stats["ds_logged"] = up, ds_logged
        log(f"UpKern train leg (k 3 -> k 5 from {source}, deep supervision): {up}; {UPKERN_STEPS} steps in "
            f"{stats['train_stats']['seconds']:.2f} s ({stats['steps_per_s']:.3f} steps/s, {stats['step_ms']:.1f} ms "
            f"a step, {stats['data_wait_ms_per_step']:.1f} of it waiting for batches); losses {stats['losses'][0]:.4f}"
            f" -> {stats['losses'][-1]:.4f}; ds terms logged {ds_logged}")
        out["upkern_train"] = stats
        lap("upkern_train")
        test = mednext_test_leg(fb, dev, logs, RECIPE, root, "UpKern k 5", 5, data[2:4] + k5[:1] + k5[2:3])
        if (test.get("restored") or {}).get("checkpoint") != res["checkpoint"]:
            fail(f"the UpKern test leg did not restore {res['checkpoint']}: {test.get('restored')}")
        predict_s = test["timing"]["predict"]
        out["upkern_test"] = dict(seconds=test["seconds"], timing=test["timing"], metrics=test["scores"],
                                  launches=test["launches"], predict_mvox_per_s=math.prod(LUCCHI_SHAPE) / predict_s / 1e6)
        log(f"UpKern test leg: predict {predict_s:.2f} s for {LUCCHI_SHAPE} with flip TTA "
            f"({out['upkern_test']['predict_mvox_per_s']:.3f} Mvox/s)")
        lap("upkern_test")

        # (b) mito_mitolab.yaml as shipped on seeded em2 volumes: train, test, the control, direct 2-D
        mroot, control_root = work / "mitolab", work / "mitolab_control"
        shutil.rmtree(mroot, ignore_errors=True)
        shutil.rmtree(control_root, ignore_errors=True)
        mdata = [*split("train", "mitolab_train"), *split("test", "mitolab_test")]
        dwk.reset_launch_counts()
        # one change from the recipe: aug_standard's missing_section blanks a whole (1, 256, 256) sample to
        # zeros, whose gradient overflows at init in both packages (ROADMAP C.11)
        mres = dispatch_runtime(parse_args(["--config", str(MITOLAB), "--device", str(dev), "--mode", "train",
                                            f"save_path={mroot}", *mdata[:2], "optimization.max_epochs=1",
                                            "data.augmentation.missing_section.enabled=false",
                                            f"optimization.n_steps_per_epoch={MITOLAB_STEPS}",
                                            "monitor.logging.scalar.loss_every_n_steps=5"]))
        torch.cuda.synchronize()
        mstats = train_leg_stats(mres)
        mstats["launches"] = {kern.__name__: kern.launches for kern in dwk.KERNELS}
        want = {"depthwise3x3": 2 * MEDNEXT_BLOCKS * MITOLAB_STEPS, "depthwise3x3_wgrad": MEDNEXT_BLOCKS * MITOLAB_STEPS}
        if mstats["train_stats"]["steps"] != MITOLAB_STEPS or not mres["checkpoint"] or not mstats["losses"] \
                or not all(math.isfinite(v) for v in mstats["losses"]) or mstats["launches"] != want:
            fail(f"the mito_mitolab train leg: {mstats['train_stats']['steps']} steps, checkpoint {mres['checkpoint']},"
                 f" losses {mstats['losses']}, depthwise launches {mstats['launches']} (want {want})")
        log(f"mito_mitolab train leg (2-D, batch {MITOLAB_TRAIN_BATCH} of 1x256x256, aug_standard): {MITOLAB_STEPS} "
            f"steps in {mstats['train_stats']['seconds']:.2f} s ({mstats['steps_per_s']:.3f} steps/s, "
            f"{mstats['data_wait_ms_per_step']:.1f} ms a step waiting for batches); losses {mstats['losses'][0]:.4f} -> "
            f"{mstats['losses'][-1]:.4f}; launches {mstats['launches']}")
        out["mitolab_train"] = mstats
        lap("mitolab_train")
        mtest = mednext_test_leg(fb, dev, logs, MITOLAB, mroot, "mito_mitolab", 3, mdata[2:])
        if (mtest.get("restored") or {}).get("checkpoint") != mres["checkpoint"]:
            fail(f"the mito_mitolab test leg did not restore {mres['checkpoint']}: {mtest.get('restored')}")
        control = mednext_test_leg(fb, dev, logs, MITOLAB, control_root, "mito_mitolab control", 3, mdata[2:])
        if control.get("restored"):
            fail(f"the mito_mitolab control restored a checkpoint: {control['restored']}")
        direct = mednext_test_leg(fb, dev, logs, MITOLAB, mroot, "mito_mitolab direct 2-D", 3,
                                  mdata[2:] + ["inference.direct_2d=true"], checkpoint=mres["checkpoint"])
        # the 2-D recipe learns on the card: both trained test legs' held-out jaccard above the untrained one's
        for name, leg in (("test", mtest), ("direct 2-D", direct)):
            if not leg["scores"]["jaccard"] > control["scores"]["jaccard"]:
                fail(f"mito_mitolab {name} jaccard {leg['scores']['jaccard']:.4f} (trained) is not above "
                     f"{control['scores']['jaccard']:.4f} (untrained)")
        for key, leg in (("mitolab_test", mtest), ("mitolab_control", control), ("mitolab_direct_2d", direct)):
            out[key] = dict(seconds=leg["seconds"], timing=leg["timing"], metrics=leg["scores"],
                            launches=leg["launches"],
                            predict_mvox_per_s=math.prod(MITOLAB_TEST_SHAPE) / leg["timing"]["predict"] / 1e6)
        lap("mitolab_test")
    finally:
        port_log.removeHandler(logs)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"mito_mitolab on {MITOLAB_TEST_SHAPE}: trained {mtest['scores']}, untrained control {control['scores']}, "
        f"direct 2-D {direct['scores']}; phase {out['seconds']:.1f} s: "
        + ", ".join(f"{key} {v:.1f}" for key, v in parts.items()))
    torch.cuda.empty_cache()


def k5_line_rows(rows, test_launches):
    """The k 5 pair's entries of the kernels line, per forward of the
    UpKern leg's k 5 MedNeXt-S (bf16, batch 16): each stage's times times
    its blocks; launches from that leg's test run."""
    source = "pytorch_connectomics_tpu_torch/ops/csrc/mednext_block.cu"
    replaces = {
        "dw_stats": "pytorch_connectomics_tpu/ops/fused_block_pallas.py:148",
        "fused_block_apply": "pytorch_connectomics_tpu/ops/fused_block_pallas.py:238",
    }
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    kernels = []
    for name in ("dw_stats", "fused_block_apply"):
        def per_forward(key, name=name):
            vals = [r[name][key] for r in bf16]
            return None if any(v is None for v in vals) else sum(v * r["blocks_per_forward"] for v, r in zip(vals, bf16))

        def bound_part(kind, name=name):
            return sum(r[name]["bound_parts"][kind] * r["blocks_per_forward"] for r in bf16)

        kernels.append(dict(
            name=f"{name}_k5", route="cuda", source=source, replaces=replaces[name],
            launches=test_launches[f"{name}_k5"], max_abs_err=max(r[name]["max_abs_err"] for r in bf16),
            ms=per_forward("ms"), plain_ms=per_forward("plain_ms"), bound_ms=per_forward("bound_ms"),
            bound_by="bytes" if bound_part("bytes") >= bound_part("ops") else "operations",
            library_ms=per_forward("library_ms"),
        ))
    return kernels


def wgrad_line_row(rows, launches):
    """The weight-gradient kernel's entry of the kernels line, per SNEMI
    train step (batch 8 of (18, 160, 160), bf16): each layer shape's times
    times its launches a step."""
    snemi = [r for r in rows if r["recipe"] == "snemi" and r["dtype"] == "bfloat16"]

    def per_step(key):
        return sum(r["wgrad"][key] * r["launches_per_step"] for r in snemi)

    def bound_part(kind):
        return sum(r["wgrad"]["bound_parts"][kind] * r["launches_per_step"] for r in snemi)

    return dict(
        name="conv3d_3x3_wgrad", route="cuda", source="pytorch_connectomics_tpu_torch/ops/csrc/conv3d_3x3.cu",
        replaces="pytorch_connectomics_tpu/ops/conv3d_pallas.py:84", launches=launches,
        max_abs_err=max(r["wgrad"]["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
        ms=per_step("ms"), plain_ms=per_step("plain_ms"), bound_ms=per_step("bound_ms"),
        bound_by="bytes" if bound_part("bytes") >= bound_part("ops") else "operations",
        library_ms=per_step("library_ms"),
    )


def nucmm_volume(dev, work):
    """(image, label) .npy paths of the seeded synthetic NucMM-Z volume
    (em2, 165x1024x768) with its label's connected components as instances,
    made on the card once and kept in ``work``; and the seconds it took."""
    from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
    from pytorch_connectomics_tpu_torch.ops import native

    name = "nuc{}x{}x{}".format(*NUCMM_SHAPE)
    im, lb = work / f"{name}_im.npy", work / f"{name}_label.npy"
    t0 = time.perf_counter()
    if not (im.exists() and lb.exists()):
        img, lbl = synthetic_em_task("em2", NUCMM_SHAPE, seed=3, device=dev)
        gt, _ = native.connected_components(lbl > 0, 6)  # instance ground truth
        np.save(im, img)
        np.save(lb, gt)
    return im, lb, time.perf_counter() - t0


def train_leg_stats(res):
    st = res["train_stats"]
    recs = [json.loads(line) for line in (Path(res["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss_total"] for r in recs if "train_loss_total" in r]
    return dict(
        train_stats=st, steps_per_s=st["steps"] / st["seconds"], step_ms=st["seconds"] / st["steps"] * 1e3,
        data_wait_ms_per_step=st["data_wait_seconds"] / st["steps"] * 1e3,
        pipeline_host_ms_per_batch=st["pipeline_host_seconds"] / max(1, st["pipeline_batches"]) * 1e3,
        losses=losses,
    )


def phase_rsunet_recipes(c3, dev, work, report):
    log("== phase 16: the RSUNet recipes through the CLI: SNEMI train -> tune -> tune-test and the untrained "
        "control; NucMM-Z train ==")
    import shutil

    import yaml

    from pytorch_connectomics_tpu_torch.data.io import read_volume
    from pytorch_connectomics_tpu_torch.data.synthetic import synthetic_em_task
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    out = report["rsunet_recipes"] = {}
    t0 = time.perf_counter()
    vols = {}
    for tag, shape, seed in (("train", SNEMI_TRAIN_SHAPE, 31), ("a", SNEMI_TUNE_SHAPE, 32), ("b", SNEMI_TUNE_SHAPE, 33)):
        img, lbl = synthetic_em_task("instance", shape, seed=seed, device=dev)
        vols[tag] = (work / f"snemi_{tag}_im.npy", work / f"snemi_{tag}_label.npy")
        np.save(vols[tag][0], img)
        np.save(vols[tag][1], lbl)
    out["volumes_seconds"] = time.perf_counter() - t0
    log(f"SNEMI volumes (synthetic instance: train {SNEMI_TRAIN_SHAPE}, A and B {SNEMI_TUNE_SHAPE}) made in "
        f"{out['volumes_seconds']:.1f} s")
    run_root, control_root, nuc_root = work / "snemi", work / "snemi_control", work / "nucmm_train"
    for d in (run_root, control_root, nuc_root):
        shutil.rmtree(d, ignore_errors=True)

    def data(split, tag):
        return [f"data.{split}.image={vols[tag][0]}", f"data.{split}.label={vols[tag][1]}"]

    flags = ["--config", str(SNEMI), "--device", str(dev)]
    logs = LogRecords(("timing[", "trial %d/%d"))
    port_log = logging.getLogger("pytorch_connectomics_tpu_torch")
    port_log.addHandler(logs)
    try:
        c3.reset_launch_counts()
        t0 = time.perf_counter()
        train = dispatch_runtime(parse_args(flags + [
            "--mode", "train", f"save_path={run_root}", f"optimization.max_epochs={SNEMI_EPOCHS}",
            f"optimization.n_steps_per_epoch={SNEMI_STEPS}", *data("train", "train")]))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in c3.KERNELS + (c3.conv3d_3x3_input_grad,)}
        steps = SNEMI_EPOCHS * SNEMI_STEPS
        stats = train_leg_stats(train)
        if stats["train_stats"]["steps"] != steps or not train["checkpoint"] or not stats["losses"] \
                or not all(math.isfinite(v) for v in stats["losses"]):
            fail(f"SNEMI train leg: {stats['train_stats']['steps']} steps, checkpoint {train['checkpoint']}, "
                 f"losses {stats['losses']}")
        if counts["conv3d_3x3_wgrad"] != 14 * steps or counts["conv3d_3x3_input_grad"] != 14 * steps \
                or counts["conv3d_3x3"] != 28 * steps:
            fail(f"the SNEMI train leg should launch 14 forward, 14 input-gradient and 14 weight-gradient convs a "
                 f"step for {steps} steps: {counts}")
        stats.update(seconds=train_s, launches=counts)
        log(f"SNEMI train leg: {steps} steps in {stats['train_stats']['seconds']:.2f} s ({stats['steps_per_s']:.3f} "
            f"steps/s, {stats['step_ms']:.1f} ms a step, {stats['data_wait_ms_per_step']:.1f} of it waiting for "
            f"batches; pipeline {stats['pipeline_host_ms_per_batch']:.1f} ms a batch); losses {stats['losses'][0]:.4f} "
            f"-> {stats['losses'][-1]:.4f}; launches {counts}")

        def leg(mode, root, extra):
            c3.reset_launch_counts()
            t0 = time.perf_counter()
            res = dispatch_runtime(parse_args(flags + ["--mode", mode] + extra + [f"save_path={root}"]))
            torch.cuda.synchronize()
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = c3.conv3d_3x3.launches
            if res["launches"] <= 0:
                fail(f"the {mode} leg did not run through the conv kernel")
            return res

        tune = leg("tune", run_root, ["--tune-trials", str(SNEMI_TRIALS), *data("test", "a")])
        if (tune.get("restored") or {}).get("checkpoint") != train["checkpoint"]:
            fail(f"the tune leg did not restore {train['checkpoint']}: {tune.get('restored')}")
        study = yaml.safe_load(Path(tune["best_params"]).read_text())
        trials = [a[4] for a in logs.take("trial %d/%d")]
        (tune_timing,) = logs.take("timing[")
        if len(trials) != SNEMI_TRIALS or study["metric"] != "adapted_rand":
            fail(f"the tune leg ran {len(trials)} trials on {study['metric']}: {study['trials']}")
        test = leg("tune-test", run_root, ["--best-params", tune["best_params"], *data("test", "b")])
        (test_timing,) = logs.take("timing[")
        control = leg("tune-test", control_root, ["--best-params", tune["best_params"], *data("test", "b")])
        logs.take("timing[")
    finally:
        port_log.removeHandler(logs)
    if control.get("restored"):
        fail(f"the control restored a checkpoint: {control['restored']}")
    pred = read_volume(str(next(f for f in Path(test["run_dir"]).iterdir()
                                if f.name.endswith(("_prediction.h5", "_prediction.npy")))))
    if pred.shape != (9, *SNEMI_TUNE_SHAPE) or not np.isfinite(pred).all() or pred.min() < 0 or pred.max() > 1:
        fail(f"tune-test prediction {pred.shape} not finite in [0, 1] of shape (9, {SNEMI_TUNE_SHAPE})")
    if "_tta_x4_" not in next(f.name for f in Path(test["run_dir"]).iterdir() if "_prediction." in f.name):
        fail("the tune-test leg did not predict with the recipe's 4 flip variants")
    scores, control_scores = (next(iter(r["metrics"].values())) for r in (test, control))
    for sc in (scores, control_scores):
        if not ({"voi", "adapted_rand"} <= set(sc) and all(math.isfinite(v) for v in sc.values())):
            fail(f"tune-test metrics: {sc}")
    # the recipe learns on the card: the trained model's held-out adapted Rand below the untrained one's
    if not scores["adapted_rand"] < control_scores["adapted_rand"]:
        fail(f"held-out adapted Rand {scores['adapted_rand']:.4f} (trained) is not below "
             f"{control_scores['adapted_rand']:.4f} (untrained)")
    names = ("read+normalise", "predict", "save", "decode", "evaluate")
    out.update(
        snemi_train=stats,
        tune=dict(seconds=tune["seconds"], timing=dict(zip(names, tune_timing[1:])), trial_seconds=trials,
                  mean_trial_seconds=sum(trials) / len(trials), best_params=study["best_params"],
                  best_adapted_rand_a=study["best_value"], launches=tune["launches"]),
        tune_test=dict(seconds=test["seconds"], timing=dict(zip(names, test_timing[1:])), metrics_b=scores,
                       launches=test["launches"]),
        control=dict(metrics_b=control_scores, launches=control["launches"]),
    )
    log(f"tune leg (volume A, {len(trials)} trials): {tune['seconds']:.2f} s, predict {tune_timing[2]:.3f} s, "
        f"{out['tune']['mean_trial_seconds']:.3f} s a trial; best adapted Rand {study['best_value']:.4f} with "
        f"{study['best_params']}")
    log(f"tune-test leg (held-out volume B, flip TTA x4, min): {test['seconds']:.2f} s, predict {test_timing[2]:.3f} "
        f"s, decode {test_timing[4]:.3f} s, evaluate {test_timing[5]:.3f} s; adapted Rand {scores['adapted_rand']:.4f}, "
        f"VOI {scores['voi']:.4f}; untrained control adapted Rand {control_scores['adapted_rand']:.4f}, VOI "
        f"{control_scores['voi']:.4f}")
    # the NucMM-Z train leg on the NucMM-Z test geometry's synthetic volume
    im, lb, setup_s = nucmm_volume(dev, work)
    c3.reset_launch_counts()
    nuc = dispatch_runtime(parse_args([
        "--config", str(NUCMM), "--device", str(dev), "--mode", "train", f"save_path={nuc_root}",
        "optimization.max_epochs=1", f"optimization.n_steps_per_epoch={NUCMM_TRAIN_STEPS}",
        f"data.train.image={im}", f"data.train.label={lb}"]))
    torch.cuda.synchronize()
    nstats = train_leg_stats(nuc)
    wl = c3.conv3d_3x3_wgrad.launches
    if nstats["train_stats"]["steps"] != NUCMM_TRAIN_STEPS or not nstats["losses"] \
            or not all(math.isfinite(v) for v in nstats["losses"]) or wl != 15 * NUCMM_TRAIN_STEPS:
        fail(f"NucMM-Z train leg: {nstats['train_stats']['steps']} steps, losses {nstats['losses']}, {wl} weight-"
             f"gradient launches")
    nstats.update(setup_s=setup_s, wgrad_launches=wl)
    out["nucmm_train"] = nstats
    log(f"NucMM-Z train leg: {NUCMM_TRAIN_STEPS} steps in {nstats['train_stats']['seconds']:.2f} s "
        f"({nstats['steps_per_s']:.3f} steps/s, {nstats['step_ms']:.1f} ms a step, {nstats['data_wait_ms_per_step']:.1f} "
        f"waiting; pipeline {nstats['pipeline_host_ms_per_batch']:.1f} ms a batch); losses {nstats['losses'][0]:.4f} "
        f"-> {nstats['losses'][-1]:.4f}; volume ready in {setup_s:.1f} s")
    return counts


def phase_probes(dev, work, report):
    log("== phase 12: probes: the measurement entry points, then the fused MLP at MedNeXt-S's widths ==")
    from pytorch_connectomics_tpu_torch.ops import conv3d as c3, depthwise as dwk, fused_mlp as fm, probes as pk
    from pytorch_connectomics_tpu_torch.tools import device_ms, host_us, microbench, probes as probe_tool, randn as seeded

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
            on_host = f"; host {r['host_us']:.2f} us" if "host_us" in r else ""
            on_host += f", library's {r['library_host_us']:.2f} us" if "library_host_us" in r else ""
            on_host += f"; device alone {r['device_ms']:.5f} ms" if r.get("device_ms") is not None else ""
            log(f"{r['name']:26s} {r['kernel']:18s} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {lib}, "
                f"bound {r['bound_ms']:.4f} {r['bound_by']}{on_host}) err {r['max_abs_err']:.3g} (tol: {r['tol']})")
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
            kern = lambda: fm.fused_mlp_residual(x, w1, b1, w2, b2)  # noqa: E731
            # the plan the wrapper takes (the planner's, with the card's report)
            plan = fm.card_plan(m, c, e, dtype) if hasattr(fm, "card_plan") else None
            row = dict(
                kernel="fused_mlp_residual", C=c, E=e, rows=m, dtype=str(dtype).split(".")[-1], blocks_per_forward=per_fwd,
                plan=plan, ms=time_ms(kern, reps), device_ms=device_ms(kern, reps),
                host_us=host_us(kern, 200, dev),
                plain_ms=time_ms(lambda: fm.fused_mlp_residual_plain(x, w1, b1, w2, b2), reps),
                unfused_library_ms=time_ms(unfused, reps), unfused_library_device_ms=device_ms(unfused, reps),
                **microbench.mlp_bound(m, c, e, es), max_abs_err=err.max().item(), max_rel_err=rel, tol=tol,
            )
            rows.append(row)
            log(f"fused_mlp C={c:4d} E={e:5d} M={m:8d} {row['dtype']:8s} {row['ms']:.4f} ms, device {row['device_ms']:.4f}, "
                f"host {row['host_us']:.1f} us (plain {row['plain_ms']:.4f}, unfused cuBLAS {row['unfused_library_ms']:.4f}, "
                f"device {row['unfused_library_device_ms']:.4f}; bound {row['bound_ms']:.4f} {row['bound_by']}) "
                f"err {row['max_abs_err']:.3g} <= {tol:.3g}")
            if plan is not None:
                log(f"  plan {json.dumps(plan)}")
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



# phase 21: the rest of training. syn_cremi (MONAI U-Net [28,36,48,64,80],
# 2 residual units, bf16, batch 8 of 16x160x160, the polarity target) and the
# other legs on seeded volumes made on the card (the CREMI and fibre volumes
# are not in the repository): synthetic://blobs, whose odd ids are pre- and
# even ids post-synaptic as seg_to_polarity reads them
SYN_CREMI = ROOT / "tutorials" / "syn_cremi.yaml"
FIBER = ROOT / "tutorials" / "fiber_linghu.yaml"
SYN_BATCH = 8
# the train step held to the plain path at half the recipe's batch: the plain
# path's autograd keeps every tap's f32 product, past 80 GB at batch 8
SYN_STEP_BATCH = 4
SYN_TRAIN_SHAPE = (48, 480, 480)
SYN_TEST_SHAPE = (32, 320, 320)
SYN_STEPS = 20
FIBER_SHAPE = (64, 384, 384)
FIBER_STEPS = 8
OPT_STEPS = 4
# the fast recipe's volume for the augmentation check (a batch of 96^3 patches)
AUG_CHECK_SHAPE = (96, 384, 384)
# the CPU apply of the card's augmentation draws: intensity transforms within
# this (sums and powers in another order), the others bit for bit
AUG_TOL = 1e-6


def syn_cremi_batch(cfg, dev):
    """Batch 8 of syn_cremi's training patch from its pipeline (host
    augmentation off) on a seeded blob volume made on the card."""
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.pipeline import build_pipelines

    shape = "shape={},{},{}".format(*SYN_TRAIN_SHAPE)
    bcfg = load_config(SYN_CREMI, mode="train", overrides=[
        f"data.train.image=synthetic://blobs/syn_step_image?{shape}&seed=50",
        f"data.train.label=synthetic://blobs/syn_step_label?{shape}&seed=50", "data.augmentation.enabled=false"])
    train, _ = build_pipelines(bcfg, dev)
    try:
        batch = train.make_batch(0)
    finally:
        train.close()
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def syn_cremi_kernels(c3, dev, out):
    """syn_cremi's stride-1 3^3 convs: their shapes recorded on one forward,
    each shape's kernels against their plain versions (bf16 at batch 8,
    timed); the forward and one train step of the kernel path against the
    plain path (whole gradient in bf16 at batch SYN_STEP_BATCH, each leaf in
    f32 at batch 2), with a fault probe; launches per forward and per step."""
    from collections import Counter

    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.models.layers import Conv

    cfg = load_config(SYN_CREMI, mode="train")
    m, dl = cfg.model, cfg.data.dataloader
    if (m.arch.type != "monai_unet" or list(m.monai.filters) != [28, 36, 48, 64, 80] or m.monai.num_res_units != 2
            or m.compute_dtype != "bfloat16" or dl.batch_size != SYN_BATCH or list(dl.patch_size) != [16, 160, 160]
            or [t.name for t in cfg.data.label_transform.targets] != ["polarity"]):
        fail("syn_cremi.yaml no longer trains the MONAI U-Net [28,36,48,64,80] bf16 on batch 8 of 16x160x160 polarity")
    model = build_model(m, device=dev, seed=0)
    with torch.no_grad():  # seeded nonzero conv biases: a bias the kernel drops must show
        g = torch.Generator().manual_seed(1)
        for mod in model.modules():
            if isinstance(mod, Conv):
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=g))
    batch = syn_cremi_batch(cfg, dev)
    x, y = batch["image"], batch["label"]
    seen = Counter()
    conv = c3.conv3d_3x3

    def record(xx, w, b=None, **kw):
        seen[(tuple(xx.shape[1:4]), xx.shape[-1], w.shape[0])] += 1
        return conv(xx, w, b, **kw)

    record.launches = 0
    c3.conv3d_3x3 = record
    try:
        with torch.no_grad():
            model(x)
    finally:
        c3.conv3d_3x3 = conv
    rows = []
    for (spatial, cin, cout), per in sorted(seen.items(), key=lambda kv: (-kv[0][0][1], kv[0][1], kv[0][2])):
        rows.append(unet_conv_row(c3, dev, spatial, cin, cout, per, torch.bfloat16, SYN_BATCH, recipe="syn_cremi"))
        torch.cuda.empty_cache()
    per_fwd = {k: sum(r[k]["ms"] * r["launches_per_step"] for r in rows) for k in ("forward", "input_grad", "wgrad")}
    bounds = {k: sum(r[k]["bound_ms"] * r["launches_per_step"] for r in rows) for k in ("forward", "input_grad", "wgrad")}
    libs = {k: sum(r[k]["library_ms"] * r["launches_per_step"] for r in rows) for k in ("forward", "input_grad", "wgrad")}
    n_fwd = sum(seen.values())
    log(f"syn_cremi's {n_fwd} stride-1 3^3 convs ({len(rows)} shapes) a forward (bf16, batch 8 of 16x160x160): "
        + ", ".join(f"{k} {per_fwd[k]:.3f} ms (bound {bounds[k]:.3f}, library {libs[k]:.3f})"
                    for k in ("forward", "input_grad", "wgrad")))
    with torch.no_grad():
        c3.reset_launch_counts()
        got = model(x)
        torch.cuda.synchronize()
        fwd_counts = conv_counts(c3)
        want = model(x, plain=True)
        fwd_err = ((got - want).abs().max() / want.abs().max()).item()
        fwd_ms = time_ms(lambda: model(x), 5)
        plain_fwd_ms = time_ms(lambda: model(x, plain=True), 2)
    if fwd_counts != dict(forward=n_fwd, input_grad=0, wgrad=0):
        fail(f"one syn_cremi forward should launch conv3d_3x3 {n_fwd} times: {fwd_counts}")
    if not torch.isfinite(got).all() or fwd_err > UNET_BF16_TOL:
        fail(f"syn_cremi forward kernel vs plain: {fwd_err:.4g} of max |plain| > {UNET_BF16_TOL}")
    log(f"syn_cremi forward (bf16, batch 8 of 16x160x160): {fwd_ms:.2f} ms (plain path {plain_fwd_ms:.1f} ms), kernel "
        f"vs plain {fwd_err:.4g} of max |plain| (limit {UNET_BF16_TOL}), launches {fwd_counts}")
    del got, want
    orch = LossOrchestrator(cfg.model.loss)
    xs, ys = x[:SYN_STEP_BATCH].contiguous(), y[:SYN_STEP_BATCH].contiguous()

    def loss_and_grads(plain, net=model, xx=xs, yy=ys):
        net.zero_grad(set_to_none=True)
        loss, _ = orch(net(xx, plain=plain), yy)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in net.named_parameters()}

    model.train()
    c3.reset_launch_counts()
    loss_k, g_k = loss_and_grads(False)
    torch.cuda.synchronize()
    step_counts = conv_counts(c3)
    torch.cuda.empty_cache()
    if step_counts["forward"] != n_fwd or step_counts["wgrad"] != n_fwd or not 0 < step_counts["input_grad"] <= n_fwd:
        fail(f"one syn_cremi train step should launch {n_fwd} forward and weight-gradient convs and an input gradient "
             f"for each but a first layer's: {step_counts}")
    loss_p, g_p = loss_and_grads(True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs, shares, whole = unet_leaf_errors(g_k, g_p, UNET_SMALL_LEAF)
    log(f"syn_cremi step (batch {SYN_STEP_BATCH}): loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel err {loss_err:.3g}); whole gradient "
        f"{whole:.4g} (limit {UNET_TRAIN_GRAD_TOL}); launches {step_counts}")
    if not math.isfinite(loss_k) or loss_err > UNET_TRAIN_LOSS_TOL:
        fail(f"syn_cremi train step loss: kernel {loss_k} vs plain {loss_p} (rel err {loss_err:.3g})")
    if whole > UNET_TRAIN_GRAD_TOL:
        fail(f"syn_cremi train step gradient: error {whole:.3g} > {UNET_TRAIN_GRAD_TOL}")
    wgrad = c3.conv3d_3x3_wgrad

    def drop_tap(xx, dd, grid=None):
        gg = wgrad(xx, dd).clone()
        gg[:, :, 0, 0, 0] = 0
        return gg

    drop_tap.launches = 0
    c3.conv3d_3x3_wgrad = drop_tap
    try:
        probe = unet_leaf_errors(loss_and_grads(False)[1], g_p, UNET_SMALL_LEAF)[2]
    finally:
        c3.conv3d_3x3_wgrad = wgrad
    if probe <= UNET_TRAIN_GRAD_TOL:
        fail(f"the gradient limit {UNET_TRAIN_GRAD_TOL} lets the dropped-tap probe pass on syn_cremi: {probe}")
    # the same step in f32 at batch 2 (the f32 kernels): every leaf within UNET_F32_GRAD_TOL
    fcfg = load_config(SYN_CREMI, overrides=["optimization.precision=32"], mode="train")
    fmodel = build_model(fcfg.model, device=dev, seed=0)
    fmodel.load_state_dict(model.state_dict())
    fmodel.train()
    f_args = dict(net=fmodel, xx=x[:2].contiguous(), yy=y[:2].contiguous())
    _, fg_k = loss_and_grads(False, **f_args)
    _, fg_p = loss_and_grads(True, **f_args)
    ferrs, _, fwhole = unet_leaf_errors(fg_k, fg_p, UNET_SMALL_LEAF)
    fworst = max(ferrs, key=ferrs.get)
    log(f"syn_cremi f32 step (batch 2): worst leaf {fworst} {ferrs[fworst]:.3g} (limit {UNET_F32_GRAD_TOL}), whole "
        f"{fwhole:.3g}; dropped-tap probe (bf16) {probe:.4g}")
    if ferrs[fworst] > UNET_F32_GRAD_TOL:
        fail(f"syn_cremi f32 train step leaf {fworst}: error {ferrs[fworst]:.3g} > {UNET_F32_GRAD_TOL}")
    out.update(conv_rows=rows, conv_launches_per_forward=n_fwd, kernel_ms_per_forward=per_fwd,
               bound_ms_per_forward=bounds, library_ms_per_forward=libs,
               forward=dict(ms=fwd_ms, plain_ms=plain_fwd_ms, err=fwd_err, launches=fwd_counts),
               step=dict(loss_err=loss_err, grad_err=whole, probe_err=probe, f32_worst_leaf=[fworst, ferrs[fworst]],
                         launches=step_counts))
    del model, fmodel, batch
    torch.cuda.empty_cache()
    return n_fwd, step_counts


def check_device_augmentation(dev, out):
    """The fast recipe's on-device augmentation on one batch (8 of 96^3, its
    host pipeline's, augmentation off, from a seeded em2 AUG_CHECK_SHAPE
    volume) on the card: each transform's apply on the card's draws against
    the same apply on the CPU with those draws (geometric and masking
    transforms bit for bit, intensity within AUG_TOL), the whole
    augmentation with no device-to-host copy (CUDA's sync debug mode raises
    at any), its time on the card, and the recipe's train step on that batch
    timed with and without it (CUDA events)."""
    from pytorch_connectomics_tpu_torch.config import load_config
    from pytorch_connectomics_tpu_torch.data.pipeline import build_pipelines
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model
    from pytorch_connectomics_tpu_torch.ops import augment
    from pytorch_connectomics_tpu_torch.training.loop import device_augment_fn
    from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
    from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step, step_generator

    shape = "shape={},{},{}".format(*AUG_CHECK_SHAPE)
    cfg = load_config(RECIPE, mode="train", overrides=[
        f"data.train.image=synthetic://em2/aug_check_image?{shape}&seed=13",
        f"data.train.label=synthetic://em2/aug_check_label?{shape}&seed=13", "data.augmentation.on_device=true"])
    train, _ = build_pipelines(cfg, dev)
    try:
        if train.augment is not None:
            fail("with augmentation.on_device the host pipeline still augments")
        host = train.make_batch(0)
    finally:
        train.close()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    geometric = {name for name, _, _, geo in augment.DEVICE_ORDER if geo}
    gen = step_generator(cfg.system.seed, 0, dev)
    n, shp = batch["image"].shape[0], tuple(batch["image"].shape[1:])
    checks, cur = {}, batch
    for name, draw, apply, kw in augment.device_steps(cfg.data.augmentation):
        d = draw(gen, n, shp, **kw)
        got = apply(cur, d, **kw)
        want = apply({k: v.cpu() for k, v in cur.items()}, {k: v.cpu() for k, v in d.items()}, **kw)
        errs = {k: (got[k].cpu() - want[k]).abs().max().item() for k in want}
        exact = name in geometric or name in ("missing_section", "slice_shift", "missing_parts", "cut_noise", "stripe")
        if any(got[k].device != batch["image"].device for k in got):
            fail(f"on-device {name} moved a key off the card")
        if (exact and any(errs.values())) or max(errs.values()) > AUG_TOL:
            fail(f"on-device {name}: the card against the CPU on the same draws {errs} (exact: {exact})")
        checks[name] = dict(max_abs_err=max(errs.values()), exact=exact)
        cur = got
    fn = device_augment_fn(cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aug = fn(dict(batch), step_generator(cfg.system.seed, 1, dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    aug_ms = time_ms(lambda: fn(dict(batch), step_generator(cfg.system.seed, 1, dev)), 10)
    changed = [k for k in batch if not torch.equal(aug[k], batch[k])]
    model = build_model(cfg.model, device=dev, seed=0)
    model.train()
    orch = LossOrchestrator(cfg.model.loss)
    opt, schedule = build_optimizer(cfg.optimization, model, 100)
    state = create_train_state(model, opt)
    step_ms = {}
    for tag, aug_fn in (("without", None), ("with", fn)):
        step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val, augment_fn=aug_fn,
                               seed=cfg.system.seed)
        step_ms[tag] = time_ms(lambda: step(state, dict(batch)), 5)
    log(f"on-device augmentation (aug_strong's {len(checks)} device transforms, batch 8 of 96^3): {aug_ms:.2f} ms a "
        f"batch on the card, no device-to-host copy, keys changed {changed}; the fast recipe's train step "
        f"{step_ms['without']:.1f} ms without it, {step_ms['with']:.1f} ms with it (CUDA events); card vs CPU on the "
        "card's draws: " + ", ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in checks.items()))
    out["augment"] = dict(checks=checks, ms=aug_ms, keys_changed=changed, step_ms=step_ms)
    del model, opt, state, batch, aug
    torch.cuda.empty_cache()


def phase_training_rest(c3, dwk, dev, work, report):
    log("== phase 21: the rest of training: syn_cremi (kernels, train -> test, control), the fast recipe with host "
        "and on-device augmentation, fiber_linghu, MALIS, SGD/StepLR and ReduceLROnPlateau ==")
    import shutil

    from pytorch_connectomics_tpu_torch.data.io import read_volume
    from pytorch_connectomics_tpu_torch.losses import malis
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    out = report["training"] = {}
    t_phase = time.perf_counter()

    def lap(what):
        out.setdefault("seconds", {})[what] = time.perf_counter() - t_phase
        log(f"-- {what}: {out['seconds'][what]:.1f} s into phase 21")

    n_fwd, step_counts = syn_cremi_kernels(c3, dev, out)
    lap("syn_cremi kernels")
    logs = LogRecords(("timing[",))
    port_log = logging.getLogger("pytorch_connectomics_tpu_torch")
    port_log.addHandler(logs)

    def blobs(split, tag, shp, seed):
        s = "shape={},{},{}".format(*shp)
        return [f"data.{split}.{r}=synthetic://blobs/{tag}_{r}?{s}&seed={seed}" for r in ("image", "label")]

    def run(recipe, mode, root, extra):
        c3.reset_launch_counts()
        dwk.reset_launch_counts()
        t0 = time.perf_counter()
        res = dispatch_runtime(parse_args(["--config", str(recipe), "--device", str(dev), "--mode", mode,
                                           f"save_path={root}", *extra]))
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = dict(conv_counts(c3), **{k.__name__: k.launches for k in dwk.KERNELS})
        return res

    def train_leg(recipe, root, extra, steps, what):
        res = run(recipe, "train", root, ["monitor.logging.scalar.loss_every_n_steps=1", *extra])
        st = train_leg_stats(res)
        if st["train_stats"]["steps"] != steps or not res["checkpoint"] or not st["losses"] \
                or not all(math.isfinite(v) for v in st["losses"]):
            fail(f"{what} train leg: {st['train_stats']['steps']} steps, checkpoint {res['checkpoint']}, "
                 f"losses {st['losses']}")
        recs = [json.loads(line) for line in (Path(res["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
        st["lr"] = [r["train_lr"] for r in recs if "train_lr" in r]
        st["launches"], st["seconds"] = res["launches"], res["seconds"]
        log(f"{what}: {steps} steps in {st['train_stats']['seconds']:.2f} s ({st['steps_per_s']:.3f} steps/s, "
            f"{st['step_ms']:.1f} ms a step, {st['data_wait_ms_per_step']:.1f} of it waiting; pipeline "
            f"{st['pipeline_host_ms_per_batch']:.1f} ms a batch); losses {st['losses'][0]:.4f} -> {st['losses'][-1]:.4f}; "
            f"lr {st['lr'][0]:.3g} -> {st['lr'][-1]:.3g}; launches {res['launches']}")
        return res, st

    def test_leg(root, extra):
        res = run(SYN_CREMI, "test", root, extra)
        (timing,) = logs.take("timing[")
        res["timing"] = dict(zip(("read+normalise", "predict", "save", "decode", "evaluate"), timing[1:]))
        scores = next(iter(res["metrics"].values()))
        if "instance_f1" not in scores or not all(math.isfinite(v) for v in scores.values()):
            fail(f"syn_cremi test metrics: {scores}")
        if res["launches"]["forward"] <= 0 or res["launches"]["forward"] % n_fwd:
            fail(f"the syn_cremi test leg did not run its forwards through the conv kernel: {res['launches']}")
        log(f"syn_cremi test ({'restored ' + str(res['restored']['checkpoint']) if res.get('restored') else 'untrained'}"
            f"): {res['seconds']:.2f} s = " + ", ".join(f"{k} {v:.3f}" for k, v in res["timing"].items())
            + f"; {scores}; launches {res['launches']}")
        return res, scores

    try:
        # syn_cremi as shipped but for its depth: train 20 steps, test the held-out volume, again untrained
        root, control_root = work / "syn_cremi", work / "syn_cremi_control"
        for r in (root, control_root):
            shutil.rmtree(r, ignore_errors=True)
        train, st = train_leg(SYN_CREMI, root, [f"optimization.n_steps_per_epoch={SYN_STEPS}", "optimization.max_epochs=1",
                                                *blobs("train", "syn_train", SYN_TRAIN_SHAPE, 51)], SYN_STEPS, "syn_cremi train")
        want = {k: v * SYN_STEPS for k, v in step_counts.items()}
        if {k: train["launches"][k] for k in want} != want:
            fail(f"the syn_cremi train leg should launch {step_counts} convs a step for {SYN_STEPS} steps: "
                 f"{train['launches']}")
        head, tail = np.mean(st["losses"][:5]), np.mean(st["losses"][-5:])
        if not tail < head:
            fail(f"the syn_cremi train loss did not fall over {SYN_STEPS} steps (mean of the first five {head:.4f}, of "
                 f"the last five {tail:.4f}): {st['losses']}")
        lap("syn_cremi train")
        test_data = blobs("test", "syn_test", SYN_TEST_SHAPE, 52)
        test, scores = test_leg(root, test_data)
        if (test.get("restored") or {}).get("checkpoint") != train["checkpoint"]:
            fail(f"the syn_cremi test leg did not restore {train['checkpoint']}: {test.get('restored')}")
        pred_file = next(f for f in Path(test["run_dir"]).iterdir() if f.name.endswith(("_prediction.h5",
                                                                                             "_prediction.npy")))
        if "_tta_x4_" not in pred_file.name:
            fail(f"the syn_cremi test leg did not predict with the recipe's 4 flip variants: {pred_file.name}")
        pred = read_volume(str(pred_file))
        if pred.shape != (3, *SYN_TEST_SHAPE) or not np.isfinite(pred).all():
            fail(f"syn_cremi prediction {pred.shape} (finite: {np.isfinite(pred).all()})")
        decoded = next((f for f in Path(test["run_dir"]).iterdir() if "decoded_polarity2instance" in f.name), None)
        if decoded is None:
            fail("the syn_cremi test leg wrote no polarity2instance labels")
        lap("syn_cremi test")
        control, control_scores = test_leg(control_root, test_data)
        if control.get("restored"):
            fail(f"the syn_cremi control restored a checkpoint: {control['restored']}")
        lap("syn_cremi control")
        log(f"syn_cremi held-out instance F1 {scores['instance_f1']:.4f} (trained {SYN_STEPS} steps) against "
            f"{control_scores['instance_f1']:.4f} (untrained); not gated: the blobs' image carries no sign of an id's "
            "parity")
        out["syn_cremi"] = dict(train=st, test=dict(seconds=test["seconds"], timing=test["timing"], metrics=scores,
                                                    launches=test["launches"]),
                                control=dict(seconds=control["seconds"], metrics=control_scores))
        # the fast recipe in one call: host augmentation as shipped, then on the device
        check_device_augmentation(dev, out)
        lap("augmentation check")
        shape = "shape={},{},{}".format(*LUCCHI_SHAPE)
        fast_over = [f"data.train.image=synthetic://em2/lucchi_train_image?{shape}&seed=11",
                     f"data.train.label=synthetic://em2/lucchi_train_label?{shape}&seed=11",
                     f"optimization.n_steps_per_epoch={FAST_STEPS}", "optimization.max_epochs=1"]
        fast = {}
        for tag, extra in (("host", []), ("device", ["data.augmentation.on_device=true"])):
            r = work / f"fast_{tag}_aug"
            shutil.rmtree(r, ignore_errors=True)
            _, fst = train_leg(RECIPE, r, fast_over + extra, FAST_STEPS, f"fast recipe, augmentation on the {tag}")
            if fst["launches"]["depthwise3x3"] <= 0:
                fail(f"the fast recipe's {tag} leg ran no depthwise kernel: {fst['launches']}")
            fst["device_step_ms"] = fst["step_ms"] - fst["data_wait_ms_per_step"]
            fast[tag] = fst
            lap(f"fast recipe {tag}")
        log("fast recipe, augmentation on the host vs on the device: " + "; ".join(
            f"{k} {v['steps_per_s']:.3f} steps/s, waited {v['data_wait_ms_per_step']:.1f} ms a step, "
            f"{v['device_step_ms']:.1f} ms a step besides, pipeline {v['pipeline_host_ms_per_batch']:.1f} ms a batch"
            for k, v in fast.items()))
        out["fast_recipe"] = fast
        # fiber_linghu's train leg (SoftClDiceLoss); its test leg needs seg_2d
        r = work / "fiber"
        shutil.rmtree(r, ignore_errors=True)
        _, fst = train_leg(FIBER, r, [f"optimization.n_steps_per_epoch={FIBER_STEPS}", "optimization.max_epochs=1",
                                      *blobs("train", "fiber_train", FIBER_SHAPE, 53)], FIBER_STEPS, "fiber_linghu train")
        if fst["launches"]["wgrad"] <= 0:
            fail(f"the fiber_linghu train leg ran no conv kernels: {fst['launches']}")
        out["fiber"] = fst
        lap("fiber_linghu train")
        # one step of the instance recipe with MALIS on its raw segmentation
        r = work / "malis"
        shutil.rmtree(r, ignore_errors=True)
        malis.host_seconds = 0.0
        _, mst = train_leg(INSTANCE, r, ["optimization.n_steps_per_epoch=2", "optimization.max_epochs=1",
                                         "model.loss.losses=[{function: MalisLoss}]", "data.label_transform.targets=[]"],
                           2, "instance recipe with MalisLoss")
        mst["malis_host_seconds_per_step"] = malis.host_seconds / 2
        if mst["launches"]["depthwise3x3"] <= 0 or not malis.host_seconds > 0:
            fail(f"the MALIS leg ran no kernels or no pair counts: {mst['launches']}, {malis.host_seconds}")
        log(f"MALIS: the host's pair counts {mst['malis_host_seconds_per_step']:.3f} s a step (batch 8 of 32x64x64) "
            f"of {mst['step_ms'] / 1e3:.3f} s")
        out["malis"] = mst
        lap("malis")
        # a few steps under the step_lr and reduce_on_plateau profiles (plateau: a validation each step, patience 0)
        for profile, extra in (("step_lr", ["optimization.scheduler.step_size=1", "optimization.scheduler.interval=step"]),
                               ("reduce_on_plateau", ["optimization.scheduler.patience=0",
                                                      "optimization.val_check_interval=1",
                                                      "optimization.limit_val_batches=1",
                                                      *blobs("val", "syn_val", (16, 320, 320), 55)])):
            r = work / f"syn_{profile}"
            shutil.rmtree(r, ignore_errors=True)
            _, pst = train_leg(SYN_CREMI, r, [f"optimization.profile={profile}", f"optimization.n_steps_per_epoch={OPT_STEPS}",
                                              "optimization.max_epochs=1",
                                              *blobs("train", "syn_train", SYN_TRAIN_SHAPE, 51), *extra],
                               OPT_STEPS, f"syn_cremi under {profile}")
            if profile == "step_lr" and not (len(set(pst["lr"])) > 1 and pst["lr"][-1] < pst["lr"][0]):
                fail(f"StepLR with step_size 1 did not lower the learning rate: {pst['lr']}")
            out[profile] = pst
        lap("optimizer profiles")
    finally:
        port_log.removeHandler(logs)
    if not out["fast_recipe"]["device"]["launches"]["depthwise3x3"]:
        fail("the on-device augmentation leg ran no kernels")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU and check it.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases of 3-21 (14 also as 'instance', 17 as 'unet', 18 as 'nisb', 19 as "
                    "'multitask', 20 as 'mednext', 21 as 'training') to run after the device and build phases "
                    "(default: all)")
    args = ap.parse_args(argv)
    phases = None
    names = {"instance": 14, "unet": 17, "nisb": 18, "multitask": 19, "mednext": 20, "training": 21}
    if args.phases is not None:
        try:
            phases = {names.get(p) or int(p) for p in args.phases.split(",")}
        except ValueError:
            ap.error("--phases takes phases 3-21")
    if phases is not None and not phases <= set(range(3, 22)):
        ap.error("--phases takes phases 3-21")

    def want(n):
        return phases is None or n in phases

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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    phase_seconds = report["phase_seconds"] = {}
    last = [time.perf_counter()]

    def mark(n):
        now = time.perf_counter()
        phase_seconds[n] = now - last[0]
        last[0] = now
        log(f"phase {n} took {phase_seconds[n]:.1f} s")

    if want(3):
        rows = phase_kernels(fb, dev, report)
        mark(3)
    if want(4):
        phase_model(fb, dev, report)
        mark(4)

    if want(5):
        log("== phase 5: CLI --mode test slice ==")
        main_run = run_slice(fb, dev, (165, 1024, 768), False, work, seed=0)
        tta_run = run_slice(fb, dev, (96, 256, 192), True, work, seed=1)
        report["slice"] = [main_run, tta_run]
        phase_predict_profile(dev, work, (165, 1024, 768), report)
        mark(5)

    if want(6):
        dw_rows = phase_depthwise(dwk, dev, report)
        mark(6)
    if want(7):
        phase_train_step(dwk, fb, dev, report)
        mark(7)
    if want(8):
        train_counts = phase_cli_train_test(dwk, fb, dev, work, report)
        mark(8)

    if want(9):
        conv_rows = phase_conv3d(c3, dev, report)
        mark(9)
    if want(10):
        phase_rsunet(c3, dev, report)
        mark(10)
    if want(11):
        nucmm_launches = phase_nucmm(c3, dev, work, report)
        phase_predict_profile(dev, work, NUCMM_SHAPE, report, recipe=NUCMM,
                              name="nuc{}x{}x{}".format(*NUCMM_SHAPE), key="nucmm_predict")
        mark(11)

    if want(12):
        probe_records, probe_counts = phase_probes(dev, work, report)
        mark(12)
    if want(13):
        phase_fast_recipe(dwk, fb, dev, work, report)
        mark(13)
    if want(14):
        phase_instance(dwk, fb, dev, work, report)
        mark(14)
    if want(15):
        wgrad_rows = phase_rsunet_train(c3, dev, report)
        mark(15)
    if want(16):
        snemi_counts = phase_rsunet_recipes(c3, dev, work, report)
        mark(16)
    if want(17):
        phase_unet(c3, dev, work, report)
        mark(17)
    if want(18):
        phase_nisb(dwk, fb, dev, work, report)
        mark(18)
    if want(19):
        phase_multitask(dwk, fb, dev, work, report)
        mark(19)
    if want(20):
        phase_mednext(dwk, fb, dev, work, report)
        mark(20)
    if want(21):
        phase_training_rest(c3, dwk, dev, work, report)
        mark(21)

    log("== phase 22: report ==")
    report["total_seconds"] = time.perf_counter() - started
    log(f"chip_smoke ran in {report['total_seconds']:.1f} s")
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    if phases is not None:
        (work / f"chip_smoke_phases_{'_'.join(map(str, sorted(phases)))}.json").write_text(
            json.dumps(report, indent=2, default=lambda o: o.item()))
        print(json.dumps({"ok": True, "device": device, "phases": sorted(phases)}))
        return
    kernels = kernel_line_rows(rows, main_run["launches"], dw_rows, train_counts)
    kernels += k5_line_rows(report["mednext"]["k5_rows"], report["mednext"]["upkern_test"]["launches"])
    kernels.append(conv3d_line_row(conv_rows, nucmm_launches))
    kernels.append(wgrad_line_row(wgrad_rows, snemi_counts["conv3d_3x3_wgrad"]))
    kernels += probe_line_rows(probe_records, probe_counts)
    report["kernels"] = kernels
    (work / "chip_smoke.json").write_text(json.dumps(report, indent=2, default=lambda o: o.item()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
