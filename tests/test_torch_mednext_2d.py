"""MedNeXt's 2-D mode, the refine head and the full-resolution hybrid in the
port against flax on the CPU (weights through ``models/convert.py``): 2-D
mode at Z 1 and Z 4 (stock stem, and the (1, 2, 2) patchify stem with the
refine head and deep supervision), the hybrid, task heads with the refine
head; the 2-D training route (the depthwise kernel on taps embedded in 3^3,
its weight gradient the centre plane's) against autograd of the plain conv;
``inference.direct_2d`` against JAX's ``predict_direct_2d``; and the ring
planners at ``tutorials/mito_mitolab.yaml``'s stride-1 stages.

Tolerances: f32 rtol 1e-4 and atol 1e-4 * max|ref|; bf16 atol 5e-2 *
max|ref| (rounding at other places in the two frameworks); gradients rtol
1e-5 of the gradient's norm."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.config.schema import MedNeXtHeadConfig
from pytorch_connectomics_tpu.inference.manager import InferenceManager as JaxInferenceManager
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.config.schema import MedNeXtHeadConfig as PortHeadConfig
from pytorch_connectomics_tpu_torch.inference import InferenceManager
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import load_flax_params
from pytorch_connectomics_tpu_torch.models.layers import conv3d_same
from pytorch_connectomics_tpu_torch.ops import depthwise as dw
from pytorch_connectomics_tpu_torch.ops import fused_block as fb
from test_torch_multitask import _jax_params

MITOLAB = "tutorials/mito_mitolab.yaml"
MITOLAB_PATH = Path(__file__).resolve().parents[1] / MITOLAB
SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(recipe, over, shape, seed=0, heads=None):
    """(port output, flax output, port model) for the recipe's tiny model;
    ``optimization.precision`` follows the compute dtype asked for."""
    prec = "32" if "model.compute_dtype=float32" in over else "bf16-mixed"
    over = [*over, f"optimization.precision={prec}"]
    jcfg = jax_load_config(recipe, overrides=TINY + over, mode="train")
    cfg = load_config(recipe, overrides=TINY + over, mode="train")
    if heads:
        jcfg.model.mednext.heads = [MedNeXtHeadConfig(**h) for h in heads]
        cfg.model.mednext.heads = [PortHeadConfig(**h) for h in heads]
    jm = jax_build(jcfg.model)
    params = _jax_params(jm, shape, seed)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": params}, x)  # jit: a tenth of the eager time on the CPU
    model = build_model(cfg.model, device="cpu", seed=1)
    load_flax_params(model, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    return got, ref, model


def _close(got, ref, dtype):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k], ref[k], dtype)
        return
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    top = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * top)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * top)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z", [1, 4])
def test_two_d_mednext_matches_flax(z, dtype):
    """mito_mitolab's 2-D MedNeXt (stock stem), tiny: (1, k, k) taps, z untouched."""
    over = [f"model.compute_dtype={dtype}", f"model.input_size=[{z},32,32]"]
    got, ref, model = _run(MITOLAB, over, (2, z, 32, 32, 1), seed=z)
    assert model.two_d and model.enc[0].blocks[0].conv_weight.shape == (8, 1, 1, 3, 3)
    assert model.down[0].stride == (1, 2, 2)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_d_k5_refine_head_and_deep_supervision_match_flax(dtype):
    """2-D at kernel 5 with the patchify stem (its (1, 2, 2) stride in 2-D
    mode whatever patchify_stride says), the refine head and deep supervision."""
    over = [f"model.compute_dtype={dtype}", "model.input_size=[2,64,64]", "model.mednext.kernel_size=5",
            "model.mednext.patchify_stem=true", "model.mednext.patchify_stride=[2,2,2]",
            "model.mednext.patchify_head=refine", "model.mednext.patchify_head_width=8",
            "model.loss.deep_supervision=true"]
    got, ref, model = _run(MITOLAB, over, (1, 2, 64, 64, 1), seed=7)
    assert model.stride == (1, 2, 2) and sorted(got) == ["ds_0", "ds_1", "ds_2", "out"]
    assert got["ds_0"].shape == (1, 2, 16, 16, 3)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_resolution_hybrid_matches_flax(dtype):
    """The hybrid (w0 16): 1x1x1 stem to w0, a full-resolution block, the
    half-resolution core, the transposed block back to w0 and a 1x1x1 head.
    bf16 is held against flax's f32 output: flax's own bf16 forward of this
    model on the CPU lies 0.13 * max|ref| from its f32 one (the port's bf16
    0.013), so flax bf16 is no reference here."""
    over = ["model.input_size=[32,32,32]", "model.mednext.patchify_stem=true", "model.mednext.patchify_full_res_width=16"]
    got, ref, model = _run(SYNTH, over + ["model.compute_dtype=float32"], (1, 32, 32, 32, 1), seed=8)
    assert model.hybrid and model.full_res_enc.fused and model.full_res_enc.pw1.in_features == 16
    if dtype == "bfloat16":
        got = _run(SYNTH, over + ["model.compute_dtype=bfloat16"], (1, 32, 32, 32, 1), seed=8)[0]
    _close(got, ref, dtype)


def test_task_heads_with_the_refine_head_and_deep_supervision_match_flax():
    heads = [dict(name="aff", out_channels=3, num_blocks=1, target_slice="0:3"),
             dict(name="sdt", out_channels=1, num_blocks=0, target_slice="3:4")]
    over = ["model.compute_dtype=float32", "model.input_size=[16,64,64]", "model.mednext.patchify_stem=true",
            "model.mednext.patchify_head=refine", "model.loss.deep_supervision=true"]
    got, ref, model = _run(SYNTH, over, (1, 16, 64, 64, 1), seed=9, heads=heads)
    assert sorted(got) == ["aff", "ds_0", "ds_1", "ds_2", "sdt"] and hasattr(model.heads["aff"], "mix")
    _close(got, ref, "float32")


@pytest.mark.parametrize("z", [1, 4])
def test_two_d_training_route_matches_plain_autograd(z):
    """At kernel 3 a 2-D block trains through the depthwise kernel on the
    (1, 3, 3) taps embedded in 3^3: its output and the gradients of x, the
    (1, 3, 3) taps and the bias equal autograd of the plain (1, 3, 3) conv."""
    rng = np.random.default_rng(z)
    x = torch.from_numpy(rng.standard_normal((2, z, 9, 11, 16)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy((rng.standard_normal((16, 1, 1, 3, 3)) * 0.3).astype(np.float32)).requires_grad_()
    b = torch.from_numpy((rng.standard_normal(16) * 0.1).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((2, z, 9, 11, 16)).astype(np.float32))
    got = dw.depthwise_conv3x3(x, fb.taps3d(w), b)
    gx, gw, gb = torch.autograd.grad(got, (x, w, b), dy)
    want = conv3d_same(x, w, b, (1, 1, 1), groups=16)
    wx, ww, wb = torch.autograd.grad(want, (x, w, b), dy)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for g, r in ((gx, wx), (gw, ww), (gb, wb)):
        assert g.shape == r.shape and (g - r).norm() <= 1e-5 * r.norm()


def test_direct_2d_matches_jax(tmp_path):
    """``inference.direct_2d``: each z-section forwarded whole in batches of
    8 (11 sections: a padded last batch), then the sigmoid; the 2-D model's
    prediction against JAX's ``predict_direct_2d`` on the same weights."""
    over = ["optimization.precision=32", "model.input_size=[1,32,32]", "inference.direct_2d=true"]
    jcfg = jax_load_config(MITOLAB, overrides=TINY + over, mode="test")
    cfg = load_config(MITOLAB, overrides=TINY + over, mode="test")
    jm = jax_build(jcfg.model)
    params = _jax_params(jm, (1, 1, 32, 32, 1), 3)
    vol = np.random.default_rng(4).random((11, 32, 32)).astype(np.float32)
    want = JaxInferenceManager(jcfg, jm).predict(params, vol)
    model = build_model(cfg.model, device="cpu", seed=0)
    load_flax_params(model, params)
    got = InferenceManager(cfg, model, "cpu").predict(vol)
    assert got.shape == want.shape == (11, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# (C, R, (Z, Y, X)) of MedNeXt-S's stride-1 stages on mito_mitolab's (1, 256,
# 256) window (stock stem), at its training batch 32 and inference batch 16
MITOLAB_STAGES = [(32, 64, (1, 256, 256)), (64, 128, (1, 128, 128)), (128, 256, (1, 64, 64)),
                  (256, 512, (1, 32, 32)), (512, 1024, (1, 16, 16))]


@pytest.mark.parametrize("batch", [16, 32])
def test_planners_take_mitolab_stages(batch):
    """Z 1: the fused pair (bf16 and f32 statistics, the bf16 apply) and the
    depthwise pair have plans at every stage, a segment of one slab."""
    for c, r, spatial in MITOLAB_STAGES:
        shape = (batch, *spatial, c)
        for dtype in (torch.float32, torch.bfloat16):
            p = fb.kernel_plan(shape, dtype, r)
            assert p["dw_stats"]["seg"] == 1 and p["dw_stats"]["groups"] == 1
            for kind in (0, 1):
                assert dw.plans(kind, shape, dtype)[0]["smem_bytes"] <= fb.MAX_SMEM
        assert fb.apply_plan(shape, r, c)["smem_bytes"] <= fb.MAX_SMEM


def test_tutorial_audit_clears_mito_mitolab():
    """``tools/tutorial_audit.py``: mito_mitolab's train and test legs clear
    every raise site that reads only the config (2-D MedNeXt raised there)."""
    from pytorch_connectomics_tpu_torch.tools.tutorial_audit import audit

    (rec,) = audit([MITOLAB_PATH])
    assert rec == {"tutorial": "mito_mitolab", "train": "ok", "test": "ok"}


def test_an_all_zero_sample_overflows_the_gradient_in_both_packages():
    """ROADMAP C.11: at init (zero biases) an all-zero 2-D sample, as
    ``aug_standard``'s ``missing_section`` makes of a (1, 256, 256) patch,
    keeps every activation exactly zero, and each GroupNorm scales its
    gradient by 1/sqrt(eps): the gradient overflows in JAX and in the port
    alike, on the same weights (the port's init through the bridge). A
    textured sample stays finite in both."""
    from pytorch_connectomics_tpu.losses.orchestrator import LossOrchestrator as JaxOrchestrator
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models.convert import state_dict_to_flax

    over = TINY + ["optimization.precision=32", "model.input_size=[1,64,64]"]
    cfg = load_config(MITOLAB, overrides=over, mode="train")
    jcfg = jax_load_config(MITOLAB, overrides=over, mode="train")
    jm = jax_build(jcfg.model)
    model = build_model(cfg.model, device="cpu", seed=0).train()
    tree = {}
    for path, a in state_dict_to_flax(model).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    orch, jorch = LossOrchestrator(cfg.model.loss), JaxOrchestrator(jcfg.model.loss)
    y = (np.random.default_rng(0).random((1, 1, 64, 64, 3)) > 0.5).astype(np.float32)
    grad = jax.jit(jax.grad(lambda p, x: jorch(jm.apply({"params": p}, x), y)[0]))
    for x, finite in ((np.zeros((1, 1, 64, 64, 1), np.float32), False),
                      (np.random.default_rng(1).random((1, 1, 64, 64, 1)).astype(np.float32), True)):
        jax_finite = all(bool(np.isfinite(np.asarray(g)).all()) for g in jax.tree.leaves(grad(tree, x)))
        model.zero_grad(set_to_none=True)
        orch(model(torch.from_numpy(x)), torch.from_numpy(y))[0].backward()
        port_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        assert jax_finite == port_finite == finite
