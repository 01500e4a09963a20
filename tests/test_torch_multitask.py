"""Multi-task MedNeXt in the port against the JAX package on the CPU: the
``sdt``, ``skeleton_aware_edt`` and ``semantic_edt`` targets, target
context, ``SmoothL1Loss``, the orchestrator on head outputs with term
weights and uncertainty, the three balancing methods over three train
steps against JAX's ``make_train_step``, MedNeXt with task heads (stock
and patchify stems, f32 and bf16), the inference manager's ``output_head``,
sorted-name merge and ``head_spans``, the balancer in checkpoints, and the
ring planners at the multi-task recipes' training shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.config.schema import MedNeXtHeadConfig
from pytorch_connectomics_tpu.data.pipeline import build_pipelines as jax_build_pipelines
from pytorch_connectomics_tpu.data.targets import build as jbuild
from pytorch_connectomics_tpu.data.targets import distance as jdist
from pytorch_connectomics_tpu.inference.manager import InferenceManager as JaxInferenceManager
from pytorch_connectomics_tpu.losses import zoo as jzoo
from pytorch_connectomics_tpu.losses.orchestrator import LossOrchestrator as JaxOrchestrator
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.models.build import init_model as jax_init
from pytorch_connectomics_tpu.training.optim import build_optimizer as jax_build_optimizer
from pytorch_connectomics_tpu.training.state import create_train_state as jax_create_train_state
from pytorch_connectomics_tpu.training.state import make_train_step as jax_make_train_step
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.data import synthetic
from pytorch_connectomics_tpu_torch.data.pipeline import build_pipelines
from pytorch_connectomics_tpu_torch.data.targets import build as pbuild
from pytorch_connectomics_tpu_torch.data.targets import distance as pdist
from pytorch_connectomics_tpu_torch.inference import InferenceManager
from pytorch_connectomics_tpu_torch.losses import LossOrchestrator, get_loss
from pytorch_connectomics_tpu_torch.losses import balancing
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import load_flax_params
from pytorch_connectomics_tpu_torch.ops import depthwise as dw
from pytorch_connectomics_tpu_torch.ops import fused_block as fb
from pytorch_connectomics_tpu_torch.training.checkpoint import CheckpointManager
from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_log_vars, make_train_step
from test_torch_depthwise_ring import _check_plan
from test_torch_fused_block import check_tiling, mednext_stages

BETASEG = "tutorials/mito_betaseg.yaml"
MULTITASK = "tutorials/neuron_snemi_sdt_multitask.yaml"
SNEMI_SDT = "tutorials/neuron_snemi_sdt.yaml"
BANIS_V1 = "tutorials/mito_betaseg_banis_v1.yaml"
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "optimization.precision=32",
    "model.input_size=[16,16,16]",
    "inference.window.window_size=[16,16,16]",
    "data.dataloader.patch_size=[16,16,16]",
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch operations: one intra-op thread, as the other CPU tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seg(seed=4, shape=(12, 28, 24), cells=10):
    return synthetic.synthetic_em_task("instance", shape, seed=seed, cells=cells)[1]


# ---------------------------------------------------------------------------
# targets: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,kw", [
    ("signed_distance", {}),
    ("signed_distance", {"truncate": 3.0}),
    ("signed_distance", {"per_instance": False}),
    ("skeleton_aware_edt", {}),
    ("skeleton_aware_edt", {"alpha": 1.0, "bg_value": 0.0}),
    ("semantic_edt", {}),
    ("semantic_edt", {"mode": "2d"}),
    ("semantic_edt", {"normalize": False, "sampling": (2.0, 1.0, 1.0)}),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()) or "default")
def test_distance_targets_match_jax(fn, kw):
    """Bit for bit: the same numpy and scipy calls in the same order."""
    seg = _seg()
    got, want = getattr(pdist, fn)(seg, **kw), getattr(jdist, fn)(seg, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ids", ["large", "negative", "float"])
def test_skeleton_aware_edt_boxes_of_any_ids(ids):
    """Ids past 2^22 and float labels take their boxes by rank, negative
    unlabeled voxels count as background; same bits as JAX."""
    seg = _seg(seed=5).astype(np.int64)
    if ids == "large":
        seg = seg * 1_000_003
    elif ids == "negative":
        seg[:, :3] = -1
    else:
        seg = seg.astype(np.float32)
    np.testing.assert_array_equal(pdist.skeleton_aware_edt(seg), jdist.skeleton_aware_edt(seg))


@pytest.mark.parametrize("recipe,over", [
    (BETASEG, []), (MULTITASK, []), (SNEMI_SDT, []),
    (BETASEG, ["data.label_transform.targets=[{name: semantic_edt}, {name: sdt, kwargs: {truncate: 4.0}}]"]),
], ids=["betaseg", "snemi_multitask", "snemi_sdt", "semantic_sdt"])
def test_recipe_targets_match_jax(recipe, over):
    """The recipes' stacked targets (affinities, then the distance target;
    SNEMI's ``aff9_sdt`` profile: erosion, 9 deepem affinities and the
    skeleton-aware EDT) and their channel spans, bit for bit."""
    cfg = load_config(recipe, overrides=over, mode="train")
    jcfg = jax_load_config(recipe, overrides=over, mode="train")
    seg = _seg(seed=6, shape=(14, 30, 26))
    got = pbuild.build_target_fn(cfg.data.label_transform)(seg)
    want = jbuild.build_target_fn(jcfg.data.label_transform)(seg)
    np.testing.assert_array_equal(got, want)
    spans = [(s["name"], s["start"], s["end"]) for s in pbuild.target_channel_spans(cfg.data.label_transform)]
    assert spans == [(s["name"], s["start"], s["end"]) for s in jbuild.target_channel_spans(jcfg.data.label_transform)]
    assert spans[-1][2] == got.shape[0]


# ---------------------------------------------------------------------------
# target context
# ---------------------------------------------------------------------------


def test_target_context_samples_match_jax(tmp_path):
    """``mito_betaseg_banis_v1.yaml``'s pipeline (context 10 on each axis,
    ``aug_banis``, r1/r3 affinities and the SDT, reject sampling) on one
    volume: the dataset crops patch + 20 and each sample is cropped back
    to the patch after the targets; two batches bit for bit against JAX's
    on the same draws. The recipe's ``divide-255`` normalisation raises in
    both packages; ``scale`` divides by 255 the same way."""
    img, lbl = synthetic.synthetic_em_task("instance", (40, 56, 56), seed=8, cells=12)
    np.save(tmp_path / "im.npy", img)
    np.save(tmp_path / "lb.npy", lbl)
    over = TINY + [f"data.train.image={tmp_path / 'im.npy'}", f"data.train.label={tmp_path / 'lb.npy'}",
                   "data.preprocessing.normalize=scale", "data.dataloader.batch_size=2", "system.num_workers=2"]
    cfg = load_config(BANIS_V1, overrides=over, mode="train")
    jcfg = jax_load_config(BANIS_V1, overrides=over, mode="train")
    assert cfg.data.dataloader.target_context == [10, 10, 10]
    pipe, _ = build_pipelines(cfg, device="cpu")
    jpipe, _ = jax_build_pipelines(jcfg, 0, 1)
    assert pipe.dataset.patch_size == tuple(jpipe.dataset.patch_size) == (36, 36, 36)
    try:
        for step in (0, 1):
            got, want = pipe.make_batch(step), jpipe.make_batch(step)
            assert set(got) == set(want) and got["image"].shape == (2, 16, 16, 16, 1)
            assert got["label"].shape == (2, 16, 16, 16, 7)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        pipe.close()


# ---------------------------------------------------------------------------
# losses, orchestrator, balancing
# ---------------------------------------------------------------------------


def _pred_target(seed=0, shape=(2, 4, 6, 5, 3)):
    rng = np.random.default_rng(seed)
    pred = (rng.standard_normal(shape) * 2).astype(np.float32)
    target = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = (rng.random(shape[:-1] + (1,)) > 0.3).astype(np.float32)
    weight = rng.random(shape[:-1] + (1,)).astype(np.float32)
    return pred, target, mask, weight


@pytest.mark.parametrize("kw", [{}, {"tanh": True}, {"beta": 0.25}, {"beta": 2.0, "tanh": True}],
                         ids=["plain", "tanh", "beta0.25", "beta2-tanh"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask+weight"])
def test_smooth_l1_matches_jax(kw, masked):
    """rtol 1e-6: the same float32 elementwise terms, summed in another order."""
    pred, target, mask, weight = _pred_target(1)
    extra = dict(mask=mask, weight=weight) if masked else {}
    want = float(jzoo.get_loss("SmoothL1Loss")(jnp.asarray(pred), jnp.asarray(target), **extra, **kw))
    got = get_loss("SmoothL1Loss")(torch.from_numpy(pred), torch.from_numpy(target),
                                   **{k: torch.from_numpy(v) for k, v in extra.items()}, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def _betaseg_outputs(seed=3, shape=(2, 8, 10, 12)):
    rng = np.random.default_rng(seed)
    heads = {"aff_r1": 3, "aff_r5": 3, "sedt": 1}
    out = {k: (rng.standard_normal(shape + (c,)) * 2).astype(np.float32) for k, c in heads.items()}
    label = np.concatenate([(rng.random(shape + (6,)) > 0.6).astype(np.float32),
                            rng.uniform(-1, 1, shape + (1,)).astype(np.float32)], axis=-1)
    return out, label


@pytest.mark.parametrize("mode", ["plain", "term_weights", "uncertainty"])
def test_orchestrator_on_heads_matches_jax(mode):
    """Betaseg's five terms on its three heads (each term's target channels
    from the stacked label, the affinity offsets' validity masks), plain,
    with GradNorm's term weights and with Kendall's log-variances: every
    ``loss_*`` and the total within 1e-6 relative (1e-5 for the weighted
    totals: the products round in another order)."""
    cfg, jcfg = load_config(BETASEG, mode="train"), jax_load_config(BETASEG, mode="train")
    out, label = _betaseg_outputs()
    kw, jkw = {}, {}
    if mode == "term_weights":
        w = np.array([0.7, 1.3, 0.9, 1.1, 1.0], np.float32)
        kw, jkw = dict(term_weights=torch.from_numpy(w)), dict(term_weights=jnp.asarray(w))
    elif mode == "uncertainty":
        s = np.array([0.2, -0.1, 0.3, 0.05, -0.4], np.float32)
        kw, jkw = dict(balancer_params=torch.from_numpy(s)), dict(balancer_params=jnp.asarray(s))
    orch = LossOrchestrator(cfg.model.loss, affinity_groups=pbuild.affinity_target_groups(cfg.data.label_transform))
    jorch = JaxOrchestrator(jcfg.model.loss, affinity_groups=jbuild.affinity_target_groups(jcfg.data.label_transform))
    total, logs = orch({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(label), **kw)
    jtotal, jlogs = jorch({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(label), **jkw)
    assert set(logs) == set(jlogs) and len(logs) == 6 and orch.num_terms == 5
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-6 if mode == "plain" else 1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6 if mode == "plain" else 1e-5)


def test_orchestrator_names_a_missing_head():
    cfg = load_config(BETASEG, mode="train")
    out, label = _betaseg_outputs()
    out.pop("sedt")
    with pytest.raises(KeyError, match="sedt"):
        LossOrchestrator(cfg.model.loss)({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(label))


@pytest.mark.parametrize("exact", [False, True], ids=["gradnorm", "gradnorm_exact"])
def test_gradnorm_updates_match_jax(exact):
    """The weight updates alone over three rounds, from the same losses
    and gradient norms: within 1e-6 relative."""
    from pytorch_connectomics_tpu.losses import balancing as jbal

    rng = np.random.default_rng(9)
    w, jw = torch.ones(3), jnp.ones(3)
    init = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    for _ in range(3):
        losses = rng.uniform(0.1, 2.0, 3).astype(np.float32)
        if exact:
            g = rng.uniform(0.01, 5.0, 3).astype(np.float32)
            w = balancing.gradnorm_exact_weights(torch.from_numpy(g), list(torch.from_numpy(losses)),
                                                 torch.from_numpy(init), w, alpha=1.5, lr=0.1)
            jw = jbal.gradnorm_exact_weights(jnp.asarray(g), list(jnp.asarray(losses)), jnp.asarray(init), jw,
                                             alpha=1.5, lr=0.1)
        else:
            w = balancing.gradnorm_weights(list(torch.from_numpy(losses)), torch.from_numpy(init), w, alpha=1.5,
                                           lr=0.1)
            jw = jbal.gradnorm_weights(list(jnp.asarray(losses)), jnp.asarray(init), jw, alpha=1.5, lr=0.1)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
        assert not w.requires_grad
    s = torch.tensor([0.3, -0.2])
    ls = [torch.tensor(1.5), torch.tensor(0.25)]
    np.testing.assert_allclose(float(balancing.uncertainty_weighted_total(ls, s)),
                               float(jbal.uncertainty_weighted_total([1.5, 0.25], jnp.asarray([0.3, -0.2]))),
                               rtol=1e-6)


def _jax_params(model, shape, seed):
    """Seeded weights of the init's shapes (no init compile), scaled as an
    init would: kernels by 1/sqrt(fan-in), norm scales near 1, small biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct(shape, np.float32))

    def weight(path, a):
        z = rng.standard_normal(a.shape)
        name = str(path[-1])
        if "scale" in name:
            z = 1.0 + 0.1 * z
        elif "kernel" in name:
            z = z / np.sqrt(np.prod(a.shape[:-1]))
        else:
            z = 0.05 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(weight, shapes["params"])


def _multitask_batch(cfg, jcfg, n=2):
    """A seeded batch of 16^3 patches with the recipe's targets (3
    affinities and the SDT), the same for both packages."""
    img, seg = synthetic.synthetic_em_task("instance", (18, 24, 24), seed=12, cells=8)
    crops = [(slice(0, 16), slice(0, 16), slice(0, 16)), (slice(2, 18), slice(8, 24), slice(8, 24))][:n]
    x = np.stack([img[c] / np.float32(255.0) for c in crops])[..., None].astype(np.float32)
    t, jt = pbuild.build_target_fn(cfg.data.label_transform), jbuild.build_target_fn(jcfg.data.label_transform)
    y = np.stack([np.moveaxis(t(seg[c]), 0, -1) for c in crops]).astype(np.float32)
    np.testing.assert_array_equal(y, np.stack([np.moveaxis(jt(seg[c]), 0, -1) for c in crops]))
    return x, y


STEPS = 3
BAL_OVER = TINY + ["optimization.n_steps_per_epoch=10", "optimization.max_epochs=2",
                   "optimization.scheduler.warmup_steps=1", "model.loss.balancing.lr=0.2"]


@pytest.fixture(scope="module", params=["gradnorm", "gradnorm_exact", "uncertainty"])
def jax_balanced_steps(request):
    """Three steps of JAX's jitted ``make_train_step`` of the tiny
    multi-task MedNeXt (heads of one block) under ``request.param``:
    each step's float logs, then the final log-variances."""
    over = BAL_OVER + [f"model.loss.balancing.method={request.param}"]
    jcfg = jax_load_config(MULTITASK, overrides=over, mode="train")
    cfg = load_config(MULTITASK, overrides=over, mode="train")
    model = jax_build(jcfg.model)
    x, y = _multitask_batch(cfg, jcfg)
    params = _jax_params(model, (1, *x.shape[1:]), seed=2)
    orch = JaxOrchestrator(jcfg.model.loss, affinity_groups=jbuild.affinity_target_groups(jcfg.data.label_transform))
    tx, _ = jax_build_optimizer(jcfg.optimization, jcfg.optimization.n_steps_per_epoch)
    n = orch.num_terms
    bal = jcfg.model.loss.balancing
    state = jax_create_train_state(params, tx, num_balancer_terms=n if bal.method == "uncertainty" else 0,
                                   gradnorm_terms=n if bal.method != "uncertainty" else 0)
    step = jax.jit(jax_make_train_step(model.apply, orch, tx, balancing=bal.method, balancing_alpha=bal.alpha,
                                       balancing_lr=bal.lr))
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    logs = []
    for _ in range(STEPS):
        state, lg = step(state, batch)
        logs.append({k: float(v) for k, v in lg.items()})
    log_vars = np.asarray(state.params["balancer"]) if bal.method == "uncertainty" else None
    return dict(method=request.param, over=over, x=x, y=y, params=params, logs=logs, log_vars=log_vars)


def test_balanced_train_steps_match_jax(jax_balanced_steps):
    """Three port train steps of the same model, weights and batch: every
    loss term and the total within 1e-5 relative at step 1 and 1e-4 after
    (the parameters moved by two AdamW updates), GradNorm's weights
    (``gradnorm_w_*``) within 1e-4, its measured gradient norms
    (``gradnorm_g_*``) within 1e-4, the gradient norm within 1e-4; with
    ``uncertainty`` the trained log-variances within 1e-6 absolute."""
    ref = jax_balanced_steps
    cfg = load_config(MULTITASK, overrides=ref["over"], mode="train")
    model = build_model(cfg.model, device="cpu", seed=3)
    load_flax_params(model, ref["params"])
    bal = cfg.model.loss.balancing
    orch = LossOrchestrator(cfg.model.loss, affinity_groups=pbuild.affinity_target_groups(cfg.data.label_transform))
    log_vars = make_log_vars(bal.method, orch.num_terms, "cpu")
    opt, schedule = build_optimizer(cfg.optimization, model, cfg.optimization.n_steps_per_epoch,
                                    extra_params=[("balancer", log_vars)] if log_vars is not None else ())
    state = create_train_state(model, opt, log_vars=log_vars,
                               gradnorm_terms=orch.num_terms if bal.method != "uncertainty" else 0)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val, balancing=bal.method,
                           balancing_alpha=bal.alpha, balancing_lr=bal.lr)
    batch = {"image": torch.from_numpy(ref["x"]), "label": torch.from_numpy(ref["y"])}
    for i, want in enumerate(ref["logs"]):
        got = step(state, batch)
        assert set(got) == set(want), (set(got) ^ set(want))
        for k, v in want.items():
            tol = 1e-5 if (i == 0 and k.startswith("loss_")) else 1e-4
            np.testing.assert_allclose(float(got[k]), v, rtol=tol, err_msg=f"step {i + 1} {k}")
    if ref["method"] == "uncertainty":
        np.testing.assert_allclose(state.log_vars.detach().numpy(), ref["log_vars"], rtol=0, atol=1e-6)
        assert state.balancer is None and np.abs(ref["log_vars"]).max() > 0
    else:
        w = [v for k, v in ref["logs"][-1].items() if k.startswith("gradnorm_w_")]
        assert len(w) == 2 and abs(sum(w) - 2) < 1e-5 and abs(w[0] - w[1]) > 1e-3  # the weights moved


def test_checkpoint_keeps_the_balancer(tmp_path):
    """GradNorm's state and the uncertainty log-variances are saved and
    restored with the step."""
    cfg = load_config(MULTITASK, overrides=TINY, mode="train")
    model = build_model(cfg.model, device="cpu", seed=0)
    log_vars = make_log_vars("uncertainty", 2, "cpu")
    opt, _ = build_optimizer(cfg.optimization, model, 10, extra_params=[("balancer", log_vars)])
    state = create_train_state(model, opt, gradnorm_terms=2, log_vars=log_vars)
    state.balancer = torch.tensor([[0.8, 1.2], [0.5, 0.25]])
    with torch.no_grad():
        state.log_vars.copy_(torch.tensor([0.125, -0.5]))
    state.step = 7
    ck = CheckpointManager(tmp_path / "ck")
    ck.save(state, 0, {})
    lv = make_log_vars("uncertainty", 2, "cpu")
    fresh = create_train_state(build_model(cfg.model, device="cpu", seed=1),
                               build_optimizer(cfg.optimization, model, 10, extra_params=[("balancer", lv)])[0],
                               gradnorm_terms=2, log_vars=lv)
    CheckpointManager.restore(ck.last_path(), fresh)
    assert fresh.step == 7
    torch.testing.assert_close(fresh.balancer, state.balancer, rtol=0, atol=0)
    torch.testing.assert_close(fresh.log_vars.detach(), torch.tensor([0.125, -0.5]), rtol=0, atol=0)


def test_unknown_balancing_raises():
    cfg = load_config(MULTITASK, overrides=TINY, mode="train")
    with pytest.raises(ValueError, match="balancing"):
        make_train_step(LossOrchestrator(cfg.model.loss), lambda c: 1e-3, balancing="nash")


# ---------------------------------------------------------------------------
# MedNeXt with task heads
# ---------------------------------------------------------------------------


def _heads_cfg(dtype, stride):
    cfg = jax_load_config(BETASEG, overrides=TINY + [f"optimization.precision={'32' if dtype == 'float32' else 'bf16-mixed'}"],
                          mode="test").model
    cfg.compute_dtype = dtype
    cfg.mednext.heads = [MedNeXtHeadConfig(name="aff", out_channels=3, num_blocks=1, target_slice="0:3"),
                         MedNeXtHeadConfig(name="sdt", out_channels=1, num_blocks=0, target_slice="3:4")]
    if stride:
        cfg.mednext.patchify_stem = True
        cfg.mednext.patchify_stride = list(stride)
    return cfg


@pytest.mark.parametrize("stride", [None, (1, 2, 2)], ids=["stock", "patchify122"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_mednext_heads_match_flax(stride, dtype):
    """Heads of one and of no MedNeXt block through ``models/convert.py``:
    every head's float32 output within 1e-4 (relative and of the head's
    largest value) in f32, 5e-2 of the largest value in bf16; the CPU run
    is the plain path's, bit for bit."""
    cfg = _heads_cfg(dtype, stride)
    shape = (1, 16, 32, 32, 1)
    cfg.input_size = list(shape[1:4])
    jm = jax_build(cfg)
    # bf16: flax's own init, as test_torch_model.py's bf16 case (seeded
    # weights of other scales drift further between two bf16 paths)
    params = _jax_params(jm, shape, seed=0) if dtype == "float32" else \
        jax.tree.map(np.asarray, jax_init(jm, cfg, jax.random.PRNGKey(0)))["params"]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": params}, x)
    model = build_model(cfg, device="cpu", seed=1)
    load_flax_params(model, params)
    assert not hasattr(model, "head") and list(model.heads) == ["aff", "sdt"]
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        plain = model(torch.from_numpy(x), plain=True)
    assert list(got) == ["aff", "sdt"]
    for k, r in ref.items():
        r, g = np.asarray(r), got[k]
        assert g.dtype == torch.float32 and g.shape == r.shape == shape[:4] + ((3,) if k == "aff" else (1,))
        torch.testing.assert_close(g, plain[k], rtol=0, atol=0)
        top = float(np.abs(r).max())
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * top)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=5e-2 * top)


def test_head_blocks_train_through_the_training_block():
    """Under grad a head's blocks run the training route: every parameter
    of every head gets a gradient, equal to the plain path's (the limits of
    ``test_torch_training.py``'s route test)."""
    cfg = load_config(MULTITASK, overrides=TINY, mode="train")
    model = build_model(cfg.model, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(1).random((1, 16, 16, 16, 1), dtype=np.float32))
    grads = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        out = model(x, plain=plain)
        sum(v.square().mean() for v in out.values()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert all(g is not None for g in grads[0].values()) and len(grads[0]) == len(list(model.parameters()))
    assert any(n.startswith("heads.aff.blocks.0.") for n in grads[0])
    top = max(g.abs().max().item() for g in grads[1].values())
    for n, want in grads[1].items():
        if n.endswith("conv_bias"):  # zero in exact arithmetic: absolute, against the largest gradient
            assert (grads[0][n] - want).abs().max().item() <= 1e-5 * top, n
        else:
            torch.testing.assert_close(grads[0][n], want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


# ---------------------------------------------------------------------------
# inference: output_head, the sorted-name merge, head_spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", ["aff_r5", "sedt", None], ids=["aff_r5", "sedt", "merged"])
def test_inference_manager_heads_match_jax(head):
    """The betaseg model on one volume through both managers on the same
    weights: the named head's activated prediction (or every head merged
    in sorted name order) within 1e-4 (f32 sums in another order through
    GroupNorm and the sigmoid, as the chunked test leg's comparison), the
    channel count and the merge's
    ``head_spans`` equal."""
    over = TINY + ["inference.window.sw_batch_size=2", "inference.window.overlap=0.5"]
    cfg, jcfg = load_config(BETASEG, overrides=over, mode="test"), jax_load_config(BETASEG, overrides=over, mode="test")
    jm = jax_build(jcfg.model)
    params = _jax_params(jm, (1, 16, 16, 16, 1), seed=4)
    model = build_model(cfg.model, device="cpu", seed=0)
    load_flax_params(model, params)
    vol = np.random.default_rng(2).random((20, 24, 22), dtype=np.float32)
    cfg.inference.model.output_head = jcfg.inference.model.output_head = head
    manager = InferenceManager(cfg, model, "cpu")
    jmanager = JaxInferenceManager(jcfg, jm)
    got, want = manager.predict(vol), jmanager.predict(params, vol)
    assert got.shape == want.shape == (20, 24, 22, manager.out_channels)
    assert manager.out_channels == {"aff_r5": 3, "sedt": 1, None: 7}[head]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert manager.head_spans == jmanager.head_spans
    if head is None:
        assert manager.head_spans == [("aff_r1", 0, 3), ("aff_r5", 3, 6), ("sedt", 6, 7)]


def test_output_head_must_name_a_head():
    cfg = load_config(BETASEG, overrides=TINY + ["inference.model.output_head=nope"], mode="test")
    with pytest.raises(KeyError, match="nope"):
        InferenceManager(cfg, build_model(cfg.model, device="cpu"), "cpu")


# ---------------------------------------------------------------------------
# the ring planners at the multi-task recipes' shapes
# ---------------------------------------------------------------------------

# (B, Z, Y, X, C) of the stride-1 training stages: betaseg's batch 2 of 192^3
# (stage 0 is 2 x 192^3 x 32 = 453 M elements), the SNEMI multi-task
# recipe's batch 8 at the z of 16 it runs at (its shipped 18 is no multiple
# of 16, which MedNeXt's four down/up steps need in both packages)
MULTITASK_TRAIN = sorted({(2, *sp, c) for sp, c, _ in mednext_stages((192, 192, 192), "S", (1, 1, 1))}
                         | {(8, *sp, c) for sp, c, _ in mednext_stages((16, 160, 160), "S", (1, 1, 1))})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MULTITASK_TRAIN, ids=lambda s: "x".join(map(str, s)))
def test_depthwise_planner_covers_the_multitask_training_shapes(shape, dtype):
    plan = dw.kernel_plan(shape, dtype)
    for kind, name in enumerate(dw.KERNEL_NAMES):
        assert plan[name]["kernel"] == name
        _check_plan(shape, dtype, kind, plan[name])


@pytest.mark.parametrize("batch,window", [(1, (192, 192, 192)), (2, (192, 192, 192)), (8, (16, 160, 160))],
                         ids=["betaseg-test", "betaseg-train", "snemi-multitask"])
def test_pair_planner_covers_the_multitask_shapes(batch, window):
    """The fused pair's plans (statistics, bf16 apply) at every stride-1
    stage of the betaseg test window (batch 1), at its training batch 2
    under ``no_grad`` (the val step), and at the SNEMI multi-task batch 8."""
    for spatial, c, r in mednext_stages(window, "S", (1, 1, 1)):
        shape = (batch, *spatial, c)
        s = fb.stats_plan(shape, torch.bfloat16)
        assert s["smem_bytes"] <= fb.MAX_SMEM
        check_tiling(shape, s)
        a = fb.kernel_plan(shape, torch.bfloat16, r)["fused_block_apply"]
        assert a["smem_bytes"] <= fb.MAX_SMEM
        check_tiling(shape, a)


def test_chunked_inference_probes_the_selected_head(tmp_path):
    """Without ``out_channels`` the chunked path probes the engine, whose
    forward selects the head: ``aff_r5``'s 3 channels of the betaseg model
    (7 in all); one chunk covers the volume, so the file equals the
    whole-volume prediction within 1e-6."""
    from pytorch_connectomics_tpu_torch.config.schema import ChunkedConfig, build_dataclass
    from pytorch_connectomics_tpu_torch.inference import LazyVolumeAccessor, run_chunked_inference

    cfg = load_config(BETASEG, overrides=TINY + ["inference.model.output_head=aff_r5"], mode="test")
    model = build_model(cfg.model, device="cpu", seed=0)
    manager = InferenceManager(cfg, model, "cpu")
    vol = np.random.default_rng(3).random((16, 24, 24), dtype=np.float32)
    np.save(tmp_path / "im.npy", vol)
    chunks = build_dataclass(ChunkedConfig, {"enabled": True, "chunk_size": [16, 24, 24], "halo": [8, 8, 8]})
    path = run_chunked_inference(manager.predictor, LazyVolumeAccessor(str(tmp_path / "im.npy"), normalize="none"),
                                 tmp_path / "pred.npy", chunks)
    got = np.load(path)
    assert got.shape == (3, 16, 24, 24) == (manager.out_channels, *vol.shape)
    np.testing.assert_allclose(np.moveaxis(got, 0, -1), manager.predict(vol), rtol=0, atol=1e-6)
