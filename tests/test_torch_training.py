"""The port's training slice against the JAX package on the CPU: losses,
the loss orchestrator, the learning-rate schedule, AdamW with the
global-norm clip, and one- and two-step train parity of a tiny MedNeXt-S
with the synthetic recipe's (1, 2, 2) stem in float32, weights carried over
by ``models/convert.py``. Also the gradient-routing repair: on the CPU every
parameter gets a gradient, and the fused inference kernels refuse to run
under grad."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.losses import zoo as jax_zoo
from pytorch_connectomics_tpu.losses.orchestrator import LossOrchestrator as JaxOrchestrator
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.models.build import init_model as jax_init
from pytorch_connectomics_tpu.training.optim import build_optimizer as jax_build_optimizer
from pytorch_connectomics_tpu.training.optim import build_schedule as jax_build_schedule
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.losses import LossOrchestrator, get_loss
from pytorch_connectomics_tpu_torch.losses import zoo
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import load_flax_params
from pytorch_connectomics_tpu_torch.ops import fused_block as fb
from pytorch_connectomics_tpu_torch.training.optim import build_optimizer, build_schedule, decay_groups
from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "optimization.precision=32",
    "model.input_size=[16,32,32]",
]


def _pred_target(seed=0, shape=(2, 4, 6, 5, 2)):
    rng = np.random.default_rng(seed)
    pred = (rng.standard_normal(shape) * 2).astype(np.float32)
    target = (rng.random(shape) > 0.6).astype(np.float32)
    mask = (rng.random(shape[:-1] + (1,)) > 0.3).astype(np.float32)
    weight = rng.random(shape[:-1] + (1,)).astype(np.float32)
    return pred, target, mask, weight


@pytest.mark.parametrize("name", ["BCEWithLogitsLoss", "WeightedBCEWithLogitsLoss", "DiceLoss"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask+weight"])
def test_losses_match_jax(name, masked):
    pred, target, mask, weight = _pred_target()
    kw = dict(mask=mask, weight=weight) if masked else {}
    want = float(jax_zoo.get_loss(name)(jnp.asarray(pred), jnp.asarray(target), **kw))
    got = get_loss(name)(
        torch.from_numpy(pred), torch.from_numpy(target), **{k: torch.from_numpy(v) for k, v in kw.items()}
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_bce_pos_weight_matches_jax():
    pred, target, _, _ = _pred_target(1)
    want = float(jax_zoo.bce_with_logits(jnp.asarray(pred), jnp.asarray(target), pos_weight=3.0))
    np.testing.assert_allclose(float(zoo.bce_with_logits(torch.from_numpy(pred), torch.from_numpy(target), pos_weight=3.0)), want, rtol=1e-6)


def test_unported_loss_raises_naming_it():
    """Every name of JAX's registry resolves (the whole zoo is ported); an
    unknown name raises naming it."""
    assert set(zoo.LOSS_REGISTRY) == set(jax_zoo.LOSS_REGISTRY)
    assert get_loss("FocalLoss") is zoo.focal_loss
    with pytest.raises(KeyError, match="NoSuchLoss"):
        get_loss("NoSuchLoss")


def test_orchestrator_total_matches_jax():
    cfg = load_config(SYNTH, overrides=TINY, mode="train")
    jcfg = jax_load_config(SYNTH, overrides=TINY, mode="train")
    pred, target, mask, weight = _pred_target(2, (2, 4, 6, 5, 1))
    want_total, want_logs = JaxOrchestrator(jcfg.model.loss)(jnp.asarray(pred), jnp.asarray(target), mask=jnp.asarray(mask))
    total, logs = LossOrchestrator(cfg.model.loss)(torch.from_numpy(pred), torch.from_numpy(target), mask=torch.from_numpy(mask))
    assert set(logs) == set(want_logs) == {"loss_BCEWithLogitsLoss_0", "loss_DiceLoss_1", "loss_total"}
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(want_logs[k]), rtol=1e-6)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)


@pytest.mark.parametrize(
    "name,over",
    [
        ("warmup30_of_300", ["optimization.n_steps_per_epoch=150", "optimization.max_epochs=2"]),
        ("warmup_clamped", ["optimization.n_steps_per_epoch=10", "optimization.max_epochs=2"]),
        ("cosine_annealing", ["optimization.scheduler.name=CosineAnnealingLR", "optimization.scheduler.interval=step",
                              "optimization.scheduler.t_max=250", "optimization.scheduler.min_lr=1e-5",
                              "optimization.n_steps_per_epoch=150", "optimization.max_epochs=2"]),
        ("constant", ["optimization.scheduler.name=constant"]),
    ],
)
def test_schedule_matches_optax_every_step(name, over):
    cfg = load_config(SYNTH, overrides=TINY + over, mode="train")
    jcfg = jax_load_config(SYNTH, overrides=TINY + over, mode="train")
    spe = cfg.optimization.n_steps_per_epoch
    ours, ref = build_schedule(cfg.optimization, spe), jax_build_schedule(jcfg.optimization, spe)
    counts = np.arange(0, 301)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(counts)))
    got = np.array([ours(int(c)) for c in counts])
    # optax evaluates in float32, the port in float64: two float32 ulps of the peak
    peak = float(cfg.optimization.optimizer.lr)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2 * np.finfo(np.float32).eps * peak)


def test_adamw_with_clip_matches_optax():
    """Three steps of identical gradients through the port's AdamW + clip
    and through optax's chain(clip_by_global_norm, adamw(mask))."""
    cfg = load_config(SYNTH, overrides=TINY, mode="train")
    jcfg = jax_load_config(SYNTH, overrides=TINY, mode="train")
    rng = np.random.default_rng(3)
    shapes = {"conv_weight": (4, 1, 3, 3, 3), "conv_bias": (4,), "norm.weight": (4,), "pw1.weight": (8, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k.replace(".", "_"), v)
    groups = decay_groups(params.items(), cfg.optimization.optimizer.weight_decay, True)
    assert [len(g["params"]) for g in groups] == [2, 2]  # weights decay; bias and norm scale do not
    opt, schedule = build_optimizer(cfg.optimization, module, 150)
    opt.param_groups.clear()
    for g in groups:
        opt.add_param_group({**g, "lr": 0.0})
    state = create_train_state(module, opt)
    from pytorch_connectomics_tpu_torch.training.optim import clip_by_global_norm_, global_norm, set_lr

    # optax: leaf names as flax writes them (bias / scale / kernel)
    jnames = {"conv_weight": "kernel", "conv_bias": "bias", "norm.weight": "scale", "pw1.weight": "kernel2"}
    tx, _ = jax_build_optimizer(jcfg.optimization, 150)
    jp = {jnames[k]: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        gl = [p.grad for p in params.values()]
        clip_by_global_norm_(gl, cfg.optimization.gradient_clip_val, global_norm(gl))
        set_lr(opt, schedule(state.step))
        opt.step()
        state.step += 1
        upd, js = tx.update({jnames[k]: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[jnames[k]]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# train-step parity with the JAX package (one JAX compile per module)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_reference():
    """Step-1 loss and gradients, and the step-2 loss after one optax update,
    of the JAX package's tiny MedNeXt-S on two seeded batches."""
    cfg = jax_load_config(SYNTH, overrides=TINY, mode="train")
    model = jax_build(cfg.model)
    params = jax.tree.map(np.asarray, jax_init(model, cfg.model, jax.random.PRNGKey(0)))["params"]
    orch = JaxOrchestrator(cfg.model.loss)
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(2):
        x = rng.random((2, 16, 32, 32, 1), dtype=np.float32)
        batches.append((x, (rng.random(x.shape) > 0.7).astype(np.float32)))

    def loss_fn(p, x, y):
        return orch(model.apply({"params": p}, x), y)[0]

    vg = jax.jit(jax.value_and_grad(loss_fn))
    loss1, grads1 = vg(params, *batches[0])
    tx, _ = jax_build_optimizer(cfg.optimization, cfg.optimization.n_steps_per_epoch)
    wrapped = {"model": params}  # the JAX train state's layout
    upd, _ = jax.jit(tx.update)({"model": grads1}, tx.init(wrapped), wrapped)
    params2 = optax.apply_updates(wrapped, upd)["model"]
    loss2, _ = vg(params2, *batches[1])
    return dict(params=params, batches=batches, loss1=float(loss1), loss2=float(loss2),
                grads1=jax.tree.map(np.asarray, grads1))


def _port_model(params):
    cfg = load_config(SYNTH, overrides=TINY, mode="train")
    model = build_model(cfg.model, device="cpu", seed=5)
    load_flax_params(model, params)
    return cfg, model


def test_train_step_matches_jax(jax_reference):
    ref = jax_reference
    cfg, model = _port_model(ref["params"])
    orch = LossOrchestrator(cfg.model.loss)
    (x1, y1), (x2, y2) = [tuple(torch.from_numpy(a) for a in b) for b in ref["batches"]]
    loss1, _ = orch(model(x1), y1)
    loss1.backward()
    np.testing.assert_allclose(loss1.item(), ref["loss1"], rtol=1e-5)
    # step-1 gradients, leaf by leaf, through the flax -> port bridge
    want = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _flax_grads_as_port(ref["grads1"], model).items()}
    for name, p in model.named_parameters():
        g, w = p.grad, want[name]
        if name.endswith("conv_bias"):  # zero in exact arithmetic: GroupNorm follows the conv
            top = max(v.norm().item() for v in want.values())
            assert (g - w).abs().max().item() <= 1e-4 * top, name
        else:
            assert (g - w).norm().item() <= 1e-4 * w.norm().item(), (name, (g - w).norm().item(), w.norm().item())
    # two port train steps: the second step's loss is the loss after one update
    model.zero_grad(set_to_none=True)
    opt, schedule = build_optimizer(cfg.optimization, model, cfg.optimization.n_steps_per_epoch)
    state = create_train_state(model, opt)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val)
    logs1 = step(state, {"image": x1, "label": y1})
    logs2 = step(state, {"image": x2, "label": y2})
    np.testing.assert_allclose(float(logs1["loss_total"]), ref["loss1"], rtol=1e-5)
    np.testing.assert_allclose(float(logs2["loss_total"]), ref["loss2"], rtol=1e-4)
    assert state.step == 2 and np.isfinite(float(logs2["grad_norm"]))


def _flax_grads_as_port(grads, model):
    from pytorch_connectomics_tpu_torch.models.convert import flax_to_state_dict

    return flax_to_state_dict(grads, model)


def test_every_parameter_gets_a_gradient_on_cpu():
    """The repair of the inference-only block: with grad enabled every
    MedNeXt-S parameter (the stride-1 blocks' pointwise weights included)
    gets a gradient."""
    cfg = load_config(SYNTH, overrides=TINY[:-1] + ["model.mednext.block_counts=[2,1,1,1,1,1,1,1,2]"], mode="train")
    model = build_model(cfg.model, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 16, 32, 32, 1), dtype=np.float32))
    model(x).square().mean().backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing
    assert all(model.enc[0].blocks[i].pw1.weight.grad.abs().sum() > 0 for i in range(2))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_training_block_gradients_match_plain_and_remat(remat):
    """The training block through the depthwise Function gives the plain
    path's gradients, with and without per-block checkpointing."""
    over = TINY + [f"model.mednext.checkpoint_style={'outside_block' if remat else 'null'}"]
    cfg = load_config(SYNTH, overrides=over, mode="train")
    model = build_model(cfg.model, device="cpu", seed=1)
    assert model.remat is remat
    x = torch.from_numpy(np.random.default_rng(1).random((1, 16, 32, 32, 1), dtype=np.float32))
    grads = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        model(x, plain=plain).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    top = max(g.abs().max().item() for g in grads[1].values())
    for n, want in grads[1].items():
        if n.endswith("conv_bias"):  # zero in exact arithmetic: absolute, against the largest gradient
            assert (grads[0][n] - want).abs().max().item() <= 1e-5 * top, n
        else:
            torch.testing.assert_close(grads[0][n], want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


def test_fused_wrappers_refuse_grad():
    rng = np.random.default_rng(0)
    c, r = 16, 32
    x = torch.from_numpy(rng.standard_normal((1, 3, 4, 5, c), dtype=np.float32)).requires_grad_(True)
    w_dw = torch.zeros((c, 1, 3, 3, 3))
    p = [torch.ones(c), torch.zeros(c), torch.zeros((r, c)), torch.zeros(r), torch.zeros((c, r)), torch.zeros(c)]
    with pytest.raises(RuntimeError, match="no backward pass"):
        fb.dw_stats(x, w_dw)
    with pytest.raises(RuntimeError, match="no backward pass"):
        fb.fused_mednext_block(x, w_dw, *p)
    with pytest.raises(RuntimeError, match="no backward pass"):
        fb.fused_block_apply(x, torch.zeros((1, 2, c)), w_dw, *p)
    with torch.no_grad():  # inference is unchanged
        assert fb.fused_mednext_block(x, w_dw, *p).shape == x.shape


def test_trainer_ema_and_inference_params(tmp_path):
    """With ``monitor.ema`` on, a train step moves the EMA copy toward the
    updated weights by ``1 - decay``, and ``inference_params`` is that copy."""
    from pytorch_connectomics_tpu_torch.training.loop import Trainer

    over = TINY + ["monitor.ema.enabled=true", "monitor.ema.decay=0.5"]
    trainer = Trainer(load_config(SYNTH, overrides=over, mode="train"), run_dir=tmp_path, device="cpu")
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((1, 16, 32, 32, 1), dtype=np.float32))
    trainer._train_step(trainer.state, {"image": x, "label": (x > 0.7).float()})
    ema = trainer.inference_params
    assert ema is trainer.state.ema
    for n, p in trainer.model.named_parameters():
        torch.testing.assert_close(ema[n], 0.5 * before[n] + 0.5 * p.detach(), rtol=1e-6, atol=1e-7)
    trainer.cfg.monitor.ema.use_for_val = False
    assert set(trainer.inference_params) == set(trainer.model.state_dict())
    trainer.metrics_logger.close()
