"""The rest of the port's training (``training/optim.py``, ``state.py``,
``loop.py``, ``distill.py``) against the JAX package's, on the CPU:

- SGD and LAMB through the port's train step against optax's chains over 5
  steps of fixed gradients (1e-6);
- every schedule's learning rate at every step against JAX's
  ``build_schedule``;
- ``accumulate_grad_batches`` over 2k steps against ``optax.MultiSteps``
  (parameters and EMA after every micro-step);
- ReduceLROnPlateau and early stopping over a fixed metric sequence against
  JAX's ``Trainer._plateau_update`` and ``_early_stop_update`` on a stub;
- ``soft_target_loss`` and its gradient, distillation from a port
  checkpoint, the teacher formats the port refuses, and anomaly detection.

The train step runs on a parameter tree with a linear loss ``sum(G_t * p)``,
so each step's gradient is exactly ``G_t``, the gradients fed to optax."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.training import distill as jdistill
from pytorch_connectomics_tpu.training.loop import Trainer as JaxTrainer
from pytorch_connectomics_tpu.training.optim import build_optimizer as jax_build_optimizer
from pytorch_connectomics_tpu.training.optim import build_schedule as jax_build_schedule
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.training import distill
from pytorch_connectomics_tpu_torch.training.checkpoint import CheckpointManager
from pytorch_connectomics_tpu_torch.training.loop import Trainer
from pytorch_connectomics_tpu_torch.training.optim import build_optimizer, build_schedule
from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"
SHAPES = {"w1": (3, 4), "w2": (2, 2, 3), "bias": (4,), "zero": (2, 3)}


class Tree(torch.nn.Module):
    def __init__(self, p0):
        super().__init__()
        for k, v in p0.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, x):
        return x


class Linear:
    """An orchestrator whose loss is sum(G_t * p): the step's gradient is G_t."""

    terms = ()
    num_terms = 1

    def __init__(self, model, grads):
        self.model, self.grads, self.t = model, grads, 0

    def __call__(self, out, target, mask=None, weight=None, balancer_params=None, term_weights=None):
        g = self.grads[self.t]
        self.t += 1
        total = sum((p * torch.from_numpy(g[n])).sum() for n, p in self.model.named_parameters())
        return total, {"loss_total": total}


def _tree(seed, steps):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    p0["zero"][:] = 0  # LAMB's trust ratio at a zero norm
    grads = [{k: (rng.standard_normal(s) * 0.7).astype(np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    return p0, grads


def _run(over, steps, ema=None):
    """(port parameters, JAX parameters, port EMA, JAX EMA) after each step."""
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    p0, grads = _tree(len(over), steps)
    model = Tree(p0)
    opt, schedule = build_optimizer(cfg.optimization, model, 10)
    state = create_train_state(model, opt, ema=ema is not None)
    step = make_train_step(Linear(model, grads), schedule, gradient_clip=cfg.optimization.gradient_clip_val,
                           ema_decay=ema, accumulate=cfg.optimization.accumulate_grad_batches)
    tx, _ = jax_build_optimizer(jcfg.optimization, 10)
    jp = {"model": {k: jnp.asarray(v) for k, v in p0.items()}}
    js, jema = tx.init(jp), dict(jp["model"])
    batch = {"image": torch.zeros(1)}
    got, want, got_ema, want_ema = [], [], [], []
    for g in grads:
        step(state, batch)
        upd, js = tx.update({"model": {k: jnp.asarray(v) for k, v in g.items()}}, js, jp)
        jp = optax.apply_updates(jp, upd)
        got.append({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
        want.append({k: np.asarray(v) for k, v in jp["model"].items()})
        if ema is not None:
            jema = {k: ema * jema[k] + (1 - ema) * jp["model"][k] for k in jema}
            got_ema.append({k: v.numpy().copy() for k, v in state.ema.items()})
            want_ema.append({k: np.asarray(v) for k, v in jema.items()})
    return got, want, got_ema, want_ema


OPTIMIZERS = {
    "sgd_momentum_decay": ["optimization.optimizer.name=SGD", "optimization.optimizer.lr=0.05",
                           "optimization.optimizer.momentum=0.9", "optimization.optimizer.weight_decay=0.01"],
    "sgd_plain": ["optimization.optimizer.name=SGD", "optimization.optimizer.lr=0.05",
                  "optimization.optimizer.momentum=0.0", "optimization.optimizer.weight_decay=0.0"],
    "lamb_decay": ["optimization.optimizer.name=LAMB", "optimization.optimizer.lr=0.02",
                   "optimization.optimizer.weight_decay=0.01"],
    "lamb": ["optimization.optimizer.name=LAMB", "optimization.optimizer.lr=0.02",
             "optimization.optimizer.weight_decay=0.0"],
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """5 steps under the global-norm clip and a constant schedule."""
    over = OPTIMIZERS[name] + ["optimization.scheduler.name=constant"]
    got, want, _, _ = _run(over, 5)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.allclose(got[-1]["w1"], _tree(len(over), 0)[0]["w1"])


SCHEDULES = {
    "warm_restarts": ["optimization.scheduler.name=CosineAnnealingWarmRestarts", "optimization.scheduler.t_0=2",
                      "optimization.scheduler.t_mult=2"],
    "warm_restarts_steps": ["optimization.scheduler.name=CosineAnnealingWarmRestarts",
                            "optimization.scheduler.interval=step", "optimization.scheduler.t_0=7"],
    "step_lr": ["optimization.scheduler.name=StepLR", "optimization.scheduler.step_size=3",
                "optimization.scheduler.gamma=0.5"],
    "multi_step": ["optimization.scheduler.name=MultiStepLR", "optimization.scheduler.milestones=[1,4,6]",
                   "optimization.scheduler.gamma=0.3"],
    "warmup_multi_step": ["optimization.scheduler.name=WarmupMultiStepLR", "optimization.scheduler.milestones=[2,5]",
                          "optimization.scheduler.warmup_steps=9", "optimization.scheduler.warmup_start_lr=1e-5"],
    "plateau": ["optimization.scheduler.name=ReduceLROnPlateau"],
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax_every_step(name):
    over = SCHEDULES[name] + ["optimization.n_steps_per_epoch=4", "optimization.max_epochs=20"]
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    ours, ref = build_schedule(cfg.optimization, 4), jax_build_schedule(jcfg.optimization, 4)
    counts = np.arange(0, 100)
    want = np.array([float(ref(jnp.asarray(c))) for c in counts])
    got = np.array([ours(int(c)) for c in counts])
    peak = float(cfg.optimization.optimizer.lr)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2 * np.finfo(np.float32).eps * peak)
    assert name == "plateau" or len(np.unique(got)) > 2


ACCUMULATE = {"adamw": ["optimization.optimizer.lr=0.05", "optimization.scheduler.warmup_steps=1"],
              "sgd": OPTIMIZERS["sgd_momentum_decay"] + ["optimization.scheduler.warmup_steps=1"]}


@pytest.mark.parametrize("name", list(ACCUMULATE))
@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_multisteps(k, name):
    """AdamW (its decay mask) and SGD, with the clip and the warmup cosine
    schedule, under ``optax.MultiSteps(k)`` over 2k micro-steps: the
    parameters after each (moving every k-th), and the EMA, which moves
    every micro-step. Adam divides by sqrt(v): where a first moment cancels
    to near zero its f32 roundings reach about 1e-5 of an lr-sized step, so
    AdamW is held to 1e-6 absolute (the parameters are of order 1)."""
    over = [f"optimization.accumulate_grad_batches={k}"] + ACCUMULATE[name]
    got, want, got_ema, want_ema = _run(over, 2 * k, ema=0.9)
    atol = 1e-6 if name == "adamw" else 1e-7
    for i, (g, w, ge, we) in enumerate(zip(got, want, got_ema, want_ema)):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=atol, err_msg=f"{key} step {i}")
            np.testing.assert_allclose(ge[key], we[key], rtol=1e-6, atol=atol, err_msg=f"ema {key} step {i}")
    p0 = _tree(len(over), 0)[0]["w1"]
    assert np.array_equal(got[k - 2]["w1"], p0) and not np.array_equal(got[k - 1]["w1"], p0)
    assert np.array_equal(got[2 * k - 2]["w1"], got[k - 1]["w1"]) and not np.array_equal(got[-1]["w1"], got[k - 1]["w1"])


def _stub(cls, cfg, jax_state):
    s = types.SimpleNamespace(cfg=cfg, _plateau=cfg.optimization.scheduler.name == "ReduceLROnPlateau",
                              _plateau_best=np.inf, _plateau_bad=0, _es_bad=0,
                              _es_best=np.inf if cfg.monitor.early_stopping.mode == "min" else -np.inf)
    if jax_state:
        s.state = types.SimpleNamespace(lr_scale=1.0)
        s.state.replace = lambda **kw: types.SimpleNamespace(**{**vars(s.state), **kw})
    else:
        s.state = types.SimpleNamespace(lr_scale=1.0)
    s._plateau_update = types.MethodType(cls._plateau_update, s)
    s._early_stop_update = types.MethodType(cls._early_stop_update, s)
    return s


@pytest.mark.parametrize("mode,check_finite", [("min", True), ("max", False)])
def test_plateau_and_early_stopping_match_jax(mode, check_finite):
    over = ["optimization.scheduler.name=ReduceLROnPlateau", "optimization.scheduler.patience=2",
            "optimization.scheduler.factor=0.5", "monitor.early_stopping.enabled=true",
            f"monitor.early_stopping.mode={mode}", "monitor.early_stopping.patience=3",
            "monitor.early_stopping.min_delta=0.01", f"monitor.early_stopping.check_finite={str(check_finite).lower()}"]
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    ours, ref = _stub(Trainer, cfg, False), _stub(JaxTrainer, jcfg, True)
    metrics = [1.0, 0.9, 0.95, 0.9, 0.905, 0.7, 0.7, 0.71, 0.72, 0.6, float("nan"), 0.5, 0.5, 0.55, 0.56, 0.57]
    scales, stops = [], []
    for m in metrics:
        for t in (ours, ref):
            t._plateau_update(m)
        stop = [t._early_stop_update({"val_loss": m}) for t in (ours, ref)]
        assert stop[0] == stop[1]
        assert ours.state.lr_scale == pytest.approx(float(ref.state.lr_scale), rel=1e-12)
        scales.append(ours.state.lr_scale)
        stops.append(stop[0])
    assert len(set(scales)) > 2 and any(stops) and not all(stops)


def _logits(seed, shape=(2, 3, 4, 5, 2)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32) * 2


@pytest.mark.parametrize("mode", ["sigmoid", "mse"])
def test_soft_target_loss_matches_jax(mode):
    """Tensors, and head dicts with a deep-supervision output (dropped)."""
    s, t, s2, t2 = _logits(0), _logits(1), _logits(2), _logits(3)
    for student, teacher in ((s, t), ({"a": s, "b": s2, "ds_1": s2[:, :1]}, {"a": t, "b": t2})):
        def jloss(x):
            xs = jax.tree.map(jnp.asarray, x)
            return jdistill.soft_target_loss(xs, jax.tree.map(jnp.asarray, teacher), temperature=3.0, mode=mode)

        want, want_g = jax.value_and_grad(jloss)(student)
        ts = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), student)
        got = distill.soft_target_loss(ts, jax.tree.map(torch.from_numpy, teacher), temperature=3.0, mode=mode)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        leaves = ts.items() if isinstance(ts, dict) else [("out", ts)]
        for k, a in leaves:
            w = np.asarray(want_g[k] if isinstance(want_g, dict) else want_g)
            if k.startswith("ds_"):
                assert a.grad is None and not w.any()
                continue
            np.testing.assert_allclose(a.grad.numpy(), w, rtol=1e-5, atol=1e-8)


TINY_UNET = ["model.arch.type=monai_basic_unet", "model.monai.features=[4,4,8,8,8,4]", "model.input_size=[16,16,16]",
             "optimization.precision=32", "model.out_channels=1"]


def test_distillation_from_a_port_checkpoint(tmp_path):
    """The teacher, a port checkpoint of another width, is loaded into the
    merged config; the step's total is (1 - alpha) hard + alpha distill; JAX's
    own teacher formats raise naming the format."""
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model

    tcfg = load_config(SYNTH, overrides=TINY_UNET + ["model.monai.features=[6,6,8,8,8,6]"], mode="train")
    teacher = build_model(tcfg.model, device="cpu", seed=3)
    opt, _ = build_optimizer(tcfg.optimization, teacher, 10)
    CheckpointManager(tmp_path / "ck").save(create_train_state(teacher, opt), 0, {}, metadata={"step": 0})
    ck = next((tmp_path / "ck").glob("*/state.pt")).parent
    over = TINY_UNET + [f"optimization.distill.teacher_checkpoint={ck}", "optimization.distill.alpha=0.3",
                        "optimization.distill.teacher_model={monai: {features: [6,6,8,8,8,6]}}"]
    cfg = load_config(SYNTH, overrides=over, mode="train")
    spec = distill.build_distill_spec(cfg, "cpu")
    for (n, a), b in zip(spec.model.state_dict().items(), teacher.state_dict().values()):
        assert torch.equal(a, b), n
    student = build_model(cfg.model, device="cpu", seed=0)
    orch = LossOrchestrator(cfg.model.loss)
    opt, schedule = build_optimizer(cfg.optimization, student, 10)
    step = make_train_step(orch, schedule, distill=spec)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1, 16, 16, 16, 1), dtype=np.float32))
    y = torch.from_numpy((rng.random((1, 16, 16, 16, 1)) > 0.5).astype(np.float32))
    with torch.no_grad():
        hard, _ = orch(student(x), y)
        soft = distill.soft_target_loss(student(x), spec.model(x), spec.temperature, spec.mode)
    logs = step(create_train_state(student, opt), {"image": x, "label": y})
    np.testing.assert_allclose(float(logs["loss_hard"]), float(hard), rtol=1e-5)
    np.testing.assert_allclose(float(logs["loss_distill"]), float(soft), rtol=1e-5)
    np.testing.assert_allclose(float(logs["loss_total"]), 0.7 * float(hard) + 0.3 * float(soft), rtol=1e-5)
    (tmp_path / "teacher.msgpack").write_bytes(b"\x80")
    (tmp_path / "orbax").mkdir()
    for path, fmt in ((tmp_path / "teacher.msgpack", "msgpack"), (tmp_path / "orbax", "Orbax")):
        with pytest.raises(NotImplementedError, match=fmt):
            distill.load_teacher(build_model(tcfg.model, device="cpu"), path, tcfg)


def test_anomaly_detection_raises_at_the_first_non_finite_value():
    """A NaN weight stops the forward at its module; a NaN made in the
    backward alone (sqrt at 0) stops the backward."""
    from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
    from pytorch_connectomics_tpu_torch.models import build_model

    cfg = load_config(SYNTH, overrides=TINY_UNET + ["monitor.detect_anomaly=true"], mode="train")
    model = build_model(cfg.model, device="cpu", seed=0)
    opt, schedule = build_optimizer(cfg.optimization, model, 10)
    batch = {"image": torch.rand(1, 16, 16, 16, 1), "label": torch.ones(1, 16, 16, 16, 1)}
    orch = LossOrchestrator(cfg.model.loss)
    step = make_train_step(orch, schedule, detect_anomaly=True)
    logs = step(create_train_state(model, opt), batch)  # finite: runs
    assert np.isfinite(float(logs["loss_total"]))
    name, p = next((n, p) for n, p in model.named_parameters() if p.dim() > 1)
    with torch.no_grad():
        p.view(-1)[0] = float("nan")
    with pytest.raises(FloatingPointError, match="forward output"):
        step(create_train_state(model, opt), batch)
    model = build_model(cfg.model, device="cpu", seed=0)

    def sqrt_loss(out, target, **kw):
        total, logs = orch(out, target)
        total = total + torch.sqrt(out.sum() - out.sum().detach())
        return total, logs

    sqrt_loss.terms = orch.terms
    step = make_train_step(sqrt_loss, schedule, detect_anomaly=True)
    with pytest.raises(RuntimeError, match="nan"):
        step(create_train_state(model, build_optimizer(cfg.optimization, model, 10)[0]), batch)


def test_profiler_window_writes_a_trace(tmp_path):
    """The trainer's profiler start and stop: a Chrome trace under
    ``<run_dir>/profile`` named by the step."""
    stub = types.SimpleNamespace(device=torch.device("cpu"), run_dir=tmp_path, state=types.SimpleNamespace(step=7))
    prof = Trainer._start_profiler(stub)
    torch.ones(4) @ torch.ones(4)
    Trainer._stop_profiler(stub, prof)
    assert "aten::" in (tmp_path / "profile" / "trace_step7.json").read_text()
