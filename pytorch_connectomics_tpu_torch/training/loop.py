"""Trainer: the config-driven training loop, the port of ``Trainer`` in
``pytorch_connectomics_tpu/training/loop.py:42-434`` on one device.

- ``__init__``: steps per epoch (``n_steps_per_epoch`` > ``num_samples //
  batch_size`` > 100), the seeded model, optimizer and schedule, the loss
  orchestrator, the train state, the checkpoint manager and the metrics
  logger, all under ``run_dir``.
- ``fit``: epochs of steps (bounded by ``max_steps``) over the threaded
  patch pipeline; every ``loss_every_n_steps`` steps (and at step 1) it
  reads the logs to the host, checks them for non-finite values and logs
  them with ``steps_per_sec`` and ``lr``; every ``every_n_steps`` steps and
  at each epoch end it saves a checkpoint; it validates when a val pipeline
  exists.
- ``validate``, ``restore`` and ``inference_params``.

Batches reach the device through pinned host memory with non-blocking
copies. The rest of JAX's trainer (``loop.py:105-121,157-170,225-288,
392-420``):
- ``data.augmentation.on_device``: the train step augments the batch on
  the device (``ops/augment.py``) when every target is flip-safe; otherwise
  a warning, and no augmentation at all (the host pipeline skips it either
  way, as JAX's does);
- ``ReduceLROnPlateau``: the host ``lr_scale`` times ``factor`` after more
  than ``patience`` validations without a new best ``val_loss`` (by 1e-8);
  early stopping on ``monitor.early_stopping`` (its metric, mode,
  ``min_delta``, ``patience``, non-finite check) after each epoch's
  validation;
- ``monitor.profile_steps`` [start, end): a ``torch.profiler`` window over
  those steps, its Chrome trace in ``<run_dir>/profile``;
- ``monitor.detect_anomaly``: the step raises at the first non-finite value
  of the forward or the backward;
- ``optimization.distill``: the frozen teacher (``training/distill.py``);
- ``optimization.accumulate_grad_batches``.

The visualizer raises ``NotImplementedError`` when configured. UpKern
initialisation (``model.mednext.upkern_from``) is :meth:`Trainer.upkern`,
which the runtime calls before any restore.
"""

from __future__ import annotations

import logging
import math
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config.loader import config_hash
from ..config.schema import Config
from ..data.pipeline import build_pipelines
from ..data.targets.build import affinity_target_groups
from ..losses.orchestrator import LossOrchestrator
from ..models import build_model
from ..ops.augment import build_device_augment_fn
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger
from .checkpoint import CheckpointManager, check_config_hash
from .distill import build_distill_spec
from .optim import build_optimizer
from .state import create_train_state, make_log_vars, make_train_step, make_val_step

logger = logging.getLogger(__name__)


class NaNError(RuntimeError):
    pass


# targets whose channels keep their meaning under flips and transposes after
# generation (affinity, LSD and flow channels do not; JAX loop.py:108-109)
FLIP_SAFE = {"binary", "sdt", "instance_edt", "semantic_edt", "skeleton_aware_edt", "instance_boundary",
             "small_object"}


def _check_ported(cfg: Config) -> None:
    if int((cfg.monitor.logging.images or {}).get("log_every_n_epochs", 0)):
        raise NotImplementedError("the visualizer is not ported yet")


def device_augment_fn(cfg: Config):
    """The train step's on-device augmentation of ``cfg``, or None: off, or
    a target that is not flip-safe (with a warning)."""
    if not cfg.data.augmentation.on_device:
        return None
    targets = {t.name for t in (cfg.data.label_transform.targets or [])}
    if targets and not targets <= FLIP_SAFE:
        logger.warning("on-device augmentation disabled: targets %s are not flip-safe after generation",
                       sorted(targets - FLIP_SAFE))
        return None
    return build_device_augment_fn(cfg.data.augmentation)


class Trainer:
    def __init__(self, cfg: Config, run_dir: str | Path = "outputs/run", device=None):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.model = build_model(cfg.model, device=self.device, seed=cfg.system.seed)
        self.orchestrator = LossOrchestrator(
            cfg.model.loss, affinity_groups=affinity_target_groups(cfg.data.label_transform)
        )
        n_samples = cfg.data.dataloader.num_samples
        from_samples = max(1, int(n_samples) // max(1, cfg.data.dataloader.batch_size)) if n_samples else None
        self.steps_per_epoch = cfg.optimization.n_steps_per_epoch or from_samples or 100
        bal = cfg.model.loss.balancing
        # the uncertainty balancer's log-variances train with the model (JAX loop.py:96-100)
        log_vars = make_log_vars(bal.method, self.orchestrator.num_terms, self.device)
        optimizer, self.schedule = build_optimizer(
            cfg.optimization, self.model, self.steps_per_epoch,
            extra_params=[("balancer", log_vars)] if log_vars is not None else (),
        )
        self.cfg_hash = config_hash(cfg)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("model %s: %.2fM params on %s", cfg.model.arch.type, n_params / 1e6, self.device)
        self.state = create_train_state(
            self.model, optimizer, ema=cfg.monitor.ema.enabled, log_vars=log_vars,
            gradnorm_terms=self.orchestrator.num_terms if bal.method in ("gradnorm", "gradnorm_exact") else 0,
        )
        self.distill = build_distill_spec(cfg, self.device)
        if self.distill is not None:
            logger.info("distillation on: teacher=%s alpha=%.2f T=%.1f", cfg.optimization.distill.teacher_checkpoint,
                        self.distill.alpha, self.distill.temperature)
        self._train_step = make_train_step(
            self.orchestrator, self.schedule,
            gradient_clip=cfg.optimization.gradient_clip_val,
            ema_decay=cfg.monitor.ema.decay if cfg.monitor.ema.enabled else None,
            balancing=bal.method, balancing_alpha=bal.alpha, balancing_lr=bal.lr,
            distill=self.distill, augment_fn=device_augment_fn(cfg), seed=cfg.system.seed,
            accumulate=cfg.optimization.accumulate_grad_batches, detect_anomaly=cfg.monitor.detect_anomaly,
        )
        self._val_step = make_val_step(self.orchestrator, use_ema=cfg.monitor.ema.use_for_val)
        ck = cfg.monitor.checkpoint
        self.ckpt = CheckpointManager(
            self.run_dir / "checkpoints", save_top_k=ck.save_top_k, monitor=ck.monitor, mode=ck.mode,
            save_last=ck.save_last, filename_prefix=ck.checkpoint_filename,
        )
        self.metrics_logger = MetricsLogger(
            self.run_dir, cfg.monitor.logging.backend, wandb_cfg=cfg.monitor.wandb,
            config={"config_hash": self.cfg_hash},
        )
        self._plateau = cfg.optimization.scheduler.name == "ReduceLROnPlateau"
        self._plateau_best, self._plateau_bad = math.inf, 0
        self._es_best = math.inf if cfg.monitor.early_stopping.mode == "min" else -math.inf
        self._es_bad = 0

    def upkern(self) -> Dict[str, int]:
        """Initialise the model from ``model.mednext.upkern_from``
        (``training/model_weights.upkern_initialize``) and re-seed the EMA
        copy with the new weights (JAX ``dispatch.py:210-223``)."""
        from .model_weights import upkern_initialize

        stats = upkern_initialize(self.cfg.model, self.model)
        if self.state.ema is not None:
            self.state.ema = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        logger.info("UpKern-initialised from %s: %s", self.cfg.model.mednext.upkern_from, stats)
        return stats

    # -- checkpoint resume -------------------------------------------------

    def restore(self, path: str | Path, reset_optimizer: bool = False, reset_epoch: bool = False,
                params_only: bool = False) -> None:
        check_config_hash(CheckpointManager.read_metadata(path), self.cfg_hash)
        if params_only:
            self.state.step = self.ckpt.restore_params_only(path, self.model)
        else:
            self.ckpt.restore(path, self.state, reset_optimizer, reset_epoch)
        logger.info("restored checkpoint from %s (step %d)", path, self.state.step)

    # -- training ----------------------------------------------------------

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def fit(self, max_epochs: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        max_epochs = max_epochs or cfg.optimization.max_epochs
        max_steps = cfg.optimization.max_steps
        if max_steps:
            max_epochs = max(max_epochs, -(-int(max_steps) // self.steps_per_epoch))
        train_pipe, val_pipe = build_pipelines(cfg, self.device)
        scalar_every = int((cfg.monitor.logging.scalar or {}).get("loss_every_n_steps", 50))
        start_epoch = self.state.step // self.steps_per_epoch
        epoch_metrics: Dict[str, float] = {}
        it = train_pipe.iterate(self.state.step)
        first_step = self.state.step
        last_t, last_step = time.time(), first_step
        t_fit = time.perf_counter()
        data_wait = 0.0
        prof, prof_window = None, cfg.monitor.profile_steps
        try:
            for epoch in range(start_epoch, max_epochs):
                losses = []
                for _ in range(self.steps_per_epoch):
                    if max_steps and self.state.step >= int(max_steps):
                        break
                    t0 = time.perf_counter()
                    batch = self._to_device(next(it))
                    data_wait += time.perf_counter() - t0
                    if prof_window and prof is None and self.state.step >= prof_window[0]:
                        prof = self._start_profiler()
                    logs = self._train_step(self.state, batch)
                    step = self.state.step
                    if prof is not None and step >= prof_window[1]:
                        self._stop_profiler(prof)
                        prof, prof_window = None, None
                    vci = cfg.optimization.val_check_interval
                    if vci and val_pipe is not None:
                        ivl = int(vci) if vci >= 1 else max(1, round(float(vci) * self.steps_per_epoch))
                        if step % ivl == 0:
                            self._plateau_update(self.validate(val_pipe).get("val_loss", float("nan")))
                    ckpt_every = cfg.monitor.checkpoint.every_n_steps
                    if ckpt_every and step % int(ckpt_every) == 0:
                        self.ckpt.save(self.state, epoch, {}, metadata={"config_hash": self.cfg_hash, "step": step})
                    if step % scalar_every == 0 or step == 1:
                        host_logs = {k: float(v) for k, v in logs.items()}
                        self._check_finite(host_logs, step)
                        now = time.time()
                        host_logs["steps_per_sec"] = (step - last_step) / max(1e-6, now - last_t)
                        host_logs["lr"] = self.schedule(step) * self.state.lr_scale
                        last_t, last_step = now, step
                        self.metrics_logger.log(step, host_logs, prefix="train_")
                        logger.info(
                            "epoch %d step %d loss %.4f (%.2f it/s)", epoch, step,
                            host_logs.get("loss_total", float("nan")), host_logs["steps_per_sec"],
                        )
                        losses.append(host_logs.get("loss_total", float("nan")))
                epoch_loss = float(np.mean(losses)) if losses else float("nan")
                epoch_metrics = {"train_loss_total_epoch": epoch_loss, "epoch": epoch}
                if val_pipe is not None and (epoch + 1) % cfg.optimization.check_val_every_n_epoch == 0:
                    val_logs = self.validate(val_pipe)
                    epoch_metrics.update(val_logs)
                    self._plateau_update(val_logs.get("val_loss", epoch_loss))
                    if self._early_stop_update(val_logs):
                        logger.info("early stopping at epoch %d", epoch)
                        self._save_epoch(epoch, epoch_metrics)
                        break
                self.metrics_logger.log(self.state.step, epoch_metrics)
                self._save_epoch(epoch, epoch_metrics)
                if max_steps and self.state.step >= int(max_steps):
                    logger.info("max_steps %d reached", int(max_steps))
                    break
        finally:
            it.close()
            if prof is not None:
                self._stop_profiler(prof)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # host-clock totals of this call: steps, seconds, the trainer's wait
        # for batches and the pipeline's time making them
        self.fit_stats = {
            "steps": self.state.step - first_step,
            "seconds": time.perf_counter() - t_fit,
            "data_wait_seconds": data_wait,
            "pipeline_batches": train_pipe.batches,
            "pipeline_host_seconds": train_pipe.host_seconds,
        }
        return epoch_metrics

    def _save_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        self.ckpt.save(self.state, epoch, metrics, metadata={"config_hash": self.cfg_hash, "step": self.state.step})

    def validate(self, val_pipe, num_batches: Optional[int] = None) -> Dict[str, float]:
        n = num_batches or int(self.cfg.optimization.limit_val_batches or 4)
        agg: Dict[str, list] = {}
        for i in range(n):  # fixed val batches: the same patches every time
            logs = self._val_step(self.state, self._to_device(val_pipe.make_batch(10_000_000 + i)))
            for k, v in logs.items():
                agg.setdefault(k, []).append(v)
        out = {k: float(np.mean(v)) for k, v in agg.items()}
        self.metrics_logger.log(self.state.step, out)
        logger.info("validation: %s", {k: round(v, 4) for k, v in out.items()})
        return out

    # -- host-side control -------------------------------------------------

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profiler(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = self.run_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_step{self.state.step}.json"))
        logger.info("profiler trace written to %s", out)

    def _plateau_update(self, metric: float) -> None:
        """ReduceLROnPlateau on the host: ``lr_scale *= factor`` after more
        than ``patience`` checks without a new best (JAX ``loop.py:392-405``)."""
        if not self._plateau:
            return
        s = self.cfg.optimization.scheduler
        if metric < self._plateau_best - 1e-8:
            self._plateau_best, self._plateau_bad = metric, 0
            return
        self._plateau_bad += 1
        if self._plateau_bad > s.patience:
            self.state.lr_scale *= s.factor
            self._plateau_bad = 0
            logger.info("plateau: lr_scale -> %.2e", self.state.lr_scale)

    def _early_stop_update(self, val_logs: Dict[str, float]) -> bool:
        """True when training should stop (JAX ``loop.py:407-420``)."""
        es = self.cfg.monitor.early_stopping
        if not es.enabled:
            return False
        metric = val_logs.get(es.monitor)
        if metric is None:
            return False
        if es.check_finite and not math.isfinite(metric):
            return True
        better = metric < self._es_best - es.min_delta if es.mode == "min" else metric > self._es_best + es.min_delta
        if better:
            self._es_best, self._es_bad = metric, 0
            return False
        self._es_bad += 1
        return self._es_bad >= es.patience

    def _check_finite(self, logs: Dict[str, float], step: int) -> None:
        if not self.cfg.monitor.nan_detection:
            return
        bad = {k: v for k, v in logs.items() if not math.isfinite(v)}
        if bad:
            dump = self.run_dir / f"nan_diagnostics_step{step}.txt"
            lines = [f"step {step}: non-finite {bad}"]
            for name, p in self.model.named_parameters():
                if not torch.isfinite(p).all():
                    lines.append(f"param {name}: non-finite")
            dump.write_text("\n".join(lines))
            raise NaNError(f"non-finite loss at step {step}: {bad} (diagnostics: {dump})")

    @property
    def inference_params(self) -> Dict[str, torch.Tensor]:
        """EMA weights when enabled for validation, else the model's."""
        if self.state.ema is not None and self.cfg.monitor.ema.use_for_val:
            return self.state.ema
        return dict(self.model.state_dict())
