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
copies. Profiler windows, ReduceLROnPlateau, early stopping, the
visualizer, anomaly detection and UpKern initialisation raise
``NotImplementedError`` when configured.
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
from ..losses.orchestrator import LossOrchestrator
from ..models import build_model
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger
from .checkpoint import CheckpointManager, check_config_hash
from .optim import build_optimizer
from .state import create_train_state, make_train_step, make_val_step

logger = logging.getLogger(__name__)


class NaNError(RuntimeError):
    pass


def _check_ported(cfg: Config) -> None:
    mon, opt = cfg.monitor, cfg.optimization
    for flag, what in (
        (mon.profile_steps, "profiler windows (monitor.profile_steps)"),
        (opt.scheduler.name == "ReduceLROnPlateau", "ReduceLROnPlateau"),
        (mon.early_stopping.enabled, "early stopping"),
        (int((mon.logging.images or {}).get("log_every_n_epochs", 0)), "the visualizer"),
        (mon.detect_anomaly, "anomaly detection"),
        (cfg.model.mednext.upkern_from, "UpKern initialisation"),
    ):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")


class Trainer:
    def __init__(self, cfg: Config, run_dir: str | Path = "outputs/run", device=None):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.model = build_model(cfg.model, device=self.device, seed=cfg.system.seed)
        self.orchestrator = LossOrchestrator(cfg.model.loss)
        n_samples = cfg.data.dataloader.num_samples
        from_samples = max(1, int(n_samples) // max(1, cfg.data.dataloader.batch_size)) if n_samples else None
        self.steps_per_epoch = cfg.optimization.n_steps_per_epoch or from_samples or 100
        optimizer, self.schedule = build_optimizer(cfg.optimization, self.model, self.steps_per_epoch)
        self.cfg_hash = config_hash(cfg)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("model %s: %.2fM params on %s", cfg.model.arch.type, n_params / 1e6, self.device)
        self.state = create_train_state(self.model, optimizer, ema=cfg.monitor.ema.enabled)
        self._train_step = make_train_step(
            self.orchestrator, self.schedule,
            gradient_clip=cfg.optimization.gradient_clip_val,
            ema_decay=cfg.monitor.ema.decay if cfg.monitor.ema.enabled else None,
            balancing=cfg.model.loss.balancing.method,
            distill=cfg.optimization.distill.teacher_checkpoint,
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
        try:
            for epoch in range(start_epoch, max_epochs):
                losses = []
                for _ in range(self.steps_per_epoch):
                    if max_steps and self.state.step >= int(max_steps):
                        break
                    t0 = time.perf_counter()
                    batch = self._to_device(next(it))
                    data_wait += time.perf_counter() - t0
                    logs = self._train_step(self.state, batch)
                    step = self.state.step
                    vci = cfg.optimization.val_check_interval
                    if vci and val_pipe is not None:
                        ivl = int(vci) if vci >= 1 else max(1, round(float(vci) * self.steps_per_epoch))
                        if step % ivl == 0:
                            self.validate(val_pipe)
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
                    epoch_metrics.update(self.validate(val_pipe))
                self.metrics_logger.log(self.state.step, epoch_metrics)
                self._save_epoch(epoch, epoch_metrics)
                if max_steps and self.state.step >= int(max_steps):
                    logger.info("max_steps %d reached", int(max_steps))
                    break
        finally:
            it.close()
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
