"""Mode dispatch for the port (the ``train``, ``val``, ``test``, ``tune`` and
``tune-test`` paths of ``pytorch_connectomics_tpu/runtime/dispatch.py``).

Run dirs: ``--output-dir`` when given; for ``train``/``val`` a timestamped
``<save_path>/<YYYYmmdd_HHMMSS>/`` holding ``config.yaml``,
``metrics.jsonl`` and ``checkpoints/``; for the inference modes the
checkpoint's run dir ``<run>/<mode>`` (``<ckpt>/../..``), else
``<save_path>/<mode>``. An inference run without ``--checkpoint`` restores
the newest train checkpoint under ``save_path`` (``last`` preferred).
``tune`` predicts the tune volumes and writes the best-params YAML;
``tune-test`` applies ``--best-params`` (tuning first when none is given)
and runs the test pipeline.
"""

from __future__ import annotations

import datetime
import logging
import pickle
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..config.loader import config_hash
from ..config.schema import Config, to_dict
from ..models import build_model
from ..models.convert import load_flax_params
from ..training.checkpoint import CheckpointManager, check_config_hash, is_checkpoint_dir
from ..training.model_weights import (
    DEFAULT_PREFIXES, TORCH_SUFFIXES, is_foreign, load_external_weights, read_torch_checkpoint, state_dict_arrays,
)
from ..utils.device import resolve_device
from .cli import parse_args, setup_config
from .preflight import preflight_check
from .test_pipeline import run_test_pipeline
from .tune_runner import apply_best_params, run_tuning

logger = logging.getLogger(__name__)


def setup_logging(level=logging.INFO) -> None:
    """INFO logs to stdout, unless the process has configured logging."""
    logging.basicConfig(
        level=level, stream=sys.stdout, format="[%(asctime)s] %(levelname)s %(message)s", datefmt="%H:%M:%S"
    )


def _save_root(cfg: Config) -> Path:
    return Path(cfg.save_path or f"outputs/{cfg.experiment_name}")


def setup_runtime_directories(cfg: Config, mode: str, args=None) -> Path:
    """``--output-dir``; else a timestamped ``<save_path>/<ts>`` for train
    and val; else ``<ckpt_dir>/../<mode>``; else ``<save_path>/<mode>``."""
    if args is not None and getattr(args, "output_dir", None):
        return Path(args.output_dir)
    if mode in ("train", "val"):
        return _save_root(cfg) / datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    ckpt = getattr(args, "checkpoint", None) if args else None
    if ckpt:
        return Path(ckpt).resolve().parent.parent / mode
    return _save_root(cfg) / mode


def resolve_latest_checkpoint(cfg: Config) -> Optional[str]:
    """Newest train checkpoint under ``save_path``: each run's ``last``
    where it has one, else its top-k entries; None when there is none."""
    base = _save_root(cfg)
    if not base.exists():
        return None
    candidates = []
    for ckdir in base.glob("*/checkpoints"):
        last = ckdir / "last"
        if is_checkpoint_dir(last):
            candidates.append(last)
            continue
        candidates += [d for d in ckdir.iterdir() if is_checkpoint_dir(d)]
    if not candidates:
        return None
    return str(max(candidates, key=lambda p: (p / "state.pt").stat().st_mtime))


def load_weights(model: torch.nn.Module, checkpoint: str, cfg: Config,
                 external_prefix: Optional[str] = None) -> Dict[str, Any]:
    """A ``.npz`` of flax params goes through the weight bridge; a port
    checkpoint directory (``state.pt`` + ``metadata.json``) loads its model
    weights, or its EMA weights when ``monitor.ema`` is enabled for
    validation, and has its config hash checked against ``cfg``; anything
    else is read as a torch state_dict (optionally under a
    ``state_dict``/``model`` key): one whose keys are exactly the port's
    loads by name, a foreign one (``.pt/.pth/.ckpt/.pytorch``: BANIS,
    nnU-Net, a reference run) through the shape-bucket matcher
    (``training/model_weights.load_external_weights``), its keys stripped
    of ``external_prefix`` or of ``model.``/``module.``/``network.``. The
    by-name load reads tensors and containers only; a foreign file that
    pickles more is unpickled in full, with a warning
    (``read_torch_checkpoint``). Returns what was restored."""
    if str(checkpoint).endswith(".npz"):
        load_flax_params(model, checkpoint)
        return {"checkpoint": str(checkpoint), "kind": "flax"}
    if is_checkpoint_dir(checkpoint):
        use_ema = cfg.monitor.ema.enabled and cfg.monitor.ema.use_for_val
        step = CheckpointManager.restore_params_only(checkpoint, model, use_ema=use_ema)
        meta = CheckpointManager.read_metadata(checkpoint)
        matches = check_config_hash(meta, config_hash(cfg))
        logger.info("restored %s (step %d)", checkpoint, step)
        return {"checkpoint": str(checkpoint), "kind": "port", "step": step,
                "config_hash": meta.get("config_hash"), "config_hash_matches": matches}
    foreign = is_foreign(checkpoint)
    try:
        ckpt = read_torch_checkpoint(checkpoint)
    except pickle.UnpicklingError:
        if not foreign:
            raise
        ckpt = None  # pickles more than tensors: no state dict of the port
    sd = ckpt
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    if isinstance(sd, dict) and set(sd) == set(model.state_dict()):
        model.load_state_dict(sd)
        return {"checkpoint": str(checkpoint), "kind": "state_dict"}
    if not foreign:
        raise ValueError(f"{checkpoint}: keys are not the port's, and it is no torch checkpoint ({TORCH_SUFFIXES})")
    prefixes = (external_prefix,) if external_prefix else DEFAULT_PREFIXES
    if ckpt is None:
        ckpt = read_torch_checkpoint(checkpoint, full=True)
    stats = load_external_weights(model, state_dict_arrays(ckpt, prefixes))
    logger.info("external checkpoint %s: %s", checkpoint, stats)
    return {"checkpoint": str(checkpoint), "kind": "external", "stats": stats}


def _write_config(cfg: Config, run_dir: Path) -> None:
    """Resolved-config provenance in the run dir."""
    import yaml

    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.yaml").write_text(yaml.safe_dump(to_dict(cfg), sort_keys=False, default_flow_style=None))


def dispatch_runtime(args=None) -> Dict[str, Any]:
    """Run ``args.mode``. Returns {mode, run_dir, metrics, ...}: for train
    also the newest checkpoint, for test what was restored."""
    if args is None:
        args = parse_args()
    setup_logging()
    cfg = setup_config(args)
    preflight_check(cfg, args.mode)
    device = resolve_device(args.device)
    if args.mode in ("test", "tune", "tune-test") and not args.checkpoint:
        args.checkpoint = resolve_latest_checkpoint(cfg)
        if args.checkpoint:
            logger.info("auto-resolved checkpoint: %s", args.checkpoint)
        else:
            logger.warning(
                "--mode %s without --checkpoint and no trained checkpoint under %s: inference runs "
                "with RANDOMLY-INITIALIZED weights (seed %d)", args.mode, _save_root(cfg), cfg.system.seed,
            )
    run_dir = setup_runtime_directories(cfg, args.mode, args)
    logger.info("mode=%s run_dir=%s device=%s", args.mode, run_dir, device)
    _write_config(cfg, run_dir)
    results: Dict[str, Any] = {"mode": args.mode, "run_dir": str(run_dir)}
    if args.mode in ("train", "val"):
        from ..training.loop import Trainer

        trainer = Trainer(cfg, run_dir=run_dir, device=device)
        try:
            if cfg.model.mednext.upkern_from:
                results["upkern"] = trainer.upkern()
            if args.checkpoint:
                trainer.restore(args.checkpoint, reset_optimizer=args.reset_optimizer, reset_epoch=args.reset_epoch)
            if args.mode == "train":
                results["metrics"] = trainer.fit()
                last = trainer.ckpt.last_path() or trainer.ckpt.best_path()
                results["checkpoint"] = str(last) if last else None
                results["train_stats"] = trainer.fit_stats
                results["config_hash"] = trainer.cfg_hash
            else:
                from ..data.pipeline import build_pipelines

                _, val_pipe = build_pipelines(cfg, device)
                results["metrics"] = trainer.validate(val_pipe) if val_pipe else {}
        finally:
            trainer.metrics_logger.close()
        return results
    t0 = time.perf_counter()
    model = build_model(cfg.model, device=device, seed=cfg.system.seed)
    if args.checkpoint:
        results["restored"] = load_weights(model, args.checkpoint, cfg, args.external_prefix)
    logger.info("model ready in %.3fs", time.perf_counter() - t0)
    if args.mode == "test":
        results["metrics"] = run_test_pipeline(cfg, model, run_dir, args.checkpoint, device)
    elif args.mode == "tune":
        results["best_params"] = str(run_tuning(cfg, model, run_dir, args.checkpoint, device))
    else:
        study = args.best_params or str(run_tuning(cfg, model, run_dir, args.checkpoint, device))
        results["metrics"] = run_test_pipeline(apply_best_params(cfg, study), model, run_dir, args.checkpoint, device)
        results["best_params"] = study
    return results
