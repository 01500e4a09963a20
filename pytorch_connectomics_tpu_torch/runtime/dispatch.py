"""Mode dispatch for the port: build the model, load weights, run the test
pipeline (the ``--mode test`` path of
``pytorch_connectomics_tpu/runtime/dispatch.py``)."""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict

import torch

from ..config.schema import Config, to_dict
from ..models import build_model
from ..models.convert import load_flax_params
from ..utils.device import resolve_device
from .cli import parse_args, setup_config
from .test_pipeline import run_test_pipeline

logger = logging.getLogger(__name__)


def setup_logging(level=logging.INFO) -> None:
    """INFO logs to stdout, unless the process has configured logging."""
    logging.basicConfig(
        level=level, stream=sys.stdout, format="[%(asctime)s] %(levelname)s %(message)s", datefmt="%H:%M:%S"
    )


def setup_runtime_directories(cfg: Config, mode: str, args=None) -> Path:
    """``--output-dir``, else ``<ckpt_dir>/../<mode>``, else ``<save_path>/<mode>``."""
    if args is not None and getattr(args, "output_dir", None):
        return Path(args.output_dir)
    ckpt = getattr(args, "checkpoint", None) if args else None
    if ckpt:
        return Path(ckpt).resolve().parent.parent / mode
    return Path(cfg.save_path or f"outputs/{cfg.experiment_name}") / mode


def load_weights(model: torch.nn.Module, checkpoint: str) -> None:
    """A ``.npz`` of flax params goes through the weight bridge; anything
    else is read as a state_dict of the port (optionally under a
    ``state_dict``/``model`` key)."""
    if str(checkpoint).endswith(".npz"):
        load_flax_params(model, checkpoint)
        return
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    model.load_state_dict(sd)


def _write_config(cfg: Config, run_dir: Path) -> None:
    """Resolved-config provenance in the run dir."""
    import yaml

    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.yaml").write_text(yaml.safe_dump(to_dict(cfg), sort_keys=False, default_flow_style=None))


def dispatch_runtime(args=None) -> Dict[str, Any]:
    """Run ``args.mode``. Returns {mode, run_dir, metrics}."""
    if args is None:
        args = parse_args()
    if args.mode != "test":
        raise NotImplementedError(f"--mode {args.mode} is not ported yet (only --mode test)")
    setup_logging()
    device = resolve_device(args.device)
    cfg = setup_config(args)
    if not args.checkpoint:
        logger.warning(
            "--mode test without --checkpoint: inference runs with RANDOMLY-INITIALIZED "
            "weights (seed %d)", cfg.system.seed,
        )
    run_dir = setup_runtime_directories(cfg, args.mode, args)
    logger.info("mode=%s run_dir=%s device=%s", args.mode, run_dir, device)
    _write_config(cfg, run_dir)
    t0 = time.perf_counter()
    model = build_model(cfg.model, device=device, seed=cfg.system.seed)
    if args.checkpoint:
        load_weights(model, args.checkpoint)
    logger.info("model ready in %.3fs", time.perf_counter() - t0)
    metrics = run_test_pipeline(cfg, model, run_dir, args.checkpoint, device)
    return {"mode": args.mode, "run_dir": str(run_dir), "metrics": metrics}
