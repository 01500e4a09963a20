"""CLI argument parsing + config setup: the flag surface of
``pytorch_connectomics_tpu/runtime/cli.py`` plus ``--device``, for
``--mode train``, ``val``, ``test``, ``tune`` and ``tune-test``.

    python -m pytorch_connectomics_tpu_torch.runtime.cli \\
        --config tutorials/mito_synthetic_cli_fast_tpu.yaml --mode train [--device cpu] [key=value ...]
    python -m pytorch_connectomics_tpu_torch.runtime.cli \\
        --config tutorials/synthetic_instance_tune_tpu.yaml --mode tune-test --best-params <yaml>
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from ..config.loader import load_config
from ..config.schema import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="connectomics-torch",
        description="PyTorch/CUDA port of connectomics-tpu: training and inference of EM segmentation",
    )
    p.add_argument("--config", "-c", default=None, help="YAML config path")
    p.add_argument("--mode", default="train", choices=["train", "val", "test", "tune", "tune-test"])
    p.add_argument(
        "--checkpoint", default=None,
        help="a checkpoint directory of the port (<run>/checkpoints/last), a .pt/.pth state_dict, "
        "or a flax params .npz",
    )
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' runs on the CPU)")
    p.add_argument("--fast-dev-run", action="store_true", help="1 epoch x 2 steps smoke run")
    p.add_argument("--shard-id", type=int, default=None)
    p.add_argument("--num-shards", type=int, default=None)
    p.add_argument("--reset-optimizer", action="store_true")
    p.add_argument("--reset-epoch", action="store_true")
    p.add_argument("--reset-scheduler", action="store_true")
    p.add_argument("--reset-early-stopping", action="store_true")
    p.add_argument("--output-dir", default=None, help="override run output dir")
    p.add_argument("--best-params", default=None, help="tuned params YAML for tune-test")
    p.add_argument("--params", default=None, help="alias of --best-params")
    p.add_argument("--external-prefix", default=None, help="prefix to strip from external checkpoint keys")
    p.add_argument("--tune-trials", type=int, default=None)
    p.add_argument("--tune-trial-timeout", type=float, default=None)
    p.add_argument("overrides", nargs="*", default=[], help="dotted key=value config overrides")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.config:
        parser.error("--config is required")
    return args


def setup_config(args: argparse.Namespace) -> Config:
    """Config from ``--config`` and the ``key=value`` overrides;
    ``--fast-dev-run`` makes it one epoch of two steps and one validation
    batch; ``--params`` fills ``--best-params``, and
    ``--tune-trials``/``--tune-trial-timeout`` set the tuning's trial count
    and per-trial timeout."""
    cfg = load_config(args.config, overrides=args.overrides, mode=args.mode)
    if args.shard_id is not None:
        cfg.system.shard_id = args.shard_id
        cfg.system.num_shards = args.num_shards or 1
    if args.fast_dev_run:
        cfg.optimization.max_epochs = 1
        cfg.optimization.n_steps_per_epoch = 2
        cfg.optimization.limit_val_batches = 1
    if args.params and not args.best_params:
        args.best_params = args.params
    if args.tune_trials:
        cfg.decoding.tuning.n_trials = args.tune_trials
    if args.tune_trial_timeout:
        cfg.decoding.tuning.timeout_per_trial = args.tune_trial_timeout
    return cfg


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    from .dispatch import dispatch_runtime

    return dispatch_runtime(parse_args(argv))


if __name__ == "__main__":
    main()
