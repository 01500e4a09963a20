"""CLI argument parsing + config setup: the flag surface of
``pytorch_connectomics_tpu/runtime/cli.py`` plus ``--device``. This slice
implements ``--mode test``; the other modes are parsed and refused.

    python -m pytorch_connectomics_tpu_torch.runtime.cli \\
        --config tutorials/mito_lucchi_tpu_fast.yaml --mode test [--device cpu] [key=value ...]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from ..config.loader import load_config
from ..config.schema import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="connectomics-torch",
        description="PyTorch/CUDA port of connectomics-tpu: test-mode inference of EM segmentation",
    )
    p.add_argument("--config", "-c", default=None, help="YAML config path")
    p.add_argument("--mode", default="train", choices=["train", "val", "test", "tune", "tune-test"])
    p.add_argument(
        "--checkpoint", default=None,
        help="weights: a .pt/.pth state_dict of the port, or a flax params .npz",
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
    """Config from ``--config`` and the ``key=value`` overrides."""
    cfg = load_config(args.config, overrides=args.overrides, mode=args.mode)
    if args.shard_id is not None:
        cfg.system.shard_id = args.shard_id
        cfg.system.num_shards = args.num_shards or 1
    return cfg


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    from .dispatch import dispatch_runtime

    return dispatch_runtime(parse_args(argv))


if __name__ == "__main__":
    main()
