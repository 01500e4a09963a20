"""The tutorial audit: how far each shipped recipe gets in the port before a
raise site that reads only its config.

For every ``tutorials/*.yaml`` and each leg, on the CPU, with no data:

- **train**: load the config (``mode="train"``; it checks the free-form
  kwarg blocks), the CLI's preflight check, build the model, then the
  trainer's ``_check_ported``, the target builder, the loss orchestrator
  (with the label transform's affinity groups), the optimizer and schedule,
  the on-device augmentation and ``data.preprocessing.normalize``;
- **test**: load the config (``mode="test"``; a decode-only recipe, one
  whose YAML names ``load_prediction_path``, with a stand-in prediction
  path), the preflight check, build the model, then the test pipeline's ``_check_ported``, the
  inference manager, the evaluation metrics (``check_metrics``, the
  ``tube`` metric among them), the decoding config (``check_decoding``:
  each step's decoder, each graph node's decoder or graph op, the streamed
  decode's rules), and ``data.preprocessing.normalize``.

It builds no dataset and runs nothing on a card, so a recipe can still
raise later (an axis-range split, a missing volume). One JSON line a
tutorial (``{"tutorial", "train", "test"}``: ``"ok"`` or the first error,
``Type: message``), then a summary line::

    python -m pytorch_connectomics_tpu_torch.tools.tutorial_audit [--tutorials DIR] [--only NAME ...]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
# the prediction a decode-only recipe's test leg is audited with (never read)
STAND_IN = "stand_in_prediction.h5"


def _normalize(cfg) -> None:
    from ..data.preprocess import normalize_volume

    pre = cfg.data.preprocessing
    normalize_volume(np.zeros((2, 2, 2), np.uint8), pre.normalize, pre.clip_percentiles)


def train_leg(path: Path) -> None:
    from ..config import load_config
    from ..data.targets.build import affinity_target_groups, build_target_fn
    from ..losses import LossOrchestrator
    from ..models import build_model
    from ..training.loop import _check_ported, device_augment_fn
    from ..training.optim import build_optimizer
    from ..runtime.preflight import preflight_check

    cfg = load_config(path, mode="train")
    preflight_check(cfg, "train")
    model = build_model(cfg.model, device="cpu")
    _check_ported(cfg)
    build_target_fn(cfg.data.label_transform)
    LossOrchestrator(cfg.model.loss, affinity_groups=affinity_target_groups(cfg.data.label_transform))
    build_optimizer(cfg.optimization, model, cfg.optimization.n_steps_per_epoch or 100)
    device_augment_fn(cfg)
    _normalize(cfg)


def test_leg(path: Path) -> None:
    from ..config import load_config
    from ..decoding.stage import check_decoding
    from ..evaluation.stage import check_metrics
    from ..inference import InferenceManager
    from ..models import build_model
    from ..runtime.preflight import preflight_check
    from ..runtime.test_pipeline import _check_ported

    decode_only = "load_prediction_path" in path.read_text()
    cfg = load_config(path, mode="test",
                      overrides=[f"decoding.load_prediction_path={STAND_IN}"] if decode_only else ())
    preflight_check(cfg, "test")
    model = build_model(cfg.model, device="cpu")
    _check_ported(cfg)
    InferenceManager(cfg, model, "cpu")
    if cfg.evaluation.enabled:
        check_metrics(cfg.evaluation.metrics)
    if cfg.decoding.enabled:
        check_decoding(cfg.decoding)
    _normalize(cfg)


def audit(paths: List[Path]) -> List[Dict[str, str]]:
    """One record a tutorial: each leg ``"ok"`` or its first error."""
    legs: Dict[str, Callable[[Path], None]] = {"train": train_leg, "test": test_leg}
    records = []
    for path in paths:
        rec = {"tutorial": path.stem}
        for name, leg in legs.items():
            try:
                leg(path)
                rec[name] = "ok"
            except Exception as e:  # noqa: BLE001 - the audit records whatever stops a leg
                rec[name] = f"{type(e).__name__}: {e}"
        records.append(rec)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tutorials", default=str(ROOT / "tutorials"), help="directory of recipe YAMLs")
    ap.add_argument("--only", nargs="*", default=None, help="tutorial names (file stems) to audit")
    args = ap.parse_args(argv)
    logging.disable(logging.WARNING)
    paths = sorted(Path(args.tutorials).glob("*.yaml"))
    if args.only:
        paths = [p for p in paths if p.stem in set(args.only)]
    records = audit(paths)
    for rec in records:
        print(json.dumps(rec))
    both = [r["tutorial"] for r in records if r["train"] == r["test"] == "ok"]
    print(json.dumps({"tutorials": len(records), "both_legs_pass": len(both), "pass": both}))


if __name__ == "__main__":
    main()
