"""The tutorial audit: how far each shipped recipe gets in the port before a
raise site that reads only its config.

For every ``tutorials/*.yaml`` and each leg, on the CPU, with no data:

- **train**: load the config (``mode="train"``), build the model, then the
  trainer's ``_check_ported``, the target builder, the loss orchestrator
  (with the label transform's affinity groups), the on-device augmentation
  check and ``data.preprocessing.normalize``;
- **test**: load the config (``mode="test"``), build the model, then the
  test pipeline's ``_check_ported``, the inference manager, the evaluation
  metrics, the decode stage's ``_check_ported`` and each decode step's
  decoder, and ``data.preprocessing.normalize``.

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


def _normalize(cfg) -> None:
    from ..data.preprocess import normalize_volume

    pre = cfg.data.preprocessing
    normalize_volume(np.zeros((2, 2, 2), np.uint8), pre.normalize, pre.clip_percentiles)


def train_leg(path: Path) -> None:
    from ..config import load_config
    from ..data.augment import build_augmentation_fn
    from ..data.targets.build import affinity_target_groups, build_target_fn
    from ..losses import LossOrchestrator
    from ..models import build_model
    from ..training.loop import _check_ported

    cfg = load_config(path, mode="train")
    build_model(cfg.model, device="cpu")
    _check_ported(cfg)
    build_target_fn(cfg.data.label_transform)
    LossOrchestrator(cfg.model.loss, affinity_groups=affinity_target_groups(cfg.data.label_transform))
    aug = cfg.data.augmentation
    if aug.on_device and build_augmentation_fn(aug) is not None:
        raise NotImplementedError("on-device augmentation is not ported yet")
    _normalize(cfg)


def test_leg(path: Path) -> None:
    from ..config import load_config
    from ..decoding.registry import get_decoder
    from ..decoding.stage import _check_ported as check_decoding
    from ..evaluation.stage import _BINARY_METRICS, _INSTANCE_METRICS
    from ..inference import InferenceManager
    from ..models import build_model
    from ..runtime.test_pipeline import _check_ported

    cfg = load_config(path, mode="test")
    model = build_model(cfg.model, device="cpu")
    _check_ported(cfg)
    InferenceManager(cfg, model, "cpu")
    if cfg.evaluation.enabled:
        unknown = [m for m in cfg.evaluation.metrics if m.lower() not in _BINARY_METRICS | _INSTANCE_METRICS]
        if unknown:
            raise NotImplementedError(f"evaluation metrics {unknown} are not ported yet")
    if cfg.decoding.enabled:
        check_decoding(cfg.decoding)
        for step in cfg.decoding.steps or []:
            get_decoder(step.name if hasattr(step, "name") else step["name"])
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
