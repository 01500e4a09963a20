"""Evaluation stage for binary predictions (the port of the binary-metric
part of ``pytorch_connectomics_tpu/evaluation/stage.py``): jaccard, dice and
accuracy of the thresholded probability map against the ground truth, and
the per-volume metrics report. Instance metrics need decoding, which is not
ported yet; they are skipped with a warning."""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..config.schema import EvaluationConfig
from ..metrics import binary_accuracy, dice_coefficient, jaccard_index

logger = logging.getLogger(__name__)

_BINARY_METRICS = {"jaccard", "dice", "accuracy"}


def compute_test_metrics(
    prediction: Optional[np.ndarray], gt: np.ndarray, metrics: Sequence[str]
) -> Dict[str, float]:
    """``prediction``: probability map (Z,Y,X,C) or (C,Z,Y,X)."""
    out: Dict[str, float] = {}
    gt = np.asarray(gt)
    if gt.ndim == 4:
        gt = gt[0] if gt.shape[0] < gt.shape[-1] else gt[..., 0]
    for metric in metrics:
        m = metric.lower()
        if m not in _BINARY_METRICS:
            logger.warning("metric '%s' is not ported yet; skipped", metric)
            continue
        if prediction is None:
            continue
        p = np.asarray(prediction)
        if p.ndim == 4:
            p = p[..., 0] if p.shape[-1] < p.shape[0] else p[0]
        fn = {"jaccard": jaccard_index, "dice": dice_coefficient, "accuracy": binary_accuracy}[m]
        out[m] = float(fn(p > 0.5, gt > 0, from_logits=False))
    return out


def write_metrics_report(output_dir: str | Path, volume_name: str, metrics: Dict[str, float]) -> Path:
    """``<volume>_metrics.txt`` plus the run's ``metrics.json``."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    lines = [f"# metrics for {volume_name}"] + [f"{k}: {v:.6f}" for k, v in sorted(metrics.items())]
    (out / f"{volume_name}_metrics.txt").write_text("\n".join(lines) + "\n")
    json_path = out / "metrics.json"
    existing = json.loads(json_path.read_text()) if json_path.exists() else {}
    existing[volume_name] = metrics
    json_path.write_text(json.dumps(existing, indent=2))
    return out / f"{volume_name}_metrics.txt"


def run_evaluation_stage(
    prediction: Optional[np.ndarray],
    gt: np.ndarray,
    cfg: EvaluationConfig,
    output_dir: Optional[str | Path] = None,
    volume_name: str = "volume",
) -> Dict[str, float]:
    if not cfg.enabled or not cfg.metrics:
        return {}
    results = compute_test_metrics(prediction, gt, cfg.metrics)
    logger.info("evaluation[%s]: %s", volume_name, {k: round(v, 4) for k, v in results.items()})
    if output_dir:
        write_metrics_report(output_dir, volume_name, results)
    return results
