"""Evaluation stage (the port of
``pytorch_connectomics_tpu/evaluation/stage.py``): binary metrics (jaccard,
dice, accuracy) of the thresholded probability map and instance metrics
(adapted_rand, voi, instance_f1, panoptic_quality, ap) of the decoded
labels against the ground truth, NERL and ERL over the ground truth's
skeletons (``cfg.nerl``'s anisotropy), the ground-truth-free tube QC of the
decoded labels (``tube``: ``tube_*`` counts and the per-instance npz), and
the per-volume metrics report (:mod:`.report`). A metric the port does not
know raises ``NotImplementedError``."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..config.schema import EvaluationConfig
from ..metrics import (
    adapted_rand,
    average_precision,
    binary_accuracy,
    compute_nerl,
    dice_coefficient,
    instance_matching,
    jaccard_index,
    voi,
)
from ..metrics.tube import tube_instance_qc, tube_qc_summary
from .report import save_tube_instances, write_metrics_report

logger = logging.getLogger(__name__)

_BINARY_METRICS = {"jaccard", "dice", "accuracy"}
_INSTANCE_METRICS = {"adapted_rand", "voi", "instance_f1", "ap", "panoptic_quality", "nerl"}
# computed by run_evaluation_stage from the decoded labels alone
_STAGE_METRICS = {"tube"}


def check_metrics(metrics: Sequence[str]) -> None:
    """Raises ``NotImplementedError`` naming the metrics the port does not know."""
    unknown = [m for m in metrics if m.lower() not in _BINARY_METRICS | _INSTANCE_METRICS | _STAGE_METRICS]
    if unknown:
        raise NotImplementedError(f"evaluation metrics {unknown} are not ported yet")


def compute_test_metrics(
    prediction: Optional[np.ndarray],
    decoded: Optional[np.ndarray],
    gt: np.ndarray,
    metrics: Sequence[str],
    nerl_cfg: Optional[Dict[str, Any]] = None,
) -> Dict[str, float]:
    """``prediction``: probability map (Z,Y,X,C) or (C,Z,Y,X) for the binary
    metrics; ``decoded``: instance labels (Z,Y,X) for the instance metrics.
    A metric whose input is None is left out; an unknown one raises."""
    check_metrics(metrics)
    out: Dict[str, float] = {}
    gt = np.asarray(gt)
    if gt.ndim == 4:
        gt = gt[0] if gt.shape[0] < gt.shape[-1] else gt[..., 0]
    for metric in metrics:
        m = metric.lower()
        if m in _BINARY_METRICS:
            if prediction is None:
                continue
            p = np.asarray(prediction)
            if p.ndim == 4:
                p = p[..., 0] if p.shape[-1] < p.shape[0] else p[0]
            fn = {"jaccard": jaccard_index, "dice": dice_coefficient, "accuracy": binary_accuracy}[m]
            out[m] = float(fn(p > 0.5, gt > 0, from_logits=False))
        elif m in _INSTANCE_METRICS:
            if decoded is None:
                continue
            seg = np.asarray(decoded)
            if m == "adapted_rand":
                out["adapted_rand"] = float(adapted_rand(seg, gt))
            elif m == "voi":
                vs, vm = voi(seg, gt)
                out["voi_split"], out["voi_merge"], out["voi"] = vs, vm, vs + vm
            elif m == "instance_f1":
                stats = instance_matching(seg, gt)
                out["instance_f1"] = stats["f1"]
                out["instance_precision"] = stats["precision"]
                out["instance_recall"] = stats["recall"]
            elif m == "panoptic_quality":
                out["panoptic_quality"] = instance_matching(seg, gt)["panoptic_quality"]
            elif m == "ap":
                out["ap"] = float(average_precision(seg, gt))
            else:
                res = compute_nerl(seg, gt, anisotropy=(nerl_cfg or {}).get("anisotropy", (1, 1, 1)))
                out["nerl"], out["erl"] = res["nerl"], res["erl"]
    return out


def run_evaluation_stage(
    prediction: Optional[np.ndarray],
    decoded: Optional[np.ndarray],
    gt: np.ndarray,
    cfg: EvaluationConfig,
    output_dir: Optional[str | Path] = None,
    volume_name: str = "volume",
) -> Dict[str, float]:
    if not cfg.enabled or not cfg.metrics:
        return {}
    results = compute_test_metrics(prediction, decoded, gt, cfg.metrics, cfg.nerl)
    if "tube" in [m.lower() for m in cfg.metrics] and decoded is not None:
        kw = dict(cfg.tube or {})
        results.update({f"tube_{k}": v for k, v in tube_qc_summary(decoded, **kw).items()})
        if output_dir:
            save_tube_instances(output_dir, volume_name, tube_instance_qc(decoded, **kw),
                                volume_shape=np.asarray(decoded).shape, config=kw)
    logger.info("evaluation[%s]: %s", volume_name, {k: round(v, 4) for k, v in results.items()})
    if output_dir:
        write_metrics_report(output_dir, volume_name, results)
    return results
