"""Tune mode, the port of ``run_tuning`` and ``apply_best_params`` in
``pytorch_connectomics_tpu/runtime/tune_runner.py:32-133``: predict every
tune volume (inference only; a valid stored prediction is reused), then
search the decode parameters against the ground truth; tune-test patches
the decoding config with the best parameters before the test pipeline
runs. A decode-only run (``decoding.load_prediction_path``) tunes on its
external prediction.
"""

from __future__ import annotations

import copy
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config.schema import Config, DecodingConfig, build_dataclass, to_dict
from ..data.io import read_volume
from ..decoding.tuning import (
    DecodingTuner,
    _set_dotted_with_list_indices,
    find_waterz_step,
    load_best_params,
    make_decode_objective,
    make_multi_volume_objective,
    make_waterz_batch_objective,
)
from ..inference import InferenceManager
from ..inference.output import stored_prediction_path
from .output_naming import prediction_filename, tuned_params_filename, volume_name_from_path
from .test_pipeline import (
    _as_list,
    external_prediction_path,
    load_external_prediction,
    prediction_tag_of,
    run_test_pipeline,
)

logger = logging.getLogger(__name__)


def run_tuning(
    cfg: Config,
    model: torch.nn.Module,
    output_dir: str | Path,
    checkpoint: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> Path:
    """Predict the tune volumes into ``output_dir``, tune the decoding on
    them and write the study; returns the best-params YAML's path."""
    out_dir = Path(output_dir)
    run_test_pipeline(cfg, model, out_dir, checkpoint, device, mode="tune")
    tag = prediction_tag_of(cfg, InferenceManager(cfg, model, device), checkpoint)
    images = _as_list(cfg.data.test.image)
    labels = _as_list(cfg.data.test.label)
    if not labels:
        raise ValueError("tune mode needs data.test.label ground truth")
    # every tune volume counts: the metric is averaged per trial, each
    # volume decoded on its own
    ext_pred = external_prediction_path(cfg)
    if ext_pred and not images:
        images = [ext_pred]
    pairs = []
    for image_path, label_path in zip(images, labels):
        if ext_pred:
            pred = load_external_prediction(ext_pred)
        else:
            name = prediction_filename(volume_name_from_path(image_path), tag)
            pred = read_volume(str(stored_prediction_path(out_dir / name)))
        gt = read_volume(label_path, device=device)
        if cfg.data.test.transpose:
            gt = np.transpose(gt, cfg.data.test.transpose)
        pairs.append((pred, gt))

    tuning = cfg.decoding.tuning
    decoding_dict = to_dict(cfg.decoding)
    decoding_dict.pop("tuning", None)
    if tuning.batch_thresholds and find_waterz_step(decoding_dict) is not None:
        # one watershed and region graph a trial and volume serve every
        # merge threshold
        objective = make_waterz_batch_objective(
            [p for p, _ in pairs], [g for _, g in pairs], decoding_dict, tuning.metric, tuning.batch_thresholds,
            minimize=tuning.direction != "maximize",
        )
        logger.info("waterz batch tuning: %d volumes x %d thresholds per trial", len(pairs),
                    len(tuning.batch_thresholds))
    elif len(pairs) > 1:
        objective = make_multi_volume_objective(pairs, decoding_dict, tuning.metrics or tuning.metric)
    else:
        objective = make_decode_objective(pairs[0][0], pairs[0][1], decoding_dict, tuning.metrics or tuning.metric)
    tuner = DecodingTuner(tuning, objective)
    best = tuner.optimize()
    logger.info(
        "tuning done: best %s = %s with %s%s", tuning.metrics or tuning.metric,
        best.values if tuner.multi else best.value, best.params,
        f" (attrs {best.user_attrs})" if best.user_attrs else "",
    )
    if "best_threshold" in best.user_attrs:
        # batch mode: the winning sweep threshold joins the best params, so
        # tune-test applies it like any other
        best.params[f"steps.{find_waterz_step(decoding_dict)}.kwargs.threshold"] = best.user_attrs["best_threshold"]
    return tuner.save_study(out_dir / tuned_params_filename(tag))


def apply_best_params(cfg: Config, study_path: str | Path) -> Config:
    """A copy of ``cfg`` whose decoding config carries the study's best
    parameters (dotted paths under ``decoding``)."""
    d = to_dict(cfg.decoding)
    d.pop("tuning", None)
    for k, v in load_best_params(study_path).items():
        _set_dotted_with_list_indices(d, k, v)
    cfg = copy.deepcopy(cfg)
    cfg.decoding = build_dataclass(DecodingConfig, d)
    return cfg
