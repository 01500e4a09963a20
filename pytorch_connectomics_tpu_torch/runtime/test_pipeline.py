"""Test pipeline: read -> normalise -> infer (+TTA) -> save -> decode ->
evaluate per test volume. The port of the non-chunked branch of
``pytorch_connectomics_tpu/runtime/test_pipeline.py`` with its
non-streamed decode (``:233-260``); chunked inference, prediction-cache
reuse, decode-only runs, nnU-Net preprocessing, read-time scaling and test
sharding are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config.loader import config_hash
from ..config.schema import Config
from ..data.io import read_volume
from ..data.preprocess import normalize_volume
from ..decoding import run_decoding_stage
from ..evaluation.stage import run_evaluation_stage
from ..inference import InferenceManager, apply_prediction_transform, save_prediction
from .output_naming import decoded_filename, prediction_filename, prediction_tag, volume_name_from_path

logger = logging.getLogger(__name__)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _check_ported(cfg: Config) -> None:
    for flag, what in (
        (cfg.inference.chunked.enabled, "chunked inference"),
        (cfg.decoding.enabled and cfg.decoding.load_prediction_path, "decode-only runs (load_prediction_path)"),
        (cfg.data.nnunet_preprocessing.enabled, "nnU-Net preprocessing"),
        (cfg.data.test.read_scale, "read-time scaling"),
        (cfg.data.data_transform.align_to_image, "align_to_image"),
        (cfg.inference.output.crop_pad, "prediction crops"),
        (cfg.inference.output.save_all_heads, "per-head artifacts"),
        ((cfg.system.num_shards or 1) > 1, "test sharding"),
    ):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")


def run_test_pipeline(
    cfg: Config,
    model: torch.nn.Module,
    output_dir: str | Path,
    checkpoint: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Infer (and evaluate, where labels are given) every test volume with
    ``model`` on ``device``. Returns {volume_name: metrics}."""
    _check_ported(cfg)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    images = _as_list(cfg.data.test.image)
    labels = _as_list(cfg.data.test.label)
    manager = InferenceManager(cfg, model, device)
    cfg_hash = config_hash(cfg)
    tag = prediction_tag(
        checkpoint,
        tta_passes=manager.predictor.num_variants,
        head=cfg.inference.model.output_head,
        channels=cfg.inference.model.select_channel,
    )
    all_metrics: Dict[str, Dict[str, float]] = {}
    for vi, image_path in enumerate(images):
        vol_name = volume_name_from_path(image_path)
        t0 = time.perf_counter()
        vol = read_volume(image_path, device=device)
        if cfg.data.test.transpose:
            vol = np.transpose(vol, cfg.data.test.transpose)
        vol = normalize_volume(vol, cfg.data.preprocessing.normalize)
        t_read = time.perf_counter()
        prediction = manager.predict(vol)  # (Z,Y,X,C)
        t_pred = time.perf_counter()
        if cfg.inference.output.save_raw:
            # channel-first and contiguous: np.save writes a strided view element by element
            stored = np.moveaxis(apply_prediction_transform(prediction, cfg.inference.output), -1, 0)
            stored = np.ascontiguousarray(stored)
            written = save_prediction(
                out_dir / prediction_filename(vol_name, tag), stored, cfg_hash, checkpoint or "", tag
            )
            logger.info("prediction[%s]: %s", vol_name, written)
        t_save = time.perf_counter()
        voxels = int(np.prod(prediction.shape[:3]))
        logger.info(
            "inference[%s]: %.1fs (%.2f Mvox/s)", vol_name, t_save - t0, voxels / max(t_save - t0, 1e-9) / 1e6
        )
        decoded = None
        if cfg.decoding.enabled and (cfg.decoding.steps or cfg.decoding.graph):
            decoded = run_decoding_stage(np.moveaxis(prediction, -1, 0), cfg.decoding).astype(np.uint32)
            logger.info("decode[%s]: %.1fs, %d instances", vol_name, time.perf_counter() - t_save,
                        int(np.count_nonzero(np.bincount(decoded.ravel())[1:])))
            dec_name = decoded_filename(vol_name, tag, decoding_cfg=cfg.decoding)
            written = save_prediction(out_dir / dec_name, decoded, cfg_hash, checkpoint or "", tag)
            logger.info("decoded[%s]: %s", vol_name, written)
        t_decode = time.perf_counter()
        if cfg.evaluation.enabled and vi < len(labels):
            gt = read_volume(labels[vi], device=device)
            if cfg.data.test.transpose:
                gt = np.transpose(gt, cfg.data.test.transpose)
            all_metrics[vol_name] = run_evaluation_stage(prediction, decoded, gt, cfg.evaluation, out_dir, vol_name)
        else:
            all_metrics[vol_name] = {}
        logger.info(
            "timing[%s]: read+normalise %.3fs, predict %.3fs, save %.3fs, decode %.3fs, evaluate %.3fs", vol_name,
            t_read - t0, t_pred - t_read, t_save - t_pred, t_decode - t_save, time.perf_counter() - t_decode,
        )
    return all_metrics
