"""Test pipeline: read -> normalise -> infer (+TTA) -> save -> decode ->
evaluate per test volume. The port of
``pytorch_connectomics_tpu/runtime/test_pipeline.py`` with its chunked
branch (``:126-149``: the volume predicted chunk by chunk through lazy
reads into one file, then read back), its read-scaled whole-volume reads
(``:150-158``), its per-head artifacts of a multi-head model
(``save_all_heads``, ``:197-210``: each head's channels of the merged
prediction beside it) and its non-streamed decode (``:233-260``); in
``tune`` mode it stops after the prediction is saved (``:220-221``). Prediction-cache
reuse, decode-only runs, nnU-Net preprocessing and test sharding are not
ported yet and raise ``NotImplementedError``.
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
from ..inference import (
    InferenceManager,
    LazyVolumeAccessor,
    apply_prediction_transform,
    run_chunked_inference,
    save_prediction,
)
from .output_naming import (
    decoded_filename,
    head_filenames,
    prediction_filename,
    prediction_tag,
    volume_name_from_path,
)

logger = logging.getLogger(__name__)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _check_ported(cfg: Config) -> None:
    for flag, what in (
        (cfg.decoding.enabled and cfg.decoding.load_prediction_path, "decode-only runs (load_prediction_path)"),
        (cfg.data.nnunet_preprocessing.enabled, "nnU-Net preprocessing"),
        (cfg.data.data_transform.align_to_image, "align_to_image"),
        (cfg.inference.output.crop_pad, "prediction crops"),
        ((cfg.system.num_shards or 1) > 1, "test sharding"),
        (cfg.inference.chunked.enabled and cfg.inference.chunked.output_mode == "precomputed",
         "the precomputed chunked output"),
    ):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")


def prediction_tag_of(cfg: Config, manager: InferenceManager, checkpoint: Optional[str]) -> str:
    """The tag that names a test run's prediction and decoded files."""
    return prediction_tag(
        checkpoint,
        tta_passes=manager.predictor.num_variants,
        head=cfg.inference.model.output_head,
        channels=cfg.inference.model.select_channel,
    )


def run_test_pipeline(
    cfg: Config,
    model: torch.nn.Module,
    output_dir: str | Path,
    checkpoint: Optional[str] = None,
    device: torch.device | str = "cuda",
    mode: str = "test",
) -> Dict[str, Dict[str, float]]:
    """Infer (and evaluate, where labels are given) every test volume with
    ``model`` on ``device``. Returns {volume_name: metrics}; in ``tune``
    mode it stops after saving each prediction ({volume_name: {"cached": 1.0}})."""
    _check_ported(cfg)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    images = _as_list(cfg.data.test.image)
    labels = _as_list(cfg.data.test.label)
    manager = InferenceManager(cfg, model, device)
    cfg_hash = config_hash(cfg)
    tag = prediction_tag_of(cfg, manager, checkpoint)
    all_metrics: Dict[str, Dict[str, float]] = {}
    for vi, image_path in enumerate(images):
        vol_name = volume_name_from_path(image_path)
        t0 = time.perf_counter()
        chunked = cfg.inference.chunked.enabled
        if chunked:
            # lazy reads, each chunk normalised on its own; the raw
            # prediction goes to disk chunk by chunk and is read back
            accessor = LazyVolumeAccessor(
                image_path, transpose=cfg.data.test.transpose, pad=cfg.data.test.pad,
                normalize=cfg.data.preprocessing.normalize, scale=cfg.data.test.read_scale, device=device,
            )
            t_read = time.perf_counter()
            written = run_chunked_inference(
                manager.predictor, accessor, out_dir / prediction_filename(vol_name, tag), cfg.inference.chunked,
                out_channels=manager.out_channels,
                # the checkpoint is in the signature: a manifest of other weights is dropped
                signature={"config_hash": cfg_hash, "checkpoint": str(checkpoint or "") or "random-init"},
            )
            prediction = np.moveaxis(read_volume(str(written)), 0, -1)
            logger.info("prediction[%s]: %s", vol_name, written)
        else:
            if cfg.data.test.read_scale:
                vol = LazyVolumeAccessor(
                    image_path, transpose=cfg.data.test.transpose, normalize=cfg.data.preprocessing.normalize,
                    scale=cfg.data.test.read_scale, device=device,
                ).read_all()
            else:
                vol = read_volume(image_path, device=device)
                if cfg.data.test.transpose:
                    vol = np.transpose(vol, cfg.data.test.transpose)
                vol = normalize_volume(vol, cfg.data.preprocessing.normalize)
            t_read = time.perf_counter()
            prediction = manager.predict(vol)  # (Z,Y,X,C)
        t_pred = time.perf_counter()
        if cfg.inference.output.save_raw and not chunked:
            # channel-first and contiguous: np.save writes a strided view element by element
            stored = np.moveaxis(apply_prediction_transform(prediction, cfg.inference.output), -1, 0)
            stored = np.ascontiguousarray(stored)
            written = save_prediction(
                out_dir / prediction_filename(vol_name, tag), stored, cfg_hash, checkpoint or "", tag
            )
            logger.info("prediction[%s]: %s", vol_name, written)
        if cfg.inference.output.save_all_heads and manager.head_spans and not chunked:
            names = head_filenames(vol_name, tag, [h for h, _, _ in manager.head_spans])
            for hname, c0, c1 in manager.head_spans:
                stored = np.moveaxis(apply_prediction_transform(prediction[..., c0:c1], cfg.inference.output), -1, 0)
                save_prediction(out_dir / names[hname], np.ascontiguousarray(stored), cfg_hash, checkpoint or "",
                                f"{tag}_head_{hname}")
        t_save = time.perf_counter()
        voxels = int(np.prod(prediction.shape[:3]))
        logger.info(
            "inference[%s]: %.1fs (%.2f Mvox/s)", vol_name, t_save - t0, voxels / max(t_save - t0, 1e-9) / 1e6
        )
        if mode == "tune":
            logger.info("timing[%s]: read+normalise %.3fs, predict %.3fs, save %.3fs", vol_name, t_read - t0,
                        t_pred - t_read, t_save - t_pred)
            all_metrics[vol_name] = {"cached": 1.0}
            continue
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
