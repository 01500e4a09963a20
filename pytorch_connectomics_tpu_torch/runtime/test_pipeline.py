"""Test pipeline: read -> normalise -> infer (+TTA) -> save -> decode ->
evaluate per test volume. The port of
``pytorch_connectomics_tpu/runtime/test_pipeline.py``:

- a decode-only run (``decoding.load_prediction_path``): the external
  prediction replaces inference, uint8 read as k/255, and with no test
  image the prediction names the volume;
- the prediction cache: a stored prediction whose attrs match the run's
  config hash and checkpoint (``inference.output.validate_prediction_cache``)
  is read instead of predicting; else the chunked branch (the volume
  predicted chunk by chunk through lazy reads into one file, then read
  back), the read-scaled whole-volume read, or the whole volume;
- the saved raw prediction and each head's channels of a multi-head model;
- prediction crops (``inference.output.crop_pad``), then the decode: read
  back from the decoded file when the prediction came from the cache and
  ``decoding.reuse_cached`` is on, else streamed (``decoding.streamed``) or
  whole;
- the evaluation, with the ground truth centre-aligned to the prediction
  (``align_to_image``), and the summary over every volume.

Test sharding (:mod:`.sharding`): independent shards take
``images[shard::num_shards]`` with their labels; a chunked run with
``system.shard_id``/``num_shards`` computes ``chunks[shard::num_shards]``
of each volume (:func:`..inference.chunked.stitch_shard_outputs` merges the
shards' files); TTA variant sharding is off for both. The ``precomputed``
chunked output is a neuroglancer layer ``<name>_prediction.precomputed``
beside where the file would be, read back through tensorstore (the JAX
package cannot read it back). In ``tune`` mode it stops after the
prediction is saved. nnU-Net preprocessing is not ported yet and raises
``NotImplementedError``.
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
from ..data.preprocess import center_align, normalize_volume
from ..decoding import run_decoding_stage, run_streamed_decoding_stage
from ..evaluation.report import aggregate_metrics_summary
from ..evaluation.stage import run_evaluation_stage
from ..inference import (
    InferenceManager,
    LazyVolumeAccessor,
    apply_prediction_transform,
    run_chunked_inference,
    save_prediction,
    validate_prediction_cache,
)
from ..inference.output import stored_prediction_path
from ..inference.prediction_crops import apply_prediction_crops
from .output_naming import (
    decoded_filename,
    head_filenames,
    prediction_filename,
    prediction_tag,
    volume_name_from_path,
)
from .sharding import plan_test_sharding, shard_paths

logger = logging.getLogger(__name__)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _check_ported(cfg: Config) -> None:
    if cfg.data.nnunet_preprocessing.enabled:
        raise NotImplementedError("nnU-Net preprocessing is not ported yet")


def _read_chunked(written: Path, precomputed: bool) -> np.ndarray:
    """The chunked run's (C, Z, Y, X) prediction read back."""
    if not precomputed:
        return read_volume(str(written))
    from ..data.precomputed import open_precomputed

    layer = open_precomputed(written)
    pred = layer.read(tuple(slice(0, n) for n in layer.shape[-3:]))
    return pred[None] if pred.ndim == 3 else pred


def prediction_tag_of(cfg: Config, manager: InferenceManager, checkpoint: Optional[str]) -> str:
    """The tag that names a test run's prediction and decoded files."""
    return prediction_tag(
        checkpoint,
        tta_passes=manager.predictor.num_variants,
        head=cfg.inference.model.output_head,
        channels=cfg.inference.model.select_channel,
    )


def external_prediction_path(cfg: Config) -> Optional[str]:
    """The decode-only run's prediction, where decoding is on and names one."""
    return cfg.decoding.load_prediction_path if cfg.decoding.enabled else None


def load_external_prediction(path: str) -> np.ndarray:
    """A stored (C, Z, Y, X) or (Z, Y, X) prediction as (C, Z, Y, X); uint8
    (the 8-bit affinity convention) read as float32 k/255."""
    pred = read_volume(str(path))
    if pred.ndim == 3:
        pred = pred[None]
    if pred.dtype == np.uint8:
        pred = pred.astype(np.float32) / 255.0
    return pred


def _read_image(cfg: Config, image_path: str, device) -> np.ndarray:
    """A test volume, read (scaled where the config says so), transposed
    and normalised."""
    if cfg.data.test.read_scale:
        return LazyVolumeAccessor(
            image_path, transpose=cfg.data.test.transpose, normalize=cfg.data.preprocessing.normalize,
            scale=cfg.data.test.read_scale, device=device,
        ).read_all()
    vol = read_volume(image_path, device=device)
    if cfg.data.test.transpose:
        vol = np.transpose(vol, cfg.data.test.transpose)
    return normalize_volume(vol, cfg.data.preprocessing.normalize)


def _save_outputs(cfg: Config, manager: InferenceManager, prediction: np.ndarray, pred_path: Path, vol_name: str,
                  tag: str, cfg_hash: str, checkpoint: Optional[str]) -> None:
    """The raw prediction and each head's channels, as the config asks."""
    if cfg.inference.output.save_raw:
        # channel-first and contiguous: np.save writes a strided view element by element
        stored = np.ascontiguousarray(np.moveaxis(apply_prediction_transform(prediction, cfg.inference.output), -1, 0))
        written = save_prediction(pred_path, stored, cfg_hash, checkpoint or "", tag)
        logger.info("prediction[%s]: %s", vol_name, written)
    if cfg.inference.output.save_all_heads and manager.head_spans:
        names = head_filenames(vol_name, tag, [h for h, _, _ in manager.head_spans])
        for hname, c0, c1 in manager.head_spans:
            stored = np.moveaxis(apply_prediction_transform(prediction[..., c0:c1], cfg.inference.output), -1, 0)
            save_prediction(pred_path.parent / names[hname], np.ascontiguousarray(stored), cfg_hash,
                            checkpoint or "", f"{tag}_head_{hname}")


def _decode(cfg: Config, prediction: np.ndarray, timings: Dict[str, float]) -> np.ndarray:
    """(Z, Y, X, C) -> decoded labels uint32, streamed or whole; each step's
    seconds into ``timings``."""
    pred_cf = np.moveaxis(prediction, -1, 0)
    if cfg.decoding.streamed:
        return run_streamed_decoding_stage(lambda sl: pred_cf[(slice(None),) + tuple(sl)], prediction.shape[:3],
                                           cfg.decoding, timings).astype(np.uint32)
    return run_decoding_stage(pred_cf, cfg.decoding, timings=timings).astype(np.uint32)


def run_test_pipeline(
    cfg: Config,
    model: torch.nn.Module,
    output_dir: str | Path,
    checkpoint: Optional[str] = None,
    device: torch.device | str = "cuda",
    mode: str = "test",
) -> Dict[str, Dict[str, float]]:
    """Infer (and evaluate, where labels are given) every test volume with
    ``model`` on ``device``, or decode the external prediction of a
    decode-only run. Returns {volume_name: metrics}; in ``tune`` mode it
    stops after saving each prediction ({volume_name: {"cached": 1.0}})."""
    _check_ported(cfg)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    images = _as_list(cfg.data.test.image)
    labels = _as_list(cfg.data.test.label)
    plan = plan_test_sharding(cfg, num_volumes=len(images))
    for note in plan.notes:
        logger.info("shard plan: %s", note)
    if plan.empty:
        return {}
    if plan.mode == "independent":
        # images and labels sharded together, so each image keeps its ground truth
        paired = shard_paths(list(zip(images, labels + [None] * len(images))), plan.shard_id, plan.num_shards)
        images = [p[0] for p in paired]
        labels = [p[1] for p in paired if p[1] is not None]
    if not plan.tta_sharding:
        cfg.inference.test_time_augmentation.shard_across_devices = False
    manager = InferenceManager(cfg, model, device)
    cfg_hash = config_hash(cfg)
    tag = prediction_tag_of(cfg, manager, checkpoint)
    ext_pred = external_prediction_path(cfg)
    if ext_pred and not images:
        images = [ext_pred]
    all_metrics: Dict[str, Dict[str, float]] = {}
    for vi, image_path in enumerate(images):
        vol_name = volume_name_from_path(image_path)
        pred_path = out_dir / prediction_filename(vol_name, tag)
        t0 = time.perf_counter()
        cached = chunked = False
        if ext_pred:
            logger.info("decode-only: loading prediction %s", ext_pred)
            prediction = np.moveaxis(load_external_prediction(ext_pred), 0, -1)
            t_read = t_pred = time.perf_counter()
        elif validate_prediction_cache(stored_prediction_path(pred_path), cfg_hash, checkpoint or ""):
            logger.info("cache hit: %s", stored_prediction_path(pred_path))
            cached = True
            prediction = np.moveaxis(read_volume(str(stored_prediction_path(pred_path))), 0, -1)
            t_read = t_pred = time.perf_counter()
        elif cfg.inference.chunked.enabled:
            chunked = True
            # lazy reads, each chunk normalised on its own; the raw
            # prediction goes to disk chunk by chunk and is read back
            accessor = LazyVolumeAccessor(
                image_path, transpose=cfg.data.test.transpose, pad=cfg.data.test.pad,
                normalize=cfg.data.preprocessing.normalize, scale=cfg.data.test.read_scale, device=device,
            )
            t_read = time.perf_counter()
            precomputed = cfg.inference.chunked.output_mode == "precomputed"
            written = run_chunked_inference(
                manager.predictor, accessor, pred_path.with_suffix(".precomputed") if precomputed else pred_path,
                cfg.inference.chunked, out_channels=manager.out_channels, shard_id=cfg.system.shard_id,
                num_shards=cfg.system.num_shards,
                # the checkpoint is in the signature: a manifest of other weights is dropped
                signature={"config_hash": cfg_hash, "checkpoint": str(checkpoint or "") or "random-init"},
            )
            prediction = np.moveaxis(_read_chunked(written, precomputed), 0, -1)
            logger.info("prediction[%s]: %s", vol_name, written)
            t_pred = time.perf_counter()
        else:
            vol = _read_image(cfg, image_path, device)
            t_read = time.perf_counter()
            prediction = manager.predict(vol)  # (Z,Y,X,C)
            t_pred = time.perf_counter()
        if not (ext_pred or cached or chunked):
            _save_outputs(cfg, manager, prediction, pred_path, vol_name, tag, cfg_hash, checkpoint)
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
        if cfg.inference.output.crop_pad:
            prediction = apply_prediction_crops(prediction, crop_pad=cfg.inference.output.crop_pad)
        decoded = None
        steps: Dict[str, float] = {}
        if cfg.decoding.enabled and (cfg.decoding.steps or cfg.decoding.graph):
            dec_path = out_dir / decoded_filename(vol_name, tag, decoding_cfg=cfg.decoding)
            stored = stored_prediction_path(dec_path)
            if cfg.decoding.reuse_cached and cached and stored.exists():
                # the decoded name encodes the decode recipe, and the prediction came from a valid cache
                logger.info("decode cache hit: %s", stored)
                decoded = read_volume(str(stored)).astype(np.uint32)
            else:
                decoded = _decode(cfg, prediction, steps)
                written = save_prediction(dec_path, decoded, cfg_hash, checkpoint or "", tag)
                logger.info("decoded[%s]: %s", vol_name, written)
            logger.info("decode[%s]: %.1fs, %d instances", vol_name, time.perf_counter() - t_save,
                        int(np.count_nonzero(np.bincount(decoded.ravel())[1:])))
        t_decode = time.perf_counter()
        if cfg.evaluation.enabled and vi < len(labels):
            gt = read_volume(labels[vi], device=device)
            if cfg.data.test.transpose:
                gt = np.transpose(gt, cfg.data.test.transpose)
            ref_shape = tuple(prediction.shape[:3])
            if cfg.data.data_transform.align_to_image and tuple(gt.shape[-3:]) != ref_shape:
                # small shape mismatches of the ground truth reconciled by a centred crop or pad
                gt = center_align(gt, gt.shape[:gt.ndim - 3] + ref_shape)
            all_metrics[vol_name] = run_evaluation_stage(prediction, decoded, gt, cfg.evaluation, out_dir, vol_name)
        else:
            all_metrics[vol_name] = {}
        logger.info(
            "timing[%s]: read+normalise %.3fs, predict %.3fs, save %.3fs, decode %.3fs, evaluate %.3fs; decode "
            "steps %s", vol_name, t_read - t0, t_pred - t_read, t_save - t_pred, t_decode - t_save,
            time.perf_counter() - t_decode, {k: round(v, 3) for k, v in steps.items()},
        )
    if cfg.evaluation.enabled and any(all_metrics.values()):
        aggregate_metrics_summary(out_dir)  # the summary over every volume
    return all_metrics
