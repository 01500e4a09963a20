"""Decoding stage for one volume (the port of the steps branch of
``run_decoding_stage``, ``pytorch_connectomics_tpu/decoding/stage.py:21-64``):
prediction -> decode steps -> post-processing -> labels. The affinity QC
mask, graph decoding and streamed decoding are not ported yet and raise
``NotImplementedError``."""

from __future__ import annotations

import numpy as np

from ..config.schema import DecodingConfig
from . import decoders  # noqa: F401 - registers the built-ins
from .postprocess import apply_postprocessing
from .registry import run_steps


def _check_ported(cfg: DecodingConfig) -> None:
    for flag, what in (
        (cfg.qc.enabled, "the affinity QC mask (decoding.qc)"),
        (cfg.graph, "graph decoding (decoding.graph)"),
        (cfg.streamed, "streamed decoding (decoding.streamed)"),
    ):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")


def run_decoding_stage(prediction: np.ndarray, cfg: DecodingConfig) -> np.ndarray:
    """prediction (C, Z, Y, X) or (Z, Y, X, C) -> decoded labels (Z, Y, X);
    ``binary_cc`` when no step is configured."""
    _check_ported(cfg)
    pred = np.asarray(prediction, dtype=np.float32)
    if pred.ndim == 3:
        pred = pred[None]
    elif pred.ndim == 4 and pred.shape[0] > pred.shape[-1]:
        pred = np.moveaxis(pred, -1, 0)  # channel-last from inference
    if cfg.steps:
        labels = run_steps(pred, cfg.steps)
    else:
        labels = decoders.decode_binary_cc(pred)
    return np.asarray(apply_postprocessing(labels, cfg.postprocessing))
