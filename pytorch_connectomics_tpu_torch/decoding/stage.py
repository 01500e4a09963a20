"""The decoding stage for one volume (the port of
``pytorch_connectomics_tpu/decoding/stage.py``): the affinity QC mask, then
the decode steps or the decode graph, then post-processing; and the
streamed stage, which decodes one ``affinity_cc`` or ``waterz`` step chunk
by chunk from a reader."""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np

from ..config.schema import DecodingConfig
from . import branch, decoders  # noqa: F401 - registers the built-ins
from .postprocess import apply_postprocessing
from .qc import AffinityQCParams, scan_affinity_quality, write_qc_report
from .registry import get_decoder, get_graph_op, run_graph, run_steps

logger = logging.getLogger(__name__)


def run_decoding_stage(prediction: np.ndarray, cfg: DecodingConfig,
                       extra_inputs: Optional[Dict[str, np.ndarray]] = None,
                       timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """prediction (C, Z, Y, X) or (Z, Y, X, C) -> decoded labels (Z, Y, X).
    With ``cfg.qc`` the prediction is multiplied by the QC keep mask first
    (``extra_inputs["image"]`` feeds its border check); a graph gets the
    prediction as ``prediction`` beside ``extra_inputs``; with neither
    steps nor a graph, ``binary_cc``. ``timings`` receives the seconds of
    the QC scan (``qc``), of each step or graph node and of the
    post-processing (``postprocess``)."""
    timings = {} if timings is None else timings
    pred = np.asarray(prediction, dtype=np.float32)
    if pred.ndim == 3:
        pred = pred[None]
    elif pred.ndim == 4 and pred.shape[0] > pred.shape[-1]:
        pred = np.moveaxis(pred, -1, 0)  # channel-last from inference
    extra = extra_inputs or {}
    t0 = time.perf_counter()
    if cfg.qc.enabled:
        qc = cfg.qc
        params = AffinityQCParams(z_stride=qc.z_stride, drift_thresh=qc.z_mean_drift, border_width=qc.border_width,
                                  bg_thresh=qc.bg_thresh)
        mask, report = scan_affinity_quality(pred, qc.z_mean_drift, qc.border_low_intensity,
                                             border_width=qc.border_width, img=extra.get("image"), params=params)
        if qc.report_path:
            write_qc_report(report, qc.report_path, params)
            logger.info("QC report written to %s", qc.report_path)
        else:
            logger.info("QC: %s", report.to_markdown(params).replace("\n", " | "))
        pred = pred * mask[None]
        timings["qc"] = time.perf_counter() - t0
    if cfg.graph:
        labels = run_graph({"prediction": pred, **extra}, cfg.graph, timings)
    elif cfg.steps:
        labels = run_steps(pred, cfg.steps, timings)
    else:
        labels = decoders.decode_binary_cc(pred)
    t0 = time.perf_counter()
    labels = np.asarray(apply_postprocessing(labels, cfg.postprocessing))
    timings["postprocess"] = time.perf_counter() - t0
    return labels


def run_streamed_decoding_stage(reader, vol_shape, cfg: DecodingConfig,
                                timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Decodes from ``reader(slices) -> (C, z, y, x)`` in chunks of
    ``cfg.streamed_chunk``, then post-processes. Takes exactly one step,
    ``affinity_cc`` or ``waterz`` with ``fragments: cc``, whose streamed
    decode equals the whole volume's (:mod:`.streamed`); no graph and no QC
    mask (the QC of a chunked run is ``qc.StreamingQCAccumulator``)."""
    from .streamed import streamed_affinity_cc_decode, streamed_waterz_decode

    check_streamed(cfg)
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    kw = dict(cfg.steps[0].kwargs or {})
    chunk = tuple(cfg.streamed_chunk)
    if cfg.steps[0].name == "affinity_cc":
        labels = streamed_affinity_cc_decode(reader, vol_shape, chunk, threshold=float(kw.get("threshold", 0.75)),
                                             min_size=int(kw.get("min_size", 0)))
    else:
        # the fragment threshold clamped as decode_waterz's cc fragments do
        labels = streamed_waterz_decode(reader, vol_shape, chunk, threshold=float(kw.get("threshold", 0.5)),
                                        fragment_threshold=max(0.9, float(kw.get("fragment_threshold", 0.5))),
                                        min_size=int(kw.get("min_size", 0)))
    timings[f"0.{cfg.steps[0].name} (streamed)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = np.asarray(apply_postprocessing(labels, cfg.postprocessing))
    timings["postprocess"] = time.perf_counter() - t0
    return labels


def check_streamed(cfg: DecodingConfig) -> None:
    """Raises ``ValueError`` unless the config is one ``affinity_cc`` step or
    one ``waterz`` step with ``fragments: cc`` (the default here), without a
    graph or the QC mask."""
    if cfg.graph or len(cfg.steps) != 1:
        raise ValueError("decoding.streamed supports exactly one decode step (affinity_cc or waterz); got "
                         f"{[s.name for s in cfg.steps] or 'graph'}")
    if cfg.qc.enabled:
        raise ValueError("decoding.streamed does not support the affinity QC mask pass "
                         "(use the StreamingQCAccumulator during chunked inference instead)")
    step = cfg.steps[0]
    if step.name == "waterz" and (step.kwargs or {}).get("fragments", "cc") != "cc":
        raise ValueError("decoding.streamed waterz requires fragments='cc' "
                         "(watershed fragments are not exactly chunkable)")
    if step.name not in ("affinity_cc", "waterz"):
        raise ValueError(f"decoding.streamed does not support step '{step.name}' (only affinity_cc and waterz)")


def check_decoding(cfg: DecodingConfig) -> None:
    """Raises where a decoding config names what the port cannot run: a
    decoder or graph op it lacks (``KeyError``; ``NotImplementedError`` for
    one not ported), or a streamed decode :func:`check_streamed` refuses."""
    for step in cfg.steps or []:
        get_decoder(step.name if hasattr(step, "name") else step["name"])
    for node in (cfg.graph or {}).get("nodes", {}).values():
        get_graph_op(node.get("op") or node.get("name"))
    if cfg.streamed:
        check_streamed(cfg)
