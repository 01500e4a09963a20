"""Quality control of an affinity prediction, on the host (the port of
``pytorch_connectomics_tpu/decoding/qc.py``): a strided per-z scan of the
channels' statistics with NaN/Inf counts, the z cuts where the volume's
head and tail stop looking like its interior, a border-against-interior
check of the background (where the image is given), a markdown report with
machine-readable front matter, the keep mask the decoding stage applies,
and an accumulator that builds the same report chunk by chunk.

Layout: predictions (C, Z, Y, X), images (Z, Y, X); channels x, y, z.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

CH_NAMES = ["x", "y", "z"]


def _channel_name(c: int) -> str:
    return CH_NAMES[c] if c < len(CH_NAMES) else f"c{c}"


@dataclass
class AffinityQCParams:
    """The scan's knobs: the z stride of the statistics, the sections left
    out at each end of the interior baseline (``k_edge``), the head and
    tail depth searched for the cuts (``refine_window``), the drift below
    the interior mean that fails a section, the border's width and the
    background intensity of the border check, and its sampled sections."""

    z_stride: int = 10
    k_edge: int = 20
    refine_window: int = 30
    drift_thresh: float = 0.05
    border_width: int = 32
    bg_thresh: float = 30.0
    n_z_border: int = 8


@dataclass
class QCReport:
    """What a scan found: the cuts ``[low_z, high_z)`` to keep, the interior
    and global statistics per channel, the sampled sections' means and
    standard deviations, the border rows, the sections the keep mask drops
    (``bad_slices``), whether the xy border is dark, and the per-section
    channel means."""

    low_z: int = 0
    high_z: int = 0
    interior_mean: Optional[np.ndarray] = None  # (C,)
    nan_count: int = 0
    inf_count: int = 0
    sampled_voxels: int = 0
    total_voxels: int = 0
    g_mean: Optional[np.ndarray] = None  # (C,)
    g_std: Optional[np.ndarray] = None
    g_min: Optional[np.ndarray] = None
    g_max: Optional[np.ndarray] = None
    z_idx: Optional[np.ndarray] = None  # (S,)
    means: Optional[np.ndarray] = None  # (S, C)
    stds: Optional[np.ndarray] = None  # (S, C)
    border_rows: List[str] = field(default_factory=list)
    bad_slices: List[int] = field(default_factory=list)
    border_flagged: bool = False
    slice_means: Optional[np.ndarray] = None

    def to_markdown(self, params: Optional[AffinityQCParams] = None, **meta) -> str:
        return render_markdown_report(self, params or AffinityQCParams(), **meta)


def _per_z_scan(pred, z_stride: int) -> Dict:
    """Statistics of every ``z_stride``-th section per channel, read in z
    blocks (the array's z chunk where it has one, else 32), with the global
    sums, squares, extremes and NaN/Inf counts of the blocks read."""
    n_ch, depth = pred.shape[0], pred.shape[1]
    chunks = getattr(pred, "chunks", None)
    block_z = max(chunks[1] if chunks is not None else 32, z_stride)
    z_idx = np.arange(0, depth, z_stride, dtype=np.int64)
    means = np.zeros((len(z_idx), n_ch), np.float32)
    stds = np.zeros((len(z_idx), n_ch), np.float32)
    g_sum, g_sq = np.zeros(n_ch, np.float64), np.zeros(n_ch, np.float64)
    g_min, g_max = np.full(n_ch, np.inf, np.float32), np.full(n_ch, -np.inf, np.float32)
    g_n = n_nan = n_inf = 0
    for z0 in range(0, depth, block_z):
        z1 = min(z0 + block_z, depth)
        rows = [(i, int(z)) for i, z in enumerate(z_idx) if z0 <= z < z1]
        if not rows:
            continue
        block = np.asarray(pred[:, z0:z1])
        n_nan += int(np.isnan(block).sum())
        n_inf += int(np.isinf(block).sum())
        for i, z in rows:
            sec = block[:, z - z0].astype(np.float32, copy=False).reshape(n_ch, -1)
            means[i], stds[i] = sec.mean(axis=1), sec.std(axis=1)
            g_sum += sec.sum(axis=1, dtype=np.float64)
            g_sq += np.square(sec, dtype=np.float64).sum(axis=1)
            g_min = np.minimum(g_min, sec.min(axis=1))
            g_max = np.maximum(g_max, sec.max(axis=1))
            g_n += sec.shape[1]
    return {"z_idx": z_idx, "means": means, "stds": stds, "g_sum": g_sum, "g_sq": g_sq, "g_min": g_min,
            "g_max": g_max, "g_n": g_n, "nan": n_nan, "inf": n_inf}


def _section_means(pred, z: int) -> np.ndarray:
    return np.asarray(pred[:, z]).astype(np.float32, copy=False).reshape(pred.shape[0], -1).mean(axis=1)


def _refine_z_cuts(pred, interior_mean: np.ndarray, refine_window: int, drift_thresh: float) -> Tuple[int, int]:
    """(first healthy z of the head, one past the last healthy z of the
    tail), each searched section by section in ``refine_window`` sections:
    healthy where every channel's mean is at least the interior mean less
    ``drift_thresh``. Without a healthy head section the cut is the window's
    end; without a healthy tail section, the tail's start."""
    depth = pred.shape[1]
    cutoff = interior_mean - drift_thresh
    head = min(refine_window, depth)
    low_z = next((z for z in range(head) if (_section_means(pred, z) >= cutoff).all()), head)
    tail = max(0, depth - refine_window)
    healthy = [z for z in range(tail, depth) if (_section_means(pred, z) >= cutoff).all()]
    return low_z, (healthy[-1] + 1 if healthy else tail)


def _xy_border_rows(pred, img, n_z: int, border: int, bg_thresh: float) -> List[str]:
    """For up to ``n_z`` sections spread over z (2% in from each end): each
    channel's mean, 95th percentile and share above 0.5 on the border's
    background voxels (image at most ``bg_thresh``) against its mean on the
    interior's background."""
    if img is None:
        return ["(skipped - no image provided)"]
    n_ch, depth, height, width = pred.shape
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[..., 0]
    if img.shape != (depth, height, width):
        return [f"WARN: img shape {img.shape} != pred spatial {(depth, height, width)}; skipped."]
    margin = max(int(0.02 * depth), 1)
    zs = np.unique(np.linspace(margin, max(depth - margin - 1, margin), min(n_z, depth), dtype=np.int64))
    rim = np.zeros((height, width), bool)
    rim[:border, :] = rim[-border:, :] = True
    rim[:, :border] = rim[:, -border:] = True
    rows = []
    for z in zs:
        dark = img[z] <= bg_thresh
        bg_rim, bg_inner = dark & rim, dark & ~rim
        n_bg = int(bg_rim.sum())
        if n_bg < 100:
            rows.append(f"  z={z:5d}: bg-border voxels={n_bg} (too few)")
            continue
        sec = np.asarray(pred[:, z]).astype(np.float32)
        parts = [f"z={z:5d} bg_border_n={n_bg:>9,d} bg_int_n={int(bg_inner.sum()):>9,d}"]
        for c in range(n_ch):
            on_rim = sec[c][bg_rim]
            inner = sec[c][bg_inner] if bg_inner.any() else np.zeros(1, np.float32)
            parts.append(f"ch{c}({_channel_name(c)}): border mu={on_rim.mean():.3f}/q95="
                         f"{np.quantile(on_rim, 0.95):.3f}/p>0.5={float((on_rim > 0.5).mean()):.1%} vs int "
                         f"mu={inner.mean():.3f}")
        rows.append("  " + " | ".join(parts))
    return rows


def scan_prediction(pred, img=None, params: Optional[AffinityQCParams] = None) -> QCReport:
    """The full scan of a (C, Z, Y, X) array (any array-like with slicing,
    such as an h5 or zarr dataset) and, for the border rows, its (Z, Y, X)
    image. The interior baseline is the NaN-ignoring mean of the sampled
    sections less ``k_edge`` at each end."""
    params = params or AffinityQCParams()
    depth = pred.shape[1]
    scan = _per_z_scan(pred, params.z_stride)
    g_n = max(scan["g_n"], 1)
    g_mean = scan["g_sum"] / g_n
    g_std = np.sqrt(np.maximum(scan["g_sq"] / g_n - g_mean**2, 0))
    means = scan["means"]
    k = params.k_edge
    interior = means[k:-k] if len(means) > 2 * k + 1 else means
    with np.errstate(invalid="ignore"):
        interior_mean = np.nanmean(interior, axis=0)
    low_z, high_z = _refine_z_cuts(pred, interior_mean, params.refine_window, params.drift_thresh)
    return QCReport(
        low_z=low_z, high_z=high_z, interior_mean=interior_mean.astype(np.float32), nan_count=scan["nan"],
        inf_count=scan["inf"], sampled_voxels=scan["g_n"], total_voxels=int(np.prod(pred.shape[1:])),
        g_mean=g_mean.astype(np.float32), g_std=g_std.astype(np.float32), g_min=scan["g_min"], g_max=scan["g_max"],
        z_idx=scan["z_idx"], means=means, stds=scan["stds"],
        border_rows=_xy_border_rows(pred, img, params.n_z_border, params.border_width, params.bg_thresh),
        bad_slices=[z for z in range(depth) if z < low_z or z >= high_z], slice_means=means.mean(axis=1),
    )


def render_markdown_report(report: QCReport, params: AffinityQCParams, pred_desc: str = "", img_desc: str = "",
                           mask_path: str = "", image_path: str = "") -> str:
    """The report as markdown: front matter (paths, cuts, border knobs),
    volume health, the z cuts and the border rows."""
    n_ch = len(report.g_mean) if report.g_mean is not None else 0
    lines = ["---", f"img: {image_path}", f"out: {mask_path}", f"low_z: {report.low_z}", f"high_z: {report.high_z}",
             f"bg_thresh: {params.bg_thresh}", f"border_width: {params.border_width}", "---", "",
             "# Affinity check report"]
    if pred_desc:
        lines.append(f"- pred: {pred_desc}")
    if img_desc:
        lines.append(f"- img:  {img_desc}")
    lines += ["", "## Volume health",
              f"- Sampled {report.sampled_voxels:,} / {report.total_voxels:,} voxels per channel "
              f"(~{report.sampled_voxels / max(report.total_voxels, 1):.1%}).",
              f"- NaN={report.nan_count}, Inf={report.inf_count}", "```"]
    for c in range(n_ch):
        lines.append(f"  ch{c}({_channel_name(c)}-aff): mean={report.g_mean[c]:.4f} std={report.g_std[c]:.4f} "
                     f"min={report.g_min[c]:.4f} max={report.g_max[c]:.4f}")
    lines.append("```")
    if n_ch:
        spread = float(report.g_mean.max() - report.g_mean.min())
        lines.append(f"- Channel-mean spread (max-min): {spread:.4f} ({'OK' if spread < 0.05 else 'imbalanced'}).")
    lines += ["", f"## Derived Z cuts (drift_thresh={params.drift_thresh})",
              f"- low_z={report.low_z}, high_z={report.high_z} (keep z in [{report.low_z}, {report.high_z})).",
              "", f"## XY-border + intensity (border={params.border_width}px, bg<={params.bg_thresh}, "
              f"n_z={params.n_z_border})", "```"]
    lines += report.border_rows or ["(not computed)"]
    lines.append("```")
    return "\n".join(lines) + "\n"


def scan_affinity_quality(pred: np.ndarray, z_mean_drift: float = 0.5, border_low_intensity: float = 0.05,
                          border_width: int = 8, img=None,
                          params: Optional[AffinityQCParams] = None) -> Tuple[np.ndarray, QCReport]:
    """The decoding stage's QC: the full scan (stride 1 unless ``params``
    says otherwise), then the keep mask (Z, Y, X) float32, zero on the
    sections whose channel mean is more than ``z_mean_drift`` (relative)
    from the median section's; the report flags the xy border when its
    mean is below ``border_low_intensity``. Returns (mask, report)."""
    p = pred if pred.ndim == 4 else pred[None]
    params = params or AffinityQCParams(z_stride=1, drift_thresh=z_mean_drift, border_width=border_width)
    report = scan_prediction(p, img=img, params=params)
    means = report.slice_means
    med = float(np.nanmedian(means))
    report.bad_slices = sorted({int(z) for z in range(means.shape[0])
                                if med > 1e-6 and abs(means[z] - med) / med > z_mean_drift})
    mask = np.ones(p.shape[1:], np.float32)
    mask[report.bad_slices] = 0.0
    b = border_width
    if b > 0 and p.shape[2] > 2 * b and p.shape[3] > 2 * b:
        rim = np.concatenate([p[:, :, :b, :].ravel(), p[:, :, -b:, :].ravel(), p[:, :, :, :b].ravel(),
                              p[:, :, :, -b:].ravel()])
        report.border_flagged = bool(rim.mean() < border_low_intensity)
    return mask, report


def write_qc_report(report: QCReport, path: str | Path, params: Optional[AffinityQCParams] = None, **meta) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(report.to_markdown(params, **meta))
    return path


class StreamingQCAccumulator:
    """The QC statistics gathered chunk by chunk (chunked inference or
    stitching): per (z, channel) sums, squares, extremes and voxel counts,
    and NaN/Inf counts; :meth:`finalize` makes the report a stride-1 scan of
    the whole prediction would."""

    def __init__(self, z_total: int, channels: int = 1):
        self._reset(z_total, channels)

    def _reset(self, z_total: int, channels: int) -> None:
        self.c = channels
        self.sum = np.zeros((z_total, channels), np.float64)
        self.sq = np.zeros((z_total, channels), np.float64)
        self.mins = np.full((z_total, channels), np.inf, np.float32)
        self.maxs = np.full((z_total, channels), -np.inf, np.float32)
        self.count = np.zeros(z_total, np.int64)
        self.nan_count = 0
        self.inf_count = 0

    def update(self, chunk: np.ndarray, z_offset: int) -> None:
        """Adds a (C, z, Y, X) or (z, Y, X) chunk starting at section
        ``z_offset``; the first chunk sets the channel count."""
        ch = chunk if chunk.ndim == 4 else chunk[None]
        if ch.shape[0] != self.c and not self.count.any():
            self._reset(len(self.count), ch.shape[0])
        self.nan_count += int(np.isnan(ch).sum())
        self.inf_count += int(np.isinf(ch).sum())
        flat = ch.reshape(ch.shape[0], ch.shape[1], -1)
        rows = slice(z_offset, z_offset + ch.shape[1])
        self.sum[rows] += flat.sum(axis=2, dtype=np.float64).T
        self.sq[rows] += np.square(flat, dtype=np.float64).sum(axis=2).T
        self.mins[rows] = np.minimum(self.mins[rows], flat.min(axis=2).T)
        self.maxs[rows] = np.maximum(self.maxs[rows], flat.max(axis=2).T)
        self.count[rows] += flat.shape[2]

    def finalize(self, z_mean_drift: float = 0.5, params: Optional[AffinityQCParams] = None) -> QCReport:
        """The report of every section seen: cuts at the first and one past
        the last section whose channel means all reach the interior mean
        less the drift, and the relative-drift sections as ``bad_slices``."""
        params = params or AffinityQCParams(drift_thresh=z_mean_drift)
        seen = self.count > 0
        means = (self.sum / np.maximum(self.count, 1)[:, None]).astype(np.float32)
        stds = np.sqrt(np.maximum(self.sq / np.maximum(self.count, 1)[:, None] - means.astype(np.float64) ** 2,
                                  0)).astype(np.float32)
        g_n = int(self.count.sum())
        g_mean = self.sum.sum(axis=0) / max(g_n, 1)
        g_std = np.sqrt(np.maximum(self.sq.sum(axis=0) / max(g_n, 1) - g_mean**2, 0))
        ch_means = means.mean(axis=1)
        med = float(np.median(ch_means[seen])) if seen.any() else 0.0
        bad = [int(z) for z in range(len(ch_means))
               if seen[z] and med > 1e-6 and abs(ch_means[z] - med) / med > z_mean_drift]
        k = params.k_edge
        interior = means[seen][k:-k] if seen.sum() > 2 * k + 1 else means[seen]
        interior_mean = interior.mean(axis=0) if len(interior) else np.zeros(self.c, np.float32)
        ok = seen & (means >= (interior_mean - params.drift_thresh)[None]).all(axis=1)
        low_z = int(np.argmax(ok)) if ok.any() else 0
        high_z = int(len(ok) - np.argmax(ok[::-1])) if ok.any() else len(ok)
        return QCReport(
            low_z=low_z, high_z=high_z, interior_mean=interior_mean, nan_count=self.nan_count,
            inf_count=self.inf_count, sampled_voxels=g_n, total_voxels=g_n, g_mean=g_mean.astype(np.float32),
            g_std=g_std.astype(np.float32), g_min=self.mins.min(axis=0), g_max=self.maxs.max(axis=0),
            z_idx=np.arange(len(ch_means)), means=means, stds=stds, bad_slices=bad, slice_means=ch_means,
        )
