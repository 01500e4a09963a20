"""Metrics reports (the port of
``pytorch_connectomics_tpu/evaluation/report.py``): each volume's
``<volume>_metrics.txt`` and its entry in the run's ``metrics.json``, a
volume's per-tube QC records as ``eval_<volume>_tube_instances.npz``, and
the summary over every volume of ``metrics.json`` written after the last
one."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


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


def save_tube_instances(output_dir: str | Path, tag: str, per_instance: Dict[int, Dict[str, float]],
                        volume_shape: Optional[tuple] = None, config: Optional[Dict[str, Any]] = None) -> Path:
    """The records of ``metrics.tube.tube_instance_qc`` as columns: ``label``
    (uint64, sorted) and one float64 column a field (NaN where a record
    lacks it), with the volume's shape and ``config_<key>`` entries."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"eval_{tag}_tube_instances.npz"
    labels = sorted(per_instance)
    columns: Dict[str, np.ndarray] = {"label": np.asarray(labels, np.uint64)}
    for name in sorted({k for rec in per_instance.values() for k in rec}):
        columns[name] = np.asarray([per_instance[i].get(name, np.nan) for i in labels], np.float64)
    if volume_shape is not None:
        columns["volume_shape"] = np.asarray(volume_shape, np.uint64)
    for k, v in (config or {}).items():
        columns[f"config_{k}"] = np.asarray(v)
    np.savez_compressed(path, **columns)
    return path


def aggregate_metrics_summary(output_dir: str | Path) -> Optional[Path]:
    """Each metric's mean, median, min, max and volume count over the
    volumes of ``metrics.json``, as ``metrics_summary.json`` and ``.txt``;
    None where there is nothing to summarise."""
    out = Path(output_dir)
    json_path = out / "metrics.json"
    if not json_path.exists():
        return None
    per_volume: Dict[str, Dict[str, float]] = json.loads(json_path.read_text())
    if not per_volume:
        return None
    summary: Dict[str, Dict[str, float]] = {}
    for name in sorted({k for m in per_volume.values() for k in m}):
        vals = np.asarray([m[name] for m in per_volume.values() if name in m], np.float64)
        summary[name] = {"mean": float(vals.mean()), "median": float(np.median(vals)), "min": float(vals.min()),
                         "max": float(vals.max()), "n_volumes": int(len(vals))}
    (out / "metrics_summary.json").write_text(json.dumps(summary, indent=2))
    lines = [f"# aggregated test metrics ({len(per_volume)} volumes)"]
    lines += [f"{name}: mean={s['mean']:.6f} median={s['median']:.6f} min={s['min']:.6f} max={s['max']:.6f} "
              f"(n={s['n_volumes']})" for name, s in summary.items()]
    (out / "metrics_summary.txt").write_text("\n".join(lines) + "\n")
    return out / "metrics_summary.json"
