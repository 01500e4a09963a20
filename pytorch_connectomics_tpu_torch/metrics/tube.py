"""Ground-truth-free QC of tube-like instances, skeleton-mask metrics and
the curvilinear file-pair evaluation (the port of
``pytorch_connectomics_tpu/metrics/tube.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
from scipy import ndimage


def tube_instance_qc(labels: np.ndarray, min_length: int = 8, max_components_ratio: float = 0.1,
                     border_patch_max: int = 64, bump_ratio: float = 3.0) -> Dict[int, Dict[str, float]]:
    """Per instance, in order of first appearance by section: its z
    ``length`` and ``voxels``, and the flags ``short`` (length below
    ``min_length``), ``border_patch`` (touches the in-plane border with at
    most ``border_patch_max`` voxels), ``multi_component`` (more than
    ``max_components_ratio`` of its sections hold several 2-D components;
    the share as ``multi_component_ratio``) and ``bump`` (largest section
    area over the median one above ``bump_ratio``)."""
    from ..decoding.branch import section_components

    lab = np.asarray(labels)
    if lab.ndim == 4:
        lab = lab[0]
    sections = section_components(lab)
    areas: Dict[int, List[int]] = {}
    zs: Dict[int, List[int]] = {}
    for z in range(lab.shape[0]):
        ids, counts = np.unique(lab[z], return_counts=True)
        for iid, c in zip(ids.tolist(), counts.tolist()):
            if iid != 0:
                areas.setdefault(iid, []).append(c)
                zs.setdefault(iid, []).append(z)
    on_border = set()
    for rim in (lab[:, 0, :], lab[:, -1, :], lab[:, :, 0], lab[:, :, -1]):
        on_border |= set(np.unique(rim).tolist())
    report: Dict[int, Dict[str, float]] = {}
    for iid, zlist in zs.items():
        a = np.array(areas[iid])
        length = max(zlist) - min(zlist) + 1
        share = sum(1 for z in zlist if sections[z].get(iid, 1) > 1) / max(1, len(zlist))
        report[iid] = {
            "length": float(length),
            "voxels": float(a.sum()),
            "short": float(length < min_length),
            "border_patch": float(iid in on_border and a.sum() <= border_patch_max),
            "multi_component_ratio": share,
            "multi_component": float(share > max_components_ratio),
            "bump": float(a.max() / max(1.0, np.median(a)) > bump_ratio),
        }
    return report


def tube_qc_summary(labels: np.ndarray, **kw) -> Dict[str, float]:
    """``n_instances`` and the count of each flag of :func:`tube_instance_qc`."""
    per = tube_instance_qc(labels, **kw)
    if not per:
        return {"n_instances": 0.0}
    out = {"n_instances": float(len(per))}
    for flag in ("short", "border_patch", "multi_component", "bump"):
        out[f"n_{flag}"] = float(sum(v[flag] for v in per.values()))
    return out


def skeleton_mask_metrics(pred_skel: np.ndarray, gt_skel: np.ndarray, tolerance: int = 2) -> Dict[str, float]:
    """Precision (predicted voxels within ``tolerance`` of the ground
    truth), recall (the reverse), F1, and the voxel IoU of two skeleton
    masks; all 0 when either is empty."""
    p, g = np.asarray(pred_skel) > 0, np.asarray(gt_skel) > 0
    if not (p.any() and g.any()):
        return {"precision": 0.0, "recall": 0.0, "f1": 0.0, "iou": 0.0}
    precision = (p & (ndimage.distance_transform_edt(~g) <= tolerance)).sum() / p.sum()
    recall = (g & (ndimage.distance_transform_edt(~p) <= tolerance)).sum() / g.sum()
    f1 = 2 * precision * recall / max(1e-9, precision + recall)
    return {"precision": float(precision), "recall": float(recall), "f1": float(f1),
            "iou": float((p & g).sum() / (p | g).sum())}


def curvilinear_f1(pred_mask: np.ndarray, gt_mask: np.ndarray, tolerance: int = 2) -> Dict[str, float]:
    """:func:`skeleton_mask_metrics` of thin fiber masks."""
    return skeleton_mask_metrics(pred_mask, gt_mask, tolerance)


def evaluate_curvilinear_pairs(pred_paths: Sequence[str], gt_paths: Sequence[str],
                               tolerance: int = 2) -> Dict[str, Dict[str, float]]:
    """{prediction file stem: :func:`curvilinear_f1`} for each file pair."""
    from ..data.io import read_volume

    return {Path(p).stem: curvilinear_f1(read_volume(p) > 0, read_volume(g) > 0, tolerance)
            for p, g in zip(pred_paths, gt_paths)}
