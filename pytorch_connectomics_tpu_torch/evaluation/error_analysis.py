"""Error analysis of a segmentation against its ground truth (the port of
``pytorch_connectomics_tpu/evaluation/error_analysis.py``): segment size
statistics, split and merge attribution from the contingency table, a
dust-removal sweep, the top-k merge-fix oracle, z discontinuities, and
which segments own each ground-truth skeleton."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from ..metrics.seg import adapted_rand, instance_matching, voi


def segment_size_stats(seg: np.ndarray) -> Dict[str, float]:
    """Count, total, extremes, median, mean, 10th and 90th percentiles of
    the nonzero segments' sizes and the share under 100 voxels."""
    ids, counts = np.unique(seg[seg > 0], return_counts=True)
    if len(counts) == 0:
        return {"num_segments": 0}
    counts = np.sort(counts)
    return {
        "num_segments": int(len(ids)),
        "total_voxels": int(counts.sum()),
        "min_size": int(counts[0]),
        "max_size": int(counts[-1]),
        "median_size": float(np.median(counts)),
        "mean_size": float(counts.mean()),
        "p10_size": float(np.percentile(counts, 10)),
        "p90_size": float(np.percentile(counts, 90)),
        "tiny_fraction": float((counts < 100).mean()),
    }


def _overlap_matrix(seg: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The nonzero contingency table as (segment ids, ground-truth ids,
    voxels), sorted by (segment, ground truth)."""
    both = (seg > 0) & (gt > 0)
    keys, counts = np.unique(seg[both].astype(np.uint64) << np.uint64(32) | gt[both].astype(np.uint64),
                             return_counts=True)
    return (keys >> np.uint64(32)).astype(np.int64), (keys & np.uint64(0xFFFFFFFF)).astype(np.int64), \
        counts.astype(np.int64)


def _grouped(keys: np.ndarray, partners: np.ndarray, counts: np.ndarray) -> Dict[int, List[Tuple[int, int]]]:
    """{key: its (partner, voxels), largest first} for keys with several partners, in key order."""
    out = {}
    for k in np.unique(keys):
        rows = keys == k
        if rows.sum() > 1:
            out[int(k)] = sorted(zip(partners[rows].tolist(), counts[rows].tolist()), key=lambda t: -t[1])
    return out


def split_merge_attribution(seg: np.ndarray, gt: np.ndarray, top: int = 20, min_overlap: int = 50) -> Dict[str, Any]:
    """A ground-truth instance is split when several segments hold
    ``min_overlap`` voxels of it; a segment merges when it holds that many
    of several instances. Counts, and the ``top`` worst of each (most
    pieces first, their eight largest overlaps)."""
    sid, gid, counts = _overlap_matrix(seg, gt)
    keep = counts >= min_overlap
    splits = _grouped(gid[keep], sid[keep], counts[keep])
    merges = _grouped(sid[keep], gid[keep], counts[keep])

    def worst(d):
        return sorted(d.items(), key=lambda kv: -len(kv[1]))[:top]

    return {
        "num_split_gt": len(splits),
        "num_merge_segments": len(merges),
        "worst_splits": [{"gt_id": g, "n_fragments": len(o), "fragments": o[:8]} for g, o in worst(splits)],
        "worst_merges": [{"segment_id": s, "n_gt": len(v), "gt_overlaps": v[:8]} for s, v in worst(merges)],
    }


def dust_removal_sweep(seg: np.ndarray, gt: np.ndarray,
                       thresholds: Sequence[int] = (0, 50, 100, 200, 500, 1000)) -> List[Dict[str, float]]:
    """Adapted Rand and VOI after removing the segments under each size."""
    ids, counts = np.unique(seg, return_counts=True)
    rows = []
    for thr in thresholds:
        drop = ids[(counts < thr) & (ids > 0)]
        cleaned = np.where(np.isin(seg, drop), 0, seg) if drop.size else seg
        vs, vm = voi(cleaned, gt)
        rows.append({"min_size": int(thr), "segments_removed": int(drop.size),
                     "adapted_rand": float(adapted_rand(cleaned, gt)), "voi_split": float(vs),
                     "voi_merge": float(vm)})
    return rows


def oracle_study(seg: np.ndarray, gt: np.ndarray, top_k: int = 20) -> Dict[str, Any]:
    """The scores before and after splitting the ``top_k`` worst mergers
    (by voxels outside their largest ground-truth overlap) along the ground
    truth."""
    vs, vm = voi(seg, gt)
    report: Dict[str, Any] = {"baseline": {"adapted_rand": float(adapted_rand(seg, gt)), "voi_split": float(vs),
                                           "voi_merge": float(vm)}}
    sid, _, counts = _overlap_matrix(seg, gt)
    waste = {}
    for s in np.unique(sid):
        rows = sid == s
        if rows.sum() > 1:
            waste[int(s)] = int(np.sort(counts[rows])[::-1][1:].sum())
    worst = [s for s, _ in sorted(waste.items(), key=lambda kv: -kv[1])[:top_k]]
    fixed = seg.astype(np.int64).copy()
    next_id = int(fixed.max()) + 1
    for s in worst:
        m = fixed == s
        for g in np.unique(gt[m]):
            if g != 0:
                fixed[m & (gt == g)] = next_id
                next_id += 1
    vs, vm = voi(fixed, gt)
    report[f"after_top{top_k}_merge_fixes"] = {"adapted_rand": float(adapted_rand(fixed, gt)), "voi_split": float(vs),
                                               "voi_merge": float(vm), "segments_resplit": len(worst)}
    return report


def scan_z_discontinuities(seg: np.ndarray, top: int = 10) -> List[Dict[str, Any]]:
    """The ``top`` z seams whose two sections agree least (the share of the
    foreground of either where both carry the same id)."""
    rows = []
    for z in range(seg.shape[0] - 1):
        a, b = seg[z], seg[z + 1]
        fg = (a > 0) | (b > 0)
        if fg.any():
            rows.append({"z": int(z), "slice_agreement": float(((a == b) & fg).sum() / fg.sum())})
    return sorted(rows, key=lambda r: r["slice_agreement"])[:top]


def skeleton_ownership(seg: np.ndarray, skeletons: Dict[int, Any],
                       false_merge_threshold: int = 2) -> List[Dict[str, Any]]:
    """Per skeleton: the segments under its nodes, its dominant segment and
    that segment's share, its eight largest owners; a dominant segment of
    ``false_merge_threshold`` skeletons or more lists the others as
    ``merged_with_skeletons``."""
    dominant: Dict[int, List[int]] = {}
    rows = []
    for sk_id, sk in skeletons.items():
        at = np.clip(np.round(np.asarray(sk.nodes)).astype(int), 0, np.asarray(seg.shape) - 1)
        owners = seg[at[:, 0], at[:, 1], at[:, 2]]
        ids, counts = np.unique(owners[owners > 0], return_counts=True)
        if len(ids) == 0:
            rows.append({"skeleton": int(sk_id), "status": "unsegmented"})
            continue
        dom = int(ids[np.argmax(counts)])
        dominant.setdefault(dom, []).append(int(sk_id))
        rows.append({"skeleton": int(sk_id), "n_nodes": int(len(owners)), "n_segments": int(len(ids)),
                     "dominant_segment": dom, "dominant_fraction": float(counts.max() / counts.sum()),
                     "fragments": sorted(zip(ids.tolist(), counts.tolist()), key=lambda t: -t[1])[:8]})
    merged = {d: sks for d, sks in dominant.items() if len(sks) >= false_merge_threshold}
    for row in rows:
        dom = row.get("dominant_segment")
        if dom in merged:
            row["merged_with_skeletons"] = [s for s in merged[dom] if s != row["skeleton"]]
    return rows


def analyze_segmentation(seg: np.ndarray, gt: np.ndarray, top: int = 20, oracle: bool = False, dust: bool = False,
                         z_scan: bool = False) -> Dict[str, Any]:
    """The dense report: scores, instance matching, size statistics and
    split/merge attribution; with ``oracle``, ``dust`` and ``z_scan`` the
    corresponding studies."""
    vs, vm = voi(seg, gt)
    report: Dict[str, Any] = {"adapted_rand": float(adapted_rand(seg, gt)), "voi_split": float(vs),
                              "voi_merge": float(vm), "matching": instance_matching(seg, gt),
                              "pred_stats": segment_size_stats(seg), "gt_stats": segment_size_stats(gt)}
    report.update(split_merge_attribution(seg, gt, top=top))
    if oracle:
        report["oracle"] = oracle_study(seg, gt, top_k=top)
    if dust:
        report["dust_sweep"] = dust_removal_sweep(seg, gt)
    if z_scan:
        report["z_discontinuities"] = scan_z_discontinuities(seg)
    return report
