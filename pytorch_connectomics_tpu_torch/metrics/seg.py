"""Instance-segmentation metrics, in numpy (the port of
``pytorch_connectomics_tpu/metrics/seg.py``): adapted Rand error,
variation of information, Hungarian-matched instance precision/recall/F1
and COCO-style average precision. Label 0 is background: it is left out of
the contingency table of ``voi`` and of the instance sets, and enters
``adapted_rand`` only through the SNEMI3D correction terms.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
from scipy import sparse
from scipy.optimize import linear_sum_assignment
from scipy.sparse.csgraph import connected_components

AP_THRESHOLDS = (0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95)


def _contingency(seg: np.ndarray, gt: np.ndarray, ignore_zero: bool = True):
    """Sparse (gt id x seg id) voxel counts over the voxels with gt > 0
    (all voxels with ``ignore_zero=False``) -> (table, voxels counted)."""
    s = np.asarray(seg).ravel().astype(np.int64)
    g = np.asarray(gt).ravel().astype(np.int64)
    if ignore_zero:
        keep = g > 0
        s, g = s[keep], g[keep]
    n = s.size
    if n == 0:
        return None, 0
    table = sparse.csr_matrix((np.ones(n, np.float64), (g, s)), shape=(int(g.max()) + 1, int(s.max()) + 1))
    return table, n


def adapted_rand(seg: np.ndarray, gt: np.ndarray, all_stats: bool = False):
    """SNEMI3D adapted Rand error (1 - the best F-score of the Rand index;
    lower is better): gt rows 0 are dropped, the seg 0 column counts only
    through the ``sum / n`` correction of the precision and pair terms."""
    seg, gt = np.asarray(seg), np.asarray(gt)
    if seg.shape != gt.shape:
        raise ValueError(f"shape mismatch: seg {seg.shape} vs gt {gt.shape}")
    table, n = _contingency(seg, gt, ignore_zero=False)
    if table is None:
        return (0.0, 1.0, 1.0) if all_stats else 0.0
    body = table[1:, :]
    inner = body[:, 1:]
    zero_col = np.asarray(body[:, 0].todense()).ravel()
    a = np.asarray(body.sum(axis=1)).ravel()
    b = np.asarray(inner.sum(axis=0)).ravel()
    zcorr = zero_col.sum() / n
    sum_a = float((a**2).sum())
    sum_b = float((b**2).sum()) + zcorr
    sum_ab = float((inner.data**2).sum()) + zcorr
    if sum_a == 0 or sum_b == 0:
        return (0.0, 1.0, 1.0) if all_stats else 0.0
    precision, recall = sum_ab / sum_b, sum_ab / sum_a
    f = 2.0 * precision * recall / (precision + recall) if precision + recall else 0.0
    return (1.0 - f, precision, recall) if all_stats else 1.0 - f


def voi(seg: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """Variation of information over gt > 0 -> (split H(seg|gt), merge
    H(gt|seg)) in bits; lower is better."""
    table, n = _contingency(seg, gt)
    if table is None:
        return 0.0, 0.0
    p = table / n

    def plogp(v):
        v = v[v > 0]
        return (v * np.log2(v)).sum()

    h_gt = -plogp(np.asarray(p.sum(axis=1)).ravel())
    h_seg = -plogp(np.asarray(p.sum(axis=0)).ravel())
    h_joint = -plogp(p.data)
    return float(h_joint - h_gt), float(h_joint - h_seg)


def _assignment(seg: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """IoU of the pairs of a Hungarian assignment (maximum total IoU) between
    the gt and the seg instances that overlap -> (IoUs, #seg, #gt). The
    assignment does not depend on an IoU threshold, so every threshold of
    :func:`average_precision` shares it.

    Only overlapping pairs can pass a threshold, and the best assignment of
    the whole (gt x seg) IoU matrix, restricted to its nonzero pairs, is the
    best assignment of each connected block of the overlap graph on its
    own. So each block is solved densely and alone: the same matched IoUs as
    one dense assignment of the whole matrix (up to exact ties between
    assignments of equal total), without a matrix of #gt x #seg entries."""
    s = np.asarray(seg).ravel().astype(np.int64)
    g = np.asarray(gt).ravel().astype(np.int64)
    s_sizes, g_sizes = np.bincount(s), np.bincount(g)
    n_seg = int(np.count_nonzero(s_sizes[1:]))
    n_gt = int(np.count_nonzero(g_sizes[1:]))
    both = (s > 0) & (g > 0)
    ns = len(s_sizes)
    key = g[both] * ns + s[both]
    if len(g_sizes) * ns <= 1 << 24:  # a dense count table of at most 128 MB, else sort
        counts = np.bincount(key, minlength=len(g_sizes) * ns)
        key = np.flatnonzero(counts)
        inter = counts[key]
    else:
        key, inter = np.unique(key, return_counts=True)
    if len(key) == 0:
        return np.zeros(0), n_seg, n_gt
    gi, si = key // ns, key % ns
    iou = inter / (g_sizes[gi] + s_sizes[si] - inter)
    # overlap graph: gt ids 0..G-1, seg ids G..G+S-1 (dense renumbering of the pairs' ids)
    gu, ga = np.unique(gi, return_inverse=True)
    su, sa = np.unique(si, return_inverse=True)
    ng = len(gu)
    graph = sparse.coo_matrix((np.ones(len(key)), (ga, ng + sa)), shape=(ng + len(su),) * 2)
    _, comp = connected_components(graph, directed=False)
    order = np.argsort(comp[ga], kind="stable")
    bounds = np.flatnonzero(np.diff(comp[ga][order])) + 1
    out = []
    for pairs in np.split(order, bounds):
        rows, r = np.unique(ga[pairs], return_inverse=True)
        cols, c = np.unique(sa[pairs], return_inverse=True)
        block = np.zeros((len(rows), len(cols)))
        block[r, c] = iou[pairs]
        br, bc = linear_sum_assignment(-block)
        out.append(block[br, bc])
    return np.concatenate(out), n_seg, n_gt


def _match_stats(matched: np.ndarray, n_seg: int, n_gt: int) -> Dict[str, float]:
    tp = len(matched)
    fp, fn = n_seg - tp, n_gt - tp
    precision = tp / max(1, tp + fp)
    recall = tp / max(1, tp + fn)
    f1 = 2 * precision * recall / max(1e-9, precision + recall)
    mean_iou = float(np.mean(matched)) if tp else 0.0
    return {
        "tp": tp, "fp": fp, "fn": fn, "precision": precision, "recall": recall, "f1": f1,
        "mean_matched_iou": mean_iou, "panoptic_quality": f1 * mean_iou,
    }


def instance_matching(seg: np.ndarray, gt: np.ndarray, iou_threshold: float = 0.5) -> Dict[str, float]:
    """Hungarian-matched instance statistics on IoU: a pair of the
    assignment with IoU >= ``iou_threshold`` is a true positive. Returns
    tp/fp/fn, precision/recall/f1, mean matched IoU and panoptic quality."""
    ious, n_seg, n_gt = _assignment(seg, gt)
    return _match_stats(ious[ious >= iou_threshold], n_seg, n_gt)


def average_precision(seg: np.ndarray, gt: np.ndarray, thresholds: Sequence[float] = AP_THRESHOLDS) -> float:
    """COCO-style AP: the mean over IoU thresholds of tp / (tp + fp + fn)
    (1 where there are no instances)."""
    ious, n_seg, n_gt = _assignment(seg, gt)
    aps = []
    for t in thresholds:
        m = _match_stats(ious[ious >= t], n_seg, n_gt)
        denom = m["tp"] + m["fp"] + m["fn"]
        aps.append(m["tp"] / denom if denom else 1.0)
    return float(np.mean(aps))
