"""(Normalized) expected run length over ground-truth skeletons, the port of
``pytorch_connectomics_tpu/metrics/nerl.py:21-120``.

Each ground-truth skeleton edge runs while the segment id under both its
ends is the same non-zero id; an id found under more than one skeleton is
a merge and voids every edge it covers. ERL is the length-weighted
expected length of the run holding a uniformly random skeleton point;
NERL divides it by the ERL of a perfect segmentation.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .seg import voi
from .skeleton import Skeleton, skeletonize_volume


def _node_segment_ids(seg: np.ndarray, skeleton: Skeleton) -> np.ndarray:
    coords = np.clip(np.round(skeleton.nodes).astype(np.int64), 0, np.asarray(seg.shape) - 1)
    return seg[tuple(coords.T)]


def expected_run_length(seg: np.ndarray, skeletons: Dict[int, Skeleton],
                        merge_penalty: bool = True) -> Tuple[float, float]:
    """-> (ERL, the ERL of a perfect segmentation)."""
    # a segment id under nodes of more than one skeleton is merged
    seg_owner: Dict[int, int] = {}
    merged: set = set()
    node_ids: Dict[int, np.ndarray] = {}
    for gt_id, sk in skeletons.items():
        ids = node_ids[gt_id] = _node_segment_ids(seg, sk)
        for s in np.unique(ids):
            if s == 0:
                continue
            if seg_owner.get(int(s), gt_id) != gt_id:
                merged.add(int(s))
            seg_owner[int(s)] = gt_id

    total_len = erl_num = max_num = 0.0
    for gt_id, sk in skeletons.items():
        if len(sk.edges) == 0:
            continue
        ids = node_ids[gt_id]
        a, b = sk.edges[:, 0], sk.edges[:, 1]
        lengths = np.linalg.norm(sk.nodes[a] - sk.nodes[b], axis=1)
        skel_len = float(lengths.sum())
        total_len += skel_len
        max_num += skel_len * skel_len  # perfect: one run the skeleton's length
        ok = (ids[a] == ids[b]) & (ids[a] > 0)
        if merge_penalty and merged:
            ok &= ~np.isin(ids[a], list(merged))
        # runs: the components of the nodes joined by the edges that run
        parent = np.arange(sk.nodes.shape[0])

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        running = np.flatnonzero(ok)
        for e in running:
            ra, rb = find(a[e]), find(b[e])
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        run_len: Dict[int, float] = {}
        for e in running:
            r = find(a[e])
            run_len[r] = run_len.get(r, 0.0) + float(lengths[e])
        erl_num += sum(v * v for v in run_len.values())
    if total_len == 0:
        return 0.0, 0.0
    return erl_num / total_len, max_num / total_len


def compute_nerl(
    seg: np.ndarray,
    gt: Optional[np.ndarray] = None,
    skeletons: Optional[Dict[int, Skeleton]] = None,
    anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
) -> Dict[str, float]:
    """{"erl", "max_erl", "nerl"} of ``seg`` against the skeletons of the
    ground truth ``gt`` (made on every call) or against ``skeletons``."""
    if skeletons is None:
        if gt is None:
            raise ValueError("need gt volume or precomputed skeletons")
        skeletons = skeletonize_volume(gt, anisotropy=anisotropy)
    erl, max_erl = expected_run_length(seg, skeletons)
    return {"erl": erl, "max_erl": max_erl, "nerl": erl / max_erl if max_erl > 0 else 0.0}


def skeleton_voi(seg: np.ndarray, skeletons: Dict[int, Skeleton]) -> Tuple[float, float]:
    """VOI (split, merge) over the skeletons' nodes only."""
    gt_ids, seg_ids = [], []
    for gt_id, sk in skeletons.items():
        ids = _node_segment_ids(seg, sk)
        gt_ids.extend([gt_id] * len(ids))
        seg_ids.extend(ids.tolist())
    if not gt_ids:
        return 0.0, 0.0
    return voi(np.asarray(seg_ids)[None, None], np.asarray(gt_ids)[None, None])
