"""Oracle metrics: the best a segmentation could score by merging its
segments alone (the port of ``pytorch_connectomics_tpu/metrics/oracle.py``):
each segment relabelled to the ground-truth id it overlaps most, then
scored, so what is left is split-free error."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy import sparse

from .seg import adapted_rand, voi


def oracle_merge(seg: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Each segment mapped to its majority ground-truth id (ties: the
    smallest id; 0 where it overlaps nothing), as uint32."""
    s = np.asarray(seg).astype(np.int64)
    g = np.asarray(gt).astype(np.int64)
    fg = s > 0
    table = sparse.csr_matrix((np.ones(int(fg.sum())), (s[fg], g[fg])), shape=(int(s.max()) + 1, int(g.max()) + 1))
    mapping = np.zeros(int(s.max()) + 1, np.int64)
    for sid in range(1, mapping.size):
        row = table.getrow(sid)
        if row.nnz:
            mapping[sid] = row.indices[np.argmax(row.data)]
    return mapping[s].astype(np.uint32)


def adapted_rand_oracle(seg: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """(adapted Rand error, adapted Rand error after :func:`oracle_merge`)."""
    return float(adapted_rand(seg, gt)), float(adapted_rand(oracle_merge(seg, gt), gt))


def voi_oracle(seg: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    vs, vm = voi(seg, gt)
    ovs, ovm = voi(oracle_merge(seg, gt), gt)
    return {"voi_split": vs, "voi_merge": vm, "oracle_voi_split": ovs, "oracle_voi_merge": ovm}
