"""Skeletons of instance volumes for NERL, the port of
``pytorch_connectomics_tpu/metrics/skeleton.py:26-161``.

``method="teasar"`` runs the native TEASAR of ``csrc/pytc_ops.cpp``
(:func:`..ops.native.teasar_skeleton`) on each instance's box; a failed
build of that library raises, with no fallback. ``method="mst"`` is the
explicit approximation: the voxel of largest boundary distance in each
cell of a stride grid, joined by the minimum spanning tree of their
8-nearest-neighbour graph.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
from scipy import ndimage, sparse
from scipy.sparse.csgraph import minimum_spanning_tree
from scipy.spatial import cKDTree

from ..ops.native import renumber, teasar_skeleton


@dataclass
class Skeleton:
    nodes: np.ndarray  # (N, 3) float voxel coordinates (z, y, x)
    edges: np.ndarray  # (M, 2) int node indices

    @property
    def total_length(self) -> float:
        if len(self.edges) == 0:
            return 0.0
        d = self.nodes[self.edges[:, 0]] - self.nodes[self.edges[:, 1]]
        return float(np.linalg.norm(d, axis=1).sum())


def _mst_skeleton(mask, coords, stride, anisotropy, max_nodes) -> Skeleton:
    d = ndimage.distance_transform_edt(mask, sampling=anisotropy)
    cell = (coords // np.asarray(stride)).astype(np.int64)
    key = cell[:, 0] * 1_000_000 + cell[:, 1] * 1_000 + cell[:, 2]
    order = np.argsort(key, kind="stable")
    key_sorted, coords_sorted = key[order], coords[order]
    edt_sorted = d[tuple(coords_sorted.T)]
    picks, start = [], 0
    for end in np.flatnonzero(np.diff(key_sorted)).tolist() + [len(key_sorted) - 1]:
        picks.append(coords_sorted[start:end + 1][np.argmax(edt_sorted[start:end + 1])])
        start = end + 1
    nodes = np.asarray(picks, dtype=np.float64)
    if nodes.shape[0] > max_nodes:
        nodes = nodes[np.linspace(0, nodes.shape[0] - 1, max_nodes).astype(int)]
    if nodes.shape[0] == 1:
        return Skeleton(nodes, np.zeros((0, 2), np.int64))
    scaled = nodes * np.asarray(anisotropy)
    k = min(8, nodes.shape[0])
    dist, idx = cKDTree(scaled).query(scaled, k=k)
    rows = np.repeat(np.arange(nodes.shape[0]), k - 1)
    graph = sparse.coo_matrix(((dist[:, 1:] + 1e-9).ravel(), (rows, idx[:, 1:].ravel())),
                              shape=(nodes.shape[0],) * 2)
    mst = minimum_spanning_tree(graph).tocoo()
    return Skeleton(nodes, np.stack([mst.row, mst.col], axis=1).astype(np.int64))


def skeletonize_instance(
    mask: np.ndarray,
    stride: Sequence[int] = (2, 4, 4),
    anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
    max_nodes: int = 2000,
    method: str = "teasar",
) -> Optional[Skeleton]:
    """Binary mask -> centreline skeleton, None for an empty mask."""
    if method not in ("teasar", "mst"):
        raise ValueError(f"skeleton method {method!r} is not 'teasar' or 'mst'")
    coords = np.argwhere(mask)
    if coords.shape[0] == 0:
        return None
    if method == "mst":
        return _mst_skeleton(mask, coords, stride, anisotropy, max_nodes)
    box = ndimage.find_objects(mask.astype(np.uint8))[0]
    nodes, edges = teasar_skeleton(np.ascontiguousarray(mask[box]), anisotropy=anisotropy)
    if len(nodes) == 0:
        return None
    return Skeleton(nodes + np.array([s.start for s in box], np.float64), edges.astype(np.int64))


def skeletonize_volume(
    labels: np.ndarray,
    stride: Sequence[int] = (2, 4, 4),
    anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
    min_voxels: int = 50,
    method: str = "teasar",
    num_workers: int = 0,
) -> Dict[int, Skeleton]:
    """Instance volume -> {id: Skeleton} for every instance of at least
    ``min_voxels`` voxels whose skeleton has an edge. One ``find_objects``
    pass gives the boxes (after a renumber where the ids are sparse), and
    the instances run on a thread pool (the native TEASAR releases the
    GIL); ``num_workers=0`` takes the CPU count, at most 8."""
    ids, counts = np.unique(labels, return_counts=True)
    keep = [int(i) for i, c in zip(ids, counts) if i != 0 and c >= min_voxels]
    if not keep:
        return {}
    lab, back = labels, None
    if int(ids.max()) > 4 * len(ids) + 64:
        lab, _ = renumber(np.ascontiguousarray(labels.astype(np.uint32)))
        nz = lab.ravel() != 0
        pairs = np.unique(np.stack([lab.ravel()[nz], labels.ravel()[nz].astype(np.int64)], 1), axis=0)
        back = {int(a): int(b) for a, b in pairs}
        fwd = {b: a for a, b in back.items()}
        keep = [fwd[o] for o in keep]
    boxes = ndimage.find_objects(lab.astype(np.int64))

    def one(iid):
        box = boxes[iid - 1]
        if box is None:
            return None
        sk = skeletonize_instance(lab[box] == iid, stride, anisotropy, method=method)
        if sk is None or not len(sk.edges):
            return None
        return (back[iid] if back else iid), Skeleton(sk.nodes + np.array([s.start for s in box], np.float64),
                                                      sk.edges)

    workers = num_workers or min(8, os.cpu_count() or 1, len(keep))
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            results = list(pool.map(one, keep))
    else:
        results = [one(k) for k in keep]
    return dict(r for r in results if r)
