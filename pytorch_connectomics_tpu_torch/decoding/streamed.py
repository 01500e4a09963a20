"""Streamed decoding: an affinity volume decoded chunk by chunk on a grid,
the chunks' labels joined across their seams, so that the result equals
the whole-volume decode exactly (the port of
``pytorch_connectomics_tpu/decoding/streamed.py``).

The affinities come through ``reader(slices) -> (C, z, y, x)`` for a region
of the volume, so the whole volume is never read at once. Channels are x,
y, z, each stored at its high-end voxel: the edge across a seam on axis k
(z, y, x = 0, 1, 2) is channel 2 - k of the seam's high side.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..chunked.grid import build_chunk_grid
from ..ops.native import affinity_connected_components, agglomerate_rag, rag_mean_edges, remap, remove_small, renumber

Reader = Callable[[tuple], np.ndarray]


class UnionFind:
    """Disjoint sets of ints, created on first use; a union keeps the
    smaller root."""

    def __init__(self):
        self.parent: Dict[int, int] = {}

    def find(self, a: int) -> int:
        parent = self.parent
        parent.setdefault(a, a)
        while parent[a] != a:
            up = parent.setdefault(parent[a], parent[a])
            parent[a] = up  # halve the path
            a = up
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def _map_chunks(fn, chunks, num_workers: int) -> list:
    """``fn`` over the chunks in order, in threads (the native ops release
    the GIL); ``num_workers`` 0 takes the CPU count, at most 8."""
    workers = num_workers or min(8, os.cpu_count() or 1, len(chunks))
    if workers <= 1:
        return [fn(c) for c in chunks]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, chunks))


def _seam_faces(chunk) -> List[Tuple[int, tuple, tuple]]:
    """(axis, the chunk's first plane on it, the plane below) for each low
    face of the chunk that is not the volume's."""
    faces = []
    for axis in range(3):
        lo = chunk.start[axis]
        if lo == 0:
            continue
        hi_face = [slice(a, b) for a, b in zip(chunk.start, chunk.stop)]
        hi_face[axis] = slice(lo, lo + 1)
        lo_face = list(hi_face)
        lo_face[axis] = slice(lo - 1, lo)
        faces.append((axis, tuple(hi_face), tuple(lo_face)))
    return faces


def streamed_affinity_cc_decode(aff_reader: Reader, vol_shape: Sequence[int], chunk_size: Sequence[int],
                                threshold: float = 0.75, min_size: int = 0,
                                num_workers: int = 0) -> np.ndarray:
    """Affinity connected components (``affinity_cc``) chunk by chunk.
    Each chunk's components take ids after the previous chunks' (in grid
    order); the edges above ``threshold`` across each seam join ids in a
    union-find. A voxel that is background in its chunk but joined across a
    seam (its one strong edge crosses it) enters the union-find as a node
    of its own and gets an id after all chunks' ids. Then renumbered in
    order of first appearance, ``min_size`` applied and renumbered again."""
    chunks = build_chunk_grid(vol_shape, chunk_size, halo=(0, 0, 0))
    out = np.zeros(tuple(vol_shape), np.uint32)

    def decode(chunk):
        labels, n = affinity_connected_components(aff_reader(chunk.core_slices), threshold)
        return labels.astype(np.uint32), n

    offset = 0
    for chunk, (labels, n) in zip(chunks, _map_chunks(decode, chunks, num_workers)):
        labels[labels > 0] += offset
        out[chunk.core_slices] = labels
        offset += n

    uf = UnionFind()
    base = int(out.max()) + 1  # a lone voxel's node: base + its flat index
    strides = (vol_shape[1] * vol_shape[2], vol_shape[2], 1)
    lone: List[Tuple[int, int]] = []  # (flat voxel index, node)
    for chunk in chunks:
        for axis, hi_face, lo_face in _seam_faces(chunk):
            strong = aff_reader(hi_face)[2 - axis] > threshold
            if not strong.any():
                continue
            hi = out[hi_face][strong].astype(np.int64)
            lo = out[lo_face][strong].astype(np.int64)
            labelled = (hi > 0) & (lo > 0)
            if labelled.any():
                for a, b in np.unique(np.stack([lo[labelled], hi[labelled]], axis=-1), axis=0):
                    uf.union(int(a), int(b))
            if labelled.all():
                continue
            zz, yy, xx = np.nonzero(strong)
            first = [s.start for s in hi_face]
            v_hi = ((zz + first[0]) * strides[0] + (yy + first[1]) * strides[1] + (xx + first[2]))[~labelled]
            v_lo = v_hi - strides[axis]
            l_hi, l_lo = hi[~labelled], lo[~labelled]
            n_hi = np.where(l_hi > 0, l_hi, base + v_hi)
            n_lo = np.where(l_lo > 0, l_lo, base + v_lo)
            for nh, nl, vh, vl, lh, ll in zip(n_hi, n_lo, v_hi, v_lo, l_hi, l_lo):
                uf.union(int(nh), int(nl))
                if lh == 0:
                    lone.append((int(vh), int(nh)))
                if ll == 0:
                    lone.append((int(vl), int(nl)))

    if uf.parent:
        fresh: Dict[int, int] = {}

        def final(node: int) -> int:
            r = uf.find(node)
            if r < base:
                return r
            if r not in fresh:
                fresh[r] = base + len(fresh)  # above every chunk id: untouched by the remap
            return fresh[r]

        for voxel, node in lone:
            out.flat[voxel] = final(node)
        out = remap(out, {a: final(a) for a in list(uf.parent) if a < base})
    out, _ = renumber(out)
    if min_size:
        out, _ = remove_small(out, min_size)
        out, _ = renumber(out)
    return out


def streamed_waterz_decode(aff_reader: Reader, vol_shape: Sequence[int], chunk_size: Sequence[int],
                           threshold: float = 0.5, fragment_threshold: float = 0.9, min_size: int = 0,
                           num_workers: int = 0) -> np.ndarray:
    """waterz with connected-component fragments, chunk by chunk, in three
    passes over the reader: the fragments (:func:`streamed_affinity_cc_decode`
    at ``fragment_threshold``, equal to the whole volume's), each chunk's
    region graph (:func:`...ops.native.rag_mean_edges`, seam edges counted
    by the high side's chunk, so the chunks' graphs add up to the volume's),
    and the merges on the joined graph to ``threshold``
    (:func:`...ops.native.agglomerate_rag`, the whole-volume
    ``agglomerate``'s sequence). Equals ``decode_waterz(pred, threshold,
    fragments="cc", fragment_threshold=...)`` exactly where the affinities'
    sums do not depend on their order (values exact in float32 and float64,
    such as 8-bit quantized ones), else up to that order. Then renumbered,
    ``min_size`` applied and renumbered again."""
    frags = streamed_affinity_cc_decode(aff_reader, vol_shape, chunk_size, threshold=fragment_threshold, min_size=0,
                                        num_workers=num_workers)
    chunks = build_chunk_grid(vol_shape, chunk_size, halo=(0, 0, 0))

    def region_graph(chunk):
        below = [None, None, None]
        for axis, _, lo_face in _seam_faces(chunk):
            below[axis] = np.squeeze(frags[lo_face], axis=axis)
        return rag_mean_edges(frags[chunk.core_slices], aff_reader(chunk.core_slices), *below)

    graphs = _map_chunks(region_graph, chunks, num_workers)
    ea, eb, esum, ecnt = (np.concatenate([g[k] for g in graphs]) for k in range(4))
    out = agglomerate_rag(ea, eb, esum, ecnt, int(frags.max()), threshold)[frags]
    out, _ = renumber(out)
    if min_size:
        out, _ = remove_small(out, min_size)
        out, _ = renumber(out)
    return out
