"""ctypes bindings for the host C++ post-processing ops the decoders need
(``csrc/pytc_ops.cpp``): 3-D connected components, seeded watershed, small
instance removal, renumbering and remapping (the bcd decode and
post-processing), affinity connected components, mean-affinity
agglomeration (one threshold or many in one pass, or on a prebuilt region
graph: the streamed decode) and the mutex watershed (the affinity
decoders), 6-connected binary erosion and dilation (the branch suite), the
multi-label distance transform (``edt``, the watershed split), the TEASAR skeleton (NERL's ground-truth skeletons) and MALIS's maximin pair
counts (``malis_counts``, the MALIS loss's weights). The port's own
binding of the shared library: host code, not a GPU kernel.

The library is compiled with ``g++`` on first use into ``build/native/`` at
the repository root, named by a hash of its source and flags, so an edited
source is rebuilt and an unchanged one loaded as it is; ``csrc/`` is only
read. A failed build raises: there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "pytc_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpytc_ops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raises with the compiler
    output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native ops build failed (g++ exited {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.ccl3d.restype = i64
            lib.ccl3d.argtypes = [u8p, i64, i64, i64, ctypes.c_int, u32p]
            lib.watershed_seeded.restype = None
            lib.watershed_seeded.argtypes = [f32p, u32p, ctypes.c_void_p, i64, i64, i64, u32p]
            lib.dust_u32.restype = i64
            lib.dust_u32.argtypes = [u32p, i64, i64]
            lib.renumber_u32.restype = i64
            lib.renumber_u32.argtypes = [u32p, i64]
            lib.affinity_cc.restype = i64
            lib.affinity_cc.argtypes = [f32p, i64, i64, i64, ctypes.c_float, u32p]
            lib.agglomerate_mean.restype = i64
            lib.agglomerate_mean.argtypes = [u32p, f32p, i64, i64, i64, ctypes.c_float, u32p]
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.agglomerate_mean_multi.restype = i64
            lib.agglomerate_mean_multi.argtypes = [u32p, f32p, i64, i64, i64, f32p, i64, u32p, i64p]
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.mutex_watershed.restype = i64
            lib.mutex_watershed.argtypes = [f32p, i32p, i64, i64, i64, i64, u32p]
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            d = ctypes.c_double
            lib.teasar_skeleton.restype = i64
            lib.teasar_skeleton.argtypes = [u8p, f32p, i64, i64, i64, d, d, d, d, d, d, i64, f64p, i64p, i64, i64,
                                            ctypes.POINTER(i64)]
            lib.malis_counts.restype = None
            lib.malis_counts.argtypes = [f32p, u32p, i64, i64, i64, ctypes.c_int, f32p]
            lib.remap_u32.restype = None
            lib.remap_u32.argtypes = [u32p, i64, u32p, u32p, i64]
            vp = ctypes.c_void_p
            lib.rag_mean_edges.restype = i64
            lib.rag_mean_edges.argtypes = [u32p, f32p, i64, i64, i64, vp, vp, vp, u32p, u32p, f64p, i64p, i64]
            lib.agglomerate_rag.restype = i64
            lib.agglomerate_rag.argtypes = [u32p, u32p, f64p, i64p, i64, ctypes.c_uint32, ctypes.c_float, u32p]
            lib.binary_morph.restype = None
            lib.binary_morph.argtypes = [u8p, i64, i64, i64, ctypes.c_int, ctypes.c_int, u8p]
            f = ctypes.c_float
            lib.edt_multilabel.restype = None
            lib.edt_multilabel.argtypes = [u32p, i64, i64, i64, f, f, f, f32p]
            _lib = lib
        return _lib


def connected_components(fg: np.ndarray, connectivity: int = 6) -> Tuple[np.ndarray, int]:
    """3-D connected components of a boolean/uint8 mask -> (labels uint32,
    count); ``connectivity`` 6, 18 or 26."""
    fg = np.ascontiguousarray(fg, dtype=np.uint8)
    out = np.empty(fg.shape, np.uint32)
    n = get_lib().ccl3d(fg, *fg.shape, int(connectivity), out)
    return out, int(n)


def watershed(energy: np.ndarray, seeds: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Seeded watershed flooding ``energy`` upwards from ``seeds`` within
    ``mask`` (6-connectivity)."""
    energy = np.ascontiguousarray(energy, dtype=np.float32)
    seeds = np.ascontiguousarray(seeds, dtype=np.uint32)
    m = None if mask is None else np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty(energy.shape, np.uint32)
    get_lib().watershed_seeded(energy, seeds, None if m is None else m.ctypes.data, *energy.shape, out)
    return out


def remove_small(labels: np.ndarray, min_size: int) -> Tuple[np.ndarray, int]:
    """Zero the instances of fewer than ``min_size`` voxels -> (labels,
    instances kept)."""
    labels = np.array(labels, dtype=np.uint32, order="C", copy=True)
    if min_size <= 1:
        return labels, int((np.unique(labels) > 0).sum())
    kept = get_lib().dust_u32(labels, labels.size, int(min_size))
    return labels, int(kept)


def renumber(labels: np.ndarray) -> Tuple[np.ndarray, int]:
    """Contiguous ids 1..K in order of first appearance, 0 kept -> (labels, K)."""
    labels = np.array(labels, dtype=np.uint32, order="C", copy=True)
    n = get_lib().renumber_u32(labels, labels.size)
    return labels, int(n)


def remap(labels: np.ndarray, mapping: Dict[int, int]) -> np.ndarray:
    """A copy of ``labels`` (as uint32) with each id in ``mapping``'s keys
    replaced by its value; other ids unchanged."""
    out = np.array(labels, dtype=np.uint32, order="C", copy=True)
    if mapping:
        keys = np.fromiter(mapping.keys(), np.uint32, len(mapping))
        vals = np.fromiter(mapping.values(), np.uint32, len(mapping))
        get_lib().remap_u32(out, out.size, keys, vals, len(mapping))
    return out


def _morph(mask: np.ndarray, iterations: int, dilate: bool) -> np.ndarray:
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty(m.shape, np.uint8)
    get_lib().binary_morph(m, *m.shape, int(iterations), int(dilate), out)
    return out.astype(bool)


def edt(labels: np.ndarray, anisotropy: Sequence[float] = (1.0, 1.0, 1.0)) -> np.ndarray:
    """Multi-label Euclidean distance transform: each voxel's distance to
    the nearest voxel of another label (float32; the volume's edges are
    open)."""
    labels = np.ascontiguousarray(labels, dtype=np.uint32)
    out = np.empty(labels.shape, np.float32)
    get_lib().edt_multilabel(labels, *labels.shape, *(float(a) for a in anisotropy), out)
    return out


def binary_erosion(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """6-connected erosion of a (Z, Y, X) mask, ``iterations`` times; the
    volume's outside counts as background."""
    return _morph(mask, iterations, dilate=False)


def binary_dilation(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """6-connected dilation of a (Z, Y, X) mask, ``iterations`` times."""
    return _morph(mask, iterations, dilate=True)


def _cardinal_affinities(aff: np.ndarray) -> np.ndarray:
    """The first three channels of a (C, Z, Y, X) map, the x, y and z
    nearest-neighbour affinities stored at the high-end voxel (offsets
    0-0-1, 0-1-0, 1-0-0), as contiguous float32; fewer channels raise."""
    aff = np.asarray(aff)
    if aff.ndim != 4 or aff.shape[0] < 3:
        raise ValueError(f"expected (C >= 3, Z, Y, X) affinities, got shape {aff.shape}")
    return np.ascontiguousarray(aff[:3], dtype=np.float32)


def affinity_connected_components(aff: np.ndarray, threshold: float = 0.5) -> Tuple[np.ndarray, int]:
    """Connected components over the edges of the three cardinal affinity
    channels above ``threshold`` -> (labels uint32, count); a voxel that
    touches no such edge stays background."""
    aff = _cardinal_affinities(aff)
    out = np.empty(aff.shape[1:], np.uint32)
    n = get_lib().affinity_cc(aff, *aff.shape[1:], float(threshold), out)
    return out, int(n)


def _fragments_for(fragments: np.ndarray, aff: np.ndarray) -> np.ndarray:
    fragments = np.ascontiguousarray(fragments, dtype=np.uint32)
    if fragments.shape != aff.shape[1:]:
        raise ValueError(f"fragments {fragments.shape} do not match affinities {aff.shape[1:]}")
    return fragments


def agglomerate(fragments: np.ndarray, aff: np.ndarray, threshold: float = 0.5) -> Tuple[np.ndarray, int]:
    """waterz-style agglomeration: fragments merged in order of the mean
    affinity of their shared edges while it is at least ``threshold`` ->
    (labels uint32, count)."""
    aff = _cardinal_affinities(aff)
    fragments = _fragments_for(fragments, aff)
    out = np.empty(fragments.shape, np.uint32)
    n = get_lib().agglomerate_mean(fragments, aff, *fragments.shape, float(threshold), out)
    return out, int(n)


def agglomerate_multi(
    fragments: np.ndarray, aff: np.ndarray, thresholds: Sequence[float]
) -> Dict[float, Tuple[np.ndarray, int]]:
    """:func:`agglomerate` at every threshold in one region graph and one
    merge pass -> {threshold: (labels, count)} in the caller's order."""
    aff = _cardinal_affinities(aff)
    fragments = _fragments_for(fragments, aff)
    thr = sorted(set(float(t) for t in thresholds), reverse=True)
    out = np.empty((len(thr),) + fragments.shape, np.uint32)
    counts = np.zeros(len(thr), np.int64)
    get_lib().agglomerate_mean_multi(fragments, aff, *fragments.shape, np.asarray(thr, np.float32), len(thr), out,
                                     counts)
    by_thr = {t: (out[i], int(counts[i])) for i, t in enumerate(thr)}
    return {float(t): by_thr[float(t)] for t in thresholds}


def rag_mean_edges(
    labels: np.ndarray,
    aff: np.ndarray,
    lz: Optional[np.ndarray] = None,
    ly: Optional[np.ndarray] = None,
    lx: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The region graph of a chunk of fragments: for each pair of touching
    fragments (a < b) the sum and count of the affinities on their shared
    edges -> (a uint32, b uint32, sum float64, count int64). Each edge
    belongs to its high-end voxel, so the chunks of a grid split the
    volume's edges exactly; ``lz``/``ly``/``lx`` are the fragment planes
    just below the chunk's low z/y/x faces ((Y, X), (Z, X), (Z, Y); None on
    the volume's faces). Concatenated over a grid's chunks they give
    :func:`agglomerate_rag` the whole volume's graph."""
    labels = np.ascontiguousarray(labels, dtype=np.uint32)
    aff = _cardinal_affinities(aff)
    planes = [None if p is None else np.ascontiguousarray(p, dtype=np.uint32) for p in (lz, ly, lx)]
    ptrs = [None if p is None else p.ctypes.data for p in planes]
    cap = 65536
    while True:
        ea, eb = np.empty(cap, np.uint32), np.empty(cap, np.uint32)
        esum, ecnt = np.empty(cap, np.float64), np.empty(cap, np.int64)
        n = get_lib().rag_mean_edges(labels, aff, *labels.shape, *ptrs, ea, eb, esum, ecnt, cap)
        if n >= 0:
            return ea[:n], eb[:n], esum[:n], ecnt[:n]
        cap = int(-n)  # the edge count the library needs


def agglomerate_rag(
    ea: np.ndarray, eb: np.ndarray, esum: np.ndarray, ecnt: np.ndarray, max_label: int, threshold: float
) -> np.ndarray:
    """:func:`agglomerate`'s merges on a region graph given as edge rows
    (rows of one pair are added up) -> ``mapping`` (max_label + 1,) uint32,
    each fragment's surviving root (``mapping[0] == 0``)."""
    ea = np.ascontiguousarray(ea, dtype=np.uint32)
    eb = np.ascontiguousarray(eb, dtype=np.uint32)
    esum = np.ascontiguousarray(esum, dtype=np.float64)
    ecnt = np.ascontiguousarray(ecnt, dtype=np.int64)
    mapping = np.empty(int(max_label) + 1, np.uint32)
    get_lib().agglomerate_rag(ea, eb, esum, ecnt, len(ea), int(max_label), float(threshold), mapping)
    return mapping


def mutex_watershed(aff: np.ndarray, offsets: Sequence[Sequence[int]]) -> Tuple[np.ndarray, int]:
    """Mutex watershed over (K, Z, Y, X) affinities, channel k for offset
    ``offsets[k]`` (dz, dy, dx): nearest-neighbour channels attract,
    long-range ones repel -> (labels uint32, count)."""
    aff = np.ascontiguousarray(aff, dtype=np.float32)
    offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32))
    if aff.ndim != 4 or offs.shape != (aff.shape[0], 3):
        raise ValueError(f"expected (K, Z, Y, X) affinities and (K, 3) offsets, got {aff.shape} and {offs.shape}")
    out = np.empty(aff.shape[1:], np.uint32)
    n = get_lib().mutex_watershed(aff, offs, *aff.shape, out)
    return out, int(n)


def teasar_skeleton(
    mask: np.ndarray,
    anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
    scale: float = 1.5,
    const_r: float = 2.0,
    penalty_scale: float = 5000.0,
    max_paths: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """TEASAR centreline skeleton of one binary instance (rolling-ball
    invalidation, boundary-penalised Dijkstra paths) -> (nodes (N, 3)
    float64 z, y, x voxel coordinates, edges (M, 2) int64)."""
    from scipy import ndimage

    # a one-voxel zero border: the boundary distance must see background
    # even where the mask fills its box
    m = np.pad(np.ascontiguousarray(mask, dtype=np.uint8), 1)
    dbf = np.ascontiguousarray(ndimage.distance_transform_edt(m, sampling=anisotropy).astype(np.float32))
    cap = int(m.sum()) + 1
    nodes = np.empty((cap, 3), np.float64)
    edges = np.empty((cap, 2), np.int64)
    n_edges = ctypes.c_int64(0)
    az, ay, ax = (float(a) for a in anisotropy)
    n = get_lib().teasar_skeleton(m, dbf, *m.shape, az, ay, ax, float(scale), float(const_r), float(penalty_scale),
                                  int(max_paths), nodes, edges, cap, cap, ctypes.byref(n_edges))
    if n < 0:
        raise RuntimeError("teasar_skeleton: output capacity exceeded")
    return nodes[:n] - 1.0, edges[: n_edges.value].copy()


def malis_counts(aff: np.ndarray, seg: np.ndarray, count_pos: bool) -> np.ndarray:
    """MALIS's pair counts of each edge (``csrc/pytc_ops.cpp:832``): ``aff``
    (3, Z, Y, X) float32 cardinal affinities (x, y, z, each stored at its
    high-end voxel), ``seg`` (Z, Y, X) ids; each edge's count of the voxel
    pairs (of nonzero ids) whose maximin edge it is, over equal ids
    (``count_pos``) or over different ones."""
    aff = np.ascontiguousarray(aff, dtype=np.float32)
    seg = np.ascontiguousarray(seg, dtype=np.uint32)
    out = np.zeros_like(aff)
    get_lib().malis_counts(aff, seg, *seg.shape, int(count_pos), out)
    return out
