"""ctypes bindings for the host C++ post-processing ops the bcd decode needs
(``csrc/pytc_ops.cpp``): 3-D connected components, seeded watershed, small
instance removal and renumbering. The port's own binding of the shared
library: host code, not a GPU kernel.

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
from typing import Optional, Tuple

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
