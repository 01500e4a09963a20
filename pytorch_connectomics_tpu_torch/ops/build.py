"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library with a
plain C interface, which :mod:`ctypes` loads. The library is built on first
use into ``build/kernels/`` at the repository root, named by a hash of its
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# one entry per library: its sources (the first is compiled, the rest are
# headers it includes and only enter the content hash)
LIBRARIES: Dict[str, List[str]] = {
    "mednext_block": ["mednext_block.cu", "ring.cuh", "mednext_block.cuh"],
    "depthwise3x3": ["depthwise3x3.cu", "ring.cuh", "mednext_block.cuh"],
    "conv3d_3x3": ["conv3d_3x3.cu", "mednext_block.cuh"],
    "fused_mlp": ["fused_mlp.cu", "mednext_block.cuh"],
    "probes": ["probes.cu", "mednext_block.cuh"],
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compiler report (ptxas registers/spills) of the last build, per library
build_log: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile_cmd(name: str, out: Path) -> List[str]:
    return [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out), str(CSRC / LIBRARIES[name][0])]


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Path]:
    """Compile the named libraries (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns their
    paths; raises with the compiler output when a build fails."""
    names = list(names or LIBRARIES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n in names:
        if paths[n].exists():
            continue
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            _compile_cmd(n, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. Once loaded it is
    returned without taking the lock."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _declare(name, lib)
            _loaded[name] = lib
        return lib


def stream(index: int) -> int:
    """The raw handle of the current CUDA stream of device ``index``
    (``Tensor.get_device()``), without building a torch.cuda.Stream object.
    Only a CUDA build of torch has the call, so it is looked up here."""
    return torch._C._cuda_getCurrentRawStream(index)


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    if name == "mednext_block":
        lib.mednext_ring_plan.argtypes = [i] * 15 + [p]
        lib.mednext_ring_plan.restype = i
        lib.mednext_dw_stats.argtypes = [p] * 4 + [i] * 11 + [p]
        lib.mednext_dw_stats.restype = i
        lib.mednext_apply_bf16.argtypes = [p] * 10 + [i] * 13 + [f, p]
        lib.mednext_apply_bf16.restype = i
        lib.mednext_block_apply_f32.argtypes = [p] * 10 + [i] * 7 + [f, p]
        lib.mednext_block_apply_f32.restype = i
        lib.mednext_error_string.argtypes = [i]
        lib.mednext_error_string.restype = ctypes.c_char_p
    elif name == "depthwise3x3":
        lib.depthwise3x3_plan.argtypes = [i] * 11 + [p]
        lib.depthwise3x3_plan.restype = i
        lib.depthwise3x3_fwd.argtypes = [p] * 4 + [i] * 12 + [p]
        lib.depthwise3x3_fwd.restype = i
        lib.depthwise3x3_wgrad.argtypes = [p] * 4 + [i] * 11 + [p]
        lib.depthwise3x3_wgrad.restype = i
        lib.depthwise3x3_error_string.argtypes = [i]
        lib.depthwise3x3_error_string.restype = ctypes.c_char_p
    elif name == "conv3d_3x3":
        lib.conv3d_3x3_weight_rows.argtypes = [i, i]
        lib.conv3d_3x3_weight_rows.restype = i
        lib.conv3d_3x3_plan.argtypes = [i] * 7 + [p]
        lib.conv3d_3x3_plan.restype = i
        lib.conv3d_3x3_fwd.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
        lib.conv3d_3x3_fwd.restype = i
        lib.conv3d_3x3_wgrad_plan.argtypes = [i] * 7 + [p, p]
        lib.conv3d_3x3_wgrad_plan.restype = i
        lib.conv3d_3x3_wgrad.argtypes = [p, p, p, q, p] + [i] * 8 + [p, p]
        lib.conv3d_3x3_wgrad.restype = i
        lib.conv3d_3x3_error_string.argtypes = [i]
        lib.conv3d_3x3_error_string.restype = ctypes.c_char_p
    elif name == "fused_mlp":
        ip = ctypes.POINTER(i)
        lib.fused_mlp_plan_fields.argtypes = []
        lib.fused_mlp_plan_fields.restype = i
        lib.fused_mlp_fwd.argtypes = [p] * 6 + [ip, q, p]
        lib.fused_mlp_fwd.restype = i
        lib.fused_mlp_plan.argtypes = [ip, q, ip]
        lib.fused_mlp_plan.restype = i
        lib.pointwise_fwd.argtypes = [p, p, p, i, q, i, i, p]
        lib.pointwise_fwd.restype = i
        lib.fused_mlp_error_string.argtypes = [i]
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
    elif name == "probes":
        lib.probes_fma_chain.argtypes = [p, p, p, i, q, i, p]
        lib.probes_fma_chain.restype = i
        lib.probes_fma27.argtypes = [p, p, p, i, q, p]
        lib.probes_fma27.restype = i
        lib.probes_lane_shift.argtypes = [p, p, i, q, i, i, i, p]
        lib.probes_lane_shift.restype = i
        lib.probes_error_string.argtypes = [i]
        lib.probes_error_string.restype = ctypes.c_char_p
