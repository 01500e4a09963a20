"""The ABISS bridge, the port of
``pytorch_connectomics_tpu/runtime/abiss_bridge.py``: export affinities as a
local neuroglancer precomputed layer in ABISS's conventions, write the
parameter file ABISS reads, and drive the external ABISS shell pipeline
(watershed -> remap -> mean-edge agglomeration -> remap) out of process.
ABISS is a C++ pipeline the user installs; ``abiss_root`` names it. Without
it the ``abiss`` decoder agglomerates in process through the port's waterz,
as the JAX package's does. Seuron provenance replay maps a recorded
segmentation's parameters onto the same entry, failing closed on any key it
does not know.

All of it is host code: numpy, tensorstore and subprocesses.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..decoding.registry import register_decoder

logger = logging.getLogger(__name__)

# each segmentation phase is a run and a remap, driven by ABISS's batch scripts
STAGES_ALL = ("watershed", "remap_watershed", "agglomerate_mean_edge", "remap_agglomeration")


def compute_top_mip(bbox_xyz: Sequence[int], chunk_size_xyz: Sequence[int]) -> int:
    """The octree depth over the chunk grid: the grid halved until one
    chunk remains."""
    dims = [max(1, math.ceil((int(bbox_xyz[i + 3]) - int(bbox_xyz[i])) / int(chunk_size_xyz[i]))) for i in range(3)]
    mip = 0
    while dims != [1, 1, 1]:
        dims = [(d + 1) // 2 for d in dims]
        mip += 1
    return mip


def validate_upload_alignment(
    bbox_xyz: Sequence[int],
    voxel_offset_xyz: Sequence[int],
    logical_chunk_size_xyz: Sequence[int],
    storage_chunk_size_xyz: Sequence[int],
) -> None:
    """Raise ``ValueError`` when ABISS's logical-chunk uploads would need
    writes not aligned to the storage chunks: ABISS writes whole logical
    chunks in parallel, so every internal chunk boundary must fall on a
    storage-chunk boundary."""
    bad: List[str] = []
    for axis, name in enumerate("xyz"):
        start, stop = int(bbox_xyz[axis]), int(bbox_xyz[axis + 3])
        logical = int(logical_chunk_size_xyz[axis])
        storage = int(storage_chunk_size_xyz[axis])
        offset = int(voxel_offset_xyz[axis])
        boundary = start + logical
        while boundary < stop:
            if (boundary - offset) % storage != 0:
                bad.append(f"{name}: boundary {boundary} not aligned to storage chunk {storage}")
                break
            boundary += logical
    if bad:
        raise ValueError(
            "ABISS logical-chunk uploads would require non-aligned writes "
            f"(logical CHUNK_SIZE={list(map(int, logical_chunk_size_xyz))}, "
            f"storage chunks={list(map(int, storage_chunk_size_xyz))}): "
            + "; ".join(bad)
            + ". Choose storage chunks that divide every internal boundary."
        )


@dataclass(frozen=True)
class StagePlan:
    """One subprocess of an ABISS run."""

    stage: str
    argv: Tuple[str, ...]
    env: Mapping[str, str]


def _copy_uri_cmd() -> str:
    """ABISS's UPLOAD_CMD/DOWNLOAD_CMD for local ``file://`` paths: the
    repository's ``scripts/copy_uri.py``, else ``cp -r``."""
    script = Path(__file__).resolve().parents[2] / "scripts" / "copy_uri.py"
    if script.exists():
        return f"{sys.executable} {script}"
    return "cp -r"


def build_param_payload(
    name: str,
    aff_path: str | Path,
    workdir: str | Path,
    bbox_xyz: Sequence[int],
    chunk_size_xyz: Sequence[int] = (256, 256, 256),
    resolution_xyz: Sequence[float] = (1.0, 1.0, 1.0),
    aff_channels: int = 3,
    ws_high: float = 0.99,
    ws_low: float = 0.01,
    ws_size: int = 200,
    ws_dust: Optional[int] = None,
    agg_threshold: float = 0.2,
    paranoid: int = 0,
    chunked_agg_output: int = 0,
) -> Dict[str, Any]:
    """The parameter payload ABISS reads; the watershed's dust threshold
    defaults to its size threshold."""
    wd = Path(workdir)
    return {
        "NAME": name,
        "AFF_PATH": str(aff_path),
        "WS_PATH": str(wd / "ws"),
        "SEG_PATH": str(wd / "seg"),
        "SCRATCH_PATH": str(wd / "scratch"),
        "CHUNKMAP_INPUT": str(wd / "chunkmap"),
        "CHUNKMAP_OUTPUT": str(wd / "chunkmap"),
        "UPLOAD_CMD": _copy_uri_cmd(),
        "DOWNLOAD_CMD": _copy_uri_cmd(),
        "AFF_RESOLUTION": [float(r) for r in resolution_xyz],
        "AFF_CHANNELS": int(aff_channels),
        "BBOX": [int(b) for b in bbox_xyz],
        "CHUNK_SIZE": [int(c) for c in chunk_size_xyz],
        "WS_HIGH_THRESHOLD": float(ws_high),
        "WS_LOW_THRESHOLD": float(ws_low),
        "WS_SIZE_THRESHOLD": int(ws_size),
        "WS_DUST_THRESHOLD": int(ws_dust if ws_dust is not None else ws_size),
        "AGG_THRESHOLD": float(agg_threshold),
        "PARANOID": int(paranoid),
        "CHUNKED_AGG_OUTPUT": int(chunked_agg_output),
    }


# stage -> (STAGE, batch script, its first argument)
_STAGE_COMMANDS = {
    "watershed": ("ws", "run_batch.sh", "ws"),
    "remap_watershed": ("ws", "remap_batch.sh", "ws"),
    "agglomerate_mean_edge": ("agg", "run_batch.sh", "me"),
    "remap_agglomeration": ("agg", "remap_batch.sh", "agg"),
}


def stage_plan(
    abiss_root: str | Path,
    stage: str,
    secrets_dir: str | Path,
    top_mip: int,
    root_tag: str = "run",
    overlap: str = "0",
    meta: str = "",
    extra_env: Optional[Mapping[str, str]] = None,
) -> StagePlan:
    """The subprocess of one stage: ``bash <abiss_root>/scripts/<batch
    script> <kind> <top_mip> <root_tag>`` under this process's environment
    with ``extra_env``, ABISS's variables, and this Python's directory first
    on ``PATH``."""
    if stage not in _STAGE_COMMANDS:
        raise ValueError(f"Unknown ABISS stage: {stage}")
    root = Path(abiss_root)
    env = dict(os.environ)
    if extra_env:
        env.update({str(k): str(v) for k, v in extra_env.items()})
    env.update({"WORKER_HOME": str(root), "SECRETS": str(secrets_dir), "OVERLAP": str(overlap), "META": str(meta)})
    bin_dir = str(Path(sys.executable).resolve().parent)
    env["PATH"] = bin_dir + (os.pathsep + env["PATH"] if env.get("PATH") else "")
    env["STAGE"], script, kind = _STAGE_COMMANDS[stage]
    argv = ("bash", str(root / "scripts" / script), kind, str(top_mip), root_tag)
    return StagePlan(stage=stage, argv=argv, env=env)


def export_affinity_for_abiss(
    aff: np.ndarray,
    output_dir: str | Path,
    resolution: Sequence[float] = (1.0, 1.0, 1.0),
    chunk_size: Sequence[int] = (64, 64, 64),
) -> Path:
    """Write (3, Z, Y, X) affinities as an ABISS-convention precomputed
    layer ``<output_dir>/aff``; ``resolution`` and ``chunk_size`` z, y, x."""
    from ..data.precomputed import abiss_affinity_convention, create_precomputed

    out = Path(output_dir) / "aff"
    conv = abiss_affinity_convention(np.asarray(aff, np.float32))
    vol = create_precomputed(out, conv.shape[1:], np.float32, chunk_size, resolution, num_channels=3)
    vol.write(tuple(slice(0, n) for n in conv.shape[1:]), conv)
    return out


def prepare_abiss_run(
    aff: np.ndarray,
    workdir: str | Path,
    name: str = "chunk",
    chunk_size_xyz: Sequence[int] = (256, 256, 256),
    resolution_xyz: Sequence[float] = (1.0, 1.0, 1.0),
    storage_chunk_size_xyz: Optional[Sequence[int]] = None,
    **param_kw,
) -> Tuple[Dict[str, Any], Path, int]:
    """Check the chunk alignment, export the affinities, write the
    parameter file ABISS reads from ``SECRETS/param`` and make the scratch
    and output directories. Returns ``(payload, secrets_dir, top_mip)``."""
    wd = Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    aff = np.asarray(aff, np.float32)
    z, y, x = aff.shape[1:]
    bbox_xyz = [0, 0, 0, x, y, z]
    storage = list(storage_chunk_size_xyz or chunk_size_xyz)
    validate_upload_alignment(bbox_xyz, bbox_xyz[:3], chunk_size_xyz, storage)
    aff_path = export_affinity_for_abiss(aff, wd, resolution=resolution_xyz[::-1])
    payload = build_param_payload(name, aff_path, wd, bbox_xyz, chunk_size_xyz=chunk_size_xyz,
                                  resolution_xyz=resolution_xyz, aff_channels=aff.shape[0], **param_kw)
    for key in ("WS_PATH", "SEG_PATH", "SCRATCH_PATH", "CHUNKMAP_OUTPUT"):
        Path(payload[key]).mkdir(parents=True, exist_ok=True)
    secrets = wd / "secrets"
    secrets.mkdir(parents=True, exist_ok=True)
    (secrets / "param").write_text(json.dumps(payload, indent=2))
    return payload, secrets, compute_top_mip(bbox_xyz, chunk_size_xyz)


def run_abiss_stages(
    abiss_root: str | Path,
    secrets_dir: str | Path,
    top_mip: int = 0,
    stages: Sequence[str] = STAGES_ALL,
    root_tag: str = "run",
    extra_env: Optional[Mapping[str, str]] = None,
) -> List[StagePlan]:
    """Run ABISS's batch stages in turn, each to its end (a failed stage
    raises ``CalledProcessError``); returns the plans run. Raises
    ``FileNotFoundError`` where ``abiss_root`` holds no ABISS."""
    root = Path(abiss_root)
    if not (root / "scripts" / "run_batch.sh").exists():
        raise FileNotFoundError(
            f"ABISS installation not found at {root}; clone seung-lab/abiss and "
            "pass its path as decoding.steps[abiss].kwargs.abiss_root"
        )
    plans = []
    for stage in stages:
        plan = stage_plan(root, stage, secrets_dir, top_mip, root_tag=root_tag, extra_env=extra_env)
        plans.append(plan)
        logger.info("ABISS stage %s: %s", stage, " ".join(plan.argv))
        subprocess.run(list(plan.argv), check=True, env=dict(plan.env))
    return plans


def decode_abiss(
    pred,
    abiss_root: Optional[str] = None,
    workdir: str = "abiss_work",
    agg_threshold: float = 0.2,
    fallback: bool = True,
    ws_size: int = 0,
    chunk_size_xyz: Optional[Tuple[int, int, int]] = None,
    **kw,
):
    """The ``abiss`` decoder: affinities -> ABISS's segmentation (uint32).
    Without ``abiss_root`` it agglomerates in process through the port's
    waterz (``threshold=agg_threshold``, ``min_size=ws_size``), unless
    ``fallback`` is off. Other keywords go into the ABISS param file."""
    aff = np.asarray(pred, np.float32)
    if aff.ndim == 3:
        aff = aff[None].repeat(3, axis=0)
    if abiss_root is None:
        if not fallback:
            raise ValueError("abiss decoder requires abiss_root")
        from ..decoding.decoders import decode_waterz

        logger.info("abiss_root not set: falling back to native agglomeration")
        return decode_waterz(aff, threshold=agg_threshold, min_size=int(ws_size))
    shape = aff.shape[1:]
    chunk = chunk_size_xyz or (shape[2], shape[1], shape[0])
    payload, secrets, top_mip = prepare_abiss_run(aff, workdir, chunk_size_xyz=chunk, agg_threshold=agg_threshold,
                                                  **kw)
    run_abiss_stages(abiss_root, secrets, top_mip)
    from ..data.precomputed import open_precomputed

    return open_precomputed(payload["SEG_PATH"]).read(tuple(slice(0, s) for s in shape)).astype(np.uint32)


# the rest of **kw goes into the ABISS param file as it is: a real free-form
# surface, which the kwarg validation must not reject
decode_abiss.__free_kwargs__ = True
register_decoder("abiss")(decode_abiss)

# Seuron provenance replay: every key of a recorded segmentation block must
# be one of these classes, or the replay refuses it
SEURON_REQUIRED = (
    "AFF_PATH", "AFF_MIP", "AFF_RESOLUTION", "BBOX", "CHUNK_SIZE", "AGG_THRESHOLD", "WS_HIGH_THRESHOLD",
    "WS_LOW_THRESHOLD", "WS_SIZE_THRESHOLD", "WS_DUST_THRESHOLD",
)
SEURON_OPTIONAL = ("IMAGE_PATH",)
SEURON_GENERATED = (
    "NAME", "WS_PATH", "WS_PREFIX", "SEG_PATH", "SEG_PREFIX", "SCRATCH_PATH", "SCRATCH_PREFIX", "CHUNKMAP_OUTPUT",
    "NG_PREFIX",
)
SEURON_INFRA = (
    "WORKER_IMAGE", "REDIS_SERVER", "REDIS_DB", "STATSD_HOST", "STATSD_PORT", "MOUNT_PATH", "WORKSPACE_PATH",
    "SKIP_SKELETON",
)
_SEURON_SEG_MARKERS = frozenset(
    {"AGG_THRESHOLD", "WS_HIGH_THRESHOLD", "WS_LOW_THRESHOLD", "WS_SIZE_THRESHOLD", "WS_DUST_THRESHOLD"}
)


def load_seuron_provenance(path: str | Path) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """A Seuron provenance JSON -> (its one ABISS segmentation block, the
    other (igneous) blocks)."""
    rec = json.loads(Path(path).read_text())
    if not isinstance(rec, dict) or not isinstance(rec.get("processing"), list):
        raise ValueError(f"Provenance {path} must contain a processing list")
    seg, igneous = [], []
    for i, block in enumerate(rec["processing"]):
        method = block.get("method") if isinstance(block, dict) else None
        if not isinstance(method, dict):
            raise ValueError(f"processing[{i}].method must be an object")
        (seg if set(method) & _SEURON_SEG_MARKERS else igneous).append(dict(method))
    if len(seg) != 1:
        raise ValueError(f"Expected exactly one ABISS segmentation block, found {len(seg)}")
    return seg[0], igneous


def replay_seuron_provenance(
    provenance_path: str | Path,
    workdir: str = "seuron_replay",
    name: str = "replay",
    aff_override: Optional[str] = None,
) -> Dict[str, Any]:
    """A recorded Seuron segmentation as a local ABISS param payload in a
    fresh namespace ``<workdir>/<name>``: the required and optional keys
    kept, the generated ones made anew, the infrastructure ones dropped,
    and any other key refused."""
    seg_block, _ = load_seuron_provenance(provenance_path)
    known = set(SEURON_REQUIRED) | set(SEURON_OPTIONAL) | set(SEURON_GENERATED) | set(SEURON_INFRA)
    unknown = set(seg_block) - known
    if unknown:
        raise ValueError(f"Unknown Seuron segmentation keys: {sorted(unknown)}")
    missing = set(SEURON_REQUIRED) - set(seg_block)
    if missing:
        raise ValueError(f"Missing required Seuron segmentation keys: {sorted(missing)}")
    if not name or Path(name).name != name or name in {".", ".."}:
        raise ValueError(f"Replay name must be a plain path component, got {name!r}")
    run_root = Path(workdir).expanduser().resolve() / name
    pre = run_root / "precomputed"
    scratch = run_root / "scratch" / name
    param: Dict[str, Any] = {k: seg_block[k] for k in SEURON_REQUIRED}
    param.update({k: seg_block[k] for k in SEURON_OPTIONAL if k in seg_block})
    if aff_override is not None:
        param["AFF_PATH"] = str(aff_override)
    param.update({
        "NAME": name,
        "WS_PATH": str(pre / "ws" / name),
        "WS_PREFIX": str(pre / "ws") + "/",
        "SEG_PATH": str(pre / "seg" / name),
        "SEG_PREFIX": str(pre / "seg") + "/",
        "SCRATCH_PATH": str(scratch),
        "SCRATCH_PREFIX": str(run_root / "scratch") + "/",
        # the agglomeration stages find the watershed's chunkmap here
        "CHUNKMAP_OUTPUT": str(scratch / "ws" / "chunkmap"),
        "NG_PREFIX": str(pre) + "/",
    })
    return param
