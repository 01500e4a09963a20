"""Test-time shard planning, the port of
``pytorch_connectomics_tpu/runtime/sharding.py``: independent external
shards (``paths[shard::num_shards]``, no communication), per-rank volume
assignment, chunk-grid sharding of one chunked volume, and the device
count set against the volume count. Rank and world come from the
launcher's environment (``RANK``/``WORLD_SIZE`` or
``SLURM_PROCID``/``SLURM_NTASKS``). No process group is started: each
shard is a process of its own.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

_ENV_PAIRS = (("RANK", "WORLD_SIZE"), ("SLURM_PROCID", "SLURM_NTASKS"))


def detect_rank_world() -> Tuple[int, int]:
    """(rank, world) from the launcher's environment; (0, 1) without one."""
    for rank_var, world_var in _ENV_PAIRS:
        if rank_var in os.environ and world_var in os.environ:
            return int(os.environ[rank_var]), int(os.environ[world_var])
    return 0, 1


def _rank_world_from(env: Mapping[str, str]) -> Tuple[int, int]:
    """As :func:`detect_rank_world` on ``env``, a pair that does not parse
    skipped."""
    for rank_var, world_var in _ENV_PAIRS:
        if rank_var in env and world_var in env:
            try:
                return int(env[rank_var]), int(env[world_var])
            except ValueError:
                continue
    return 0, 1


def shard_paths(paths: Sequence, shard_id: Optional[int], num_shards: Optional[int]) -> List:
    """One independent shard's items, ``paths[shard_id::num_shards]``."""
    paths = list(paths)
    if shard_id is None or not num_shards or num_shards <= 1:
        return paths
    return paths[shard_id::num_shards]


def assign_volumes_to_ranks(paths: Sequence[str], rank: int, world_size: int) -> List[str]:
    """A rank's volumes, disjoint across ranks and not padded."""
    return list(paths)[rank::world_size]


def effective_devices_for_volumes(num_devices: int, num_volumes: int) -> int:
    """The devices worth using for ``num_volumes`` volumes."""
    return max(1, min(num_devices, num_volumes)) if num_volumes else num_devices


@dataclass(frozen=True)
class ShardPlan:
    """The test stage's sharding.

    ``mode``: ``"none"`` (one process, every volume), ``"independent"``
    (this process takes ``paths[shard_id::num_shards]``) or
    ``"chunk_grid"`` (one chunked volume whose chunk grid is split
    ``chunks[shard_id::num_shards]``). ``device_cap`` caps the devices for
    volume-level work; ``tta_sharding`` says whether TTA variants may be
    spread over devices; ``empty`` that this shard has nothing to do.
    """

    mode: str = "none"
    shard_id: Optional[int] = None
    num_shards: Optional[int] = None
    device_cap: Optional[int] = None
    tta_sharding: bool = True
    empty: bool = False
    notes: Tuple[str, ...] = ()


def is_chunked_raw_inference(cfg) -> bool:
    """Chunked inference, which always writes raw predictions."""
    return bool(cfg.inference.chunked.enabled)


def _count_tta_passes(cfg) -> int:
    tta = cfg.inference.test_time_augmentation
    if not tta.enabled:
        return 1
    from ..inference.tta import enumerate_tta_variants

    return max(1, len(enumerate_tta_variants(tta.flip_axes or "all", tta.rotation90,
                                             rotation_planes=getattr(tta, "rotation_planes", None),
                                             rotation_k=getattr(tta, "rotation_k", None))))


def plan_test_sharding(cfg, num_volumes: int, num_devices: int = 1,
                       env: Optional[Mapping[str, str]] = None) -> ShardPlan:
    """The test stage's :class:`ShardPlan` from the config and the
    environment (``env``, else this process's): explicit
    ``system.shard_id``/``num_shards`` win, on the chunk grid where the
    inference is chunked; else a launcher's rank and world shard a
    multi-volume run; else the devices are capped by the volumes (or, for
    one volume spread by TTA variant, by the TTA passes). TTA variant
    sharding is off for shards and for multi-volume runs."""
    notes = []
    shard_id = cfg.system.shard_id
    num_shards = cfg.system.num_shards
    if shard_id is None and num_shards and num_shards > 1:
        raise ValueError("system.num_shards>1 requires system.shard_id")
    if num_shards is not None and num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    if shard_id is not None:
        if num_shards is None:
            num_shards = 1
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id={shard_id} out of range for num_shards={num_shards}")

    explicit = shard_id is not None and (num_shards or 1) > 1
    chunked_raw = is_chunked_raw_inference(cfg)
    if explicit and chunked_raw:
        notes.append(f"chunk-grid sharding: shard {shard_id}/{num_shards} of the chunk grid, single device per process")
        return ShardPlan(mode="chunk_grid", shard_id=shard_id, num_shards=num_shards, device_cap=None,
                         tta_sharding=False, notes=tuple(notes))
    if not explicit and num_volumes > 1:
        e_rank, e_world = detect_rank_world() if env is None else _rank_world_from(env)
        if e_world > 1:
            shard_id, num_shards = e_rank, e_world
            explicit = True
            notes.append(f"independent sharding from launcher env (rank {e_rank}/{e_world})")
    if explicit:
        n_mine = len(range(shard_id, num_volumes, num_shards)) if num_volumes else 0
        empty = num_volumes > 0 and n_mine == 0
        if empty:
            notes.append(f"shard {shard_id}/{num_shards} is empty, nothing to do")
        if cfg.inference.test_time_augmentation.shard_across_devices:
            notes.append("disabling TTA variant-sharding for independent per-process shards")
        return ShardPlan(mode="independent", shard_id=shard_id, num_shards=num_shards,
                         device_cap=1 if num_shards and num_shards > 1 else None, tta_sharding=False, empty=empty,
                         notes=tuple(notes))
    tta_sharding = bool(cfg.inference.test_time_augmentation.shard_across_devices)
    if tta_sharding and num_volumes > 1:
        # devices would reduce predictions of different volumes together
        notes.append("disabling TTA variant-sharding for multi-volume test sets")
        tta_sharding = False
    device_cap = None
    if num_devices > 1 and num_volumes:
        if tta_sharding and num_volumes == 1:
            device_cap = max(1, min(num_devices, _count_tta_passes(cfg)))
            if device_cap < num_devices:
                notes.append(f"reducing devices to TTA passes: {num_devices} -> {device_cap}")
        elif not chunked_raw and num_volumes < num_devices:
            device_cap = max(1, num_volumes)
            notes.append(f"fewer volumes than devices: capping {num_devices} -> {device_cap}")
    return ShardPlan(mode="none", device_cap=device_cap, tta_sharding=tta_sharding, notes=tuple(notes))
