"""Instance segmentation -> affinity map targets, the port's copy of
``pytorch_connectomics_tpu/data/targets/affinity.py`` (numpy, host side).

Offsets are ``(dz, dy, dx)`` triples; the string form is ``"dz-dy-dx"``,
with optional negative components (``"0--9-0"`` is (0, -9, 0)). An
affinity channel is 1 where the voxel and its offset neighbour share the
same nonzero instance id. ``deepem`` stores each edge at the high-end
(destination) voxel, ``banis`` at the source voxel.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple, Union

import numpy as np

Offset = Tuple[int, int, int]


# three signed integers separated by '-' or '_'
_OFFSET_RE = re.compile(r"^(-?\d+)[-_](-?\d+)[-_](-?\d+)$")


def parse_offsets(offsets: Sequence[Union[str, Sequence[int]]]) -> List[Offset]:
    """Parse offsets; string form is ``"dz-dy-dx"`` with optional negative
    components (``"0-0--1"`` -> (0, 0, -1)). Malformed strings raise (the
    reference raises on len(parts) != 3)."""
    out: List[Offset] = []
    for off in offsets:
        if isinstance(off, str):
            m = _OFFSET_RE.match(off.strip())
            if m is None:
                raise ValueError(
                    f"malformed affinity offset string {off!r}: expected "
                    "'dz-dy-dx' with three (optionally negative) integers"
                )
            out.append(tuple(int(g) for g in m.groups()))  # type: ignore[arg-type]
        else:
            vals = tuple(int(v) for v in off)
            if len(vals) > 3:
                raise ValueError(f"offset {off!r} has more than 3 components")
            out.append((0,) * (3 - len(vals)) + vals)  # type: ignore[arg-type]
    return out


def _storage_slices(seg_shape, off: Offset, affinity_mode: str):
    """(src, dst, storage) slice tuples for one offset. ``deepem`` stores the
    edge at the destination (high-end) voxel, ``banis`` at the source voxel
    (reference ``affinity.py:345-366``)."""
    src = []
    dst = []
    for d, o in enumerate(off):
        n = seg_shape[d]
        # clamp so |o| >= n yields EMPTY slices instead of negative stops
        # that wrap around and mark nonexistent neighbors as valid
        if o >= 0:
            src.append(slice(0, max(0, n - o)))
            dst.append(slice(min(o, n), n))
        else:
            src.append(slice(min(-o, n), n))
            dst.append(slice(0, max(0, n + o)))
    storage = dst if affinity_mode == "deepem" else src
    return tuple(src), tuple(dst), tuple(storage)


def seg_to_affinity(
    seg: np.ndarray,
    offsets: Sequence[Union[str, Sequence[int]]],
    affinity_mode: str = "deepem",
    dtype=np.float32,
) -> np.ndarray:
    """Compute affinity channels, one per offset; shape ``(C, Z, Y, X)``.

    ``deepem`` stores each edge at the destination (high-end) voxel, ``banis``
    at the source voxel; both require endpoints equal and the storage voxel
    nonzero (reference ``affinity.py:408``). ``seg == -1`` marks unlabeled
    voxels (never foreground); use :func:`affinity_unlabeled_mask` for the
    matching validity mask.
    """
    seg = np.asarray(seg)
    if seg.ndim == 4:
        seg = seg[0]
    if affinity_mode not in ("deepem", "banis"):
        raise ValueError(f"unknown affinity_mode {affinity_mode!r}")
    offs = parse_offsets(offsets)
    aff = np.zeros((len(offs),) + seg.shape, dtype=dtype)
    for c, off in enumerate(offs):
        if all(o == 0 for o in off):
            aff[c] = (seg > 0).astype(dtype)
            continue
        src, dst, storage = _storage_slices(seg.shape, off, affinity_mode)
        match = (seg[src] == seg[dst]) & (seg[storage] > 0)
        aff[(c,) + storage] = match.astype(dtype)
    return aff


def affinity_unlabeled_mask(
    seg: np.ndarray,
    offsets: Sequence[Union[str, Sequence[int]]],
    affinity_mode: str = "deepem",
    dtype=np.float32,
) -> np.ndarray:
    """Per-channel validity mask: edges whose BOTH endpoints are labeled
    (``seg != -1``) and lie inside the volume, stored at the mode's storage
    voxel (reference ``seg_to_affinity`` mask semantics, ``affinity.py:454``).
    Supersedes :func:`affinity_valid_mask` when the labels carry -1 ignore
    voxels."""
    seg = np.asarray(seg)
    if seg.ndim == 4:
        seg = seg[0]
    offs = parse_offsets(offsets)
    labeled = seg != -1
    mask = np.zeros((len(offs),) + seg.shape, dtype=dtype)
    for c, off in enumerate(offs):
        if all(o == 0 for o in off):
            mask[c] = labeled.astype(dtype)
            continue
        src, dst, storage = _storage_slices(seg.shape, off, affinity_mode)
        mask[(c,) + storage] = (labeled[src] & labeled[dst]).astype(dtype)
    return mask


def affinity_valid_mask(
    shape: Sequence[int],
    offsets: Sequence[Union[str, Sequence[int]]],
    dtype=np.float32,
    affinity_mode: str = "deepem",
) -> np.ndarray:
    """Per-channel mask of positions where the offset neighbor exists,
    stored at the mode's storage voxel — deepem: destination/high end,
    banis: source (reference ``affinity.py:369``)."""
    offs = parse_offsets(offsets)
    mask = np.zeros((len(offs),) + tuple(shape), dtype=dtype)
    for c, off in enumerate(offs):
        _src, _dst, storage = _storage_slices(tuple(shape), off, affinity_mode)
        mask[(c,) + storage] = 1.0
    return mask


def max_offset_pad(offsets: Sequence[Union[str, Sequence[int]]]) -> Tuple[int, int, int]:
    """Per-axis maximum |offset| — the context margin needed so long-range
    affinities at patch borders are correct (reference crop-pad math
    ``affinity.py:275-344``)."""
    offs = parse_offsets(offsets)
    return tuple(int(max(abs(o[d]) for o in offs)) for d in range(3))  # type: ignore[return-value]


def affinity_channel_groups(offsets: Sequence[Union[str, Sequence[int]]]) -> List[List[int]]:
    """Group channel indices by offset magnitude (short/mid/long range),
    used for visualization and ensemble configuration."""
    offs = parse_offsets(offsets)
    mags = [max(abs(v) for v in o) for o in offs]
    groups: dict = {}
    for i, m in enumerate(mags):
        groups.setdefault(m, []).append(i)
    return [groups[m] for m in sorted(groups)]
