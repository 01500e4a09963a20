"""Target generation: a label-transform config -> ``seg (C, Z, Y, X) ->
target (C', Z, Y, X)`` float32, the port of ``build_target_fn``,
``build_target_mask_fn``, ``target_channel_spans`` and
``affinity_target_groups`` in
``pytorch_connectomics_tpu/data/targets/build.py:38-253``, with
``seg_to_binary`` of ``targets/misc.py:17``.

Every target of JAX's registry (``build.py:52-120``): ``binary``,
``affinity``, ``instance_boundary``, ``instance_edt``, ``semantic_edt``,
``sdt``, ``skeleton_aware_edt``, ``lsd``, ``polarity``, ``small_object``,
``flow``, ``binary_ratio_weight`` and ``unet3d_weight``. The clean-ups run
on the segmentation before every target, in JAX's order (``:146-155``):
``normalize_labels``, ``relabel_cc``, ``erosion``, ``erosion_window``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .affinity import affinity_unlabeled_mask, parse_offsets, seg_to_affinity
from .distance import (
    erode_instances,
    instance_boundary_mask,
    instance_edt,
    seg_erosion_instance,
    semantic_edt,
    signed_distance,
    skeleton_aware_edt,
)
from .lsd import seg_to_lsd
from .misc import (
    binary_ratio_weight,
    normalize_labels,
    relabel_connected_components,
    seg_to_flow,
    seg_to_polarity,
    seg_to_small_object,
    unet3d_weight,
)

_DEFAULT_OFFSETS = ["0-0-1", "0-1-0", "1-0-0"]


def seg_to_binary(seg: np.ndarray, dtype=np.float32) -> np.ndarray:
    return (np.asarray(seg) > 0).astype(dtype)


def _binary(seg: np.ndarray, **kw) -> np.ndarray:
    b = seg_to_binary(seg)
    return b[None] if b.ndim == 3 else b


def _affinity(seg: np.ndarray, offsets=None, affinity_mode="deepem", **kw) -> np.ndarray:
    return seg_to_affinity(seg, offsets or _DEFAULT_OFFSETS, affinity_mode)


def _chan(x: np.ndarray) -> np.ndarray:
    return x[None] if x.ndim == 3 else x


def _boundary(seg: np.ndarray, thickness=1, mode="3d", edge_mode=None, **kw) -> np.ndarray:
    return _chan(instance_boundary_mask(seg, thickness, mode, edge_mode).astype(np.float32))


def _instance_edt(seg: np.ndarray, mode="3d", **kw) -> np.ndarray:
    return _chan(instance_edt(seg, mode=mode, **kw))


def _semantic_edt(seg: np.ndarray, mode="3d", **kw) -> np.ndarray:
    return _chan(semantic_edt(seg, mode=mode, **kw))


def _sdt(seg: np.ndarray, mode="3d", **kw) -> np.ndarray:
    return _chan(signed_distance(seg, mode=mode, **kw))


def _skeleton_aware_edt(seg: np.ndarray, alpha=0.8, bg_value=-1.0, **kw) -> np.ndarray:
    return _chan(skeleton_aware_edt(seg, alpha=alpha, bg_value=bg_value))


def _lsd(seg: np.ndarray, sigma=(5.0, 5.0, 5.0), **kw) -> np.ndarray:
    return seg_to_lsd(seg, sigma=sigma)


def _polarity(seg: np.ndarray, exclusive=False, **kw) -> np.ndarray:
    out = seg_to_polarity(seg, exclusive=exclusive)
    return out[None].astype(np.float32) if exclusive else out


def _small_object(seg: np.ndarray, size_threshold=1000, **kw) -> np.ndarray:
    return _chan(seg_to_small_object(seg, size_threshold))


def _flow(seg: np.ndarray, **kw) -> np.ndarray:
    return seg_to_flow(seg)


def _binary_ratio_weight(seg: np.ndarray, **kw) -> np.ndarray:
    return _chan(binary_ratio_weight(seg))


def _unet3d_weight(seg: np.ndarray, **kw) -> np.ndarray:
    return _chan(unet3d_weight(seg, **kw))


_TARGETS: Dict[str, Callable[..., np.ndarray]] = {
    "binary": _binary, "affinity": _affinity, "instance_boundary": _boundary, "instance_edt": _instance_edt,
    "semantic_edt": _semantic_edt, "sdt": _sdt, "skeleton_aware_edt": _skeleton_aware_edt, "lsd": _lsd,
    "polarity": _polarity, "small_object": _small_object, "flow": _flow,
    "binary_ratio_weight": _binary_ratio_weight, "unet3d_weight": _unet3d_weight,
}


def _unknown(name: str) -> KeyError:
    return KeyError(f"unknown target '{name}'; available: {sorted(_TARGETS)}")


def _target_kwargs(t) -> Dict[str, Any]:
    """A target's kwargs, with its extra keys joined."""
    kw = dict(t.kwargs or {})
    extra = getattr(t, "extra", None) or {}
    kw.update({k: v for k, v in extra.items() if k not in ("name", "kwargs")})
    return kw


def build_target_fn(cfg) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """Compile a ``LabelTransformConfig``; None when no target is configured
    (the label is used as it is). Targets stack in configured order."""
    if cfg is None or not cfg.targets:
        return None
    steps = []
    for t in cfg.targets:
        if t.name not in _TARGETS:
            raise _unknown(t.name)
        steps.append((_TARGETS[t.name], _target_kwargs(t)))
    window = getattr(cfg, "erosion_window", None)

    def fn(seg: np.ndarray) -> np.ndarray:
        s = np.asarray(seg)
        if s.ndim == 4:
            s = s[0]
        if cfg.normalize_labels:
            s = normalize_labels(s)
        if cfg.relabel_cc:
            s = relabel_connected_components(s)
        if cfg.erosion:
            s = erode_instances(s, cfg.erosion)
        if window is not None:
            s = seg_erosion_instance(s, window)
        return np.concatenate([f(s, **kw) for f, kw in steps], axis=0).astype(np.float32)

    return fn


def target_channel_spans(cfg) -> List[Dict[str, Any]]:
    """[{name, start, end, kwargs}] channel layout of the stacked target
    tensor: one channel per affinity offset, other targets probed on a tiny
    segmentation (their channel counts do not depend on the data)."""
    if cfg is None or not cfg.targets:
        return []
    probe = np.zeros((6, 6, 6), np.uint32)
    probe[1:3, 1:3, 1:3] = 1
    probe[4:, 4:, 4:] = 2
    spans = []
    start = 0
    for t in cfg.targets:
        kw = _target_kwargs(t)
        if t.name == "affinity":
            c = len(kw.get("offsets") or _DEFAULT_OFFSETS)
        elif t.name in _TARGETS:
            c = int(_TARGETS[t.name](probe, **kw).shape[0])
        else:
            raise _unknown(t.name)
        spans.append({"name": t.name, "start": start, "end": start + c, "kwargs": kw})
        start += c
    return spans


def build_target_mask_fn(cfg) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """``fn(raw_seg) -> (C, Z, Y, X) float32`` per-channel validity mask over
    the stacked target layout, for segmentations that carry ``-1``
    (unlabeled) voxels: an affinity edge is valid where both endpoints are
    labeled and inside the volume (at the mode's storage voxel), any other
    target channel where ``seg != -1``. None without targets."""
    spans = target_channel_spans(cfg)
    if not spans:
        return None

    def fn(seg: np.ndarray) -> np.ndarray:
        s = np.asarray(seg)
        if s.ndim == 4:
            s = s[0]
        labeled = (s != -1).astype(np.float32)
        cols = []
        for span in spans:
            if span["name"] == "affinity":
                offsets = span["kwargs"].get("offsets") or _DEFAULT_OFFSETS
                cols.append(affinity_unlabeled_mask(s, offsets, span["kwargs"].get("affinity_mode", "deepem")))
            else:
                cols.append(np.broadcast_to(labeled[None], (span["end"] - span["start"],) + s.shape))
        return np.ascontiguousarray(np.concatenate(cols, axis=0), dtype=np.float32)

    return fn


def affinity_target_groups(cfg) -> List[Dict[str, Any]]:
    """[{start, end, offsets, mode}] channel ranges of the target tensor that
    hold affinity channels, with parsed (dz, dy, dx) offsets: the map the
    loss orchestrator masks offset validity by."""
    return [
        {
            "start": span["start"],
            "end": span["end"],
            "offsets": parse_offsets(span["kwargs"].get("offsets") or _DEFAULT_OFFSETS),
            "mode": span["kwargs"].get("affinity_mode", "deepem"),
        }
        for span in target_channel_spans(cfg)
        if span["name"] == "affinity"
    ]
