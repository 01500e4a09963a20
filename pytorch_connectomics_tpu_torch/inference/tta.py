"""Test-time augmentation: the port of ``pytorch_connectomics_tpu/inference/tta.py``
for the serial variant loop.

Flip/rot90 variant enumeration with deduplication, per-channel activations,
per-channel-slice ensembling, and :class:`TTAPredictor`, which runs the
window engine once per variant. The variant transforms, activations and
the ensemble work on tensors: the predictor keeps the volume, each
variant's prediction and the ensemble on the device and copies only the
result to the host. Variant sharding across devices,
patch-local TTA and the affinity flip realignment are not ported yet and
raise ``NotImplementedError`` where a config asks for them.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.schema import TTAConfig
from ..utils.slicing import parse_slice
from .window import SlidingWindowEngine, _to_host


def enumerate_tta_variants(
    flip_axes: Union[str, List[List[int]], None] = "all",
    rotation90: bool = False,
    rotation_planes: Optional[Sequence[Sequence[int]]] = None,
    rotation_k: Optional[Sequence[int]] = None,
    transforms: Optional[Sequence[Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """Each variant: {"flip": tuple of spatial axes (0=z,1=y,2=x), "rot": k,
    "plane": rotation plane}. Compositions that act alike on an index probe
    are kept once. ``transforms`` (explicit variant dicts) replace the
    enumeration, with the identity prepended if absent."""
    if transforms is not None:
        out = [{"flip": (), "rot": 0, "plane": (1, 2)}]
        seen = {_variant_signature(out[0])}
        for t in transforms:
            extra = set(t) - {"flip", "rot", "rotation90_k", "plane"}
            if extra:
                raise ValueError(f"unknown TTA transform keys {sorted(extra)}")
            v = {
                "flip": tuple(int(a) for a in (t.get("flip") or ())),
                "rot": int(t.get("rot", t.get("rotation90_k", 0))) % 4,
                "plane": tuple(int(a) for a in (t.get("plane") or (1, 2))),
            }
            if any(a not in (0, 1, 2) for a in v["flip"]) or len(v["plane"]) != 2:
                raise ValueError(f"bad TTA transform {t}")
            sig = _variant_signature(v)
            if sig not in seen:
                seen.add(sig)
                out.append(v)
        return out
    if flip_axes in (None, False):
        flips: List[Tuple[int, ...]] = [()]
    elif flip_axes == "all":
        flips = []
        for r in range(4):
            flips.extend(itertools.combinations((0, 1, 2), r))
    elif flip_axes == "xy":
        flips = [(), (1,), (2,), (1, 2)]
    elif isinstance(flip_axes, str):
        raise ValueError(
            f"flip_axes string must be 'all' or 'xy', got {flip_axes!r} "
            "(use a list of axis combinations, e.g. [[0]] for z-flip; 0=z, 1=y, 2=x)"
        )
    else:
        flips = [tuple(int(a) for a in f) for f in ([()] + list(flip_axes))]
    if rotation_planes is not None:
        planes = [tuple(int(a) for a in p) for p in rotation_planes]
        for p in planes:
            if len(p) != 2 or not all(0 <= a <= 2 for a in p) or p[0] == p[1]:
                raise ValueError(f"rotation plane must be two distinct spatial axes, got {p}")
        rotation90 = True
    else:
        planes = [(1, 2)]
    rots = [int(k) % 4 for k in rotation_k] if rotation_k is not None else ([0, 1, 2, 3] if rotation90 else [0])
    out = []
    seen = set()
    for f in flips:
        for plane in planes:
            for k in rots:
                v = {"flip": f, "rot": k, "plane": plane}
                sig = _variant_signature(v)
                if sig in seen:
                    continue
                seen.add(sig)
                out.append(v)
    return out


def _variant_signature(v: Dict[str, Any]) -> Tuple[int, ...]:
    probe = torch.arange(64).reshape(4, 4, 4)
    return tuple(apply_variant(probe, v).flatten().tolist())


def apply_variant(vol: torch.Tensor, variant: Dict[str, Any]) -> torch.Tensor:
    """vol: (Z,Y,X[,C]) -> flips, then rot90 in the variant's plane."""
    out = torch.flip(vol, dims=tuple(variant["flip"])) if variant["flip"] else vol
    if variant["rot"]:
        out = torch.rot90(out, variant["rot"], dims=tuple(variant.get("plane", (1, 2))))
    return out.contiguous()


def invert_variant(pred: torch.Tensor, variant: Dict[str, Any]) -> torch.Tensor:
    out = pred
    if variant["rot"]:
        out = torch.rot90(out, -variant["rot"], dims=tuple(variant.get("plane", (1, 2))))
    if variant["flip"]:
        out = torch.flip(out, dims=tuple(variant["flip"]))
    return out.contiguous()


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "softmax": lambda v: torch.softmax(v, dim=-1)}


def _apply_act(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act in ("none", None, ""):
        return x
    if act not in _ACTS:
        raise ValueError(f"unknown activation '{act}'")
    return _ACTS[act](x)


def apply_channel_activations(pred: torch.Tensor, acts: Optional[Union[str, List[Any]]]) -> torch.Tensor:
    """acts: 'sigmoid' | list of {channels, activation} dicts | list of
    [slice_spec, act] pairs; channels last."""
    if acts is None:
        return pred
    out = pred.float().clone()
    if isinstance(acts, str):
        return _apply_act(out, acts)
    for entry in acts:
        if isinstance(entry, dict):
            spec, act = entry.get("channels", ":"), entry.get("activation", "none")
        else:
            spec, act = entry
        sl = parse_slice(str(spec))
        out[..., sl] = _apply_act(out[..., sl], act)
    return out


def ensemble(preds: Iterable[torch.Tensor], mode: Union[str, List[Any]] = "mean") -> torch.Tensor:
    """Per-channel-slice ensemble, e.g. ``[["0:9", "min"], ["9:", "mean"]]``,
    folded one prediction at a time (a running sum, minimum or maximum), so
    an iterator of predictions never holds more than one of them besides the
    folds."""
    need = {mode} if isinstance(mode, str) else {str(m) for _, m in mode}
    if need - {"mean", "min", "max"}:
        raise ValueError(f"unknown ensemble mode(s) {sorted(need - {'mean', 'min', 'max'})}")
    accs: Dict[str, torch.Tensor] = {}
    n = 0
    for p in preds:
        n += 1
        for m, fold in (("mean", torch.add), ("min", torch.minimum), ("max", torch.maximum)):
            if m in need:
                accs[m] = p if m not in accs else fold(accs[m], p)
    if "mean" in accs:
        accs["mean"] = accs["mean"] / n
    if isinstance(mode, str):
        return accs[mode]
    out = accs[str(mode[0][1])].clone()
    for spec, m in mode:
        sl = parse_slice(str(spec))
        out[..., sl] = accs[str(m)][..., sl]
    return out


class TTAPredictor:
    """Runs the window engine once per TTA variant and ensembles."""

    def __init__(
        self,
        engine: SlidingWindowEngine,
        tta_cfg: Optional[TTAConfig] = None,
        activations: Optional[Union[str, List[Any]]] = None,
        select_channel: Optional[List[int]] = None,
        affinity_outputs: bool = False,
    ):
        self.engine = engine
        cfg = tta_cfg or TTAConfig()
        if cfg.enabled:
            self.variants = enumerate_tta_variants(
                cfg.flip_axes or "all",
                cfg.rotation90,
                rotation_planes=cfg.rotation_planes,
                rotation_k=cfg.rotation_k,
                transforms=cfg.transforms,
            )
        else:
            self.variants = [{"flip": (), "rot": 0}]
        if cfg.patch_first_local and len(self.variants) > 1:
            raise NotImplementedError("patch-local TTA is not ported yet")
        if affinity_outputs and any(v["flip"] or v["rot"] for v in self.variants):
            raise NotImplementedError("TTA over affinity channels (flip realignment) is not ported yet")
        self.ensemble_mode = cfg.ensemble_mode
        self.activations = activations if activations is not None else cfg.act
        self.select_channel = select_channel

    @property
    def num_variants(self) -> int:
        return len(self.variants)

    def predict(self, volume: np.ndarray, out_channels: Optional[int] = None) -> np.ndarray:
        """volume (Z,Y,X[,C]) -> activated, ensembled prediction (Z,Y,X,C)
        float32. Variants run one after another on the engine's device and
        fold into the ensemble there; only the result goes to the host."""
        vol = torch.from_numpy(np.asarray(volume, dtype=np.float32)).to(self.engine.device)

        def variant_predictions():
            for variant in self.variants:
                p = self.engine.predict_tensor(apply_variant(vol, variant), out_channels)
                yield apply_channel_activations(invert_variant(p, variant), self.activations)

        out = ensemble(variant_predictions(), self.ensemble_mode)
        if self.select_channel is not None:
            out = out[..., self.select_channel]
        return _to_host(out.float())
