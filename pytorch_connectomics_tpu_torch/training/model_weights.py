"""Foreign weights and UpKern, the port of
``pytorch_connectomics_tpu/training/model_weights.py:212-410``.

- :func:`load_torch_state_dict`: a torch checkpoint's state dict (its
  ``state_dict`` or ``model_state_dict`` entry where it has one) as numpy
  arrays, with key prefixes stripped (``model.``, ``module.``, ``network.``).
- :func:`load_external_weights`: fill a port model from a foreign torch
  checkpoint (BANIS, nnU-Net, a reference run) by JAX's shape-bucket
  matcher: every parameter in the flax tree's sorted path order takes the
  first unused source tensor of its shape, the sources in the file's order
  and in flax layout (``torch_conv_to_flax``: a conv (O, I, k...) ->
  (k..., I, O), a linear (O, I) -> (I, O)); with ``upkern`` a conv kernel
  without a same-shape source takes the first source of its (in, out)
  channels and smaller extent, trilinearly inflated. The matching runs on
  the flax layout of the port's parameters (``models/convert.py``'s
  entries), so a 1x1x1 conv of the source meets the port's ``nn.Linear``
  as it meets flax's 1x1x1 conv, and a transposed kernel is matched in
  flax's unflipped layout, as JAX matches it; the result is what JAX loads,
  carried through the flax -> torch bridge.
- UpKern (Roy et al., MICCAI 2023): :func:`upkern_resize_kernel` inflates a
  flax-layout kernel trilinearly (``F.interpolate``, as the reference's
  ``upkern_load_weights``); :func:`upkern_transfer` copies a small-kernel
  state dict into a large-kernel model by key (same shapes copied, 5-D
  kernels of the same channels inflated, anything else kept);
  :func:`upkern_initialize` reads ``model.mednext.upkern_from``: a port
  checkpoint directory (``state.pt`` + ``metadata.json``) is transferred by
  key, a foreign torch file goes through the matcher with ``upkern``.
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import from_flax, model_entries, to_flax
from .checkpoint import CheckpointManager, is_checkpoint_dir

logger = logging.getLogger(__name__)

DEFAULT_PREFIXES = ("model.", "module.", "network.")
TORCH_SUFFIXES = (".pt", ".pth", ".ckpt", ".pytorch")


def _numpy(value) -> np.ndarray | None:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return value if isinstance(value, np.ndarray) else None


def is_foreign(path: str | Path) -> bool:
    """A torch file named as a foreign checkpoint (``TORCH_SUFFIXES``)."""
    return str(path).endswith(TORCH_SUFFIXES)


def read_torch_checkpoint(path: str | Path, full: bool = False) -> Any:
    """``torch.load`` on the CPU by the restricted reader (tensors and
    containers). With ``full``, a foreign torch file (:func:`is_foreign`)
    that the restricted reader refuses, because it pickles other objects (a
    training run's whole checkpoint), is unpickled in full with a warning:
    that runs whatever code the file names, so name only files you trust.
    Anything else the restricted reader refuses raises."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not (full and is_foreign(path)):
            raise
        logger.warning("%s pickles more than tensors (%s); unpickling it in full, which runs the code it names",
                       path, e)
        return torch.load(path, map_location="cpu", weights_only=False)


def state_dict_arrays(ckpt: Any, strip_prefixes: Tuple[str, ...] = DEFAULT_PREFIXES) -> Dict[str, np.ndarray]:
    """The state dict of a read torch checkpoint (its ``state_dict`` or
    ``model_state_dict`` entry where it has one) as numpy arrays, file order
    kept; each prefix of ``strip_prefixes`` is stripped in turn where a key
    starts with it."""
    state = ckpt.get("state_dict", ckpt.get("model_state_dict", ckpt)) if isinstance(ckpt, dict) else ckpt
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        value = _numpy(value)
        if value is None:
            continue
        for pre in strip_prefixes:
            if key.startswith(pre):
                key = key[len(pre):]
        out[key] = value
    return out


def load_torch_state_dict(path: str | Path, strip_prefixes: Tuple[str, ...] = DEFAULT_PREFIXES
                          ) -> Dict[str, np.ndarray]:
    """:func:`state_dict_arrays` of the torch file ``path``, read by
    :func:`read_torch_checkpoint` (in full only where it is foreign)."""
    return state_dict_arrays(read_torch_checkpoint(path, full=True), strip_prefixes)


def torch_conv_to_flax(w: np.ndarray) -> np.ndarray:
    """torch conv3d (O, I, Z, Y, X) -> flax (Z, Y, X, I, O); conv2d/1d analogous."""
    if w.ndim == 5:
        return np.transpose(w, (2, 3, 4, 1, 0))
    if w.ndim == 4:
        return np.transpose(w, (2, 3, 1, 0))
    if w.ndim == 3:
        return np.transpose(w, (2, 1, 0))
    if w.ndim == 2:  # linear (O, I) -> (I, O)
        return w.T
    return w


def upkern_resize_kernel(w: np.ndarray, spatial: Tuple[int, int, int]) -> np.ndarray:
    """Trilinearly interpolate a flax conv kernel ``(z, y, x, I, O)`` to a new
    spatial extent (``F.interpolate(mode='trilinear')``)."""
    z, y, x, ci, co = w.shape
    if (z, y, x) == tuple(spatial):
        return np.asarray(w)
    t = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 4, 0, 1, 2)))).float()
    t = t.reshape(1, ci * co, z, y, x)
    t = F.interpolate(t, size=tuple(int(s) for s in spatial), mode="trilinear")
    t = t.reshape(ci, co, *spatial)
    return np.transpose(t.numpy(), (2, 3, 4, 0, 1)).astype(w.dtype)


def _load(model: torch.nn.Module, entries, new: Dict[Tuple[str, ...], np.ndarray]) -> None:
    model.load_state_dict({e.key: from_flax(e, new[e.path]) for e in entries})


def load_external_weights(
    model: torch.nn.Module,
    checkpoint: str | Path | Mapping[str, Any],
    strip_prefixes: Tuple[str, ...] = DEFAULT_PREFIXES,
    strict: bool = False,
    upkern: bool = False,
) -> Dict[str, int]:
    """Fill ``model`` in place from a foreign torch checkpoint (a path, or a
    state dict already read by :func:`load_torch_state_dict`); see the
    module doc. Returns ``{loaded, missed, inflated, unused}``: parameters
    filled, parameters left as they were, kernels inflated, source tensors
    nothing took. ``strict`` raises when any parameter was missed."""
    state = checkpoint if isinstance(checkpoint, Mapping) else load_torch_state_dict(checkpoint, strip_prefixes)
    entries = model_entries(model)
    own = model.state_dict()
    by_shape: Dict[Tuple[int, ...], List[Tuple[str, np.ndarray]]] = {}
    by_io: Dict[Tuple[int, int], List[Tuple[str, np.ndarray]]] = {}
    for k, v in state.items():
        v = torch_conv_to_flax(np.asarray(v))
        by_shape.setdefault(tuple(v.shape), []).append((k, v))
        if v.ndim == 5:
            by_io.setdefault((v.shape[3], v.shape[4]), []).append((k, v))
    new: Dict[Tuple[str, ...], np.ndarray] = {}
    loaded = inflated = missed = 0
    for e in entries:
        value = to_flax(e, own[e.key])
        bucket = by_shape.get(tuple(value.shape))
        if bucket:
            new[e.path] = bucket.pop(0)[1].astype(value.dtype)
            loaded += 1
            continue
        if upkern and value.ndim == 5:
            cands = by_io.get((value.shape[3], value.shape[4]), [])
            pick = next((c for c in cands if c[1].shape != tuple(value.shape)
                         and all(s <= t for s, t in zip(c[1].shape[:3], value.shape[:3]))), None)
            if pick is not None:
                cands.remove(pick)
                new[e.path] = upkern_resize_kernel(pick[1], value.shape[:3]).astype(value.dtype)
                inflated += 1
                continue
        new[e.path] = value
        missed += 1
    stats = {"loaded": loaded, "missed": missed, "inflated": inflated,
             "unused": sum(len(b) for b in by_shape.values())}
    if strict and missed:
        raise ValueError(f"strict load failed: {stats}")
    _load(model, entries, new)
    logger.info("external weights: %s", stats)
    return stats


def upkern_transfer(model: torch.nn.Module, source: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """Copy ``source`` (a small-kernel state dict of the same architecture)
    into ``model`` by key; see the module doc. Returns ``{copied, inflated,
    kept}``."""
    entries = model_entries(model)
    own = model.state_dict()
    new: Dict[Tuple[str, ...], np.ndarray] = {}
    copied = inflated = kept = 0
    for e in entries:
        value = to_flax(e, own[e.key])
        s = source.get(e.key)
        s = None if s is None else to_flax(e, s)
        if s is None:
            new[e.path] = value
            kept += 1
        elif s.shape == value.shape:
            new[e.path] = s.astype(value.dtype)
            copied += 1
        elif s.ndim == 5 and value.ndim == 5 and s.shape[3:] == value.shape[3:]:
            new[e.path] = upkern_resize_kernel(s, value.shape[:3]).astype(value.dtype)
            inflated += 1
        else:
            logger.warning("upkern: incompatible shapes at %s: %s vs %s", e.key, s.shape, value.shape)
            new[e.path] = value
            kept += 1
    _load(model, entries, new)
    stats = {"copied": copied, "inflated": inflated, "kept": kept}
    logger.info("upkern transfer: %s", stats)
    return stats


def upkern_initialize(model_cfg, model: torch.nn.Module) -> Dict[str, int]:
    """Initialise a large-kernel MedNeXt in place from the small-kernel run
    ``model_cfg.mednext.upkern_from``: a foreign torch file through the
    matcher with inflation, a port checkpoint directory by key. Returns the
    stats."""
    path = Path(str(model_cfg.mednext.upkern_from))
    if is_foreign(path):
        return load_external_weights(model, path, upkern=True)
    if not is_checkpoint_dir(path):
        raise FileNotFoundError(f"upkern_from {path}: no port checkpoint (state.pt) or torch file there")
    return upkern_transfer(model, CheckpointManager.load(path)["model"])
