"""Weight bridge: a flax MedNeXt, RSUNet or MONAI U-Net (BasicUNet3D,
UNet3D, UNETR) parameter tree <-> the port's ``state_dict``.

:func:`model_entries` lists every parameter of a port model once, as
(flax path, state_dict key, layout): :func:`flax_to_state_dict` reads a flax
tree through it, and :func:`state_dict_to_flax` gives the inverse (the flax
layout of each port parameter, which the external-weight matcher of
``training/model_weights.py`` works in).

The tree is the ``params`` collection that ``pytorch_connectomics_tpu``'s
``init_model`` or a training checkpoint holds, given as a nested dict of
numpy arrays, or as an ``.npz`` whose keys are the ``/``-joined paths
(``MedNeXtBlock_0/Conv_1/kernel``). Kernel layouts:

- flax ``Conv`` kernels are DHWIO ``(kz, ky, kx, I/g, O)``; the port stores
  PyTorch's ``(O, I/g, kz, ky, kx)``, and 1x1x1 kernels as ``nn.Linear``
  weights ``(O, I)``.
- flax ``ConvTranspose`` kernels are ``(kz, ky, kx, I, O)`` and are NOT
  flipped by flax (``transpose_kernel=False``): flax correlates the dilated
  input with them as they are. The port stores them flipped, in PyTorch's
  transposed layout ``(I, O, kz, ky, kx)`` (see
  :func:`..models.layers.conv_transpose3d_same`).
- GroupNorm ``scale``/``bias`` -> ``norm.weight``/``norm.bias``.

flax names the submodules of ``MedNeXt`` by creation order: ``_Stage_0..3``
(encoder), ``MedNeXtBlock_0..3`` (down), ``_Stage_4`` (bottleneck),
``MedNeXtBlock_4..7`` (up), ``_Stage_5..8`` (decoder), plus ``stem`` and
``head`` (the refine head: ``head_up``, ``head_mix`` and ``head``), the
deep-supervision heads ``ds_head_{3,2,1}``, the hybrid's
``full_res_{enc,down,up,dec}`` blocks, or with task heads a ``head_<name>``
subtree a head in place of ``head``: its blocks ``MedNeXtBlock_n`` and its
projection ``Conv_0`` (the patchify stem's ``ConvTranspose_0``; the refine
head's ``up``, ``mix`` and ``Conv_0``). Inside a block, ``Conv_n`` counts the convs in order (depthwise,
expand, compress, residual), so in a transposed up block, whose spatial conv
is ``ConvTranspose_0``, the expand conv is ``Conv_0``. With remat
(``checkpoint_style: outside_block``) the blocks of a stage are named
``CheckpointMedNeXtBlock_n``.

flax names the submodules of ``RSUNet`` by creation order too: the stem
``ConvNormAct_0``; ``ResBlock_0..n`` (the n encoder levels, then the
bottleneck); per decoder level k, from the deepest, a top-level 1x1x1
``Conv_k`` and ``ResBlock_{n+1+k}``; and ``head``. Inside a ``ResBlock`` the
1x1x1 skip conv, when the channel count changes, is created first and is
``Conv_0``, so the second 3^3 conv is ``Conv_1`` with a skip and ``Conv_0``
without one; ``ConvNormAct_0`` holds the first conv and ``Norm_0`` the
block's last norm. Norms sit at ``.../Norm_0/GroupNorm_0/{scale,bias}``.
Deep supervision adds ``ds_head_{i}`` for the decoder levels i > 0.

The U-Nets (``models/unet3d.py``) count each class in creation order too:
``BasicUNet3D`` has ``ConvNormAct_0..9`` (two a level, the bottleneck last)
then per decoder level ``UpConv_j`` and ``ConvNormAct_{10+2j, 11+2j}``;
``UNet3D`` the stem ``ConvNormAct_0``, a ``ConvNormAct`` per strided down
conv and ``ResBlock_k`` for every residual unit in the order they run,
``UpConv_j`` per decoder level; ``UNETR`` ``patch_embed``, ``pos_embed``,
per transformer layer ``LayerNorm_{2l, 2l+1}``, ``Dense_{2l, 2l+1}`` and
``MultiHeadDotProductAttention_l`` (``query``/``key``/``value`` kernels
``(hidden, heads, head_dim)``, ``out`` ``(heads, head_dim, hidden)``), then
the decoder's ``ConvNormAct_0..8`` and ``UpConv_0..6`` in the order they
run. ``UpConv`` holds ``ConvTranspose_0``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .mednext import MedNeXt, MedNeXtBlock
from .rsunet import RSUNet
from .unet3d import UNETR, BasicUNet3D, UNet3D


def load_flax_npz(path: Union[str, Path]) -> Dict[str, Any]:
    """``.npz`` of ``/``-joined keys -> nested dict (a leading ``params/`` is
    dropped)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            if parts[0] == "params":
                parts = parts[1:]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def flatten_flax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{"a/b/kernel": array}`` (the ``.npz`` key form)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_flax(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


def conv_kernel(k) -> torch.Tensor:
    """DHWIO -> (O, I, kz, ky, kx)."""
    return _t(np.transpose(np.asarray(k), (4, 3, 0, 1, 2)))


def conv_transpose_kernel(k) -> torch.Tensor:
    """flax ConvTranspose (kz, ky, kx, I, O), unflipped -> flipped (I, O, kz, ky, kx)."""
    return _t(np.transpose(np.flip(np.asarray(k), (0, 1, 2)), (3, 4, 0, 1, 2)))


def linear_kernel(k) -> torch.Tensor:
    """1x1x1 kernel (1, 1, 1, I, O) -> nn.Linear weight (O, I)."""
    k = np.asarray(k)
    if k.shape[:3] != (1, 1, 1):
        raise ValueError(f"expected a 1x1x1 kernel, got {k.shape}")
    return _t(k[0, 0, 0].T)


class Entry(NamedTuple):
    """One parameter: its flax path, its state_dict key and its layout:
    ``conv``, ``conv_t`` (flipped transposed conv), ``linear`` (1x1x1 conv as
    ``nn.Linear``), ``dense1``/``dense2`` (flax Dense/DenseGeneral whose
    first 1 or 2 axes are inputs, flax kernel ``shape``) or ``vec`` (as it
    is; with ``shape``, flattened from it)."""
    path: Tuple[str, ...]
    key: str
    kind: str
    shape: Optional[Tuple[int, ...]] = None


def from_flax(e: Entry, a) -> torch.Tensor:
    """A flax leaf -> the port's tensor for entry ``e``."""
    a = np.asarray(a)
    if e.kind == "conv":
        return conv_kernel(a)
    if e.kind == "conv_t":
        return conv_transpose_kernel(a)
    if e.kind == "linear":
        return linear_kernel(a)
    if e.kind in ("dense1", "dense2"):
        n_in = int(np.prod(a.shape[: int(e.kind[-1])]))
        return _t(a.reshape(n_in, -1).T)
    return _t(a.reshape(-1) if e.shape is not None else a)


def to_flax(e: Entry, t: torch.Tensor) -> np.ndarray:
    """The port's tensor for entry ``e`` -> the flax leaf (float32): the
    inverse of :func:`from_flax`."""
    a = t.detach().cpu().float().numpy()
    if e.kind == "conv":
        return np.ascontiguousarray(np.transpose(a, (2, 3, 4, 1, 0)))
    if e.kind == "conv_t":
        return np.ascontiguousarray(np.flip(np.transpose(a, (2, 3, 4, 0, 1)), (0, 1, 2)))
    if e.kind == "linear":
        return np.ascontiguousarray(a.T[None, None, None])
    if e.kind in ("dense1", "dense2"):
        return np.ascontiguousarray(a.T.reshape(e.shape))
    return np.ascontiguousarray(a.reshape(e.shape) if e.shape is not None else a)


class _Entries:
    """Collects the entries of one model, flax paths as tuples."""

    def __init__(self):
        self.items: List[Entry] = []

    def add(self, path, key: str, kind: str, shape=None) -> None:
        self.items.append(Entry(tuple(path), key, kind, None if shape is None else tuple(shape)))

    def pair(self, path, key: str, kind: str, weight: str = "weight", bias: str = "bias") -> None:
        """A layer's kernel and bias: ``path/kernel`` -> ``key + weight``."""
        self.add((*path, "kernel"), key + weight, kind)
        self.add((*path, "bias"), key + bias, "vec")

    def norm(self, path, key: str) -> None:
        self.add((*path, "Norm_0", "GroupNorm_0", "scale"), key + "weight", "vec")
        self.add((*path, "Norm_0", "GroupNorm_0", "bias"), key + "bias", "vec")


def _block(e: _Entries, path, prefix: str, blk: MedNeXtBlock) -> None:
    if blk.transpose:
        spatial, pw1, pw2, res, kind = "ConvTranspose_0", "Conv_0", "Conv_1", "ConvTranspose_1", "conv_t"
    else:
        spatial, pw1, pw2, res, kind = "Conv_0", "Conv_1", "Conv_2", "Conv_3", "conv"
    e.pair((*path, spatial), prefix, kind, "conv_weight", "conv_bias")
    e.norm(path, prefix + "norm.")
    e.pair((*path, pw1), prefix + "pw1.", "linear")
    e.pair((*path, pw2), prefix + "pw2.", "linear")
    if blk.res is not None:
        e.pair((*path, res), prefix + "res.", "linear")


def _conv_norm_act(e: _Entries, path, prefix: str) -> None:
    e.pair((*path, "Conv_0"), prefix + "conv.", "conv")
    e.norm(path, prefix + "norm.")


def _res_block(e: _Entries, path, prefix: str, blk) -> None:
    second = "Conv_0"
    if blk.skip is not None:  # the skip conv was created first
        e.pair((*path, "Conv_0"), prefix + "skip.", "linear")
        second = "Conv_1"
    _conv_norm_act(e, (*path, "ConvNormAct_0"), prefix + "conv1.")
    e.pair((*path, second), prefix + "conv2.", "conv")
    e.norm(path, prefix + "norm2.")


def _rsunet(e: _Entries, model: RSUNet) -> None:
    n = len(model.enc)
    _conv_norm_act(e, ("ConvNormAct_0",), "stem.")
    for i in range(n):
        _res_block(e, (f"ResBlock_{i}",), f"enc.{i}.", model.enc[i])
    _res_block(e, (f"ResBlock_{n}",), "bottleneck.", model.bottleneck)
    for k, i in enumerate(reversed(range(n))):
        e.pair((f"Conv_{k}",), f"up.{i}.", "linear")
        _res_block(e, (f"ResBlock_{n + 1 + k}",), f"dec.{i}.", model.dec[i])
    e.pair(("head",), "head.", "linear")
    for i in model.ds_heads or {}:
        e.pair((f"ds_head_{i}",), f"ds_heads.{i}.", "linear")


def _unet(e: _Entries, model) -> None:
    e.pair(("head",), "head.", "linear")
    if isinstance(model, BasicUNet3D):
        for i in range(5):
            for j in range(2):
                _conv_norm_act(e, (f"ConvNormAct_{2 * i + j}",), f"enc.{i}.c{j}.")
        for i in range(4):
            e.pair((f"UpConv_{i}", "ConvTranspose_0"), f"up.{i}.", "conv_t", "conv_weight", "conv_bias")
            for j in range(2):
                _conv_norm_act(e, (f"ConvNormAct_{10 + 2 * i + j}",), f"dec.{i}.c{j}.")
        return
    if isinstance(model, UNet3D):
        _conv_norm_act(e, ("ConvNormAct_0",), "stem.")
        rb = iter(range(1 << 30))
        units = [("stem_units", model.stem_units)]
        for i, u in enumerate(model.down_units):
            _conv_norm_act(e, (f"ConvNormAct_{i + 1}",), f"down.{i}.")
            units.append((f"down_units.{i}", u))
        for name, u in units:
            for k, blk in enumerate(u.blocks):
                _res_block(e, (f"ResBlock_{next(rb)}",), f"{name}.blocks.{k}.", blk)
        for i, u in enumerate(model.up_units):
            e.pair((f"UpConv_{i}", "ConvTranspose_0"), f"up.{i}.", "conv_t", "conv_weight", "conv_bias")
            for k, blk in enumerate(u.blocks):
                _res_block(e, (f"ResBlock_{next(rb)}",), f"up_units.{i}.blocks.{k}.", blk)
        return
    e.pair(("patch_embed",), "patch_embed.", "conv")
    e.add(("pos_embed",), "pos_embed", "vec")
    hidden = model.hidden
    for li, layer in enumerate(model.layers):
        p = f"layers.{li}."
        for j, ln in enumerate(("ln1", "ln2")):
            e.add((f"LayerNorm_{2 * li + j}", "scale"), f"{p}{ln}.weight", "vec")
            e.add((f"LayerNorm_{2 * li + j}", "bias"), f"{p}{ln}.bias", "vec")
        heads = layer.attn.heads
        d = hidden // heads
        attn = f"MultiHeadDotProductAttention_{li}"
        for name in ("query", "key", "value"):
            e.add((attn, name, "kernel"), f"{p}attn.{name}.weight", "dense1", (hidden, heads, d))
            e.add((attn, name, "bias"), f"{p}attn.{name}.bias", "vec", (heads, d))
        e.add((attn, "out", "kernel"), f"{p}attn.out.weight", "dense2", (heads, d, hidden))
        e.add((attn, "out", "bias"), f"{p}attn.out.bias", "vec")
        for j, fc in enumerate((layer.fc1, layer.fc2)):
            e.add((f"Dense_{2 * li + j}", "kernel"), f"{p}fc{j + 1}.weight", "dense1",
                  (fc.in_features, fc.out_features))
            e.add((f"Dense_{2 * li + j}", "bias"), f"{p}fc{j + 1}.bias", "vec")
    # decoder, in the order the JAX module creates its layers
    names = ["proj.0.", "proj.1.", "proj.2.", "proj.3.", "fuse.0.", "fuse.1.", "fuse.2.", "inp.", "last."]
    for k, name in enumerate(names):
        _conv_norm_act(e, (f"ConvNormAct_{k}",), name)
    for k in range(7):
        e.pair((f"UpConv_{k}", "ConvTranspose_0"), f"up.{k}.", "conv_t", "conv_weight", "conv_bias")


def _projection(e: _Entries, owner, path_of, prefix: str) -> None:
    """The output layer of a MedNeXt or a task head (``_add_projection``);
    ``path_of(part)`` names its flax modules (part: ``""``, ``up``, ``mix``)."""
    if hasattr(owner, "mix"):
        e.pair(path_of("up"), prefix + "up_", "conv_t")
        e.pair(path_of("mix"), prefix + "mix.", "linear")
        e.pair(path_of(""), prefix + "head.", "linear")
    elif hasattr(owner, "head_weight"):
        e.pair(path_of(""), prefix, "conv_t", "head_weight", "head_bias")
    else:
        e.pair(path_of(""), prefix + "head.", "linear")


def _mednext(e: _Entries, model: MedNeXt) -> None:
    if model.patchify_stem and not model.hybrid:
        e.pair(("stem",), "", "conv", "stem_weight", "stem_bias")
    else:
        e.pair(("stem",), "stem.", "linear")
    if model.hybrid:
        for name in ("full_res_enc", "full_res_down", "full_res_up", "full_res_dec"):
            _block(e, (name,), f"{name}.", getattr(model, name))
    if model.heads is None:
        _projection(e, model, lambda part: ("head_" + part if part else "head",), "")
    for name, head in (model.heads or {}).items():
        fh = f"head_{name}"
        for i, blk in enumerate(head.blocks):
            _block(e, (fh, f"MedNeXtBlock_{i}"), f"heads.{name}.blocks.{i}.", blk)
        last = "ConvTranspose_0" if hasattr(head, "head_weight") else "Conv_0"
        _projection(e, head, lambda part: (fh, part or last), f"heads.{name}.")
    for i in model.ds_heads or {}:
        e.pair((f"ds_head_{i}",), f"ds_heads.{i}.", "linear")
    # remat stages (checkpoint_style outside_block) wrap each block as CheckpointMedNeXtBlock
    cls = "CheckpointMedNeXtBlock" if model.remat else "MedNeXtBlock"

    def stage(flax_name: str, port_name: str, st) -> None:
        for i, blk in enumerate(st.blocks):
            _block(e, (flax_name, f"{cls}_{i}"), f"{port_name}.blocks.{i}.", blk)

    for i in range(4):
        stage(f"_Stage_{i}", f"enc.{i}", model.enc[i])
        _block(e, (f"MedNeXtBlock_{i}",), f"down.{i}.", model.down[i])
        _block(e, (f"MedNeXtBlock_{4 + i}",), f"up.{i}.", model.up[i])
        stage(f"_Stage_{5 + i}", f"dec.{i}", model.dec[i])
    stage("_Stage_4", "bottleneck", model.bottleneck)


def model_entries(model: torch.nn.Module) -> List[Entry]:
    """Every parameter of a port MedNeXt, RSUNet or MONAI U-Net with its flax
    path and layout, in the flax tree's sorted key order (the order of a
    tree that went through ``jax.tree`` operations, as a trainer's params do)."""
    e = _Entries()
    if isinstance(model, RSUNet):
        _rsunet(e, model)
    elif isinstance(model, (BasicUNet3D, UNet3D, UNETR)):
        _unet(e, model)
    elif isinstance(model, MedNeXt):
        _mednext(e, model)
    else:
        raise TypeError(f"no flax bridge for {type(model).__name__}")
    return sorted(e.items, key=lambda x: x.path)


def _leaf(tree: Mapping[str, Any], path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def flax_to_state_dict(params: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """Map a flax MedNeXt, RSUNet or MONAI U-Net ``params`` tree onto
    ``model``'s state_dict keys."""
    entries = model_entries(model)
    if "params" in params and "params" not in {e.path[0] for e in entries}:
        params = params["params"]
    return {e.key: from_flax(e, _leaf(params, e.path)) for e in entries}


def state_dict_to_flax(model: torch.nn.Module, state: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict[Tuple[str, ...], np.ndarray]:
    """``{flax path: flax-layout float32 array}`` of ``model``'s parameters (or
    of ``state``, a state_dict of it), in :func:`model_entries` order."""
    state = model.state_dict() if state is None else state
    return {e.path: to_flax(e, state[e.key]) for e in model_entries(model)}


def load_flax_params(model: torch.nn.Module, params: Union[str, Path, Mapping[str, Any]]) -> MedNeXt:
    """Load a flax tree (dict or ``.npz`` path) into ``model`` in place; every
    parameter of the model must be covered and every shape must match."""
    if not isinstance(params, Mapping):
        params = load_flax_npz(params)
    sd = flax_to_state_dict(params, model)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"flax tree does not cover {missing[:5]}")
    bad = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in sd.items() if v.shape != own[k].shape]
    if bad:
        raise ValueError(f"shape mismatch (key, flax, port): {bad[:5]}")
    model.load_state_dict(sd)
    return model
