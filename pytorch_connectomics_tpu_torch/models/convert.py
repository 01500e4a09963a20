"""Weight bridge: a flax MedNeXt, RSUNet or MONAI U-Net (BasicUNet3D,
UNet3D, UNETR) parameter tree -> the port's ``state_dict``.

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
``head``, or with task heads a ``head_<name>`` subtree a head in place of
``head``: its blocks ``MedNeXtBlock_n`` and its projection ``Conv_0`` (the
patchify stem's ``ConvTranspose_0``). Inside a block, ``Conv_n`` counts the convs in order (depthwise,
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
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .layers import ResBlock
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


def _block(fp: Mapping[str, Any], prefix: str, blk: MedNeXtBlock, sd: Dict[str, torch.Tensor]) -> None:
    if blk.transpose:
        spatial, pw1, pw2, res = "ConvTranspose_0", "Conv_0", "Conv_1", "ConvTranspose_1"
        sd[prefix + "conv_weight"] = conv_transpose_kernel(fp[spatial]["kernel"])
    else:
        spatial, pw1, pw2, res = "Conv_0", "Conv_1", "Conv_2", "Conv_3"
        sd[prefix + "conv_weight"] = conv_kernel(fp[spatial]["kernel"])
    sd[prefix + "conv_bias"] = _t(fp[spatial]["bias"])
    gn = fp["Norm_0"]["GroupNorm_0"]
    sd[prefix + "norm.weight"] = _t(gn["scale"])
    sd[prefix + "norm.bias"] = _t(gn["bias"])
    for name, key in (("pw1", pw1), ("pw2", pw2)) + ((("res", res),) if blk.res is not None else ()):
        sd[f"{prefix}{name}.weight"] = linear_kernel(fp[key]["kernel"])
        sd[f"{prefix}{name}.bias"] = _t(fp[key]["bias"])


def _norm(fp: Mapping[str, Any], prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    gn = fp["Norm_0"]["GroupNorm_0"]
    sd[prefix + "weight"] = _t(gn["scale"])
    sd[prefix + "bias"] = _t(gn["bias"])


def _conv_norm_act(fp: Mapping[str, Any], prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[prefix + "conv.weight"] = conv_kernel(fp["Conv_0"]["kernel"])
    sd[prefix + "conv.bias"] = _t(fp["Conv_0"]["bias"])
    _norm(fp, prefix + "norm.", sd)


def _res_block(fp: Mapping[str, Any], prefix: str, blk: ResBlock, sd: Dict[str, torch.Tensor]) -> None:
    second = "Conv_0"
    if blk.skip is not None:  # the skip conv was created first
        sd[prefix + "skip.weight"] = linear_kernel(fp["Conv_0"]["kernel"])
        sd[prefix + "skip.bias"] = _t(fp["Conv_0"]["bias"])
        second = "Conv_1"
    _conv_norm_act(fp["ConvNormAct_0"], prefix + "conv1.", sd)
    sd[prefix + "conv2.weight"] = conv_kernel(fp[second]["kernel"])
    sd[prefix + "conv2.bias"] = _t(fp[second]["bias"])
    _norm(fp, prefix + "norm2.", sd)


def rsunet_to_state_dict(params: Mapping[str, Any], model: RSUNet) -> Dict[str, torch.Tensor]:
    """Map a flax RSUNet ``params`` tree onto ``model``'s state_dict keys."""
    if "params" in params and "head" not in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    n = len(model.enc)
    _conv_norm_act(params["ConvNormAct_0"], "stem.", sd)
    for i in range(n):
        _res_block(params[f"ResBlock_{i}"], f"enc.{i}.", model.enc[i], sd)
    _res_block(params[f"ResBlock_{n}"], "bottleneck.", model.bottleneck, sd)
    for k, i in enumerate(reversed(range(n))):
        sd[f"up.{i}.weight"] = linear_kernel(params[f"Conv_{k}"]["kernel"])
        sd[f"up.{i}.bias"] = _t(params[f"Conv_{k}"]["bias"])
        _res_block(params[f"ResBlock_{n + 1 + k}"], f"dec.{i}.", model.dec[i], sd)
    _head(params, sd)
    return sd


def _up_conv(fp: Mapping[str, Any], prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[prefix + "conv_weight"] = conv_transpose_kernel(fp["ConvTranspose_0"]["kernel"])
    sd[prefix + "conv_bias"] = _t(fp["ConvTranspose_0"]["bias"])


def _dense(fp: Mapping[str, Any], prefix: str, sd: Dict[str, torch.Tensor], in_axes: int = 1) -> None:
    """flax Dense / DenseGeneral whose kernel's first ``in_axes`` axes are
    its inputs -> ``nn.Linear`` weight (out, in) and flat bias."""
    k, b = np.asarray(fp["kernel"]), np.asarray(fp["bias"])
    sd[prefix + "weight"] = _t(k.reshape(int(np.prod(k.shape[:in_axes])), -1).T)
    sd[prefix + "bias"] = _t(b.reshape(-1))


def _head(params: Mapping[str, Any], sd: Dict[str, torch.Tensor]) -> None:
    sd["head.weight"] = linear_kernel(params["head"]["kernel"])
    sd["head.bias"] = _t(params["head"]["bias"])


def unet_to_state_dict(params: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """Map a flax BasicUNet3D, UNet3D or UNETR ``params`` tree onto
    ``model``'s state_dict keys."""
    if "params" in params and "head" not in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    _head(params, sd)
    if isinstance(model, BasicUNet3D):
        for i in range(5):
            for j in range(2):
                _conv_norm_act(params[f"ConvNormAct_{2 * i + j}"], f"enc.{i}.c{j}.", sd)
        for i in range(4):
            _up_conv(params[f"UpConv_{i}"], f"up.{i}.", sd)
            for j in range(2):
                _conv_norm_act(params[f"ConvNormAct_{10 + 2 * i + j}"], f"dec.{i}.c{j}.", sd)
        return sd
    if isinstance(model, UNet3D):
        _conv_norm_act(params["ConvNormAct_0"], "stem.", sd)
        rb = iter(range(1 << 30))
        units = [("stem_units", model.stem_units)]
        for i, u in enumerate(model.down_units):
            _conv_norm_act(params[f"ConvNormAct_{i + 1}"], f"down.{i}.", sd)
            units.append((f"down_units.{i}", u))
        for name, u in units:
            for k, blk in enumerate(u.blocks):
                _res_block(params[f"ResBlock_{next(rb)}"], f"{name}.blocks.{k}.", blk, sd)
        for i, u in enumerate(model.up_units):
            _up_conv(params[f"UpConv_{i}"], f"up.{i}.", sd)
            for k, blk in enumerate(u.blocks):
                _res_block(params[f"ResBlock_{next(rb)}"], f"up_units.{i}.blocks.{k}.", blk, sd)
        return sd
    sd["patch_embed.weight"] = conv_kernel(params["patch_embed"]["kernel"])
    sd["patch_embed.bias"] = _t(params["patch_embed"]["bias"])
    sd["pos_embed"] = _t(params["pos_embed"])
    for li in range(len(model.layers)):
        p = f"layers.{li}."
        for j, ln in enumerate(("ln1", "ln2")):
            sd[f"{p}{ln}.weight"] = _t(params[f"LayerNorm_{2 * li + j}"]["scale"])
            sd[f"{p}{ln}.bias"] = _t(params[f"LayerNorm_{2 * li + j}"]["bias"])
        attn = params[f"MultiHeadDotProductAttention_{li}"]
        for name in ("query", "key", "value", "out"):
            _dense(attn[name], f"{p}attn.{name}.", sd, 2 if name == "out" else 1)
        _dense(params[f"Dense_{2 * li}"], f"{p}fc1.", sd)
        _dense(params[f"Dense_{2 * li + 1}"], f"{p}fc2.", sd)
    # decoder, in the order the JAX module creates its layers
    names = ["proj.0.", "proj.1.", "proj.2.", "proj.3.", "fuse.0.", "fuse.1.", "fuse.2.", "inp.", "last."]
    for k, name in enumerate(names):
        _conv_norm_act(params[f"ConvNormAct_{k}"], name, sd)
    for k in range(7):
        _up_conv(params[f"UpConv_{k}"], f"up.{k}.", sd)
    return sd


def flax_to_state_dict(params: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """Map a flax MedNeXt, RSUNet or MONAI U-Net ``params`` tree onto
    ``model``'s state_dict keys."""
    if isinstance(model, RSUNet):
        return rsunet_to_state_dict(params, model)
    if isinstance(model, (BasicUNet3D, UNet3D, UNETR)):
        return unet_to_state_dict(params, model)
    if "params" in params and "stem" not in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}

    def projection(fp, prefix, transposed):
        if transposed:
            sd[prefix + "head_weight"] = conv_transpose_kernel(fp["kernel"])
            sd[prefix + "head_bias"] = _t(fp["bias"])
        else:
            sd[prefix + "head.weight"] = linear_kernel(fp["kernel"])
            sd[prefix + "head.bias"] = _t(fp["bias"])

    if model.patchify_stem:
        sd["stem_weight"] = conv_kernel(params["stem"]["kernel"])
        sd["stem_bias"] = _t(params["stem"]["bias"])
    else:
        sd["stem.weight"] = linear_kernel(params["stem"]["kernel"])
        sd["stem.bias"] = _t(params["stem"]["bias"])
    if model.heads is None:
        projection(params["head"], "", model.patchify_stem)
    for name, head in (model.heads or {}).items():
        fh = params[f"head_{name}"]
        for i, blk in enumerate(head.blocks):
            _block(fh[f"MedNeXtBlock_{i}"], f"heads.{name}.blocks.{i}.", blk, sd)
        projection(fh["ConvTranspose_0" if model.patchify_stem else "Conv_0"], f"heads.{name}.",
                   model.patchify_stem)

    def stage(flax_name: str, port_name: str, st) -> None:
        fs = params[flax_name]
        # remat stages (checkpoint_style outside_block) wrap each block as CheckpointMedNeXtBlock
        cls = "CheckpointMedNeXtBlock" if "CheckpointMedNeXtBlock_0" in fs else "MedNeXtBlock"
        for i, blk in enumerate(st.blocks):
            _block(fs[f"{cls}_{i}"], f"{port_name}.blocks.{i}.", blk, sd)

    for i in range(4):
        stage(f"_Stage_{i}", f"enc.{i}", model.enc[i])
        _block(params[f"MedNeXtBlock_{i}"], f"down.{i}.", model.down[i], sd)
        _block(params[f"MedNeXtBlock_{4 + i}"], f"up.{i}.", model.up[i], sd)
        stage(f"_Stage_{5 + i}", f"dec.{i}", model.dec[i])
    stage("_Stage_4", "bottleneck", model.bottleneck)
    return sd


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
