"""Weight bridge: a flax MedNeXt parameter tree -> the port's ``state_dict``.

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
``head``. Inside a block, ``Conv_n`` counts the convs in order (depthwise,
expand, compress, residual), so in a transposed up block, whose spatial conv
is ``ConvTranspose_0``, the expand conv is ``Conv_0``. With remat
(``checkpoint_style: outside_block``) the blocks of a stage are named
``CheckpointMedNeXtBlock_n``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .mednext import MedNeXt, MedNeXtBlock


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


def flax_to_state_dict(params: Mapping[str, Any], model: MedNeXt) -> Dict[str, torch.Tensor]:
    """Map a flax MedNeXt ``params`` tree onto ``model``'s state_dict keys."""
    if "params" in params and "stem" not in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    if model.patchify_stem:
        sd["stem_weight"] = conv_kernel(params["stem"]["kernel"])
        sd["stem_bias"] = _t(params["stem"]["bias"])
        sd["head_weight"] = conv_transpose_kernel(params["head"]["kernel"])
        sd["head_bias"] = _t(params["head"]["bias"])
    else:
        for name in ("stem", "head"):
            sd[f"{name}.weight"] = linear_kernel(params[name]["kernel"])
            sd[f"{name}.bias"] = _t(params[name]["bias"])

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


def load_flax_params(model: MedNeXt, params: Union[str, Path, Mapping[str, Any]]) -> MedNeXt:
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
