"""RSUNet: residual symmetric U-Net (SNEMI lineage), the port of
``pytorch_connectomics_tpu/models/rsunet.py``.

A stem conv-norm-act, one residual block per encoder level followed by a
max-pool, a residual bottleneck block, and per decoder level a trilinear
upsample, a 1x1x1 conv to the level's width, the skip added, and a residual
block; a 1x1x1 head in float32. Down factors are ``(2,2,2)`` with ``iso``,
else ``(1,2,2)`` for the first two levels, or the explicit
``down_factors``; the first ``depth_2d`` levels convolve with ``kernel_2d``
(``(1,3,3)``).

Every 3^3 conv (all of them with ``iso`` and ``depth_2d: 0``) is SAME and
stride 1: on a CUDA device it runs through the hand-written kernels of
:mod:`..ops.conv3d` (the port of ``conv3d_pallas.py``), on the CPU through
their plain versions. With grad enabled and a parameter or the input that
requires grad (training), each goes through ``Conv3x3Function``: the forward
kernel, then in the backward the input gradient through the same kernel
(mirrored, transposed taps) and the weight-gradient kernel. Under
``torch.no_grad()``/``inference_mode()`` the forward kernel takes a weight
matrix built once per parameter version. ``forward(x, plain=True)`` runs the
plain version on any device, differentiable by autograd, the reference a
kernel run is held against. Other kernel shapes (``kernel_2d``) are
computed by ``F.conv3d``, as the JAX package computes them outside any
Pallas kernel. The 1x1x1 convs are ``F.linear`` over the channel axis.

Activations are channels-last ``(B, Z, Y, X, C)`` in the compute dtype;
parameters stay float32 and are cast per call, as flax does (bias added
after the conv's rounding, in the compute dtype). The head computes in
float32 and the output is float32. Deep supervision raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv3d
from .layers import Norm, conv3d_same, downsample, get_act, upsample_trilinear
from .registry import register_architecture


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax's 1x1x1 ``nn.Conv`` in ``dtype``: rounded product, then the bias."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, padding='SAME')``, stride 1, in
    ``dtype`` on channels-last input; weight ``(O, I, kz, ky, kx)``."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int], dtype: torch.dtype):
        super().__init__()
        self.kernel = tuple(int(k) for k in kernel)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._wmat_key = None

    def _kernel_weight(self) -> torch.Tensor:
        """The 3^3 kernel's weight matrix in the compute dtype for inference,
        built again only when the weight moves or is written in place."""
        key = (self.weight.device, self.weight.data_ptr(), self.weight._version)
        if key != self._wmat_key:
            with torch.inference_mode(False), torch.no_grad():
                self._wmat = conv3d.kernel_weight(self.weight, self.dtype)
            self._wmat_key = key
        return self._wmat

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.kernel == (3, 3, 3):
            if plain:
                return conv3d.conv3d_3x3_plain(x, self.weight, self.bias)
            if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad or self.bias.requires_grad):
                return conv3d.Conv3x3Function.apply(x, self.weight, self.bias)
            wmat = None if x.device.type == "cpu" else self._kernel_weight()
            return conv3d.conv3d_3x3(x, self.weight, self.bias, wmat=wmat)
        y = conv3d_same(x, self.weight.to(self.dtype), None, (1, 1, 1))
        return y + self.bias.to(self.dtype)


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, kernel, norm, act, groups, dtype):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, dtype)
        self.norm = Norm(cout, norm, groups)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return self.act(self.norm(self.conv(x, plain)))


class ResBlock(nn.Module):
    """Two convs with an additive skip before the last activation; the skip
    is a 1x1x1 conv only when the channel count changes."""

    def __init__(self, cin, cout, kernel, norm, act, groups, dtype):
        super().__init__()
        self.dtype = dtype
        self.skip = nn.Linear(cin, cout) if cin != cout else None
        self.conv1 = ConvNormAct(cin, cout, kernel, norm, act, groups, dtype)
        self.conv2 = Conv(cout, cout, kernel, dtype)
        self.norm2 = Norm(cout, norm, groups)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        skip = x if self.skip is None else _linear(x, self.skip, self.dtype)
        y = self.norm2(self.conv2(self.conv1(x, plain), plain))
        return self.act(y + skip)


class RSUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 3,
        width: Sequence[int] = (16, 32, 64, 128),
        down_factors: Sequence[Sequence[int]] | None = None,
        depth_2d: int = 0,
        kernel_2d: Sequence[int] = (1, 3, 3),
        norm: str = "group",
        act: str = "elu",
        groups: int = 8,
        iso: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        deep_supervision: bool = False,
    ):
        super().__init__()
        if deep_supervision:
            raise NotImplementedError("RSUNet deep supervision is not ported yet")
        width = [int(w) for w in width]
        n = len(width) - 1
        if down_factors is not None:
            self.factors: List[Tuple[int, ...]] = [tuple(int(v) for v in f) for f in down_factors]
        elif iso:
            self.factors = [(2, 2, 2)] * n
        else:  # anisotropic default: keep z at the first two levels
            self.factors = [(1, 2, 2) if i < 2 else (2, 2, 2) for i in range(n)]
        self.dtype = dtype

        def kernel(level: int) -> Tuple[int, ...]:
            return tuple(kernel_2d) if level < depth_2d else (3, 3, 3)

        blk = dict(norm=norm, act=act, groups=groups, dtype=dtype)
        self.stem = ConvNormAct(in_channels, width[0], kernel(0), **blk)
        self.enc = nn.ModuleList(
            ResBlock(width[max(i - 1, 0)], width[i], kernel(i), **blk) for i in range(n)
        )
        self.bottleneck = ResBlock(width[n - 1], width[n], (3, 3, 3), **blk)
        self.up = nn.ModuleList(nn.Linear(width[i + 1], width[i]) for i in range(n))
        self.dec = nn.ModuleList(ResBlock(width[i], width[i], kernel(i), **blk) for i in range(n))
        self.head = nn.Linear(width[0], out_channels)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = self.stem(x, plain)
        skips = []
        for i, blk in enumerate(self.enc):
            x = blk(x, plain)
            skips.append(x)
            x = downsample(x, self.factors[i])
        x = self.bottleneck(x, plain)
        for i in reversed(range(len(self.dec))):
            x = upsample_trilinear(x, self.factors[i])
            x = _linear(x, self.up[i], self.dtype) + skips[i]
            x = self.dec[i](x, plain)
        return F.linear(x.float(), self.head.weight, self.head.bias)


@register_architecture("rsunet", "Residual symmetric U-Net (anisotropic EM default)")
def build_rsunet(model_cfg, iso: bool | None = None) -> RSUNet:
    r = model_cfg.rsunet
    return RSUNet(
        in_channels=model_cfg.in_channels,
        out_channels=model_cfg.out_channels,
        width=tuple(r.width),
        down_factors=r.down_factors,
        depth_2d=r.depth_2d,
        kernel_2d=tuple(r.kernel_2d),
        norm=r.norm,
        act=r.act,
        groups=r.group_norm_groups,
        iso=r.iso if iso is None else iso,
        dtype=getattr(torch, str(model_cfg.compute_dtype)),
        deep_supervision=model_cfg.loss.deep_supervision,
    )


@register_architecture("rsunet_iso", "Isotropic RSUNet variant")
def build_rsunet_iso(model_cfg) -> RSUNet:
    return build_rsunet(model_cfg, iso=True)
