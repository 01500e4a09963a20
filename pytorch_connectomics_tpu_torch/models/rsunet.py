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
float32 and the output is float32. With ``deep_supervision`` each decoder
level i > 0 also has a float32 1x1x1 head (``ds_heads[str(i)]``, JAX
``ds_head_{i}``), and the forward returns ``{"out": head, "ds_k": ...}``,
``ds_0`` the finest of them (JAX ``rsunet.py:63-84``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvNormAct, ResBlock, downsample, linear, upsample_trilinear
from .registry import register_architecture


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
        self.ds_heads = (nn.ModuleDict({str(i): nn.Linear(width[i], out_channels) for i in range(n - 1, 0, -1)})
                         if deep_supervision else None)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = self.stem(x, plain)
        skips = []
        for i, blk in enumerate(self.enc):
            x = blk(x, plain)
            skips.append(x)
            x = downsample(x, self.factors[i])
        x = self.bottleneck(x, plain)
        ds = []
        for i in reversed(range(len(self.dec))):
            x = upsample_trilinear(x, self.factors[i])
            x = linear(x, self.up[i], self.dtype) + skips[i]
            x = self.dec[i](x, plain)
            if self.ds_heads is not None and i > 0:
                h = self.ds_heads[str(i)]
                ds.append(F.linear(x.float(), h.weight, h.bias))
        out = F.linear(x.float(), self.head.weight, self.head.bias)
        if self.ds_heads is None:
            return out
        return {"out": out, **{f"ds_{k}": d for k, d in enumerate(reversed(ds))}}


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
