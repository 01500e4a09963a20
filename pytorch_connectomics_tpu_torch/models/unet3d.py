"""The MONAI-style U-Nets, the port of ``pytorch_connectomics_tpu/models/unet3d.py``:
``BasicUNet3D`` (two-conv blocks, max-pool downs, upcat decoder), ``UNet3D``
(strided encoder with residual units, transposed-conv decoder) and ``UNETR``
(a ViT encoder over 3-D patches with a conv decoder).

Every SAME stride-1 3^3 conv runs through :class:`.layers.Conv`, that is the
hand-written kernels of :mod:`..ops.conv3d` on a CUDA device (forward, and
in training the input gradient through the forward kernel and the
weight-gradient kernel) and their plain versions on the CPU. Strided convs,
the transposed convs and UNETR's patch embedding run ``F.conv3d`` /
``F.conv_transpose3d`` with flax's ``SAME`` padding, as the JAX package
computes them outside any Pallas kernel; the 1x1x1 skip and head convs are
``F.linear`` over the channel axis. Norms are flax's GroupNorm
(``instance``: one group per channel, eps 1e-6, fast variance).

Activations are channels-last ``(B, Z, Y, X, C)`` in the compute dtype;
parameters stay float32 and are cast per call, as flax does; the head
computes in float32. ``forward(x, plain=True)`` runs the 3^3 convs' plain
versions on any device (the reference a kernel run is held against).

UNETR's attention is flax's ``MultiHeadDotProductAttention`` written out:
query, key and value projections with biases, the query scaled by
``1/sqrt(head_dim)`` in the compute dtype, the softmax in the compute dtype,
then the output projection. Its layer norms are flax's (f32 statistics,
eps 1e-6), its GELU the tanh form. The position embedding is sized from
``img_size`` and the patch size, as flax's is from the input.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, ConvNormAct, ResBlock, UpConv, downsample, get_act, linear
from .registry import register_architecture


class _Block(nn.Module):
    """BasicUNet's two conv-norm-act layers (and dropout in training)."""

    def __init__(self, cin, cout, norm, act, dtype, dropout):
        super().__init__()
        self.c0 = ConvNormAct(cin, cout, (3, 3, 3), norm, act, 8, dtype)
        self.c1 = ConvNormAct(cout, cout, (3, 3, 3), norm, act, 8, dtype)
        self.dropout = float(dropout)

    def forward(self, x, plain=False):
        x = self.c1(self.c0(x, plain), plain)
        return F.dropout(x, self.dropout, self.training) if self.dropout else x


class BasicUNet3D(nn.Module):
    """MONAI BasicUNet topology; ``features`` has MONAI's six entries: four
    encoder levels, the bottleneck and the last decoder width."""

    def __init__(self, in_channels=1, out_channels=1, features=(32, 32, 64, 128, 256, 32), norm="instance",
                 act="leaky_relu", dropout=0.0, dtype=torch.bfloat16):
        super().__init__()
        f = [int(v) for v in features]
        blk = dict(norm=norm, act=act, dtype=dtype, dropout=dropout)
        self.enc = nn.ModuleList([_Block(in_channels, f[0], **blk)] + [_Block(f[i], f[i + 1], **blk) for i in range(4)])
        # decoder level i (deepest first): up from the width below, cat the skip, block to the level's width
        widths, below, skips = [f[3], f[2], f[1], f[5]], [f[4], f[3], f[2], f[1]], [f[3], f[2], f[1], f[0]]
        self.up = nn.ModuleList(UpConv(b, w, (2, 2, 2), dtype) for b, w in zip(below, widths))
        self.dec = nn.ModuleList(_Block(w + s, w, **blk) for w, s in zip(widths, skips))
        self.head = nn.Linear(f[5], out_channels)

    def forward(self, x, plain=False):
        skips = []
        for i, blk in enumerate(self.enc):
            x = blk(x if i == 0 else downsample(x, (2, 2, 2)), plain)
            skips.append(x)
        skips.pop()
        for up, blk in zip(self.up, self.dec):
            x = blk(torch.cat([up(x), skips.pop()], dim=-1), plain)
        return F.linear(x.float(), self.head.weight, self.head.bias)


class _ResUnits(nn.Module):
    def __init__(self, cin, cout, n, kernel, norm, act, dtype, dropout):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResBlock(cin if i == 0 else cout, cout, kernel, norm, act, 8, dtype) for i in range(max(1, n))
        )
        self.dropout = float(dropout)

    def forward(self, x, plain=False):
        for b in self.blocks:
            x = b(x, plain)
        return F.dropout(x, self.dropout, self.training) if self.dropout else x


class UNet3D(nn.Module):
    """MONAI UNet topology: per level a strided conv-norm-act and residual
    units; per decoder level a transposed conv (kernel ``up_kernel_size``),
    the skip concatenated and residual units."""

    def __init__(self, in_channels=1, out_channels=1, channels=(16, 32, 64),
                 strides: Optional[Sequence[Sequence[int]]] = None, num_res_units=1, kernel_size=3, up_kernel_size=3,
                 norm="instance", act="prelu", dropout=0.0, dtype=torch.bfloat16):
        super().__init__()
        ch = [int(c) for c in channels]
        n = len(ch) - 1
        self.strides = [tuple(int(v) for v in s) for s in (strides or [(2, 2, 2)] * n)]
        k = (int(kernel_size),) * 3
        ru = dict(n=num_res_units, kernel=k, norm=norm, act=act, dtype=dtype, dropout=dropout)
        self.stem = ConvNormAct(in_channels, ch[0], k, norm, act, 8, dtype)
        self.stem_units = _ResUnits(ch[0], ch[0], **ru)
        self.down = nn.ModuleList(ConvNormAct(ch[i], ch[i + 1], k, norm, act, 8, dtype, self.strides[i])
                                  for i in range(n))
        self.down_units = nn.ModuleList(_ResUnits(ch[i + 1], ch[i + 1], **ru) for i in range(n))
        # decoder, deepest first: level i = n-1 .. 0
        self.up = nn.ModuleList(UpConv(ch[i + 1], ch[i], self.strides[i], dtype, (int(up_kernel_size),) * 3)
                                for i in reversed(range(n)))
        self.up_units = nn.ModuleList(_ResUnits(2 * ch[i], ch[i], **ru) for i in reversed(range(n)))
        self.head = nn.Linear(ch[0], out_channels)

    def forward(self, x, plain=False):
        x = self.stem_units(self.stem(x, plain), plain)
        skips = []
        for down, units in zip(self.down, self.down_units):
            skips.append(x)
            x = units(down(x, plain), plain)
        for up, units in zip(self.up, self.up_units):
            x = units(torch.cat([up(x), skips.pop()], dim=-1), plain)
        return F.linear(x.float(), self.head.weight, self.head.bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis: f32 statistics, variance
    ``E[x^2] - E[x]^2`` clipped at 0, eps 1e-6, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return ((xf - mean) * (torch.rsqrt(var + 1e-6) * ln.weight) + ln.bias).to(x.dtype)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask) in
    ``dtype``: (B, N, hidden) -> (B, N, hidden)."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.query, self.key, self.value, self.out = (nn.Linear(hidden, hidden) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q, k, v = (linear(x, m, self.dtype).reshape(b, n, self.heads, d) for m in (self.query, self.key, self.value))
        q = q / torch.tensor(math.sqrt(d), dtype=self.dtype)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, c)
        return linear(o, self.out, self.dtype)


class _TransformerLayer(nn.Module):
    def __init__(self, hidden, heads, mlp_dim, dtype, dropout):
        super().__init__()
        self.dtype, self.dropout = dtype, float(dropout)
        self.ln1, self.ln2 = nn.LayerNorm(hidden), nn.LayerNorm(hidden)
        self.attn = Attention(hidden, heads, dtype)
        self.fc1, self.fc2 = nn.Linear(hidden, mlp_dim), nn.Linear(mlp_dim, hidden)

    def forward(self, t):
        t = t + self.attn(layer_norm(t, self.ln1))
        h = linear(get_act("gelu")(linear(layer_norm(t, self.ln2), self.fc1, self.dtype)), self.fc2, self.dtype)
        if self.dropout:
            h = F.dropout(h, self.dropout, self.training)
        return t + h


class UNETR(nn.Module):
    """UNETR: a ViT encoder over ``patch_size`` patches (taps every
    ``num_layers // 4`` layers, the last four kept) and a conv decoder that
    upsamples the taps back to the input scale, with a full-scale skip."""

    def __init__(self, in_channels=1, out_channels=1, img_size=(96, 96, 96), patch_size=(16, 16, 16),
                 hidden_size=384, mlp_dim=1536, num_heads=6, num_layers=8, feature_size=16, norm="instance",
                 dropout=0.0, dtype=torch.bfloat16):
        super().__init__()
        ps = tuple(int(p) for p in patch_size)
        self.grid = tuple(int(s) // p for s, p in zip(img_size, ps))
        self.hidden, self.dtype, self.dropout = int(hidden_size), dtype, float(dropout)
        self.tap_every = max(1, num_layers // 4)
        fs, c = int(feature_size), dict(kernel=(3, 3, 3), norm=norm, act="relu", groups=8, dtype=dtype)
        self.patch_embed = Conv(in_channels, self.hidden, ps, dtype, ps)
        self.pos_embed = nn.Parameter(torch.zeros(1, math.prod(self.grid), self.hidden))
        self.layers = nn.ModuleList(_TransformerLayer(self.hidden, num_heads, mlp_dim, dtype, dropout)
                                    for _ in range(num_layers))
        self.proj = nn.ModuleList(ConvNormAct(self.hidden, fs * m, **c) for m in (8, 4, 2, 1))
        self.up = nn.ModuleList([
            UpConv(fs * 8, fs * 4, (2, 2, 2), dtype), UpConv(fs * 4, fs * 4, (2, 2, 2), dtype),
            UpConv(fs * 4, fs * 2, (2, 2, 2), dtype), UpConv(fs * 2, fs * 2, (4, 4, 4), dtype),
            UpConv(fs * 2, fs, (2, 2, 2), dtype), UpConv(fs, fs, (8, 8, 8), dtype),
            UpConv(fs, fs, (2, 2, 2), dtype),
        ])
        self.fuse = nn.ModuleList(ConvNormAct(2 * fs * m, fs * m, **c) for m in (4, 2, 1))
        self.inp = ConvNormAct(in_channels, fs, **c)
        self.last = ConvNormAct(2 * fs, fs, **c)
        self.head = nn.Linear(fs, out_channels)

    def forward(self, x, plain=False):
        b = x.shape[0]
        grid = tuple(s // p for s, p in zip(x.shape[1:4], self.patch_embed.kernel))
        if grid != self.grid:
            raise ValueError(f"UNETR was built for a patch grid of {self.grid}, got input {tuple(x.shape[1:4])}")
        t = self.patch_embed(x).reshape(b, -1, self.hidden)
        t = t + self.pos_embed.to(t.dtype)
        if self.dropout:
            t = F.dropout(t, self.dropout, self.training)
        taps = []
        for li, layer in enumerate(self.layers):
            t = layer(t)
            if (li + 1) % self.tap_every == 0:
                taps.append(t)
        vol = [tp.reshape(b, *self.grid, self.hidden) for tp in taps[-4:]]
        d4, d3, d2, d1 = (p(v, plain) for p, v in zip(self.proj, reversed(vol)))
        up = self.up
        y = self.fuse[0](torch.cat([up[0](d4), up[1](d3)], dim=-1), plain)
        y = self.fuse[1](torch.cat([up[2](y), up[3](d2)], dim=-1), plain)
        y = self.fuse[2](torch.cat([up[4](y), up[5](d1)], dim=-1), plain)
        y = self.last(torch.cat([up[6](y), self.inp(x, plain)], dim=-1), plain)
        return F.linear(y.float(), self.head.weight, self.head.bias)


def _dtype(model_cfg) -> torch.dtype:
    return getattr(torch, str(model_cfg.compute_dtype))


@register_architecture("monai_basic_unet", "BasicUNet 3D (two-conv blocks)")
def build_basic_unet(model_cfg) -> BasicUNet3D:
    m = model_cfg.monai
    return BasicUNet3D(in_channels=model_cfg.in_channels, out_channels=model_cfg.out_channels,
                       features=tuple(m.features or [32, 32, 64, 128, 256, 32]), norm=m.norm, dropout=m.dropout,
                       dtype=_dtype(model_cfg))


@register_architecture("monai_unet", "UNet 3D with residual units")
def build_unet(model_cfg) -> UNet3D:
    m = model_cfg.monai
    return UNet3D(in_channels=model_cfg.in_channels, out_channels=model_cfg.out_channels, channels=tuple(m.filters),
                  strides=m.strides, num_res_units=m.num_res_units, kernel_size=m.kernel_size,
                  up_kernel_size=m.up_kernel_size, norm=m.norm, act=m.act, dropout=m.dropout, dtype=_dtype(model_cfg))


@register_architecture("monai_unetr", "UNETR: ViT encoder + conv decoder")
def build_unetr(model_cfg) -> UNETR:
    m = model_cfg.monai
    return UNETR(in_channels=model_cfg.in_channels, out_channels=model_cfg.out_channels,
                 img_size=tuple(model_cfg.input_size), patch_size=tuple(m.patch_size), hidden_size=m.hidden_size,
                 mlp_dim=m.mlp_dim, num_heads=m.num_heads, num_layers=m.num_layers, feature_size=m.feature_size,
                 dropout=m.dropout, dtype=_dtype(model_cfg))
