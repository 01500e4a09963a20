"""MedNeXt: ConvNeXt-style 3-D encoder-decoder (Roy et al., MICCAI 2023), the
port of ``pytorch_connectomics_tpu/models/mednext.py``.

A block is depthwise k^3 conv -> per-channel GroupNorm -> 1x1 expand (ratio
R) -> GELU (tanh) -> 1x1 compress, plus a residual; stride-2 depthwise down
blocks and transposed-conv up blocks join the stages; S/B/M/L presets.

Every stride-1 block with as many output channels as input channels runs
through the fused MedNeXt block kernels (:mod:`..ops.fused_block`): on a
CUDA device the hand-written kernels, on the CPU their plain versions.
``forward(x, plain=True)`` runs the plain versions on any device, the
reference a kernel run is held against. The stems, the strided down and up
blocks and the head are plain PyTorch.

Activations are channels-last ``(B, Z, Y, X, C)`` in the compute dtype
(bfloat16 by default); parameters stay float32 and are cast per call, as
flax does, except the fused blocks' pointwise weights, which are cast once
per parameter version; the head computes in float32 and the output is
float32.

This slice ports the stock 1x1x1 stem and the patchify stem (any per-axis
stride, ``linear`` head). Deep supervision, task heads, 2-D mode, the
``refine`` head, the full-resolution hybrid and kernel sizes other than 3
raise ``NotImplementedError``. ``remat`` (activation checkpointing) only
changes what training keeps for the backward pass; the port runs inference
only, so the flag is accepted and has no effect.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_block
from .layers import Norm, conv3d_same, conv_transpose3d_same
from .registry import register_architecture

# size presets: (base_channels, exp_ratios[9], block_counts[9])
_PRESETS: Dict[str, Tuple[int, List[int], List[int]]] = {
    "S": (32, [2] * 9, [2] * 9),
    "B": (32, [2, 3, 4, 4, 4, 4, 4, 3, 2], [2] * 9),
    "M": (32, [2, 3, 4, 4, 4, 4, 4, 3, 2], [3, 4, 4, 4, 4, 4, 4, 4, 3]),
    "L": (32, [3, 4, 8, 8, 8, 8, 8, 4, 3], [3, 4, 8, 8, 8, 8, 8, 4, 3]),
}


def _lin(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MedNeXtBlock(nn.Module):
    """One MedNeXt block on channels-last input with ``channels`` channels."""

    def __init__(
        self,
        channels: int,
        exp_ratio: int = 4,
        kernel: int = 3,
        norm: str = "group",
        out_channels: int | None = None,
        stride: int = 1,
        transpose: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        if kernel != 3:
            raise NotImplementedError(f"MedNeXt kernel size {kernel} is not ported yet (3 only)")
        cin = channels
        cout = out_channels or channels
        self.kernel, self.stride, self.transpose, self.dtype = kernel, stride, transpose, dtype
        self.fused = stride == 1 and cin == cout and not transpose
        k = (kernel,) * 3
        if transpose:  # dense transposed conv, stored flipped in (I, O, k, k, k)
            self.conv_weight = nn.Parameter(torch.zeros(cin, cin, *k))
        else:  # depthwise conv, (C, 1, k, k, k)
            self.conv_weight = nn.Parameter(torch.zeros(cin, 1, *k))
        self.conv_bias = nn.Parameter(torch.zeros(cin))
        self.norm = Norm(cin, norm)
        self.pw1 = nn.Linear(cin, cin * exp_ratio)
        self.pw2 = nn.Linear(cin * exp_ratio, cout)
        # strided / channel-changing residual: a 1x1x1 (transposed) conv
        self.res = None if (stride == 1 and cin == cout) else nn.Linear(cin, cout)
        self._cast_key = None

    def _pointwise_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """pw1 and pw2 weights in the compute dtype, cast again only when a
        weight moves or is written in place."""
        ws = (self.pw1.weight, self.pw2.weight)
        key = tuple((w.device, w.data_ptr(), w._version) for w in ws)
        if key != self._cast_key:
            with torch.inference_mode(False), torch.no_grad():
                self._cast = tuple(w.detach().to(self.dtype).contiguous() for w in ws)
            self._cast_key = key
        return self._cast

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        if self.fused:
            block = fused_block.fused_mednext_block_plain if plain else fused_block.fused_mednext_block
            w1, w2 = self._pointwise_weights()
            return block(
                x, self.conv_weight, self.norm.weight, self.norm.bias,
                w1, self.pw1.bias, w2, self.pw2.bias, self.norm.eps,
            )
        s = (self.stride,) * 3
        w, b = self.conv_weight.to(dt), self.conv_bias.to(dt)
        if self.transpose:
            y = conv_transpose3d_same(x, w, b, s)
        else:
            y = conv3d_same(x, w, b, s, groups=x.shape[-1])
        y = self.norm(y)
        y = F.gelu(_lin(y, self.pw1, dt), approximate="tanh")
        y = _lin(y, self.pw2, dt)
        if self.res is None:
            return x + y
        if self.transpose:
            # k=1 stride-s transposed conv: W.x + b on the stride lattice, b elsewhere
            res = self.res.bias.to(dt).expand(
                x.shape[0], *(n * st for n, st in zip(x.shape[1:4], s)), self.res.out_features
            ).clone()
            res[:, :: s[0], :: s[1], :: s[2]] = _lin(x, self.res, dt)
        else:
            res = _lin(x[:, :: s[0], :: s[1], :: s[2]], self.res, dt)
        return res + y


class _Stage(nn.Module):
    def __init__(self, channels, num_blocks, exp_ratio, kernel, norm, dtype):
        super().__init__()
        self.blocks = nn.ModuleList(
            MedNeXtBlock(channels, exp_ratio, kernel, norm, dtype=dtype) for _ in range(num_blocks)
        )

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, plain)
        return x


class MedNeXt(nn.Module):
    """(B, Z, Y, X, in_channels) float -> (B, Z, Y, X, out_channels) float32."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        base_channels: int = 32,
        exp_ratios: Sequence[int] = (2,) * 9,
        block_counts: Sequence[int] = (2,) * 9,
        kernel: int = 3,
        norm: str = "group",
        deep_supervision: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
        heads=None,
        two_d: bool = False,
        patchify_stem: bool = False,
        patchify_kernel: int = 2,
        patchify_stride: Sequence[int] = (2, 2, 2),
        patchify_head: str = "linear",
        patchify_full_res_width: int | None = None,
    ):
        super().__init__()
        for flag, what in (
            (deep_supervision, "deep supervision"),
            (heads, "task heads"),
            (two_d, "2-D mode"),
            (patchify_stem and patchify_head != "linear", f"patchify head '{patchify_head}'"),
            (patchify_stem and patchify_full_res_width, "the full-resolution hybrid"),
        ):
            if flag:
                raise NotImplementedError(f"MedNeXt {what} is not ported yet")
        C, R, B = base_channels, list(exp_ratios), list(block_counts)
        self.in_channels, self.out_channels, self.dtype = in_channels, out_channels, dtype
        self.patchify_stem = bool(patchify_stem)
        if self.patchify_stem:
            self.stride = tuple(int(s) for s in patchify_stride)
            pk = tuple(1 if s == 1 else patchify_kernel for s in self.stride)
            self.stem_weight = nn.Parameter(torch.zeros(C, in_channels, *pk))
            self.stem_bias = nn.Parameter(torch.zeros(C))
            # transposed-conv head, stored flipped in (I, O, k, k, k)
            self.head_weight = nn.Parameter(torch.zeros(C, out_channels, *pk))
            self.head_bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.stem = nn.Linear(in_channels, C)
            self.head = nn.Linear(C, out_channels)

        def stage(i, ch):
            return _Stage(ch, B[i], R[i], kernel, norm, dtype)

        self.enc = nn.ModuleList(stage(i, C * 2**i) for i in range(4))
        self.down = nn.ModuleList(
            MedNeXtBlock(C * 2**i, R[i], kernel, norm, out_channels=C * 2 ** (i + 1), stride=2, dtype=dtype)
            for i in range(4)
        )
        self.bottleneck = stage(4, C * 16)
        self.up = nn.ModuleList(
            MedNeXtBlock(
                C * 2 ** (4 - j), R[5 + j], kernel, norm, out_channels=C * 2 ** (3 - j),
                stride=2, transpose=True, dtype=dtype,
            )
            for j in range(4)
        )
        self.dec = nn.ModuleList(stage(5 + j, C * 2 ** (3 - j)) for j in range(4))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        dt = self.dtype
        if self.patchify_stem:
            x = conv3d_same(x.to(dt), self.stem_weight.to(dt), self.stem_bias.to(dt), self.stride)
        else:
            x = _lin(x, self.stem, dt)
        skips = []
        for i in range(4):
            x = self.enc[i](x, plain)
            skips.append(x)
            x = self.down[i](x, plain)
        x = self.bottleneck(x, plain)
        for j in range(4):
            x = self.up[j](x, plain) + skips[3 - j]
            x = self.dec[j](x, plain)
        if self.patchify_stem:
            return conv_transpose3d_same(x.float(), self.head_weight, self.head_bias, self.stride)
        return _lin(x, self.head, torch.float32)


@register_architecture("mednext", "MedNeXt S/B/M/L ConvNeXt-style 3D U-Net")
def build_mednext(model_cfg) -> MedNeXt:
    m = model_cfg.mednext
    size = (m.size or "S").upper()
    if size in _PRESETS:
        base, ratios, counts = _PRESETS[size]
    else:  # custom
        base = m.base_channels
        ratios = m.exp_ratio if isinstance(m.exp_ratio, list) else [m.exp_ratio] * 9
        counts = m.block_counts or [2] * 9
    ds = m.deep_supervision
    if ds is None:
        ds = model_cfg.loss.deep_supervision
    return MedNeXt(
        in_channels=model_cfg.in_channels,
        out_channels=model_cfg.out_channels,
        base_channels=base,
        exp_ratios=tuple(ratios),
        block_counts=tuple(counts),
        kernel=m.kernel_size,
        norm=m.norm_type,
        deep_supervision=bool(ds),
        dtype=getattr(torch, str(model_cfg.compute_dtype)),
        remat=(m.checkpoint_style == "outside_block"),
        heads=m.heads or None,
        two_d=(str(m.dim).lower() == "2d"),
        patchify_stem=bool(m.patchify_stem),
        patchify_kernel=int(m.patchify_kernel),
        patchify_stride=tuple(m.patchify_stride or (2, 2, 2)),
        patchify_head=str(m.patchify_head),
        patchify_full_res_width=m.patchify_full_res_width,
    )
