"""MedNeXt: ConvNeXt-style 3-D encoder-decoder (Roy et al., MICCAI 2023), the
port of ``pytorch_connectomics_tpu/models/mednext.py``.

A block is depthwise k^3 conv -> per-channel GroupNorm -> 1x1 expand (ratio
R) -> GELU (tanh) -> 1x1 compress, plus a residual; stride-2 depthwise down
blocks and transposed-conv up blocks join the stages; S/B/M/L presets.

A stride-1 block with as many output channels as input channels runs one of
two ways, chosen by autograd, not by ``train()``/``eval()``:

- **inference** (grad disabled, or nothing requires grad): the fused MedNeXt
  block kernels (:mod:`..ops.fused_block`), which never write the stencil,
  the normalised tensor or the hidden activation to memory and so have no
  backward pass;
- **training** (grad enabled and the input or a parameter requires grad):
  the unfused block, as the JAX package trains it: the depthwise conv
  through the kernels of :mod:`..ops.depthwise` (an autograd Function whose
  backward is a kernel too), then GroupNorm, the pointwise layers with their
  weights cast inside autograd, tanh-GELU and the residual in torch ops.

On a CUDA device the hand-written kernels run, on the CPU their plain
versions. ``forward(x, plain=True)`` runs the plain versions on any device,
the reference a kernel run is held against. The stems, the strided down and
up blocks and the head are plain PyTorch.

Activations are channels-last ``(B, Z, Y, X, C)`` in the compute dtype
(bfloat16 by default); parameters stay float32 and are cast per call, as
flax does, except the fused blocks' pointwise weights at inference, which
are cast once per parameter version; the head computes in float32 and the
output is float32.

``remat`` (``checkpoint_style: outside_block``, ``nn.remat`` of each stage
block in JAX) wraps each stage block in ``torch.utils.checkpoint`` when grad
is enabled: its activations are recomputed in the backward pass instead of
kept.

Task heads (``model.mednext.heads``, JAX ``MedNeXtTaskHead``,
``mednext.py:128-178,306-321``) replace the single head: each runs its own
stride-1 blocks on the last decoder stage's output (expansion ratio 2, the
same inference and training routes as every stride-1 block, no remat, as
in JAX) and a float32 projection (1x1x1, or the transposed conv of the
patchify stem); the forward then returns ``{name: output}`` in the order
the heads are configured.

This slice ports the stock 1x1x1 stem and the patchify stem (any per-axis
stride, ``linear`` head). Deep supervision, 2-D mode, the ``refine`` head,
the full-resolution hybrid and kernel sizes other than 3 raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import depthwise, fused_block
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
        """pw1 and pw2 weights in the compute dtype for the fused inference
        kernels, cast again only when a weight moves or is written in place.
        Detached: the training block casts inside autograd instead."""
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
        if self.fused and torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters())
        ):
            return self._train_block(x, plain)
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


    def _train_block(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        """The unfused stride-1 block, differentiable end to end."""
        dt = self.dtype
        conv = depthwise.depthwise3x3_plain if plain else depthwise.depthwise_conv3x3
        y = self.norm(conv(x.contiguous(), self.conv_weight, self.conv_bias))
        y = F.gelu(_lin(y, self.pw1, dt), approximate="tanh")
        return x + _lin(y, self.pw2, dt)


class _Stage(nn.Module):
    def __init__(self, channels, num_blocks, exp_ratio, kernel, norm, dtype, remat=False):
        super().__init__()
        self.remat = remat
        self.blocks = nn.ModuleList(
            MedNeXtBlock(channels, exp_ratio, kernel, norm, dtype=dtype) for _ in range(num_blocks)
        )

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, plain, use_reentrant=False)
            else:
                x = blk(x, plain)
        return x


def _add_projection(owner: nn.Module, channels: int, out_channels: int, stride, kernel: int) -> None:
    """Give ``owner`` the float32 output layer: a 1x1x1 conv (``head``), or
    with the patchify stem's ``stride`` the transposed conv back to full
    resolution (``head_weight``, stored flipped in (I, O, k, k, k), and
    ``head_bias``)."""
    if stride:
        pk = tuple(1 if s == 1 else kernel for s in stride)
        owner.head_weight = nn.Parameter(torch.zeros(channels, out_channels, *pk))
        owner.head_bias = nn.Parameter(torch.zeros(out_channels))
    else:
        owner.head = nn.Linear(channels, out_channels)


def _project(owner: nn.Module, x: torch.Tensor, stride) -> torch.Tensor:
    """The output layer that ``_add_projection`` gave ``owner``, in float32."""
    if stride:
        return conv_transpose3d_same(x.float(), owner.head_weight, owner.head_bias, stride)
    return _lin(x, owner.head, torch.float32)


class MedNeXtTaskHead(nn.Module):
    """One task head: ``num_blocks`` stride-1 MedNeXt blocks (ratio 2) at
    the decoder's width, then the float32 projection."""

    def __init__(self, channels, out_channels, num_blocks, kernel, norm, dtype, up_stride=None, up_kernel=2):
        super().__init__()
        self.blocks = nn.ModuleList(
            MedNeXtBlock(channels, 2, kernel, norm, dtype=dtype) for _ in range(int(num_blocks))
        )
        self.stride = up_stride
        _add_projection(self, channels, out_channels, up_stride, up_kernel)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, plain)
        return _project(self, x, self.stride)


class MedNeXt(nn.Module):
    """(B, Z, Y, X, in_channels) float -> (B, Z, Y, X, out_channels) float32,
    or with task heads {name: (B, Z, Y, X, head channels) float32}."""

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
            (two_d, "2-D mode"),
            (patchify_stem and patchify_head != "linear", f"patchify head '{patchify_head}'"),
            (patchify_stem and patchify_full_res_width, "the full-resolution hybrid"),
        ):
            if flag:
                raise NotImplementedError(f"MedNeXt {what} is not ported yet")
        C, R, B = base_channels, list(exp_ratios), list(block_counts)
        self.in_channels, self.out_channels, self.dtype = in_channels, out_channels, dtype
        self.remat = bool(remat)
        self.patchify_stem = bool(patchify_stem)
        self.stride = None
        if self.patchify_stem:
            self.stride = tuple(int(s) for s in patchify_stride)
            pk = tuple(1 if s == 1 else patchify_kernel for s in self.stride)
            self.stem_weight = nn.Parameter(torch.zeros(C, in_channels, *pk))
            self.stem_bias = nn.Parameter(torch.zeros(C))
        else:
            self.stem = nn.Linear(in_channels, C)
        self.heads = None
        if heads:
            self.heads = nn.ModuleDict()
            for h in heads:
                self.heads[h.name] = MedNeXtTaskHead(C, h.out_channels, h.num_blocks, kernel, norm, dtype,
                                                     self.stride, patchify_kernel)
        else:
            _add_projection(self, C, out_channels, self.stride, patchify_kernel)

        def stage(i, ch):
            return _Stage(ch, B[i], R[i], kernel, norm, dtype, self.remat)

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

    def forward(self, x: torch.Tensor, plain: bool = False):
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
        if self.heads is not None:
            return {name: head(x, plain) for name, head in self.heads.items()}
        return _project(self, x, self.stride)


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
