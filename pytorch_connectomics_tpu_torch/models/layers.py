"""Shared building blocks of the port's models.

Layout: activations are channels-last ``(B, Z, Y, X, C)``, the layout of the
JAX package. A convolution views them as NCDHW through a permute, which is
PyTorch's ``channels_last_3d`` memory format, and returns channels-last.
Pointwise (1x1x1) convolutions are ``F.linear`` over the channel axis.
Padding follows flax's ``SAME`` rule exactly, which differs from a symmetric
``padding=k//2`` for strided and transposed convolutions.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name; ``gelu`` is the tanh form, as flax's ``nn.gelu``."""
    return {
        "relu": F.relu,
        "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
        "elu": F.elu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "prelu": lambda x: F.leaky_relu(x, 0.25),  # fixed-slope PReLU, as the JAX package
        "silu": F.silu,
        "tanh": torch.tanh,
        "none": lambda x: x,
    }[name.lower()]


class Norm(nn.Module):
    """GroupNorm over channels-last input, flax semantics: float32
    statistics over the spatial axes and the channels of each group,
    variance ``E[x^2] - E[x]^2`` clipped at 0, eps 1e-6, output in the input
    dtype. ``groups`` follows JAX's ``Norm`` (``models/layers.py:50-53``):
    ``min(groups, C)``, stepped down to a divisor of C; ``None`` (or kind
    ``instance``) is one group per channel, as MedNeXt's blocks pass
    ``groups=C``. ``batch`` maps to group, as in JAX."""

    def __init__(self, channels: int, kind: str = "group", groups: int | None = None, eps: float = 1e-6):
        super().__init__()
        kind = kind.lower()
        if kind not in ("group", "instance", "batch"):
            raise NotImplementedError(f"norm '{kind}' is not ported yet (group/instance/batch)")
        g = channels if kind == "instance" or groups is None else min(groups, channels)
        while channels % g:
            g -= 1
        self.groups, self.eps = g, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        g, cg = self.groups, c // self.groups
        xf = x.float().reshape(*x.shape[:-1], g, cg)
        dims = tuple(range(1, x.dim() - 1)) + (x.dim(),)
        mean = xf.mean(dim=dims, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.reshape(g, cg)) + self.bias.reshape(g, cg)
        return y.reshape(x.shape).to(x.dtype)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) of one axis of a strided conv."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _cl(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv3d_same(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: Sequence[int], groups: int = 1
) -> torch.Tensor:
    """flax ``nn.Conv(padding='SAME')`` on channels-last x; weight (O, I/g, kz, ky, kx)."""
    k = weight.shape[2:]
    pads = [same_pads(n, kk, s) for n, kk, s in zip(x.shape[1:4], k, stride)]
    xp = F.pad(_ncdhw(x), (*pads[2], *pads[1], *pads[0]))
    return _cl(F.conv3d(xp, weight, bias, stride=tuple(stride), groups=groups))


def conv_transpose3d_same(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: Sequence[int]
) -> torch.Tensor:
    """flax ``nn.ConvTranspose(padding='SAME')`` on channels-last x.

    flax dilates the input by the stride, pads each axis by (pa, k+s-2-pa)
    with ``pa = k-1`` if ``s > k-1`` else ``ceil((k+s-2)/2)``, and correlates
    with the UNflipped kernel. ``weight`` is stored flipped in PyTorch's
    transposed layout (I, O, kz, ky, kx), so the full ``conv_transpose3d``
    output equals that correlation with padding (k-1, k-1); the result is its
    window starting at ``k-1-pa`` of length ``n*s`` (``output_padding``
    supplies the bias-only tail where ``k < s``)."""
    k = weight.shape[2:]
    starts, extra = [], []
    for n, kk, s in zip(x.shape[1:4], k, stride):
        pa = kk - 1 if s > kk - 1 else -(-(kk + s - 2) // 2)
        start = kk - 1 - pa
        starts.append(start)
        extra.append(max(0, start + n * s - ((n - 1) * s + kk)))
    y = F.conv_transpose3d(_ncdhw(x), weight, bias, stride=tuple(stride), output_padding=tuple(extra))
    y = y[
        :, :,
        starts[0] : starts[0] + x.shape[1] * stride[0],
        starts[1] : starts[1] + x.shape[2] * stride[1],
        starts[2] : starts[2] + x.shape[3] * stride[2],
    ]
    return _cl(y)


def downsample(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """Max-pool with window = stride = ``factors``, VALID (JAX ``downsample``)."""
    if all(int(f) == 1 for f in factors):
        return x
    return _cl(F.max_pool3d(_ncdhw(x), kernel_size=tuple(factors), stride=tuple(factors)))


def upsample_trilinear(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(method="linear")`` by integer ``factors``: half-pixel
    centres, edge samples clamped (``align_corners=False``), in x's dtype."""
    size = tuple(n * int(f) for n, f in zip(x.shape[1:4], factors))
    return _cl(F.interpolate(_ncdhw(x), size=size, mode="trilinear", align_corners=False))
