"""Shared building blocks of the port's models.

Layout: activations are channels-last ``(B, Z, Y, X, C)``, the layout of the
JAX package. A convolution views them as NCDHW through a permute, which is
PyTorch's ``channels_last_3d`` memory format, and returns channels-last.
Pointwise (1x1x1) convolutions are ``F.linear`` over the channel axis.
Padding follows flax's ``SAME`` rule exactly, which differs from a symmetric
``padding=k//2`` for strided and transposed convolutions.

The modules below are the JAX package's (``models/layers.py``): :class:`Conv`
runs every SAME stride-1 3^3 conv through the hand-written kernels of
:mod:`..ops.conv3d` (the port of ``conv3d_pallas.py``) and any other conv
(strided, 1x1x1 heads aside, patch embeddings) through ``F.conv3d``, as the
JAX package computes those outside any Pallas kernel; :class:`ConvNormAct`,
:class:`ResBlock` and :class:`UpConv` follow JAX's ``ConvNormAct`` (:59),
``ResBlock`` (:83) and ``UpConv`` (:130). Parameters stay float32 and are
cast to the compute dtype per call, as flax does (bias added after the
conv's rounding, in the compute dtype). Each module's ``forward(x, plain)``
takes ``plain=True`` to run the 3^3 convs' plain version on any device,
differentiable by autograd: the reference a kernel run is held against.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv3d


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


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax's 1x1x1 ``nn.Conv`` (or ``nn.Dense``) in ``dtype``: rounded
    product, then the bias."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, strides, padding='SAME')`` in
    ``dtype`` on channels-last input; weight ``(O, I, kz, ky, kx)``. A 3^3
    stride-1 conv runs the kernels of :mod:`..ops.conv3d`: under grad
    (a parameter or the input requires grad) through ``Conv3x3Function``,
    otherwise the forward kernel with a weight matrix built once per
    parameter version."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int], dtype: torch.dtype,
                 stride: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.kernel = tuple(int(k) for k in kernel)
        self.stride = tuple(int(s) for s in stride)
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
        if self.kernel == (3, 3, 3) and self.stride == (1, 1, 1):
            if plain:
                return conv3d.conv3d_3x3_plain(x, self.weight, self.bias)
            if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad or self.bias.requires_grad):
                return conv3d.Conv3x3Function.apply(x, self.weight, self.bias)
            wmat = None if x.device.type == "cpu" else self._kernel_weight()
            return conv3d.conv3d_3x3(x, self.weight, self.bias, wmat=wmat)
        y = conv3d_same(x, self.weight.to(self.dtype), None, self.stride)
        return y + self.bias.to(self.dtype)


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, kernel, norm, act, groups, dtype, stride=(1, 1, 1)):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, dtype, stride)
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
        skip = x if self.skip is None else linear(x, self.skip, self.dtype)
        y = self.norm2(self.conv2(self.conv1(x, plain), plain))
        return self.act(y + skip)


class UpConv(nn.Module):
    """flax ``nn.ConvTranspose(padding='SAME')`` upsampling by ``factors``
    with kernel ``max(kernel, factor)`` per axis (default: the factor,
    non-overlapping), in ``dtype``; the weight is stored flipped in
    PyTorch's transposed layout ``(I, O, kz, ky, kx)``
    (:func:`conv_transpose3d_same`), the bias added after the rounding."""

    transpose = True

    def __init__(self, cin: int, cout: int, factors: Sequence[int], dtype: torch.dtype,
                 kernel: Sequence[int] | None = None):
        super().__init__()
        self.factors = tuple(int(f) for f in factors)
        k = self.factors if kernel is None else tuple(int(v) for v in kernel)
        k = tuple(max(a, f) for a, f in zip(k, self.factors))
        self.dtype = dtype
        self.conv_weight = nn.Parameter(torch.zeros(cin, cout, *k))
        self.conv_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_transpose3d_same(x.to(self.dtype), self.conv_weight.to(self.dtype), None, self.factors)
        return y + self.conv_bias.to(self.dtype)
