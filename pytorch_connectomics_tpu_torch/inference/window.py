"""Sliding-window inference engine: the port of
``pytorch_connectomics_tpu/inference/window.py``.

The volume, the value accumulator and the blend normaliser live on the
device; windows are cut out with tensor slicing, the model runs on
``sw_batch_size`` windows at a time, and blended predictions are added back
in place. Only the normalised prediction goes to the host.

Three engines, with the semantics of the JAX package:

- the snap-grid engine (:meth:`SlidingWindowEngine.__call__` for a stride
  that does not divide the window): origins on the snap-to-edge grid, the
  stock (clipped) importance map, value-only accumulation, normalised by
  1 / the accumulated importance, which is computed once per (shape, grid)
  on the device (:func:`inv_weight_scatter`);
- the parity-group engine (a dividing stride): overlapping windows split
  into ``prod(window // stride)`` groups that each tile the volume, so
  cutting out and adding back are reshapes (:func:`sliding_window_regular`);
- :func:`predict_volume_device`: exact separable blending with the
  UNclipped per-axis bump profiles and a closed-form per-axis normaliser.

Volumes are ``(Z, Y, X, C)``, window batches ``(B, Z, Y, X, C)``.
``apply_fn(windows) -> predictions`` is the model forward.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.schema import SlidingWindowConfig

ApplyFn = Callable[[torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# window grid and importance (host, static)
# ---------------------------------------------------------------------------


def compute_grid_1d(size: int, window: int, stride: int, snap: bool = True) -> List[int]:
    """Window origins covering [0, size) (reference dense grid + snap-to-edge)."""
    if size <= window:
        return [0]
    origins = list(range(0, size - window + 1, stride))
    last = size - window
    if origins[-1] != last:
        origins.append(last if snap else origins[-1] + stride)
    return origins


def compute_window_grid(
    vol_shape: Sequence[int],
    window: Sequence[int],
    overlap: float = 0.5,
    stride: Optional[Sequence[int]] = None,
    snap: bool = True,
) -> np.ndarray:
    """All (z,y,x) window origins, shape (N, 3)."""
    if stride is None:
        stride = [max(1, int(round(w * (1.0 - overlap)))) for w in window]
    axes = [compute_grid_1d(s, w, st, snap) for s, w, st in zip(vol_shape, window, stride)]
    return np.array([(z, y, x) for z in axes[0] for y in axes[1] for x in axes[2]], dtype=np.int32)


def importance_map(
    window: Sequence[int], blending: str = "bump", sigma_scale: float = 0.125
) -> np.ndarray:
    """Per-window blending weights; ``bump``/``gaussian`` is the separable
    Gaussian clipped at 1e-4 (so not separable any more)."""
    w = tuple(int(x) for x in window)
    if blending in ("constant", "none"):
        return np.ones(w, dtype=np.float32)
    if blending in ("bump", "gaussian"):
        axes = []
        for n in w:
            x = (np.arange(n) - (n - 1) / 2.0) / max(1.0, (n - 1) / 2.0)
            sigma = max(sigma_scale * 2.0, 1e-3)
            axes.append(np.exp(-0.5 * (x / sigma) ** 2))
        m = functools.reduce(np.multiply.outer, axes).astype(np.float32)
        return np.clip(m, 1e-4, None)
    if blending == "distance":
        from scipy import ndimage

        core = np.zeros(w, dtype=np.uint8)
        core[tuple(slice(1, -1) for _ in w)] = 1
        d = ndimage.distance_transform_edt(core) + 1.0
        return (d / d.max()).astype(np.float32)
    raise ValueError(f"unknown blending '{blending}'")


_NP_PAD_MODES = {"reflect": "reflect", "replicate": "edge", "constant": "constant"}


def pad_volume_to_roi(
    vol: np.ndarray, window: Sequence[int], mode: str = "reflect"
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Grow a (Z,Y,X[,C]) volume so every axis >= window, centred."""
    pads = []
    for s, w in zip(vol.shape[:3], window):
        need = max(0, w - s)
        pads.append((need // 2, need - need // 2))
    full = pads + [(0, 0)] * (vol.ndim - 3)
    if any(p != (0, 0) for p in pads):
        vol = np.pad(vol, full, mode=_NP_PAD_MODES[mode])
    return vol, pads


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_grid_with_valid(grid: np.ndarray, multiple: int):
    """Pad the (N, 3) origin grid to a multiple with duplicates of the last
    origin; ``valid`` is 0 on the padding rows, which add nothing."""
    n = grid.shape[0]
    n_pad = _round_up(n, multiple)
    valid = np.ones(n_pad, np.float32)
    if n_pad != n:
        grid = np.concatenate([grid, np.repeat(grid[-1:], n_pad - n, axis=0)])
        valid[n:] = 0.0
    return grid, valid


def _pad_device(vol: torch.Tensor, pads: Sequence[Tuple[int, int]], mode: str) -> torch.Tensor:
    """numpy ``np.pad`` semantics (modes reflect, replicate = edge, constant)
    on the spatial axes of a (Z,Y,X,C) tensor, by gathering with per-axis
    index vectors (any pad width)."""
    if mode == "constant":
        spec = []
        for lo, hi in reversed(list(pads)):
            spec += [lo, hi]
        return torch.nn.functional.pad(vol, [0, 0] + spec)
    for ax, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        n = vol.shape[ax]
        idx = np.arange(-lo, n + hi)
        if mode == "replicate" or n == 1:
            idx = np.clip(idx, 0, n - 1)
        elif mode == "reflect":
            period = 2 * (n - 1)
            idx = np.abs(idx) % period
            idx = np.where(idx >= n, period - idx, idx)
        else:
            raise ValueError(f"unknown padding mode '{mode}'")
        vol = vol.index_select(ax, torch.as_tensor(idx, device=vol.device))
    return vol


# ---------------------------------------------------------------------------
# device engines
# ---------------------------------------------------------------------------


def _window(vol: torch.Tensor, o, window) -> torch.Tensor:
    z, y, x = (int(v) for v in o)
    return vol[z : z + window[0], y : y + window[1], x : x + window[2]]


def sliding_window_scatter(
    apply_fn: ApplyFn,
    volume: torch.Tensor,  # (Z, Y, X, Cin)
    origins: np.ndarray,  # (N, 3), N a multiple of sw_batch
    imp: torch.Tensor,  # (wz, wy, wx, 1)
    window: Tuple[int, int, int],
    sw_batch: int,
    out_channels: int,
    acc_dtype: torch.dtype = torch.float32,
    valid: Optional[np.ndarray] = None,  # (N,) 1 real window, 0 batch padding
) -> torch.Tensor:
    """Value-only accumulation: ``sum_o imp * apply_fn(window_o)`` placed at
    each origin. A padding duplicate (valid 0) is run but adds nothing."""
    value = torch.zeros((*volume.shape[:3], out_channels), dtype=acc_dtype, device=volume.device)
    impc = imp.to(acc_dtype)
    for b0 in range(0, origins.shape[0], sw_batch):
        batch = origins[b0 : b0 + sw_batch]
        windows = torch.stack([_window(volume, o, window) for o in batch])
        preds = apply_fn(windows).to(acc_dtype) * impc
        for i, o in enumerate(batch):
            if valid is None or valid[b0 + i] > 0:
                _window(value, o, window).add_(preds[i])
    return value


def inv_weight_scatter(
    origins: np.ndarray, imp: torch.Tensor, vol_shape: Sequence[int], window: Sequence[int]
) -> torch.Tensor:
    """1 / accumulated importance over the (unpadded) origin grid, computed
    on the device of ``imp``: (Z, Y, X, 1) float32."""
    weight = torch.zeros((*vol_shape, 1), dtype=torch.float32, device=imp.device)
    impf = imp.float()
    for o in origins:
        _window(weight, o, window).add_(impf)
    return 1.0 / torch.clamp(weight, min=1e-8)


def _parity_group_layout(n: int, g: int) -> List[int]:
    """Window counts per parity class p: |{k in [0,n): k % g == p}|."""
    return [(n - p + g - 1) // g for p in range(g)]


def sliding_window_regular(
    apply_fn: ApplyFn,
    volume: torch.Tensor,  # (Z, Y, X, Cin) padded to full grid coverage
    imp: torch.Tensor,  # (wz, wy, wx, 1)
    inv_weight: torch.Tensor,  # (Z, Y, X, 1)
    window: Tuple[int, int, int],
    stride: Tuple[int, int, int],
    sw_batch: int,
    out_channels: int,
    acc_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Dense regular-grid engine: with ``stride`` dividing ``window`` the
    windows split into parity groups that each tile the volume, so windows
    are cut out and added back by reshapes; all groups' windows run through
    one batched loop."""
    Z, Y, X, Cin = volume.shape
    wz, wy, wx = window
    sz, sy, sx = stride
    if any(w % s != 0 for w, s in zip(window, stride)):
        raise ValueError(
            f"parity-group engine requires stride to divide window, got window={window} "
            f"stride={stride}; use predict_volume_device for arbitrary strides"
        )
    gz, gy, gx = wz // sz, wy // sy, wx // sx
    counts = [
        _parity_group_layout((n - w) // s + 1, g)
        for n, w, s, g in zip((Z, Y, X), window, stride, (gz, gy, gx))
    ]
    groups, blocks = [], []
    for pz in range(gz):
        for py in range(gy):
            for px in range(gx):
                Mz, My, Mx = counts[0][pz], counts[1][py], counts[2][px]
                if Mz == 0 or My == 0 or Mx == 0:
                    continue
                oz, oy, ox = pz * sz, py * sy, px * sx
                region = volume[oz : oz + Mz * wz, oy : oy + My * wy, ox : ox + Mx * wx]
                wins = region.reshape(Mz, wz, My, wy, Mx, wx, Cin).permute(0, 2, 4, 1, 3, 5, 6)
                groups.append((oz, oy, ox, Mz, My, Mx))
                blocks.append(wins.reshape(Mz * My * Mx, wz, wy, wx, Cin))
    wins_all = torch.cat(blocks)
    n_total = wins_all.shape[0]
    impc = imp.to(acc_dtype)
    # blended window predictions buffered in the volume dtype; the overlap-add
    # below accumulates in acc_dtype
    outbuf = torch.empty((n_total, wz, wy, wx, out_channels), dtype=volume.dtype, device=volume.device)
    for b0 in range(0, n_total, sw_batch):
        chunk = wins_all[b0 : b0 + sw_batch]
        if chunk.shape[0] < sw_batch:  # zero windows pad the last batch
            chunk = torch.cat([chunk, chunk.new_zeros((sw_batch - chunk.shape[0], *chunk.shape[1:]))])
        preds = (apply_fn(chunk).to(acc_dtype) * impc).to(volume.dtype)
        outbuf[b0 : b0 + sw_batch] = preds[: min(sw_batch, n_total - b0)]
    value = torch.zeros((Z, Y, X, out_channels), dtype=acc_dtype, device=volume.device)
    offset = 0
    for oz, oy, ox, Mz, My, Mx in groups:
        M = Mz * My * Mx
        block = outbuf[offset : offset + M].to(acc_dtype)
        offset += M
        block = block.reshape(Mz, My, Mx, wz, wy, wx, out_channels).permute(0, 3, 1, 4, 2, 5, 6)
        value[oz : oz + Mz * wz, oy : oy + My * wy, ox : ox + Mx * wx] += block.reshape(
            Mz * wz, My * wy, Mx * wx, out_channels
        )
    return value * inv_weight.to(acc_dtype)


def _separable_bump_profiles(window, sigma_scale: float = 0.125) -> List[np.ndarray]:
    """Per-axis UNclipped Gaussian profiles (the clipped stock bump is not
    separable, so it cannot be normalised per axis)."""
    sigma = max(sigma_scale * 2.0, 1e-3)
    profiles = []
    for n in window:
        x = (np.arange(n) - (n - 1) / 2.0) / max(1.0, (n - 1) / 2.0)
        profiles.append(np.exp(-0.5 * (x / sigma) ** 2))
    return profiles


def _outer3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return a[:, None, None] * b[None, :, None] * c[None, None, :]


def _snap_grid_inv_weight_1d(size: int, window: int, stride: int, profile: np.ndarray) -> np.ndarray:
    """Closed-form per-axis 1 / accumulated blend weight of a snap-to-edge
    grid: the weight of a separable map over a Cartesian origin grid
    factorises as Wz(z) Wy(y) Wx(x)."""
    acc = np.zeros(size, np.float64)
    for o in compute_grid_1d(size, window, stride):
        acc[o : o + window] += profile
    return (1.0 / np.maximum(acc, 1e-30)).astype(np.float32)


def regular_cover_setup_device(vol_shape, window, stride, device, sigma_scale: float = 0.125):
    """``(cover, imp, inv_weight)`` of the exact separable bump blend for the
    dividing-stride engine, built on ``device`` from per-axis vectors."""
    cover = tuple(
        (max(1, -(-(s - w) // st) + 1) - 1) * st + w for s, w, st in zip(vol_shape, window, stride)
    )
    profiles = _separable_bump_profiles(window, sigma_scale)
    p = [torch.as_tensor(q, dtype=torch.float32, device=device) for q in profiles]
    imp = _outer3(*p)[..., None]
    w1d = []
    for d, (size, w, st) in enumerate(zip(cover, window, stride)):
        wd = np.zeros(size, np.float64)
        for o in range(0, size - w + 1, st):
            wd[o : o + w] += profiles[d]
        w1d.append(torch.as_tensor(wd, dtype=torch.float32, device=device))
    return cover, imp, (1.0 / _outer3(*w1d))[..., None]


def predict_volume_device(
    apply_fn: ApplyFn,
    volume: torch.Tensor,  # (Z, Y, X, Cin), raw shape
    window: Tuple[int, int, int],
    stride: Tuple[int, int, int],
    sw_batch: int,
    out_channels: int,
    acc_dtype: torch.dtype = torch.float32,
    sigma_scale: float = 0.125,
) -> torch.Tensor:
    """Whole-volume prediction on the device with exact separable bump
    blending: the parity-group engine when ``stride`` divides ``window``,
    else the snap-grid scatter engine normalised in closed form."""
    vol_shape = tuple(volume.shape[:3])
    if any(s < w for s, w in zip(vol_shape, window)):
        pads = []
        for s, w in zip(vol_shape, window):
            need = max(0, int(w) - int(s))
            pads.append((need // 2, need - need // 2))
        out = predict_volume_device(
            apply_fn, _pad_device(volume, pads, "reflect"), window, stride, sw_batch,
            out_channels, acc_dtype, sigma_scale,
        )
        return out[
            pads[0][0] : pads[0][0] + vol_shape[0],
            pads[1][0] : pads[1][0] + vol_shape[1],
            pads[2][0] : pads[2][0] + vol_shape[2],
        ]
    if all(w % s == 0 for w, s in zip(window, stride)):
        cover, imp, inv_weight = regular_cover_setup_device(
            vol_shape, window, stride, volume.device, sigma_scale
        )
        volp = _pad_device(volume, [(0, c - s) for c, s in zip(cover, vol_shape)], "reflect")
        out = sliding_window_regular(
            apply_fn, volp, imp, inv_weight, window, stride, sw_batch, out_channels, acc_dtype
        )
        return out[: vol_shape[0], : vol_shape[1], : vol_shape[2]]
    grids = [np.asarray(compute_grid_1d(s, w, st), np.int32) for s, w, st in zip(vol_shape, window, stride)]
    origins = np.stack(np.meshgrid(*grids, indexing="ij"), axis=-1).reshape(-1, 3)
    origins, valid = _pad_grid_with_valid(origins, sw_batch)
    profiles = _separable_bump_profiles(window, sigma_scale)
    imp = _outer3(*(torch.as_tensor(p, dtype=torch.float32, device=volume.device) for p in profiles))[..., None]
    value = sliding_window_scatter(
        apply_fn, volume, origins, imp, window, sw_batch, out_channels, acc_dtype, valid
    )
    inv = [
        torch.as_tensor(_snap_grid_inv_weight_1d(s, w, st, p), dtype=acc_dtype, device=volume.device)
        for s, w, st, p in zip(vol_shape, window, stride, profiles)
    ]
    return value * _outer3(*inv)[..., None]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class SlidingWindowEngine:
    """Grid planning, padding, the device pass and normalisation for one
    model forward ``apply_fn`` on ``device``."""

    # bytes of device memory the cached blend normalisers may hold together
    INV_WEIGHT_CACHE_BYTES = 2 << 30

    def __init__(
        self,
        apply_fn: ApplyFn,
        window: Sequence[int],
        overlap: float = 0.5,
        stride: Optional[Sequence[int]] = None,
        blending: str = "bump",
        sigma_scale: float = 0.125,
        sw_batch_size: int = 4,
        padding_mode: str = "reflect",
        snap_to_edge: bool = True,
        border_mask: Optional[Sequence[int]] = None,
        acc_dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cuda",
    ):
        self.apply_fn = apply_fn
        self.window = tuple(int(w) for w in window)
        self.overlap = overlap
        self.stride = stride
        self.sw_batch = int(sw_batch_size)
        self.padding_mode = padding_mode
        self.snap = snap_to_edge
        self.acc_dtype = acc_dtype
        self.device = torch.device(device)
        imp = importance_map(self.window, blending, sigma_scale)
        if border_mask:
            # zero a border band of each window (reference window.py:297)
            bz, by, bx = border_mask
            m = np.zeros_like(imp)
            m[bz : imp.shape[0] - bz or None, by : imp.shape[1] - by or None, bx : imp.shape[2] - bx or None] = 1
            imp = np.clip(imp * m, 1e-6, None)
        self.imp = torch.as_tensor(imp[..., None], device=self.device)
        self._invw_cache: Dict[tuple, torch.Tensor] = {}

    def probe_out_channels(self, in_channels: int) -> int:
        with torch.inference_mode():
            x = torch.zeros((1, *self.window, in_channels), device=self.device)
            return int(self.apply_fn(x).shape[-1])

    def effective_stride(self) -> Tuple[int, int, int]:
        if self.stride is not None:
            return tuple(int(s) for s in self.stride)
        return tuple(max(1, int(round(w * (1.0 - self.overlap)))) for w in self.window)

    def __call__(self, volume: np.ndarray, out_channels: Optional[int] = None) -> np.ndarray:
        """volume (Z,Y,X) or (Z,Y,X,Cin) -> (Z,Y,X,Cout) float32 numpy."""
        vol = torch.from_numpy(np.asarray(volume, dtype=np.float32))
        return _to_host(self.predict_tensor(vol.to(self.device), out_channels))

    def predict_tensor(self, vol: torch.Tensor, out_channels: Optional[int] = None) -> torch.Tensor:
        """(Z,Y,X) or (Z,Y,X,Cin) float32 tensor on the engine's device ->
        (Z,Y,X,Cout) float32 tensor on the device."""
        if vol.dim() == 3:
            vol = vol[..., None]
        orig_shape = tuple(vol.shape[:3])
        pads = []
        for s, w in zip(orig_shape, self.window):
            need = max(0, w - s)
            pads.append((need // 2, need - need // 2))
        if any(p != (0, 0) for p in pads):
            vol = _pad_device(vol, pads, self.padding_mode)
        if out_channels is None:
            out_channels = self.probe_out_channels(vol.shape[-1])
        stride = self.effective_stride()
        with torch.inference_mode():
            if all(w % s == 0 for w, s in zip(self.window, stride)):
                out = self._call_regular(vol, stride, out_channels)
            else:
                vol_shape = tuple(vol.shape[:3])
                grid = compute_window_grid(vol_shape, self.window, self.overlap, self.stride, self.snap)
                # a snap=False grid may overshoot size - window: clamp in-bounds
                # (duplicates kept, as the JAX engine's dynamic_slice does)
                grid = np.minimum(grid, np.asarray(vol_shape) - np.asarray(self.window)).astype(np.int32)
                invw = self._snap_inv_weight(vol_shape, grid)
                grid, valid = _pad_grid_with_valid(grid, self.sw_batch)
                value = sliding_window_scatter(
                    self.apply_fn, vol, grid, self.imp, self.window, self.sw_batch, out_channels,
                    self.acc_dtype, valid,
                )
                out = value * invw
            sl = tuple(slice(p[0], p[0] + s) for p, s in zip(pads, orig_shape))
            return out[sl].float()

    def _snap_inv_weight(self, vol_shape, grid: np.ndarray) -> torch.Tensor:
        """Cached 1/weight per (shape, grid), on the device; the cache drops
        its oldest entries beyond ``INV_WEIGHT_CACHE_BYTES``."""
        key = (tuple(int(s) for s in vol_shape), grid.tobytes())
        invw = self._invw_cache.get(key)
        if invw is None:
            invw = inv_weight_scatter(grid, self.imp, key[0], self.window)
            self._invw_cache[key] = invw
            while sum(t.numel() * t.element_size() for t in self._invw_cache.values()) > (
                self.INV_WEIGHT_CACHE_BYTES
            ) and len(self._invw_cache) > 1:
                self._invw_cache.pop(next(iter(self._invw_cache)))
        return invw

    def _call_regular(self, vol: torch.Tensor, stride, out_channels: int) -> torch.Tensor:
        """Dense parity-group path: the volume is padded at the far end so the
        regular grid covers it fully (same coverage as snap-to-edge)."""
        cover, extra = [], []
        for size, w, s in zip(vol.shape[:3], self.window, stride):
            n = max(1, -(-(size - w) // s) + 1)
            cover.append((n - 1) * s + w)
            extra.append(cover[-1] - size)
        if any(extra):
            vol = _pad_device(vol, [(0, e) for e in extra], self.padding_mode)
        grids = [np.arange(0, c - w + 1, s, dtype=np.int32) for c, w, s in zip(cover, self.window, stride)]
        origins = np.stack(np.meshgrid(*grids, indexing="ij"), axis=-1).reshape(-1, 3)
        invw = self._snap_inv_weight(tuple(cover), origins)
        return sliding_window_regular(
            self.apply_fn, vol, self.imp, invw, self.window, tuple(stride), self.sw_batch, out_channels,
            self.acc_dtype,
        )


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy through pinned memory (a pageable copy of a
    large volume runs at a fraction of the link's rate)."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def make_engine(
    apply_fn: ApplyFn, cfg: SlidingWindowConfig, input_size: Sequence[int], device="cuda"
) -> SlidingWindowEngine:
    return SlidingWindowEngine(
        apply_fn,
        window=cfg.window_size or list(input_size),
        overlap=cfg.overlap,
        stride=cfg.stride,
        blending=cfg.blending,
        sigma_scale=cfg.sigma_scale,
        sw_batch_size=cfg.sw_batch_size,
        padding_mode=cfg.padding_mode,
        snap_to_edge=cfg.snap_to_edge,
        border_mask=cfg.border_mask,
        acc_dtype=getattr(torch, str(cfg.acc_dtype)),
        device=device,
    )
