"""Synthetic EM volumes (Lucchi++-style mitochondria tasks), the port of
``pytorch_connectomics_tpu/data/synthetic_jax.py:33-148``.

Each generator is split in two:

- *draws*: every random number the volume needs, taken from a
  ``torch.Generator`` on the CPU (so one seed gives the same volume on any
  device);
- a deterministic *transform* of those draws, run on the given device:
  smooth random fields (low-resolution noise, tricubic resize, percentile
  normalisation), thresholds, intensity composition, serial-section
  artefacts and sensor noise.

The draws of JAX's ``jax.random`` and of a ``torch.Generator`` differ for
one seed, so a volume of the port is not the JAX package's volume for the
same URL; fed the draws that JAX's keys produce, the transform gives JAX's
volume (``tests/test_torch_data.py``).

Two details follow JAX exactly: ``jax.image.resize(method="cubic")`` is the
Keys cubic kernel with a = -0.5, half-pixel centres and weights renormalised
at the edges (torch's bicubic uses a = -0.75 and has no 3-D form), and
``jnp.percentile`` interpolates linearly between order statistics (found
with ``kthvalue``: ``torch.quantile`` refuses inputs over 2^24 elements).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Shape = Tuple[int, int, int]

# feature sizes (voxels) of the smooth fields, per generator
_V1_FIELDS = {"mito": 22.0, "cristae": 4.0, "distract": 14.0, "dtex": 7.0, "cyto": 9.0, "gain": 90.0}
_V2_FIELDS = {"mito": 22.0, "cristae": 3.5, "distract": 22.0, "dtex": 11.0, "cyto": 9.0, "gain": 90.0}


def low_shape(shape: Shape, feature_voxels: float) -> Shape:
    """Shape of the low-resolution noise of a smooth field."""
    return tuple(max(2, int(round(s / feature_voxels))) for s in shape)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize(method="cubic")``
    along one axis (antialiased when shrinking, as JAX's default)."""
    inv = 1.0 / (n_out / n_in)
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kscale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(x: torch.Tensor, shape: Shape) -> torch.Tensor:
    """Separable tricubic resize of a 3-D float32 tensor to ``shape``."""
    for axis, n_out in enumerate(shape):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = cubic_weights(n_in, n_out, x.device)
        x = torch.movedim(torch.tensordot(torch.movedim(x, axis, -1), w, dims=1), -1, axis)
    return x


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear interpolation), in float32."""
    flat = x.reshape(-1)
    n = flat.numel()
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = torch.tensor(pos - np.float32(lo), dtype=torch.float32, device=x.device)
    v_lo = flat.kthvalue(lo + 1).values
    v_hi = v_lo if hi == lo else flat.kthvalue(hi + 1).values
    return v_lo * (1.0 - w_hi) + v_hi * w_hi


def smooth_field(noise: torch.Tensor, shape: Shape) -> torch.Tensor:
    """Smooth random field in [0, 1] from its low-resolution normal noise."""
    field = resize_cubic(noise.float(), shape)
    lo, hi = percentile(field, 2.0), percentile(field, 98.0)
    return torch.clamp((field - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def band_noise(noise: torch.Tensor, shape: Shape, amp: float) -> torch.Tensor:
    return amp * (2.0 * smooth_field(noise, shape) - 1.0)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def em_draws(shape: Shape, seed: int, v2: bool = True) -> Dict[str, torch.Tensor]:
    """Every random number of one volume, on the CPU: the low-resolution
    noise of each smooth field, the per-slice gain and the sensor noise,
    and for v2 the per-slice (y, x) shifts and the blanked slice."""
    g = torch.Generator().manual_seed(int(seed))
    fields = _V2_FIELDS if v2 else _V1_FIELDS
    d = {k: torch.randn(low_shape(shape, fv), generator=g) for k, fv in fields.items()}
    d["slice_gain"] = torch.randn((shape[0], 1, 1), generator=g)
    d["noise"] = torch.randn(shape, generator=g)
    if v2:
        d["shifts"] = torch.randint(-2, 3, (shape[0], 2), generator=g)
        d["zmiss"] = torch.randint(1, shape[0] - 1, (), generator=g)
    return d


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _roll_slices(v: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``v[z]`` rolled by ``shifts[z] = (sy, sx)`` along (y, x)."""
    z, y, x = v.shape
    yi = (torch.arange(y, device=v.device)[None, :] - shifts[:, :1]) % y
    xi = (torch.arange(x, device=v.device)[None, :] - shifts[:, 1:]) % x
    zi = torch.arange(z, device=v.device)
    return v[zi[:, None, None], yi[:, :, None], xi[:, None, :]]


def synthetic_em_volume(
    draws: Dict[str, torch.Tensor], shape: Shape, mito_fraction: float = 0.12, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """v1 task from its draws: (image float32 [0,1] (Z,Y,X), label uint8)."""
    d = {k: v.to(device) for k, v in draws.items()}
    mito_field = smooth_field(d["mito"], shape)
    thr = percentile(mito_field, 100.0 * (1.0 - mito_fraction))
    mito = mito_field > thr
    rim = (mito_field > thr - 0.035) & ~mito
    cristae = smooth_field(d["cristae"], shape)
    distract_field = smooth_field(d["distract"], shape)
    dthr = percentile(distract_field, 91.0)
    distract = distract_field > dthr
    drim = (distract_field > dthr - 0.030) & ~distract
    dtex = smooth_field(d["dtex"], shape)
    img = torch.full(shape, 0.70, dtype=torch.float32, device=device)
    img = img + band_noise(d["cyto"], shape, 0.08)
    img = torch.where(mito, 0.45 + 0.16 * cristae, img)
    img = torch.where(rim, torch.full_like(img, 0.22), img)
    img = torch.where(distract & ~mito & ~rim, 0.47 + 0.15 * dtex, img)
    img = torch.where(drim & ~mito & ~rim & ~distract, torch.full_like(img, 0.34), img)
    img = img * (1.0 + band_noise(d["gain"], shape, 0.10))
    img = img * (1.0 + 0.05 * d["slice_gain"])
    img = img + 0.06 * d["noise"]
    return torch.clamp(img, 0.0, 1.0), mito.to(torch.uint8)


def synthetic_em_volume_v2(
    draws: Dict[str, torch.Tensor], shape: Shape, mito_fraction: float = 0.12, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """v2 task from its draws: distractors share the mito scale, intensity
    and rim, only their texture frequency differs; per-slice misalignment,
    one blanked section, stronger noise. (image float32 [0,1], label uint8)."""
    d = {k: v.to(device) for k, v in draws.items()}
    mito_field = smooth_field(d["mito"], shape)
    thr = percentile(mito_field, 100.0 * (1.0 - mito_fraction))
    mito = mito_field > thr
    rim = (mito_field > thr - 0.035) & ~mito
    cristae = smooth_field(d["cristae"], shape)
    distract_field = smooth_field(d["distract"], shape)
    dthr = percentile(distract_field, 100.0 * (1.0 - mito_fraction))
    distract = (distract_field > dthr) & ~mito & ~rim
    drim = (distract_field > dthr - 0.035) & ~distract & ~mito & ~rim
    dtex = smooth_field(d["dtex"], shape)
    img = torch.full(shape, 0.70, dtype=torch.float32, device=device)
    img = img + band_noise(d["cyto"], shape, 0.08)
    img = torch.where(mito, 0.45 + 0.16 * cristae, img)
    img = torch.where(rim, torch.full_like(img, 0.26), img)
    img = torch.where(distract, 0.45 + 0.16 * dtex, img)
    img = torch.where(drim, torch.full_like(img, 0.26), img)
    img = img * (1.0 + band_noise(d["gain"], shape, 0.10))
    img = img * (1.0 + 0.05 * d["slice_gain"])
    img = _roll_slices(img, d["shifts"])
    lbl = _roll_slices(mito.to(torch.uint8), d["shifts"])
    img[d["zmiss"]] = 0.5
    img = img + 0.09 * d["noise"]
    return torch.clamp(img, 0.0, 1.0), lbl


def synthetic_em_task(task: str, shape: Shape, seed: int, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(image uint8, label uint32) host arrays of the ``em``/``em2`` task for
    ``seed``, generated on ``device``."""
    shape = tuple(int(s) for s in shape)
    if task == "em2":
        img, lbl = synthetic_em_volume_v2(em_draws(shape, seed, v2=True), shape, device=device)
    elif task == "em":
        img, lbl = synthetic_em_volume(em_draws(shape, seed, v2=False), shape, device=device)
    else:
        raise NotImplementedError(f"synthetic task '{task}' is not ported yet (em and em2 only)")
    img = torch.clamp(img * 255.0, 0, 255).to(torch.uint8)
    return img.cpu().numpy(), lbl.cpu().numpy().astype(np.uint32)
