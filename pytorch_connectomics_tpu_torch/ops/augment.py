"""On-device augmentation, the port of ``pytorch_connectomics_tpu/ops/augment_jax.py``:
the 13 transforms of ``_DEVICE_ORDER`` (``:245-259``) and
``build_device_augment_fn`` (``:262-292``).

Plain PyTorch on the batch's device, channels-last ``(N, Z, Y, X, C)``, as
the port's batches are; JAX's is ``jnp`` code that XLA fuses, with no
Pallas kernel. Each transform is two functions:

- ``draw(gen, n, shape, **kw)``: the per-sample decisions and parameters of
  ``n`` samples of ``shape`` (Z, Y, X, C), a dict of tensors with a leading
  ``n``, taken from the ``torch.Generator`` ``gen`` on the device;
- ``apply(batch, draws, **kw)``: the whole batch at once, each sample's
  decision a mask (``torch.where`` over the batch).

The draws' bits are not ``jax.random``'s (ROADMAP C.4); ``apply`` on JAX's
own draws gives JAX's batch (the tests replay them). Geometric transforms
(flip, transpose, rotate, misalignment) move ``image``, ``label``, ``mask``
and ``weight``; the others touch ``image`` only. ``transpose`` and
``rotate`` leave a key whose (y, x) is not square as it is.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

Batch = Dict[str, torch.Tensor]
_GEOM_KEYS = ("image", "label", "mask", "weight")


def _u(gen, n, lo=0.0, hi=1.0):
    return torch.rand(n, generator=gen, device=gen.device) * (hi - lo) + lo


def _bern(gen, n, p):
    return _u(gen, n) < p


def _ints(gen, lo, hi, size):
    return torch.randint(lo, hi, size, generator=gen, device=gen.device)


def _b(mask: torch.Tensor, ndim: int = 5) -> torch.Tensor:
    """(n,) or (n, Z) per-sample values broadcast over a (N, Z, Y, X, C) batch."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def _geom(batch: Batch):
    return [k for k in _GEOM_KEYS if k in batch]


def _roll_yx(v: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """``jnp.roll`` of each sample by its own (dy, dx) on (y, x)."""
    n, _, y, x, _ = v.shape
    iy = (torch.arange(y, device=v.device)[None] - dy[:, None]) % y
    ix = (torch.arange(x, device=v.device)[None] - dx[:, None]) % x
    b = torch.arange(n, device=v.device)[:, None, None]
    return v[b, :, iy[:, :, None], ix[:, None, :], :].permute(0, 3, 1, 2, 4)


def _z_mask(z: int, idx: torch.Tensor) -> torch.Tensor:
    """(n, z) bool: True at each sample's indices ``idx`` (n, k)."""
    m = torch.zeros(idx.shape[0], z, dtype=torch.bool, device=idx.device)
    return m.scatter(1, idx, True)


def _grid(shape, device):
    z, y, x = shape
    return (torch.arange(z, device=device).view(1, z, 1, 1, 1), torch.arange(y, device=device).view(1, 1, y, 1, 1),
            torch.arange(x, device=device).view(1, 1, 1, x, 1))


# -- geometric -------------------------------------------------------------


def flip_draw(gen, n, shape, prob=0.5, **_):
    return {"do": _u(gen, (n, 3)) < prob}


def flip_apply(batch: Batch, d, **_) -> Batch:
    out = dict(batch)
    for axis in range(3):
        for k in _geom(out):
            out[k] = torch.where(_b(d["do"][:, axis]), out[k].flip(axis + 1), out[k])
    return out


def transpose_draw(gen, n, shape, prob=0.5, **_):
    return {"do": _bern(gen, n, prob)}


def transpose_apply(batch: Batch, d, **_) -> Batch:
    out = dict(batch)
    for k in _geom(out):
        if out[k].shape[2] == out[k].shape[3]:
            out[k] = torch.where(_b(d["do"]), out[k].transpose(2, 3), out[k])
    return out


def rotate_draw(gen, n, shape, prob=0.5, **_):
    return {"do": _bern(gen, n, prob), "k": _ints(gen, 1, 4, (n,))}


def rotate_apply(batch: Batch, d, **_) -> Batch:
    out = dict(batch)
    k = _b(d["k"])
    for name in _geom(out):
        v = out[name]
        if v.shape[2] != v.shape[3]:
            continue
        r1, r2, r3 = (torch.rot90(v, i, dims=(2, 3)) for i in (1, 2, 3))
        out[name] = torch.where(_b(d["do"]), torch.where(k == 1, r1, torch.where(k == 2, r2, r3)), v)
    return out


def misalignment_draw(gen, n, shape, prob=0.3, displacement=12, **_):
    z = shape[0]
    return {"zi": _ints(gen, 1, max(2, z), (n,)), "dy": _ints(gen, -displacement, displacement + 1, (n,)),
            "dx": _ints(gen, -displacement, displacement + 1, (n,)), "do": _bern(gen, n, prob)}


def misalignment_apply(batch: Batch, d, **_) -> Batch:
    """Each key's sections from ``zi`` up rolled by (dy, dx)."""
    out = dict(batch)
    z = out["image"].shape[1]
    sel = _b(d["do"][:, None] & (torch.arange(z, device=d["zi"].device)[None] >= d["zi"][:, None]))
    for k in _geom(out):
        out[k] = torch.where(sel, _roll_yx(out[k], d["dy"], d["dx"]), out[k])
    return out


# -- image only ------------------------------------------------------------


def missing_section_draw(gen, n, shape, prob=0.3, num_sections=2, **_):
    return {"idx": _ints(gen, 0, shape[0], (n, max(1, num_sections))), "do": _bern(gen, n, prob)}


def missing_section_apply(batch: Batch, d, **_) -> Batch:
    out = dict(batch)
    img = out["image"]
    zmask = (~_z_mask(img.shape[1], d["idx"])).to(img.dtype)
    out["image"] = torch.where(_b(d["do"]), img * _b(zmask), img)
    return out


def slice_shift_draw(gen, n, shape, prob=0.2, max_shift=8, num_slices=2, **_):
    m = int(max_shift)
    return {"zsel": _ints(gen, 0, shape[0], (n, int(num_slices))), "sy": _ints(gen, -m, m + 1, (n,)),
            "sx": _ints(gen, -m, m + 1, (n,)), "do": _bern(gen, n, prob)}


def slice_shift_apply(batch: Batch, d, **_) -> Batch:
    out = dict(batch)
    img = out["image"]
    sel = _b(d["do"][:, None] & _z_mask(img.shape[1], d["zsel"]))
    out["image"] = torch.where(sel, _roll_yx(img, d["sy"], d["sx"]), img)
    return out


def missing_parts_draw(gen, n, shape, prob=0.2, hole_size=24, **_):
    z, y, x = shape[:3]
    return {"zi": _ints(gen, 0, z, (n,)), "oy": _ints(gen, 0, max(1, y - hole_size), (n,)),
            "ox": _ints(gen, 0, max(1, x - hole_size), (n,)), "do": _bern(gen, n, prob)}


def missing_parts_apply(batch: Batch, d, hole_size=24, **_) -> Batch:
    out = dict(batch)
    img = out["image"]
    zz, yy, xx = _grid(img.shape[1:4], img.device)
    oy, ox = _b(d["oy"]), _b(d["ox"])
    box = (zz == _b(d["zi"])) & (yy >= oy) & (yy < oy + hole_size) & (xx >= ox) & (xx < ox + hole_size)
    out["image"] = torch.where(_b(d["do"]) & box, torch.zeros((), dtype=img.dtype, device=img.device), img)
    return out


def _box1d(v: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Mean of the ``k`` neighbours ``i - k//2 .. i + k - 1 - k//2`` on
    ``axis``, edge-padded, as JAX's ``box1d``. JAX differences cumulative
    sums; the port adds the k shifted slices in order, so the card and the
    CPU round alike (a scan's order is the device's)."""
    n = v.shape[axis]
    idx = torch.clamp(torch.arange(-(k // 2), n + k - 1 - k // 2, device=v.device), 0, n - 1)
    vp = v.index_select(axis, idx)
    total = vp.narrow(axis, 0, n)
    for j in range(1, k):
        total = total + vp.narrow(axis, j, n)
    return total / k


def motion_blur_draw(gen, n, shape, prob=0.2, sections=2, kernel_size=9, **_):
    return {"along_x": _bern(gen, n, 0.5), "zsel": _ints(gen, 0, shape[0], (n, int(sections))),
            "do": _bern(gen, n, prob)}


def motion_blur_apply(batch: Batch, d, kernel_size=9, **_) -> Batch:
    """A k-wide box blur along x or y on the drawn sections."""
    out = dict(batch)
    img = out["image"]
    k = int(kernel_size)
    blurred = torch.where(_b(d["along_x"]), _box1d(img, 3, k), _box1d(img, 2, k))
    out["image"] = torch.where(_b(d["do"][:, None] & _z_mask(img.shape[1], d["zsel"])), blurred, img)
    return out


def _cut_lengths(shape, length_ratio):
    return tuple(max(1, int(s * length_ratio)) for s in shape[:3])


def cut_noise_draw(gen, n, shape, prob=0.2, length_ratio=0.4, scale=0.3, **_):
    (z, y, x), (lz, ly, lx) = shape[:3], _cut_lengths(shape, length_ratio)
    return {"oz": _ints(gen, 0, z - lz + 1, (n,)), "oy": _ints(gen, 0, y - ly + 1, (n,)),
            "ox": _ints(gen, 0, x - lx + 1, (n,)), "noise": _u(gen, (n, *shape), -scale, scale),
            "do": _bern(gen, n, prob)}


def cut_noise_apply(batch: Batch, d, length_ratio=0.4, **_) -> Batch:
    out = dict(batch)
    img = out["image"]
    lz, ly, lx = _cut_lengths(img.shape[1:], length_ratio)
    zz, yy, xx = _grid(img.shape[1:4], img.device)
    oz, oy, ox = _b(d["oz"]), _b(d["oy"]), _b(d["ox"])
    box = (zz >= oz) & (zz < oz + lz) & (yy >= oy) & (yy < oy + ly) & (xx >= ox) & (xx < ox + lx)
    out["image"] = torch.where(_b(d["do"]) & box, torch.clamp(img + d["noise"], 0.0, 1.0), img)
    return out


def stripe_draw(gen, n, shape, prob=0.1, intensity=0.15, num_stripes=4, **_):
    ns = int(num_stripes)
    return {"rows": _ints(gen, 0, shape[1], (n, ns)), "deltas": _u(gen, (n, ns), -intensity, intensity),
            "do": _bern(gen, n, prob)}


def stripe_apply(batch: Batch, d, **_) -> Batch:
    """Brightness deltas added to the drawn y rows."""
    out = dict(batch)
    img = out["image"]
    row = torch.zeros(img.shape[0], img.shape[2], dtype=d["deltas"].dtype, device=img.device)
    row = row.scatter_add(1, d["rows"], d["deltas"])
    out["image"] = torch.where(_b(d["do"]), torch.clamp(img + row[:, None, :, None, None], 0.0, 1.0), img)
    return out


def intensity_draw(gen, n, shape, gaussian_noise_prob=0.5, gaussian_noise_std=0.1, shift_intensity_prob=0.5,
                   shift_intensity_offset=0.1, contrast_prob=0.5, contrast_range=(0.8, 1.2), **_):
    return {"noise": torch.randn((n, *shape), generator=gen, device=gen.device),
            "do_noise": _bern(gen, n, gaussian_noise_prob),
            "shift": _u(gen, n, -shift_intensity_offset, shift_intensity_offset),
            "do_shift": _bern(gen, n, shift_intensity_prob),
            "factor": _u(gen, n, contrast_range[0], contrast_range[1]), "do_contrast": _bern(gen, n, contrast_prob)}


def intensity_apply(batch: Batch, d, gaussian_noise_std=0.1, **_) -> Batch:
    """Gaussian noise, an intensity shift and a contrast change about the
    sample's mean, each drawn on or off, then a clip to [0, 1]."""
    out = dict(batch)
    img = out["image"]
    img = torch.where(_b(d["do_noise"]), img + d["noise"] * gaussian_noise_std, img)
    img = torch.where(_b(d["do_shift"]), img + _b(d["shift"]), img)
    mean = img.mean(dim=(1, 2, 3, 4), keepdim=True)
    img = torch.where(_b(d["do_contrast"]), (img - mean) * _b(d["factor"]) + mean, img)
    out["image"] = torch.clamp(img, 0.0, 1.0)
    return out


def mul_add_draw(gen, n, shape, prob=0.5, mul_range=(0.9, 1.1), add_range=(-0.1, 0.1), **_):
    return {"mul": _u(gen, n, *mul_range), "add": _u(gen, n, *add_range), "do": _bern(gen, n, prob)}


def mul_add_apply(batch: Batch, d, **_) -> Batch:
    out = dict(batch)
    img = out["image"]
    out["image"] = torch.where(_b(d["do"]), torch.clamp(img * _b(d["mul"]) + _b(d["add"]), 0.0, 1.0), img)
    return out


def gamma_draw(gen, n, shape, prob=0.3, gamma_range=(0.7, 1.5), **_):
    return {"gamma": _u(gen, n, *gamma_range), "do": _bern(gen, n, prob)}


def gamma_apply(batch: Batch, d, **_) -> Batch:
    out = dict(batch)
    img = out["image"]
    out["image"] = torch.where(_b(d["do"]), torch.clamp(img, 1e-6, 1.0) ** _b(d["gamma"]), img)
    return out


# (name, draw, apply, geometric) in JAX's _DEVICE_ORDER
DEVICE_ORDER: List[Tuple[str, Callable, Callable, bool]] = [
    ("flip", flip_draw, flip_apply, True),
    ("transpose", transpose_draw, transpose_apply, True),
    ("rotate", rotate_draw, rotate_apply, True),
    ("misalignment", misalignment_draw, misalignment_apply, True),
    ("missing_section", missing_section_draw, missing_section_apply, False),
    ("slice_shift", slice_shift_draw, slice_shift_apply, False),
    ("missing_parts", missing_parts_draw, missing_parts_apply, False),
    ("motion_blur", motion_blur_draw, motion_blur_apply, False),
    ("cut_noise", cut_noise_draw, cut_noise_apply, False),
    ("stripe", stripe_draw, stripe_apply, False),
    ("intensity", intensity_draw, intensity_apply, False),
    ("mul_add", mul_add_draw, mul_add_apply, False),
    ("gamma", gamma_draw, gamma_apply, False),
]


def device_steps(cfg) -> List[Tuple[str, Callable, Callable, Dict]]:
    """The enabled transforms of an ``AugmentationConfig`` with a device
    form, in order, each with its keyword arguments (lists as tuples,
    ``spatial_axes`` dropped)."""
    if cfg is None or not cfg.enabled:
        return []
    steps = []
    for name, draw, apply, _ in DEVICE_ORDER:
        block = getattr(cfg, name, None)
        if not block or not block.get("enabled", True):
            continue
        kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in block.items()
                  if k not in ("enabled", "spatial_axes")}
        steps.append((name, draw, apply, kwargs))
    return steps


def build_device_augment_fn(cfg) -> Optional[Callable[[Batch, torch.Generator], Batch]]:
    """``AugmentationConfig`` -> ``augment(batch, generator) -> batch``, the
    transforms with a device form in JAX's order (elastic and the other
    host-only transforms are not among them); None when none is enabled."""
    steps = device_steps(cfg)
    if not steps:
        return None

    def augment(batch: Batch, gen: torch.Generator) -> Batch:
        n, shape = batch["image"].shape[0], tuple(batch["image"].shape[1:])
        for _, draw, apply, kwargs in steps:
            batch = apply(batch, draw(gen, n, shape, **kwargs), **kwargs)
        return batch

    return augment
