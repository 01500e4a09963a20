"""Host augmentation transforms (numpy and scipy), the port of the 21
transforms of ``pytorch_connectomics_tpu/data/augment/ops.py``: geometric
(flip, axis permute, transpose, rot90, affine, elastic), EM artefacts
(misalignment, missing and lost sections, slice drop and shift, missing
parts, motion blur, stripes), intensity (noise, shift, contrast, inversion;
mul-add; gamma) and mixing (cut blur, cut noise, mixup, copy-paste).

A sample is a dict ``{"image": (C, Z, Y, X) float32, "label": (C, Z, Y, X),
...}``. Each transform takes the sample and an ``np.random.Generator`` and
draws from it in the JAX package's order, call for call, so one generator
gives the same sample in both packages. Geometric transforms move image,
label, mask, auxiliary label and weight together (the image interpolated,
the others nearest); the others touch the image only, except where said.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy import ndimage

Sample = Dict[str, np.ndarray]

GEOM_KEYS = ("image", "label", "mask", "label_aux", "weight")


def _with_image(sample: Sample, img: np.ndarray) -> Sample:
    out = dict(sample)
    out["image"] = img
    return out


def _geom_apply(sample: Sample, fn) -> Sample:
    """``fn(array, is_image)`` applied to every geometric key present."""
    out = dict(sample)
    for k in GEOM_KEYS:
        if out.get(k) is not None:
            out[k] = fn(out[k], k == "image")
    return out


def _shift_zero(v: np.ndarray, d0: int, d1: int) -> np.ndarray:
    """``v`` shifted by (d0, d1) in its last two axes, zero-filled (no wrap)."""
    h, w = v.shape[-2], v.shape[-1]
    moved = np.zeros_like(v)
    src = (slice(max(0, -d0), min(h, h - d0)), slice(max(0, -d1), min(w, w - d1)))
    dst = (slice(max(0, d0), min(h, h + d0)), slice(max(0, d1), min(w, w + d1)))
    moved[(..., *dst)] = v[(..., *src)]
    return moved


# -- geometric ---------------------------------------------------------------


def rand_flip(sample: Sample, rng, prob=0.5, axes=(1, 2, 3)) -> Sample:
    flips = [a for a in axes if rng.random() < prob]
    if not flips:
        return sample
    return _geom_apply(sample, lambda v, _: np.flip(v, axis=[a for a in flips if a < v.ndim]).copy())


def rand_rotate90(sample: Sample, rng, prob=0.5, spatial_axes=(1, 2)) -> Sample:
    """k * 90 degrees, k in 1..3, in the plane of ``spatial_axes`` (spatial
    indices: 1, 2 is (y, x))."""
    if rng.random() >= prob:
        return sample
    k = int(rng.integers(1, 4))
    axes = tuple(a + 1 for a in spatial_axes)
    return _geom_apply(sample, lambda v, _: np.rot90(v, k, axes=axes).copy())


def rand_transpose(sample: Sample, rng, prob=0.5) -> Sample:
    """y and x swapped (square in-plane patches)."""
    if rng.random() >= prob:
        return sample
    return _geom_apply(sample, lambda v, _: np.swapaxes(v, 2, 3).copy())


def rand_axis_permute(sample: Sample, rng, prob=0.5) -> Sample:
    """A random permutation of the three spatial axes (isotropic patches)."""
    if rng.random() >= prob:
        return sample
    order = (0,) + tuple(int(p) + 1 for p in rng.permutation(3))
    return _geom_apply(sample, lambda v, _: np.transpose(v, order).copy())


def rand_elastic(sample: Sample, rng, prob=0.3, sigma=16.0, alpha=20.0) -> Sample:
    """One smooth in-plane displacement field (Gaussian-filtered noise of
    ``sigma``, scaled by ``alpha``) for every z section; image linear,
    others nearest, reflected at the border."""
    if rng.random() >= prob:
        return sample
    _, _, y, x = sample["image"].shape
    dy = ndimage.gaussian_filter(rng.standard_normal((y, x)), sigma) * alpha
    dx = ndimage.gaussian_filter(rng.standard_normal((y, x)), sigma) * alpha
    yy, xx = np.meshgrid(np.arange(y), np.arange(x), indexing="ij")
    coords = [np.clip(yy + dy, 0, y - 1), np.clip(xx + dx, 0, x - 1)]

    def warp(v, is_image):
        out = np.empty_like(v)
        for ci in range(v.shape[0]):
            for zi in range(v.shape[1]):
                out[ci, zi] = ndimage.map_coordinates(v[ci, zi], coords, order=1 if is_image else 0, mode="reflect")
        return out

    return _geom_apply(sample, warp)


def _rotation(angle: float, axis: int) -> np.ndarray:
    m = np.eye(3)
    if angle:
        i, j = [a for a in range(3) if a != axis]
        c, s = np.cos(angle), np.sin(angle)
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def rand_affine(sample: Sample, rng, prob=0.2, rotate_range=(0.0, 0.0, 0.0), scale_range=(0.0, 0.0, 0.0),
                shear_range=(0.0, 0.0, 0.0)) -> Sample:
    """A 3-D affine about the patch centre: rotations U(-r, r) radians about
    each axis, scales 1 + U(-s, s), shears U(-h, h); image linear, others
    nearest, reflected at the border."""
    if rng.random() >= prob:
        return sample
    rot = [float(rng.uniform(-r, r)) if r else 0.0 for r in rotate_range]
    scl = [1.0 + (float(rng.uniform(-s, s)) if s else 0.0) for s in scale_range]
    shr = [float(rng.uniform(-h, h)) if h else 0.0 for h in shear_range]
    shear = np.eye(3)
    shear[0, 1], shear[0, 2], shear[1, 2] = shr
    mat = _rotation(rot[0], 0) @ _rotation(rot[1], 1) @ _rotation(rot[2], 2) @ shear @ np.diag(scl)

    def apply(v, is_image):
        out = np.empty_like(v)
        center = (np.asarray(v.shape[1:], np.float64) - 1.0) / 2.0
        offset = center - mat @ center
        for ci in range(v.shape[0]):
            out[ci] = ndimage.affine_transform(v[ci], mat, offset=offset, order=1 if is_image else 0, mode="reflect")
        return out

    return _geom_apply(sample, apply)


# -- EM artefacts ------------------------------------------------------------


def rand_misalignment(sample: Sample, rng, prob=0.3, displacement=12, rotate_ratio=0.0) -> Sample:
    """Every section from a random z on shifted by up to ``displacement``
    voxels in y and x (zero fill), or with probability ``rotate_ratio``
    rotated by U(-5, 5) degrees; all geometric keys alike."""
    if rng.random() >= prob:
        return sample
    z = sample["image"].shape[1]
    if z < 2:
        return sample
    zi = int(rng.integers(1, z))
    if rng.random() < rotate_ratio:
        angle = float(rng.uniform(-5.0, 5.0))

        def move(v, is_image):
            out = v.copy()
            for ci in range(v.shape[0]):
                out[ci, zi:] = ndimage.rotate(v[ci, zi:], angle, axes=(1, 2), reshape=False,
                                              order=1 if is_image else 0, mode="reflect")
            return out
    else:
        dy = int(rng.integers(-displacement, displacement + 1))
        dx = int(rng.integers(-displacement, displacement + 1))

        def move(v, _):
            out = v.copy()
            out[:, zi:] = _shift_zero(v[:, zi:], dy, dx)
            return out

    return _geom_apply(sample, move)


def rand_missing_section(sample: Sample, rng, prob=0.3, num_sections=2, fill=0.0) -> Sample:
    """1..``num_sections`` random z sections of the image set to ``fill``."""
    if rng.random() >= prob:
        return sample
    img = sample["image"].copy()
    z = img.shape[1]
    n = int(rng.integers(1, num_sections + 1))
    for zi in rng.choice(z, size=min(n, z), replace=False):
        img[:, zi] = fill
    return _with_image(sample, img)


def rand_lost_section(sample: Sample, rng, prob=0.2, num_sections=1) -> Sample:
    """1..``num_sections`` sections (never the first) deleted and the last
    kept one repeated to keep the depth; all geometric keys alike."""
    if rng.random() >= prob:
        return sample
    z = sample["image"].shape[1]
    if z <= num_sections + 1:
        return sample
    n = int(rng.integers(1, num_sections + 1))
    drop = set(np.sort(rng.choice(np.arange(1, z), size=min(n, z - 1), replace=False)).tolist())
    keep = np.array([i for i in range(z) if i not in drop])
    idx = np.concatenate([keep, np.repeat(keep[-1], z - len(keep))])
    return _geom_apply(sample, lambda v, _: v[:, idx].copy())


def rand_slice_drop(sample: Sample, rng, prob=0.2, num_slices=2, fill="neighbor") -> Sample:
    """``num_slices`` random sections replaced by their neighbour (the one
    below, or above for the first)."""
    if rng.random() >= prob:
        return sample
    img = sample["image"].copy()
    z = img.shape[1]
    for zi in rng.choice(z, size=min(num_slices, z), replace=False):
        img[:, zi] = img[:, max(0, zi - 1) if zi > 0 else min(z - 1, zi + 1)]
    return _with_image(sample, img)


def rand_slice_shift(sample: Sample, rng, prob=0.2, max_shift=8, num_slices=2, wrap=True, slice_prob=None,
                     spatial_axis=None, shift_magnitude=None) -> Sample:
    """Single slices shifted in their plane by up to ``max_shift`` (or
    ``shift_magnitude``) voxels, wrapped or zero-filled: ``num_slices`` of
    them, or each with probability ``slice_prob``; slices along z, or along
    ``spatial_axis`` (an int, or candidates drawn from)."""
    if rng.random() >= prob:
        return sample
    mag = int(max_shift if shift_magnitude is None else shift_magnitude)
    img = sample["image"].copy()
    if spatial_axis is None:
        axis = 0
    elif isinstance(spatial_axis, (int, np.integer)):
        axis = int(spatial_axis)
    else:
        axis = int(rng.choice(list(spatial_axis)))
    depth = img.shape[axis + 1]
    if slice_prob is not None:
        sel = np.nonzero(rng.random(depth) < slice_prob)[0]
    else:
        sel = rng.choice(depth, size=min(num_slices, depth), replace=False)
    for si in sel:
        idx = [slice(None)] * 4
        idx[axis + 1] = int(si)
        idx = tuple(idx)
        d0 = int(rng.integers(-mag, mag + 1))
        d1 = int(rng.integers(-mag, mag + 1))
        img[idx] = np.roll(img[idx], (d0, d1), axis=(1, 2)) if wrap else _shift_zero(img[idx], d0, d1)
    return _with_image(sample, img)


def rand_missing_parts(sample: Sample, rng, prob=0.2, hole_size=24, num_holes=1) -> Sample:
    """``num_holes`` zeroed in-plane rectangles, sides of ``hole_size / 2``
    to ``hole_size``, each in one random section."""
    if rng.random() >= prob:
        return sample
    img = sample["image"].copy()
    _, z, y, x = img.shape
    for _ in range(num_holes):
        zi = int(rng.integers(0, z))
        hy = int(rng.integers(hole_size // 2, hole_size + 1))
        hx = int(rng.integers(hole_size // 2, hole_size + 1))
        oy = int(rng.integers(0, max(1, y - hy)))
        ox = int(rng.integers(0, max(1, x - hx)))
        img[:, zi, oy : oy + hy, ox : ox + hx] = 0.0
    return _with_image(sample, img)


def rand_motion_blur(sample: Sample, rng, prob=0.2, sections=2, kernel_size=9) -> Sample:
    """A box blur of ``kernel_size`` along x (or y) on ``sections`` random
    sections, reflected at the border."""
    if rng.random() >= prob:
        return sample
    img = sample["image"].copy()
    z = img.shape[1]
    axis = 2 if rng.random() < 0.5 else 1  # of a (C, Y, X) section: x, else y
    k = np.ones(kernel_size, dtype=np.float32) / kernel_size
    for zi in rng.choice(z, size=min(sections, z), replace=False):
        img[:, zi] = ndimage.convolve1d(img[:, zi], k, axis=axis, mode="reflect")
    return _with_image(sample, img)


def rand_stripe(sample: Sample, rng, prob=0.1, intensity=0.15, num_stripes=4) -> Sample:
    """``num_stripes`` whole columns (or rows) of every section shifted by
    U(-intensity, intensity), clipped to [0, 1]."""
    if rng.random() >= prob:
        return sample
    img = sample["image"].copy()
    _, _, y, x = img.shape
    vertical = rng.random() < 0.5
    for _ in range(num_stripes):
        a = float(rng.uniform(-intensity, intensity))
        if vertical:
            img[..., int(rng.integers(0, x))] += a
        else:
            img[..., int(rng.integers(0, y)), :] += a
    return _with_image(sample, np.clip(img, 0.0, 1.0))


# -- intensity ---------------------------------------------------------------


def rand_intensity(sample: Sample, rng, gaussian_noise_prob=0.5, gaussian_noise_std=0.1, shift_intensity_prob=0.5,
                   shift_intensity_offset=0.1, contrast_prob=0.5, contrast_range=(0.8, 1.2), invert_prob=0.0,
                   **_) -> Sample:
    """Gaussian noise, a shift, a contrast change about the mean and an
    inversion, each with its probability; clipped to [0, 1]."""
    img = sample["image"].astype(np.float32).copy()
    if rng.random() < gaussian_noise_prob:
        img = img + rng.normal(0, gaussian_noise_std, img.shape).astype(np.float32)
    if rng.random() < shift_intensity_prob:
        img = img + float(rng.uniform(-shift_intensity_offset, shift_intensity_offset))
    if rng.random() < contrast_prob:
        f = float(rng.uniform(*contrast_range))
        img = (img - img.mean()) * f + img.mean()
    if invert_prob and rng.random() < invert_prob:
        img = 1.0 - img
    return _with_image(sample, np.clip(img, 0.0, 1.0))


def rand_gamma(sample: Sample, rng, prob=0.3, gamma_range=(0.7, 1.5)) -> Sample:
    if rng.random() >= prob:
        return sample
    g = float(rng.uniform(*gamma_range))
    return _with_image(sample, np.clip(sample["image"], 0.0, 1.0) ** g)


def rand_mul_add(sample: Sample, rng, prob=0.5, mul_range=(0.9, 1.1), add_range=(-0.1, 0.1)) -> Sample:
    """image * U(mul_range) + U(add_range), clipped to [0, 1]."""
    if rng.random() >= prob:
        return sample
    m = float(rng.uniform(*mul_range))
    a = float(rng.uniform(*add_range))
    return _with_image(sample, np.clip(sample["image"] * m + a, 0.0, 1.0))


# -- mixing ------------------------------------------------------------------


def rand_cut_blur(sample: Sample, rng, prob=0.2, length_ratio=0.4, down_ratio=(2, 8)) -> Sample:
    """An in-plane box of ``length_ratio`` of y and x, through all sections,
    subsampled by d in U{down_ratio} and blown up again (nearest)."""
    if rng.random() >= prob:
        return sample
    img = sample["image"].copy()
    _, _, y, x = img.shape
    ly, lx = max(2, int(y * length_ratio)), max(2, int(x * length_ratio))
    oy, ox = int(rng.integers(0, y - ly + 1)), int(rng.integers(0, x - lx + 1))
    d = int(rng.integers(down_ratio[0], down_ratio[1] + 1))
    small = img[:, :, oy : oy + ly : d, ox : ox + lx : d]
    img[:, :, oy : oy + ly, ox : ox + lx] = np.repeat(np.repeat(small, d, axis=2), d, axis=3)[:, :, :ly, :lx]
    return _with_image(sample, img)


def rand_cut_noise(sample: Sample, rng, prob=0.2, length_ratio=0.4, scale=0.3) -> Sample:
    """Uniform noise of ``scale`` added inside a box of ``length_ratio`` of
    each axis, clipped to [0, 1]."""
    if rng.random() >= prob:
        return sample
    img = sample["image"].copy()
    _, z, y, x = img.shape
    lz = max(1, int(z * length_ratio))
    ly, lx = max(2, int(y * length_ratio)), max(2, int(x * length_ratio))
    oz = int(rng.integers(0, z - lz + 1))
    oy, ox = int(rng.integers(0, y - ly + 1)), int(rng.integers(0, x - lx + 1))
    box = (slice(None), slice(oz, oz + lz), slice(oy, oy + ly), slice(ox, ox + lx))
    img[box] = np.clip(img[box] + rng.uniform(-scale, scale, img[box].shape), 0.0, 1.0)
    return _with_image(sample, img)


def rand_mixup(sample: Sample, rng, other: Optional[Sample] = None, prob=0.2, alpha=0.7) -> Sample:
    """The image blended with ``other``'s, weight U(alpha, 1) on its own;
    the label stays this sample's."""
    if other is None or rng.random() >= prob:
        return sample
    lam = float(rng.uniform(alpha, 1.0))
    return _with_image(sample, lam * sample["image"] + (1 - lam) * other["image"])


def rand_copy_paste(sample: Sample, rng, other: Optional[Sample] = None, prob=0.2) -> Sample:
    """``other``'s foreground (label > 0) pasted over this sample, image and
    label; integer labels are offset past this sample's largest."""
    if other is None or "label" not in other or "label" not in sample:
        return sample
    if rng.random() >= prob:
        return sample
    fg = other["label"][0] > 0
    if not fg.any():
        return sample
    img = sample["image"].copy()
    lbl = sample["label"].copy()
    img[:, fg] = other["image"][:, fg]
    offset = lbl.max() + 1
    lbl[:, fg] = other["label"][:, fg] + (offset if lbl.dtype != np.float32 else 0)
    out = _with_image(sample, img)
    out["label"] = lbl
    return out
