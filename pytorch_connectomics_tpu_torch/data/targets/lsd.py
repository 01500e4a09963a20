"""Local shape descriptors as training targets, the port of ``seg_to_lsd``
in ``pytorch_connectomics_tpu/data/targets/lsd.py:69`` (with its
``_aggregate``, ``_downsample`` and ``_upsample``).

3-D descriptors are 10 channels in [0, 1]: the mean offset to the local
centre of mass (z, y, x) over sigma, 0.5-centred; the variance diagonal over
sigma^2; the Pearson correlations (zy, zx, yx), 0.5-centred; the local
size (the Gaussian window's fill). 2-D gives 6 (2 offsets, 2 variances, 1
correlation, size). numpy and scipy's ``ndimage`` in float64, as JAX's.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import numpy as np
from scipy import ndimage

_TRUNCATE = 3.0


def _sigma_tuple(sigma, ndim: int):
    if np.isscalar(sigma):
        return (float(sigma),) * ndim
    s = tuple(float(v) for v in sigma)[:ndim]
    if len(s) != ndim:
        raise ValueError(f"sigma {sigma} incompatible with {ndim}-D labels")
    return s


def _aggregate(arr: np.ndarray, sigma_vox, mode: str) -> np.ndarray:
    if mode == "gaussian":
        return ndimage.gaussian_filter(arr, sigma=sigma_vox, mode="constant", cval=0.0, truncate=_TRUNCATE)
    # sphere: an unnormalised ball over the even support arange(-r, r)
    r = sigma_vox[0]
    if any(abs(s - r) > 1e-9 for s in sigma_vox):
        raise ValueError("mode='sphere' requires isotropic sigma/voxel_size")
    r = max(1, int(r))
    grids = np.meshgrid(*([np.arange(-r, r)] * arr.ndim), indexing="ij")
    ball = (sum(g**2 for g in grids) <= r * r).astype(np.float32)
    return ndimage.convolve(arr, ball, mode="constant", cval=0.0)


def _upsample(arr: np.ndarray, df: int, full_shape) -> np.ndarray:
    if df == 1:
        return arr
    out = arr
    for axis in range(1, arr.ndim):
        out = np.repeat(out, df, axis=axis)
    return out[(slice(None),) + tuple(slice(0, s) for s in full_shape)]


def seg_to_lsd(
    seg: np.ndarray,
    sigma: Union[float, Sequence[float]] = (5.0, 5.0, 5.0),
    components: Optional[str] = None,
    voxel_size: Optional[Sequence[float]] = None,
    mode: str = "gaussian",
    downsample: int = 1,
    labels: Optional[Iterable[int]] = None,
    truncate: float = _TRUNCATE,
    dtype=np.float32,
) -> np.ndarray:
    """(C, *spatial) descriptors in [0, 1]: C 10 (3-D) or 6 (2-D), or
    ``len(components)`` for a digit-string subset such as ``"0129"``."""
    seg = np.asarray(seg)
    if seg.ndim == 4:
        seg = seg[0]
    ndim = seg.ndim
    if ndim not in (2, 3):
        raise ValueError(f"labels must be 2-D or 3-D, got {ndim}-D")
    sig = _sigma_tuple(sigma, ndim)
    vox = tuple(float(v) for v in (voxel_size or (1.0,) * ndim))
    full_shape = seg.shape
    df = int(downsample)
    seg_w = seg
    if df > 1:
        if any(s % df for s in seg.shape):
            raise ValueError(f"shape {seg.shape} not divisible by downsample {df}")
        seg_w = seg[tuple(slice(None, None, df) for _ in range(ndim))]
        vox = tuple(v * df for v in vox)
    sigma_vox = tuple(s / v for s, v in zip(sig, vox))
    shape = seg_w.shape
    n_off, n_var, n_pear = ndim, ndim, (3 if ndim == 3 else 1)
    n_total = n_off + n_var + n_pear + 1
    sel = list(range(n_total)) if components is None else [int(c) for c in components]
    if any(c < 0 or c >= n_total for c in sel):
        raise ValueError(f"components must be digits in 0..{n_total - 1}")
    out = np.zeros((len(sel),) + shape, np.float64)
    coords = np.meshgrid(*[np.arange(n, dtype=np.float64) * v for n, v in zip(shape, vox)], indexing="ij")
    pear_pairs = [(0, 1), (0, 2), (1, 2)] if ndim == 3 else [(0, 1)]
    ids = np.asarray(list(labels)) if labels is not None else np.unique(seg_w)
    ids = ids[ids > 0]
    pad = tuple(int(np.ceil(sv * truncate)) + 1 for sv in sigma_vox)
    # the farthest weighted voxel: about sigma for the Gaussian, the ball's radius sigma / 2 for the sphere
    max_dist = sig if mode == "gaussian" else tuple(0.5 * s for s in sig)
    for iid in ids:
        full_mask = seg_w == iid
        obj = ndimage.find_objects(full_mask.astype(np.uint8))[0]
        sl = tuple(slice(max(0, o.start - p), min(n, o.stop + p)) for o, p, n in zip(obj, pad, shape))
        m = full_mask[sl].astype(np.float64)
        c = [cc[sl] for cc in coords]
        count = _aggregate(m, sigma_vox, mode)
        count_safe = np.where(count == 0, 1.0, count)
        mean = [_aggregate(m * ci, sigma_vox, mode) / count_safe for ci in c]
        inside = m > 0.5
        var = [np.maximum(_aggregate(m * c[d] * c[d], sigma_vox, mode) / count_safe - mean[d] ** 2, 1e-3)
               for d in range(ndim)]
        pear = [(_aggregate(m * c[a] * c[b], sigma_vox, mode) / count_safe - mean[a] * mean[b])
                / np.sqrt(var[a] * var[b]) for a, b in pear_pairs]
        for slot, comp in enumerate(sel):
            if comp < n_off:
                val = (mean[comp] - c[comp]) / max_dist[comp] * 0.5 + 0.5
            elif comp < n_off + n_var:
                val = var[comp - n_off] / sig[comp - n_off] ** 2
            elif comp < n_off + n_var + n_pear:
                val = pear[comp - n_off - n_var] * 0.5 + 0.5
            else:
                val = count
            out[slot][sl][inside] = val[inside]
    np.clip(out, 0.0, 1.0, out=out)
    return _upsample(out.astype(dtype), df, full_shape)
