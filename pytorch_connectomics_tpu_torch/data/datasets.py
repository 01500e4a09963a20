"""Patch datasets over EM volumes, the port of ``random_crop_origin``,
``RejectConfig`` and ``VolumeDataset`` of
``pytorch_connectomics_tpu/data/datasets.py:45-232`` (numpy, host side).

A dataset holds its volumes in RAM, normalised once, and exposes
``sample(rng) -> {"image": (1, Z, Y, X), "label": (C, Z, Y, X), ...}`` for
random training patches, with foreground rejection sampling. The random
draws are the JAX package's, call for call, so one ``np.random.Generator``
gives the same patches in both packages. The JAX dataset's center crop and
its lazy and multi-dataset variants are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .io import read_volume
from .preprocess import normalize_volume, pad_to_min_shape


def _as_list(x) -> List[str]:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def random_crop_origin(rng: np.random.Generator, vol_shape: Sequence[int], patch: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(rng.integers(0, max(1, s - p + 1))) for s, p in zip(vol_shape, patch))


@dataclass
class RejectConfig:
    """Foreground-aware rejection sampling."""

    enabled: bool = False
    min_fg_ratio: float = 0.0
    max_attempts: int = 20
    prob: float = 0.95  # probability of rejecting a patch below min_fg_ratio


class VolumeDataset:
    """In-RAM volume dataset with random crops.

    ``images``/``labels``/``masks`` are path strings or lists of them; every
    volume is read, transposed, normalised and padded up to the patch size
    once. ``device`` is where ``synthetic://`` volumes are generated."""

    def __init__(
        self,
        images: Union[str, List[str]],
        labels: Union[str, List[str], None] = None,
        masks: Union[str, List[str], None] = None,
        patch_size: Sequence[int] = (32, 64, 64),
        normalize: str = "smart",
        reject: Optional[RejectConfig] = None,
        pad_mode: str = "reflect",
        transpose: Optional[Sequence[int]] = None,
        clip_percentiles=None,
        device=None,
    ):
        self.patch_size = tuple(int(p) for p in patch_size)
        self.reject = reject or RejectConfig()
        self.images: List[np.ndarray] = []
        self.labels: List[Optional[np.ndarray]] = []
        self.masks: List[Optional[np.ndarray]] = []
        lbl_paths, msk_paths = _as_list(labels), _as_list(masks)

        def read(path):
            v = read_volume(path, device=device)
            return np.transpose(v, transpose) if transpose else v

        for i, ip in enumerate(_as_list(images)):
            img = normalize_volume(read(ip), normalize, clip_percentiles=clip_percentiles)
            img, _ = pad_to_min_shape(img, self.patch_size, pad_mode)
            self.images.append(np.ascontiguousarray(img, dtype=np.float32))
            lbl = None
            if i < len(lbl_paths):
                lbl = np.ascontiguousarray(pad_to_min_shape(read(lbl_paths[i]), self.patch_size, "constant")[0])
            self.labels.append(lbl)
            msk = None
            if i < len(msk_paths):
                msk = np.ascontiguousarray(pad_to_min_shape(read(msk_paths[i]), self.patch_size, "constant")[0])
            self.masks.append(msk)
        if not self.images:
            raise ValueError("VolumeDataset requires at least one image volume")
        # volume picked proportionally to voxel count
        sizes = np.array([im.size for im in self.images], dtype=np.float64)
        self._vol_probs = sizes / sizes.sum()

    def _extract(self, vi: int, origin: Sequence[int]) -> Dict[str, np.ndarray]:
        sl = tuple(slice(o, o + p) for o, p in zip(origin, self.patch_size))
        out: Dict[str, np.ndarray] = {"image": self.images[vi][sl][None]}
        if self.labels[vi] is not None:
            lbl = self.labels[vi][sl]
            out["label"] = lbl[None] if lbl.ndim == 3 else lbl
        if self.masks[vi] is not None:
            out["mask"] = self.masks[vi][sl][None].astype(np.float32)
        return out

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        vi = int(rng.choice(len(self.images), p=self._vol_probs))
        shape = self.images[vi].shape
        for _ in range(max(1, self.reject.max_attempts)):
            origin = random_crop_origin(rng, shape, self.patch_size)
            if not self.reject.enabled or self.labels[vi] is None:
                return self._extract(vi, origin)
            sl = tuple(slice(o, o + p) for o, p in zip(origin, self.patch_size))
            fg = float((self.labels[vi][sl] > 0).mean())
            if fg > self.reject.min_fg_ratio:
                return self._extract(vi, origin)
            if rng.random() > self.reject.prob:
                return self._extract(vi, origin)
        return self._extract(vi, origin)

    @property
    def has_unlabeled(self) -> bool:
        """True when a label volume carries ``-1`` (unlabeled) voxels."""
        return any(lb is not None and lb.dtype.kind in "if" and lb.min() < 0 for lb in self.labels)
