"""Augmentation config -> one host augmentation function, the port of
``pytorch_connectomics_tpu/data/augment/build.py``: the configured
transforms in the JAX package's order (geometric, EM artefacts, intensity,
mixing), each block a dict of ``enabled`` and the transform's keywords."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ...config.schema import AugmentationConfig
from . import ops

Sample = ops.Sample

# (config key, transform, takes a second sample)
_ORDER: List[Tuple[str, Callable, bool]] = [
    ("flip", ops.rand_flip, False),
    ("axis_permute", ops.rand_axis_permute, False),
    ("transpose", ops.rand_transpose, False),
    ("rotate", ops.rand_rotate90, False),
    ("affine", ops.rand_affine, False),
    ("elastic", ops.rand_elastic, False),
    ("misalignment", ops.rand_misalignment, False),
    ("missing_section", ops.rand_missing_section, False),
    ("lost_section", ops.rand_lost_section, False),
    ("slice_drop", ops.rand_slice_drop, False),
    ("slice_shift", ops.rand_slice_shift, False),
    ("missing_parts", ops.rand_missing_parts, False),
    ("motion_blur", ops.rand_motion_blur, False),
    ("cut_blur", ops.rand_cut_blur, False),
    ("cut_noise", ops.rand_cut_noise, False),
    ("stripe", ops.rand_stripe, False),
    ("intensity", ops.rand_intensity, False),
    ("mul_add", ops.rand_mul_add, False),
    ("gamma", ops.rand_gamma, False),
    ("mixup", ops.rand_mixup, True),
    ("copy_paste", ops.rand_copy_paste, True),
]
# keywords a YAML list gives that the transforms take as tuples
_TUPLES = ("down_ratio", "contrast_range", "gamma_range", "spatial_axes")


def build_augmentation_fn(cfg: Optional[AugmentationConfig],
                          sample_other: Optional[Callable[[np.random.Generator], Sample]] = None):
    """``augment(sample, rng) -> sample``, or None when augmentation is off
    or no block is enabled. A block comes from its field of ``cfg`` or, for
    keys without one (``axis_permute``, ``mul_add``), from ``cfg.extra``;
    ``sample_other(rng)`` gives mixup and copy-paste their second sample."""
    if cfg is None or not cfg.enabled:
        return None
    steps = []
    for key, fn, needs_other in _ORDER:
        block = getattr(cfg, key, None)
        if block is None:
            block = (getattr(cfg, "extra", None) or {}).get(key)
        if not block or not block.get("enabled", True):
            continue
        kwargs = {k: tuple(v) if k in _TUPLES and isinstance(v, list) else v
                  for k, v in block.items() if k != "enabled"}
        steps.append((fn, kwargs, needs_other))
    if not steps:
        return None

    def augment(sample: Sample, rng: np.random.Generator) -> Sample:
        for fn, kwargs, needs_other in steps:
            if needs_other:
                sample = fn(sample, rng, other=sample_other(rng) if sample_other else None, **kwargs)
            else:
                sample = fn(sample, rng, **kwargs)
        return sample

    return augment
