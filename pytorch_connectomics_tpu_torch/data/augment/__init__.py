"""Host augmentation (numpy and scipy): :mod:`.ops` holds the transforms,
:func:`build_augmentation_fn` composes the configured ones."""

from .build import build_augmentation_fn  # noqa: F401
