from .build import build_target_fn, seg_to_binary  # noqa: F401
