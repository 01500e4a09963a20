from .build import build_model, init_model  # noqa: F401
from .registry import (  # noqa: F401
    architecture_info,
    get_architecture,
    list_architectures,
    register_architecture,
)
