from .schema import (  # noqa: F401
    Config,
    ConfigError,
    build_dataclass,
    to_dict,
)
from .loader import (  # noqa: F401
    config_hash,
    load_config,
    load_yaml_with_bases,
    resolve_stages,
    resolve_system_sentinels,
    validate_config,
)
from .merge import apply_overrides, deep_merge, get_path, set_path  # noqa: F401
