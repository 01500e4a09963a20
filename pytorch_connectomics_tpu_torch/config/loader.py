"""Config loading pipeline: YAML + ``_base_`` chains -> profile expansion ->
stage merge -> typed :class:`Config`.

Reference behavior being reproduced:
- ``_base_`` inheritance chains        (``config/pipeline/config_io.py:59``)
- CLI ``key=value`` overrides pre+post (``config_io.py:351``, ``cli.py:181``)
- default/stage/top three-level merge  (``pipeline/stage_resolver.py:336``)
- config hash                           (``config_io.py:712``)
- data path resolution                  (``config_io.py:753``)
- validation rule set                   (``config_io.py:488``)

The port's own copy of ``pytorch_connectomics_tpu/config/loader.py``. It
differs in one place: ``num_devices`` resolves against the visible CUDA
devices.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .merge import apply_overrides, deep_merge, get_path, set_path
from .profiles import expand_profiles, split_registries
from .schema import Config, ConfigError, build_dataclass, to_dict

STAGE_KEYS = ("default", "train", "test", "tune")
# sections that may appear inside a stage block
_STAGE_SECTIONS = (
    "system",
    "model",
    "data",
    "optimization",
    "monitor",
    "inference",
    "decoding",
    "evaluation",
    "pipeline_profile",
    "profile",
)

_BUILTIN_PROFILES = Path(__file__).parent / "profiles_data" / "all_profiles.yaml"


def load_yaml_with_bases(path: str | Path, _seen: Optional[set] = None) -> Dict[str, Any]:
    """Load a YAML file, recursively merging its ``_base_:`` chain
    (bases first, later bases and the file itself win)."""
    path = Path(path).resolve()
    _seen = _seen or set()
    if path in _seen:
        raise ConfigError(f"circular _base_ chain at {path}")
    _seen.add(path)
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise ConfigError(f"{path} must contain a mapping at top level")
    bases = raw.pop("_base_", None) or []
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_path = (path.parent / base).resolve()
        if not base_path.exists():
            # reference configs point at the reference repo's profile file;
            # fall back to our builtin library for same-named files.
            if Path(base).name == "all_profiles.yaml":
                base_path = _BUILTIN_PROFILES
            else:
                raise ConfigError(f"_base_ file not found: {base_path}")
        merged = deep_merge(merged, load_yaml_with_bases(base_path, _seen))
    return deep_merge(merged, raw)


def resolve_stages(raw: Dict[str, Any], mode: str) -> Dict[str, Any]:
    """Three-level merge: ``default.*`` -> mode stage -> top-level explicit.

    ``mode`` maps tune-test -> test for data purposes; the stage blocks are
    removed from the result.
    """
    # tune modes inherit the test stage's data paths, then the tune overlay
    # (reference tune data fallback, ``runtime/tune_runner.py``)
    stages = {
        "train": ["train"],
        "val": ["train"],
        "test": ["test"],
        "tune": ["test", "tune"],
        "tune-test": ["test", "tune"],
    }[mode]
    out = copy.deepcopy(raw)
    default_block = out.pop("default", None) or {}
    stage_blocks = {k: out.pop(k, None) or {} for k in ("train", "test", "tune")}
    top = {k: out.get(k) for k in _STAGE_SECTIONS if k in out}

    merged_sections: Dict[str, Any] = {}
    for block in [default_block] + [stage_blocks.get(s, {}) for s in stages]:
        for key, value in block.items():
            if key not in _STAGE_SECTIONS:
                raise ConfigError(f"unknown stage section '{key}'")
            merged_sections = deep_merge(merged_sections, {key: value})
    merged_sections = deep_merge(merged_sections, top)
    for key, value in merged_sections.items():
        out[key] = value

    # test/tune data paths live under <stage>.data.<split>; keep whichever
    # split blocks the merge produced.
    return out


def resolve_data_paths(raw: Dict[str, Any], config_dir: Optional[Path]) -> None:
    """Prefix relative data paths with ``data.base_path`` or the config file
    directory (reference ``config_io.py:753-918``)."""
    data = raw.get("data")
    if not isinstance(data, dict):
        return
    base = data.get("base_path")
    roots = [Path(base)] if base else []
    if config_dir is not None:
        roots.append(config_dir)
    roots.append(Path.cwd())

    def fix(value):
        if isinstance(value, list):
            return [fix(v) for v in value]
        if not isinstance(value, str) or "://" in value or os.path.isabs(value):
            return value
        for root in roots:
            cand = root / value
            if cand.exists():
                return str(cand)
        return value

    for split in ("train", "val", "test"):
        block = data.get(split)
        if isinstance(block, dict):
            for key in ("image", "label", "mask", "label_aux"):
                if key in block and block[key] is not None:
                    block[key] = fix(block[key])


def config_hash(cfg: Config | Dict[str, Any]) -> str:
    d = to_dict(cfg) if not isinstance(cfg, dict) else cfg
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def resolve_precision(cfg: Config) -> None:
    """Map the reference's ``optimization.precision`` strings to the model
    compute dtype: "32" -> float32; "16-mixed"/"bf16-mixed" -> bfloat16
    (bf16 is the mixed-precision compute dtype)."""
    p = str(cfg.optimization.precision)
    if p in ("32", "32-true", "float32"):
        cfg.model.compute_dtype = "float32"
    elif p in ("16-mixed", "bf16-mixed", "16", "bf16"):
        cfg.model.compute_dtype = "bfloat16"


def validate_config(cfg: Config, mode: str = "train") -> List[str]:
    """Coherence checks; returns warnings, raises on hard errors
    (reference ``config_io.py:488-711``, ``runtime/preflight.py``)."""
    warnings: List[str] = []
    m = cfg.model
    if len(m.input_size) != 3:
        raise ConfigError("model.input_size must have 3 entries [z,y,x]")
    if m.output_size and len(m.output_size) != 3:
        raise ConfigError("model.output_size must have 3 entries [z,y,x]")
    if m.out_channels < 1:
        raise ConfigError("model.out_channels must be >= 1")
    ps = cfg.data.dataloader.patch_size
    if list(ps) != list(m.input_size):
        warnings.append(
            f"data.dataloader.patch_size {ps} != model.input_size {m.input_size}; using patch_size"
        )
    if mode == "train":
        if not cfg.model.loss.losses:
            raise ConfigError("train mode requires model.loss.losses")
        if cfg.data.train.image is None:
            raise ConfigError("train mode requires data.train.image")
    if mode in ("test", "tune", "tune-test") and cfg.data.test.image is None:
        warnings.append("no data.test.image configured")
    w = cfg.inference.window
    if w.window_size is None:
        w.window_size = list(m.input_size)
    if not 0.0 <= float(w.overlap) < 1.0:
        raise ConfigError("inference.window.overlap must be in [0,1)")
    if cfg.model.loss.deep_supervision and cfg.model.arch.type not in (
        "mednext",
        "rsunet",
        "monai_basic_unet",
        "monai_unet",
    ):
        warnings.append(f"deep supervision untested for arch {cfg.model.arch.type}")
    # the free-form kwarg blocks, checked against the signatures that read them
    from .kwarg_validation import validate_augmentation_config, validate_decoding_config

    warnings += validate_augmentation_config(cfg.data.augmentation)
    warnings += validate_decoding_config(cfg.decoding)
    return warnings


def available_cpus() -> int:
    """CPU slots visible to this process, cgroup/SLURM aware (reference
    ``_available_cpus_for_current_run``, hardware/auto_config.py:37):
    affinity mask > SLURM_CPUS_PER_TASK > os.cpu_count()."""
    try:
        aff = os.sched_getaffinity(0)
        if aff:
            return len(aff)
    except (AttributeError, OSError):
        pass
    slurm = os.environ.get("SLURM_CPUS_PER_TASK", "")
    if slurm.isdigit():
        return max(int(slurm), 1)
    return max(os.cpu_count() or 1, 1)


_MALIS_WORKER_CAP = 8


def resolve_malis_worker_budget(cfg: Config) -> int:
    """Inject the MalisLoss ``num_workers`` auto-default
    (min(2*batch, cap)) for unset entries and return the total thread
    reservation (reference ``_resolve_malis_worker_budget``,
    hardware/auto_config.py:96)."""
    losses = cfg.model.loss.losses or []
    batch = int(cfg.data.dataloader.batch_size or 1)
    default = max(1, min(batch * 2, _MALIS_WORKER_CAP))
    total = 0
    for term in losses:
        if term.function != "MalisLoss":
            continue
        kwargs = dict(term.kwargs or {})
        explicit = kwargs.get("num_workers")
        if explicit is None:
            kwargs["num_workers"] = default
            term.kwargs = kwargs
            total += default
        elif int(explicit) > 1:
            total += int(explicit)
    return total


def resolve_system_sentinels(cfg: Config) -> None:
    """Resolve ``-1`` hardware sentinels against visible CUDA devices / CPUs
    (reference ``config/hardware/auto_config.py:142``); with no CUDA device
    the one CPU device counts."""
    if cfg.system.num_devices in (-1, 0, None):
        import torch

        cfg.system.num_devices = max(1, torch.cuda.device_count())
    malis_threads = resolve_malis_worker_budget(cfg)
    if cfg.system.num_workers in (-1, None):
        # leave one CPU for the main loop and reserve the MALIS thread pool;
        # system.num_cpus overrides the detected budget (reference num_cpus)
        n = cfg.system.num_cpus or available_cpus()
        cfg.system.num_workers = max(1, min(8, int(n) - 1 - malis_threads))
    mesh = dict(cfg.system.mesh or {"data": -1})
    unknown = [k for k, v in mesh.items() if v in (-1, None)]
    known = 1
    for k, v in mesh.items():
        if v not in (-1, None):
            known *= v
    if unknown:
        rest = max(1, cfg.system.num_devices // known)
        for k in unknown[:-1]:
            mesh[k] = 1
        mesh[unknown[-1]] = rest
    cfg.system.mesh = mesh


def load_config(
    path: str | Path | None = None,
    overrides: Iterable[str] = (),
    mode: str = "train",
    raw_dict: Optional[Dict[str, Any]] = None,
    use_builtin_profiles: bool = True,
) -> Config:
    """Full pipeline: YAML(+bases) -> overrides(pre) -> stage merge ->
    profile expansion -> overrides(post) -> path/sentinel resolution ->
    typed Config -> validation."""
    if raw_dict is not None:
        raw = copy.deepcopy(raw_dict)
        config_dir = None
    else:
        raw = load_yaml_with_bases(path)
        config_dir = Path(path).resolve().parent
    if use_builtin_profiles and _BUILTIN_PROFILES.exists():
        builtin = load_yaml_with_bases(_BUILTIN_PROFILES)
        raw = deep_merge(builtin, raw)
    raw, registries = split_registries(raw)
    apply_overrides(raw, overrides)
    raw = expand_profiles(raw, registries)
    raw = resolve_stages(raw, mode)
    raw = expand_profiles(raw, registries)  # stage blocks may carry selectors
    apply_overrides(raw, overrides)
    resolve_data_paths(raw, config_dir)
    raw.pop("_merge_context", None)
    cfg: Config = build_dataclass(Config, raw)
    resolve_system_sentinels(cfg)
    resolve_precision(cfg)
    validate_config(cfg, mode)
    return cfg
