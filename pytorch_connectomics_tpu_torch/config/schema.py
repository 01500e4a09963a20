"""Typed configuration schema (the port's own copy of
``pytorch_connectomics_tpu/config/schema.py``).

This mirrors the configuration *surface* of the reference framework
(``connectomics/config/schema`` in PyTorch Connectomics — see e.g.
``schema/root.py:26``) but is implemented as plain Python dataclasses with a
small recursive dict->dataclass builder instead of OmegaConf structured
configs.  Unknown keys are rejected (reference: ``config_io.py:94``).

Axis convention: all 3-D sizes are ``[z, y, x]`` voxel counts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union, get_args, get_origin

# ---------------------------------------------------------------------------
# dict <-> dataclass machinery
# ---------------------------------------------------------------------------


class ConfigError(ValueError):
    """Raised on malformed configuration input."""


def _is_optional(tp) -> Tuple[bool, Any]:
    if get_origin(tp) is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return True, args[0]
        return True, Union[tuple(args)]
    return False, tp


def build_dataclass(cls, data: Optional[Dict[str, Any]], path: str = ""):
    """Recursively build dataclass ``cls`` from a (possibly nested) dict.

    Unknown keys raise :class:`ConfigError` unless the target dataclass
    declares ``__extra_ok__ = True`` (used for free-form kwargs blocks).
    """
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ConfigError(f"config node '{path}' must be a mapping, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls) if f.init}
    extra_ok = getattr(cls, "__extra_ok__", False)
    kwargs: Dict[str, Any] = {}
    extra: Dict[str, Any] = {}
    for key, value in data.items():
        if key not in fields:
            if extra_ok:
                extra[key] = value
                continue
            raise ConfigError(
                f"unknown config key '{path + '.' if path else ''}{key}' for {cls.__name__}; "
                f"valid keys: {sorted(fields)}"
            )
        kwargs[key] = _coerce(fields[key].type, value, f"{path + '.' if path else ''}{key}")
    obj = cls(**kwargs)
    if extra:
        obj.extra = extra  # type: ignore[attr-defined]
    return obj


def _coerce(tp, value, path: str):
    if isinstance(tp, str):  # postponed annotation
        tp = _resolve_annotation(tp)
    optional, inner = _is_optional(tp)
    if value is None:
        return None
    tp = inner if optional else tp
    origin = get_origin(tp)
    if dataclasses.is_dataclass(tp):
        return build_dataclass(tp, value, path)
    if origin in (list, List):
        (elem,) = get_args(tp) or (Any,)
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"'{path}' must be a list")
        return [_coerce(elem, v, f"{path}[{i}]") for i, v in enumerate(value)]
    if origin in (tuple, Tuple):
        return tuple(value) if isinstance(value, (list, tuple)) else value
    if origin in (dict, Dict):
        return dict(value)
    if tp is float and isinstance(value, (int, str)):
        return float(value)
    if tp is int and isinstance(value, float) and value.is_integer():
        return int(value)
    if tp is int and isinstance(value, str):
        return int(value)
    if tp is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return value


_ANNOTATION_CACHE: Dict[str, Any] = {}


def _resolve_annotation(name: str):
    if name in _ANNOTATION_CACHE:
        return _ANNOTATION_CACHE[name]
    ns = dict(globals())
    import typing

    ns.update(vars(typing))
    try:
        tp = eval(name, ns)  # noqa: S307 - controlled namespace
    except Exception:
        tp = Any
    _ANNOTATION_CACHE[name] = tp
    return tp


def to_dict(obj) -> Any:
    """Dataclass tree -> plain dict (for hashing / serialization)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        xtra = getattr(obj, "extra", None)
        if xtra:
            out.update({k: to_dict(v) for k, v in xtra.items()})
        return out
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


# ---------------------------------------------------------------------------
# system
# ---------------------------------------------------------------------------


@dataclass
class SystemConfig:
    """Hardware / parallelism settings (reference: ``schema/system.py``).

    ``num_devices`` replaces the reference's ``num_gpus``: -1 = all visible
    TPU chips (sentinel resolution in ``resolver.py``, mirroring
    ``config/hardware/auto_config.py:142``).
    """

    profile: Optional[str] = None
    num_devices: int = -1
    num_gpus: Optional[int] = None  # accepted alias for reference configs
    num_workers: int = -1
    num_cpus: Optional[int] = None
    seed: int = 42
    deterministic: bool = False  # compat no-op: JAX/XLA runs are deterministic by default
    # jax mesh axis sizes; -1 entries resolved from num_devices
    mesh: Dict[str, int] = field(default_factory=lambda: {"data": -1})
    distributed_backend: str = "jax"  # jax | none
    # multi-host (DCN) init: auto = env detection (SLURM/TPU-pod vars),
    # force = always call jax.distributed.initialize, never = single host
    distributed: str = "auto"  # auto | force | never
    # independent-shard test mode (reference runtime/sharding.py:212)
    shard_id: Optional[int] = None
    num_shards: Optional[int] = None


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@dataclass
class ArchConfig:
    type: str = "monai_unet"


@dataclass
class MonaiModelConfig:
    """MONAI-style UNet knobs (reference: ``schema/model_monai.py``)."""

    filters: List[int] = field(default_factory=lambda: [16, 32, 64])
    num_res_units: int = 1
    kernel_size: int = 3
    up_kernel_size: int = 3
    dropout: float = 0.0
    norm: str = "instance"
    act: str = "prelu"
    strides: Optional[List[List[int]]] = None
    features: Optional[List[int]] = None  # basic_unet variant
    # unetr / swin-unetr style transformer knobs
    hidden_size: int = 384
    num_heads: int = 6
    mlp_dim: int = 1536
    num_layers: int = 8
    patch_size: List[int] = field(default_factory=lambda: [16, 16, 16])
    feature_size: int = 24
    depths: List[int] = field(default_factory=lambda: [2, 2, 2, 2])
    window_size: List[int] = field(default_factory=lambda: [4, 4, 4])


@dataclass
class MedNeXtHeadConfig:
    name: str = "out"
    out_channels: int = 1
    num_blocks: int = 1
    kernel_size: Optional[int] = None
    target_slice: Optional[str] = None


@dataclass
class MedNeXtConfig:
    """MedNeXt knobs (reference: ``schema/model_mednext.py``)."""

    size: str = "S"  # S | B | M | L | custom
    kernel_size: int = 3
    dim: str = "3d"
    deep_supervision: Optional[bool] = None
    checkpoint_style: Optional[str] = None  # outside_block -> jax.checkpoint
    # custom-size knobs
    base_channels: int = 32
    exp_ratio: Union[int, List[int]] = 4
    block_counts: Optional[List[int]] = None
    norm_type: str = "group"
    heads: Optional[List[MedNeXtHeadConfig]] = None
    # UpKern (Roy et al. 2023): initialize this (large-kernel) model from a
    # trained small-kernel checkpoint via trilinear kernel inflation
    # (reference mednext_models.py:487).
    upkern_from: Optional[str] = None
    upkern_source_kernel: int = 3  # informational: source kernel size (shapes are read from the checkpoint)
    # Throughput variant: stem = 2x2x2 stride-2 patch embed (an exact
    # space-to-depth + dense 8->C matmul), every stage runs one resolution
    # level down, and a learned 2x transposed-conv head restores full
    # resolution. ~8x fewer full-res voxels; needs (re)training — not a
    # drop-in transform of existing checkpoints.
    patchify_stem: bool = False
    # stem/head kernel for the patchify variant: 2 = non-overlapping patch
    # embed (exact space-to-depth); 4 = overlapping (k=4, s=2), same cost
    # class, keeps more fine detail
    patchify_kernel: int = 2
    # per-axis stem stride; [1, 2, 2] keeps z full-res (EM anisotropy):
    # 4x voxel reduction instead of 8x — between stock and isotropic
    # patchify on both throughput and quality
    patchify_stride: Optional[List[int]] = None
    # head for the patchify variant: "linear" = one 2x transposed conv
    # (each output voxel is a linear readout of its patch feature);
    # "refine" = 2x transposed conv to a small full-res feature map,
    # concatenated with the RAW input (intensity guidance) and mixed by a
    # nonlinear pointwise layer before projection. Full-res cost is
    # pointwise/elementwise only (no full-res stencils); recovers
    # fine-detail discrimination the linear patch readout loses.
    patchify_head: str = "linear"
    patchify_head_width: int = 16
    # hybrid variant: keep ONE thin full-resolution MedNeXt stage of this
    # width (e.g. 16) around the half-res patchify core — full-res stencils
    # and a full-res skip at a fraction of the standard cost. None = pure
    # patchify (no full-res stage).
    patchify_full_res_width: Optional[int] = None


@dataclass
class RSUNetConfig:
    """RSUNet knobs (reference: ``schema/model_rsunet.py``; arch
    ``models/architectures/rsunet.py:262``)."""

    width: List[int] = field(default_factory=lambda: [16, 32, 64, 128])
    down_factors: Optional[List[List[int]]] = None  # e.g. [[1,2,2],[1,2,2],[2,2,2]]
    depth_2d: int = 0
    kernel_2d: List[int] = field(default_factory=lambda: [1, 3, 3])
    norm: str = "group"
    act: str = "elu"
    group_norm_groups: int = 8
    iso: bool = False


@dataclass
class NNUNetConfig:
    plans_path: Optional[str] = None
    checkpoint_path: Optional[str] = None
    configuration: str = "3d_fullres"
    fold: int = 0


@dataclass
class LossTermConfig:
    """One loss term (reference unified loss list: ``losses/plan.py:59``)."""

    __extra_ok__ = True

    function: str = "DiceLoss"
    weight: float = 1.0
    pred_slice: Optional[str] = None
    target_slice: Optional[str] = None
    pred2_slice: Optional[str] = None
    mask_slice: Optional[str] = None
    head: Optional[str] = None
    # common per-loss kwargs (extra keys allowed via __extra_ok__)
    pos_weight: Optional[Union[float, str]] = None
    spatial_weight: Optional[str] = None
    use_valid_mask: bool = False
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LossBalancingConfig:
    # uncertainty | gradnorm (loss-ratio approx) | gradnorm_exact (measured
    # per-term gradient norms at the trunk/head boundary) | None
    method: Optional[str] = None
    alpha: float = 1.5
    lr: float = 0.025


@dataclass
class LossConfig:
    profile: Optional[str] = None
    losses: List[LossTermConfig] = field(default_factory=list)
    deep_supervision: bool = False
    ds_weights: Optional[List[float]] = None
    ds_clamp: Optional[float] = None
    balancing: LossBalancingConfig = field(default_factory=LossBalancingConfig)


@dataclass
class ModelConfig:
    arch: ArchConfig = field(default_factory=ArchConfig)
    in_channels: int = 1
    out_channels: int = 1
    input_size: List[int] = field(default_factory=lambda: [32, 64, 64])
    output_size: Optional[List[int]] = None
    monai: MonaiModelConfig = field(default_factory=MonaiModelConfig)
    mednext: MedNeXtConfig = field(default_factory=MedNeXtConfig)
    rsunet: RSUNetConfig = field(default_factory=RSUNetConfig)
    nnunet: NNUNetConfig = field(default_factory=NNUNetConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    # dtype of parameters / compute
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@dataclass
class DatasetSplitConfig:
    """Paths for one split. ``image``/``label`` may be str or list of str.

    ``random://name`` produces a deterministic synthetic volume (used by the
    minimal tutorial; reference ``tutorials/minimal.yaml``).
    """

    __extra_ok__ = True

    image: Optional[Union[str, List[str]]] = None
    label: Optional[Union[str, List[str]]] = None
    mask: Optional[Union[str, List[str]]] = None
    label_aux: Optional[Union[str, List[str]]] = None
    resolution: Optional[List[float]] = None
    transpose: Optional[List[int]] = None
    pad: Optional[List[int]] = None
    image_internal_path: Optional[str] = None
    # per-axis read-downscale in (0, 1]: lazy reads fetch the covering native
    # crop and resample (reference lazy.py:422-454, data_factory.py:84)
    read_scale: Optional[List[float]] = None
    label_internal_path: Optional[str] = None


@dataclass
class TrainValSplitConfig:
    """DeepEM-style axis-range split (reference ``data/datasets/split.py``)."""

    enabled: bool = False
    axis: int = 0
    train_range: Optional[List[float]] = None
    val_range: Optional[List[float]] = None
    pad: Optional[List[int]] = None


@dataclass
class DataloaderConfig:
    __extra_ok__ = True

    profile: Optional[str] = None
    batch_size: int = 1
    val_batch_size: Optional[int] = None
    patch_size: List[int] = field(default_factory=lambda: [32, 64, 64])
    num_samples: Optional[int] = None
    use_preloaded_cache_train: bool = True
    use_preloaded_cache_val: bool = True
    use_lazy_zarr: bool = False
    # torch-DataLoader compat no-op (the threaded pipeline has no worker
    # processes); accepted so reference configs load unchanged
    persistent_workers: bool = True
    prefetch: int = 2
    # read patch + context voxels per axis so long-range affinity targets
    # are valid at patch borders; cropped back after target generation
    # (reference banis target_context)
    target_context: Optional[List[int]] = None
    # foreground rejection sampling (reference dataset_volume_cached.py:75)
    reject_sampling: Optional[Dict[str, Any]] = None
    # torch-DataLoader compat no-ops (device_put handles transfer; batches
    # are always full by construction); accepted for reference-config compat
    pin_memory: bool = True
    drop_last: bool = True


@dataclass
class AugmentationConfig:
    """Flat per-transform dict blocks keyed by transform name; profile
    expansion fills these (reference ``profiles/augmentation_profiles.yaml``).
    Each value is a free-form dict understood by the augmentation builder.
    """

    __extra_ok__ = True

    profile: Optional[str] = None
    enabled: bool = True
    # run geometric/intensity/EM-artifact transforms inside the jitted train
    # step on TPU instead of host threads (ops/augment_jax.py)
    on_device: bool = False
    flip: Optional[Dict[str, Any]] = None
    rotate: Optional[Dict[str, Any]] = None
    affine: Optional[Dict[str, Any]] = None
    transpose: Optional[Dict[str, Any]] = None
    intensity: Optional[Dict[str, Any]] = None
    elastic: Optional[Dict[str, Any]] = None
    misalignment: Optional[Dict[str, Any]] = None
    missing_section: Optional[Dict[str, Any]] = None
    lost_section: Optional[Dict[str, Any]] = None
    missing_parts: Optional[Dict[str, Any]] = None
    slice_drop: Optional[Dict[str, Any]] = None
    slice_shift: Optional[Dict[str, Any]] = None
    motion_blur: Optional[Dict[str, Any]] = None
    cut_noise: Optional[Dict[str, Any]] = None
    cut_blur: Optional[Dict[str, Any]] = None
    mixup: Optional[Dict[str, Any]] = None
    copy_paste: Optional[Dict[str, Any]] = None
    stripe: Optional[Dict[str, Any]] = None
    gamma: Optional[Dict[str, Any]] = None


@dataclass
class LabelTargetConfig:
    """One entry of the target-generation pipeline, e.g.
    ``{name: affinity, offsets: [...]}, {name: binary}`` (reference
    ``data/processing/transforms.py`` zoo)."""

    __extra_ok__ = True

    name: str = "binary"
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LabelTransformConfig:
    __extra_ok__ = True

    profile: Optional[str] = None
    targets: List[LabelTargetConfig] = field(default_factory=list)
    erosion: int = 0
    # Kisuk-window erosion (reference processing/segment.py:25): voxels whose
    # box window holds >1 positive id become background. Scalar = in-plane
    # half-size; per-axis list = anisotropic N-D window.
    erosion_window: Optional[Union[int, List[int]]] = None
    dilation: int = 0
    relabel_cc: bool = False
    normalize_labels: bool = False


@dataclass
class PreprocessConfig:
    __extra_ok__ = True

    normalize: str = "smart"  # smart | zscore | percentile | scale | none
    clip_percentiles: Optional[List[float]] = None
    read_downscale: Optional[List[int]] = None


@dataclass
class DataTransformConfig:
    """Paired transforms applied to image/label/mask/label_aux at volume load
    so they stay spatially aligned (reference ``DataTransformConfig``,
    ``config/schema/data.py:90``). Image resize is linear; label/mask resize
    is nearest-neighbor."""

    __extra_ok__ = True

    resize: Optional[List[int]] = None  # target spatial size [Z, Y, X]; None = off
    align_to_image: bool = False  # eval: center pad/crop GT/mask to prediction size
    binarize: bool = False  # label -> {0,1} via value > threshold
    threshold: float = 0.0
    pad_size: List[int] = field(default_factory=lambda: [0, 0, 0])  # extra border pad
    pad_mode: str = "reflect"  # reflect | replicate | constant


@dataclass
class NNUNetPreprocessingConfig:
    """nnU-Net-style preprocessing: foreground crop, spacing-aware
    resampling, normalization, and prediction restore
    (reference ``config/schema/data.py:139``)."""

    __extra_ok__ = True

    enabled: bool = False
    crop_to_nonzero: bool = True
    target_spacing: Optional[List[float]] = None  # (z, y, x)
    source_spacing: Optional[List[float]] = None  # None -> split resolution
    normalization: str = "zscore"  # zscore | percentile | none
    force_separate_z: Optional[bool] = None  # None = auto rule
    anisotropy_threshold: float = 3.0
    restore_to_input_space: bool = True


@dataclass
class DataConfig:
    __extra_ok__ = True

    train: DatasetSplitConfig = field(default_factory=DatasetSplitConfig)
    val: DatasetSplitConfig = field(default_factory=DatasetSplitConfig)
    test: DatasetSplitConfig = field(default_factory=DatasetSplitConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    label_transform: LabelTransformConfig = field(default_factory=LabelTransformConfig)
    preprocessing: PreprocessConfig = field(default_factory=PreprocessConfig)
    data_transform: DataTransformConfig = field(default_factory=DataTransformConfig)
    nnunet_preprocessing: NNUNetPreprocessingConfig = field(
        default_factory=NNUNetPreprocessingConfig
    )
    split: TrainValSplitConfig = field(default_factory=TrainValSplitConfig)
    base_path: Optional[str] = None


# ---------------------------------------------------------------------------
# optimization
# ---------------------------------------------------------------------------


@dataclass
class OptimizerConfig:
    __extra_ok__ = True

    name: str = "AdamW"
    lr: float = 1e-3
    weight_decay: float = 0.0
    betas: List[float] = field(default_factory=lambda: [0.9, 0.999])
    eps: float = 1e-8
    momentum: float = 0.9
    no_decay_bias: bool = True


@dataclass
class SchedulerConfig:
    __extra_ok__ = True

    name: Optional[str] = None
    interval: str = "epoch"
    frequency: int = 1  # Lightning compat no-op (optax schedules are per-step closures)
    warmup_epochs: int = 0
    warmup_steps: Optional[int] = None
    warmup_start_lr: float = 1e-6
    min_lr: float = 0.0
    monitor: Optional[str] = None
    mode: str = "min"
    factor: float = 0.2
    patience: int = 10
    step_size: int = 30
    gamma: float = 0.1
    milestones: Optional[List[int]] = None
    t_max: Optional[int] = None
    t_0: Optional[int] = None
    t_mult: int = 1
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DistillConfig:
    """Knowledge distillation from a frozen teacher (training/distill.py).

    An extension with no reference counterpart: the patchify
    throughput variant trails the stock model on quality; distilling the
    converged stock teacher into the fast student is the closing lever."""

    # flax msgpack file or Orbax checkpoint dir; None disables distillation
    teacher_checkpoint: Optional[str] = None
    # dict merged over the student ModelConfig to build the teacher
    # (e.g. {"mednext": {"patchify_stem": false}})
    teacher_model: Optional[Dict[str, Any]] = None
    alpha: float = 0.5  # total = (1-alpha)*hard + alpha*distill
    temperature: float = 2.0
    mode: str = "sigmoid"  # "sigmoid" soft targets | "mse" logit matching


@dataclass
class OptimizationConfig:
    __extra_ok__ = True

    profile: Optional[str] = None
    distill: DistillConfig = field(default_factory=DistillConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    max_epochs: int = 100
    max_steps: Optional[int] = None
    n_steps_per_epoch: Optional[int] = None
    precision: str = "bf16-mixed"  # "32" | "bf16-mixed" | "16-mixed" (alias)
    gradient_clip_val: Optional[float] = None
    accumulate_grad_batches: int = 1
    num_sanity_val_steps: int = 0  # Lightning compat no-op (val is jitted; no sanity pass needed)
    val_check_interval: Optional[Union[int, float]] = None
    check_val_every_n_epoch: int = 1
    limit_val_batches: Optional[Union[int, float]] = None
    remat: bool = False  # jax.checkpoint over model blocks


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------


@dataclass
class CheckpointConfig:
    __extra_ok__ = True

    save_top_k: int = 1
    monitor: str = "train_loss_total_epoch"
    mode: str = "min"
    save_last: bool = True
    every_n_steps: Optional[int] = None
    checkpoint_filename: Optional[str] = None


@dataclass
class EarlyStoppingConfig:
    enabled: bool = False
    monitor: str = "val_loss"
    mode: str = "min"
    patience: int = 20
    min_delta: float = 0.0
    check_finite: bool = True


@dataclass
class EMAConfig:
    enabled: bool = False
    decay: float = 0.999
    use_for_val: bool = True


@dataclass
class LoggingConfig:
    __extra_ok__ = True

    scalar: Dict[str, Any] = field(default_factory=dict)
    images: Dict[str, Any] = field(default_factory=dict)
    backend: str = "jsonl"  # jsonl | tensorboard | none


@dataclass
class MonitorConfig:
    __extra_ok__ = True

    logging: LoggingConfig = field(default_factory=LoggingConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    early_stopping: EarlyStoppingConfig = field(default_factory=EarlyStoppingConfig)
    ema: EMAConfig = field(default_factory=EMAConfig)
    detect_anomaly: bool = False
    nan_detection: bool = True
    wandb: Optional[Dict[str, Any]] = None
    # [start, end) global-step range captured with jax.profiler into
    # <run_dir>/profile (XLA/TPU trace; open with TensorBoard or Perfetto)
    profile_steps: Optional[List[int]] = None


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


@dataclass
class SlidingWindowConfig:
    """Reference ``schema/inference.py:54`` / ``inference/window.py:530``."""

    __extra_ok__ = True

    window_size: Optional[List[int]] = None
    overlap: float = 0.5
    stride: Optional[List[int]] = None
    blending: str = "bump"  # constant | bump | gaussian | distance
    sigma_scale: float = 0.125
    sw_batch_size: int = 4
    padding_mode: str = "reflect"
    border_mask: Optional[List[int]] = None
    snap_to_edge: bool = True
    # HBM accumulator dtype for overlap-add ("float32" | "bfloat16" |
    # "float16"); compact accumulators halve accumulation memory
    # (reference lazy fp16 accumulators, lazy.py:1133-1139)
    acc_dtype: str = "float32"


@dataclass
class TTAConfig:
    """Reference ``inference/tta.py:53`` / ``schema/inference.py:146``."""

    __extra_ok__ = True

    enabled: bool = False
    flip_axes: Union[str, List[List[int]], None] = None  # "all" | explicit
    rotation90: bool = False
    # generalize rotation90 (reference tta_combinations.py:159): spatial
    # rotation planes (pairs of axes, 0=z/1=y/2=x) and k-value subsets
    rotation_planes: Optional[List[List[int]]] = None
    rotation_k: Optional[List[int]] = None
    transforms: Optional[List[Dict[str, Any]]] = None
    ensemble_mode: Union[str, List[Any]] = "mean"  # mean|min|max or per-slice
    act: Optional[Union[str, List[Any]]] = None  # sigmoid/softmax/tanh per slice
    shard_across_devices: bool = True
    # patch-first-local mode (reference tta.py:420,822): variants evaluated
    # inside each window batch on-device; ONE volume sweep instead of one
    # per variant. Exact for mean ensembling on symmetric grids; min/max
    # ensemble at window level before blending.
    patch_first_local: bool = False


@dataclass
class InferenceModelConfig:
    __extra_ok__ = True

    activation_profile: Optional[str] = None
    act: Optional[Union[str, List[Any]]] = None
    select_channel: Optional[List[int]] = None
    output_head: Optional[str] = None


@dataclass
class ChunkedConfig:
    """Chunk-grid inference (reference ``inference/chunked.py:701``)."""

    __extra_ok__ = True

    enabled: bool = False
    chunk_size: Optional[List[int]] = None
    halo: Optional[List[int]] = None
    output_mode: str = "stitch_h5"  # stitch_h5 | chunk_h5 | precomputed | zarr
    h5_chunks: Optional[List[int]] = None
    resume: bool = True
    num_chunks_per_rank: Optional[int] = None
    roi_filter: bool = True


@dataclass
class InferenceOutputConfig:
    __extra_ok__ = True

    scale: Optional[float] = None
    dtype: Optional[str] = None
    save_raw: bool = True
    save_all_heads: bool = False
    crop_pad: Optional[List[int]] = None


@dataclass
class InferenceConfig:
    __extra_ok__ = True

    window: SlidingWindowConfig = field(default_factory=SlidingWindowConfig)
    test_time_augmentation: TTAConfig = field(default_factory=TTAConfig)
    model: InferenceModelConfig = field(default_factory=InferenceModelConfig)
    chunked: ChunkedConfig = field(default_factory=ChunkedConfig)
    output: InferenceOutputConfig = field(default_factory=InferenceOutputConfig)
    precision: str = "bf16"
    direct_2d: bool = False


# ---------------------------------------------------------------------------
# decoding / evaluation / tuning
# ---------------------------------------------------------------------------


@dataclass
class DecodingStepConfig:
    __extra_ok__ = True

    name: Optional[str] = None
    template: Optional[str] = None
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DecodingPostprocessConfig:
    __extra_ok__ = True

    min_instance_size: int = 0
    # small-instance handling: background (drop) | background_2d |
    # neighbor (merge into largest-contact neighbor) | neighbor_2d | none
    # (reference decoding/utils.py:40 modes)
    small_instance_mode: str = "background"
    max_instance_size: Optional[int] = None
    connectivity: int = 6
    # cc3d-style relabel: split instances that are not connected under
    # ``connectivity`` into separate ids (reference postprocess cc pass)
    split_disconnected: bool = False
    transpose: Optional[List[int]] = None
    # binary cleanup pipeline (reference BinaryPostprocessingConfig):
    # {threshold, median_filter_size, opening_iterations, closing_iterations,
    #  connected_components: {top_k, min_size, connectivity}}
    binary: Optional[Dict[str, Any]] = None


@dataclass
class TuningParamConfig:
    __extra_ok__ = True

    name: str = ""
    type: str = "float"  # float | int | categorical
    low: Optional[float] = None
    high: Optional[float] = None
    log: bool = False
    step: Optional[float] = None
    choices: Optional[List[Any]] = None


@dataclass
class TuningConfig:
    __extra_ok__ = True

    enabled: bool = False
    n_trials: int = 20
    sampler: str = "tpe"  # tpe | random | grid | cmaes
    pruner: Optional[str] = None
    metric: str = "adapted_rand"
    direction: str = "minimize"
    # multi-objective mode: when set, overrides metric/direction; trials get
    # a values vector and the study reports a Pareto front
    metrics: Optional[List[str]] = None
    directions: Optional[List[str]] = None
    params: List[TuningParamConfig] = field(default_factory=list)
    timeout_per_trial: Optional[float] = None
    seed: int = 0
    # waterz batch mode: sweep these merge thresholds inside ONE decode per
    # trial (watershed + RAG computed once; reference optuna_tuner.py:1155)
    batch_thresholds: Optional[List[float]] = None


@dataclass
class QCConfig:
    __extra_ok__ = True

    enabled: bool = False
    z_mean_drift: float = 0.5
    border_low_intensity: float = 0.05
    # full-scan knobs (reference AffinityQCParams, qc/affinity.py:24)
    z_stride: int = 1
    border_width: int = 8
    bg_thresh: float = 30.0
    # when set, the decoding stage writes the markdown QC report here
    report_path: Optional[str] = None


@dataclass
class DecodingConfig:
    __extra_ok__ = True

    enabled: bool = False
    steps: List[DecodingStepConfig] = field(default_factory=list)
    graph: Optional[Dict[str, Any]] = None
    # user-controlled suffix for decoded artifact names (overrides the
    # auto decode-recipe tag; reference output_naming.py:382)
    save_suffix: Optional[str] = None
    # decode-only mode: load this (C,Z,Y,X) prediction instead of running
    # inference (reference waterz_decoding.yaml load_prediction_path)
    load_prediction_path: Optional[str] = None
    # re-entrancy: reuse an existing decoded artifact when the prediction
    # came from a valid cache (its name encodes the decode recipe;
    # reference cache_resolver whole-run skip, dispatch.py:288-346)
    reuse_cached: bool = True
    # memory-bounded chunk-parallel decode (exact whole-volume parity for
    # affinity_cc / waterz[fragments=cc] single-step recipes); see
    # decoding/streamed.py
    streamed: bool = False
    streamed_chunk: List[int] = field(default_factory=lambda: [64, 256, 256])
    postprocessing: DecodingPostprocessConfig = field(default_factory=DecodingPostprocessConfig)
    tuning: TuningConfig = field(default_factory=TuningConfig)
    qc: QCConfig = field(default_factory=QCConfig)


@dataclass
class EvaluationConfig:
    __extra_ok__ = True

    enabled: bool = False
    metrics: List[str] = field(default_factory=list)
    nerl: Optional[Dict[str, Any]] = None
    tube: Optional[Dict[str, Any]] = None


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


@dataclass
class StageOverlay:
    """A stage block (``default`` / ``train`` / ``test`` / ``tune``) is kept
    as a *raw dict overlay* and merged by the stage resolver
    (reference three-level merge: ``pipeline/stage_resolver.py:336``)."""

    __extra_ok__ = True


@dataclass
class Config:
    """Root config (reference ``schema/root.py:26``)."""

    experiment_name: str = "connectomics_experiment"
    description: str = ""
    save_path: Optional[str] = None

    system: SystemConfig = field(default_factory=SystemConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    decoding: DecodingConfig = field(default_factory=DecodingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)

    def __post_init__(self):
        if self.model.output_size is None:
            self.model.output_size = list(self.model.input_size)
        if self.system.num_gpus is not None:
            self.system.num_devices = self.system.num_gpus
