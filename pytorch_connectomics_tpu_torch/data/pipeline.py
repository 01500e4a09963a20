"""Host data pipeline: config -> batched train/val iterators, the port of
``_reject_from_cfg``, ``build_dataset``, ``make_train_val_datasets``,
``PatchPipeline`` and ``build_pipelines`` of
``pytorch_connectomics_tpu/data/pipeline.py:31-317``.

Each sample draws from a ``np.random.Generator`` seeded by
``SeedSequence([seed, train, step, slot])``, as in the JAX package, so one
volume gives bit-identical batches in both packages. Batches are stacked
channels-last ``(N, Z, Y, X, C)`` float32 numpy arrays; the trainer moves
them to the device.

This slice ports the cached in-RAM dataset without host augmentation: a
configured augmentation block, lazy (zarr) datasets, nnU-Net
preprocessing, auxiliary label volumes, target context, read-time
downscaling, paired data transforms, axis-range splits and per-channel
target masks raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config.schema import Config, DatasetSplitConfig
from .datasets import RejectConfig, VolumeDataset
from .targets import build_target_fn

_AUG_SWITCHES = ("profile", "enabled", "on_device")


def _reject_from_cfg(block) -> Optional[RejectConfig]:
    if not block:
        return None
    return RejectConfig(
        enabled=bool(block.get("enabled", True)),
        min_fg_ratio=float(block.get("min_fg_ratio", 0.0)),
        max_attempts=int(block.get("max_attempts", 20)),
        prob=float(block.get("prob", 0.95)),
    )


def check_augmentation(aug_cfg) -> None:
    """Raise when the resolved augmentation config enables any block: host
    and on-device augmentation are not ported yet, and a block must not be
    skipped silently."""
    if aug_cfg is None or not aug_cfg.enabled:
        return
    names = [f.name for f in dataclasses.fields(aug_cfg) if f.name not in _AUG_SWITCHES]
    names += sorted(getattr(aug_cfg, "extra", None) or {})
    on = []
    for name in names:
        block = getattr(aug_cfg, name, None)
        if block is None:
            block = (getattr(aug_cfg, "extra", None) or {}).get(name)
        if block and (not isinstance(block, dict) or block.get("enabled", True)):
            on.append(name)
    if on:
        raise NotImplementedError(f"augmentation is not ported yet: {', '.join(on)}")


def build_dataset(cfg: Config, split_cfg: DatasetSplitConfig, train: bool = True, device=None) -> VolumeDataset:
    dl = cfg.data.dataloader
    dt = cfg.data.data_transform
    use_cache = dl.use_preloaded_cache_train if train else dl.use_preloaded_cache_val
    for flag, what in (
        (dl.use_lazy_zarr or not use_cache, "the lazy (uncached) dataset"),
        (cfg.data.nnunet_preprocessing.enabled, "nnU-Net preprocessing"),
        (split_cfg.label_aux, "auxiliary label volumes"),
        (split_cfg.image_internal_path or split_cfg.label_internal_path, "internal dataset paths"),
        (dl.target_context, "target context"),
        (cfg.data.preprocessing.read_downscale, "read-time downscaling"),
        (dt.resize or dt.binarize or any(dt.pad_size or ()), "paired data transforms"),
    ):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")
    return VolumeDataset(
        split_cfg.image,
        split_cfg.label,
        split_cfg.mask,
        patch_size=tuple(dl.patch_size),
        normalize=cfg.data.preprocessing.normalize,
        reject=_reject_from_cfg(dl.reject_sampling),
        transpose=split_cfg.transpose,
        clip_percentiles=cfg.data.preprocessing.clip_percentiles,
        device=device,
    )


def make_train_val_datasets(cfg: Config, device=None):
    """(train dataset, val dataset or None): val from ``data.val`` paths."""
    train_ds = build_dataset(cfg, cfg.data.train, train=True, device=device)
    if cfg.data.val.image:
        return train_ds, build_dataset(cfg, cfg.data.val, train=False, device=device)
    if cfg.data.split.enabled:
        raise NotImplementedError("the axis-range train/val split is not ported yet")
    return train_ds, None


class PatchPipeline:
    """Assembles batches: sample -> target generation -> NDHWC stack."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, target_cfg=None, prefetch: int = 2, train: bool = True):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.seed = seed
        self.train = train
        self.target_fn = build_target_fn(target_cfg)
        if getattr(dataset, "has_unlabeled", False):
            raise NotImplementedError("per-channel target masks of unlabeled (-1) voxels are not ported yet")
        self.prefetch = prefetch
        # host time spent making batches, and their count
        self.host_seconds = 0.0
        self.batches = 0

    def _make_sample(self, step: int, slot: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0 if self.train else 1, step, slot]))
        s = self.dataset.sample(rng)
        if self.target_fn is not None and "label" in s:
            s["label"] = self.target_fn(s["label"])
        return s

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        batch = self.collate([self._make_sample(step, i) for i in range(self.batch_size)])
        self.host_seconds += time.perf_counter() - t0
        self.batches += 1
        return batch

    @staticmethod
    def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """Stack and convert (C, Z, Y, X) -> (N, Z, Y, X, C) float32."""
        out: Dict[str, np.ndarray] = {}
        for k in samples[0]:
            arr = np.stack([s[k] for s in samples])
            out[k] = np.ascontiguousarray(np.moveaxis(arr, 1, -1)).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Batches for steps ``start_step, start_step + 1, ...``, made ahead
        by one producer thread (``prefetch`` batches deep). A producer error
        is raised in the consumer; closing the iterator stops the thread."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            step = start_step
            while not stop.is_set():
                try:
                    batch = self.make_batch(step)
                except Exception as e:  # handed to the consumer, which raises it
                    put(e)
                    return
                if not put(batch):
                    return
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


def build_pipelines(cfg: Config, device=None):
    """Config -> (train PatchPipeline, val PatchPipeline or None)."""
    check_augmentation(cfg.data.augmentation)
    train_ds, val_ds = make_train_val_datasets(cfg, device)
    dl = cfg.data.dataloader
    train_pipe = PatchPipeline(
        train_ds, dl.batch_size, seed=cfg.system.seed, target_cfg=cfg.data.label_transform,
        prefetch=dl.prefetch, train=True,
    )
    val_pipe = None
    if val_ds is not None:
        val_pipe = PatchPipeline(
            val_ds, dl.val_batch_size or dl.batch_size, seed=cfg.system.seed,
            target_cfg=cfg.data.label_transform, prefetch=1, train=False,
        )
    return train_pipe, val_pipe
