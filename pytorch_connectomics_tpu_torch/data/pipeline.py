"""Host data pipeline: config -> batched train/val iterators, the port of
``_reject_from_cfg``, ``build_dataset``, ``make_train_val_datasets``,
``PatchPipeline`` and ``build_pipelines`` of
``pytorch_connectomics_tpu/data/pipeline.py:31-317``.

Each sample draws from a ``np.random.Generator`` seeded by
``SeedSequence([seed, train, step, slot])``, as in the JAX package, so one
volume gives bit-identical batches in both packages. Batches are stacked
channels-last ``(N, Z, Y, X, C)`` float32 numpy arrays; the trainer moves
them to the device.

A training pipeline augments each sample on the host after the crop and
before the targets (:mod:`.augment`, the same draws from the same
generator), and makes the samples of a batch in a pool of
``cfg.system.num_workers`` threads; the batches do not depend on the
thread count. Where a label volume carries ``-1`` (unlabeled) voxels, each
sample also gets the per-channel validity mask of its targets, multiplied
into its ``mask``. With ``data.dataloader.target_context`` the dataset
crops a patch larger by twice the context on each axis, and every array of
a sample is cropped back to the patch after augmentation and targets, so
long-range affinities at the patch border see real data (JAX
``pipeline.py:58-62,218-224``). This slice ports the cached in-RAM dataset:
on-device augmentation, lazy (zarr) datasets, nnU-Net preprocessing,
auxiliary label volumes, read-time downscaling and paired data transforms
raise ``NotImplementedError``. Without ``data.val`` paths, ``data.split``
splits each train volume into train and val slabs along one axis
(:mod:`.split`).
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config.schema import Config, DatasetSplitConfig
from .augment import build_augmentation_fn
from .datasets import RejectConfig, VolumeDataset
from .split import split_volume
from .targets import build_target_fn
from .targets.build import build_target_mask_fn


def _reject_from_cfg(block) -> Optional[RejectConfig]:
    if not block:
        return None
    return RejectConfig(
        enabled=bool(block.get("enabled", True)),
        min_fg_ratio=float(block.get("min_fg_ratio", 0.0)),
        max_attempts=int(block.get("max_attempts", 20)),
        prob=float(block.get("prob", 0.95)),
    )


def build_dataset(cfg: Config, split_cfg: DatasetSplitConfig, train: bool = True, device=None) -> VolumeDataset:
    dl = cfg.data.dataloader
    dt = cfg.data.data_transform
    use_cache = dl.use_preloaded_cache_train if train else dl.use_preloaded_cache_val
    for flag, what in (
        (dl.use_lazy_zarr or not use_cache, "the lazy (uncached) dataset"),
        (cfg.data.nnunet_preprocessing.enabled, "nnU-Net preprocessing"),
        (split_cfg.label_aux, "auxiliary label volumes"),
        (split_cfg.image_internal_path or split_cfg.label_internal_path, "internal dataset paths"),
        (cfg.data.preprocessing.read_downscale, "read-time downscaling"),
        (dt.resize or dt.binarize or any(dt.pad_size or ()), "paired data transforms"),
    ):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")
    patch = tuple(dl.patch_size)
    if dl.target_context:
        # patch + context: the pipeline crops the context back off after the targets
        patch = tuple(p + 2 * int(c) for p, c in zip(patch, dl.target_context))
    return VolumeDataset(
        split_cfg.image,
        split_cfg.label,
        split_cfg.mask,
        patch_size=patch,
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
    if not cfg.data.split.enabled:
        return train_ds, None
    # the axis-range split of every train volume: the train dataset keeps
    # the train slabs, a copy of it the val slabs; the volume draw keeps the
    # whole volumes' proportions, as in the JAX package. Masks are split
    # with their volumes (the JAX package keeps them whole).
    s = cfg.data.split

    def halves(vols):
        pairs = [split_volume(v, s.axis, s.train_range, s.val_range) if v is not None else (None, None)
                 for v in vols]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    val_ds = copy.copy(train_ds)
    train_ds.images, val_ds.images = halves(train_ds.images)
    train_ds.labels, val_ds.labels = halves(train_ds.labels)
    train_ds.masks, val_ds.masks = halves(train_ds.masks)
    return train_ds, val_ds


class PatchPipeline:
    """Assembles batches: sample -> augment (training only) -> target
    generation -> NDHWC stack, the samples of a batch in a pool of
    ``num_threads`` threads."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, augment_cfg=None, target_cfg=None,
                 num_threads: int = 4, prefetch: int = 2, train: bool = True, target_context=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.seed = seed
        self.train = train
        self.augment = build_augmentation_fn(augment_cfg if train else None,
                                             sample_other=lambda rng: self.dataset.sample(rng))
        self.target_fn = build_target_fn(target_cfg)
        # decided once per dataset, so every sample of a batch has the same keys
        self.target_mask_fn = build_target_mask_fn(target_cfg) if getattr(dataset, "has_unlabeled", False) else None
        self.target_context = tuple(int(c) for c in (target_context or ()))
        self.num_threads = max(1, int(num_threads))
        self.prefetch = prefetch
        self._pool: Optional[ThreadPoolExecutor] = None
        # host time spent making batches (wall clock, the pool's threads
        # together), and their count
        self.host_seconds = 0.0
        self.batches = 0

    def _make_sample(self, step: int, slot: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0 if self.train else 1, step, slot]))
        s = self.dataset.sample(rng)
        if self.augment is not None:
            s = self.augment(s, rng)
        if self.target_fn is not None and "label" in s:
            raw_seg = s["label"]
            s["label"] = self.target_fn(raw_seg)
            if self.target_mask_fn is not None:
                tm = self.target_mask_fn(raw_seg)
                s["mask"] = s["mask"] * tm if "mask" in s else tm
        if any(self.target_context):
            # the context margin off every array, after the targets saw it
            cz, cy, cx = self.target_context
            sl = (slice(None), slice(cz, -cz or None), slice(cy, -cy or None), slice(cx, -cx or None))
            s = {k: v[sl] for k, v in s.items()}
        return s

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.num_threads, thread_name_prefix="patch")
        samples = list(self._pool.map(lambda slot: self._make_sample(step, slot), range(self.batch_size)))
        batch = self.collate(samples)
        self.host_seconds += time.perf_counter() - t0
        self.batches += 1
        return batch

    def close(self) -> None:
        """Stop the sample threads (a later batch starts them again)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

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
            self.close()


def build_pipelines(cfg: Config, device=None):
    """Config -> (train PatchPipeline, val PatchPipeline or None). The train
    pipeline augments on the host, and not at all when
    ``augmentation.on_device`` is set (JAX ``pipeline.py:288``): the train
    step then runs the transforms that have a device form
    (``ops/augment.py``), and the host-only ones (elastic and the others)
    are dropped, as JAX's code drops them (ROADMAP C)."""
    aug = None if cfg.data.augmentation.on_device else cfg.data.augmentation
    train_ds, val_ds = make_train_val_datasets(cfg, device)
    dl = cfg.data.dataloader
    train_pipe = PatchPipeline(
        train_ds, dl.batch_size, seed=cfg.system.seed, augment_cfg=aug, target_cfg=cfg.data.label_transform,
        num_threads=cfg.system.num_workers, prefetch=dl.prefetch, train=True, target_context=dl.target_context,
    )
    val_pipe = None
    if val_ds is not None:
        val_pipe = PatchPipeline(
            val_ds, dl.val_batch_size or dl.batch_size, seed=cfg.system.seed,
            target_cfg=cfg.data.label_transform, num_threads=1, prefetch=1, train=False,
            target_context=dl.target_context,
        )
    return train_pipe, val_pipe
