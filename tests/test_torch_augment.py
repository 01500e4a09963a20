"""The port's host augmentation (``data/augment/``) against the JAX package's
(``pytorch_connectomics_tpu/data/augment/``), on the CPU: each of the 21
transforms on a seeded (1, 8, 24, 24) image with its label under the same
``np.random.Generator`` seeds, the composed ``aug_strong`` and
``aug_em_neuron`` profiles, and the training pipeline with ``aug_strong``
at 1 and 4 threads. Both are numpy and scipy with the same draws in the
same order, so every comparison is exact (``assert_array_equal``)."""

import numpy as np
import pytest

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.data.augment import build_augmentation_fn as jax_build
from pytorch_connectomics_tpu.data.augment import ops as jops
from pytorch_connectomics_tpu.data.pipeline import PatchPipeline as JaxPatchPipeline
from pytorch_connectomics_tpu.data.pipeline import build_dataset as jax_build_dataset
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.data.augment import build_augmentation_fn
from pytorch_connectomics_tpu_torch.data.augment import ops
from pytorch_connectomics_tpu_torch.data.pipeline import PatchPipeline, build_dataset, build_pipelines

SEEDS = (0, 1, 2, 3)


def _sample(seed, label_dtype=np.uint32):
    """A (1, 8, 24, 24) image in [0, 1] with an instance label and a mask."""
    rng = np.random.default_rng(100 + seed)
    img = rng.random((1, 8, 24, 24), dtype=np.float32)
    lbl = (rng.random((1, 8, 24, 24)) > 0.7).astype(label_dtype) * rng.integers(1, 4, (1, 8, 24, 24)).astype(label_dtype)
    return {"image": img, "label": lbl, "mask": (rng.random((1, 8, 24, 24)) > 0.1).astype(np.float32)}


# (transform name, keywords that make it fire): every transform of both
# packages, and each mode of the ones with several (misalignment's shift and
# rotation, slice shift's wrap, zero fill, per-slice draw and axis choice,
# intensity's inversion, copy-paste's float label)
CASES = [
    ("rand_flip", dict(prob=0.5)),
    ("rand_axis_permute", dict(prob=1.0)),
    ("rand_transpose", dict(prob=1.0)),
    ("rand_rotate90", dict(prob=1.0, spatial_axes=(1, 2))),
    ("rand_affine", dict(prob=1.0, rotate_range=(0.2, 0.1, 0.3), scale_range=(0.1, 0.1, 0.1),
                         shear_range=(0.05, 0.0, 0.05))),
    ("rand_elastic", dict(prob=1.0, sigma=4.0, alpha=6.0)),
    ("rand_misalignment", dict(prob=1.0, displacement=5)),
    ("rand_misalignment", dict(prob=1.0, displacement=5, rotate_ratio=1.0)),
    ("rand_missing_section", dict(prob=1.0, num_sections=3)),
    ("rand_lost_section", dict(prob=1.0, num_sections=2)),
    ("rand_slice_drop", dict(prob=1.0, num_slices=3)),
    ("rand_slice_shift", dict(prob=1.0, max_shift=4, num_slices=3)),
    ("rand_slice_shift", dict(prob=1.0, shift_magnitude=5, wrap=False, slice_prob=0.5, spatial_axis=(1, 2))),
    ("rand_slice_shift", dict(prob=1.0, max_shift=3, wrap=False, spatial_axis=2)),
    ("rand_missing_parts", dict(prob=1.0, hole_size=10, num_holes=2)),
    ("rand_motion_blur", dict(prob=1.0, sections=3, kernel_size=5)),
    ("rand_cut_blur", dict(prob=1.0, length_ratio=0.5, down_ratio=(2, 4))),
    ("rand_cut_noise", dict(prob=1.0, length_ratio=0.5, scale=0.3)),
    ("rand_stripe", dict(prob=1.0, intensity=0.2, num_stripes=3)),
    ("rand_intensity", dict(gaussian_noise_prob=0.7, shift_intensity_prob=0.7, contrast_prob=0.7,
                            contrast_range=(0.75, 1.25), invert_prob=0.5)),
    ("rand_mul_add", dict(prob=1.0)),
    ("rand_gamma", dict(prob=1.0, gamma_range=(0.7, 1.5))),
    ("rand_mixup", dict(prob=1.0, alpha=0.6)),
    ("rand_copy_paste", dict(prob=1.0)),
]


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'-'.join(map(str, c[1].values()))}"[:60])
def test_transform_matches_jax(case, seed):
    name, kw = case
    ours, theirs = getattr(ops, name), getattr(jops, name)
    if name in ("rand_mixup", "rand_copy_paste"):
        kw = dict(kw, other=_sample(seed + 50))
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = ours(_sample(seed), rng_a, **kw), theirs(_sample(seed), rng_b, **kw)
    _assert_samples_equal(got, want)
    assert rng_a.random() == rng_b.random()  # the same number of draws


def test_transforms_cover_the_jax_module():
    """Every ``rand_*`` transform of the JAX module has its port, and every
    one of them is a case above."""
    names = {n for n in dir(jops) if n.startswith("rand_")}
    assert len(names) == 21 and names <= set(dir(ops)) and names == {c[0] for c in CASES}


def test_copy_paste_offsets_integer_labels_only():
    for dtype in (np.uint32, np.float32):
        s, o = _sample(0, dtype), _sample(9, dtype)
        got = ops.rand_copy_paste(s, np.random.default_rng(1), other=o, prob=1.0)
        want = jops.rand_copy_paste(_sample(0, dtype), np.random.default_rng(1), other=_sample(9, dtype), prob=1.0)
        _assert_samples_equal(got, want)
        fg = o["label"][0] > 0
        offset = s["label"].max() + 1 if dtype == np.uint32 else 0
        np.testing.assert_array_equal(got["label"][:, fg], o["label"][:, fg] + offset)


SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"


@pytest.mark.parametrize("profile", ["aug_strong", "aug_em_neuron"])
def test_profile_matches_jax(profile):
    """The composed profile of both packages (loaded from each package's
    config) on the same samples and generators, with a second sample for
    the mixing transforms."""
    over = [f"data.augmentation.profile={profile}"]
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    fn = build_augmentation_fn(cfg.data.augmentation, sample_other=lambda rng: _sample(int(rng.integers(0, 9))))
    jfn = jax_build(jcfg.data.augmentation, sample_other=lambda rng: _sample(int(rng.integers(0, 9))))
    assert fn is not None and jfn is not None
    for seed in range(8):
        _assert_samples_equal(fn(_sample(seed), np.random.default_rng(seed)),
                              jfn(_sample(seed), np.random.default_rng(seed)))


def test_disabled_or_empty_augmentation_builds_nothing():
    cfg = load_config(SYNTH, mode="train")
    assert build_augmentation_fn(None) is None
    cfg.data.augmentation.enabled = False
    assert build_augmentation_fn(cfg.data.augmentation) is None


@pytest.mark.parametrize("threads", [1, 4])
def test_pipeline_with_aug_strong_matches_jax(tmp_path, threads):
    """The synthetic recipe's training pipeline with ``aug_strong``, reject
    sampling and the binary target: bit-identical batches to JAX's at steps
    0, 1 and 7, whatever the number of sample threads, also through the
    prefetch thread."""
    rng = np.random.default_rng(3)
    np.save(tmp_path / "im.npy", rng.integers(0, 256, (20, 48, 40), dtype=np.uint8))
    lbl = (rng.random((20, 48, 40)) > 0.9).astype(np.uint32) * rng.integers(1, 5, (20, 48, 40), dtype=np.uint32)
    np.save(tmp_path / "lb.npy", lbl)
    over = [f"data.train.image={tmp_path / 'im.npy'}", f"data.train.label={tmp_path / 'lb.npy'}",
            "data.dataloader.patch_size=[8,24,24]", "data.dataloader.batch_size=3",
            "data.augmentation.profile=aug_strong"]
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    ours = PatchPipeline(build_dataset(cfg, cfg.data.train), 3, seed=cfg.system.seed, augment_cfg=cfg.data.augmentation,
                         target_cfg=cfg.data.label_transform, num_threads=threads)
    ref = JaxPatchPipeline(jax_build_dataset(jcfg, jcfg.data.train), 3, seed=jcfg.system.seed,
                           augment_cfg=jcfg.data.augmentation, target_cfg=jcfg.data.label_transform)
    assert ours.augment is not None
    for step in (0, 1, 7):
        got, want = ours.make_batch(step), ref.make_batch(step)
        assert set(got) == set(want) == {"image", "label"}
        for k in got:
            assert got[k].shape == want[k].shape == (3, 8, 24, 24, 1)
            np.testing.assert_array_equal(got[k], want[k])
    batches = ours.iterate(5)
    np.testing.assert_array_equal(next(batches)["image"], ref.make_batch(5)["image"])
    batches.close()
    assert ours._pool is None  # closing the iterator stops the sample threads
    ours.close()


def test_build_pipelines_augments_on_the_host_with_the_resolved_threads():
    over = ["data.augmentation.profile=aug_strong", "system.num_workers=3",
            "data.train.image=synthetic://em2/aug_image?shape=8,32,32",
            "data.train.label=synthetic://em2/aug_label?shape=8,32,32", "data.dataloader.patch_size=[8,16,16]"]
    train, val = build_pipelines(load_config(SYNTH, overrides=over, mode="train"), "cpu")
    assert train.augment is not None and train.num_threads == 3 and val is None
    auto = load_config(SYNTH, overrides=over[:1] + over[2:], mode="train")
    assert auto.system.num_workers == jax_load_config(SYNTH, overrides=over[:1] + over[2:], mode="train").system.num_workers
    assert auto.system.num_workers >= 1


def test_on_device_augmentation_raises():
    """On-device augmentation is ported (tests/test_torch_augment_device.py):
    it no longer raises, and the host pipeline then augments nothing, as
    JAX's (``pipeline.py:288``)."""
    over = ["data.augmentation.profile=aug_strong", "data.augmentation.on_device=true"]
    train, _ = build_pipelines(load_config(SYNTH, overrides=over, mode="train"), "cpu")
    assert train.augment is None
    train.close()
