"""The port's on-device augmentation (``ops/augment.py``) against the JAX
package's (``pytorch_connectomics_tpu/ops/augment_jax.py``), on the CPU.

Each transform's ``apply`` is fed JAX's own draws, which the tests replay
with ``jax.random`` from the same key splits as ``augment_jax.py`` (the
port's generator draws other bits, by design): geometric and masking
transforms match bit for bit, intensity transforms within 1e-6. Then the
batch function's order and keyword parsing, the flip-safe rule, the host
pipeline's skip and the seeded step generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.ops import augment_jax as ja
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.data.pipeline import build_pipelines
from pytorch_connectomics_tpu_torch.ops import augment as pa
from pytorch_connectomics_tpu_torch.training.loop import FLIP_SAFE, device_augment_fn
from pytorch_connectomics_tpu_torch.training.state import step_generator

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"
N = 6


def _u(k, lo=0.0, hi=1.0, shape=()):
    return jax.random.uniform(k, shape, minval=lo, maxval=hi)


# each transform's draws from its key, in the port's names, as augment_jax.py takes them
def _flip(key, shape, prob=0.5, **_):
    return {"do": jnp.stack([_u(k) < prob for k in jax.random.split(key, 3)])}


def _transpose(key, shape, prob=0.5, **_):
    return {"do": _u(key) < prob}


def _rotate(key, shape, prob=0.5, **_):
    return {"do": _u(jax.random.fold_in(key, 0)) < prob, "k": jax.random.randint(jax.random.fold_in(key, 1), (), 1, 4)}


def _misalignment(key, shape, prob=0.3, displacement=12, **_):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    d = displacement
    return {"zi": jax.random.randint(k1, (), 1, max(2, shape[0])), "dy": jax.random.randint(k2, (), -d, d + 1),
            "dx": jax.random.randint(k3, (), -d, d + 1), "do": _u(k4) < prob}


def _missing_section(key, shape, prob=0.3, num_sections=2, **_):
    k1, k2 = jax.random.split(key)
    return {"idx": jax.random.randint(k1, (max(1, num_sections),), 0, shape[0]), "do": _u(k2) < prob}


def _slice_shift(key, shape, prob=0.2, max_shift=8, num_slices=2, **_):
    ks = jax.random.split(key, 4)
    m = int(max_shift)
    return {"zsel": jax.random.randint(ks[0], (int(num_slices),), 0, shape[0]),
            "sy": jax.random.randint(ks[1], (), -m, m + 1), "sx": jax.random.randint(ks[2], (), -m, m + 1),
            "do": _u(ks[3]) < prob}


def _missing_parts(key, shape, prob=0.2, hole_size=24, **_):
    ks = jax.random.split(key, 4)
    z, y, x = shape[:3]
    return {"zi": jax.random.randint(ks[0], (), 0, z), "oy": jax.random.randint(ks[1], (), 0, max(1, y - hole_size)),
            "ox": jax.random.randint(ks[2], (), 0, max(1, x - hole_size)), "do": _u(ks[3]) < prob}


def _motion_blur(key, shape, prob=0.2, sections=2, **_):
    ks = jax.random.split(key, 4)
    return {"along_x": jax.random.bernoulli(ks[0]), "zsel": jax.random.randint(ks[1], (int(sections),), 0, shape[0]),
            "do": _u(ks[2]) < prob}


def _cut_noise(key, shape, prob=0.2, length_ratio=0.4, scale=0.3, **_):
    ks = jax.random.split(key, 5)
    (z, y, x), (lz, ly, lx) = shape[:3], [max(1, int(s * length_ratio)) for s in shape[:3]]
    return {"oz": jax.random.randint(ks[0], (), 0, z - lz + 1), "oy": jax.random.randint(ks[1], (), 0, y - ly + 1),
            "ox": jax.random.randint(ks[2], (), 0, x - lx + 1), "noise": _u(ks[3], -scale, scale, shape),
            "do": _u(ks[4]) < prob}


def _stripe(key, shape, prob=0.1, intensity=0.15, num_stripes=4, **_):
    ks = jax.random.split(key, 3)
    ns = int(num_stripes)
    return {"rows": jax.random.randint(ks[0], (ns,), 0, shape[1]), "deltas": _u(ks[1], -intensity, intensity, (ns,)),
            "do": _u(ks[2]) < prob}


def _intensity(key, shape, gaussian_noise_prob=0.5, shift_intensity_prob=0.5, shift_intensity_offset=0.1,
               contrast_prob=0.5, contrast_range=(0.8, 1.2), **_):
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    return {"noise": jax.random.normal(k1, shape), "do_noise": _u(k2) < gaussian_noise_prob,
            "shift": _u(k3, -shift_intensity_offset, shift_intensity_offset), "do_shift": _u(k4) < shift_intensity_prob,
            "factor": _u(k5, *contrast_range), "do_contrast": _u(k6) < contrast_prob}


def _mul_add(key, shape, prob=0.5, mul_range=(0.9, 1.1), add_range=(-0.1, 0.1), **_):
    ks = jax.random.split(key, 3)
    return {"mul": _u(ks[0], *mul_range), "add": _u(ks[1], *add_range), "do": _u(ks[2]) < prob}


def _gamma(key, shape, prob=0.3, gamma_range=(0.7, 1.5), **_):
    return {"gamma": _u(jax.random.fold_in(key, 0), *gamma_range), "do": _u(jax.random.fold_in(key, 1)) < prob}


JAX_DRAWS = {"flip": _flip, "transpose": _transpose, "rotate": _rotate, "misalignment": _misalignment,
             "missing_section": _missing_section, "slice_shift": _slice_shift, "missing_parts": _missing_parts,
             "motion_blur": _motion_blur, "cut_noise": _cut_noise, "stripe": _stripe, "intensity": _intensity,
             "mul_add": _mul_add, "gamma": _gamma}
JAX_FNS = {name: fn for name, fn in ja._DEVICE_ORDER}
PORT = {name: (draw, apply) for name, draw, apply, _ in pa.DEVICE_ORDER}
# transforms that only move, mask or add voxels: bit for bit; the others within 1e-6
EXACT = {"flip", "transpose", "rotate", "misalignment", "missing_section", "slice_shift", "missing_parts",
         "cut_noise", "stripe"}
CASES = [
    ("flip", dict(prob=0.5)),
    ("transpose", dict(prob=0.5)),
    ("rotate", dict(prob=0.7)),
    ("misalignment", dict(prob=0.7, displacement=3)),
    ("missing_section", dict(prob=0.7, num_sections=2)),
    ("slice_shift", dict(prob=0.7, max_shift=3, num_slices=2)),
    ("missing_parts", dict(prob=0.7, hole_size=4)),
    ("motion_blur", dict(prob=0.7, sections=2, kernel_size=5)),
    ("cut_noise", dict(prob=0.7, length_ratio=0.5, scale=0.3)),
    ("stripe", dict(prob=0.7, intensity=0.2, num_stripes=3)),
    ("intensity", dict(gaussian_noise_prob=0.6, gaussian_noise_std=0.1, shift_intensity_prob=0.6,
                       shift_intensity_offset=0.15, contrast_prob=0.6, contrast_range=(0.75, 1.25))),
    ("mul_add", dict(prob=0.7)),
    ("gamma", dict(prob=0.7)),
]


def _batch(shape, seed=0):
    """(N, *shape, 1) image in [0, 1], label, mask and weight."""
    rng = np.random.default_rng(seed)
    full = (N, *shape, 1)
    return {"image": rng.random(full, dtype=np.float32),
            "label": rng.integers(0, 4, full).astype(np.float32),
            "mask": (rng.random(full) > 0.2).astype(np.float32),
            "weight": rng.random(full, dtype=np.float32)}


def _jax_draws(name, keys, shape, kw):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax.vmap(lambda k: JAX_DRAWS[name](k, shape + (1,), **kw))(keys).items()}


def _check(got, want, exact):
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)


# every transform on square (y, x); those whose rule or edges depend on the shape also on a non-square one
SHAPED = [(n, kw, (4, 10, 10)) for n, kw in CASES] + [
    (n, kw, (5, 8, 12)) for n, kw in CASES if n in ("transpose", "rotate", "misalignment", "slice_shift", "motion_blur")]


@pytest.mark.parametrize("name,kw,shape", SHAPED, ids=[f"{c[0]}-{'x'.join(map(str, c[2]))}" for c in SHAPED])
def test_transform_matches_jax_on_jax_draws(name, kw, shape):
    """One transform over a batch of 6: JAX's vmapped function on the
    sample keys against the port's apply on the draws of the same keys;
    non-square (y, x) leaves transpose and rotate without effect."""
    b = _batch(shape, seed=len(name))
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    want = jax.vmap(lambda s, k: JAX_FNS[name](s, k, **kw))({k: jnp.asarray(v) for k, v in b.items()}, keys)
    got = PORT[name][1]({k: torch.from_numpy(v) for k, v in b.items()}, _jax_draws(name, keys, shape, kw), **kw)
    _check(got, want, name in EXACT)
    if name in ("transpose", "rotate") and shape[1] != shape[2]:
        np.testing.assert_array_equal(got["image"].numpy(), b["image"])


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_draws_have_the_shapes_of_jax_draws(name, kw):
    """The port's draws on its own generator: the keys, shapes and dtypes of
    JAX's draws, the same from the same seed."""
    shape = (4, 10, 10)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    want = _jax_draws(name, keys, shape, kw)
    got = PORT[name][0](torch.Generator().manual_seed(1), N, shape + (1,), **kw)
    again = PORT[name][0](torch.Generator().manual_seed(1), N, shape + (1,), **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and (got[k].dtype == torch.bool) == (want[k].dtype == torch.bool), k
        assert got[k].is_floating_point() == want[k].is_floating_point(), k
        assert torch.equal(got[k], again[k])


@pytest.mark.parametrize("profile", ["aug_standard", "aug_strong"])
def test_batch_function_order_matches_jax(profile):
    """JAX's ``build_device_augment_fn`` against the port's steps applied in
    their order on JAX's per-step draws (``fold_in(sample key, i)``): the
    same transforms, order and keywords."""
    over = [f"data.augmentation.profile={profile}", "data.augmentation.on_device=true"]
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    shape = (4, 12, 12)
    b = _batch(shape, seed=7)
    key = jax.random.PRNGKey(11)
    want = ja.build_device_augment_fn(jcfg.data.augmentation)({k: jnp.asarray(v) for k, v in b.items()}, key)
    steps = pa.device_steps(cfg.data.augmentation)
    assert [s[0] for s in steps] == [n for n, fn in ja._DEVICE_ORDER if getattr(jcfg.data.augmentation, n, None)
                                     and jcfg.data.augmentation.__dict__[n].get("enabled", True)]
    sample_keys = jax.random.split(key, N)
    got = {k: torch.from_numpy(v) for k, v in b.items()}
    for i, (name, _, apply, kw) in enumerate(steps):
        step_keys = jax.vmap(lambda k: jax.random.fold_in(k, i))(sample_keys)
        got = apply(got, _jax_draws(name, step_keys, shape, kw), **kw)
    _check(got, want, exact=False)
    assert not np.array_equal(got["image"].numpy(), b["image"])


def test_flip_safe_rule_and_host_skip():
    """On-device augmentation runs for flip-safe targets only (a warning and
    none for affinities), and the host pipeline never augments when it is
    set (JAX ``pipeline.py:288``)."""
    over = ["data.augmentation.profile=aug_strong", "data.augmentation.on_device=true",
            "data.train.image=synthetic://em2/dev_image?shape=8,32,32",
            "data.train.label=synthetic://em2/dev_label?shape=8,32,32", "data.dataloader.patch_size=[8,16,16]"]
    cfg = load_config(SYNTH, overrides=over, mode="train")
    assert {t.name for t in cfg.data.label_transform.targets} <= FLIP_SAFE
    fn = device_augment_fn(cfg)
    assert fn is not None
    train, _ = build_pipelines(cfg, "cpu")
    assert train.augment is None
    train.close()
    aff = load_config(SYNTH, overrides=over + ["data.label_transform.targets=[{name: affinity}]"], mode="train")
    assert device_augment_fn(aff) is None
    off = load_config(SYNTH, overrides=over[:1] + over[2:], mode="train")
    assert device_augment_fn(off) is None
    train, _ = build_pipelines(off, "cpu")
    assert train.augment is not None
    train.close()
    b = {k: torch.from_numpy(v) for k, v in _batch((4, 12, 12)).items()}
    one = fn(dict(b), step_generator(0, 5, "cpu"))
    two = fn(dict(b), step_generator(0, 5, "cpu"))
    other = fn(dict(b), step_generator(0, 6, "cpu"))
    assert all(torch.equal(one[k], two[k]) for k in b)
    assert not torch.equal(one["image"], other["image"])
    assert one["image"].device.type == "cpu" and one["image"].shape == b["image"].shape
