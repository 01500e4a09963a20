"""The port's affinity instance chain against the JAX package on the CPU:
the synthetic neuron volumes (``synthetic://instance``), the affinity
targets and their masks, the patch pipeline on labels with unlabeled (-1)
voxels, the affinity-aware loss orchestrator and one train step of a tiny
3-channel MedNeXt, the validation step on affinities, the native affinity
ops and the ``affinity_cc``/``waterz``/``mutex_watershed`` decoders, and a
tiny CLI drive of ``tutorials/synthetic_instance.yaml`` (train with val,
then test with waterz)."""

import jax
import numpy as np
import pytest
import torch
from scipy import ndimage

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.config.schema import LabelTransformConfig as JaxLabelTransformConfig
from pytorch_connectomics_tpu.config.schema import build_dataclass as jax_build_dataclass
from pytorch_connectomics_tpu.data.pipeline import PatchPipeline as JaxPatchPipeline
from pytorch_connectomics_tpu.data.pipeline import build_dataset as jax_build_dataset
from pytorch_connectomics_tpu.data.synthetic_jax import synthetic_instance_volume as jax_instance
from pytorch_connectomics_tpu.data.targets import affinity as jaff
from pytorch_connectomics_tpu.data.targets import build as jbuild
from pytorch_connectomics_tpu.decoding import decoders as jdec
from pytorch_connectomics_tpu.decoding.stage import run_decoding_stage as jax_run_decoding_stage
from pytorch_connectomics_tpu.losses.orchestrator import LossOrchestrator as JaxOrchestrator
from pytorch_connectomics_tpu.metrics import binary as jbinary
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.ops import native as jnative
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.config.schema import LabelTransformConfig, build_dataclass
from pytorch_connectomics_tpu_torch.data import io, synthetic
from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.data.pipeline import PatchPipeline, build_dataset
from pytorch_connectomics_tpu_torch.data.targets import affinity as paff
from pytorch_connectomics_tpu_torch.data.targets import build as pbuild
from pytorch_connectomics_tpu_torch.decoding import decoders as pdec
from pytorch_connectomics_tpu_torch.decoding import run_decoding_stage
from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import flax_to_state_dict, load_flax_params
from pytorch_connectomics_tpu_torch.ops import native
from pytorch_connectomics_tpu_torch.runtime.cli import main
from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step, make_val_step

TUNE = "tutorials/synthetic_instance_tune_tpu.yaml"
INSTANCE = "tutorials/synthetic_instance.yaml"
# short- and long-range offsets, negative ones and a zero one, in both forms
OFFSETS = ["0-0-1", "0-1-0", "1-0-0", "0--9-0", "-4-0-0", "0-0--3", "2-5-0", (0, -1, 2), "0-0-0"]
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "optimization.precision=32",
    "model.input_size=[16,16,16]",
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small torch operations; under the parallel test
    run (several workers of one thread per core each) torch's spinning
    intra-op threads made them about 25x slower, so they run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) synthetic://instance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elongation", [1.0, 3.0], ids=["round", "elongated"])
def test_instance_transform_matches_jax_on_jax_draws(elongation):
    """The port's transform fed the draws of JAX's own keys gives JAX's
    volume: labels identical (no boundary voxel flips: the distances are
    computed in the same f32 operations in the same order), image within
    1e-5."""
    shape, n = (12, 40, 36), 11
    key = jax.random.PRNGKey(5)
    ks = jax.random.split(key, 9)
    # key index of each draw in synthetic_jax.py:179-232
    slot = {"warp_z": 0, "warp_y": 1, "warp_x": 2, "tex": 4, "org": 5, "gain": 6}
    d = {k: jax.random.normal(ks[slot[k]], synthetic.low_shape(shape, fv))
         for k, fv in synthetic._INSTANCE_FIELDS.items()}
    d["seeds"] = jax.random.uniform(ks[3], (n, 3))
    d["slice_gain"] = jax.random.normal(ks[7], (shape[0], 1, 1))
    d["noise"] = jax.random.normal(ks[8], shape)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    want_img, want_lbl = jax_instance(key, shape, n_cells=n, elongation=elongation)
    img, lbl = synthetic.synthetic_instance_volume(draws, shape, elongation)
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(want_lbl))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    assert set(np.unique(lbl.numpy())) == set(range(1, n + 1))


def test_instance_url_cells_and_elongation():
    """``synthetic://instance``: uint8 image and uint32 labels 1..n from one
    generation, n = max(8, 180 per megavoxel) unless ``cells=`` names it;
    ``cells=``/``elong=`` give other volumes."""
    url = "synthetic://instance/x_{}?shape=16,48,40&seed=3"
    img, lbl = read_volume(url.format("image")), read_volume(url.format("label"))
    assert img.dtype == np.uint8 and lbl.dtype == np.uint32 and img.shape == lbl.shape == (16, 48, 40)
    assert synthetic.default_cells((16, 48, 40)) == 8 == lbl.max() and lbl.min() == 1
    assert synthetic.default_cells((32, 192, 192)) == 212
    # membranes are dark: the boundary voxels' mean lies below the interior's
    mem = synthetic.instance_boundary(torch.from_numpy(lbl.astype(np.int32))).numpy()
    assert img[mem].mean() + 40 < img[~mem].mean()
    many = read_volume(url.format("label") + "&cells=20")
    assert many.max() == 20
    long_img = read_volume(url.format("image") + "&elong=3")
    assert not np.array_equal(long_img, img)
    io._SYNTH_CACHE.clear()
    np.testing.assert_array_equal(read_volume(url.format("label")), lbl)


# ---------------------------------------------------------------------------
# (b) affinity targets and masks
# ---------------------------------------------------------------------------


def _seg_with_unlabeled(seed=0, shape=(10, 14, 12)):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 5, shape).astype(np.int64)
    seg = ndimage.maximum_filter(seg, size=3)  # blobs, so edges match often
    seg[rng.random(shape) < 0.08] = -1
    return seg


def _label_cfgs(mode):
    d = {"targets": [{"name": "binary"}, {"name": "affinity", "kwargs": {"offsets": OFFSETS, "affinity_mode": mode}}]}
    return build_dataclass(LabelTransformConfig, d), jax_build_dataclass(JaxLabelTransformConfig, d)


def test_parse_offsets_matches_jax():
    assert paff.parse_offsets(OFFSETS) == jaff.parse_offsets(OFFSETS)
    assert paff.parse_offsets(["0--9-0", "-4-0-0", "0_1_-2"]) == [(0, -9, 0), (-4, 0, 0), (0, 1, -2)]
    for bad in ("0-1", "a-b-c", "1-2-3-4"):
        with pytest.raises(ValueError):
            paff.parse_offsets([bad])
    assert paff.max_offset_pad(OFFSETS) == jaff.max_offset_pad(OFFSETS) == (4, 9, 3)
    assert paff.affinity_channel_groups(OFFSETS) == jaff.affinity_channel_groups(OFFSETS)


@pytest.mark.parametrize("mode", ["deepem", "banis"])
def test_affinity_targets_and_masks_bit_identical_to_jax(mode):
    seg = _seg_with_unlabeled(1)
    for fn in ("seg_to_affinity", "affinity_unlabeled_mask"):
        got, want = getattr(paff, fn)(seg, OFFSETS, mode), getattr(jaff, fn)(seg, OFFSETS, mode)
        assert got.dtype == want.dtype and got.shape == (len(OFFSETS),) + seg.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        paff.affinity_valid_mask(seg.shape, OFFSETS, affinity_mode=mode),
        jaff.affinity_valid_mask(seg.shape, OFFSETS, affinity_mode=mode),
    )
    ours, ref = _label_cfgs(mode)
    for build in ("build_target_fn", "build_target_mask_fn"):
        got, want = getattr(pbuild, build)(ours)(seg[None]), getattr(jbuild, build)(ref)(seg[None])
        assert got.shape == want.shape == (1 + len(OFFSETS),) + seg.shape
        np.testing.assert_array_equal(got, want)
    assert pbuild.target_channel_spans(ours) == jbuild.target_channel_spans(ref)
    assert pbuild.affinity_target_groups(ours) == jbuild.affinity_target_groups(ref)


def test_pipeline_with_unlabeled_voxels_matches_jax(tmp_path):
    """Labels with -1 voxels: the batches carry the per-channel target mask
    (affinity edges with both ends labeled, binary voxels labeled),
    bit-identical to JAX's pipeline."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (14, 40, 36), dtype=np.uint8)
    seg = np.repeat(np.repeat(rng.integers(1, 9, (14, 8, 6)), 5, axis=1), 6, axis=2).astype(np.int32)
    seg[rng.random(seg.shape) < 0.05] = -1
    np.save(tmp_path / "im.npy", img)
    np.save(tmp_path / "lb.npy", seg)
    over = [f"data.train.image={tmp_path / 'im.npy'}", f"data.train.label={tmp_path / 'lb.npy'}",
            "data.dataloader.patch_size=[8,16,16]", "data.dataloader.batch_size=2",
            "data.label_transform.targets=[{name: binary}, {name: affinity, kwargs: {offsets: "
            "['0-0-1', '0-1-0', '1-0-0', '0--3-0', '-2-0-0'], affinity_mode: banis}}]"]
    cfg, jcfg = load_config(TUNE, overrides=over, mode="train"), jax_load_config(TUNE, overrides=over, mode="train")
    ours = PatchPipeline(build_dataset(cfg, cfg.data.train), 2, seed=1, target_cfg=cfg.data.label_transform)
    ref = JaxPatchPipeline(jax_build_dataset(jcfg, jcfg.data.train), 2, seed=1, target_cfg=jcfg.data.label_transform)
    for step in (0, 3):
        got, want = ours.make_batch(step), ref.make_batch(step)
        assert set(got) == set(want) == {"image", "label", "mask"}
        assert got["mask"].shape == (2, 8, 16, 16, 6) and 0 < got["mask"].mean() < 1
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    ours.close()


# ---------------------------------------------------------------------------
# (c) affinity-aware losses, one train step, validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["deepem", "banis"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_orchestrator_affinity_masks_match_jax(mode, masked):
    """BCE + Dice with the affinity groups of binary + affinity targets (a
    BCE term on the affinity channels only, a Dice term on all): the
    offset-validity masks reach each term as in JAX, f32 within 1e-6."""
    ours_lt, ref_lt = _label_cfgs(mode)
    over = ["model.out_channels=10",
            "model.loss.losses=[{function: BCEWithLogitsLoss, weight: 1.0, target_slice: '1:', pred_slice: '1:'},"
            " {function: DiceLoss, weight: 0.5}]"]
    cfg, jcfg = load_config(TUNE, overrides=over, mode="train"), jax_load_config(TUNE, overrides=over, mode="train")
    ours = LossOrchestrator(cfg.model.loss, affinity_groups=pbuild.affinity_target_groups(ours_lt))
    ref = JaxOrchestrator(jcfg.model.loss, affinity_groups=jbuild.affinity_target_groups(ref_lt))
    # one small volume (still longer than every offset): JAX sums the BCE
    # term in f32 in an order whose error grows with the element count (at
    # batch 2 it is 3.8e-6 off the f64 value, the port 2e-7)
    rng = np.random.default_rng(4)
    pred = (rng.standard_normal((1, 5, 11, 6, 10)) * 2).astype(np.float32)
    seg = _seg_with_unlabeled(3, (5, 11, 6))
    target = np.moveaxis(pbuild.build_target_fn(ours_lt)(seg), 0, -1)[None]
    mask = (rng.random((1, 5, 11, 6, 1)) > 0.2).astype(np.float32) if masked else None
    for term, jterm in zip(ours.terms, ref.terms):  # the masks themselves, bit for bit
        np.testing.assert_array_equal(ours._affinity_valid_mask(term, torch.from_numpy(target)).numpy(),
                                      np.asarray(ref._affinity_valid_mask(jterm, target)))
    got_total, got = ours(torch.from_numpy(pred), torch.from_numpy(target),
                          mask=None if mask is None else torch.from_numpy(mask))
    want_total, want = ref(pred, target, mask=mask)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=1e-6)
    # the masks do change the loss: the same terms without the groups differ
    plain, _ = LossOrchestrator(cfg.model.loss)(torch.from_numpy(pred), torch.from_numpy(target))
    assert abs(float(plain) - float(got_total)) > 1e-4


@pytest.fixture(scope="module")
def jax_affinity_step():
    """Loss and gradients of the JAX package's tiny 3-channel MedNeXt on
    one seeded batch of a synthetic instance volume with deepem affinity
    targets and its orchestrator's affinity groups."""
    cfg = jax_load_config(TUNE, overrides=TINY, mode="train")
    model = jax_build(cfg.model)
    # seeded weights of the init's shapes (tracing only: no init compile),
    # scaled as an init would: kernels by 1/sqrt(fan-in), norm scales near 1
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 16, 16, 16, 1), np.float32))

    def weight(path, a):
        z = rng.standard_normal(a.shape)
        name = str(path[-1])
        if "scale" in name:
            z = 1.0 + 0.1 * z
        elif "kernel" in name:
            z = z / np.sqrt(np.prod(a.shape[:-1]))
        else:
            z = 0.05 * z
        return z.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(weight, shapes["params"])
    orch = JaxOrchestrator(cfg.model.loss, affinity_groups=jbuild.affinity_target_groups(cfg.data.label_transform))
    img, seg = synthetic.synthetic_em_task("instance", (16, 16, 16), seed=9, cells=6)
    target_fn = jbuild.build_target_fn(cfg.data.label_transform)
    x = np.stack([img / np.float32(255.0), img[:, ::-1] / np.float32(255.0)])[..., None].astype(np.float32)
    y = np.stack([np.moveaxis(target_fn(s), 0, -1) for s in (seg, seg[:, ::-1])]).astype(np.float32)

    def loss_fn(p):
        return orch(model.apply({"params": p}, x), y)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(params=params, x=x, y=y, loss=float(loss), grads=jax.tree.map(np.asarray, grads))


def test_affinity_train_step_matches_jax(jax_affinity_step):
    """One train step of the tiny 3-channel MedNeXt on affinity targets:
    the loss (with the offset-validity masks) within 1e-5 relative, each
    gradient leaf within 1e-4 of its norm, as the binary train step test."""
    ref = jax_affinity_step
    cfg = load_config(TUNE, overrides=TINY, mode="train")
    model = build_model(cfg.model, device="cpu", seed=3)
    load_flax_params(model, ref["params"])
    orch = LossOrchestrator(cfg.model.loss, affinity_groups=pbuild.affinity_target_groups(cfg.data.label_transform))
    x, y = torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"])
    loss, _ = orch(model(x), y)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    want = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flax_to_state_dict(ref["grads"], model).items()}
    top = max(v.norm().item() for v in want.values())
    for name, p in model.named_parameters():
        g, w = p.grad, want[name]
        if name.endswith("conv_bias"):  # zero in exact arithmetic: GroupNorm follows the conv
            assert (g - w).abs().max().item() <= 1e-4 * top, name
        else:
            assert (g - w).norm().item() <= 1e-4 * w.norm().item(), name
    model.zero_grad(set_to_none=True)
    from pytorch_connectomics_tpu_torch.training.optim import build_optimizer

    opt, schedule = build_optimizer(cfg.optimization, model, cfg.optimization.n_steps_per_epoch)
    state = create_train_state(model, opt)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val)
    logs = step(state, {"image": x, "label": y})
    np.testing.assert_allclose(float(logs["loss_total"]), ref["loss"], rtol=1e-5)
    # the val step on the 3 affinity channels: the masked loss and the
    # binary metrics of every channel, as JAX's val step computes them
    val = make_val_step(orch)(state, {"image": x, "label": y})
    with torch.no_grad():
        out = model(x)
    assert val["val_loss"] == pytest.approx(float(orch(out, y)[0]), rel=1e-6)
    o = out.numpy()
    for k, fn in (("val_jaccard", jbinary.jaccard_index), ("val_dice", jbinary.dice_coefficient),
                  ("val_accuracy", jbinary.binary_accuracy)):
        assert val[k] == pytest.approx(float(fn(o, ref["y"])), abs=1e-6), k


# ---------------------------------------------------------------------------
# (d) native affinity ops and decoders
# ---------------------------------------------------------------------------


def affinity_prediction(seed=0, shape=(20, 40, 36), offsets=("0-0-1", "0-1-0", "1-0-0")):
    """Seeded affinity map of a synthetic instance volume: the true deepem
    affinities scaled into [0.1, 0.9], with noise, clipped into (0, 1)."""
    _, seg = synthetic.synthetic_em_task("instance", shape, seed=seed, cells=12)
    aff = paff.seg_to_affinity(seg, list(offsets))
    rng = np.random.default_rng(seed)
    aff = 0.1 + 0.8 * aff + 0.2 * rng.standard_normal(aff.shape)
    return np.clip(aff, 0.01, 0.99).astype(np.float32), seg


def test_native_affinity_ops_match_jax():
    aff, _ = affinity_prediction(1)
    for thr in (0.75, 0.9):
        got, want = native.affinity_connected_components(aff, thr), jnative.affinity_connected_components(aff, thr)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] > 1
    frags, _ = native.affinity_connected_components(aff, 0.9)
    got, want = native.agglomerate(frags, aff, 0.4), jnative.agglomerate(frags, aff, 0.4)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    thr = [0.7, 0.3, 0.5, 0.3]
    got, want = native.agglomerate_multi(frags, aff, thr), jnative.agglomerate_multi(frags, aff, thr)
    assert list(got) == list(want) == [0.7, 0.3, 0.5]
    for t in want:
        np.testing.assert_array_equal(got[t][0], want[t][0])
        assert got[t][1] == want[t][1]
    long_offsets = [(0, 0, 1), (0, 1, 0), (1, 0, 0), (0, -6, 0), (0, 0, -6), (-3, 0, 0)]
    laff, _ = affinity_prediction(2, offsets=long_offsets)
    got, want = native.mutex_watershed(laff, long_offsets), jnative.mutex_watershed(laff, long_offsets)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] > 1
    with pytest.raises(ValueError):
        native.affinity_connected_components(aff[:2])
    with pytest.raises(ValueError):
        native.agglomerate(frags[:-1], aff)
    with pytest.raises(ValueError):
        native.mutex_watershed(laff, long_offsets[:3])


@pytest.mark.parametrize("name, kwargs", [
    ("affinity_cc", {"threshold": 0.75}),
    ("affinity_cc", {"threshold": 0.85, "min_size": 30}),
    ("waterz", {"threshold": 0.5, "fragment_threshold": 0.5, "min_size": 20}),
    ("waterz", {"threshold": 0.3, "fragments": "cc", "fragment_threshold": 0.95}),
    ("waterz", {"thresholds": [0.2, 0.5, 0.8], "return_all_thresholds": True, "min_size": 10}),
    ("mutex_watershed", {"offsets": ["0-0-1", "0-1-0", "1-0-0", "0--6-0", "0-0--6", "-3-0-0"], "min_size": 5}),
], ids=["affinity_cc", "affinity_cc-min_size", "waterz-watershed", "waterz-cc", "waterz-batch", "mutex"])
def test_affinity_decoders_match_jax(name, kwargs):
    offsets = kwargs.get("offsets", ("0-0-1", "0-1-0", "1-0-0"))
    pred, _ = affinity_prediction(3, offsets=offsets)
    got, want = getattr(pdec, f"decode_{name}")(pred, **kwargs), getattr(jdec, f"decode_{name}")(pred, **kwargs)
    if isinstance(want, dict):
        assert list(got) == list(want) == [0.2, 0.5, 0.8]
        pairs = [(got[t], want[t]) for t in want]
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        assert g.dtype == w.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
    assert max(len(np.unique(w)) for _, w in pairs) > 2


def test_decoding_stage_runs_waterz_as_jax():
    """The tune recipe's waterz step through both packages' decoding stage,
    on a channel-last prediction as inference returns it."""
    pred, _ = affinity_prediction(4)
    cfg, jcfg = load_config(TUNE, mode="test"), jax_load_config(TUNE, mode="test")
    got = run_decoding_stage(np.moveaxis(pred, 0, -1), cfg.decoding)
    np.testing.assert_array_equal(got, jax_run_decoding_stage(np.moveaxis(pred, 0, -1), jcfg.decoding))


# ---------------------------------------------------------------------------
# synthetic_instance.yaml through the CLI: train with val, then test
# ---------------------------------------------------------------------------


def test_cli_synthetic_instance_trains_with_val_then_tests(tmp_path):
    """The tutorial cut to a tiny model and volumes: --mode train (2 steps,
    validation on its 3 affinity channels) writes a checkpoint that --mode
    test restores, predicts 3 channels, decodes with waterz and scores."""
    over = ["--device", "cpu", *TINY, f"save_path={tmp_path}", "data.dataloader.patch_size=[16,16,16]",
            "inference.window.window_size=[16,16,16]", "inference.window.sw_batch_size=4"]
    vols = {
        split: [f"data.{split}.image=synthetic://instance/{split}_image?shape={shape}&seed={seed}",
                f"data.{split}.label=synthetic://instance/{split}_label?shape={shape}&seed={seed}"]
        for split, shape, seed in (("train", "16,40,40", 11), ("val", "16,32,32", 12), ("test", "16,40,36", 13))
    }
    res = main(["--config", INSTANCE, "--mode", "train", *over, *vols["train"], *vols["val"],
                "optimization.n_steps_per_epoch=2", "optimization.limit_val_batches=1"])
    m = res["metrics"]
    assert np.isfinite(m["val_loss"]) and 0 <= m["val_jaccard"] <= 1 and "loss_DiceLoss_1" in m
    test = main(["--config", INSTANCE, "--mode", "test", *over, *vols["test"]])
    assert test["restored"]["checkpoint"] == res["checkpoint"]
    scores = test["metrics"]["synthetic"]
    assert {"adapted_rand", "voi", "voi_split", "voi_merge"} <= set(scores)
    run = tmp_path.glob("*/test/synthetic_last_prediction.h5")
    assert read_volume(str(next(run))).shape == (3, 16, 40, 36)
