"""RSUNet training in the port against the JAX package on the CPU: the dense
3^3 conv's backward (``Conv3x3Function``: dx, dW, db) against ``jax.vjp`` of
flax's ``nn.Conv``, and gradcheck of the plain versions in f64; the new
targets (``instance_boundary``, ``instance_edt``, erosion) and losses
(``PerChannelBCEWithLogitsLoss`` with auto pos weight, ``WeightedMSELoss``
with tanh, ``pos_weight: auto``); and one RSUNet train step of the SNEMI
recipe (aff9 with erosion, per-channel BCE) and of the NucMM-Z recipe (bcd,
``pos_weight: auto``, tanh MSE) against JAX's ``make_train_step`` on the
same flax weights and batch. Every tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.data.targets import build as jbuild
from pytorch_connectomics_tpu.data.targets import distance as jdist
from pytorch_connectomics_tpu.losses import zoo as jzoo
from pytorch_connectomics_tpu.losses.orchestrator import LossOrchestrator as JaxOrchestrator
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.training.optim import build_optimizer as jax_build_optimizer
from pytorch_connectomics_tpu.training.state import create_train_state as jax_create_train_state
from pytorch_connectomics_tpu.training.state import make_train_step as jax_make_train_step
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.data import synthetic
from pytorch_connectomics_tpu_torch.data.targets import build as pbuild
from pytorch_connectomics_tpu_torch.data.targets import distance as pdist
from pytorch_connectomics_tpu_torch.losses import LossOrchestrator, get_loss
from pytorch_connectomics_tpu_torch.losses import zoo
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import flax_to_state_dict, load_flax_params
from pytorch_connectomics_tpu_torch.ops import conv3d as c3
from pytorch_connectomics_tpu_torch.training.optim import build_optimizer
from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_train_step

SNEMI = "tutorials/neuron_snemi.yaml"
NUCMM = "tutorials/nuc_nucmm.yaml"
TINY_SNEMI = [
    "model.rsunet.width=[8,12,16]",
    "model.rsunet.down_factors=[[1,2,2],[1,2,2]]",
    "optimization.precision=32",
    "model.input_size=[8,24,24]",
]
TINY_NUCMM = ["model.rsunet.width=[8,12]", "optimization.precision=32", "model.input_size=[16,16,16]"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch operations: one intra-op thread under the parallel
    test run, as the other instance-chain tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulps(a, n=2):
    return n * 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


# ---------------------------------------------------------------------------
# the conv's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", [((2, 4, 6, 10, 12), 20), ((1, 5, 7, 9, 1), 8), ((1, 3, 4, 16, 36), 28)],
                         ids=["12-20", "stem", "36-28"])
def test_conv3x3_function_matches_jax_vjp(shape, cout, dtype):
    """dx, dW and db of ``Conv3x3Function`` (the plain versions on the CPU)
    against ``jax.vjp`` of flax's ``nn.Conv(cout, (3, 3, 3))`` in ``dtype``
    on the same weights and cotangent. f32: 1e-5 of the summed magnitudes
    (sums in another order). bf16: dx two bf16 ulps at its largest
    magnitude (both round one f32 sum); dW 2^-8 of the value plus 1e-5 of
    the summed magnitudes (JAX rounds the gradient of the cast kernel to
    bf16, the port keeps f32); db is the f32 sum of the bf16 cotangent
    (1e-6 relative), from which JAX's, summed in bf16 on the CPU, is within
    2^-7 of the summed magnitudes."""
    rng = np.random.default_rng(sum(shape) + cout)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    g = rng.standard_normal((*shape[:4], cout)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    conv = nn.Conv(cout, (3, 3, 3), padding="SAME", dtype=jdt)

    def f(xx, kk, bb):
        return conv.apply({"params": {"kernel": kk, "bias": bb}}, xx)

    xj = jnp.asarray(x, jdt)
    out, vjp = jax.vjp(f, xj, jnp.asarray(k), jnp.asarray(b))
    jdx, jdk, jdb = (np.asarray(v.astype(jnp.float32)) for v in vjp(jnp.asarray(g, out.dtype)))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2))).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = c3.Conv3x3Function.apply(xt, w, bt)
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(out.astype(jnp.float32)),
                               atol=1e-5 if dtype == "float32" else _bf16_ulps(np.asarray(out.astype(jnp.float32))))
    y.backward(torch.from_numpy(g).to(tdt))
    dx = xt.grad.float().numpy()
    dk = w.grad.numpy().transpose(2, 3, 4, 1, 0)
    db = bt.grad.numpy()
    xa, ga = torch.from_numpy(np.abs(x)), torch.from_numpy(np.abs(g))
    mag_dx = c3.conv3d_3x3_input_grad_plain(ga, torch.from_numpy(np.abs(k)), layout="dhwio").numpy()
    mag_dk = c3.conv3d_3x3_wgrad_plain(xa, ga).numpy().transpose(2, 3, 4, 1, 0)
    mag_db = np.abs(g).sum((0, 1, 2, 3))
    if dtype == "float32":
        assert np.all(np.abs(dx - jdx) <= 1e-5 * mag_dx + 1e-30)
        assert np.all(np.abs(dk - jdk) <= 1e-5 * mag_dk + 1e-30)
        assert np.all(np.abs(db - jdb) <= 1e-5 * mag_db)
    else:
        assert np.abs(dx - jdx).max() <= _bf16_ulps(jdx), (np.abs(dx - jdx).max(), _bf16_ulps(jdx))
        assert np.all(np.abs(dk - jdk) <= 2.0 ** -8 * np.abs(jdk) + 1e-5 * mag_dk + 1e-30)
        exact = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32)).sum((0, 1, 2, 3), dtype=np.float64)
        np.testing.assert_allclose(db, exact, rtol=1e-6, atol=1e-6 * mag_db.max())
        assert np.all(np.abs(jdb - exact) <= 2.0 ** -7 * mag_db)


@pytest.mark.parametrize("shape,cout,x_grad", [((2, 3, 4, 5, 3), 4, True), ((1, 2, 3, 4, 1), 3, False)],
                         ids=["3-4", "stem"])
def test_conv3x3_gradcheck_f64(shape, cout, x_grad):
    """``torch.autograd.gradcheck`` in f64 of ``Conv3x3Function``, whose
    backward runs ``conv3d_3x3_input_grad_plain`` (skipped for the stem's
    data input) and ``conv3d_3x3_wgrad_plain``."""
    g = torch.Generator().manual_seed(shape[-1] + cout)
    x = torch.randn(shape, dtype=torch.float64, generator=g).requires_grad_(x_grad)
    w = torch.randn((cout, shape[-1], 3, 3, 3), dtype=torch.float64, generator=g).requires_grad_(True)
    b = torch.randn(cout, dtype=torch.float64, generator=g).requires_grad_(True)
    assert torch.autograd.gradcheck(c3.Conv3x3Function.apply, (x, w, b))
    assert torch.autograd.gradcheck(lambda xx, ww: c3.conv3d_3x3(xx, ww, layout="dhwio"),
                                    (x, w.detach().permute(2, 3, 4, 1, 0).contiguous().requires_grad_(True)))


def test_conv3d_backward_plain_versions_match_autograd():
    """The two plain backward functions equal autograd through the plain
    forward in f64 (to 1e-12)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 5, 4, 6), dtype=torch.float64, generator=g).requires_grad_(True)
    w = torch.randn((7, 6, 3, 3, 3), dtype=torch.float64, generator=g).requires_grad_(True)
    dy = torch.randn((2, 3, 5, 4, 7), dtype=torch.float64, generator=g)
    c3.conv3d_3x3_plain(x, w).backward(dy)
    torch.testing.assert_close(c3.conv3d_3x3_input_grad_plain(dy, w.detach()), x.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(c3.conv3d_3x3_wgrad_plain(x.detach(), dy), w.grad, rtol=1e-12, atol=1e-12)
    assert torch.equal(c3.mirror_weight(w.detach())[:, :, 0, 0, 0], w.detach()[:, :, 2, 2, 2].t())


# ---------------------------------------------------------------------------
# targets and erosion
# ---------------------------------------------------------------------------


def _seg(seed=4, shape=(10, 24, 20), cells=9):
    return synthetic.synthetic_em_task("instance", shape, seed=seed, cells=cells)[1]


@pytest.mark.parametrize("edge_mode", [None, "all", "seg-all", "seg-no-bg"])
@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("mode", ["3d", "2d"])
def test_instance_boundary_matches_jax(mode, thickness, edge_mode):
    seg = _seg()
    seg[:, :3] = 0  # some background
    np.testing.assert_array_equal(pdist.instance_boundary_mask(seg, thickness, mode, edge_mode),
                                  jdist.instance_boundary_mask(seg, thickness, mode, edge_mode))


@pytest.mark.parametrize("iterations", [0, 1, 2])
def test_erode_instances_matches_jax(iterations):
    seg = _seg(5)
    np.testing.assert_array_equal(pdist.erode_instances(seg, iterations), jdist.erode_instances(seg, iterations))
    np.testing.assert_array_equal(pdist.erode_instances(seg[None], iterations),
                                  jdist.erode_instances(seg[None], iterations))


@pytest.mark.parametrize("mode", ["3d", "2d"])
def test_instance_edt_matches_jax(mode):
    seg = _seg(6)
    seg[2:4] = 0
    for kw in ({}, dict(normalize=False, bg_value=-1.0), dict(sampling=(2.0, 1.0, 1.0))):
        np.testing.assert_array_equal(pdist.instance_edt(seg, mode=mode, **kw), jdist.instance_edt(seg, mode=mode, **kw))


@pytest.mark.parametrize("recipe,overrides", [(SNEMI, TINY_SNEMI), (NUCMM, TINY_NUCMM)], ids=["aff9", "bcd"])
def test_recipe_targets_match_jax(recipe, overrides):
    """The recipes' label transforms (aff9 with erosion 1; bcd: binary,
    instance boundary in 2-D, instance EDT in 2-D): targets, channel spans
    and affinity groups bit-equal to JAX's."""
    lt = load_config(recipe, overrides=overrides, mode="train").data.label_transform
    jlt = jax_load_config(recipe, overrides=overrides, mode="train").data.label_transform
    seg = _seg(7, (12, 30, 26), 11)
    got, want = pbuild.build_target_fn(lt)(seg), jbuild.build_target_fn(jlt)(seg)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == ((9 if recipe == SNEMI else 3), *seg.shape)
    np.testing.assert_array_equal(got, want)
    assert pbuild.target_channel_spans(lt) == jbuild.target_channel_spans(jlt)
    assert pbuild.affinity_target_groups(lt) == jbuild.affinity_target_groups(jlt)
    if recipe == SNEMI:  # erosion took effect: fewer positive affinities than on the raw labels
        lt.erosion = 0
        assert pbuild.build_target_fn(lt)(seg).sum() > got.sum()


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _pred_target(seed=0, shape=(2, 4, 6, 5, 3)):
    rng = np.random.default_rng(seed)
    pred = (rng.standard_normal(shape) * 2).astype(np.float32)
    target = (rng.random(shape) > 0.8).astype(np.float32)
    mask = (rng.random(shape) > 0.3).astype(np.float32)
    weight = rng.random(shape[:-1] + (1,)).astype(np.float32)
    return pred, target, mask, weight


@pytest.mark.parametrize("name,kw", [("PerChannelBCEWithLogitsLoss", dict(auto_pos_weight=True)),
                                     ("PerChannelBCE", dict(auto_pos_weight_flag=False)),
                                     ("WeightedMSELoss", dict(tanh=True)), ("MSELoss", {})], ids=lambda v: str(v))
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask+weight"])
def test_new_losses_match_jax(name, kw, masked):
    pred, target, mask, weight = _pred_target(1)
    if name.endswith("MSELoss"):
        target = np.tanh(target * 2 - 1)
    extra = dict(mask=mask, weight=weight) if masked else {}
    want = float(jzoo.get_loss(name)(jnp.asarray(pred), jnp.asarray(target), **kw,
                                     **{k: jnp.asarray(v) for k, v in extra.items()}))
    got = get_loss(name)(torch.from_numpy(pred), torch.from_numpy(target), **kw,
                         **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_auto_pos_weight_matches_jax(masked):
    _, target, mask, _ = _pred_target(2)
    m = mask if masked else None
    want = float(jzoo.auto_pos_weight(jnp.asarray(target), None if m is None else jnp.asarray(m)))
    got = zoo.auto_pos_weight(torch.from_numpy(target), None if m is None else torch.from_numpy(m))
    assert float(got) == pytest.approx(want, rel=1e-7) and 1.0 <= want <= 100.0
    assert float(zoo.auto_pos_weight(torch.ones(4, 4))) == 1.0  # clipped below at 1
    assert float(zoo.auto_pos_weight(torch.zeros(1000))) == 100.0  # and above at 100


@pytest.mark.parametrize("recipe", [SNEMI, NUCMM], ids=["per_channel", "bcd"])
def test_recipe_orchestrator_matches_jax(recipe):
    """The recipes' loss profiles through both orchestrators: loss_per_channel
    with the aff9 groups' offset masks, loss_bcd with ``pos_weight: auto``
    on its boundary term and tanh MSE on the distance channel; every term
    within 1e-6 relative."""
    over = TINY_SNEMI if recipe == SNEMI else TINY_NUCMM
    cfg, jcfg = load_config(recipe, overrides=over, mode="train"), jax_load_config(recipe, overrides=over, mode="train")
    c = 9 if recipe == SNEMI else 3
    pred, target, _, _ = _pred_target(3, (2, 6, 12, 10, c))
    if recipe == NUCMM:
        target[..., 2] = np.tanh(pred[..., 2] * 0.3)  # a distance channel in [-1, 1]
    orch = LossOrchestrator(cfg.model.loss, affinity_groups=pbuild.affinity_target_groups(cfg.data.label_transform))
    jorch = JaxOrchestrator(jcfg.model.loss, affinity_groups=jbuild.affinity_target_groups(jcfg.data.label_transform))
    total, logs = orch(torch.from_numpy(pred), torch.from_numpy(target))
    jtotal, jlogs = jorch(jnp.asarray(pred), jnp.asarray(target))
    assert set(logs) == set(jlogs) and len(logs) == (2 if recipe == SNEMI else 6)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-6, err_msg=k)
    if recipe == NUCMM:
        assert orch.terms[2].auto_pos and not orch.terms[0].auto_pos


# ---------------------------------------------------------------------------
# one train step against JAX's make_train_step
# ---------------------------------------------------------------------------


def _jax_params(model, shape, seed):
    """Seeded weights of the init's shapes (no init compile), scaled as an
    init would: kernels by 1/sqrt(fan-in), norm scales near 1, small biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct(shape, np.float32))

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

    return jax.tree_util.tree_map_with_path(weight, shapes["params"])


def _batch(recipe, cfg, jcfg, n=2):
    """A seeded batch of the recipe's patch from a synthetic instance volume
    and its targets, the same for both packages (asserted bit-equal)."""
    zyx = tuple(cfg.model.input_size)
    img, seg = synthetic.synthetic_em_task("instance", (zyx[0] + 2, zyx[1] + 8, zyx[2] + 8), seed=9, cells=8)
    crops = [(slice(0, zyx[0]), slice(0, zyx[1]), slice(0, zyx[2])),
             (slice(2, 2 + zyx[0]), slice(8, 8 + zyx[1]), slice(8, 8 + zyx[2]))][:n]
    x = np.stack([img[c] / np.float32(255.0) for c in crops])[..., None].astype(np.float32)
    t, jt_ = pbuild.build_target_fn(cfg.data.label_transform), jbuild.build_target_fn(jcfg.data.label_transform)
    y = np.stack([np.moveaxis(t(seg[c]), 0, -1) for c in crops]).astype(np.float32)
    np.testing.assert_array_equal(y, np.stack([np.moveaxis(jt_(seg[c]), 0, -1) for c in crops]))
    return x, y


@pytest.fixture(scope="module", params=["snemi", "nucmm"])
def jax_rsunet_step(request):
    """Two steps of JAX's jitted ``make_train_step`` on a tiny f32 RSUNet of
    the recipe from seeded weights: the first step's loss logs, gradients
    and updated parameters, and the second step's loss."""
    recipe, over = (SNEMI, TINY_SNEMI) if request.param == "snemi" else (NUCMM, TINY_NUCMM)
    jcfg = jax_load_config(recipe, overrides=over, mode="train")
    cfg = load_config(recipe, overrides=over, mode="train")
    model = jax_build(jcfg.model)
    x, y = _batch(recipe, cfg, jcfg)
    params = _jax_params(model, (1, *x.shape[1:]), seed=1)
    orch = JaxOrchestrator(jcfg.model.loss, affinity_groups=jbuild.affinity_target_groups(jcfg.data.label_transform))

    def loss_fn(p):
        return orch(model.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))[0]

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))
    tx, _ = jax_build_optimizer(jcfg.optimization, jcfg.optimization.n_steps_per_epoch)
    state = jax_create_train_state(params, tx)
    step = jax.jit(jax_make_train_step(model.apply, orch, tx))
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    state, logs1 = step(state, batch)
    params1 = jax.tree.map(np.asarray, state.params["model"])
    _, logs2 = step(state, batch)
    return dict(recipe=recipe, over=over, x=x, y=y, params=params, grads=grads, params1=params1,
                logs1={k: float(v) for k, v in logs1.items()}, loss2=float(logs2["loss_total"]))


def test_rsunet_train_step_matches_jax(jax_rsunet_step):
    """One port train step of the tiny f32 RSUNet, the 3^3 convs through
    ``Conv3x3Function``, against JAX's: every loss log within 1e-5
    relative; each gradient leaf within 1e-4 of its norm (the convs' biases,
    whose gradients GroupNorm all but cancels, within 1e-4 of the largest
    leaf norm); the gradient norm within 1e-4; the updated parameters within
    1e-7 absolute plus 1e-3 of the step's largest update of the leaf, except
    that an element whose JAX gradient is within that noise level (1e-4 of
    the largest leaf norm) may move by up to lr either way in each package
    (AdamW's first step is lr * g / (|g| + eps)), so within 2 lr; and the
    second step's loss within 1e-4."""
    ref = jax_rsunet_step
    cfg = load_config(ref["recipe"], overrides=ref["over"], mode="train")
    model = build_model(cfg.model, device="cpu", seed=3)
    load_flax_params(model, ref["params"])
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    orch = LossOrchestrator(cfg.model.loss, affinity_groups=pbuild.affinity_target_groups(cfg.data.label_transform))
    x, y = torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"])
    loss, _ = orch(model(x), y)
    loss.backward()
    want = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flax_to_state_dict(ref["grads"], model).items()}
    top = max(v.norm().item() for v in want.values())
    conv_bias = [n for n, m in model.named_modules() if isinstance(m, type(model.stem.conv))]
    conv_bias = {f"{n}.bias" for n in conv_bias}
    for name, p in model.named_parameters():
        g, w = p.grad, want[name]
        if name in conv_bias:
            assert (g - w).abs().max().item() <= 1e-4 * top, name
        else:
            assert (g - w).norm().item() <= 1e-4 * w.norm().item(), (name, (g - w).norm().item(), w.norm().item())
    model.zero_grad(set_to_none=True)
    opt, schedule = build_optimizer(cfg.optimization, model, cfg.optimization.n_steps_per_epoch)
    state = create_train_state(model, opt)
    step = make_train_step(orch, schedule, gradient_clip=cfg.optimization.gradient_clip_val)
    logs1 = step(state, {"image": x, "label": y})
    for k, v in ref["logs1"].items():
        np.testing.assert_allclose(float(logs1[k]), v, rtol=1e-5 if k != "grad_norm" else 1e-4, err_msg=k)
    lr0 = schedule(0)
    p1 = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flax_to_state_dict(ref["params1"], model).items()}
    for name, p in model.named_parameters():
        d = (p.detach() - p1[name]).abs()
        limit = 1e-7 + 1e-3 * (p1[name] - p0[name]).abs().max().item()
        limit = torch.where(want[name].abs() <= 1e-4 * top, torch.full_like(d, 2.01 * lr0), torch.full_like(d, limit))
        assert torch.all(d <= limit), (name, d.max().item(), (d > limit).sum().item())
    logs2 = step(state, {"image": x, "label": y})
    np.testing.assert_allclose(float(logs2["loss_total"]), ref["loss2"], rtol=1e-4)


@pytest.mark.parametrize("recipe,overrides", [(SNEMI, TINY_SNEMI), (NUCMM, TINY_NUCMM)], ids=["snemi", "nucmm"])
def test_rsunet_kernel_route_matches_plain_and_trains(recipe, overrides):
    """Under grad the RSUNet's 3^3 convs run ``Conv3x3Function``; on the
    CPU its plain backward gives the loss and every gradient of autograd
    through ``plain=True`` (to 1e-6 of each leaf's norm, f32), and every
    parameter gets one. The stem's input gets no gradient."""
    cfg = load_config(recipe, overrides=overrides, mode="train")
    model = build_model(cfg.model, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).random((2, *cfg.model.input_size, 1), dtype=np.float32))
    grads = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        out = model(x, plain=plain)
        (out.square().mean()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert (g - grads[1][n]).norm().item() <= 1e-6 * max(grads[1][n].norm().item(), 1e-12), n
    assert len(grads[0]) == len(list(model.parameters()))
