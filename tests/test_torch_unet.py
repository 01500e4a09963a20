"""The port's MONAI U-Net family against the JAX package on the CPU: the
three models (``BasicUNet3D``, ``UNet3D``, ``UNETR``) on weights carried over
by ``models/convert.py``, ``random://`` volumes, the ``synthetic://blobs``
transform on JAX's draws, the plain emulation of the Cin-chunked conv sum,
and the weight gradient's column blocks past Cout 128.

Model tolerances, relative to max |reference|: f32 1e-5 (sums in another
order; UNETR 5e-5: each layer's softmax and two layer norms sum in another
order too); bf16 3e-2 (the frameworks round at other places, and a rounding
flip early in the net travels through every later layer), as for RSUNet.
The CLI legs are in ``tests/test_torch_unet_cli.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.data.io import synthetic_volume as jax_random_volume
from pytorch_connectomics_tpu.data.synthetic_jax import synthetic_blob_instance_volume as jax_blobs
from pytorch_connectomics_tpu.models.unet3d import UNETR as JaxUNETR
from pytorch_connectomics_tpu.models.unet3d import BasicUNet3D as JaxBasicUNet3D
from pytorch_connectomics_tpu.models.unet3d import UNet3D as JaxUNet3D
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.data import io, synthetic
from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import flatten_flax, flax_to_state_dict, load_flax_params
from pytorch_connectomics_tpu_torch.models.unet3d import UNETR, BasicUNet3D, UNet3D
from pytorch_connectomics_tpu_torch.ops import conv3d as c3

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
MINIMAL = "tutorials/minimal.yaml"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch operations: one thread each under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parity(jax_model, port_model, shape, seed=0):
    """Seeded random flax params (shapes from ``eval_shape``, so no eager
    init), JAX's output, and the port's output on them; every flax leaf
    maps to one port parameter. Returns (max error / max |JAX|, shapes)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 1)

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0
        scale = 1.0 / np.sqrt(fan_in) if fan_in else 0.1
        base = 1.0 if len(s.shape) == 1 else 0.0
        return (base + scale * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree.map(leaf, shapes)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    assert len(flax_to_state_dict(params, port_model)) == len(flatten_flax(params))
    load_flax_params(port_model, params)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_basic_unet_matches_flax(dtype):
    f = (8, 8, 16, 32, 64, 8)
    err = _parity(JaxBasicUNet3D(features=f, dtype=jnp.dtype(dtype)), BasicUNet3D(features=f, dtype=getattr(torch, dtype)),
                  (1, 16, 16, 16, 1))
    assert err <= TOL[dtype], err


# (num_res_units, strides, up_kernel_size): one and two residual units, an
# anisotropic first level, kernel 3 transposed convs (flax pads (2, 1), no
# flip) and kernel 2 (the stride)
UNET_CASES = [(1, None, 3), (2, [(1, 2, 2), (2, 2, 2)], 3), (1, None, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", UNET_CASES, ids=["res1", "res2-aniso", "up2"])
def test_unet_matches_flax(case, dtype):
    nr, strides, uk = case
    kw = dict(channels=(8, 16, 32), num_res_units=nr, strides=strides, up_kernel_size=uk)
    err = _parity(JaxUNet3D(dtype=jnp.dtype(dtype), **kw), UNet3D(dtype=getattr(torch, dtype), **kw), (1, 8, 16, 16, 1))
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unetr_matches_flax(dtype):
    """Four layers (JAX's decoder needs four taps) of hidden 32, patch 16
    (its decoder upsamples the patch grid 16x) on a 32^3 input."""
    kw = dict(hidden_size=32, mlp_dim=64, num_heads=2, num_layers=4, feature_size=4, patch_size=(16, 16, 16))
    err = _parity(JaxUNETR(dtype=jnp.dtype(dtype), **kw), UNETR(img_size=(32, 32, 32), dtype=getattr(torch, dtype), **kw),
                  (1, 32, 32, 32, 1))
    assert err <= (5e-5 if dtype == "float32" else TOL[dtype]), err


def test_registry_names_build_the_three_models():
    """JAX's architecture names build the three models from the schema's
    knobs; the flax defaults (BasicUNet's stock widths, UNETR's 384-wide ViT)."""
    for arch, cls in (("monai_unet", UNet3D), ("monai_basic_unet", BasicUNet3D), ("monai_unetr", UNETR)):
        cfg = load_config(MINIMAL, overrides=[f"model.arch.type={arch}", "model.input_size=[32,32,32]"])
        m = build_model(cfg.model, device="cpu")
        assert isinstance(m, cls) and not m.training
    assert [b.c1.conv.weight.shape[0] for b in BasicUNet3D().enc] == [32, 32, 64, 128, 256]
    r = UNETR()
    assert r.pos_embed.shape == (1, 216, 384) and len(r.layers) == 8 and r.proj[0].conv.weight.shape == (128, 384, 3, 3, 3)


@pytest.mark.parametrize("name,shape", [("minimal/train_image", (20, 24, 28)), ("minimal/train_label", (20, 24, 28)),
                                        ("demo/val_im", (9, 8, 13)), ("demo/val_seg", (9, 8, 13))])
def test_random_volumes_equal_jax(name, shape):
    """``random://`` volumes bit for bit: one crc32-seeded field for the
    image and label of a name, uint8 images, uint32 connected components."""
    want = jax_random_volume(name, shape)
    got = read_volume(f"random://{name}?shape={','.join(map(str, shape))}")
    assert got.dtype == want.dtype and got.shape == shape
    np.testing.assert_array_equal(got, want)
    assert io.parse_random_url("random://a/b") == ("a/b", (64, 128, 128))


def test_blob_transform_matches_jax_on_jax_draws():
    """The port's blob transform fed the draws of JAX's own keys gives JAX's
    volume: labels identical (the same f32 distances in the same order),
    image and distance within 1e-5."""
    shape, n = (12, 40, 36), 7
    key = jax.random.PRNGKey(5)
    ks = jax.random.split(key, 10)
    # key index of each draw in synthetic_jax.py:237-318
    slot = {"warp_z": 0, "warp_y": 1, "warp_x": 2, "tex": 6, "shade": 7, "clutter": 8}
    d = {k: jax.random.normal(ks[slot[k]], synthetic.low_shape(shape, fv)) for k, fv in synthetic._BLOB_FIELDS.items()}
    d["seeds"] = jax.random.uniform(ks[3], (n, 3))
    d["radii"] = jax.random.uniform(ks[4], (n,))
    d["aniso"] = jax.random.uniform(ks[5], (n, 3))
    d["slice_gain"] = jax.random.normal(ks[9], (shape[0], 1, 1))
    d["noise"] = jax.random.normal(jax.random.fold_in(key, 7), shape)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    want_img, want_lbl, want_dist = jax_blobs(key, shape, n_blobs=n)
    img, lbl, dist = synthetic.synthetic_blob_volume(draws, shape)
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(want_lbl))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist), rtol=0, atol=1e-5)
    assert len(np.unique(lbl.numpy())) > 2


def test_blob_url_reads_image_and_label_of_one_draw():
    url = "synthetic://blobs/t_{}?shape=8,24,20&seed=3"
    img, lbl = read_volume(url.format("image")), read_volume(url.format("label"))
    assert img.dtype == np.uint8 and lbl.dtype == np.uint32 and img.shape == lbl.shape == (8, 24, 20)
    assert lbl.max() >= 1 and img[lbl > 0].mean() < img[lbl == 0].mean()  # dark blobs on bright cytoplasm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,chunk", [(256, 128), (384, 192), (193, 104)])
def test_chunked_sum_is_one_rounding_of_the_f32_sum(cin, chunk, dtype):
    """The Cin-chunked kernel's arithmetic (f32 sums per chunk added in
    order, one rounding, then the bias) against the plain version's single
    sum: f32 within 1e-5 of the summed magnitudes, bf16 within one ulp of
    the output's largest magnitude (two f32 sums of one set of products
    round to neighbouring values at most); rounding each chunk instead would
    be a second rounding."""
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((1, 2, 3, 4, cin), dtype=np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((24, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    got = c3.conv3d_3x3_chunked_plain(x, w, b, chunk)
    want = c3.conv3d_3x3_plain(x, w, b)
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        mag = c3.conv3d_3x3_plain(x.abs(), w.abs()) + b.abs()
        assert torch.all((got - want).abs() <= 1e-5 * mag)
    else:
        ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
        assert (got.float() - want.float()).abs().max().item() <= ulp
        # one chunk is the plain version itself
        assert torch.equal(c3.conv3d_3x3_chunked_plain(x, w, b, cin), want)


def test_wgrad_column_blocks_past_cout_128():
    """BasicUNet's bottleneck (Cout 256) splits Cout into two 128-column
    blocks, items of their own; the decomposition follows from the shape
    and plan alone (no grid), every (row, column) of dW is one partial cell."""
    for shape, plan in (((8, 1, 8, 8, 256), dict(xs=16, r=4, m_tiles=1, tap_groups=3)),
                        ((8, 1, 8, 8, 128), dict(xs=16, r=8, m_tiles=1, tap_groups=1))):
        geo = c3.wgrad_geometry(shape, 256, plan)
        assert geo["slices"] == 2 and geo["n"] == 128
        assert geo["items"] == geo["chunks"] * plan["tap_groups"] * geo["row_groups"] * 2
        assert geo["partial_floats"] == geo["chunks"] * geo["rows_per_chunk"] * 256
        assert geo["rows_per_block"] >= 27 // plan["tap_groups"] * shape[-1]
