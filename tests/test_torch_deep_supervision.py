"""Deep supervision in the port against the JAX package on the CPU: the loss
orchestrator's multi-scale loss (default weights 1/2^(k+1), configured
``ds_weights``, ``ds_clamp``, a mask, per-head terms left out of the ds
scales) on seeded outputs, RSUNet's and MedNeXt's ``ds_head_i`` against
flax, and the validation step's metrics on ``out``.

Tolerances: losses rtol 1e-5; models f32 1e-5 * max|ref| (RSUNet) and rtol
1e-4, atol 1e-4 * max|ref| (MedNeXt); bf16 3e-2 * max|ref| (RSUNet, the
frameworks round at other places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.config.schema import LossConfig as JaxLossConfig
from pytorch_connectomics_tpu.config.schema import build_dataclass as jax_build_dataclass
from pytorch_connectomics_tpu.losses.orchestrator import LossOrchestrator as JaxOrchestrator
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.models.rsunet import RSUNet as JaxRSUNet
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.config.schema import LossConfig, build_dataclass
from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import load_flax_params
from pytorch_connectomics_tpu_torch.models.rsunet import RSUNet
from pytorch_connectomics_tpu_torch.training.state import create_train_state, make_val_step
from test_torch_multitask import _jax_params

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"

TERMS = [{"function": "DiceLoss", "kwargs": {"sigmoid": True}},
         {"function": "WeightedBCEWithLogitsLoss", "weight": 0.5, "pred_slice": "0:2", "target_slice": "0:2"}]
HEAD_TERMS = [{"function": "WeightedBCEWithLogitsLoss", "head": "aff", "target_slice": "0:2"},
              {"function": "DiceLoss", "kwargs": {"sigmoid": True}, "head": "sdt", "target_slice": "2:3"}]
# (terms, ds_weights, ds_clamp, mask, heads)
CASES = {
    "default": (TERMS, None, None, False, False),
    "weights": (TERMS, [0.7, 0.2, 0.05], None, False, False),
    "clamp": (TERMS, None, 0.4, False, False),
    "mask": (TERMS, [1.0], None, True, False),
    "heads": (HEAD_TERMS, None, None, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_deep_supervision_loss_matches_jax(case):
    terms, weights, clamp, masked, heads = CASES[case]
    loss = {"losses": terms, "deep_supervision": True, "ds_weights": weights, "ds_clamp": clamp}
    rng = np.random.default_rng(len(case))
    shape = (2, 8, 16, 16)
    out = {("aff" if heads else "out"): (rng.standard_normal((*shape, 2)) * 2).astype(np.float32)}
    if heads:
        out["sdt"] = rng.standard_normal((*shape, 1)).astype(np.float32)
    for k in range(3):
        out[f"ds_{k}"] = (rng.standard_normal((2, 8 >> (k + 1), 16 >> (k + 1), 16 >> (k + 1), 2)) * 2).astype(np.float32)
    target = (rng.random((*shape, 3 if heads else 2)) > 0.6).astype(np.float32)
    mask = (rng.random((*shape, 1)) > 0.2).astype(np.float32) if masked else None
    want_total, want = JaxOrchestrator(jax_build_dataclass(JaxLossConfig, loss))(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(target),
        mask=None if mask is None else jnp.asarray(mask))
    orch = LossOrchestrator(build_dataclass(LossConfig, loss))
    total, got = orch({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(target),
                      mask=None if mask is None else torch.from_numpy(mask))
    assert set(got) == set(want) and {"loss_ds_0", "loss_ds_1", "loss_ds_2"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    if heads:  # every term has a head: the ds scales add nothing
        assert all(float(got[f"loss_ds_{k}"]) == 0.0 for k in range(3))
    if clamp is not None:
        assert max(float(got[f"loss_ds_{k}"]) for k in range(3)) == pytest.approx(clamp)


def test_downsampled_target_is_the_integer_factor_mean():
    t = torch.arange(2 * 4 * 6 * 6 * 1, dtype=torch.float32).reshape(2, 4, 6, 6, 1)
    got = LossOrchestrator._downsample_target(t, (2, 3, 2))
    want = t.reshape(2, 2, 2, 3, 2, 2, 3, 1).mean(dim=(2, 4, 6))
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rsunet_deep_supervision_heads_match_flax(dtype):
    """RSUNet with four levels: ``ds_head_{2,1}`` on the decoder levels above
    the finest; ``ds_0`` the finer of them."""
    kw = dict(width=(8, 12, 16, 20), iso=True, deep_supervision=True)
    jm = JaxRSUNet(in_channels=1, out_channels=3, dtype=jnp.dtype(dtype), **kw)
    shape = (1, 16, 16, 16, 1)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    params = _jax_params(jm, shape, 3)
    assert {"ds_head_1", "ds_head_2"} <= set(params) and "ds_head_0" not in params
    want = jax.jit(jm.apply)({"params": params}, x)
    model = RSUNet(in_channels=1, out_channels=3, dtype=getattr(torch, dtype), **kw)
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["ds_0", "ds_1", "out"]
    assert got["ds_0"].shape == (1, 8, 8, 8, 3) and got["ds_1"].shape == (1, 4, 4, 4, 3)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for k in want:
        w = np.asarray(want[k])
        assert np.abs(got[k].numpy() - w).max() <= tol * np.abs(w).max(), k


def test_mednext_deep_supervision_and_validation_metrics():
    """MedNeXt's ``ds_head_{3,2,1}`` against flax (f32), then the validation
    step: the ds losses in its logs and the binary metrics of ``out``, as
    JAX's ``eval_step`` computes them."""
    over = ["model.mednext.size=custom", "model.mednext.base_channels=8", "model.mednext.exp_ratio=2",
            "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]", "optimization.precision=32",
            "model.input_size=[16,32,32]", "model.loss.deep_supervision=true"]
    jm = jax_build(jax_load_config(SYNTH, overrides=over, mode="train").model)
    shape = (2, 16, 32, 32, 1)
    params = _jax_params(jm, shape, 5)
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, x)
    cfg = load_config(SYNTH, overrides=over, mode="train")
    model = build_model(cfg.model, device="cpu", seed=0)
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["ds_0", "ds_1", "ds_2", "out"]
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)
    y = (np.random.default_rng(7).random(shape) > 0.5).astype(np.float32)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=0.0))
    logs = make_val_step(LossOrchestrator(cfg.model.loss))(state, {"image": torch.from_numpy(x),
                                                                    "label": torch.from_numpy(y)})
    assert {"loss_ds_0", "val_jaccard", "val_dice", "val_accuracy"} <= set(logs)
