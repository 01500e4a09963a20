"""The port's loss zoo (``losses/zoo.py``) and the orchestrator's
pred-vs-pred terms against the JAX package's, on the CPU: each loss's
value and its gradient with respect to ``pred`` against ``jax.grad``, in
float32 within 1e-5 relative, plain and with a mask and a weight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.losses import zoo as jzoo
from pytorch_connectomics_tpu.losses.orchestrator import LossOrchestrator as JaxOrchestrator
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.losses import LossOrchestrator
from pytorch_connectomics_tpu_torch.losses import zoo

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"
SHAPE = (2, 4, 6, 5, 3)


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    pred = (rng.standard_normal(SHAPE) * 2).astype(np.float32)
    target = (rng.random(SHAPE) > 0.6).astype(np.float32)
    if name == "CrossEntropyLoss":
        target = rng.integers(0, SHAPE[-1], SHAPE[:-1] + (1,)).astype(np.float32)
    elif name in ("ForegroundDTConsistency", "WeightedMAELoss", "MAELoss", "L1Loss"):
        target = (rng.standard_normal(SHAPE) * 0.5).astype(np.float32)
    elif name == "ContourDTConsistency":
        target = (rng.standard_normal(SHAPE) * 2).astype(np.float32)  # the second prediction
    mask = (rng.random(SHAPE[:-1] + (1,)) > 0.3).astype(np.float32)
    weight = rng.random(SHAPE[:-1] + (1,)).astype(np.float32)
    return pred, target, mask, weight


# (name, kwargs, masked): every loss the JAX registry names beside those of earlier slices
CASES = [
    ("WeightedMAELoss", {}, True), ("MAELoss", {"tanh": True}, False), ("L1Loss", {}, False),
    ("CrossEntropyLoss", {}, True), ("CrossEntropyLoss", {"onehot": True}, False),
    ("FocalLoss", {}, True), ("FocalLoss", {"alpha": 0.5, "gamma": 1.0}, False),
    ("TverskyLoss", {"alpha": 0.3, "beta": 0.7}, True), ("TverskyLoss", {}, False),
    ("SoftClDiceLoss", {"num_iters": 3}, False), ("SoftClDiceLoss", {"num_iters": 5, "smooth": 0.5}, False),
    ("ScnpLoss", {}, True), ("ScnpLoss", {"neighborhood_size": 5, "auto_pos_weight_flag": False}, False),
    ("BinaryReg", {}, False), ("ForegroundDTConsistency", {}, True), ("ContourDTConsistency", {}, True),
    ("NonOverlapReg", {}, False), ("GANLoss", {}, False), ("GANLoss", {"mode": "vanilla"}, False),
]


@pytest.mark.parametrize("name,kw,masked", CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)])
def test_loss_and_gradient_match_jax(name, kw, masked):
    kw = dict(kw)
    pred, target, mask, weight = _inputs(name, seed=len(name))
    if kw.pop("onehot", False):
        target = np.eye(SHAPE[-1], dtype=np.float32)[target[..., 0].astype(int)]
    extra = dict(mask=mask, weight=weight) if masked else {}
    jfn = jzoo.get_loss(name)

    def jloss(p):
        return jfn(p, jnp.asarray(target), **{k: jnp.asarray(v) for k, v in extra.items()}, **kw)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = zoo.get_loss(name)(p, torch.from_numpy(target), **{k: torch.from_numpy(v) for k, v in extra.items()}, **kw)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    g, wg = p.grad.numpy(), np.asarray(want_g)
    # relative to the gradient's largest entry (entries that cancel to ~0 carry f32 noise)
    np.testing.assert_allclose(g, wg, rtol=1e-5, atol=1e-5 * np.abs(wg).max())
    assert np.abs(wg).max() > 0


def test_pred_vs_pred_terms_match_jax():
    """An orchestrator with a pred2_slice term and a ContourDTConsistency term
    without one (the whole prediction), beside BCE: every term, the total and
    the gradient."""
    over = ["model.out_channels=2", "model.loss.losses=[{function: WeightedBCEWithLogitsLoss, weight: 1.0, "
            "pred_slice: '0:1', target_slice: '0:1'}, {function: ContourDTConsistency, weight: 0.5, "
            "pred_slice: '0:1', pred2_slice: '1:2'}, {function: ContourDTConsistency, weight: 0.25, "
            "pred_slice: '1:2'}, {function: WeightedMSELoss, weight: 0.3, pred_slice: '0:1', pred2_slice: '1:2'}]"]
    cfg, jcfg = load_config(SYNTH, overrides=over, mode="train"), jax_load_config(SYNTH, overrides=over, mode="train")
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((2, 4, 6, 5, 2)).astype(np.float32)
    target = (rng.random((2, 4, 6, 5, 1)) > 0.5).astype(np.float32)
    mask = (rng.random((2, 4, 6, 5, 1)) > 0.3).astype(np.float32)
    jorch = JaxOrchestrator(jcfg.model.loss)

    def jtotal(p):
        return jorch(p, jnp.asarray(target), mask=jnp.asarray(mask))

    (want, want_logs), want_g = jax.value_and_grad(jtotal, has_aux=True)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    total, logs = LossOrchestrator(cfg.model.loss)(p, torch.from_numpy(target), mask=torch.from_numpy(mask))
    total.backward()
    assert set(logs) == set(want_logs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k].detach()), float(want_logs[k]), rtol=1e-5, err_msg=k)
    wg = np.asarray(want_g)
    np.testing.assert_allclose(p.grad.numpy(), wg, rtol=1e-5, atol=1e-5 * np.abs(wg).max())
