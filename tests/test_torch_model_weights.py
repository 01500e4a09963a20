"""Foreign weights, UpKern and the CLI repairs of the port against the JAX
package on the CPU: ``upkern_resize_kernel`` bit for bit; ``upkern_transfer``
of a kernel-3 MedNeXt into a kernel-5 one through the flax -> torch bridge;
``load_external_weights`` of a seeded foreign torch checkpoint (1x1x1 convs
as (O, I, 1, 1, 1), transposed kernels, a ``module.`` prefix, a tensor no
parameter takes), with and without UpKern inflation, weights and
``loaded/missed/inflated/unused`` against JAX's loader through the bridge;
the CLI's ``--external-prefix`` and ``--fast-dev-run``; full unpickling
for foreign files only; ``upkern_from`` a
port checkpoint through the trainer, the EMA copy re-seeded. Tolerance:
exact (the same float32 operations on the same numbers)."""

import argparse
import json
import logging
import pickle
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.models import build_model as jax_build
from pytorch_connectomics_tpu.training import model_weights as jmw
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.models.convert import flax_to_state_dict, load_flax_params, model_entries
from pytorch_connectomics_tpu_torch.runtime import cli
from pytorch_connectomics_tpu_torch.runtime.dispatch import load_weights
from pytorch_connectomics_tpu_torch.training import model_weights as pmw
from pytorch_connectomics_tpu_torch.training.loop import Trainer
from test_torch_multitask import _jax_params

SYNTH = "tutorials/mito_synthetic_cli_fast_tpu.yaml"
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "optimization.precision=32",
    "model.input_size=[16,32,32]",
]
SHAPE = (1, 16, 32, 32, 1)


def _models(kernel, seed, over=()):
    """(flax params in sorted key order, the port model holding them, cfg)."""
    over = TINY + [f"model.mednext.kernel_size={kernel}", *over]
    jm = jax_build(jax_load_config(SYNTH, overrides=over, mode="train").model)
    params = jax.tree.map(np.asarray, _jax_params(jm, SHAPE, seed))  # sorted keys, as a trainer's params
    cfg = load_config(SYNTH, overrides=over, mode="train")
    model = build_model(cfg.model, device="cpu", seed=0)
    load_flax_params(model, params)
    return params, model, cfg


def _assert_same(sd_a, sd_b):
    assert set(sd_a) == set(sd_b)
    for k in sd_a:
        torch.testing.assert_close(sd_a[k], sd_b[k], rtol=0, atol=0, msg=k)


def test_upkern_resize_kernel_matches_jax():
    rng = np.random.default_rng(0)
    for src, dst in (((3, 3, 3, 4, 6), (5, 5, 5)), ((1, 3, 3, 8, 8), (1, 5, 5)), ((2, 2, 2, 3, 5), (2, 2, 2))):
        w = rng.standard_normal(src).astype(np.float32)
        want = jmw.upkern_resize_kernel(w, dst)
        got = pmw.upkern_resize_kernel(w, dst)
        assert got.shape == (*dst, *src[3:])
        np.testing.assert_array_equal(got, want)


def test_upkern_transfer_matches_jax_through_the_bridge():
    """Every kernel-3 depthwise and transposed kernel inflated to 5^3, every
    other leaf copied: the port's transfer equals JAX's, bridged."""
    src_params, src_model, _ = _models(3, 1)
    tgt_params, model, _ = _models(5, 2)
    want, want_stats = jmw.upkern_transfer(tgt_params, src_params)
    stats = pmw.upkern_transfer(model, src_model.state_dict())
    assert stats == want_stats and stats["inflated"] == 17 and stats["kept"] == 0
    _assert_same(model.state_dict(), flax_to_state_dict(want, model))


def _foreign(params, model, seed, prefix="module.", extra=True):
    """A foreign torch state dict of ``params``' shapes, in the flax tree's
    creation order (not the sorted order the matcher walks): conv kernels
    (O, I, k...), 1x1x1 convs (O, I, 1, 1, 1), transposed kernels as a
    torch ConvTranspose3d holds them (I, O, k...), seeded values; plus a
    tensor no parameter takes."""
    rng = np.random.default_rng(seed)
    out = OrderedDict()
    for e in sorted(model_entries(model), key=lambda e: (e.key.count("."), e.key)):
        leaf = params
        for p in e.path:
            leaf = leaf[p]
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if a.ndim == 5:
            a = np.transpose(a, (4, 3, 0, 1, 2))  # (O, I, k...): torch_conv_to_flax maps it back
        out[prefix + e.key.replace(".", "_")] = torch.from_numpy(np.ascontiguousarray(a))
    if extra:
        out[prefix + "num_batches_tracked"] = torch.tensor(3)
        out[prefix + "unmatched.weight"] = torch.ones(7, 5)
    return out


@pytest.mark.parametrize("upkern", [False, True])
def test_load_external_weights_matches_jax(tmp_path, upkern):
    """A foreign checkpoint through JAX's ``load_external_weights`` then the
    bridge, and through the port's: the same weights and stats. With
    ``upkern`` the checkpoint is a kernel-3 model's and the target kernel 5."""
    src_params, src_model, _ = _models(3, 3, ["model.loss.deep_supervision=true"])
    params, model, _ = _models(5 if upkern else 3, 4, ["model.loss.deep_supervision=true"])
    path = tmp_path / "foreign.pth"
    torch.save({"state_dict": _foreign(src_params, src_model, 5)}, path)
    want, want_stats = jmw.load_external_weights(params, str(path), upkern=upkern)
    stats = pmw.load_external_weights(model, path, upkern=upkern)
    assert stats == want_stats
    assert stats["loaded"] > 0 and stats["unused"] >= 1 and (stats["inflated"] > 0) == upkern
    _assert_same(model.state_dict(), flax_to_state_dict(want, model))


def test_cli_routes_foreign_checkpoints_through_the_matcher(tmp_path):
    """``--external-prefix`` strips the foreign prefix and the matcher fills
    the model (the parent loaded torch files by name only and raised); a
    state dict with exactly the port's keys still loads by name."""
    params, model, cfg = _models(3, 6)
    path = tmp_path / "ext.ckpt"
    torch.save(_foreign(params, model, 7, prefix="net.", extra=False), path)
    args = cli.parse_args(["--config", SYNTH, "--mode", "test", "--checkpoint", str(path), "--external-prefix", "net."])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = load_weights(model, args.checkpoint, cfg, args.external_prefix)
    assert got["kind"] == "external" and got["stats"]["missed"] == 0 and got["stats"]["unused"] == 0
    want, _ = jmw.load_external_weights(params, str(path), strip_prefixes=("net.",))
    _assert_same(model.state_dict(), flax_to_state_dict(want, model))
    own = tmp_path / "own.pt"
    torch.save(before, own)
    assert load_weights(model, str(own), cfg)["kind"] == "state_dict"
    _assert_same(model.state_dict(), before)


def test_only_foreign_files_are_unpickled_in_full(tmp_path, caplog):
    """A foreign checkpoint that pickles more than tensors (a training
    run's hyperparameters) is unpickled in full, with a warning, and goes
    through the matcher as JAX's loader takes it; a file of any other name
    that the restricted reader refuses raises, as the by-name load did."""
    params, model, cfg = _models(3, 10)
    hparams = argparse.Namespace(lr=0.1)  # refused by torch.load(weights_only=True)
    path = tmp_path / "run.ckpt"
    torch.save({"state_dict": _foreign(params, model, 11, extra=False), "hparams": hparams}, path)
    with caplog.at_level(logging.WARNING, logger=pmw.__name__):
        got = load_weights(model, str(path), cfg)
    assert got["kind"] == "external" and got["stats"]["missed"] == 0 and got["stats"]["unused"] == 0
    assert any("unpickling it in full" in r.getMessage() for r in caplog.records)
    want, _ = jmw.load_external_weights(params, str(path))
    _assert_same(model.state_dict(), flax_to_state_dict(want, model))
    own = tmp_path / "own.bin"
    torch.save({"state_dict": model.state_dict(), "hparams": hparams}, own)
    with pytest.raises(pickle.UnpicklingError):
        load_weights(model, str(own), cfg)
    with pytest.raises(pickle.UnpicklingError):
        pmw.read_torch_checkpoint(path)  # full reads are asked for, never the default


def test_fast_dev_run_cuts_the_run_as_jax_does():
    cfg = cli.setup_config(cli.parse_args(["--config", SYNTH, "--mode", "train", "--fast-dev-run"]))
    o = cfg.optimization
    assert (o.max_epochs, o.n_steps_per_epoch, o.limit_val_batches) == (1, 2, 1)
    full = cli.setup_config(cli.parse_args(["--config", SYNTH, "--mode", "train"]))
    assert full.optimization.max_epochs > 1


def test_upkern_from_a_port_checkpoint_reseeds_the_ema(tmp_path):
    """``model.mednext.upkern_from`` a port checkpoint directory: the trainer
    transfers it by key (JAX's stats), and its EMA copy holds the new
    weights; a missing source raises."""
    src_params, src_model, _ = _models(3, 8)
    ck = tmp_path / "run" / "checkpoints" / "last"
    ck.mkdir(parents=True)
    torch.save({"model": src_model.state_dict(), "step": 5}, ck / "state.pt")
    (ck / "metadata.json").write_text(json.dumps({"step": 5}))
    over = TINY + ["model.mednext.kernel_size=5", f"model.mednext.upkern_from={ck}", "monitor.ema.enabled=true"]
    cfg = load_config(SYNTH, overrides=over, mode="train")
    trainer = Trainer(cfg, run_dir=tmp_path / "k5", device="cpu")
    try:
        stats = trainer.upkern()
    finally:
        trainer.metrics_logger.close()
    tgt = jax.tree.map(np.asarray, _jax_params(jax_build(jax_load_config(SYNTH, overrides=over, mode="train").model),
                                               SHAPE, 9))
    assert stats == jmw.upkern_transfer(tgt, src_params)[1]
    m = trainer.model
    assert m.enc[0].blocks[0].conv_weight.shape == (8, 1, 5, 5, 5)
    for n, p in m.named_parameters():
        torch.testing.assert_close(trainer.state.ema[n], p.detach(), rtol=0, atol=0)
    cfg.model.mednext.upkern_from = str(tmp_path / "nowhere")
    with pytest.raises(FileNotFoundError):
        pmw.upkern_initialize(cfg.model, m)
