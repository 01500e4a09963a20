"""Tiny CLI drives of the multi-task recipes on the CPU, train -> test on
small ``synthetic://instance`` volumes with a narrow model:
``mito_betaseg.yaml`` (three heads, skeleton-aware EDT, SmoothL1,
``output_head: aff_r1``, ``affinity_cc``, adapted Rand / VOI / instance F1,
then the merged heads saved one file a head), ``neuron_snemi_sdt_multitask.yaml``
(heads of one block, SDT, GradNorm), ``neuron_snemi_sdt.yaml`` (RSUNet,
SDT, ``select_channel``) and ``mito_betaseg_banis_v1.yaml`` (target
context)."""

import json

import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.runtime.cli import main

MEDNEXT_TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
]
RSUNET_TINY = ["model.rsunet.width=[8,12,16]", "model.rsunet.down_factors=[[1,2,2],[1,2,2]]"]
SHAPE16 = ["model.input_size=[16,16,16]", "inference.window.window_size=[16,16,16]",
           "data.dataloader.patch_size=[16,16,16]"]
VOL = "data.{}.{}=synthetic://instance/{}_{}?shape={}&seed={}"
# recipe, its tiny overrides, the prediction's channels
RECIPES = {
    "mito_betaseg": (MEDNEXT_TINY + SHAPE16, 3),
    "neuron_snemi_sdt_multitask": (MEDNEXT_TINY + SHAPE16, 3),
    "neuron_snemi_sdt": (RSUNET_TINY + SHAPE16, 3),
    # the recipe's divide-255 normalisation raises in both packages; scale is x / 255
    "mito_betaseg_banis_v1": (MEDNEXT_TINY + SHAPE16 + ["data.preprocessing.normalize=scale"], 3),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch operations: one intra-op thread, as the other CLI tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_cli_train_then_test(recipe, tmp_path):
    """3 train steps (batch 2, f32) then ``--mode test`` restoring the last
    checkpoint: finite losses logged per term, the selected prediction's
    channels, a decoded volume and finite metrics."""
    over, channels = RECIPES[recipe]
    flags = ["--config", f"tutorials/{recipe}.yaml", "--device", "cpu"]
    common = [*over, "optimization.precision=32", f"save_path={tmp_path}"]
    train = main([*flags, "--mode", "train", *common, "data.dataloader.batch_size=2", "optimization.n_steps_per_epoch=3",
                  "optimization.max_epochs=1", VOL.format("train", "image", "t", "image", "24,40,40", 31),
                  VOL.format("train", "label", "t", "label", "24,40,40", 31)])
    run = tmp_path / train["run_dir"].split("/")[-1]
    logs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    terms = [k for k in logs[0] if k.startswith("train_loss_") and k != "train_loss_total"]
    assert terms and all(np.isfinite(v) for r in logs for k, v in r.items() if isinstance(v, float))
    if recipe == "neuron_snemi_sdt_multitask":
        assert {"train_gradnorm_w_PerChannelBCEWithLogitsLoss_0", "train_gradnorm_w_WeightedMSELoss_1"} <= set(logs[0])
    test = main([*flags, "--mode", "test", *common, VOL.format("test", "image", "s", "image", "20,40,36", 32),
                 VOL.format("test", "label", "s", "label", "20,40,36", 32)])
    scores = test["metrics"]["synthetic"]
    assert {"adapted_rand", "voi"} <= set(scores) and all(np.isfinite(v) for v in scores.values())
    out = run / "test"
    pred = read_volume(str(next(out.glob("synthetic_*_prediction.h5"))))
    assert pred.shape == (channels, 20, 40, 36) and 0 <= pred.min() <= pred.max() <= 1
    assert read_volume(str(next(out.glob("synthetic_*_decoded_*.h5")))).shape == (20, 40, 36)
    if recipe == "mito_betaseg":
        assert "instance_f1" in scores
        # no output head: the heads merged in sorted name order, each also saved alone
        main([*flags, "--mode", "test", "--output-dir", str(tmp_path / "heads"), *common, "inference.model.output_head=null",
              "inference.output.save_all_heads=true", "decoding.enabled=false", "evaluation.enabled=false",
              VOL.format("test", "image", "s", "image", "20,40,36", 32)])
        merged = read_volume(str(next((tmp_path / "heads").glob("synthetic_last_prediction.h5"))))
        assert merged.shape == (7, 20, 40, 36)
        start = 0
        for name, c in (("aff_r1", 3), ("aff_r5", 3), ("sedt", 1)):
            head = read_volume(str(tmp_path / "heads" / f"synthetic_last_head_{name}_prediction.h5"))
            np.testing.assert_array_equal(head, merged[start:start + c])
            start += c
