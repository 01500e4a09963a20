"""The CLI legs of the port's MONAI U-Net recipes on the CPU, cut to a tiny
model, small volumes and windows and 2 train steps (each cut is an override
in ``CUT`` or the volume URLs): ``tutorials/minimal.yaml`` train -> test and
``tutorials/synthetic_blobs.yaml`` train -> test -> bcd decode -> adapted
Rand / VOI."""

import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.runtime.cli import main

MINIMAL, BLOBS = "tutorials/minimal.yaml", "tutorials/synthetic_blobs.yaml"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch operations: one thread each under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the CLI legs, cut: tiny widths, small volumes and windows, 2 train steps
CUT = ["--device", "cpu", "optimization.n_steps_per_epoch=2", "optimization.limit_val_batches=1",
       "model.monai.filters=[4,8,8]", "data.dataloader.patch_size=[16,32,32]", "model.input_size=[16,32,32]",
       "inference.window.window_size=[16,32,32]", "inference.window.sw_batch_size=2"]


def test_cli_minimal_trains_then_tests(tmp_path):
    """``minimal.yaml``: train (random:// volumes, DiceLoss) writes a
    checkpoint that --mode test restores; the recipe names no test volume,
    so the test leg names random:// ones on the command line."""
    vols = [f"data.{s}.{r}=random://minimal/{s}_{r}?shape=16,40,40" for s in ("train", "val") for r in ("image", "label")]
    res = main(["--config", MINIMAL, "--mode", "train", *CUT, f"save_path={tmp_path}", *vols])
    assert np.isfinite(res["metrics"]["val_loss"]) and "loss_DiceLoss_0" in res["metrics"]
    test = main(["--config", MINIMAL, "--mode", "test", *CUT, f"save_path={tmp_path}",
                 "data.test.image=random://minimal/test_image?shape=16,40,36",
                 "data.test.label=random://minimal/test_label?shape=16,40,36"])
    assert test["restored"]["checkpoint"] == res["checkpoint"]
    pred = read_volume(str(next(tmp_path.glob("*/test/*_prediction.h5"))))
    assert pred.shape == (1, 16, 40, 36) and np.isfinite(pred).all()


def test_cli_synthetic_blobs_train_test_decode_evaluate(tmp_path):
    """``synthetic_blobs.yaml`` (the ``bcd`` profile on synthetic://blobs):
    train, then test with bump blending at overlap 0.25, bcd watershed
    decode and adapted Rand / VOI."""
    vols = [f"data.{s}.{r}=synthetic://blobs/{s}_{r}?shape={shape}&seed={seed}"
            for s, shape, seed in (("train", "16,48,48", 21), ("val", "16,32,32", 22), ("test", "16,40,36", 23))
            for r in ("image", "label")]
    res = main(["--config", BLOBS, "--mode", "train", *CUT, f"save_path={tmp_path}", *vols[:4]])
    assert np.isfinite(res["metrics"]["val_loss"])
    test = main(["--config", BLOBS, "--mode", "test", *CUT, f"save_path={tmp_path}", *vols[4:]])
    scores = test["metrics"]["synthetic"]
    assert {"adapted_rand", "voi", "voi_split", "voi_merge"} <= set(scores)
    pred = read_volume(str(next(tmp_path.glob("*/test/*_prediction.h5"))))
    assert pred.shape == (3, 16, 40, 36)
    assert next(tmp_path.glob("*/test/*_decoded_bcd_watershed*"), None) is not None
