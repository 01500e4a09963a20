"""CLI legs of the recipes this slice unblocks, on the CPU, cut to a tiny
model, small volumes and windows and a few steps (each cut an override in
``CUT`` or the volume URLs):

- ``tutorials/syn_cremi.yaml`` train -> test: the polarity target, BCE with
  ``pos_weight: auto`` plus Dice, flip TTA xy, ``polarity2instance`` and
  instance F1, on ``synthetic://blobs`` volumes (odd ids pre, even post);
- ``tutorials/fiber_linghu.yaml``'s train leg (``SoftClDiceLoss``) with
  on-device augmentation, SGD under ``StepLR``, 2-step accumulation, early
  stopping and a profiler window (its start and
  stop recorded: ``torch.profiler`` over the CPU's plain conv path records
  millions of events; ``test_torch_train_options.py`` writes a trace)."""

import json

import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.runtime.cli import main


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CUT = ["--device", "cpu", "optimization.limit_val_batches=1", "model.monai.filters=[4,8,8]",
       "data.dataloader.patch_size=[16,32,32]", "model.input_size=[16,32,32]", "data.dataloader.batch_size=2",
       "inference.window.window_size=[16,32,32]", "inference.window.sw_batch_size=2"]


def _blobs(split, shape, seed):
    return [f"data.{split}.{r}=synthetic://blobs/{split}_{r}?shape={shape}&seed={seed}" for r in ("image", "label")]


def test_syn_cremi_trains_then_tests(tmp_path):
    res = main(["--config", "tutorials/syn_cremi.yaml", "--mode", "train", *CUT, "optimization.n_steps_per_epoch=3",
                "optimization.max_epochs=1", f"save_path={tmp_path}", *_blobs("train", "16,48,48", 31)])
    recs = [json.loads(x) for x in (tmp_path.glob("*/metrics.jsonl").__next__()).read_text().splitlines()]
    assert any("train_loss_WeightedBCEWithLogitsLoss_0" in r for r in recs)
    test = main(["--config", "tutorials/syn_cremi.yaml", "--mode", "test", *CUT, f"save_path={tmp_path}",
                 *_blobs("test", "16,40,36", 32)])
    assert test["restored"]["checkpoint"] == res["checkpoint"]
    scores = test["metrics"]["synthetic"]
    assert {"instance_f1", "instance_precision", "instance_recall"} <= set(scores)
    pred = read_volume(str(next(tmp_path.glob("*/test/*tta_x4_prediction.h5"))))
    assert pred.shape == (3, 16, 40, 36) and np.isfinite(pred).all() and 0 <= pred.min() and pred.max() <= 1
    decoded = read_volume(str(next(tmp_path.glob("*/test/*decoded_polarity2instance*"))))
    assert decoded.shape == (16, 40, 36)


def test_fiber_linghu_train_leg_with_the_rest_of_training(tmp_path, monkeypatch):
    from pytorch_connectomics_tpu_torch.training.loop import Trainer

    window = []
    monkeypatch.setattr(Trainer, "_start_profiler", lambda self: window.append(("start", self.state.step)) or "p")
    monkeypatch.setattr(Trainer, "_stop_profiler", lambda self, prof: window.append(("stop", self.state.step)))
    over = ["optimization.n_steps_per_epoch=4", "optimization.max_epochs=4", "optimization.optimizer.name=SGD",
            "optimization.optimizer.lr=0.01", "optimization.scheduler.name=StepLR",
            "optimization.scheduler.interval=step", "optimization.scheduler.step_size=1",
            "optimization.accumulate_grad_batches=2", "data.augmentation.on_device=true",
            "monitor.profile_steps=[1,3]", "monitor.early_stopping.enabled=true", "monitor.early_stopping.patience=1",
            "monitor.early_stopping.min_delta=100.0", "monitor.logging.scalar.loss_every_n_steps=1",
            "model.monai.filters=[4,8]"]
    res = main(["--config", "tutorials/fiber_linghu.yaml", "--mode", "train", *CUT, *over, f"save_path={tmp_path}",
                *_blobs("train", "16,48,48", 33), *_blobs("val", "16,32,32", 34)])
    run = next(tmp_path.glob("*/metrics.jsonl")).parent
    recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss_SoftClDiceLoss_1"] for r in recs if "train_loss_SoftClDiceLoss_1" in r]
    assert losses and all(np.isfinite(losses))
    # early stopping after the second epoch's validation (nothing betters the first by 100)
    assert res["train_stats"]["steps"] == 8 and np.isfinite(res["metrics"]["val_loss"])
    lrs = [r["train_lr"] for r in recs if "train_lr" in r]
    assert lrs[0] == pytest.approx(0.01 * 0.1 ** 1) and lrs[-1] < lrs[0]  # logged at the micro-step, as JAX logs it
    assert window == [("start", 1), ("stop", 3)]  # steps [1, 3): before the second step, after the third
