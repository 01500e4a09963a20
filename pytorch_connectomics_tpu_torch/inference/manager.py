"""InferenceManager: config -> sliding-window engine + TTA on one device
(the port of ``pytorch_connectomics_tpu/inference/manager.py``, 3-D path)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config.schema import Config
from ..data.targets.build import affinity_target_groups
from .tta import TTAPredictor
from .window import make_engine


class InferenceManager:
    """``model`` is the port's module, already on ``device``."""

    def __init__(self, cfg: Config, model: torch.nn.Module, device: torch.device | str):
        self.cfg = cfg
        inf = cfg.inference
        if inf.direct_2d:
            raise NotImplementedError("2-D direct inference is not ported yet")
        if inf.model.output_head:
            raise NotImplementedError("output heads of multi-head models are not ported yet")
        self.model = model
        self.device = torch.device(device)
        self.engine = make_engine(model, inf.window, cfg.model.input_size, self.device)
        acts = inf.model.act
        if acts is None:
            acts = (getattr(inf.model, "extra", None) or {}).get("channel_activations")
        self.predictor = TTAPredictor(
            self.engine,
            inf.test_time_augmentation,
            activations=acts,
            select_channel=inf.model.select_channel,
            affinity_groups=affinity_target_groups(getattr(cfg.data, "label_transform", None)),
        )

    def predict(self, volume: np.ndarray) -> np.ndarray:
        """Full-volume prediction with TTA -> (Z,Y,X,C) float32."""
        return self.predictor.predict(volume, out_channels=self.cfg.model.out_channels)
