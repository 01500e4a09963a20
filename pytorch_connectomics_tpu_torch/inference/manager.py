"""InferenceManager: config -> sliding-window engine + TTA on one device
(the port of ``pytorch_connectomics_tpu/inference/manager.py``, 3-D path).

A multi-head model's dict output becomes one tensor before blending
(JAX ``manager.py:19-40``): the head ``inference.model.output_head``
names, else ``out``, else every head's channels concatenated in sorted
name order; ``head_spans`` gives each head's channels in that merge.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config.schema import Config
from ..data.targets.build import affinity_target_groups
from .tta import TTAPredictor
from .window import make_engine


def select_head(out, head: Optional[str] = None) -> torch.Tensor:
    """A model output as one tensor: ``out[head]``, ``out["out"]``, or the
    heads concatenated in sorted name order (``ds_*`` left out)."""
    if not isinstance(out, dict):
        return out
    if head:
        return out[head]
    if "out" in out:
        return out["out"]
    return torch.cat([out[k] for k in sorted(k for k in out if not k.startswith("ds_"))], dim=-1)


def _head_channels(cfg: Config) -> List[Tuple[str, int]]:
    heads = getattr(getattr(cfg.model, "mednext", None), "heads", None) or []
    return [(str(h.name), int(h.out_channels)) for h in heads]


class InferenceManager:
    """``model`` is the port's module, already on ``device``."""

    def __init__(self, cfg: Config, model: torch.nn.Module, device: torch.device | str):
        self.cfg = cfg
        inf = cfg.inference
        if inf.direct_2d:
            raise NotImplementedError("2-D direct inference is not ported yet")
        self.model = model
        self.device = torch.device(device)
        head = inf.model.output_head
        heads = dict(_head_channels(cfg))
        if head and heads and head not in heads:
            raise KeyError(f"output_head {head!r} is none of the model's heads {sorted(heads)}")
        # the channels the selected output has: the head's, all heads' merged, or the model's
        if heads:
            self.out_channels = heads[head] if head else sum(heads.values())
        else:
            self.out_channels = int(cfg.model.out_channels)
        # each head's channel span in the sorted-name merge (no head named)
        self.head_spans: Optional[List[Tuple[str, int, int]]] = None
        if heads and not head:
            self.head_spans, start = [], 0
            for name in sorted(heads):
                self.head_spans.append((name, start, start + heads[name]))
                start += heads[name]
        self.engine = make_engine(lambda w: select_head(model(w), head), inf.window, cfg.model.input_size,
                                  self.device)
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
        return self.predictor.predict(volume, out_channels=self.out_channels)
