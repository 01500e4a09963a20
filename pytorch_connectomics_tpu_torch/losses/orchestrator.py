"""Loss orchestrator, the port of ``LossOrchestrator`` in
``pytorch_connectomics_tpu/losses/orchestrator.py:73-240``.

It compiles ``model.loss.losses`` once; ``orchestrator(outputs, targets,
mask, weight)`` returns ``(total, logs)`` with ``logs["loss_<Function>_<i>"]``
per term and ``logs["loss_total"]`` (tensors, still on the device). Terms
route channels with ``pred_slice``/``target_slice``/``mask_slice``, take a
numeric ``pos_weight`` and the batch's mask and spatial weight as the JAX
package does, and ``pos_weight: auto`` (the term's neg/pos ratio over its
valid voxels, clipped to [1, 100], per batch). Given the affinity channel
groups of the target tensor
(``data.targets.build.affinity_target_groups``), a term whose target
channels overlap a group gets each channel's offset validity (the voxels
whose offset neighbour exists) multiplied into its mask, as JAX's
``_affinity_valid_mask`` (``orchestrator.py:29-53,120-147``).

Multi-head outputs are a dict of head name -> tensor: a term with
``head`` takes that head's output, and its target channels from the
stacked label by ``target_slice`` (or ``targets[head]`` where the targets
are a dict holding it). The total is the weighted sum of the terms, or,
given ``term_weights`` (GradNorm's, :mod:`.balancing`), each term times its
weight too, or, given ``balancer_params`` (Kendall's log-variances),
``sum exp(-s_i) w_i L_i + s_i / 2``; either needs more than one term.

Deep supervision (JAX ``orchestrator.py:232-276``): outputs ``ds_k`` beside
``out`` (or beside the heads) each add ``w_k * L_k`` to the total, where
``L_k`` is the weighted sum of the terms without a ``head`` on the output
against the label average-pooled to its scale by integer factors (the mask
too; no spatial weight), clipped to ``[0, ds_clamp]`` when set, logged as
``loss_ds_k``; ``w_k`` is ``ds_weights[k]`` or ``1 / 2^(k+1)``.
Pred-vs-pred terms raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.slicing import parse_slice
from .balancing import uncertainty_weighted_total
from .zoo import auto_pos_weight, get_loss


def _channels(x: torch.Tensor, spec: Optional[str]) -> torch.Tensor:
    return x[..., parse_slice(spec)]


@dataclass
class CompiledTerm:
    name: str
    fn: Callable
    weight: float
    pred_slice: Optional[str]
    target_slice: Optional[str]
    mask_slice: Optional[str]
    head: Optional[str]
    kwargs: Dict[str, Any]
    auto_pos: bool = False
    # how the batch's spatial weight reaches the term: "weight" (default),
    # "mask" (folded into the loss mask) or "none"
    spatial_weight: Optional[str] = None


def offset_valid_mask(spatial: Tuple[int, int, int], offset, mode: str = "deepem", device=None) -> torch.Tensor:
    """(Z, Y, X) float32 validity of one affinity offset: 1 where the offset
    neighbour exists, at the mode's storage voxel (``deepem``: the
    high-end voxel, ``banis``: the source voxel)."""
    m = torch.ones(spatial, dtype=torch.float32, device=device)
    for d, o in enumerate(offset):
        if o == 0:
            continue
        n = spatial[d]
        idx = torch.arange(n, device=device)
        if mode == "banis":
            keep = idx < n - o if o > 0 else idx >= -o
        else:
            keep = idx >= o if o > 0 else idx < n + o
        shape = [1, 1, 1]
        shape[d] = n
        m = m * keep.reshape(shape).float()
    return m


class LossOrchestrator:
    """``affinity_groups`` ([{start, end, offsets, mode}]) makes the
    orchestrator affinity-aware: each term whose target channels overlap a
    group gets the per-offset validity mask multiplied into its loss mask."""

    def __init__(self, loss_cfg, affinity_groups=None):
        self.cfg = loss_cfg
        self.affinity_groups: List[Dict[str, Any]] = list(affinity_groups or [])
        # validity masks by (term, target shape, device): built once, as
        # JAX's are constants of its trace
        self._valid_masks: Dict[Tuple, Optional[torch.Tensor]] = {}
        self.ds_weights = loss_cfg.ds_weights
        self.ds_clamp = loss_cfg.ds_clamp
        self.terms = []
        for i, t in enumerate(loss_cfg.losses):
            if t.pred2_slice:
                raise NotImplementedError(f"pred-vs-pred loss terms ({t.function}) are not ported yet")
            if t.spatial_weight not in (None, "weight", "mask", "none"):
                raise ValueError(f"loss term {t.function}: spatial_weight must be weight|mask|none, got {t.spatial_weight!r}")
            kwargs = dict(t.kwargs or {})
            kwargs.update(getattr(t, "extra", None) or {})
            auto_pos = t.pos_weight == "auto"
            if t.pos_weight is not None and not auto_pos:
                kwargs["pos_weight"] = float(t.pos_weight)
            self.terms.append(CompiledTerm(
                name=f"{t.function}_{i}", fn=get_loss(t.function), weight=float(t.weight),
                pred_slice=t.pred_slice, target_slice=t.target_slice, mask_slice=t.mask_slice, head=t.head,
                kwargs=kwargs, auto_pos=auto_pos, spatial_weight=t.spatial_weight,
            ))

    def _affinity_valid_mask(self, term: CompiledTerm, target: torch.Tensor) -> Optional[torch.Tensor]:
        """(1, Z, Y, X, Csel) validity mask when the term's target channels
        overlap an affinity group; None otherwise."""
        if not self.affinity_groups:
            return None
        key = (term.name, tuple(target.shape), target.device)
        if key not in self._valid_masks:
            sel = list(range(*parse_slice(term.target_slice).indices(target.shape[-1])))
            per_channel = [None] * len(sel)
            for g in self.affinity_groups:
                for i, c in enumerate(sel):
                    if g["start"] <= c < g["end"]:
                        per_channel[i] = (g["offsets"][c - g["start"]], g.get("mode", "deepem"))
            mask = None
            if any(om is not None for om in per_channel):
                spatial = tuple(target.shape[1:4])
                cols = [
                    offset_valid_mask(spatial, om[0], om[1], target.device) if om is not None
                    else torch.ones(spatial, dtype=torch.float32, device=target.device)
                    for om in per_channel
                ]
                mask = torch.stack(cols, dim=-1)[None]
            self._valid_masks[key] = mask
        return self._valid_masks[key]

    def _term_loss(self, term: CompiledTerm, pred, target, mask=None, weight=None):
        p = _channels(pred, term.pred_slice)
        t = _channels(target, term.target_slice)
        m = None
        if mask is not None:
            m = mask if mask.shape[-1] == 1 else _channels(mask, term.pred_slice)
        if term.mask_slice is not None:
            m2 = _channels(target, term.mask_slice)
            m = m2 if m is None else m * m2
        mv = self._affinity_valid_mask(term, target)
        if mv is not None:
            m = mv if m is None else m * mv
        w = None
        if weight is not None and term.spatial_weight != "none":
            w = weight if weight.shape[-1] == 1 else _channels(weight, term.pred_slice)
            if term.spatial_weight == "mask":
                m = w if m is None else m * w
                w = None
        if term.auto_pos:
            return term.fn(p, t, weight=w, mask=m, pos_weight=auto_pos_weight(t, m), **term.kwargs)
        return term.fn(p, t, weight=w, mask=m, **term.kwargs)

    def compute(self, outputs, targets, mask=None, weight=None, balancer_params=None,
                term_weights=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``outputs``: a tensor, or a dict of head outputs; ``targets``: a
        tensor, or a dict with ``label`` (or one entry a head)."""
        outputs, ds_outs = self._split_outputs(outputs)
        logs: Dict[str, torch.Tensor] = {}
        term_losses = []
        for term in self.terms:
            pred = outputs
            if isinstance(outputs, dict):
                if term.head not in outputs:
                    raise KeyError(f"loss term {term.name} takes head {term.head!r}; the outputs hold {sorted(outputs)}")
                pred = outputs[term.head]
            if isinstance(targets, dict):
                tgt = targets[term.head] if term.head in targets else targets["label"]
            else:
                tgt = targets
            # a non-finite term propagates, so the trainer's finite check names it
            value = self._term_loss(term, pred, tgt, mask, weight)
            logs[f"loss_{term.name}"] = value
            term_losses.append(value)
        if term_weights is not None and len(term_losses) > 1:
            total = sum(term_weights[i] * t.weight * L for i, (t, L) in enumerate(zip(self.terms, term_losses)))
        elif balancer_params is not None and len(term_losses) > 1:
            total = uncertainty_weighted_total([t.weight * L for t, L in zip(self.terms, term_losses)],
                                               balancer_params[: len(term_losses)])
        else:
            total = sum(t.weight * L for t, L in zip(self.terms, term_losses))
        if ds_outs:
            total = total + self._deep_supervision_loss(ds_outs, targets, mask, logs)
        logs["loss_total"] = total
        return total, logs

    __call__ = compute

    @staticmethod
    def _split_outputs(outputs):
        """(main, ``{ds_k: output}``): a dict of only ``out`` (beside the
        ``ds_*``) gives that tensor."""
        if not isinstance(outputs, dict):
            return outputs, {}
        ds = {k: v for k, v in outputs.items() if k.startswith("ds_")}
        main = {k: v for k, v in outputs.items() if not k.startswith("ds_")}
        return (main["out"] if set(main) == {"out"} else main), ds

    @staticmethod
    def _downsample_target(target: torch.Tensor, spatial) -> torch.Tensor:
        """Average-pool (B, Z, Y, X, C) to ``spatial`` by the integer factors
        ``target // spatial`` (VALID: a remainder is dropped), in float32."""
        f = [t // s for t, s in zip(target.shape[1:4], spatial)]
        t = target.float().permute(0, 4, 1, 2, 3)
        return F.avg_pool3d(t, kernel_size=f, stride=f).permute(0, 2, 3, 4, 1)

    def _deep_supervision_loss(self, ds_outs, targets, mask, logs) -> torch.Tensor:
        tgt = targets["label"] if isinstance(targets, dict) else targets
        total = 0.0
        for i, key in enumerate(sorted(ds_outs, key=lambda k: int(k.split("_")[1]))):
            out = ds_outs[key]
            w = self.ds_weights[i] if self.ds_weights and i < len(self.ds_weights) else 0.5 ** (i + 1)
            t_small = self._downsample_target(tgt, out.shape[1:4])
            m_small = self._downsample_target(mask, out.shape[1:4]) if mask is not None else None
            scale_loss = 0.0
            for term in self.terms:
                if term.head is not None:
                    continue  # per-head terms only on full-resolution heads
                scale_loss = scale_loss + term.weight * self._term_loss(term, out, t_small, m_small, None)
            if self.ds_clamp is not None:
                scale_loss = torch.clamp(scale_loss, 0.0, self.ds_clamp)
            logs[f"loss_{key}"] = scale_loss
            total = total + w * scale_loss
        return total

    @property
    def num_terms(self) -> int:
        return len(self.terms)
