"""Multi-task loss balancing, the port of
``pytorch_connectomics_tpu/losses/balancing.py``: Kendall uncertainty
weighting and two GradNorm updates (Chen et al. 2018).

- ``gradnorm``: inverse training rates from the loss ratios L_i / L_i(0)
  only, no gradient measured.
- ``gradnorm_exact``: with the measured norms of d loss_i / d model output
  (one loss-only backward a term, at the trunk/head boundary), the
  weighted norms are driven toward ``mean(w G) * r_i^alpha``.

The GradNorm updates return new weights outside autograd (detached), on
the device: no host sync.
"""

from __future__ import annotations

from typing import Sequence

import torch


def uncertainty_weighted_total(losses: Sequence[torch.Tensor], log_vars: torch.Tensor) -> torch.Tensor:
    """Kendall: sum of exp(-s_i) L_i + s_i / 2 (the log-variances train)."""
    return sum(torch.exp(-log_vars[i]) * L + 0.5 * log_vars[i] for i, L in enumerate(losses))


def _inverse_rates(losses: Sequence[torch.Tensor], initial_losses: torch.Tensor) -> torch.Tensor:
    L = torch.stack([torch.as_tensor(x, dtype=torch.float32) for x in losses])
    ratios = L / torch.clamp(initial_losses, min=1e-8)
    return ratios / torch.clamp(ratios.mean(), min=1e-8)


def _renormalised(new_w: torch.Tensor, n: int) -> torch.Tensor:
    return (new_w * (n / torch.clamp(new_w.sum(), min=1e-8))).detach()


def gradnorm_exact_weights(grad_norms: torch.Tensor, losses: Sequence[torch.Tensor], initial_losses: torch.Tensor,
                           weights: torch.Tensor, alpha: float = 1.5, lr: float = 0.025) -> torch.Tensor:
    """GradNorm from the measured per-term gradient norms ``G``: the
    per-step solution ``w*_i = mean(w G) r_i^alpha / G_i``, weights moved
    toward it by ``lr`` and renormalised to sum to the term count."""
    G = torch.clamp(grad_norms, min=1e-12)
    target = (weights * G).mean() * _inverse_rates(losses, initial_losses) ** alpha
    new_w = weights * (1.0 - lr) + lr * (target / G)
    return _renormalised(new_w, len(losses))


def gradnorm_weights(losses: Sequence[torch.Tensor], initial_losses: torch.Tensor, weights: torch.Tensor,
                     alpha: float = 1.5, lr: float = 0.025) -> torch.Tensor:
    """One GradNorm update from the current and initial per-term losses:
    the weights move toward ``r_i^alpha`` by ``lr`` and are renormalised to
    sum to the term count."""
    new_w = weights * (1.0 - lr) + lr * _inverse_rates(losses, initial_losses) ** alpha
    return _renormalised(new_w, len(losses))
