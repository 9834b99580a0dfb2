"""Model ensembling: voting and AdaBoost reweighting, on tensors.

The port's counterpart of ``lightctr_tpu/ops/ensembling.py`` (a redesign
of ``util/ensembling.h``): hard-vote and probability-average ``Voting``
(ensembling.h:19-63) and ``AdaBoost`` sample reweighting and model weights
(ensembling.h:65-107).  Each function runs on the device of its inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def vote_hard(predictions: torch.Tensor, num_classes: int = 64
              ) -> torch.Tensor:
    """[models, N] class predictions -> [N] majority vote (ties to the
    lowest class).  ``num_classes`` must cover every id: an id outside
    ``[0, num_classes)`` votes for nothing (``jax.nn.one_hot``'s zero row),
    so a row with no valid vote goes to class 0."""
    preds = predictions.to(torch.int64)
    valid = (preds >= 0) & (preds < num_classes)
    one = torch.nn.functional.one_hot(
        torch.where(valid, preds, 0), num_classes).to(torch.float32)
    one = one * valid[..., None].to(torch.float32)
    return torch.argmax(torch.sum(one, dim=0), dim=-1)


def vote_soft(probs: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[models, N, classes] probabilities (optionally model-weighted) ->
    [N] argmax of the averaged distribution (ties to the lowest class)."""
    if weights is not None:
        probs = probs * weights[:, None, None]
    return torch.argmax(torch.mean(probs, dim=0), dim=-1)


def adaboost_step(
    sample_weights: torch.Tensor,  # [N]
    pred_labels: torch.Tensor,     # [N]
    true_labels: torch.Tensor,     # [N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One AdaBoost round (ensembling.h:65-107): returns (new sample
    weights, model weight alpha)."""
    wrong = (pred_labels != true_labels).to(torch.float32)
    err = torch.clamp(torch.sum(sample_weights * wrong)
                      / torch.sum(sample_weights), 1e-7, 1 - 1e-7)
    alpha = 0.5 * torch.log((1.0 - err) / err)
    scale = torch.where(wrong == 1, torch.exp(alpha), torch.exp(-alpha))
    new_w = sample_weights * scale
    return new_w / torch.sum(new_w), alpha
