"""Loss functions on tensors.

The port's counterpart of ``lightctr_tpu/ops/losses.py`` (itself a redesign
of ``LightCTR/util/loss.h:17-86``).  Losses are scalar-valued functions of
logits; autograd reproduces the reference's hand-written gradients, so no
separate gradient methods exist.

All losses return the **sum** over elements by default (the reference
accumulates sums, e.g. loss.h:45-52), with ``mean`` and ``none``
reductions.
"""

from __future__ import annotations

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "none":
        return x
    raise ValueError(f"unknown reduction {reduction!r}")


def square_loss(pred: torch.Tensor, target: torch.Tensor,
                reduction: str = "sum") -> torch.Tensor:
    """MSE, 0.5 * (pred - y)^2 (loss.h:25-39); grad w.r.t. pred is pred - y."""
    d = pred - target
    return _reduce(0.5 * d * d, reduction)


def logistic_loss(logits: torch.Tensor, labels: torch.Tensor,
                  reduction: str = "sum") -> torch.Tensor:
    """Numerically-stable binary cross-entropy on logits: the negated
    log-likelihood ``(y - [z>=0]) z - log(1 + exp(z - 2 [z>=0] z))``
    (loss.h:44-52).  grad w.r.t. z is sigmoid(z) - y (loss.h:56-60)."""
    z = logits
    pos = (z >= 0).to(z.dtype)
    ll = (labels - pos) * z - torch.log1p(torch.exp(z - 2.0 * pos * z))
    return _reduce(-ll, reduction)


def bce_on_probs(probs: torch.Tensor, labels: torch.Tensor,
                 reduction: str = "sum") -> torch.Tensor:
    """Binary cross-entropy on probabilities clamped away from 0/1 (the
    form the reference's predictors report, fm_predict.cpp:56-61)."""
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    return _reduce(-(labels * torch.log(p)
                     + (1.0 - labels) * torch.log1p(-p)), reduction)


def softmax_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor,
                          temperature: float = 1.0,
                          reduction: str = "sum") -> torch.Tensor:
    """CE for one-hot targets (Logistic_Softmax, loss.h:65-86).  The
    gradient w.r.t. the logits is softmax(z) - onehot (the reference writes
    its negative: its backward convention is "direction of increase")."""
    logp = torch.log_softmax(logits / temperature, dim=-1)
    return _reduce(-torch.sum(onehot * logp, dim=-1), reduction)


LOSSES = {
    "square": square_loss,
    "logistic": logistic_loss,
    "softmax_ce": softmax_cross_entropy,
}


def get(name: str):
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; have {sorted(LOSSES)}")
