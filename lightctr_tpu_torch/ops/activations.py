"""Activation functions on tensors (``LightCTR/util/activations.h``).

The port's counterpart of ``lightctr_tpu/ops/activations.py``; only what
the serving slice runs is here so far.

Numerical-guard semantics preserved:
  - Sigmoid clamps logits to +/-16 and outputs to [1e-7, 1-1e-7]
    (activations.h:63-79).
"""

from __future__ import annotations

import torch

EPS = 1e-7
SIGMOID_CLAMP = 16.0


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Clamped sigmoid (activations.h:63-79): inputs beyond +/-16 saturate to
    eps / 1-eps, so downstream log-losses never see exact 0 or 1."""
    y = torch.sigmoid(x.clamp(-SIGMOID_CLAMP, SIGMOID_CLAMP))
    return torch.where(x < -SIGMOID_CLAMP, EPS,
                       torch.where(x > SIGMOID_CLAMP, 1.0 - EPS, y))
