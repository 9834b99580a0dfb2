"""Activation functions on tensors (``LightCTR/util/activations.h``).

The port's counterpart of ``lightctr_tpu/ops/activations.py``.  Forward
functions are differentiated by autograd; ``binary_sigmoid`` is a
``torch.autograd.Function`` because the reference's backward deliberately
differs from the true derivative (the straight-through estimator of
``Binary_Sigmoid``, activations.h:36-60).

Numerical-guard semantics preserved:
  - Sigmoid clamps logits to +/-16 and outputs to [1e-7, 1-1e-7]
    (activations.h:63-79).
  - Softmax is max-shifted, takes a distillation temperature
    (``softTargetRate``, activations.h:92-123), and clamps outputs away
    from exact 0/1 (activations.h:107-112).
"""

from __future__ import annotations

import torch

EPS = 1e-7
SIGMOID_CLAMP = 16.0


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Clamped sigmoid (activations.h:63-79): inputs beyond +/-16 saturate to
    eps / 1-eps, so downstream log-losses never see exact 0 or 1."""
    y = torch.sigmoid(x.clamp(-SIGMOID_CLAMP, SIGMOID_CLAMP))
    return torch.where(x < -SIGMOID_CLAMP, EPS,
                       torch.where(x > SIGMOID_CLAMP, 1.0 - EPS, y))


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.softplus(x)


def softmax(x: torch.Tensor, temperature: float = 1.0,
            axis: int = -1) -> torch.Tensor:
    """Max-shifted softmax with distillation temperature
    (``softTargetRate``, activations.h:92-112); outputs clamped to
    [1e-7, 1-1e-7] like the reference."""
    return torch.softmax(x / temperature, dim=axis).clamp(EPS, 1.0 - EPS)


class _BinarySigmoid(torch.autograd.Function):
    """Forward sign(x) * mean(|x|); backward the straight-through
    estimator (the JAX ``_binary_sigmoid_fwd`` / ``_bwd`` pair)."""

    @staticmethod
    def forward(ctx, x):
        return torch.sign(x) * torch.mean(x.abs())

    @staticmethod
    def backward(ctx, g):
        return g


def binary_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """XNOR-net style weight binarization (activations.h:36-60): forward
    replaces each element with sign(x) * mean(|x|) over the tensor;
    backward passes the gradient through unchanged (activations.h:54-59)."""
    return _BinarySigmoid.apply(x)


ACTIVATIONS = {
    "identity": identity,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "relu": relu,
    "softplus": softplus,
    "softmax": softmax,
    "binary_sigmoid": binary_sigmoid,
}


def get(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; have "
                         f"{sorted(ACTIVATIONS)}")
