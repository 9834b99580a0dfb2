"""Fully-connected layer on tensors.

The port's counterpart of ``lightctr_tpu/nn/dense.py`` (a redesign of
``train/layer/fullyconnLayer.h``): weights ~ U(-0.5, 0.5), zero bias
(fullyconnLayer.h:43-54); per-OUTPUT-UNIT dropout (one mask entry per
output neuron, re-sampled each minibatch, never on the network's output
layer — fullyconnLayer.h:49,96-104,199-201), as inverted dropout (scaled
by 1/keep_prob at train time, so inference is the identity).

The product is a plain ``torch.matmul``: the JAX package leaves it to XLA,
outside any Pallas kernel.  On the card it runs in float32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's
default).

A stack of layers (an MLP) is a dict ``{"l0": layer, "l1": ...}``:
:func:`init_stack` draws it over consecutive widths, :func:`apply_stack`
runs it with one activation after every layer (or every layer but the
last).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch


def init(generator: torch.Generator, in_dim: int, out_dim: int,
         scale: Optional[str] = None, device="cpu") -> Dict[str, torch.Tensor]:
    """weight [out, in] ~ U(-0.5, 0.5); bias zeros (fullyconnLayer.h:43-54),
    drawn from ``generator`` on its device and moved to ``device``.

    ``scale="fan_in"`` divides by sqrt(in_dim), as in the JAX package.
    ``scale="linear"`` is ``torch.nn.Linear``'s default: weight, then bias,
    ~ U(-1, 1) / sqrt(in_dim)."""
    w = torch.rand((out_dim, in_dim), generator=generator,
                   dtype=torch.float32, device=generator.device) - 0.5
    b = torch.zeros((out_dim,), dtype=torch.float32, device=device)
    if scale == "fan_in":
        w = w / math.sqrt(float(in_dim))
    elif scale == "linear":
        bound = 1.0 / math.sqrt(float(in_dim))
        w = w * (2.0 * bound)
        b = ((torch.rand((out_dim,), generator=generator,
                         dtype=torch.float32, device=generator.device)
              * 2.0 - 1.0) * bound).to(device)
    elif scale is not None:
        raise ValueError(f"unknown scale {scale!r}")
    return {"w": w.to(device), "b": b}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          activation: Optional[Callable] = None,
          dropout_mask: Optional[torch.Tensor] = None,
          keep_prob: float = 1.0) -> torch.Tensor:
    """y = act(x @ W.T + b), optionally masked per output unit.

    ``dropout_mask`` is a [out_dim] 0/1 vector shared across the batch —
    the reference's semantics of dropping output *units* for a whole
    minibatch (fullyconnLayer.h:96-104), not per-example noise."""
    y = x @ params["w"].T + params["b"]
    if activation is not None:
        y = activation(y)
    if dropout_mask is not None:
        y = y * dropout_mask / keep_prob
    return y


def init_stack(generator: torch.Generator, widths: Sequence[int],
               scale: Optional[str] = None, device="cpu") -> Dict[str, Dict]:
    """An MLP over consecutive ``widths`` (``[in, h1, ..., out]``): layers
    ``l0``, ``l1``, ... each as :func:`init`, drawn in that order."""
    return {f"l{i}": init(generator, a, b, scale=scale, device=device)
            for i, (a, b) in enumerate(zip(widths, widths[1:]))}


def apply_stack(params: Dict[str, Dict], x: torch.Tensor,
                activation: Callable = torch.relu,
                activate_last: bool = True) -> torch.Tensor:
    """The layers of :func:`init_stack` in order, ``activation`` after each
    (after all but the last with ``activate_last=False``)."""
    n = len(params)
    for i in range(n):
        last = i == n - 1
        x = apply(params[f"l{i}"], x,
                  activation=None if last and not activate_last
                  else activation)
    return x


def sample_dropout_mask(generator: torch.Generator, out_dim: int,
                        keep_prob: float) -> torch.Tensor:
    """Per-output-unit keep mask, re-sampled once per minibatch
    (fullyconnLayer.h:199-201), on the generator's device."""
    p = torch.full((out_dim,), float(keep_prob), dtype=torch.float32,
                   device=generator.device)
    return torch.bernoulli(p, generator=generator)
