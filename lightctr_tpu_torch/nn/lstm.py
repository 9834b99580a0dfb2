"""LSTM cell + sequence loop on tensors.

The port's counterpart of ``lightctr_tpu/nn/lstm.py`` (a redesign of
``train/unit/lstm_unit.h``): one fused [in + hidden, 4 * hidden] kernel,
gate order [i | f | g | o], as in the JAX package, so its weights carry
across as they are (``torch.nn.LSTM`` keeps separate input and hidden
matrices in the order i, f, g, o over [4H, in] and adds two biases).  The
JAX ``lax.scan`` over T is a Python loop; BPTT is autograd through it.

Gate math: i, f, o = sigmoid; g = tanh; c' = f*c + i*g; h = o * tanh(c').
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def init(generator: torch.Generator, in_dim: int, hidden: int,
         device="cpu") -> Dict[str, torch.Tensor]:
    """Fused kernel [in+hidden, 4*hidden] ~ U(-0.5,0.5)/sqrt(fan_in), zero
    bias."""
    fan_in = in_dim + hidden
    k = (torch.rand((fan_in, 4 * hidden), generator=generator,
                    dtype=torch.float32, device=generator.device) - 0.5) \
        / math.sqrt(float(fan_in))
    return {"kernel": k.to(device),
            "bias": torch.zeros((4 * hidden,), dtype=torch.float32,
                                device=device)}


def cell(params: Dict[str, torch.Tensor], x_t: torch.Tensor,
         state: Tuple[torch.Tensor, torch.Tensor]
         ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One step: ``x_t`` [B, in], ``state`` (h, c) [B, H] -> ((h', c'),
    h')."""
    h, c = state
    z = torch.cat([x_t, h], dim=-1) @ params["kernel"] + params["bias"]
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return (h_new, c_new), h_new


def apply_seq(params: Dict[str, torch.Tensor], xs: torch.Tensor
              ) -> torch.Tensor:
    """The cell over a [B, T, in] sequence; all hidden states [B, T, H]
    (the reference's ``seq_output()``, train_rnn_algo.h:66)."""
    b = xs.shape[0]
    hidden = params["kernel"].shape[1] // 4
    state = (xs.new_zeros((b, hidden)), xs.new_zeros((b, hidden)))
    hs = []
    for t in range(xs.shape[1]):
        state, h = cell(params, xs[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1)
