"""Sequence classifier: LSTM + additive attention, on tensors.

The port's counterpart of ``lightctr_tpu/models/rnn.py`` (capability
parity with ``Train_RNN_Algo``, train_rnn_algo.h:34-90): a 28x28 image is
a 28-step sequence of 28-pixel rows through an LSTM (hidden 50), additive
attention (inner FC hidden 20) pools the hidden states, then FC(hidden ->
72, tanh) -> FC(72 -> classes).

The LSTM runs step by step from the host (``nn.lstm.apply_seq``), about
ten small launches a step: at the CLI's batch of 10 the host sets the
pace on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from lightctr_tpu_torch.nn import attention, dense, lstm


def init(generator: torch.Generator, seq_len: int = 28, in_dim: int = 28,
         hidden: int = 50, att_hidden: int = 20, fc_hidden: int = 72,
         n_classes: int = 10, device="cpu") -> Dict:
    return {
        "lstm": lstm.init(generator, in_dim, hidden, device=device),
        "att": attention.init(generator, hidden, att_hidden, device=device),
        "fc1": dense.init(generator, hidden, fc_hidden, device=device),
        "fc2": dense.init(generator, fc_hidden, n_classes, device=device),
    }


def logits(params: Dict, feats: torch.Tensor, seq_len: int = 28,
           in_dim: int = 28) -> torch.Tensor:
    xs = feats.reshape(-1, seq_len, in_dim)
    hs = lstm.apply_seq(params["lstm"], xs)            # [B, T, H]
    ctx = attention.apply(params["att"], hs)           # [B, H]
    h = dense.apply(params["fc1"], ctx, activation=torch.tanh)
    return dense.apply(params["fc2"], h)
