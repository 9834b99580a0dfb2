"""Additive attention over a sequence, on tensors.

The port's counterpart of ``lightctr_tpu/nn/attention.py`` (a redesign of
``train/unit/attention_unit.h``): per step h_t -> FC(D -> fc_hidden) ->
act -> FC(fc_hidden -> 1) (attention_unit.h:40-59), softmax over the T
scores, context = sum_t alpha_t * h_t (attention_unit.h:60-75).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from lightctr_tpu_torch.nn import dense


def init(generator: torch.Generator, dim: int, fc_hidden: int,
         device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    return {"score1": dense.init(generator, dim, fc_hidden, device=device),
            "score2": dense.init(generator, fc_hidden, 1, device=device)}


def apply(params: Dict[str, Dict[str, torch.Tensor]], hs: torch.Tensor,
          activation: Callable = torch.tanh) -> torch.Tensor:
    """[B, T, D] -> the context vector [B, D]."""
    s = dense.apply(params["score1"], hs, activation=activation)  # [B, T, H]
    s = dense.apply(params["score2"], s)[..., 0]                  # [B, T]
    alpha = torch.softmax(s, dim=-1)
    return torch.einsum("bt,btd->bd", alpha, hs)
