"""Factorization Machine on tensors.

The port's counterpart of ``lightctr_tpu/models/fm.py``: the same batch
layout (``fids [B, P]`` int, ``vals`` and ``mask`` ``[B, P]`` float) and
the same batched sumVX formulation of ``train_fm_algo.cpp:63-88``:

    vx      = V[fids] * vals[..., None]          # gather -> [B, P, k]
    sumvx   = sum_p vx                           # [B, k]
    pred    = W[fids]·vals + 0.5 * (|sumvx|^2 - sum_p |vx|^2)

Parameters are a plain dict ``{"w": [F], "v": [F, k]}`` of tensors;
:func:`params_from_numpy` carries the JAX package's params (as numpy) in.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def init(generator: torch.Generator, feature_cnt: int, factor_cnt: int,
         device="cpu") -> Dict[str, torch.Tensor]:
    """W zero-init, V ~ N(0, 1/k) (fm_algo_abst.h:53-67), drawn from
    ``generator`` on its own device and moved to ``device``."""
    v = torch.randn((feature_cnt, factor_cnt), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return {
        "w": torch.zeros((feature_cnt,), dtype=torch.float32, device=device),
        "v": (v / math.sqrt(float(factor_cnt))).to(device),
    }


def params_from_numpy(np_params: Dict, device) -> Dict[str, torch.Tensor]:
    """``{"w": [F], "v": [F, k]}`` numpy arrays (e.g. the JAX package's
    params through ``np.asarray``) -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in np_params.items()}


def logits(params: Dict[str, torch.Tensor],
           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Batched sumVX forward (train_fm_algo.cpp:63-88)."""
    return logits_with_l2(params, batch)[0]


def logits_with_l2(params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]):
    """Forward plus the touched-row L2 penalty from the SAME gathers."""
    mask = batch["mask"]
    vals = batch["vals"] * mask                                  # [B, P]
    fids = batch["fids"]
    flat = fids.reshape(-1)
    w = params["w"].index_select(0, flat).reshape(fids.shape)   # [B, P]
    linear = torch.sum(w * vals, dim=-1)                         # [B]
    v = params["v"].index_select(0, flat).reshape(
        fids.shape + params["v"].shape[1:])                      # [B, P, k]
    vx = v * vals[..., None]                                     # [B, P, k]
    sumvx = torch.sum(vx, dim=1)                                 # [B, k]
    second = 0.5 * (
        torch.sum(sumvx * sumvx, dim=-1) - torch.sum(vx * vx, dim=(1, 2))
    )
    l2 = 0.5 * (torch.sum(w * w * mask) + torch.sum(v * v * mask[..., None]))
    return linear + second, l2
