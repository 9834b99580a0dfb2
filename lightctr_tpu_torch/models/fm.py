"""Factorization Machine on tensors.

The port's counterpart of ``lightctr_tpu/models/fm.py``: the same batch
layout (``fids [B, P]`` int, ``vals`` and ``mask`` ``[B, P]`` float) and
the same batched sumVX formulation of ``train_fm_algo.cpp:63-88``:

    vx      = V[fids] * vals[..., None]          # gather -> [B, P, k]
    sumvx   = sum_p vx                           # [B, k]
    pred    = W[fids]·vals + 0.5 * (|sumvx|^2 - sum_p |vx|^2)

Every gather of a table goes through ``embed.table.lookup``, whose
gradient sums duplicate ids in slot order (``merge_rows`` on the card), so
a step's gradient is the same from run to run and in XLA's order.

Parameters are a plain dict ``{"w": [F], "v": [F, k]}`` of tensors;
:func:`params_from_numpy` carries the JAX package's params (as numpy) in,
and :func:`opt_state_from_numpy` its trainers' optimizer state (both
shared with the rest of the model family, ``models/_common.py``).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from lightctr_tpu_torch.embed.table import lookup
from lightctr_tpu_torch.models._common import (  # noqa: F401 (re-exported)
    opt_state_from_numpy,
    params_from_numpy,
)


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
    w = lookup(params["w"], fids)                                # [B, P]
    linear = torch.sum(w * vals, dim=-1)                         # [B]
    v = lookup(params["v"], fids)                                # [B, P, k]
    vx = v * vals[..., None]                                     # [B, P, k]
    sumvx = torch.sum(vx, dim=1)                                 # [B, k]
    second = 0.5 * (
        torch.sum(sumvx * sumvx, dim=-1) - torch.sum(vx * vx, dim=(1, 2))
    )
    l2 = 0.5 * (torch.sum(w * w * mask) + torch.sum(v * v * mask[..., None]))
    return linear + second, l2


def l2_penalty(params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 on the *touched* rows only, matching the reference which adds
    ``L2Reg_ratio * W[fid]`` per occurrence (train_fm_algo.cpp:108-115)
    rather than decaying the whole table."""
    mask = batch["mask"]
    w = lookup(params["w"], batch["fids"])
    v = lookup(params["v"], batch["fids"])
    return 0.5 * (torch.sum(w * w * mask)
                  + torch.sum(v * v * mask[..., None]))


def densify(arrays: Dict, feature_cnt: int) -> Dict:
    """Host-side one-time densification of a (small-vocab) sparse batch
    into numpy ``x``, ``x2``, ``cnt`` and ``labels`` (the JAX package's
    ``fm.densify``, see there for the exact-parity construction):

      x[i,f]   = sum of vals over slots with that fid
      x2[i,f]  = sum of vals^2 over slots (the per-slot self-interaction)
      cnt[f]   = number of touched slots (per-occurrence L2)

    Memory: 2 * B * F floats — the caller's job to check it fits."""
    fids = np.asarray(arrays["fids"])
    vals = np.asarray(arrays["vals"]) * np.asarray(arrays["mask"])
    mask = np.asarray(arrays["mask"]) > 0
    if mask.any():
        lo, hi = fids[mask].min(), fids[mask].max()
        if lo < 0 or hi >= feature_cnt:
            raise ValueError(
                f"fid out of range [{lo}, {hi}] for feature_cnt="
                f"{feature_cnt}; negative/overflow ids would scatter into "
                "the wrong dense column")
    n, p = fids.shape
    x = np.zeros((n, feature_cnt), np.float32)
    x2 = np.zeros((n, feature_cnt), np.float32)
    cnt = np.zeros((feature_cnt,), np.float32)
    rows = np.broadcast_to(np.arange(n)[:, None], (n, p))
    np.add.at(x, (rows[mask], fids[mask]), vals[mask])
    np.add.at(x2, (rows[mask], fids[mask]), vals[mask] ** 2)
    np.add.at(cnt, fids[mask], 1.0)
    return {"x": x, "x2": x2, "cnt": cnt,
            "labels": np.asarray(arrays["labels"])}


def dense_logits(params: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return dense_logits_with_l2(params, batch)[0]


def dense_logits_with_l2(params: Dict[str, torch.Tensor],
                         batch: Dict[str, torch.Tensor]):
    """Matmul formulation of :func:`logits_with_l2` over a densified batch:
    z = x @ w + 0.5 * (|x @ V|^2 - x2 @ (V*V) summed)."""
    w, v = params["w"], params["v"]
    linear = batch["x"] @ w                                   # [B]
    sumvx = batch["x"] @ v                                    # [B, k]
    self_term = batch["x2"] @ (v * v)                         # [B, k]
    second = 0.5 * (torch.sum(sumvx * sumvx, -1) - torch.sum(self_term, -1))
    l2 = 0.5 * (batch["cnt"] @ (w * w) + batch["cnt"] @ torch.sum(v * v, -1))
    return linear + second, l2
