"""Factorization Machine on tensors.

The port's counterpart of ``lightctr_tpu/models/fm.py``: the same batch
layout (``fids [B, P]`` int, ``vals`` and ``mask`` ``[B, P]`` float) and
the same batched sumVX formulation of ``train_fm_algo.cpp:63-88``:

    vx      = V[fids] * vals[..., None]          # gather -> [B, P, k]
    sumvx   = sum_p vx                           # [B, k]
    pred    = W[fids]·vals + 0.5 * (|sumvx|^2 - sum_p |vx|^2)

Parameters are a plain dict ``{"w": [F], "v": [F, k]}`` of tensors;
:func:`params_from_numpy` carries the JAX package's params (as numpy) in,
and :func:`opt_state_from_numpy` its trainers' optimizer state.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from lightctr_tpu_torch.optim.updaters import AdagradState


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
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in np_params.items()}


def opt_state_from_numpy(np_state, device, rank: int = 0):
    """The JAX trainers' optimizer state (as numpy) -> the port's: an
    ``AdagradState`` (anything with an ``accum`` dict, ``CTRTrainer``'s
    state), the compressed ring's ``CompressedRingState`` (``inner`` and
    ``residual``), or the sparse trainer's ``{"dense": AdagradState,
    "accum": {table: [rows, ...]}}`` with, on a mesh, ``residual`` and
    ``sres``.  The JAX mesh state stacks one EF residual per rank
    (``[n, ...]``); rank ``rank`` takes its slice."""
    if hasattr(np_state, "inner") and hasattr(np_state, "residual"):
        from lightctr_tpu_torch.models.ctr_trainer import CompressedRingState

        return CompressedRingState(
            inner=opt_state_from_numpy(np_state.inner, device),
            residual=_tensor(np_state.residual[rank], device))
    if hasattr(np_state, "accum"):
        return AdagradState(accum=params_from_numpy(np_state.accum, device))
    if isinstance(np_state, dict) and {"dense", "accum"} <= set(np_state) \
            <= {"dense", "accum", "residual", "sres"}:
        out = {"dense": opt_state_from_numpy(np_state["dense"], device),
               "accum": params_from_numpy(np_state["accum"], device)}
        if "residual" in np_state:
            out["residual"] = _tensor(np_state["residual"][rank], device)
        if "sres" in np_state:
            out["sres"] = {k: _tensor(v[rank], device)
                           for k, v in np_state["sres"].items()}
        return out
    raise ValueError(f"not an Adagrad optimizer state: {type(np_state)}")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


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


def l2_penalty(params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 on the *touched* rows only, matching the reference which adds
    ``L2Reg_ratio * W[fid]`` per occurrence (train_fm_algo.cpp:108-115)
    rather than decaying the whole table."""
    mask = batch["mask"]
    fids = batch["fids"]
    flat = fids.reshape(-1)
    w = params["w"].index_select(0, flat).reshape(fids.shape)
    v = params["v"].index_select(0, flat).reshape(
        fids.shape + params["v"].shape[1:])
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
