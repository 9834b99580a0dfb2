"""Wide & Deep CTR model on tensors — the reference's PS-mode distributed
model.

The port's counterpart of ``lightctr_tpu/models/widedeep.py``, with
capability parity with ``Distributed_Algo_Abst``
(``distributed_algo_abst.h:93-349``):

  wide  = W . x over sparse fids          (distributed_algo_abst.h:203-212)
  deep  = concat_f embedding[rep_fid(f)]  (one factor_dim vector per field,
          keyed by the FIRST fid seen in that field per row —
          distributed_algo_abst.h:210-226)
          -> FC_tanh(field_cnt*factor_dim -> 50) -> FC_sigmoid(50 -> 1)
          (distributed_algo_abst.h:116-118)
  pCTR  = sigmoid(wide + deep)            (distributed_algo_abst.h:233)

Every table gather goes through ``embed.table.lookup`` (its gradient the
slot-order ``merge_rows``, as for FM), so ``w`` and ``embed`` train with
XLA's order on the card.  ``field_representatives`` precomputes the
per-(row, field) representative fid on the host — data prep, not model
state (a copy of the JAX function, numpy only).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from lightctr_tpu_torch.embed.table import lookup
from lightctr_tpu_torch.nn import dense
from lightctr_tpu_torch.ops.activations import sigmoid


def field_representatives(
    fids: np.ndarray, fields: np.ndarray, mask: np.ndarray, field_cnt: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per row, the first active fid of each field (+ presence mask) —
    the reference's ``tensor_map`` construction (distributed_algo_abst.h:210-215).
    Returns (rep_fids [N, field_cnt] int32, rep_mask [N, field_cnt] f32).

    Vectorized over rows: sweep slots last-to-first so the FIRST occurrence's
    write wins — O(P) numpy scatters instead of an O(N*P) Python loop."""
    n, p = fids.shape
    rep = np.zeros((n, field_cnt), np.int32)
    rep_mask = np.zeros((n, field_cnt), np.float32)
    for j in range(p - 1, -1, -1):
        valid = (mask[:, j] > 0) & (fields[:, j] >= 0) & (fields[:, j] < field_cnt)
        rows = np.nonzero(valid)[0]
        f = fields[rows, j]
        rep[rows, f] = fids[rows, j]
        rep_mask[rows, f] = 1.0
    return rep, rep_mask


def init(generator: torch.Generator, feature_cnt: int, field_cnt: int,
         factor_dim: int, hidden: int = 50, device="cpu") -> Dict:
    """W zero; embed ~ N(0, 1/factor_dim) (the PS lazy-init,
    paramserver.h check_and_find); fc1 [hidden, field_cnt*factor_dim] and
    fc2 [1, hidden] as ``dense.init``.  Drawn in that order from
    ``generator`` on its device, moved to ``device``."""
    embed = torch.randn((feature_cnt, factor_dim), generator=generator,
                        dtype=torch.float32, device=generator.device)
    return {
        "w": torch.zeros((feature_cnt,), dtype=torch.float32, device=device),
        "embed": (embed / math.sqrt(float(factor_dim))).to(device),
        "fc1": dense.init(generator, field_cnt * factor_dim, hidden,
                          device=device),
        "fc2": dense.init(generator, hidden, 1, device=device),
    }


def logits(params: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    vals = batch["vals"] * batch["mask"]
    w = lookup(params["w"], batch["fids"])
    wide = torch.sum(w * vals, dim=-1)

    emb = lookup(params["embed"], batch["rep_fids"])             # [B, Fl, D]
    emb = emb * batch["rep_mask"][..., None]                     # absent -> 0
    deep_in = emb.reshape(emb.shape[0], -1)                      # [B, Fl*D]
    h = dense.apply(params["fc1"], deep_in, activation=torch.tanh)
    deep = dense.apply(params["fc2"], h, activation=sigmoid)[:, 0]
    return wide + deep


def make_batch(ds, rep_fids: np.ndarray, rep_mask: np.ndarray
               ) -> Dict[str, np.ndarray]:
    b = ds.batch_dict()
    b["rep_fids"] = rep_fids
    b["rep_mask"] = rep_mask
    return b
