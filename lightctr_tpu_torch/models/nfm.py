"""Neural Factorization Machine (wide + deep) on tensors.

The port's counterpart of ``lightctr_tpu/models/nfm.py``, with capability
parity with ``Train_NFM_Algo`` (``train/train_nfm_algo.{h,cpp}``):

  wide    = W . x                                  (train_nfm_algo.cpp:84-85)
  bi      = 0.5 * [(sum_i v_i x_i)^2 - sum_i (v_i x_i)^2]   in R^k
            (the bi-interaction pooling, train_nfm_algo.cpp:86-95)
  deep    = FC_sigmoid(k -> hidden) -> FC_sigmoid(hidden -> 1)
            (train_nfm_algo.cpp:22-27)
  logit   = wide + deep                            (train_nfm_algo.cpp:100-104)

Both table gathers go through ``embed.table.lookup`` (slot-order gradient
sums, ``merge_rows`` on the card); the two layers are ``nn.dense``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from lightctr_tpu_torch.embed.table import lookup
from lightctr_tpu_torch.models.fm import l2_penalty as fm_l2_penalty
from lightctr_tpu_torch.nn import dense
from lightctr_tpu_torch.ops.activations import sigmoid


def init(generator: torch.Generator, feature_cnt: int, factor_cnt: int,
         hidden: int, device="cpu") -> Dict:
    """W zero; V [F, k] ~ N(0, 1/k); fc1 [hidden, k] and fc2 [1, hidden]
    as ``dense.init``.  Drawn in that order from ``generator`` on its
    device, moved to ``device``."""
    v = torch.randn((feature_cnt, factor_cnt), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return {
        "w": torch.zeros((feature_cnt,), dtype=torch.float32, device=device),
        "v": (v / math.sqrt(float(factor_cnt))).to(device),
        "fc1": dense.init(generator, factor_cnt, hidden, device=device),
        "fc2": dense.init(generator, hidden, 1, device=device),
    }


def _bi_pool(vx: torch.Tensor) -> torch.Tensor:
    """0.5[(sum vx)^2 - sum (vx)^2] over the nnz axis."""
    sumvx = torch.sum(vx, dim=1)                                 # [B, k]
    return 0.5 * (sumvx * sumvx - torch.sum(vx * vx, dim=1))


def bi_interaction(params: Dict, batch: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """NFM pooling vector in R^k."""
    vals = batch["vals"] * batch["mask"]
    v = lookup(params["v"], batch["fids"])                       # [B, P, k]
    return _bi_pool(v * vals[..., None])


def logits(params: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return logits_with_l2(params, batch)[0]


def logits_with_l2(params: Dict, batch: Dict[str, torch.Tensor]):
    """Forward plus touched-row L2 from the same gathers."""
    mask = batch["mask"]
    vals = batch["vals"] * mask
    w = lookup(params["w"], batch["fids"])
    wide = torch.sum(w * vals, dim=-1)                           # [B]
    v = lookup(params["v"], batch["fids"])                       # [B, P, k]
    bi = _bi_pool(v * vals[..., None])
    h = dense.apply(params["fc1"], bi, activation=sigmoid)
    deep = dense.apply(params["fc2"], h, activation=sigmoid)[:, 0]
    l2 = 0.5 * (torch.sum(w * w * mask) + torch.sum(v * v * mask[..., None]))
    return wide + deep, l2


# the same touched-row L2 over the same ("w" [F], "v" [F, k]) leaves
l2_penalty = fm_l2_penalty
