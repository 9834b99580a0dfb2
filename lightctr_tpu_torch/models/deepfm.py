"""DeepFM and DCN (cross network) on tensors.

The port's counterpart of ``lightctr_tpu/models/deepfm.py``: the next
members of the CTR family after Wide&Deep, built from the same pieces
(per-field embeddings of Wide&Deep's ``rep_fids`` path, FM pairwise
pooling, the dense MLP).

DeepFM (Guo et al. 2017): one shared embedding table feeds BOTH the FM
second-order term and the deep MLP:

    wide  = W . x
    fm    = 0.5 sum_k [(sum_f e_f)^2 - sum_f e_f^2]   over field embeddings
    deep  = MLP(concat_f e_f)
    logit = wide + fm + deep

DCN-v1 cross network (Wang et al. 2017): explicit bounded-degree feature
crosses on the embedding concat x0:

    x_{l+1} = x0 * (x_l . w_l) + b_l + x_l       (one rank-1 cross per layer)
    logit   = [x_L ; MLP(x0)] . w_out

Both use the Wide&Deep batch layout (``fids/vals/mask`` + per-field
``rep_fids/rep_mask``), so ``widedeep.field_representatives`` is the shared
data prep and the O(touched) sparse trainer composes the same way
(DeepFM: ``sparse_tables={"w": ["fids"], "embed": ["rep_fids"]}``;
DCN has no wide table, so ``{"embed": ["rep_fids"]}``).  Every table
gather goes through ``embed.table.lookup``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from lightctr_tpu_torch.embed.table import lookup
from lightctr_tpu_torch.models import widedeep as _widedeep
from lightctr_tpu_torch.nn import dense
from lightctr_tpu_torch.ops.activations import sigmoid

# ---------------------------------------------------------------------------
# DeepFM

# identical parameter tree (w / embed / fc1 / fc2) and initializers — the
# models differ only in how the pieces combine, so init is shared
init = _widedeep.init


def _field_embeddings(params: Dict, batch: Dict) -> torch.Tensor:
    """[B, Fl, D] per-field embedding vectors, absent fields zeroed."""
    emb = lookup(params["embed"], batch["rep_fids"])
    return emb * batch["rep_mask"][..., None]


def logits(params: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return logits_with_l2(params, batch)[0]


def logits_with_l2(params: Dict, batch: Dict[str, torch.Tensor]):
    """Forward plus the touched-row L2 (wide weights + field embeddings)
    from the same gathers — the CTR-family regularization convention."""
    vals = batch["vals"] * batch["mask"]
    w = lookup(params["w"], batch["fids"])
    wide = torch.sum(w * vals, dim=-1)

    emb = _field_embeddings(params, batch)                     # [B, Fl, D]
    s = torch.sum(emb, dim=1)                                  # [B, D]
    fm = 0.5 * torch.sum(s * s - torch.sum(emb * emb, dim=1), dim=-1)

    deep_in = emb.reshape(emb.shape[0], -1)
    h = dense.apply(params["fc1"], deep_in, activation=torch.tanh)
    deep = dense.apply(params["fc2"], h, activation=sigmoid)[:, 0]
    l2 = 0.5 * (torch.sum(w * w * batch["mask"]) + torch.sum(emb * emb))
    return wide + fm + deep, l2


# ---------------------------------------------------------------------------
# DCN


def dcn_init(generator: torch.Generator, feature_cnt: int, field_cnt: int,
             factor_dim: int, n_cross: int = 3, hidden: int = 50,
             device="cpu") -> Dict:
    """embed ~ N(0, 1/factor_dim); cross_w [n_cross, d] ~ N(0, 1/d),
    cross_b zeros (d = field_cnt * factor_dim); fc1 [hidden, d] and out
    [1, d + hidden] as ``dense.init``.  Drawn in that order from
    ``generator`` on its device, moved to ``device``."""
    d = field_cnt * factor_dim
    gdev = generator.device
    embed = torch.randn((feature_cnt, factor_dim), generator=generator,
                        dtype=torch.float32, device=gdev)
    cross_w = torch.randn((n_cross, d), generator=generator,
                          dtype=torch.float32, device=gdev)
    return {
        "embed": (embed / math.sqrt(float(factor_dim))).to(device),
        "cross_w": (cross_w / math.sqrt(float(d))).to(device),
        "cross_b": torch.zeros((n_cross, d), dtype=torch.float32,
                               device=device),
        "fc1": dense.init(generator, d, hidden, device=device),
        "out": dense.init(generator, d + hidden, 1, device=device),
    }


def cross_network(x0: torch.Tensor, cross_w: torch.Tensor,
                  cross_b: torch.Tensor) -> torch.Tensor:
    """L stacked rank-1 crosses: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l.
    ``cross_w``/``cross_b``: [L, d].  The JAX package scans over the L
    rows; here a loop over them (each ``x_l . w_l`` a matrix-vector
    product, reduced in PyTorch's order)."""
    x = x0
    for w, b in zip(cross_w, cross_b):
        x = x0 * (x @ w)[:, None] + b[None, :] + x
    return x


def dcn_logits(params: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return dcn_logits_with_l2(params, batch)[0]


def dcn_logits_with_l2(params: Dict, batch: Dict[str, torch.Tensor]):
    emb = _field_embeddings(params, batch)
    x0 = emb.reshape(emb.shape[0], -1)                         # [B, d]
    x = cross_network(x0, params["cross_w"], params["cross_b"])
    h = dense.apply(params["fc1"], x0, activation=torch.tanh)
    combo = torch.cat([x, h], dim=-1)
    l2 = 0.5 * torch.sum(emb * emb)
    return dense.apply(params["out"], combo)[:, 0], l2
