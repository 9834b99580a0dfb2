"""DLRM with a DCN-v2 interaction (DLRM-DCNv2) on tensors: the model of
MLPerf Training's recommendation benchmark (mlcommons/training
``recommendation_v2/torchrec_dlrm``, TorchRec's ``DLRM_DCN``; DLRM,
arXiv:1906.00091; DCN-V2's low-rank cross, arXiv:2008.13535 §3).

    d        = bottom(dense)                     13 -> 512 -> 256 -> D, ReLU
                                                 after every layer
    e_f      = sum of embed[bag_ids[s]] over     each of F features' fixed
               the slots s of feature f's bag    bag of slots, sum-pooled
    x0       = [d; e_1; ...; e_F]                (F + 1) * D
    x_{l+1}  = x0 * (W_l (V_l x_l) + b_l) + x_l  L low-rank crosses: V_l
                                                 [r, n] without bias, W_l
                                                 [n, r] with bias b_l
    logit    = top(x_L)                          -> 1024 -> 1024 -> 512 ->
                                                 256, ReLU, then -> 1

The batch: ``bag_ids`` [B, sum(bag sizes)] int, each feature's bag in a
fixed range of slots, in feature order, all features in one table with a
range of rows each; ``dense`` [B, 13] float (log1p of the numeric
features, DLRM's preprocessing); ``labels``.  The bag sizes are static:
:func:`make_logits` closes over them, so no optimizer sees them.  The
pool is :func:`~lightctr_tpu_torch.embed.table.pooled_lookup` (the
table's gradient is ``lookup``'s slot-order merge), the products are
``nn.dense`` on cuBLAS.  It trains through ``SparseTableCTRTrainer(...,
sparse_tables={"embed": ["bag_ids"]})``.

The initialisers are TorchRec's modules': each feature's rows ~ U(-1, 1)
* sqrt(1 / the feature's rows in the deployment), the MLPs ``torch.nn.Linear``'s default
(``dense.init(scale="linear")``), the cross's V and W xavier-normal and
its bias zero.

Spans (``utils.profiling.annotate``), inside the trainer's
``trainer/forward``: ``embed/bag_pool`` (the pooled lookup),
``dlrm/bottom``, ``dlrm/cross`` and ``dlrm/top``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from lightctr_tpu_torch.embed.table import Bags, pooled_lookup
from lightctr_tpu_torch.nn import dense
from lightctr_tpu_torch.utils.profiling import annotate

#: MLPerf's widths (``--dense_arch_layer_sizes 512,256,128``,
#: ``--over_arch_layer_sizes 1024,1024,512,256,1``): the bottom MLP's
#: hidden layers (its last width is the embedding's), the top MLP's
#: hidden layers (a linear layer to the logit follows)
BOTTOM = (512, 256)
TOP = (1024, 1024, 512, 256)


def init(generator: torch.Generator, feature_rows: Sequence[int], dim: int,
         dense_in: int = 13, bottom: Sequence[int] = BOTTOM,
         top: Sequence[int] = TOP, n_cross: int = 3, rank: int = 512,
         num_embeddings: Optional[Sequence[int]] = None,
         device="cpu") -> Dict:
    """The parameters, drawn in this order from ``generator`` on its
    device and moved to ``device``: ``embed`` [sum(feature_rows), dim],
    feature ``f``'s rows ~ U(-1, 1) * sqrt(1 / num_embeddings[f]) (the
    feature's rows in the deployment; ``feature_rows`` by default);
    ``bottom`` (``dense_in`` -> ``bottom`` -> ``dim``); ``cross`` layers
    ``l0`` ... with ``V`` [rank, n] and ``W`` [n, rank] xavier-normal and
    ``b`` [n] zero, n = (F + 1) * dim; ``top`` (n -> ``top`` -> 1)."""
    rows = [int(r) for r in feature_rows]
    ne = [int(r) for r in (num_embeddings or rows)]
    if len(ne) != len(rows):
        raise ValueError(f"{len(ne)} embedding counts for {len(rows)} "
                         "features")
    gdev = generator.device
    bound = torch.repeat_interleave(
        torch.tensor([math.sqrt(1.0 / n) for n in ne], dtype=torch.float32,
                     device=gdev),
        torch.tensor(rows, device=gdev))
    embed = torch.rand((sum(rows), dim), generator=generator,
                       dtype=torch.float32, device=gdev)
    embed.mul_(2.0).sub_(1.0).mul_(bound[:, None])
    n = (len(rows) + 1) * dim
    params = {"embed": embed.to(device),
              "bottom": dense.init_stack(generator,
                                         [dense_in, *bottom, dim],
                                         scale="linear", device=device)}
    std = math.sqrt(2.0 / (n + rank))
    cross = {}
    for i in range(n_cross):
        v = torch.randn((rank, n), generator=generator, dtype=torch.float32,
                        device=gdev) * std
        w = torch.randn((n, rank), generator=generator, dtype=torch.float32,
                        device=gdev) * std
        cross[f"l{i}"] = {"V": v.to(device), "W": w.to(device),
                          "b": torch.zeros((n,), dtype=torch.float32,
                                           device=device)}
    params["cross"] = cross
    params["top"] = dense.init_stack(generator, [n, *top, 1],
                                     scale="linear", device=device)
    return params


def cross_network(x0: torch.Tensor, cross: Dict[str, Dict]) -> torch.Tensor:
    """The low-rank crosses ``x_{l+1} = x0 * (x_l V^T W^T + b) + x_l``
    over ``x0`` [B, n], layers ``l0``, ``l1``, ... in order."""
    x = x0
    for i in range(len(cross)):
        layer = cross[f"l{i}"]
        x = x0 * ((x @ layer["V"].T) @ layer["W"].T + layer["b"]) + x
    return x


def make_logits(bag_sizes: Sequence[int]):
    """A ``logits(params, batch)`` closure over the static bag sizes (one
    a feature, in the order of ``bag_ids``' slot ranges)."""
    bags = Bags(bag_sizes)

    def logits(params: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with annotate("dlrm/bottom"):
            d = dense.apply_stack(params["bottom"], batch["dense"])
        e = pooled_lookup(params["embed"], batch["bag_ids"], bags)
        x0 = torch.cat([d[:, None, :], e], dim=1).reshape(d.shape[0], -1)
        with annotate("dlrm/cross"):
            x = cross_network(x0, params["cross"])
        with annotate("dlrm/top"):
            return dense.apply_stack(params["top"], x,
                                     activate_last=False)[:, 0]

    return logits
