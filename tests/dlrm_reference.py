"""Plain PyTorch reference of DLRM-DCNv2 (DLRM, arXiv:1906.00091, with
DCN-V2's low-rank cross, arXiv:2008.13535 §3), as MLPerf Training's
recommendation benchmark defines it (mlcommons/training
``recommendation_v2/torchrec_dlrm``, TorchRec's ``DLRM_DCN``), trained
by Adagrad.  Float32 with TF32 off; nothing of the port is imported.

    d        = relu stack(dense)                 bottom: 13 -> ... -> D
    e_f      = sum over feature f's bag of its embedding rows
    x0       = [d; e_1; ...; e_F]
    x_{l+1}  = x0 * (W_l (V_l x_l) + b_l) + x_l
    z        = top(x_L): ReLU after every layer but the last (-> 1)
    loss     = mean over rows of softplus(z) - y z

Parameters are flat: ``embed`` (every feature's rows, a range each),
``bottom/l<i>/w|b``, ``cross/l<i>/V|W|b``, ``top/l<i>/w|b``; a dense
weight is [out, in], as ``torch.nn.Linear`` holds it.

Departures from the published training, each deliberate (the port's
trainer): element-wise Adagrad, also on the tables (MLPerf uses FBGEMM's
row-wise Adagrad on them); epsilon 1e-7 inside the square root; no
initial accumulator; no warm-up or decay of the rate; one table with a
range of rows a feature in place of 26 tables.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the reference's modes: itself, and its products in TF32
MODES = ("exact", "tf32")


def init_params(gen: torch.Generator, feature_rows: Sequence[int],
                dim: int, dense_in: int = 13,
                bottom: Sequence[int] = (512, 256),
                top: Sequence[int] = (1024, 1024, 512, 256),
                n_cross: int = 3, rank: int = 512,
                num_embeddings: Sequence[int] = None) -> Dict:
    """TorchRec's initialisers, drawn in this order from ``gen``: each
    feature's rows U(-a, a), a = sqrt(1 / num_embeddings of the feature)
    (``EmbeddingBagCollection``); each MLP layer as ``torch.nn.Linear``
    resets itself (kaiming-uniform weight with a = sqrt(5), bias
    U(-1, 1) / sqrt(fan_in)); each cross layer's V then W xavier-normal,
    its bias zero (``LowRankCrossNet``)."""
    dev = gen.device
    num_embeddings = list(num_embeddings or feature_rows)
    blocks = []
    for rows, n in zip(feature_rows, num_embeddings):
        a = math.sqrt(1.0 / n)
        blocks.append(torch.nn.init.uniform_(
            torch.empty((rows, dim), device=dev), -a, a, generator=gen))
    out = {"embed": torch.cat(blocks)}

    def linear(prefix, n_in, n_out):
        w = torch.empty((n_out, n_in), device=dev)
        torch.nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=gen)
        bound = 1.0 / math.sqrt(n_in)
        out[f"{prefix}/w"] = w
        out[f"{prefix}/b"] = torch.nn.init.uniform_(
            torch.empty(n_out, device=dev), -bound, bound, generator=gen)

    widths = [dense_in, *bottom, dim]
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        linear(f"bottom/l{i}", a, b)
    n = (len(feature_rows) + 1) * dim
    for i in range(n_cross):
        out[f"cross/l{i}/V"] = torch.nn.init.xavier_normal_(
            torch.empty((rank, n), device=dev), generator=gen)
        out[f"cross/l{i}/W"] = torch.nn.init.xavier_normal_(
            torch.empty((n, rank), device=dev), generator=gen)
        out[f"cross/l{i}/b"] = torch.zeros(n, device=dev)
    widths = [n, *top, 1]
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        linear(f"top/l{i}", a, b)
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (to nearest, ties to
    even), as the tensor cores round a product's inputs."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with its inputs rounded to TF32, forward and backward,
    summed in float32: what cuBLAS does with TF32 allowed."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.T, a.T @ g


def _mm(a, b, mode):
    return _TF32MatMul.apply(a, b) if mode == "tf32" else a @ b


def _layers(params, prefix):
    """The layer numbers under ``prefix``, in order."""
    i = 0
    while f"{prefix}/l{i}/b" in params:
        yield i
        i += 1


def forward(params: Dict, rows: torch.Tensor, pos: torch.Tensor,
            dense: torch.Tensor, bag_sizes: Sequence[int],
            mode: str = "exact") -> torch.Tensor:
    """Logits [B]: ``rows`` [U, D] are the table's rows the batch touches
    and ``pos`` [B, S] each slot's row among them."""
    emb = rows[pos]                                        # [B, S, D]
    pooled, s = [], 0
    for size in bag_sizes:
        pooled.append(emb[:, s:s + size].sum(dim=1))
        s += size
    x = dense
    for i in _layers(params, "bottom"):
        x = torch.relu(_mm(x, params[f"bottom/l{i}/w"].T, mode)
                       + params[f"bottom/l{i}/b"])
    x0 = torch.cat([x] + pooled, dim=1)
    x = x0
    for i in _layers(params, "cross"):
        v = _mm(x, params[f"cross/l{i}/V"].T, mode)
        x = x0 * (_mm(v, params[f"cross/l{i}/W"].T, mode)
                  + params[f"cross/l{i}/b"]) + x
    top = list(_layers(params, "top"))
    for i in top:
        x = _mm(x, params[f"top/l{i}/w"].T, mode) + params[f"top/l{i}/b"]
        if i != top[-1]:
            x = torch.relu(x)
    return x[:, 0]


def logistic_loss(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean binary cross-entropy on logits."""
    return (torch.nn.functional.softplus(z) - labels * z).mean()


def loss_and_grads(params: Dict, batch: Dict, bag_sizes: Sequence[int],
                   mode: str = "exact"):
    """(loss, logits, {leaf: gradient}, touched row ids): the table's
    gradient is the touched rows' alone ([U, D], autograd through
    ``index_select`` of those rows), in the order of the row ids."""
    ids = batch["bag_ids"].to(torch.int64)
    uids, pos = torch.unique(ids, return_inverse=True)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items() if k != "embed"}
    rows = params["embed"].detach().index_select(0, uids).requires_grad_(
        True)
    z = forward(leaves, rows, pos, batch["dense"], bag_sizes, mode)
    loss = logistic_loss(z, batch["labels"])
    g = torch.autograd.grad(loss, [rows] + list(leaves.values()))
    grads = {"embed": g[0], **dict(zip(leaves, g[1:]))}
    return loss.detach(), z.detach(), grads, uids


def steps(params0: Dict, batches: List[Dict], bag_sizes: Sequence[int],
          lr: float, eps: float = 1e-7, mode: str = "exact") -> Dict:
    """``len(batches)`` Adagrad steps from ``params0``: accum += g^2, p -=
    lr g / sqrt(accum + eps); the table at its touched rows only
    (``index_add_`` of the rows' changes).  Returns the losses, the
    gradients and accumulators after the first step and the parameters
    and accumulators after the last."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    params = {k: v.detach().clone() for k, v in params0.items()}
    accum = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"losses": [], "grads1": None, "accum1": None}
    for i, batch in enumerate(batches):
        loss, _, grads, uids = loss_and_grads(params, batch, bag_sizes, mode)
        out["losses"].append(float(loss))
        with torch.no_grad():
            for k, g in grads.items():
                if k == "embed":
                    a = accum[k].index_select(0, uids) + g * g
                    accum[k].index_add_(0, uids, g * g)
                    params[k].index_add_(0, uids, -lr * g * torch.rsqrt(
                        a + eps))
                else:
                    accum[k] += g * g
                    params[k] -= lr * g * torch.rsqrt(accum[k] + eps)
        if i == 0:
            out["grads1"] = grads
            out["accum1"] = {k: v.clone() for k, v in accum.items()}
    out["params"] = params
    out["accum"] = accum
    return out
