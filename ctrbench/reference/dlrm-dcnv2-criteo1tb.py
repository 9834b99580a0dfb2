"""Plain PyTorch reference of ``dlrm-dcnv2-criteo1tb``: DLRM with a
DCN-v2 interaction (DLRM, arXiv:1906.00091; DCN-V2's low-rank cross,
arXiv:2008.13535 §3) as MLPerf Training's recommendation benchmark
defines it (mlcommons/training ``recommendation_v2/torchrec_dlrm``,
TorchRec's ``DLRM_DCN``), trained by Adagrad.  The benchmark's copy of
``tests/dlrm_reference.py``, with the rows of the harness's pool made
into the model's batch here.

    d        = relu stack(log1p(numeric values))   13 -> 512 -> 256 -> 128
    e_f      = sum over feature f's bag of its embedding rows
    x0       = [d; e_1; ...; e_26]                  3,456
    x_{l+1}  = x0 * (W_l (V_l x_l) + b_l) + x_l     3 layers, rank 512
    z        = top(x_3)   -> 1024 -> 1024 -> 512 -> 256, ReLU, then -> 1
    loss     = mean over rows of softplus(z) - y z

Each feature's bag: its one-hot id first, then a fixed hash of (the id's
row in its feature, the slot) into the same feature's rows (the
configuration's ``assumed.multi_hot``), worked out here from ``fids``.
The gradient of the table is its touched rows' alone (autograd through
``index_select`` of those rows), applied with ``index_add_``: no
table-sized gradient is ever made.  In the "control" mode the products
run in TF32.

Departures from the published training (the configuration's
``departures``): element-wise Adagrad with epsilon 1e-7 inside the square
root and no initial accumulator, also on the table (MLPerf: FBGEMM's
row-wise Adagrad); no warm-up or decay; one table with a range of rows a
feature in place of 26 tables.
"""

import math

import torch

from ctrbench import generate
from ctrbench.reference import common

#: the bag hash's modulus (a prime) and multipliers
M = 2 ** 31 - 1
HASH_ROW, HASH_SLOT, LEHMER = 2_654_435_761, 40_503, 48_271


def _dims(cfg):
    layout, net = cfg["layout"], cfg["dlrm"]
    d = int(cfg["factor_dim"])
    return {"d": d, "n_cat": int(layout["categorical"]),
            "n_num": int(layout["fields"]) - int(layout["categorical"]),
            "bags": [int(s) for s in layout["multi_hot_sizes"]],
            "bottom": [int(w) for w in net["bottom_hidden"]],
            "top": [int(w) for w in net["top_hidden"]],
            "cross": int(net["cross_layers"]), "rank": int(net["cross_rank"]),
            "n": (int(layout["categorical"]) + 1) * d}


def feature_rows(cfg):
    """Each feature's rows in the table, as the generator lays them out
    (its range of the vocabulary before the numeric rows)."""
    dm = _dims(cfg)
    counts = [int(c) for c in cfg["layout"]["num_embeddings_per_feature"]]
    return generate.field_rows(counts, int(cfg["vocab"]) - dm["n_num"])


def init_params(gen: torch.Generator, cfg) -> dict:
    """TorchRec's initialisers, drawn in this order on the generator's
    device: each feature's rows U(-a, a), a = sqrt(1 / its
    ``num_embeddings_per_feature``), the rows past the features zero;
    each MLP layer as ``torch.nn.Linear`` resets itself; each cross
    layer's V then W xavier-normal, its bias zero."""
    dm = _dims(cfg)
    dev = gen.device
    counts = cfg["layout"]["num_embeddings_per_feature"]
    embed = torch.zeros((int(cfg["vocab"]), dm["d"]), device=dev)
    lo = 0
    for rows, n in zip(feature_rows(cfg), counts):
        a = math.sqrt(1.0 / int(n))
        embed[lo:lo + rows].uniform_(-a, a, generator=gen)
        lo += rows
    out = {"embed": embed}

    def linear(prefix, n_in, n_out):
        w = torch.empty((n_out, n_in), device=dev)
        torch.nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=gen)
        bound = 1.0 / math.sqrt(n_in)
        out[f"{prefix}/w"] = w
        out[f"{prefix}/b"] = torch.empty(n_out, device=dev).uniform_(
            -bound, bound, generator=gen)

    widths = [dm["n_num"], *dm["bottom"], dm["d"]]
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        linear(f"bottom/l{i}", a, b)
    for i in range(dm["cross"]):
        out[f"cross/l{i}/V"] = torch.nn.init.xavier_normal_(
            torch.empty((dm["rank"], dm["n"]), device=dev), generator=gen)
        out[f"cross/l{i}/W"] = torch.nn.init.xavier_normal_(
            torch.empty((dm["n"], dm["rank"]), device=dev), generator=gen)
        out[f"cross/l{i}/b"] = torch.zeros(dm["n"], device=dev)
    widths = [dm["n"], *dm["top"], 1]
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        linear(f"top/l{i}", a, b)
    return out


def model_batch(batch, cfg):
    """The rows as made (``fids``, ``vals``, ``mask``, ``labels``) to the
    model's: each feature's bag of ids in feature order, and log1p of
    the numeric values."""
    dm = _dims(cfg)
    rows = feature_rows(cfg)
    fids = batch["fids"].to(torch.int64)
    bags, lo = [], 0
    for f, size in enumerate(dm["bags"]):
        first = fids[:, f]
        r = first - lo
        j = torch.arange(1, size, dtype=torch.int64, device=fids.device)
        h = (r[:, None] * HASH_ROW + j[None, :] * HASH_SLOT) % M
        h = (h * LEHMER) % M
        bags.append(torch.cat([first[:, None], lo + h % rows[f]], dim=1))
        lo += rows[f]
    x = batch["vals"][:, dm["n_cat"]:] * batch["mask"][:, dm["n_cat"]:]
    return {"bag_ids": torch.cat(bags, dim=1), "dense": torch.log1p(x),
            "labels": batch["labels"]}


def forward(params, rows, pos, dense, dm, prec):
    """Logits: ``rows`` the table's touched rows, ``pos`` each slot's
    row among them."""
    emb = rows[pos]
    pooled, s = [], 0
    for size in dm["bags"]:
        pooled.append(emb[:, s:s + size].sum(dim=1))
        s += size
    x = dense
    for i in range(len(dm["bottom"]) + 1):
        x = torch.relu(common.matmul(x, params[f"bottom/l{i}/w"].T, prec)
                       + params[f"bottom/l{i}/b"])
    x0 = torch.cat([x] + pooled, dim=1)
    x = x0
    for i in range(dm["cross"]):
        v = common.matmul(x, params[f"cross/l{i}/V"].T, prec)
        x = x0 * (common.matmul(v, params[f"cross/l{i}/W"].T, prec)
                  + params[f"cross/l{i}/b"]) + x
    n_top = len(dm["top"]) + 1
    for i in range(n_top):
        x = (common.matmul(x, params[f"top/l{i}/w"].T, prec)
             + params[f"top/l{i}/b"])
        if i < n_top - 1:
            x = torch.relu(x)
    return x[:, 0]


def steps(params0, batches, cfg, mode="exact"):
    """``len(batches)`` Adagrad steps from ``params0`` (flat leaf names):
    the losses, the accumulators after the first step and the parameters
    after the last.  ``mode`` as ``common.run_steps``'s: "half" steps on
    the first half of each batch, "frozen" leaves the state unchanged,
    "control" computes the products in TF32."""
    if mode not in common.MODES:
        raise ValueError(f"unknown mode {mode!r}")
    dm = _dims(cfg)
    opt = cfg["optimizer"]
    lr, eps = float(opt["learning_rate"]), float(opt["eps"])
    control = mode == "control"
    prec = cfg["control"]["precision"] if control else "float32"
    params = {k: v.detach().clone() for k, v in params0.items()}
    accum = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"losses": [], "accum1": None, "params": None}
    for i, raw in enumerate(batches):
        batch = model_batch(raw, cfg)
        if mode == "half":
            n = len(batch["labels"]) // 2
            batch = {k: v[:n] for k, v in batch.items()}
        uids, pos = torch.unique(batch["bag_ids"], return_inverse=True)
        rows = params["embed"].index_select(0, uids).requires_grad_(True)
        dense = {k: v.requires_grad_(True) for k, v in params.items()
                 if k != "embed"}
        with common.matmul_precision(control):
            # the numeric inputs in the parameters' precision (float64 for
            # the control tool's witness)
            x = batch["dense"].to(rows.dtype)
            z = forward(dense, rows, pos, x, dm, prec)
            loss = common.logistic_loss(z, batch["labels"]) / z.shape[0]
            grads = torch.autograd.grad(loss, [rows] + list(dense.values()))
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            for p in dense.values():
                p.requires_grad_(False)
            if mode != "frozen":
                g = grads[0]
                a = accum["embed"].index_select(0, uids) + g * g
                accum["embed"].index_add_(0, uids, g * g)
                params["embed"].index_add_(
                    0, uids, -lr * g * torch.rsqrt(a + eps))
                for (k, p), g in zip(dense.items(), grads[1:]):
                    accum[k] += g * g
                    p -= lr * g * torch.rsqrt(accum[k] + eps)
        if i == 0:
            out["accum1"] = {k: v.clone() for k, v in accum.items()}
        del grads, loss, z, rows
    out["params"] = params
    return out
