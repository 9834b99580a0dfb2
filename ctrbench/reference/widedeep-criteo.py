"""Plain PyTorch reference of ``widedeep-criteo``: Wide & Deep (Cheng et
al. 2016) in the form LightCTR's ``distributed_algo_abst.h:93-349``
builds it, trained by Adagrad.

    wide  = sum_i w[id_i] x_i                     (every slot)
    e_f   = embed[first id of field f] (0 where the field is empty)
    h     = tanh(concat_f(e_f) @ fc1.w^T + fc1.b)  (1,248 -> 1,024)
    deep  = sigmoid(h @ fc2.w^T + fc2.b)           (1,024 -> 1)
    loss  = mean over rows of logistic(wide + deep, y)

``x`` is a slot's value times its mask.  Each row's field representative
is worked out here from the ids, the slots' fields and the mask.  In the
"control" mode the matrix products run in TF32 (on a card, with cuBLAS's
own TF32; on the CPU, with the inputs rounded as the tensor cores round
them).
"""

import math

import torch

from ctrbench.reference import common


def init_params(gen: torch.Generator, cfg) -> dict:
    """``w`` zeros, ``embed`` ~ N(0, 1/factor_dim); each dense weight
    U(-0.5, 0.5) / sqrt(fan_in), each bias zeros.  Drawn in that order on
    the generator's device."""
    vocab, k = int(cfg["vocab"]), int(cfg["factor_dim"])
    dev = gen.device
    embed = torch.randn((vocab, k), generator=gen, dtype=torch.float32,
                        device=dev)
    embed.mul_(1.0 / math.sqrt(k))
    out = {"w": torch.zeros(vocab, dtype=torch.float32, device=dev),
           "embed": embed}
    for i, (n_in, n_out) in enumerate(cfg["dense_layers"]):
        w = torch.rand((n_out, n_in), generator=gen, dtype=torch.float32,
                       device=dev)
        w.sub_(0.5).mul_(1.0 / math.sqrt(n_in))
        out[f"fc{i + 1}/w"] = w
        out[f"fc{i + 1}/b"] = torch.zeros(n_out, dtype=torch.float32,
                                          device=dev)
    return out


def representatives(fids, mask, n_fields):
    """The first active id of each field of each row, and whether the field
    has one; at this layout slot j belongs to field j."""
    n, slots = fids.shape
    rep = torch.zeros((n, n_fields), dtype=torch.int64, device=fids.device)
    present = torch.zeros((n, n_fields), dtype=torch.float32,
                          device=fids.device)
    for j in range(slots):
        f = j % n_fields
        take = (mask[:, j] > 0) & (present[:, f] == 0)
        rep[:, f] = torch.where(take, fids[:, j].to(torch.int64), rep[:, f])
        present[:, f] = torch.where(take, 1.0, present[:, f])
    return rep, present


def loss_fn(cfg):
    n_fields = int(cfg["layout"]["fields"])
    ctl = cfg["control"]["precision"]

    def fn(params, batch, mode):
        prec = ctl if mode == "control" else "float32"
        mask = batch["mask"]
        ids = batch["fids"].to(torch.int64)
        wide = (params["w"][ids] * batch["vals"] * mask).sum(-1)
        rep, present = representatives(batch["fids"], mask, n_fields)
        e = params["embed"][rep] * present[..., None]
        x = e.reshape(e.shape[0], -1)
        h = torch.tanh(common.matmul(x, params["fc1/w"].T, prec)
                       + params["fc1/b"])
        deep = torch.sigmoid(common.matmul(h, params["fc2/w"].T, prec)
                             + params["fc2/b"])[:, 0]
        return common.logistic_loss(wide + deep, batch["labels"]) / x.shape[0]

    return fn


def steps(params0, batches, cfg, mode="exact"):
    opt = cfg["optimizer"]
    tables = {k: t["ids"] for k, t in cfg["tables"].items()}
    # the embedding's touched rows are among the rows' ids (each field's
    # first): the reference works the representatives out itself, and a
    # row it did not use has a zero gradient, so it does not move
    tables["embed"] = ["fids"]
    return common.run_steps(params0, batches, loss_fn(cfg), tables,
                            float(opt["learning_rate"]), float(opt["eps"]),
                            mode, tf32=cfg["control"]["precision"] == "tf32")
