"""Plain PyTorch reference of ``fm-criteo``: a Factorization Machine
(Rendle 2010; LightCTR's ``fm_algo_abst.h`` / ``train_fm_algo.cpp:63-115``)
trained by Adagrad.

    z    = sum_i w[id_i] x_i + 1/2 sum_f ((sum_i v[id_i, f] x_i)^2
                                          - sum_i v[id_i, f]^2 x_i^2)
    loss = (sum_rows logistic(z, y)
            + lambda_l2 * 1/2 sum_slots (w[id]^2 + |v[id]|^2)) / batch

The L2 term is LightCTR's: one penalty a slot a row, on the rows the
batch touches.  ``x`` is a slot's value times its mask.  In the "control"
mode the forward and backward run in bfloat16 (the parameters and the
optimizer stay float32).
"""

import math

import torch

from ctrbench.reference import common


def init_params(gen: torch.Generator, cfg) -> dict:
    """``w`` zeros, ``v`` ~ N(0, 1/factor_dim) (fm_algo_abst.h:53-67),
    drawn on the generator's device."""
    vocab, k = int(cfg["vocab"]), int(cfg["factor_dim"])
    v = torch.randn((vocab, k), generator=gen, dtype=torch.float32,
                    device=gen.device)
    v.mul_(1.0 / math.sqrt(k))
    return {"w": torch.zeros(vocab, dtype=torch.float32, device=gen.device),
            "v": v}


def loss_fn(cfg):
    lam = float(cfg["optimizer"]["lambda_l2"])
    cdt = (torch.bfloat16 if cfg["control"]["precision"] == "bfloat16"
           else torch.float32)

    def fn(params, batch, mode):
        dt = cdt if mode == "control" else torch.float32
        ids = batch["fids"].to(torch.int64)
        mask = batch["mask"]
        x = (batch["vals"] * mask).to(dt)
        w = params["w"][ids]                         # [B, P]
        v = params["v"][ids]                         # [B, P, k]
        vx = v.to(dt) * x[..., None]
        s = vx.sum(dim=1)
        z = (w.to(dt) * x).sum(-1) + 0.5 * ((s * s).sum(-1)
                                            - (vx * vx).sum(dim=(1, 2)))
        loss = common.logistic_loss(z.float(), batch["labels"])
        l2 = 0.5 * ((w * w * mask).sum() + (v * v * mask[..., None]).sum())
        return (loss + lam * l2) / z.shape[0]

    return fn


def steps(params0, batches, cfg, mode="exact"):
    opt = cfg["optimizer"]
    tables = {k: t["ids"] for k, t in cfg["tables"].items()}
    return common.run_steps(params0, batches, loss_fn(cfg), tables,
                            float(opt["learning_rate"]), float(opt["eps"]),
                            mode)
