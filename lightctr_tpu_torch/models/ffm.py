"""Field-aware Factorization Machine on tensors.

The port's counterpart of ``lightctr_tpu/models/ffm.py``, with capability
parity with ``Train_FFM_Algo`` (``train/train_ffm_algo.cpp``).  The
reference computes, per row, the O(nnz^2 * k) pairwise sum

    sum_{i<j}  <V[f_i, field_j], V[f_j, field_i]> * x_i * x_j
    (train_ffm_algo.cpp:62-70)

as a scalar loop.  As in the JAX package, the forward is the
field-bucketed form instead:

    G[b, f, g, :] = sum_{i : field_i = f}  x_i * V[fid_i, g, :]

    sum_{i != j} x_i x_j <V[f_i, field_j], V[f_j, field_i]>
        = sum_{f,g} <G[b,f,g,:], G[b,g,f,:]>  -  sum_i x_i^2 |V[fid_i, field_i, :]|^2

and the i<j sum is half that.  G comes from a one-hot field product
(``einsum``), with no per-pair loop.

Both gathers, ``w`` [V] and ``v`` [V, Fl, k], go through
``embed.table.lookup``: the gradient of ``v`` is ``merge_rows`` over rows
of Fl*k floats, summed in slot order (XLA's order), so a step on the card
is the same from run to run.

Init parity: V ~ N(0, 1)/sqrt(k) (fm_algo_abst.h:57-64); W zero.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from lightctr_tpu_torch.embed.table import lookup


def init(generator: torch.Generator, feature_cnt: int, field_cnt: int,
         factor_cnt: int, device="cpu") -> Dict[str, torch.Tensor]:
    """W zero; V [F, Fl, k] ~ N(0, 1/k), drawn from ``generator`` on its
    own device and moved to ``device``."""
    v = torch.randn((feature_cnt, field_cnt, factor_cnt),
                    generator=generator, dtype=torch.float32,
                    device=generator.device)
    return {
        "w": torch.zeros((feature_cnt,), dtype=torch.float32, device=device),
        "v": (v / math.sqrt(float(factor_cnt))).to(device),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def logits(params: Dict[str, torch.Tensor],
           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return logits_with_l2(params, batch)[0]


def logits_with_l2(params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]):
    """Forward plus the touched-row L2 from the SAME gathers (the separate
    penalty would re-read the big [B, P, Fl, k] gather)."""
    mask = batch["mask"]
    vals = batch["vals"] * mask                                  # [B, P]
    fids = batch["fids"]                                         # [B, P]
    fields = batch["fields"]                                     # [B, P]
    field_cnt = params["v"].shape[1]

    w = lookup(params["w"], fids)                                # [B, P]
    linear = torch.sum(w * vals, dim=-1)

    vg = lookup(params["v"], fids)                               # [B, P, Fl, k]
    vx = vg * vals[..., None, None]
    onehot = _one_hot(fields, field_cnt, vx.dtype)               # [B, P, Fl]
    # G[b, f, g, k] = sum_p onehot[b,p,f] * vx[b,p,g,k]
    g = torch.einsum("bpf,bpgk->bfgk", onehot, vx)
    cross = torch.einsum("bfgk,bgfk->b", g, g)
    # self-pair correction: x_i^2 * |V[fid_i, field_i, :]|^2
    idx = fields.to(torch.int64).clamp(0, field_cnt - 1)[..., None, None]
    v_self = torch.gather(vg, 2, idx.expand(
        idx.shape[:2] + (1, vg.shape[-1])))[..., 0, :]          # [B, P, k]
    diag = torch.sum((v_self * vals[..., None]) ** 2, dim=(1, 2))
    l2 = 0.5 * (torch.sum(w * w * mask)
                + torch.sum(vg * vg * mask[..., None, None]))
    return linear + 0.5 * (cross - diag), l2


def l2_penalty(params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 on touched rows (train_ffm_algo.cpp adds L2Reg_ratio per
    occurrence)."""
    mask = batch["mask"]
    w = lookup(params["w"], batch["fids"])
    v = lookup(params["v"], batch["fids"])
    return 0.5 * (torch.sum(w * w * mask)
                  + torch.sum(v * v * mask[..., None, None]))


def densify(arrays: Dict, feature_cnt: int, field_cnt: int):
    """Host-side one-time densification for full-batch FFM training on a
    compacted vocabulary (a copy of the JAX package's ``ffm.densify``,
    numpy only).

    Requires each fid to map to exactly ONE field (true of libFFM data,
    where the field is a property of the feature).  Features are permuted
    so fields are contiguous; the returned ``perm`` maps dense position ->
    original fid, and ``field_slices`` gives each field's [start, end)
    column block.  The caller permutes params to match (``w[perm]``,
    ``v[perm]``).

    Returns ``(dense_batch, perm, field_slices)``.
    """
    fids = np.asarray(arrays["fids"])
    fields = np.asarray(arrays["fields"])
    vals = np.asarray(arrays["vals"]) * np.asarray(arrays["mask"])
    mask = np.asarray(arrays["mask"]) > 0
    if mask.any():
        lo, hi = fids[mask].min(), fids[mask].max()
        if lo < 0 or hi >= feature_cnt:
            raise ValueError(f"fid out of range [{lo}, {hi}] for "
                             f"feature_cnt={feature_cnt}")
        flo, fhi = fields[mask].min(), fields[mask].max()
        if flo < 0 or fhi >= field_cnt:
            raise ValueError(
                f"field out of range [{flo}, {fhi}] for field_cnt="
                f"{field_cnt}; the dense path would silently misplace the "
                "feature's block")

    feat_field = np.full((feature_cnt,), -1, np.int64)
    f_flat, fl_flat = fids[mask], fields[mask]
    feat_field[f_flat] = fl_flat
    if not (feat_field[f_flat] == fl_flat).all():
        raise ValueError("a fid appears under two different fields; dense "
                         "FFM requires field-unique features (libFFM "
                         "semantics)")
    feat_field[feat_field < 0] = field_cnt - 1  # untouched: any block

    perm = np.argsort(feat_field, kind="stable").astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(feature_cnt)
    sorted_fields = feat_field[perm]
    starts = np.searchsorted(sorted_fields, np.arange(field_cnt))
    ends = np.searchsorted(sorted_fields, np.arange(field_cnt), side="right")
    field_slices = tuple((int(s), int(e)) for s, e in zip(starts, ends))

    n, p = fids.shape
    x = np.zeros((n, feature_cnt), np.float32)
    x2 = np.zeros((n, feature_cnt), np.float32)
    cnt = np.zeros((feature_cnt,), np.float32)
    rows = np.broadcast_to(np.arange(n)[:, None], (n, p))
    cols = inv[fids]
    np.add.at(x, (rows[mask], cols[mask]), vals[mask])
    np.add.at(x2, (rows[mask], cols[mask]), vals[mask] ** 2)
    np.add.at(cnt, cols[mask], 1.0)
    dense_batch = {"x": x, "x2": x2, "cnt": cnt,
                   "labels": np.asarray(arrays["labels"])}
    return dense_batch, perm, field_slices


def make_dense_logits(field_slices):
    """The fused (logits, l2) function for a static field layout: the
    cross term's G[b, f, g, :] = X_f @ V_f[:, g, :], one [B, F_f] x
    [F_f, Fl*k] product per field block (its backward the transposed
    products, no scatter); self-pair and L2 terms from x2 / cnt as in the
    sparse path."""
    def dense_logits_with_l2(params: Dict[str, torch.Tensor],
                             batch: Dict[str, torch.Tensor]):
        w, v = params["w"], params["v"]
        _, field_cnt, k = v.shape
        x, x2, cnt = batch["x"], batch["x2"], batch["cnt"]
        b = x.shape[0]
        linear = x @ w
        g_blocks = []
        diag = torch.zeros(b, dtype=v.dtype, device=v.device)
        for f, (s, e) in enumerate(field_slices):
            if e <= s:
                g_blocks.append(torch.zeros((b, field_cnt * k),
                                            dtype=v.dtype, device=v.device))
                continue
            vb = v[s:e]                                      # [F_f, Fl, k]
            g_blocks.append(x[:, s:e] @ vb.reshape(e - s, field_cnt * k))
            diag = diag + x2[:, s:e] @ torch.sum(vb[:, f, :] ** 2, -1)
        g = torch.stack(g_blocks, dim=1).reshape(
            b, len(field_slices), field_cnt, k)
        cross = torch.einsum("bfgk,bgfk->b", g, g)
        l2 = 0.5 * (cnt @ (w * w) + cnt @ torch.sum(v * v, dim=(1, 2)))
        return linear + 0.5 * (cross - diag), l2

    return dense_logits_with_l2
