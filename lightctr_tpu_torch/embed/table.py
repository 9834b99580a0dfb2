"""Touched-row sparse Adagrad on embedding tables.

The port's counterpart of the single-device half of
``lightctr_tpu/embed/table.py``: the PS's Adagrad branch
(``paramserver.h:287-295``) applied only at the rows a batch touched, so
untouched rows keep both their weights and their accumulators (the sparse
semantics of ``AdagradUpdater_Num``, gradientUpdater.h:143).

This is the plain chain that ``merge_apply``'s plain version runs.  The
JAX functions return new arrays (their trainer donates the old ones); here
the update is **in place** on ``table`` and ``state.accum``, as the CUDA
kernel's is, with the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class SparseAdagradState(NamedTuple):
    accum: torch.Tensor  # [rows, ...], the table's shape


def segment_sum(rows: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows summed per segment id, ids outside
    ``[0, num_segments)`` dropped."""
    seg = segment_ids.reshape(-1).to(torch.int64)
    keep = (seg >= 0) & (seg < num_segments)
    rows = rows * keep.to(rows.dtype).reshape((-1,) + (1,) * (rows.ndim - 1))
    out = rows.new_zeros((num_segments,) + tuple(rows.shape[1:]))
    return out.index_add_(0, seg.clamp(0, max(num_segments - 1, 0)), rows)


def _bcast(valid: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape the [n] validity mask to broadcast against [n, ...] deltas."""
    return valid.reshape((-1,) + (1,) * (like.ndim - 1))


def dedup_grads(ids: torch.Tensor, grads: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum gradients of duplicate keys (pull.h:46-52 / push.h:55-66).
    Static-shape: returns (unique_ids, summed, valid) padded to
    ``ids.numel()``.  Padded slots repeat id 0, so every downstream scatter
    is an add of ``valid``-masked deltas."""
    flat_ids = ids.reshape(-1)
    k = flat_ids.shape[0]
    flat_g = grads.reshape(k, -1)
    u, inv = torch.unique(flat_ids, sorted=True, return_inverse=True)
    uids = flat_ids.new_zeros((k,))
    uids[: u.shape[0]] = u
    summed = segment_sum(flat_g, inv.reshape(-1), k)
    valid = (torch.arange(k, device=flat_ids.device)
             <= inv.max()).to(flat_g.dtype)
    return uids, summed, valid


def sparse_adagrad_update(
    table: torch.Tensor,
    state: SparseAdagradState,
    ids: torch.Tensor,
    grads: torch.Tensor,
    lr: float,
    eps: float = 1e-7,
) -> Tuple[torch.Tensor, SparseAdagradState]:
    """PS Adagrad branch (paramserver.h:287-295), touched rows only, in
    place: accum[k] += g^2 ; w[k] -= lr * g / sqrt(accum[k] + eps)."""
    uids, g, valid = dedup_grads(ids, grads)
    g = g.reshape((uids.shape[0],) + tuple(table.shape[1:]))
    vmask = _bcast(valid, g)
    accum_rows = state.accum.index_select(0, uids) + g * g
    update = -lr * g * torch.rsqrt(accum_rows + eps)
    state.accum.index_add_(0, uids, g * g * vmask)
    table.index_add_(0, uids, update * vmask)
    return table, state
