"""Embedding tables: init, the pull (:func:`lookup`) and the touched-row
updates of the PS's ``UpdaterType`` branches (paramserver.h:252-300).

The port's counterpart of the single-device half of
``lightctr_tpu/embed/table.py``:

  - :func:`lookup` gathers rows, and its gradient sums each row's
    duplicate slots in slot order (the ``merge_rows`` kernel on the card),
    as XLA's scatter-add orders the gradient of ``jnp.take``;
  - the SGD, Adagrad and DCASGD branches apply only at the rows a batch
    touched, so untouched rows keep their weights and their state (the
    sparse semantics of ``AdagradUpdater_Num``, gradientUpdater.h:143).

Sparse Adagrad is the plain chain that ``merge_apply``'s plain version
runs.  The JAX functions return new arrays (their trainer donates the old
ones); here every update is **in place** on ``table`` and its state, as
the CUDA kernel's is, with the same values.  A row-sharded table (the JAX
``mesh=`` of :func:`init_table`) is not ported (ROADMAP.md §A.8).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


def init_table(generator: torch.Generator, num_rows: int, dim: int,
               mesh=None, scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1/dim) rows (the PS lazy-init draws gaussian*sqrt(1/dim),
    paramserver.h:315-339 check_and_find), drawn from ``generator`` on its
    device."""
    if mesh is not None:
        raise ValueError("init_table: mesh= (a row-sharded table) not yet "
                         "ported to lightctr_tpu_torch (see ROADMAP.md §A)")
    scale = scale if scale is not None else 1.0 / math.sqrt(float(dim))
    return torch.randn((num_rows, dim), generator=generator,
                       dtype=torch.float32, device=generator.device) * scale


class _Lookup(torch.autograd.Function):
    """``table[ids]`` whose backward is the slot-order segment sum."""

    @staticmethod
    def forward(ctx, table, ids):
        flat = ids.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.table_shape = table.shape
        return table.index_select(0, flat).reshape(
            tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        from lightctr_tpu_torch.ops import sparse_kernels

        (flat,) = ctx.saved_tensors
        shape = ctx.table_shape
        m = flat.numel()
        merged = sparse_kernels.merge_rows(
            grad.reshape(m, -1).contiguous(), flat.to(torch.int32), shape[0])
        return merged.reshape(shape), None


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Pull: the rows of ``table`` at ``ids`` (``jnp.take(table, ids,
    axis=0)``), shaped ``ids.shape + table.shape[1:]``.

    Its gradient is ``merge_rows(grad, ids, rows)``: each row's slots
    summed in increasing slot order from +0, the order of XLA's
    scatter-add.  On a CUDA tensor that is the ``merge_rows`` kernel (float32
    tables; ``index_select``'s own backward sums with atomics in an order
    that varies run to run), on a CPU tensor its plain version
    (``index_add_`` in index order)."""
    return _Lookup.apply(table, ids)


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


def jax_rows(ids: torch.Tensor, rows: int):
    """The JAX package's index rules for a table of ``rows`` rows: an id in
    ``[-rows, 0)`` wraps to ``id + rows``; any other id outside
    ``[0, rows)`` is out (a ``.at[].add`` drops it, a ``jnp.take`` fills
    it).  Returns the row index (clamped, so it can be gathered) and the
    in-table mask."""
    idx = torch.where(ids < 0, ids + rows, ids).to(torch.int64)
    inside = (idx >= 0) & (idx < rows)
    return idx.clamp(0, max(rows - 1, 0)), inside


def filter_preferred_grads(grads: torch.Tensor, tiny: float = 1e-7,
                           huge: float = 15.0) -> torch.Tensor:
    """Worker-side pre-wire gradient filter (``checkPreferredValue``,
    push.h:61-63 / distributed_algo_abst.h:76-79): values that are ~0 carry
    no information and exploded values are dropped for robustness.
    Dropping = zeroing (a zero gradient is a no-op update).  Applied to the
    per-key SUMMED gradient, after :func:`dedup_grads`."""
    a = grads.abs()
    keep = (a > tiny) & (a < huge)
    return grads * keep.to(grads.dtype)


def _scatter_add(dst: torch.Tensor, idx: torch.Tensor, inside: torch.Tensor,
                 src: torch.Tensor) -> None:
    """``dst.at[idx].add(src)`` with the rows outside the table dropped."""
    keep = inside.nonzero().reshape(-1)
    dst.index_add_(0, idx.index_select(0, keep), src.index_select(0, keep))


def sparse_sgd_update(table: torch.Tensor, ids: torch.Tensor,
                      grads: torch.Tensor, lr: float,
                      filter_grads: bool = False) -> torch.Tensor:
    """PS simple-SGD branch (paramserver.h:296-300), in place.
    ``filter_grads`` applies the push-side ``checkPreferredValue`` filter to
    the deduped per-key sums."""
    uids, g, valid = dedup_grads(ids, grads)
    if filter_grads:
        g = filter_preferred_grads(g)
    g = g.reshape((uids.shape[0],) + tuple(table.shape[1:]))
    idx, inside = jax_rows(uids, table.shape[0])
    _scatter_add(table, idx, inside, -lr * g * _bcast(valid, g))
    return table


def init_adagrad_state(table: torch.Tensor) -> SparseAdagradState:
    return SparseAdagradState(accum=torch.zeros_like(table))


def sparse_adagrad_update(
    table: torch.Tensor,
    state: SparseAdagradState,
    ids: torch.Tensor,
    grads: torch.Tensor,
    lr: float,
    eps: float = 1e-7,
    filter_grads: bool = False,
) -> Tuple[torch.Tensor, SparseAdagradState]:
    """PS Adagrad branch (paramserver.h:287-295), touched rows only, in
    place: accum[k] += g^2 ; w[k] -= lr * g / sqrt(accum[k] + eps).  Ids
    follow :func:`jax_rows`: a negative id wraps, an id past the table is
    dropped."""
    uids, g, valid = dedup_grads(ids, grads)
    if filter_grads:
        g = filter_preferred_grads(g)
    g = g.reshape((uids.shape[0],) + tuple(table.shape[1:]))
    vmask = _bcast(valid, g)
    idx, inside = jax_rows(uids, table.shape[0])
    accum_rows = state.accum.index_select(0, idx) + g * g
    update = -lr * g * torch.rsqrt(accum_rows + eps)
    _scatter_add(state.accum, idx, inside, g * g * vmask)
    _scatter_add(table, idx, inside, update * vmask)
    return table, state


class SparseDCASGDState(NamedTuple):
    """Per-worker shadow copies (paramserver.h:33-39
    ValueWrapper.shadow_copies)."""

    shadow: torch.Tensor  # [workers, rows, ...]


def init_dcasgd_state(table: torch.Tensor, n_workers: int
                      ) -> SparseDCASGDState:
    return SparseDCASGDState(
        shadow=table.unsqueeze(0).repeat((n_workers,) + (1,) * table.ndim))


def sparse_dcasgd_update(
    table: torch.Tensor,
    state: SparseDCASGDState,
    worker_id: int,
    ids: torch.Tensor,
    grads: torch.Tensor,
    lr: float,
    dcasgd_lambda: float = 0.1,
    filter_grads: bool = False,
) -> Tuple[torch.Tensor, SparseDCASGDState]:
    """PS DCASGD branch (paramserver.h:252-268), in place:
    g' = g + lambda * g^2 * (w_cur - shadow[worker]); w -= lr * g';
    shadow[worker] <- w_new."""
    uids, g, valid = dedup_grads(ids, grads)
    if filter_grads:
        g = filter_preferred_grads(g)
    g = g.reshape((uids.shape[0],) + tuple(table.shape[1:]))
    vmask = _bcast(valid, g)
    idx, inside = jax_rows(uids, table.shape[0])
    shadow = state.shadow[worker_id]
    cur = table.index_select(0, idx)
    shadow_rows = shadow.index_select(0, idx)
    comp = g + dcasgd_lambda * g * g * (cur - shadow_rows)
    delta = -lr * comp * vmask
    _scatter_add(table, idx, inside, delta)
    # shadow <- w_new, expressed as an add of the masked difference
    _scatter_add(shadow, idx, inside, (cur + delta - shadow_rows) * vmask)
    return table, state
