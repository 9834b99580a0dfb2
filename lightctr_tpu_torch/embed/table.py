"""Embedding tables: init, the pull (:func:`lookup`) and the touched-row
updates of the PS's ``UpdaterType`` branches (paramserver.h:252-300).

The port's counterpart of the single-device half of
``lightctr_tpu/embed/table.py``:

  - :func:`lookup` gathers rows, and its gradient sums each row's
    duplicate slots in slot order (the ``merge_rows`` kernel on the card),
    as XLA's scatter-add orders the gradient of ``jnp.take``;
  - :func:`pooled_lookup` is :func:`lookup` followed by a sum over each
    feature's fixed bag of slots (multi-hot features, DLRM's sum-pooled
    ``EmbeddingBag``), so its gradient is the same slot-order merge;
  - the SGD, Adagrad and DCASGD branches apply only at the rows a batch
    touched, so untouched rows keep their weights and their state (the
    sparse semantics of ``AdagradUpdater_Num``, gradientUpdater.h:143).

Sparse Adagrad is the plain chain that ``merge_apply``'s plain version
runs.  The JAX functions return new arrays (their trainer donates the old
ones); here every update is **in place** on ``table`` and its state, as
the CUDA kernel's is, with the same values.

A row-sharded table (the JAX ``mesh=`` of :func:`init_table`, rows
``P("embed", None)``) is a :class:`ShardedTable`: this rank's block of
rows, its offset, the table's row count and the mesh.  :func:`lookup`
pulls its rows the way the reference's worker pulls from the PS shards
(pull.h:43-99), over the mesh's ``embed`` view:

  1. the ids deduped (``dedup_ids``);
  2. the unique ids bucketed by the block that owns them, each bucket
     padded to the deduped length (no bucket can overflow);
  3. the buckets routed to their owners (``all_to_all_exchange``);
  4. each owner serves its rows from its block (``gather_rows``);
  5. the rows routed back (``all_to_all_exchange``);
  6. expanded by the dedup's inverse.

Its gradient is the block's: each slot's row gradient merged into the
block at ``id - offset`` (``merge_rows``, slot order), the other blocks'
ids falling outside it and dropped.  No push crosses the embed axis: the
members of an embed line hold the same batch rows, compute the same slot
gradients, and each keeps the rows it owns.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class ShardedTable:
    """A table of ``num_rows`` rows, row-sharded over ``mesh``'s ``embed``
    axis, as this rank holds it: ``local``, its block of rows ``[offset,
    offset + local.shape[0])``.  The JAX package's table under
    ``embed_sharding``; :func:`lookup` reads it, and the trainers step
    ``local`` in place."""

    __slots__ = ("local", "offset", "num_rows", "mesh")

    def __init__(self, local: torch.Tensor, offset: int, num_rows: int,
                 mesh):
        self.local = local
        self.offset = int(offset)
        self.num_rows = int(num_rows)
        self.mesh = mesh

    @property
    def shape(self) -> tuple:
        """The whole table's shape."""
        return (self.num_rows,) + tuple(self.local.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def with_local(self, local: torch.Tensor) -> "ShardedTable":
        """The same placement over another block (an update's result)."""
        return ShardedTable(local, self.offset, self.num_rows, self.mesh)

    def detach(self) -> "ShardedTable":
        return self.with_local(self.local.detach())

    def clone(self) -> "ShardedTable":
        return self.with_local(self.local.clone())

    def __repr__(self) -> str:
        return (f"ShardedTable(shape={self.shape}, rows=[{self.offset}, "
                f"{self.offset + self.local.shape[0]}), "
                f"device={self.device})")


def shard_rows(full, mesh, device=None) -> ShardedTable:
    """This rank's block of a whole table ``full`` (a tensor or an array)
    under ``embed_sharding(mesh)``: rows ``[e*F/S, (e+1)*F/S)`` for embed
    index ``e`` of ``S``, copied onto ``device`` (``mesh.device`` by
    default).  ``F`` must divide by ``S``, as the JAX ``device_put``
    requires."""
    full = torch.as_tensor(full)
    emb = mesh.view("embed")
    s, e = emb.size, emb.rank
    f = full.shape[0]
    if f % s:
        raise ValueError(f"embed_sharding: the global size of dimension 0 "
                         f"should be divisible by {s}, but it is equal to "
                         f"{f} (full shape: {tuple(full.shape)})")
    rows = f // s
    dev = mesh.device if device is None else device
    return ShardedTable(full[e * rows:(e + 1) * rows].to(dev).clone(),
                        e * rows, f, mesh)


def gather_table(table: ShardedTable) -> torch.Tensor:
    """The whole table on every member of the embed line (one all-gather
    of the blocks over the ``embed`` view)."""
    from lightctr_tpu_torch.dist import collectives

    return collectives.all_gather(table.mesh.view("embed"), table.local)


def init_table(generator: torch.Generator, num_rows: int, dim: int,
               mesh=None, scale: Optional[float] = None):
    """N(0, 1/dim) rows (the PS lazy-init draws gaussian*sqrt(1/dim),
    paramserver.h:315-339 check_and_find), drawn from ``generator`` on its
    device.  With ``mesh`` the whole table is drawn as without one and
    this rank keeps its block, a :class:`ShardedTable` on the mesh's
    device: a sharded table holds the same numbers as the unsharded one."""
    scale = scale if scale is not None else 1.0 / math.sqrt(float(dim))
    t = torch.randn((num_rows, dim), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    if mesh is not None:
        return shard_rows(t, mesh)
    return t


def pull_rows(table: ShardedTable, uids: torch.Tensor,
              count: torch.Tensor, local: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Steps 2-5 of the pull (module docstring): the rows of deduped
    ``uids`` [K] (sorted, the first ``count`` real, the rest pads) from
    their owners over the ``embed`` view -> [K, ...], zero at the pads.
    ``local`` stands in for ``table.local`` (an autograd leaf over it).
    Every member of the embed line must pull together."""
    from lightctr_tpu_torch.dist import collectives
    from lightctr_tpu_torch.ops import sparse_kernels

    block = table.local if local is None else local
    emb = table.mesh.view("embed")
    s, k, rows = emb.size, uids.shape[0], block.shape[0]
    dev = uids.device
    slot = torch.arange(k, device=dev)
    # pads are masked by the count, never by their value: id 0 is a real
    # row of block 0 and B2's pad
    valid = slot < count
    key = torch.where(valid, uids.to(torch.int64), table.num_rows)
    owner = torch.where(valid, key // rows, s)
    # the uids are sorted, so each owner's are one run of slots: a slot's
    # place in its bucket is its distance from the run's start (the pads
    # fill the trash bucket s)
    starts = torch.searchsorted(
        key, torch.arange(s + 1, device=dev, dtype=torch.int64) * rows)
    pos = slot - starts.index_select(0, owner)
    req = torch.zeros((s + 1, k), dtype=torch.int32, device=dev)
    req[owner, pos] = torch.where(valid, key - owner * rows, 0).to(
        torch.int32)
    asked = collectives.all_to_all_exchange(emb, req[:s], axis="embed")
    served = sparse_kernels.gather_rows(
        block.detach(), asked.reshape(-1)).reshape(
            (s, k) + tuple(block.shape[1:]))
    back = collectives.all_to_all_exchange(emb, served, axis="embed")
    got = back[owner.clamp(max=s - 1), pos]
    return got * valid.to(got.dtype).reshape(
        (-1,) + (1,) * (got.ndim - 1))


def _tree_map(f, *trees):
    from lightctr_tpu_torch.optim.updaters import tree_map

    return tree_map(f, *trees)


def local_view(tree):
    """``tree`` with each :class:`ShardedTable` replaced by its block."""
    return _tree_map(
        lambda x: x.local if isinstance(x, ShardedTable) else x, tree)


def rewrap(tree, like):
    """``tree`` (blocks) with each leaf where ``like`` holds a
    :class:`ShardedTable` put back under that table's placement."""
    return _tree_map(
        lambda x, t: t.with_local(x) if isinstance(t, ShardedTable) else x,
        tree, like)


def has_sharded(tree) -> bool:
    """Whether any leaf of ``tree`` is a :class:`ShardedTable`."""
    from lightctr_tpu_torch.optim.updaters import tree_leaves

    return any(isinstance(x, ShardedTable) for x in tree_leaves(tree))


def place(tree, placements, device=None):
    """``tree`` under a matching tree of ``core.mesh.Placement``: each leaf
    under ``embed_sharding`` this rank's :class:`ShardedTable` block
    (:func:`shard_rows`; a leaf that already is one stays), each
    replicated leaf as it is.  Any other placement is refused: nothing
    else shards a parameter in the JAX package."""
    def one(x, p):
        axis = getattr(p, "row_axis", None)
        if not hasattr(p, "spec") or (p.spec and any(
                a is not None for a in p.spec[1:])):
            raise ValueError(f"param_shardings: unsupported placement {p!r}")
        if axis is None:
            return x
        if axis != "embed":
            raise ValueError(f"param_shardings: a parameter's rows shard "
                             f"over 'embed' only, got {axis!r}")
        if isinstance(x, ShardedTable):
            return x
        return shard_rows(x, p.mesh, device)

    return _tree_map(one, tree, placements)


def _per_param(state, like, fn):
    """``state`` with ``fn(subtree, like[k])`` in place of each subtree
    under a dict whose keys are all names of ``like`` (a per-parameter
    tree of an optimizer state: Adagrad's ``accum``, Adam's moments, the
    sparse trainer's table accumulators)."""
    if isinstance(state, dict) and isinstance(like, dict) and state \
            and set(state) <= set(like):
        return {k: fn(v, like[k]) for k, v in state.items()}
    if isinstance(state, dict):
        return {k: _per_param(v, like, fn) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_per_param(v, like, fn) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(_per_param(v, like, fn) for v in state)
    return state


def place_state(state, placements, device=None):
    """An optimizer state of whole tables under the params' ``placements``
    (the carry-over of a JAX state): each per-parameter leaf placed as
    its parameter is."""
    return _per_param(state, placements,
                      lambda v, p: place(v, p, device))


def place_like(state, params):
    """An optimizer state of ``params``' blocks under ``params``'
    placements, as the JAX optimizer state inherits its params'
    shardings."""
    return _per_param(state, params, rewrap)


class _ShardedLookup(torch.autograd.Function):
    """The pull of a :class:`ShardedTable`'s rows at ``ids``, whose
    backward is the slot-order merge into this rank's block."""

    @staticmethod
    def forward(ctx, local, ids, table):
        from lightctr_tpu_torch.ops import sparse_kernels

        flat = ids.reshape(-1).to(torch.int32)
        uids, inv, count = sparse_kernels.dedup_ids(flat)
        rows = pull_rows(table, uids, count, local=local)
        ctx.save_for_backward(flat)
        ctx.offset = table.offset
        ctx.local_shape = local.shape
        return rows.index_select(0, inv).reshape(
            tuple(ids.shape) + tuple(local.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        from lightctr_tpu_torch.ops import sparse_kernels
        from lightctr_tpu_torch.utils.profiling import annotate

        (flat,) = ctx.saved_tensors
        shape = ctx.local_shape
        m = flat.numel()
        with annotate("embed/lookup_backward"):
            # ids of the other blocks land outside [0, rows) and are dropped
            merged = sparse_kernels.merge_rows(
                grad.reshape(m, -1).contiguous(), flat - ctx.offset,
                shape[0])
        return merged.reshape(shape), None, None


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
        from lightctr_tpu_torch.utils.profiling import annotate

        (flat,) = ctx.saved_tensors
        shape = ctx.table_shape
        m = flat.numel()
        with annotate("embed/lookup_backward"):
            merged = sparse_kernels.merge_rows(
                grad.reshape(m, -1).contiguous(), flat.to(torch.int32),
                shape[0])
        return merged.reshape(shape), None


def lookup(table, ids: torch.Tensor) -> torch.Tensor:
    """Pull: the rows of ``table`` at ``ids`` (``jnp.take(table, ids,
    axis=0)``), shaped ``ids.shape + table.shape[1:]``.  A
    :class:`ShardedTable` is pulled from its owners (module docstring);
    its gradient reaches this rank's block only.

    Its gradient is ``merge_rows(grad, ids, rows)``: each row's slots
    summed in increasing slot order from +0, the order of XLA's
    scatter-add.  On a CUDA tensor that is the ``merge_rows`` kernel (float32
    tables; ``index_select``'s own backward sums with atomics in an order
    that varies run to run), on a CPU tensor its plain version
    (``index_add_`` in index order)."""
    if isinstance(table, ShardedTable):
        return _ShardedLookup.apply(table.local, ids, table)
    return _Lookup.apply(table, ids)


class _BagSum(torch.autograd.Function):
    """``rows`` [B, S, ...] summed over consecutive slot ranges of fixed
    ``lengths`` [B, F] -> [B, F, ...]: each output summed in slot order by
    one thread of ``segment_reduce`` (no atomics, so the card repeats it
    bit for bit); the backward hands each slot its feature's gradient
    (``feature`` [S], the static slot -> feature map)."""

    @staticmethod
    def forward(ctx, rows, lengths, feature):
        ctx.save_for_backward(feature)
        # unsafe: the lengths are static and checked once (Bags); the
        # check would read them back from the card every call
        return torch.segment_reduce(rows, "sum", lengths=lengths, axis=1,
                                    unsafe=True)

    @staticmethod
    def backward(ctx, grad):
        (feature,) = ctx.saved_tensors
        return grad.index_select(1, feature), None, None


class Bags:
    """The fixed bag layout of multi-hot features: ``sizes[f]`` slots for
    feature ``f``, the features' slot ranges in order.  Holds the static
    maps the pool needs on each device it met (``lengths`` [F] and the
    slot -> feature map [S]), made once: a map made from host data every
    step would be a pageable copy, which waits for the card."""

    def __init__(self, sizes: Tuple[int, ...]):
        self.sizes = tuple(int(s) for s in sizes)
        if not self.sizes or min(self.sizes) < 1:
            raise ValueError(f"every bag needs at least one slot, got "
                             f"{self.sizes}")
        self.slots = sum(self.sizes)
        self._maps: dict = {}

    def maps(self, device: torch.device):
        """``(lengths, feature)`` on ``device``."""
        key = str(device)
        if key not in self._maps:
            sizes = torch.tensor(self.sizes, dtype=torch.int64)
            feature = torch.repeat_interleave(
                torch.arange(len(self.sizes)), sizes)
            self._maps[key] = (sizes.to(device), feature.to(device))
        return self._maps[key]


def pooled_lookup(table, ids: torch.Tensor, bags: Bags) -> torch.Tensor:
    """Sum-pooled bags: ``ids`` [B, S] holds each feature's bag in its
    fixed range of slots (``bags``, ``S == bags.slots``) -> [B, F, ...],
    each feature's rows of :func:`lookup` summed in slot order.  The
    gradient of the table is :func:`lookup`'s (``merge_rows``, slot
    order).

    A span ``embed/bag_pool`` covers the lookup and the pool; with
    telemetry on, ``embed_bag_slots_total`` counts the slots pooled."""
    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.utils.profiling import annotate

    b, s = ids.shape
    if s != bags.slots:
        raise ValueError(f"ids have {s} slots a row, the bags {bags.slots}")
    with annotate("embed/bag_pool", slots=b * s):
        lengths, feature = bags.maps(ids.device)
        rows = lookup(table, ids)
        pooled = _BagSum.apply(rows, lengths.expand(b, -1), feature)
    if obs.enabled():
        obs.default_registry().inc("embed_bag_slots_total", b * s)
    return pooled


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
