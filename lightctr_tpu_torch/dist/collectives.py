"""Collectives: explicit ring all-reduce and the sparse exchange.

The port's counterpart of ``lightctr_tpu/dist/collectives.py``.  The JAX
functions run per device under ``shard_map`` and name their mesh axis; here
each runs in one rank's process and takes the :class:`~lightctr_tpu_torch.
core.mesh.Mesh` in place of ``axis_name``.  The JAX collectives map so:

  ``all_gather(tiled=True)``  an all-gather along dim 0 (:func:`all_gather`)
  ``pmax`` / ``psum``         ``all_reduce`` with MAX / SUM
  ``pmean``                   ``all_reduce`` SUM, then ``/ n``
  ``ppermute`` (ring)         paired ``isend``/``irecv`` to the ring
                              neighbours (:func:`ring_shift`;
                              :func:`ring_shift_all` for several tensors
                              in one batch, either way round)

On an NCCL group CUDA tensors go straight in.  On a gloo group the layer
stages CUDA payloads through host memory itself, chosen by the group's
backend (gloo's CUDA support is partial), and ships 2-byte codes and
16-bit floats as bytes (gloo has no 16-bit integer type).  Nothing
retries or falls back.

The byte accounting (``sparse_exchange_bytes``, ``dense_ring_bytes``,
``pick_exchange_algo`` and the rest) is the JAX package's pure Python,
copied: the two packages price and pick alike (tested).  The reference
implements the ring by hand over ZeroMQ (``distribut/ring_collect.h``):
params fused into one flat buffer, split into ``ring_size`` segments,
N-1 reduce-scatter steps and N-1 all-gather steps around the ring.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from lightctr_tpu_torch.ops import quantize, sparse_kernels

# -- the collectives over a mesh ---------------------------------------------


#: 2-byte types sent as their bytes: gloo has no 16-bit integer type, and
#: its 16-bit float support varies by version
_AS_BYTES = (torch.uint16, torch.int16, torch.float16, torch.bfloat16)


def _staged(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the group's backend takes it: on gloo a CUDA tensor goes
    to host memory, and 2-byte types go as their bytes."""
    if mesh.backend == "gloo" and x.is_cuda:
        x = x.cpu()
    return x.contiguous()


def all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """Tiled all-gather: every rank's ``x`` [K, ...] concatenated in rank
    order along dim 0 -> [n*K, ...], on ``x``'s device."""
    n = mesh.size
    src = _staged(mesh, x)
    as_bytes = src.dtype in _AS_BYTES
    if as_bytes:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    if as_bytes:
        out = out.view(x.dtype)
    return out.to(x.device)


def all_reduce(mesh, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``psum`` / ``pmax`` of ``x`` over the mesh (a new tensor on ``x``'s
    device)."""
    buf = _staged(mesh, x).clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(x.device)


def pmean(mesh, x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.pmean``: the sum over the mesh, divided by its size."""
    return all_reduce(mesh, x) / mesh.size


def _ring_perm(n: int):
    """Neighbour table: rank j sends to (j+1) % n (ring_collect.h:26-40)."""
    return [(j, (j + 1) % n) for j in range(n)]


def ring_shift(mesh, x: torch.Tensor) -> torch.Tensor:
    """``ppermute`` over :func:`_ring_perm`: send ``x`` to the next rank,
    return what the previous rank sent."""
    return ring_shift_all(mesh, (x,))[0]


def ring_shift_all(mesh, xs, reverse: bool = False) -> list:
    """:func:`ring_shift` of every tensor of ``xs`` in one
    ``batch_isend_irecv``, sent and received in the order given, so every
    rank posts the same sequence (``reverse``: send to the previous rank,
    return what the next one sent)."""
    n, r = mesh.size, mesh.rank
    if n == 1:
        return [x.clone() for x in xs]
    to, frm = ((r - 1) % n, (r + 1) % n) if reverse else ((r + 1) % n,
                                                          (r - 1) % n)
    ops, recvs = [], []
    for x in xs:
        src = _staged(mesh, x)
        if src.dtype in _AS_BYTES:
            src = src.view(torch.uint8)
        recv = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, mesh.global_rank(to), mesh.group),
                dist.P2POp(dist.irecv, recv, mesh.global_rank(frm),
                           mesh.group)]
        recvs.append(recv)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [(recv.view(x.dtype) if x.dtype in _AS_BYTES else recv)
            .to(x.device) for recv, x in zip(recvs, xs)]


# -- the ring all-reduce -----------------------------------------------------


def _ring_all_reduce_local(
    flat: torch.Tensor,
    mesh,
    n: int,
    average: bool,
    compress_bits: Optional[int] = None,
    compress_range=1.0,
    residual: Optional[torch.Tensor] = None,
    compress_mode: str = "uniform",
):
    """One rank's ring all-reduce of its full-length vector ``flat``,
    pre-padded to a multiple of n — the JAX function's segment schedule,
    with ``compress_bits`` the quantile-coded hops (the codes ride the
    wire; decode happens on the receiver) and ``residual`` the EF-SGD
    carry of every value this rank encodes.  Returns ``reduced`` or
    ``(reduced, new_residual)`` when a residual is given."""
    idx = mesh.rank
    segs = flat.reshape(n, -1).clone()
    if compress_bits is not None:
        use_ef = residual is not None
        res = (residual.reshape(n, -1).clone() if use_ef
               else torch.zeros_like(segs))
        if compress_range == "dynamic":
            # ring-global gradient magnitude (1.05 headroom keeps exact-max
            # values off the clip boundary); with EF the carried residual is
            # measured too, so a drop in gradient scale cannot clip it
            gmag = segs.abs().max() if segs.numel() else segs.new_zeros(())
            if not average:
                gmag = gmag * n  # partial SUMS must fit, not partial means
            if use_ef:
                rmag = res.abs().max() if res.numel() else res.new_zeros(())
                mags = all_reduce(mesh, torch.stack([gmag, rmag]),
                                  dist.ReduceOp.MAX)
                rng = 1.05 * (mags[0] + mags[1])
            else:
                rng = 1.05 * all_reduce(mesh, gmag, dist.ReduceOp.MAX)
            rng = torch.clamp(rng, min=1e-12)
        else:
            rng = compress_range
        table = quantize.build_table(-rng, rng, bits=compress_bits,
                                     mode=compress_mode, device=flat.device)
        if average:
            # pre-divide so every partial sum is a partial MEAN (bounded by
            # max|g|); the residual lives in this /n domain across steps
            segs = segs / n
        for i in range(n - 1):  # reduce-scatter
            send_idx = (idx - i) % n
            val = segs[send_idx]
            if use_ef:
                val = val + res[send_idx]
            codes = sparse_kernels.quantize_pack(table, val)
            if use_ef:
                res[send_idx] = val - quantize.extract(table, codes)
            recv = ring_shift(mesh, codes)
            segs[(idx - i - 1) % n] += quantize.extract(table, recv)
        # rank idx owns the fully reduced segment (idx + 1) % n; the
        # all-gather circulates its CODES, decoded through one table
        own = (idx + 1) % n
        own_val = segs[own]
        if use_ef:
            own_val = own_val + res[own]
        own_codes = sparse_kernels.quantize_pack(table, own_val)
        if use_ef:
            res[own] = own_val - quantize.extract(table, own_codes)
        codes = torch.zeros(segs.shape, dtype=quantize.code_dtype(
            compress_bits), device=segs.device)
        codes[own] = own_codes
        for i in range(n - 1):  # all-gather
            send_idx = (idx + 1 - i) % n
            codes[(idx - i) % n] = ring_shift(mesh, codes[send_idx])
        out = quantize.extract(table, codes).reshape(-1)
        if use_ef:
            return out, res.reshape(-1)
        return out

    for i in range(n - 1):  # reduce-scatter
        send_idx = (idx - i) % n
        recv = ring_shift(mesh, segs[send_idx])
        segs[(idx - i - 1) % n] += recv
    for i in range(n - 1):  # all-gather
        send_idx = (idx + 1 - i) % n
        segs[(idx - i) % n] = ring_shift(mesh, segs[send_idx])
    out = segs.reshape(-1)
    if average:
        out = out / n  # ring_collect.h:61-68 divides by ring size
    return out


def _sorted_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def ravel_tree(tree, device=None):
    """``jax.flatten_util.ravel_pytree`` for a (nested) dict of tensors —
    BufferFusion (buffer_fusion.h:53-65): the leaves, keys sorted at every
    level as JAX orders them, as one flat vector; and the function that
    cuts a vector of that length back into the tree."""
    items = list(_sorted_leaves(tree))
    if items:
        flat = torch.cat([t.reshape(-1) for _, t in items])
    else:
        flat = torch.zeros(0, device=device)

    def unravel(vec: torch.Tensor) -> dict:
        out: dict = {}
        ofs = 0
        for path, t in items:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = vec[ofs:ofs + t.numel()].reshape(t.shape)
            ofs += t.numel()
        return out

    return flat, unravel


def ef_residual_init(mesh, tree) -> torch.Tensor:
    """Zero error-feedback carry of :func:`ring_all_reduce`'s EF mode for
    this rank: the padded flat length of ``tree`` (the JAX function's
    [n, padded] stack, one row per rank, each rank holding its own)."""
    n = mesh.size
    length = ravel_tree(tree)[0].numel()
    padded = ((length + n - 1) // n) * n
    return torch.zeros(padded, dtype=torch.float32, device=mesh.device)


def ring_all_reduce(
    mesh,
    tree: dict,
    average: bool = True,
    compress_bits: Optional[int] = None,
    compress_range=1.0,
    compress_mode: str = "uniform",
    residual: Optional[torch.Tensor] = None,
):
    """Explicit ring all-reduce of this rank's ``tree`` ({name: tensor},
    the per-worker gradients): every rank gets the reduced (mean by
    default) tree.  ``compress_bits`` codes every hop; ``residual`` (from
    :func:`ef_residual_init`) is the EF-SGD carry, and the call then
    returns ``(tree, new_residual)``."""
    n = mesh.size
    if residual is not None and compress_bits is None:
        raise ValueError("error-feedback residual needs compress_bits")
    flat, unravel = ravel_tree(tree, device=mesh.device)
    length = flat.shape[0]
    padded = ((length + n - 1) // n) * n
    flat = torch.nn.functional.pad(flat, (0, padded - length))
    out = _ring_all_reduce_local(
        flat, mesh, n, average, compress_bits=compress_bits,
        compress_range=compress_range, residual=residual,
        compress_mode=compress_mode)
    if residual is not None:
        out, new_res = out
        return unravel(out[:length]), new_res
    return unravel(out[:length])


def psum_all_reduce(mesh, tree, average: bool = True) -> dict:
    """The production path: the backend's own all-reduce of every leaf
    (mean by default)."""
    out = {}
    for k, v in tree.items():
        r = all_reduce(mesh, v)
        out[k] = r / mesh.size if average else r
    return out


# -- byte accounting (pure Python, the JAX package's) -------------------------
#
# SparCML (arXiv:1802.08021) / Parallax (arXiv:1808.02621): each member
# ships its deduped (uids, rows) pair, one all_gather moves O(touched)
# ids+values, and the density switch back to the dense ring is a static
# pick from shapes alone.


def _wire_value_bytes(compress_bits: Optional[int]) -> int:
    return 4 if compress_bits is None else (1 if compress_bits <= 8 else 2)


def _wire_row_bytes(dim: int, compress_bits: Optional[int]) -> int:
    """Wire bytes of ONE row of ``dim`` values under the codec: fp32
    (None), 2-byte codes (9..16 bits), 1-byte codes (5..8 bits), or the
    bit-packed sub-byte codes (<= 4 bits: two codes per byte)."""
    if compress_bits is None:
        return int(dim) * 4
    if compress_bits <= 4:
        return (int(dim) + 1) // 2
    return int(dim) * _wire_value_bytes(compress_bits)


def sparse_exchange_bytes(n: int, k_padded: int, dim: int,
                          compress_bits: Optional[int] = None,
                          include_ids: bool = True) -> int:
    """Bytes each member TRANSMITS per :func:`sparse_all_reduce` call: the
    other members' [k_padded] id + [k_padded, dim] value segments once
    each; ``include_ids=False`` prices a table riding a shared id
    stream."""
    idb = 4 if include_ids else 0
    return int((n - 1) * int(k_padded)
               * (idb + _wire_row_bytes(dim, compress_bits)))


def dense_ring_bytes(vocab: int, dim: int, n: int,
                     compress_bits: Optional[int] = None) -> int:
    """Bytes each member transmits per dense ring all-reduce of a
    [vocab, dim] gradient."""
    return int(2 * (n - 1) * int(vocab)
               * _wire_row_bytes(dim, compress_bits) // n)


def prefer_sparse_exchange(n: int, k_padded: int, vocab: int, dim: int,
                           sparse_bits: Optional[int] = None,
                           dense_bits: Optional[int] = None,
                           margin: float = 1.0) -> bool:
    """SparCML's density switch: True when the padded sparse payload is
    cheaper than ``margin`` times the dense ring's bytes."""
    return (sparse_exchange_bytes(n, k_padded, dim, sparse_bits)
            <= margin * dense_ring_bytes(vocab, dim, n, dense_bits))


#: slack multiplier on the expected bucket / merged-shard sizes of the
#: reduce-scatter exchange
RS_SLACK = 1.3

#: extra hysteresis the reduce-scatter variant must clear against the
#: dense ring (its rounds and merge cost latency the byte model misses)
RS_DENSE_MARGIN = 0.9


def rs_default_caps(n: int, k_padded: int, vocab: int,
                    slack: float = RS_SLACK) -> Tuple[int, int]:
    """(bucket_cap, shard_cap) of the reduce-scatter exchange, from static
    shapes only (expected sizes with slack)."""
    k = max(1, int(k_padded))
    owned = -(-int(vocab) // n)  # ceil(vocab / n)
    bucket = min(k, owned, max(1, -(-int(slack * k) // n)))
    density = min(k / float(vocab), 1.0)
    u_hat = float(vocab) * (1.0 - (1.0 - density) ** n)
    shard = min(n * bucket, owned + 1,
                max(bucket, int(slack * u_hat / n) + 2))
    return bucket, shard


def sparse_rs_bytes(n: int, bucket_cap: int, shard_cap: int, dim: int,
                    compress_bits: Optional[int] = None,
                    include_ids: bool = True) -> int:
    """Bytes each member transmits per reduce-scatter exchange: n-1
    destination buckets plus n-1 merged-shard segments."""
    idb = 4 if include_ids else 0
    per_entry = idb + _wire_row_bytes(dim, compress_bits)
    return int((n - 1) * (int(bucket_cap) + int(shard_cap)) * per_entry)


def pick_exchange_algo(
    n: int,
    k_padded: int,
    vocab: int,
    dim: int,
    sparse_bits: Optional[int] = None,
    dense_bits: Optional[int] = None,
    margin: float = 1.0,
    slack: float = RS_SLACK,
    rs_margin: float = RS_DENSE_MARGIN,
    local_n: Optional[int] = None,
) -> Tuple[str, int]:
    """The single-fabric exchange pick -> ``(algo, bytes)``: ``"dense" |
    "sparse" | "sparse_rs"`` from static shapes.  The cheaper sparse
    variant must beat ``margin`` times the dense ring, the reduce-scatter
    variant additionally ``rs_margin`` times it.  The two-fabric form
    (``local_n`` < ``n``, the hierarchical exchange) is not ported."""
    if local_n is not None and local_n < n:
        raise ValueError("pick_exchange_algo: the two-fabric form (local_n < "
                         "n, the hierarchical exchange) not yet ported to "
                         "lightctr_tpu_torch (see ROADMAP.md §A)")
    dense_b = dense_ring_bytes(vocab, dim, n, dense_bits)
    ag_b = sparse_exchange_bytes(n, k_padded, dim, sparse_bits)
    bucket, shard = rs_default_caps(n, k_padded, vocab, slack)
    rs_b = sparse_rs_bytes(n, bucket, shard, dim, sparse_bits)
    algo, sb = ("sparse", ag_b) if ag_b <= rs_b else ("sparse_rs", rs_b)
    eff = margin * (rs_margin if algo == "sparse_rs" else 1.0)
    if sb <= eff * dense_b:
        return algo, sb
    if algo == "sparse_rs" and ag_b <= margin * dense_b:
        return "sparse", ag_b
    return "dense", dense_b


# -- the allgather sparse exchange -------------------------------------------


def _coded_exchange(payload: torch.Tensor, exchange, mesh,
                    compress_bits: int, compress_range,
                    compress_mode: str) -> torch.Tensor:
    """Single-shot quantile-coded collective: ONE mesh-global table
    (dynamic range = one MAX all-reduce of the local payload's magnitude,
    1.05 headroom, 1e-12 floor), encode with the ``quantize_pack`` kernel,
    run ``exchange`` on the narrow codes, decode on the receiver."""
    if compress_range == "dynamic":
        mag = (payload.abs().max() if payload.numel()
               else payload.new_zeros(()))
        rng = 1.05 * all_reduce(mesh, mag, dist.ReduceOp.MAX)
        rng = torch.clamp(rng, min=1e-12)
    else:
        rng = compress_range
    table = quantize.build_table(-rng, rng, bits=compress_bits,
                                 mode=compress_mode, device=payload.device)
    return quantize.extract(
        table, exchange(sparse_kernels.quantize_pack(table, payload)))


def _ag_gather_ids(uids: torch.Tensor, mesh):
    """Id half of the allgather sparse exchange: one all-gather of the [K]
    id stream and the union/inverse every rank computes identically (the
    ``dedup_ids`` kernel on the card).  Tables sharing one id stream
    gather and dedup it once."""
    all_ids = all_gather(mesh, uids)
    uniq, inv, _ = sparse_kernels.dedup_ids(all_ids)
    return all_ids, uniq, inv


def _ef_valid_mask(uids: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcastable validity mask over an id stream: every slot except
    the padded id-0 repeats past slot 0 (the dedup convention)."""
    k = uids.shape[0]
    valid = ~((uids == 0) & (torch.arange(k, device=uids.device) > 0))
    return valid.to(like.dtype).reshape((-1,) + (1,) * (like.ndim - 1))


def _ag_exchange_rows(
    rows: torch.Tensor,
    mesh,
    compress_bits: Optional[int] = None,
    compress_range="dynamic",
    compress_mode: str = "uniform",
    uids: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
):
    """Gather/decode half of the allgather sparse exchange (no merge, no
    mean): every rank's [K, ...] payload, optionally quantile-coded, lands
    as [n*K, ...] decoded rows -> ``(all_rows, residual | None)``.

    ``residual``: the [vocab, ...] EF carry for CLIPPED payloads under a
    FIXED ``compress_range`` (needs ``uids``), updated in place by the
    ``quantize_pack_ef_update`` kernel: compensate, encode, decode and
    write the fresh error back in one pass."""
    use_ef = residual is not None
    if compress_bits is None:
        if use_ef:
            raise ValueError("sparse error feedback needs compress_bits")
        return all_gather(mesh, rows), None
    if not use_ef:
        return _coded_exchange(rows, lambda c: all_gather(mesh, c), mesh,
                               compress_bits, compress_range,
                               compress_mode), None
    if not isinstance(compress_range, (int, float)):
        raise ValueError(
            "sparse error feedback compensates FIXED-range clipping; "
            "compress_range='dynamic' never clips — pass a float range")
    if uids is None:
        raise ValueError("sparse error feedback needs uids")
    table = quantize.build_table(-compress_range, compress_range,
                                 bits=compress_bits, mode=compress_mode,
                                 device=rows.device)
    mask = _ef_valid_mask(uids, rows)
    codes, residual, _ = sparse_kernels.quantize_pack_ef_update(
        table, rows, uids, residual, mask)
    return quantize.extract(table, all_gather(mesh, codes)), residual


def _ag_merge_rows(rows, inv, mesh, n, num_segments, average=True,
                   compress_bits=None, compress_range="dynamic",
                   compress_mode="uniform", uids=None, residual=None):
    """Row half of the allgather sparse exchange: gather every rank's
    payload and merge the duplicates through the shared ``inv`` with the
    ``merge_rows`` kernel (mean when ``average``).  Returns ``merged`` or
    ``(merged, residual)`` when a residual is given."""
    all_rows, new_residual = _ag_exchange_rows(
        rows, mesh, compress_bits=compress_bits,
        compress_range=compress_range, compress_mode=compress_mode,
        uids=uids, residual=residual)
    merged = sparse_kernels.merge_rows(all_rows, inv, num_segments)
    if average:
        merged = merged / n
    if residual is not None:
        return merged, new_residual
    return merged


def _sparse_all_reduce_local(uids, rows, mesh, n, average=True,
                             compress_bits=None, compress_range="dynamic",
                             compress_mode="uniform", residual=None):
    """This rank's deduped ``uids`` [K] (padded by repeating id 0) and
    ``rows`` [K, ...] against every other rank's -> ``(all_uids,
    merged)`` [n*K] / [n*K, ...], identical on every rank: the sorted
    union padded with id 0 and each id's cross-rank sum (mean when
    ``average``) in its slot."""
    _, uniq, inv = _ag_gather_ids(uids, mesh)
    out = _ag_merge_rows(
        rows, inv, mesh, n, num_segments=uniq.shape[0], average=average,
        compress_bits=compress_bits, compress_range=compress_range,
        compress_mode=compress_mode, uids=uids, residual=residual)
    if residual is not None:
        merged, new_residual = out
        return uniq, merged, new_residual
    return uniq, out


def sparse_all_reduce(mesh, uids, rows, average: bool = True,
                      compress_bits: Optional[int] = None,
                      compress_range="dynamic",
                      compress_mode: str = "uniform",
                      residual: Optional[torch.Tensor] = None):
    """Sparse all-reduce of this rank's (ids, row-gradients) pair: ``uids``
    [K] deduped and padded, ``rows`` [K, ...] their summed values.
    Returns ``(all_uids [n*K], merged [n*K, ...])``, the same on every
    rank — O(touched) bytes on the wire instead of the dense ring's
    O(vocab).  ``residual`` (from :func:`sparse_ef_residual_init`) is the
    EF carry of clipped payloads under a FIXED float ``compress_range``;
    the call then returns ``(all_uids, merged, residual)``."""
    return _sparse_all_reduce_local(
        uids, rows, mesh, mesh.size, average=average,
        compress_bits=compress_bits, compress_range=compress_range,
        compress_mode=compress_mode, residual=residual)


def sparse_ef_residual_init(mesh, table_shape) -> torch.Tensor:
    """Zero EF carry of :func:`sparse_all_reduce`'s clipped-payload mode
    for this rank: one [vocab, ...] table-keyed residual (the JAX
    function's [n, vocab, ...] stack holds one per rank)."""
    return torch.zeros(tuple(table_shape), dtype=torch.float32,
                       device=mesh.device)
