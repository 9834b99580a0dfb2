"""Collectives: explicit ring all-reduce and the sparse exchange.

The port's counterpart of ``lightctr_tpu/dist/collectives.py``.  The JAX
functions run per device under ``shard_map`` and name their mesh axis; here
each runs in one rank's process and takes the :class:`~lightctr_tpu_torch.
core.mesh.Mesh` in place of ``axis_name``.  The JAX collectives map so:

  ``all_gather(tiled=True)``  an all-gather along dim 0 (:func:`all_gather`)
  ``pmax`` / ``psum``         ``all_reduce`` with MAX / SUM
  ``pmean``                   ``all_reduce`` SUM, then ``/ n``
  ``ppermute`` (rotate by s)  paired ``isend``/``irecv`` to the ranks s
                              ahead and s behind (:func:`permute`, several
                              tensors and shifts in one batch;
                              :func:`ring_shift` and :func:`ring_shift_all`
                              are its shift of one, either way round)

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

import logging
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
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


def ring_shift(mesh, x: torch.Tensor) -> torch.Tensor:
    """``ppermute`` over the ring's neighbour table (ring_collect.h:26-40:
    rank j sends to (j+1) % n): send ``x`` to the next rank, return what
    the previous rank sent."""
    return ring_shift_all(mesh, (x,))[0]


def ring_shift_all(mesh, xs, reverse: bool = False) -> list:
    """:func:`ring_shift` of every tensor of ``xs`` in one batch
    (``reverse``: send to the previous rank, return what the next one
    sent)."""
    return permute(mesh, xs, -1 if reverse else 1)


def permute(mesh, xs, shift) -> list:
    """``lax.ppermute`` over the rotate-by-``shift`` table ``[(j, (j +
    shift) % n)]``: send each tensor of ``xs`` to rank ``(r + shift) % n``
    and return what rank ``(r - shift) % n`` sent it.  ``shift`` is one
    int for every tensor or a sequence, one a tensor.  Every hop goes in
    one ``batch_isend_irecv``, posted in the order given, so every rank
    posts the same sequence; a shift of 0 mod n returns a copy."""
    n, r = mesh.size, mesh.rank
    shifts = [shift] * len(xs) if isinstance(shift, int) else list(shift)
    ops, recvs = [], []
    for x, s in zip(xs, shifts):
        s %= n
        if s == 0:
            recvs.append(None)
            continue
        src = _staged(mesh, x)
        if src.dtype in _AS_BYTES:
            src = src.view(torch.uint8)
        recv = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, mesh.global_rank((r + s) % n),
                           mesh.group),
                dist.P2POp(dist.irecv, recv, mesh.global_rank((r - s) % n),
                           mesh.group)]
        recvs.append(recv)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [x.clone() if recv is None else
            (recv.view(x.dtype) if x.dtype in _AS_BYTES else recv)
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


def rs_fits(per_member_ids, n: int, bucket_cap: int, shard_cap: int) -> bool:
    """Host-side exact capacity check for one batch (numpy): True when
    every member's per-owner unique-id count fits ``bucket_cap`` and every
    owner's cross-member union fits ``shard_cap``.  ``per_member_ids``:
    one raw (pre-dedup) integer id array per mesh member.  The hybrid
    trainer runs it before the reduce-scatter step and takes the allgather
    when it returns False, so the capacity guess never corrupts a step."""
    uniques = []
    for ids in per_member_ids:
        u = np.unique(np.asarray(ids).reshape(-1))
        if u.size:
            counts = np.bincount((u % n).astype(np.int64), minlength=n)
            if counts.max(initial=0) > bucket_cap:
                return False
        uniques.append(u)
    gu = np.unique(np.concatenate(uniques)) if uniques else np.zeros(0)
    if not gu.size:
        return True
    counts = np.bincount((gu % n).astype(np.int64), minlength=n)
    # +1: the id-0 padding slot can ride into every owner's shard
    return bool(counts.max(initial=0) + 1 <= shard_cap)


def sparse_rs_bytes(n: int, bucket_cap: int, shard_cap: int, dim: int,
                    compress_bits: Optional[int] = None,
                    include_ids: bool = True) -> int:
    """Bytes each member transmits per reduce-scatter exchange: n-1
    destination buckets plus n-1 merged-shard segments."""
    idb = 4 if include_ids else 0
    per_entry = idb + _wire_row_bytes(dim, compress_bits)
    return int((n - 1) * (int(bucket_cap) + int(shard_cap)) * per_entry)


# -- the two-fabric cost model (pure Python, the JAX package's) ---------------
#
# A multi-host deployment has two fabrics: the fast link inside a host (the
# host's own process group, which the collectives above run on; ``ici`` in
# the names, the JAX package's word for it) and the slower network between
# hosts (the socket wire of ``dist/hier.py``; ``dcn`` in the names).  A flat
# collective spanning both runs at the slowest link's speed: every ring or
# permute schedule above moves one segment a hop, so the hop that crosses
# hosts gates the whole exchange.  The hierarchical exchange aggregates
# where the data crosses the slow link (the in-network-aggregation
# argument, arXiv:2205.05243, on SparCML-style sparse payloads): ranks
# merge inside the host first, then exactly ONE merged (uids, rows)
# payload per host rides the network, so cross-host bytes stay
# O(touched-per-host) whatever the number of local ranks.  The pick
# between the flat algorithms and the hierarchy is therefore a TIME
# comparison over measured link bandwidths, not a byte comparison on one
# fabric.

#: fallback link speeds (bytes/s) when neither the env override nor a probe
#: supplied a measurement: the JAX package's defaults, kept so both packages
#: pick alike unprobed.  They are no claim about any machine the port runs
#: on: measure with :func:`measure_ici_bw` and ``HierExchangeClient.probe_bw``
DEFAULT_ICI_BPS = 4.0e9
DEFAULT_DCN_BPS = 2.5e8

#: env override: ``LIGHTCTR_LINK_BW="<ici_bytes_per_s>:<dcn_bytes_per_s>"``
LINK_BW_ENV = "LIGHTCTR_LINK_BW"


class LinkBandwidth(NamedTuple):
    """Measured (or configured) fabric speeds the cost model prices with.
    ``source``: "env" | "probe" | "default" — artifacts record where the
    numbers came from, so a defaulted model can't masquerade as measured."""

    ici_bps: float
    dcn_bps: float
    source: str = "default"


_link_bw_cache: Optional[LinkBandwidth] = None


def link_bandwidth(probe_ici=None, probe_dcn=None,
                   refresh: bool = False) -> LinkBandwidth:
    """The process's link-bandwidth estimate, resolved once and cached
    (re-probing every step would make the pick flap with probe noise;
    ``refresh=True`` re-resolves).  Priority: :data:`LINK_BW_ENV`
    override, then the probe callables (zero-arg -> bytes/s; e.g.
    :func:`measure_ici_bw` / ``HierExchangeClient.probe_bw``), then the
    defaults.  A probe that raises is logged and its link takes the
    default (``source`` stays "probe" if the other probe answered, so a
    caller that needs both measured checks each figure).  A cached
    DEFAULT resolution never shadows a later call that brings probes."""
    global _link_bw_cache
    if _link_bw_cache is not None and not refresh:
        if _link_bw_cache.source != "default" or (
                probe_ici is None and probe_dcn is None):
            return _link_bw_cache
    env = os.environ.get(LINK_BW_ENV, "").strip()
    if env:
        ici_s, _, dcn_s = env.partition(":")
        bw = LinkBandwidth(float(ici_s), float(dcn_s or ici_s), "env")
    else:
        ici = dcn = None
        try:
            ici = float(probe_ici()) if probe_ici is not None else None
        except Exception:  # a failed probe degrades to the default, loudly
            logging.getLogger(__name__).warning(
                "ICI bandwidth probe failed; using default", exc_info=True)
        try:
            dcn = float(probe_dcn()) if probe_dcn is not None else None
        except Exception:
            logging.getLogger(__name__).warning(
                "DCN bandwidth probe failed; using default", exc_info=True)
        source = "probe" if (ici is not None or dcn is not None) else "default"
        bw = LinkBandwidth(ici or DEFAULT_ICI_BPS, dcn or DEFAULT_DCN_BPS,
                           source)
    if bw.ici_bps <= 0 or bw.dcn_bps <= 0:
        raise ValueError(f"link bandwidths must be positive, got {bw}")
    _link_bw_cache = bw
    return bw


def measure_ici_bw(mesh, axis: str = "data", payload_bytes: int = 1 << 22,
                   reps: int = 3) -> float:
    """Startup probe of the host's own link: the median wall time of one
    tiled :func:`all_gather` of a ``payload_bytes`` float32 vector over
    the mesh's process group (after one warm-up call) -> bytes each rank
    transmitted per second ((n-1)/n of the gathered array leaves through
    this rank).  Every rank of the group must call it.  The vector lives
    on the mesh's device; on a gloo group a CUDA vector is staged through
    host memory, so ranks that share one card measure gloo through host
    memory, not a device link."""
    mesh.require_axis(axis, "measure_ici_bw")
    n = mesh.size
    if n < 2:
        return DEFAULT_ICI_BPS
    per = max(1, payload_bytes // 4 // n)
    x = torch.zeros(per, dtype=torch.float32, device=mesh.device)

    def once():
        out = all_gather(mesh, x)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)

    once()  # warm-up: the group's first collective sets up its buffers
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        ts.append(time.perf_counter() - t0)
    moved = (n - 1) * per * 4  # bytes through one member's outgoing link
    return moved / max(float(np.median(ts)), 1e-9)


def expected_union(k: int, vocab: int, members: int) -> int:
    """Expected unique-id union of ``members`` independent K-id streams
    over ``vocab`` rows (the same uniform-id estimator
    :func:`rs_default_caps` sizes its shards with)."""
    density = min(max(int(k), 1) / float(max(int(vocab), 1)), 1.0)
    u = float(vocab) * (1.0 - (1.0 - density) ** max(int(members), 1))
    return max(1, min(int(u) + 1, int(vocab), int(members) * int(k)))


def hier_wire_bytes(k_out: int, k_in: int, dim: int,
                    wire_bits: Optional[int] = None,
                    include_ids: bool = True) -> int:
    """Bytes ONE HOST moves over the network per hierarchical exchange of
    one table: push its ``k_out`` locally-merged entries + pull the
    ``k_in``-entry cross-host union, each entry an id plus ``dim`` values
    (``wire_bits`` None = the exact fp32 codec, 16 = the fp16 codec,
    5..8 = 1-byte codes — the client's ``q8_ef`` frame, <= 4 = nibble
    codes at two per byte — its ``q4_ef`` frame).  Flat in local rank
    count by construction: the ranks merged before the wire."""
    idb = 4 if include_ids else 0
    per = idb + _wire_row_bytes(dim, wire_bits)
    return int((int(k_out) + int(k_in)) * per)


def hier_exchange_bytes(local_n: int, n_hosts: int, k_padded: int,
                        vocab: int, dim: int,
                        sparse_bits: Optional[int] = None,
                        wire_bits: Optional[int] = None,
                        slack: float = RS_SLACK) -> Tuple[str, int, int]:
    """Static-shape byte model of the two-level exchange ->
    ``(local_algo, local_bytes, wire_bytes)``: the intra-host merge rides
    the cheaper of the two sparse collectives over the ``local_n``-rank
    host group (``local_algo``), then one merged payload per host (the
    expected union of the local streams) is pushed and the expected
    cross-host union pulled over the network.  ``k_padded`` is the
    PER-RANK padded id count, as everywhere in this module."""
    ag_b = sparse_exchange_bytes(local_n, k_padded, dim, sparse_bits)
    bucket, shard = rs_default_caps(local_n, k_padded, vocab, slack)
    rs_b = sparse_rs_bytes(local_n, bucket, shard, dim, sparse_bits)
    local_algo, local_b = (("sparse", ag_b) if ag_b <= rs_b
                           else ("sparse_rs", rs_b))
    if local_n <= 1:
        local_algo, local_b = "none", 0
    k_out = expected_union(k_padded, vocab, local_n)
    k_in = expected_union(k_padded, vocab, local_n * n_hosts)
    return local_algo, local_b, hier_wire_bytes(k_out, k_in, dim, wire_bits)


#: hysteresis the HIERARCHICAL pick must clear against the best flat
#: algorithm's modeled time: the wire stage pays a push+pull round trip,
#: host staging and the rendezvous barrier that a bytes/bandwidth model
#: does not see — a near-tie stays on the flat path
HIER_DCN_MARGIN = 0.9

#: switch-away hysteresis when a previous pick is supplied: the challenger
#: must beat the incumbent's modeled time by this factor before the pick
#: moves (bandwidth re-probes jitter a few percent run to run)
PICK_FLAP_MARGIN = 0.8


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
    bw: Optional[LinkBandwidth] = None,
    wire_bits: Optional[int] = None,
    prev: Optional[str] = None,
    hier_margin: float = HIER_DCN_MARGIN,
    stripes: int = 1,
    overlap_push: bool = False,
) -> Tuple[str, int]:
    """The exchange pick -> ``(algo, bytes)``.

    SINGLE-FABRIC form (``local_n`` None or >= ``n``): ``"dense" |
    "sparse" | "sparse_rs"`` from static shapes.  The cheaper sparse
    variant must beat ``margin`` times the dense ring, the reduce-scatter
    variant additionally ``rs_margin`` times it; otherwise the dense path
    wins.

    TWO-FABRIC form (``local_n`` < ``n``: ``n / local_n`` hosts of
    ``local_n`` ranks): a bandwidth-aware cost model.  Of each member's
    ``B`` flat bytes the off-host share ``(n - local_n)/(n - 1)`` crosses
    a host boundary, and the host's ``local_n`` members share one uplink,
    so a flat algorithm takes ``local_n * B * cross / dcn_bps + B * (1 -
    cross) / ici_bps``.  ``"hier"`` takes ``local_bytes / ici_bps +
    wire_bytes / dcn_bps`` (:func:`hier_exchange_bytes`).  ``bw``
    defaults to :func:`link_bandwidth`.  ``hier`` must beat the best flat
    candidate by ``hier_margin``, and with ``prev`` the incumbent keeps
    the pick unless the challenger wins by :data:`PICK_FLAP_MARGIN`.  For
    ``hier`` the returned bytes are the wire bytes per host; ``wire_bits``
    prices the wire codec (:func:`hier_wire_bytes`).  ``stripes``
    reduce shards multiply the wire rate; ``overlap_push=True`` prices a
    push hidden under the next step's local merge:
    ``max(local_t, push_t) + pull_t``."""
    dense_b = dense_ring_bytes(vocab, dim, n, dense_bits)
    ag_b = sparse_exchange_bytes(n, k_padded, dim, sparse_bits)
    bucket, shard = rs_default_caps(n, k_padded, vocab, slack)
    rs_b = sparse_rs_bytes(n, bucket, shard, dim, sparse_bits)

    def flat_pick() -> Tuple[str, int]:
        algo, sb = ("sparse", ag_b) if ag_b <= rs_b else ("sparse_rs", rs_b)
        eff = margin * (rs_margin if algo == "sparse_rs" else 1.0)
        if sb <= eff * dense_b:
            return algo, sb
        if algo == "sparse_rs" and ag_b <= margin * dense_b:
            return "sparse", ag_b
        return "dense", dense_b

    if local_n is None or local_n >= n:
        return flat_pick()
    if n % local_n:
        raise ValueError(
            f"world {n} is not a whole number of {local_n}-replica hosts")
    if bw is None:
        bw = link_bandwidth()
    n_hosts = n // local_n
    _, hier_local_b, hier_wire_b = hier_exchange_bytes(
        local_n, n_hosts, k_padded, vocab, dim, sparse_bits=sparse_bits,
        wire_bits=wire_bits, slack=slack)
    flat_algo, flat_b = flat_pick()
    cross = (n - local_n) / (n - 1)  # off-host share of per-peer traffic

    def flat_time(b: int) -> float:
        return (local_n * b * cross / bw.dcn_bps
                + b * (1.0 - cross) / bw.ici_bps)

    dcn_eff = bw.dcn_bps * max(1, int(stripes))
    local_t = hier_local_b / bw.ici_bps
    if overlap_push:
        k_out = expected_union(k_padded, vocab, local_n)
        k_in = expected_union(k_padded, vocab, local_n * n_hosts)
        push_t = hier_wire_bytes(k_out, 0, dim, wire_bits) / dcn_eff
        pull_t = hier_wire_bytes(0, k_in, dim, wire_bits) / dcn_eff
        hier_t = max(local_t, push_t) + pull_t
    else:
        hier_t = local_t + hier_wire_b / dcn_eff
    times = {flat_algo: flat_time(flat_b), "hier": hier_t}
    bytes_of = {flat_algo: flat_b, "hier": hier_wire_b}
    best = min(times, key=times.get)
    if best == "hier" and times["hier"] > hier_margin * times[flat_algo]:
        best = flat_algo  # near-tie: stay on the flat path
    if prev is not None and prev in times and best != prev:
        if times[best] > PICK_FLAP_MARGIN * times[prev]:
            best = prev  # incumbent keeps a contested pick
    return best, bytes_of[best]


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


# -- the reduce-scatter sparse exchange --------------------------------------
#
# SparCML's split allreduce (arXiv:1802.08021 §4): each rank
# owner-partitions its deduped (uids, rows) by ``uid % n`` (the PS modulo
# family), ships only destination-owned buckets around a rotate-by-i
# permute, the owner merges the duplicates, and only the merged owner
# shards are all-gathered: (n-1)*(bucket_cap + shard_cap) entries a rank
# instead of the allgather's (n-1)*K.


def rs_owner_partition(uids: torch.Tensor, n: int, bucket_cap: int):
    """Owner partition plan for one deduped id stream (owner = uid % n).

    ``uids`` [K] follow the dedup convention (unique ids, padding repeats
    id 0 past slot 0).  Padded repeats are routed nowhere: their rows are
    zero, and dropping them keeps them out of owner 0's bucket.  Returns
    ``(dest [K], order [K], bucket_ids [n, bucket_cap], overflow)``:
    ``order`` is the owner-grouped permutation of the slots (stable, so
    equal owners keep slot order), ``dest`` the flat bucket slot of each
    permuted entry (``n * bucket_cap`` = dropped), so row payloads scatter
    with :func:`rs_scatter_rows` through the same plan.  ``overflow`` (a
    0-d int32 tensor) counts real entries that did not fit their
    bucket."""
    k = uids.shape[0]
    slot = torch.arange(k, device=uids.device)
    owner = torch.remainder(uids, n).to(torch.int32)
    owner = owner.masked_fill((uids == 0) & (slot > 0), n)
    order = torch.argsort(owner, stable=True)
    o_sorted = owner.index_select(0, order)
    first = torch.searchsorted(o_sorted, o_sorted, side="left")
    pos = slot - first
    over = (pos >= bucket_cap) & (o_sorted < n)
    drop = n * bucket_cap
    dest = torch.where((o_sorted >= n) | over, drop,
                       o_sorted.to(torch.int64) * bucket_cap + pos)
    bucket_ids = uids.new_zeros((drop + 1,))
    bucket_ids[dest] = uids.index_select(0, order)
    return (dest, order, bucket_ids[:drop].reshape(n, bucket_cap),
            over.sum(dtype=torch.int32))


def rs_scatter_rows(rows: torch.Tensor, dest: torch.Tensor,
                    order: torch.Tensor, n: int, bucket_cap: int,
                    fill=None) -> torch.Tensor:
    """Scatter a [K, ...] payload into [n, bucket_cap, ...] destination
    buckets through an :func:`rs_owner_partition` plan, empty slots zero
    (``fill`` overrides: the folded-EF path scatters codes and fills with
    the code of 0.0, so the buckets are the codes of zero-filled value
    buckets)."""
    dtype = rows.dtype
    if dtype == torch.uint16:  # index_select/index_put lack uint16
        rows = rows.view(torch.int16)
        if fill is not None:
            fill = torch.as_tensor(fill).view(torch.int16)
    shape = (n * bucket_cap + 1,) + tuple(rows.shape[1:])
    out = rows.new_zeros(shape) if fill is None else \
        rows.new_empty(shape).fill_(fill)
    out[dest] = rows.index_select(0, order)
    return out[:n * bucket_cap].view(dtype).reshape(
        (n, bucket_cap) + tuple(rows.shape[1:]))


def _rs_ring_exchange(buckets: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """Scatter phase: bucket d of every rank reaches rank d.  Hop i (the
    rotate-by-i :func:`permute`, all n-1 hops in one batch) ships one
    [bucket_cap, ...] bucket a rank.  Returns [n, bucket_cap, ...]: slot 0
    this rank's own bucket, slot i the bucket rank (idx - i) % n sent."""
    idx = mesh.rank
    got = permute(mesh, [buckets[(idx + i) % n] for i in range(1, n)],
                  list(range(1, n)))
    return torch.stack([buckets[idx]] + got)


def _rs_merge_ids(all_ids: torch.Tensor, shard_cap: int):
    """Owner-side id merge: the n received [bucket_cap] id buckets ->
    ``(uniq [shard_cap], inv [n*bucket_cap], overflow)``, through the
    ``dedup_ids`` kernel cut at ``shard_cap``.  ``inv`` keeps full ranks,
    so the ids past the cut reach the merge out of range and are dropped;
    ``overflow`` counts them (0 when :func:`rs_fits` held)."""
    uniq, inv, count = sparse_kernels.dedup_ids(all_ids.reshape(-1),
                                                size=shard_cap)
    return uniq, inv, torch.clamp(count - shard_cap, min=0)


def _rs_gather_rows(rows, dest, order, inv, mesh, n, bucket_cap, shard_cap,
                    average=True, compress_bits=None,
                    compress_range="dynamic", compress_mode="uniform",
                    uids=None, residual=None, owner_uids=None,
                    owner_residual=None):
    """Row half of the reduce-scatter exchange against a shared id plan
    (``dest``/``order`` from :func:`rs_owner_partition`, ``inv`` from
    :func:`_rs_merge_ids`): scatter this table's [K, ...] payload into
    destination buckets, route them round the ring, merge at the owner
    with the ``merge_rows`` kernel (mean when ``average``), all-gather the
    merged shards -> [n*shard_cap, ...].  Tables sharing one id stream
    call this once each while the id plan runs once.

    ``residual``: this rank's [vocab, ...] stage-1 EF carry for clipped
    payloads under a FIXED ``compress_range`` (needs ``uids``), updated
    in place: the scatter-phase encode is compensated and its fresh error
    written back by the ``quantize_pack_ef_update`` kernel, and an entry
    dropped by bucket overflow carries its full value forward.

    ``owner_residual``: this rank's [vocab, ...] stage-2 carry for the
    owner's merged-shard encode (needs ``owner_uids``, the owner's merged
    ids).  Only in SUM mode: the merged mean of decoded values cannot
    clip, a merged sum can reach ``n * compress_range``.  Each rank owns
    the ``uid % n == idx`` rows, so the carries never collide.

    Returns ``gathered``, ``(gathered, residual)`` when ``residual`` is
    given, and ``(gathered, residual | None, owner_residual)`` when
    ``owner_residual`` is."""
    use_ef = residual is not None
    use_owner_ef = owner_residual is not None
    table = None
    if use_ef or use_owner_ef:
        if compress_bits is None:
            raise ValueError("sparse error feedback needs compress_bits")
        if not isinstance(compress_range, (int, float)):
            raise ValueError(
                "sparse error feedback compensates FIXED-range clipping; "
                "compress_range='dynamic' never clips — pass a float range")
        table = quantize.build_table(-compress_range, compress_range,
                                     bits=compress_bits, mode=compress_mode,
                                     device=rows.device)
    if use_owner_ef:
        if average:
            raise ValueError(
                "owner_residual is a SUM-mode carry: the averaged merged "
                "shard cannot clip, stage 2 needs no compensation")
        if owner_uids is None:
            raise ValueError("owner-side error feedback needs owner_uids")
    if use_ef:
        if uids is None:
            raise ValueError("sparse error feedback needs uids")
        mask = _ef_valid_mask(uids, rows)
        # compensate, encode, decode and scatter the carry in one kernel
        # pass over the [K, ...] rows, before the bucket scatter: codes are
        # slot-invariant, so scattered codes are the codes of the
        # scattered values
        codes_rows, residual, dec_rows = \
            sparse_kernels.quantize_pack_ef_update(table, rows, uids,
                                                   residual, mask)
        # an entry dropped by bucket overflow reaches no owner: its carry
        # takes the decoded value back (exact zero when rs_fits held)
        kept = rows.new_zeros((uids.shape[0],))
        kept[order] = (dest < n * bucket_cap).to(rows.dtype)
        dropped = (1.0 - kept).reshape((-1,) + (1,) * (rows.ndim - 1))
        residual.index_add_(0, uids, dec_rows * dropped * mask)
        zero_code = quantize.compress(table, rows.new_zeros(()))
        codes = rs_scatter_rows(codes_rows, dest, order, n, bucket_cap,
                                fill=zero_code)
        all_rows = quantize.extract(table, _rs_ring_exchange(codes, mesh, n))
    else:
        bucket_rows = rs_scatter_rows(rows, dest, order, n, bucket_cap)
        if compress_bits is not None:
            all_rows = _coded_exchange(
                bucket_rows, lambda c: _rs_ring_exchange(c, mesh, n), mesh,
                compress_bits, compress_range, compress_mode)
        else:
            all_rows = _rs_ring_exchange(bucket_rows, mesh, n)
    merged = sparse_kernels.merge_rows(
        all_rows.reshape((n * bucket_cap,) + tuple(rows.shape[1:])), inv,
        shard_cap)
    if average:
        merged = merged / n
    if use_owner_ef:
        mask_o = _ef_valid_mask(owner_uids, merged)
        codes_o, owner_residual, _ = sparse_kernels.quantize_pack_ef_update(
            table, merged, owner_uids, owner_residual, mask_o)
        gathered = quantize.extract(table, all_gather(mesh, codes_o))
        return gathered, residual, owner_residual
    if compress_bits is not None:
        gathered = _coded_exchange(merged, lambda c: all_gather(mesh, c),
                                   mesh, compress_bits, compress_range,
                                   compress_mode)
    else:
        gathered = all_gather(mesh, merged)
    if use_ef:
        return gathered, residual
    return gathered


def _rs_ids(uids: torch.Tensor, mesh, n: int, bucket_cap: int,
            shard_cap: int):
    """Id half of the reduce-scatter exchange, once per id stream:
    partition, route the id buckets, merge them at the owner and gather
    the merged shards -> ``(dest, order, uniq, inv, out_ids, overflow)``.
    ``out_ids`` [n*shard_cap] is the n sorted shards end to end, so not
    sorted as a whole; each foreign shard starts with an id-0 pad."""
    dest, order, bucket_ids, over_b = rs_owner_partition(uids, n, bucket_cap)
    all_ids = _rs_ring_exchange(bucket_ids, mesh, n)
    uniq, inv, over_s = _rs_merge_ids(all_ids, shard_cap)
    return dest, order, uniq, inv, all_gather(mesh, uniq), over_b + over_s


def sparse_reduce_scatter(mesh, uids, rows, average: bool = True,
                          vocab: Optional[int] = None,
                          bucket_cap: Optional[int] = None,
                          shard_cap: Optional[int] = None,
                          compress_bits: Optional[int] = None,
                          compress_range="dynamic",
                          compress_mode: str = "uniform",
                          residual: Optional[torch.Tensor] = None,
                          owner_residual: Optional[torch.Tensor] = None):
    """Owner-partitioned sparse all-reduce of this rank's (ids,
    row-gradients) pair, ``uids`` [K] deduped and id-0 padded, ``rows``
    [K, ...] as in :func:`sparse_all_reduce`.  Returns ``(all_uids
    [n*shard_cap], merged [n*shard_cap, ...], overflow)``, the same on
    every rank: the owner shards end to end, each real id once (in its
    owner's shard) with its cross-rank sum (mean when ``average``), the
    id-0 pads of foreign shards with zero rows (the ``.add`` contract of
    :func:`sparse_all_reduce`).  ``overflow`` (0-d int32) counts this
    rank's entries and its shard's ids that did not fit.

    Capacities default to :func:`rs_default_caps` (``vocab`` needed then):
    expected sizes with slack, so exact callers check :func:`rs_fits`
    first and fall back to :func:`sparse_all_reduce`.  ``compress_bits``
    codes both phases' payloads through mesh-global tables.  ``residual``
    (stage 1) and ``owner_residual`` (stage 2, SUM mode) are this rank's
    [vocab, ...] EF carries (:func:`sparse_ef_residual_init`), updated in
    place; each appends itself to the return, stage 1 first."""
    n = mesh.size
    if bucket_cap is None or shard_cap is None:
        if vocab is None:
            raise ValueError(
                "sparse_reduce_scatter needs vocab (to derive default "
                "capacities) or explicit bucket_cap/shard_cap")
        db, ds = rs_default_caps(n, uids.shape[-1], vocab)
        bucket_cap = bucket_cap if bucket_cap is not None else db
        shard_cap = shard_cap if shard_cap is not None else ds
    dest, order, uniq, inv, out_ids, over = _rs_ids(uids, mesh, n,
                                                    bucket_cap, shard_cap)
    out = _rs_gather_rows(
        rows, dest, order, inv, mesh, n, bucket_cap, shard_cap,
        average=average, compress_bits=compress_bits,
        compress_range=compress_range, compress_mode=compress_mode,
        uids=uids, residual=residual,
        owner_uids=uniq if owner_residual is not None else None,
        owner_residual=owner_residual)
    if owner_residual is not None:
        gathered, new_res, new_owner = out
        tail = ((new_res,) if residual is not None else ()) + (new_owner,)
        return (out_ids, gathered, over) + tail
    if residual is not None:
        return (out_ids, out[0], over, out[1])
    return out_ids, out, over
