"""Hierarchical two-level sparse exchange — the cross-host half.

The port's copy of ``lightctr_tpu/dist/hier.py``: host code (sockets and
numpy), its frames byte-identical, so a port client talks to a JAX shard
and the other way round.

The sparse collectives of ``dist.collectives`` keep intra-host bytes
O(touched) over the host's own process group (the fast link; ``ici`` in
the cost model's names); this socket wire merges across hosts (the slow
link; ``dcn``).  Composing them is the software analogue of in-network
aggregation (PAPERS.md: Programmable Switches, arXiv:2205.05243 —
aggregate where the data crosses the slow link) applied to SparCML-style
sparse payloads (arXiv:1802.08021): a host's ranks first merge touched
rows over their group, then exactly ONE merged (uids, rows) payload per
host rides this wire, and the pulled cross-host merge is broadcast back
to the host's ranks — cross-host bytes stay O(touched-per-host)
regardless of the number of local ranks.

This module is the rendezvous that wire needs:

  - :class:`SparseReduceShard` — one owner shard of the reduce rendezvous:
    a threaded socket service speaking the PS framing (``[u32 len][type]
    [payload]``, ``dist.ps_server``) with the SAME hot-path ops.  MSG_PUSH
    lands one host's merged (uids, rows) contribution for a ``(epoch,
    table)`` round; once all ``n_hosts`` contributions arrived, MSG_PULL
    answers the merged cross-host union (duplicate ids segment-summed,
    exactly the owner-side merge of ``sparse_reduce_scatter`` — but across
    hosts).  A pull before the round completes gets the WITHHELD status
    byte (the SSP pull convention) and the client retries with backoff.
    Trace context rides the frames (``wire.TRACE_FLAG``) and telemetry
    lands in a registry served over MSG_STATS.
  - :class:`HierExchangeClient` — the host-side stub: owner-partitions the
    merged payload by ``uid % n_shards`` (the PS modulo family, so the
    intra-host merge output is already shard-aligned), pushes every shard,
    then pulls the merged unions back and splices them into one sorted
    (uids, rows) pair.  ``push``/``pull`` are exposed separately so a
    caller simulating several hosts in one process (the bench) can push
    all hosts before any pull.

Wire codec: the exact fp32 form (``pack_keys`` ++ raw fp32 rows — the PS
admin-op encoding) is the default, because the exchange is a COLLECTIVE,
not storage: every branch of the trainer's exchange stays exact, and a
codec belongs behind an explicit knob exactly like ``compress_bits`` on
the in-host paths.  ``codec="f16"`` ships ``wire.pack_rows`` instead (the
PS hot-path fp16 policy, half the value bytes, the reference's training
numerics).  ``codec="q8_ef"`` puts the quantile-coded ERROR-FEEDBACK wire
on the rendezvous (SparCML's sparse quantized streams, arXiv:1802.08021,
on the slowest link per arXiv:2205.05243): pushes ship
``wire.pack_rows_coded`` frames (tagged id stream + 1-byte quantile codes
over a per-frame dynamic range) with a MEMBER-side sparse EF carry — the
encode compensates from last step's carried quantization error, the
socket-wire twin of the trainer's ``sres`` opt-state — and the shard
answers merged-round pulls through an OWNER-side carry (the stage-2
sum-mode reduce-scatter EF, carried across rounds), encoding each round
exactly once so every host decodes identical bytes.  Dynamic ranges never
clip, so both carries stay sub-bucket (tested).  The dense+loss
pseudo-table always rides exact fp32 (``push(..., exact=True)``) — the
loss readout must not wobble with the codec.

Wire-level shared id streams: tables listing the identical batch-field
tuple produce the identical merged id union, so :meth:`HierExchangeClient.
push_group` / :meth:`~HierExchangeClient.pull_group` ship ONE tagged id
stream per (host, field group) with per-table value sections referencing
it by position — the socket-wire twin of the trainer's shared id streams.
All forms are self-describing; fp32/f16 frames are bit-identical to the
first, ungrouped wire.
"""

from __future__ import annotations

import collections
import json
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from lightctr_tpu_torch.dist import wire
from lightctr_tpu_torch.dist.ps_server import (
    MAX_FRAME_BYTES,
    MSG_CLOSE,
    MSG_PULL,
    MSG_PUSH,
    MSG_STATS,
    PSClient,
    _recv_msg,
)
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs import resources as obs_resources
from lightctr_tpu_torch.obs import trace as obs_trace
from lightctr_tpu_torch.obs.registry import (
    MetricsRegistry,
    default_registry,
    labeled,
)

#: per-round straggler-attribution series — declared like
#: EXCHANGE_SERIES/HEALTH_SERIES, so a new round metric cannot ship dark.  The shard-side histogram is keyed
#: by HOST: a slow host shows up BY NAME in one scrape, and the cluster
#: rollup's straggler attributor (obs/cluster.py) ranks hosts off its
#: sum/count.
HIER_ROUND_SERIES = (
    "hier_round_wait_seconds",            # shard hist {host}: FIRST-chunk
                                          # arrival offset behind the
                                          # round's first push
    "hier_round_chunk_spread_seconds",    # shard hist {host}: last-chunk
                                          # minus first-chunk offset (a slow
                                          # TRICKLER, vs a late starter)
    "hier_round_client_seconds",          # client hist: push->pull-satisfied
    "hier_round_withheld_retries_total",  # client counter: withheld retries
    "hier_stripe_push_bytes_total",       # client counter {stripe}: push
                                          # frame bytes per rendezvous shard
    "hier_stripe_pull_bytes_total",       # client counter {stripe}: pull
                                          # reply bytes per rendezvous shard
)

#: push/pull header codec flags (a varint bitfield, so old peers that only
#: know bit 0 read an unknown bit as a codec they cannot parse and fail
#: LOUD on the payload, never silently misparse it):
#:   bit 0 — exact fp32 payload (pack_keys ++ raw fp32 rows)
#:   bit 1 — quantile-coded payload (the tagged ``wire.pack_rows_coded``
#:           frame / ``pack_codes_section`` group sections)
#:   bit 2 — GROUP frame: one shared id stream + per-table value sections
#:   bit 3 — CHUNKED push: the payload is prefixed with
#:           ``wire.pack_chunk_header`` — one fixed row WINDOW of this
#:           host's contribution (the streaming rendezvous); an
#:           unflagged frame is exactly chunk (0, 1)
#:   bit 4 — NIBBLE pull: the puller asks the owner-side encode for 4-bit
#:           codes (``codec="q4_ef"``) — the header is frozen at exactly
#:           five varints, so the code width rides a flag, not a field
FLAG_F32 = 1
FLAG_CODED = 2
FLAG_GROUP = 4
FLAG_CHUNK = 8
FLAG_NIBBLE = 16

#: code width of the ``q8_ef`` wire codec (<= 8 — one byte per value)
CODED_BITS = 8

#: code width of the ``q4_ef`` wire codec (two codes per byte — the
#: nibble packing of ``ops.quantize.pack_nibbles``, on the socket wire)
NIBBLE_BITS = 4


class _EFCarry:
    """Sparse table-keyed error-feedback carry: the socket-wire twin of
    the trainer's dense ``[vocab, dim]`` ``sres`` opt-state, keyed only by
    the rows actually seen so neither endpoint needs to know the vocab.
    ``get`` returns zeros for unseen ids; ``set`` overwrites the carried
    rows (the EF recipe carries ``val - dec``, a full replacement, not an
    accumulation)."""

    __slots__ = ("dim", "keys", "rows")

    def __init__(self, dim: int):
        self.dim = int(dim)
        self.keys = np.zeros(0, np.int64)
        self.rows = np.zeros((0, self.dim), np.float32)

    def get(self, uids: np.ndarray) -> np.ndarray:
        out = np.zeros((len(uids), self.dim), np.float32)
        if self.keys.size and len(uids):
            pos = np.searchsorted(self.keys, uids)
            pos_c = np.minimum(pos, self.keys.size - 1)
            hit = self.keys[pos_c] == uids
            out[hit] = self.rows[pos_c[hit]]
        return out

    def set(self, uids: np.ndarray, rows: np.ndarray) -> None:
        """Already-carried ids update IN PLACE (the steady state once the
        hot working set has been seen — O(step ids), no rebuild); only
        genuinely new ids pay the union merge.  Memory converges to the
        touched-id footprint — the same [vocab, dim]-bounded trade the
        trainer's dense ``sres`` carry documents, here shrunk to rows
        actually seen."""
        if not len(uids):
            return
        uids = np.ascontiguousarray(uids, np.int64)
        rows = np.ascontiguousarray(rows, np.float32)
        if not self.keys.size:
            self.keys = uids.copy()
            self.rows = rows.copy()
            return
        pos = np.searchsorted(self.keys, uids)
        pos_c = np.minimum(pos, self.keys.size - 1)
        hit = self.keys[pos_c] == uids
        self.rows[pos_c[hit]] = rows[hit]
        if hit.all():
            return
        fresh = ~hit
        union = np.union1d(self.keys, uids[fresh])
        merged = np.zeros((union.size, self.dim), np.float32)
        merged[np.searchsorted(union, self.keys)] = self.rows
        merged[np.searchsorted(union, uids[fresh])] = rows[fresh]
        self.keys, self.rows = union, merged

    def mass(self) -> float:
        """Sum |carry| — the undelivered residual mass telemetry."""
        return float(np.abs(self.rows).sum())

    def max_abs(self) -> float:
        return float(np.abs(self.rows).max()) if self.rows.size else 0.0


def _encode_payload(uids: np.ndarray, rows: np.ndarray, flags: int) -> bytes:
    """Non-coded payload encodes (the first wire, byte-identical): exact
    fp32 or the PS fp16 ``pack_rows`` frame.  Coded frames are built at
    the call sites (the encoder needs the decoded view for its EF
    carry)."""
    if flags & FLAG_F32:
        return wire.pack_keys(uids) + np.ascontiguousarray(
            rows, np.float32
        ).tobytes()
    return wire.pack_rows(uids, rows)


def _decode_payload(
    payload: bytes, dim: int, flags: int
) -> Tuple[np.ndarray, np.ndarray]:
    if flags & FLAG_CODED:
        keys, rows, consumed = wire.unpack_rows_coded(payload, dim)
        if consumed != len(payload):
            raise ValueError(
                f"coded reduce payload length mismatch: consumed "
                f"{consumed} of {len(payload)} bytes"
            )
        return keys, rows
    if flags & FLAG_F32:
        keys, consumed = wire.split_keys(payload)
        rows = np.frombuffer(payload[consumed:], np.float32)
        if rows.size != len(keys) * dim:
            raise ValueError(
                f"f32 reduce payload carries {rows.size} values for "
                f"{len(keys)} keys at dim {dim} (peer dim skew?)"
            )
        return keys, rows.reshape(len(keys), dim).copy()
    keys, rows, consumed = wire.unpack_rows(payload, dim)
    if consumed != len(payload):
        raise ValueError(
            f"reduce payload length mismatch: consumed {consumed} of "
            f"{len(payload)} bytes (peer dim skew?)"
        )
    return keys, rows


def _decode_section(buf: bytes, n: int, dim: int, flags: int
                    ) -> Tuple[np.ndarray, int]:
    """One GROUP value section -> ([n, dim] fp32 rows, bytes consumed),
    by the frame's codec flags."""
    if flags & FLAG_CODED:
        return wire.unpack_codes_section(buf, n, dim)
    if flags & FLAG_F32:
        need = 4 * n * dim
        if len(buf) < need:
            raise ValueError(
                f"f32 group section carries {len(buf)} bytes for "
                f"{n}x{dim} rows"
            )
        return (np.frombuffer(buf[:need], np.float32)
                .reshape(n, dim).copy(), need)
    need = 2 * n * dim
    if len(buf) < need:
        raise ValueError(
            f"f16 group section carries {len(buf)} bytes for {n}x{dim} rows"
        )
    return wire.unpack_values(buf[:need], (n, dim)), need


class _Round:
    """One (epoch, table) reduction round.  Every contribution is a
    sequence of ``n_chunks`` disjoint sorted uid windows (a legacy
    unchunked frame is exactly chunk ``(0, 1)``); ``chunks_seen`` /
    ``chunks_total`` dedup retried chunks — at-least-once delivery counts
    each window ONCE — and decide host completion without an
    end-of-stream frame.  In STREAMING mode each chunk
    segment-merges into the bounded ``(acc_keys, acc_rows)`` accumulator
    AS IT ARRIVES, so round memory tracks the cross-host id UNION rather
    than ``n_hosts × payload``; in barrier mode chunks buffer in
    ``contrib`` and merge lazily on the first complete pull (the barrier
    path, retained as the bench A/B baseline).  ``coded_section`` caches
    the ONE owner-side EF-compensated encode of the merged rows (every
    host must decode identical bytes and the owner carry must advance
    exactly once per round); ``ids_bytes`` caches the tagged id stream
    beside it.  ``t0`` is the perf-counter instant of the round's FIRST
    push; ``first_off``/``last_off`` are the per-host first- and
    last-chunk offsets behind it — a late STARTER and a slow TRICKLER
    are different straggler diagnoses."""

    __slots__ = ("contrib", "acc_keys", "acc_rows", "chunks_seen",
                 "chunks_total", "first_off", "last_off", "merged",
                 "pulled", "dim", "coded_section", "ids_bytes", "t0",
                 "arrivals")

    def __init__(self, dim: int):
        self.contrib: Dict[int, list] = {}
        self.acc_keys: Optional[np.ndarray] = None
        self.acc_rows: Optional[np.ndarray] = None
        self.chunks_seen: Dict[int, set] = {}
        self.chunks_total: Dict[int, int] = {}
        self.first_off: Dict[int, float] = {}
        self.last_off: Dict[int, float] = {}
        self.merged: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.pulled: set = set()
        self.dim = dim
        self.coded_section: Optional[bytes] = None
        self.ids_bytes: Optional[bytes] = None
        self.t0: Optional[float] = None
        self.arrivals: List[Tuple[int, float]] = []

    def hosts_done(self) -> int:
        """Hosts whose every declared chunk has arrived."""
        return sum(1 for h, t in self.chunks_total.items()
                   if len(self.chunks_seen[h]) >= t)

    def accumulate(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Sorted-merge one chunk into the streaming accumulator: ids
        already accumulated segment-sum in place, fresh ids pay one union
        merge.  Chunks of one host window DISJOINT uid ranges, so each
        (host, uid) adds exactly once per round — the dedup in ``_push``
        plus this invariant is what keeps chunked and single-shot rounds
        numerically aligned."""
        if not keys.size:
            return
        if self.acc_keys is None or not self.acc_keys.size:
            self.acc_keys = keys.astype(np.int64, copy=True)
            self.acc_rows = rows.astype(np.float32, copy=True)
            return
        pos = np.searchsorted(self.acc_keys, keys)
        pos_c = np.minimum(pos, self.acc_keys.size - 1)
        hit = self.acc_keys[pos_c] == keys
        self.acc_rows[pos_c[hit]] += rows[hit]
        if hit.all():
            return
        fresh = ~hit
        union = np.union1d(self.acc_keys, keys[fresh])
        merged = np.zeros((union.size, self.dim), np.float32)
        merged[np.searchsorted(union, self.acc_keys)] = self.acc_rows
        merged[np.searchsorted(union, keys[fresh])] = rows[fresh]
        self.acc_keys, self.acc_rows = union, merged

    def nbytes(self) -> int:
        """Live payload bytes this round pins (accumulator, barrier
        buffers, merged result) — the shard's peak-memory telemetry."""
        total = 0
        if self.acc_keys is not None:
            total += self.acc_keys.nbytes + self.acc_rows.nbytes
        for parts in self.contrib.values():
            for _, k, r in parts:
                total += k.nbytes + r.nbytes
        if self.merged is not None:
            total += self.merged[0].nbytes + self.merged[1].nbytes
        return total


class SparseReduceShard:
    """One owner shard of the cross-host reduce rendezvous (class
    docstring above).  ``n_hosts`` is the round-completion bar: a pull is
    withheld until that many distinct hosts pushed ALL their declared
    chunks of the round.

    ``streaming=True`` (the default) reduces each arriving
    chunk into the round's bounded accumulator off the wire — peak round
    memory tracks the cross-host id union, independent of ``n_hosts`` —
    and per-uid sums land in ARRIVAL order (every host still pulls
    bit-identical merged rows: all hosts read the one accumulator; with
    two hosts the sum is also bit-equal to the barrier merge by
    commutativity).  ``streaming=False`` retains the first wire's barrier: buffer
    every contribution, merge once in (host-id, chunk-idx) order with one
    ``np.add.at`` segment sum — the replicas-cannot-diverge contract of
    the in-host exchanges carried across the DCN, and the bench's A/B
    baseline arm."""

    #: completed rounds older than this many epochs behind the newest seen
    #: are dropped even if a host never pulled them (a crashed host must
    #: not pin every round in memory forever)
    ROUND_GC_LAG = 16

    #: bounded per-round arrival ring served in stats(): the newest
    #: completed rounds' per-host arrival offsets (straggler timelines a
    #: scrape can read back verbatim, beside the histogram's aggregate)
    ARRIVAL_RING = 64

    def __init__(self, n_hosts: int, host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 streaming: bool = True):
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        self.n_hosts = int(n_hosts)
        self.streaming = bool(streaming)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._rounds: Dict[Tuple[int, int], _Round] = {}
        self._max_epoch = -(1 << 62)
        # high-water mark of live round payload bytes (accumulators +
        # barrier buffers) — the flat-as-n_hosts-doubles acceptance gate
        # reads this from stats()
        self._peak_round_bytes = 0
        # owner-side EF carries, one sparse table-keyed carry per table:
        # the stage-2 sum-mode rs EF of the in-host exchange, across the
        # DCN — each merged round's encode compensates from the previous
        # round's quantization error (docs/SPARSE_EXCHANGE.md)
        self._owner_carry: Dict[int, _EFCarry] = {}
        self._counts = {"pushes": 0, "pulls": 0, "withheld": 0,
                        "rounds_merged": 0, "protocol_errors": 0,
                        "coded_rounds": 0}
        # newest completed rounds' arrival timelines (REAL rounds only —
        # probe rounds have one contributor and nothing to attribute)
        self._arrivals: collections.deque = collections.deque(
            maxlen=self.ARRIVAL_RING
        )
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._stop = threading.Event()
        self._peers: List = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()

    # -- the reduction ------------------------------------------------------

    #: lingering probe rounds kept (a probe push whose client died before
    #: the pull must not pin memory; epoch-lag GC cannot see them — probe
    #: epochs are negative and deliberately exempt from it)
    PROBE_ROUNDS_KEPT = 16

    def _gc_locked(self) -> None:
        # REAL rounds age out by epoch lag only (a completed round is
        # retained until then so a host whose pull REPLY was lost can
        # retry and still be served — see _pull); probe rounds are exempt
        # from the lag (their epochs are negative, which would read as
        # infinitely stale) and bounded by count instead
        stale = [key for key in self._rounds
                 if 0 <= key[0] < self._max_epoch - self.ROUND_GC_LAG]
        # probe epochs grow MORE NEGATIVE as they get newer (per host,
        # later reps are lower), so ascending order puts the newest first
        # — keep the head, reap the tail (the oldest abandoned probes)
        probes = sorted(key for key in self._rounds if key[0] < 0)
        stale += probes[self.PROBE_ROUNDS_KEPT:]
        for key in stale:
            del self._rounds[key]

    def _bar(self, epoch: int) -> int:
        # negative epochs are single-contributor PROBE rounds (the
        # bandwidth probe must complete without the other hosts)
        return 1 if epoch < 0 else self.n_hosts

    def _push(self, host_id: int, epoch: int, table: int,
              keys: np.ndarray, rows: np.ndarray, dim: int,
              chunk: Tuple[int, int] = (0, 1)) -> None:
        chunk_idx, n_chunks = int(chunk[0]), int(chunk[1])
        arrival = None
        spread = None
        with self._lock:
            # stamped INSIDE the lock: arrivals are ordered by the merge
            # order the round actually sees, so offsets behind t0 can
            # never go negative under concurrent handler threads
            now = time.perf_counter()
            self._counts["pushes"] += 1
            self._max_epoch = max(self._max_epoch, epoch)
            rd = self._rounds.get((epoch, table))
            if rd is None:
                rd = self._rounds[(epoch, table)] = _Round(dim)
            elif rd.dim != dim:
                raise ValueError(
                    f"round ({epoch}, {table}) dim skew: {rd.dim} vs {dim}"
                )
            if rd.merged is not None:
                # a retried push after the merge (its reply was lost):
                # at-least-once delivery, the contribution already counted
                return
            total = rd.chunks_total.get(host_id)
            if total is None:
                rd.chunks_total[host_id] = total = n_chunks
                rd.chunks_seen[host_id] = set()
            elif total != n_chunks:
                raise ValueError(
                    f"host {host_id} chunk-count skew in round "
                    f"({epoch}, {table}): declared {total}, now {n_chunks}"
                )
            seen = rd.chunks_seen[host_id]
            if chunk_idx in seen:
                # a duplicate retried chunk (its reply was lost): counted
                # exactly once — the accumulator must never double-add
                return
            seen.add(chunk_idx)
            if self.streaming:
                rd.accumulate(keys, rows)
            else:
                rd.contrib.setdefault(host_id, []).append(
                    (chunk_idx, keys, rows)
                )
            self._peak_round_bytes = max(
                self._peak_round_bytes,
                sum(r.nbytes() for r in self._rounds.values()),
            )
            # arrival timeline (REAL rounds, first delivery per chunk):
            # the first-chunk offset behind the round's first push is the
            # late-STARTER signal, the last-minus-first spread the slow-
            # TRICKLER signal — two different straggler diagnoses.
            if epoch >= 0:
                if rd.t0 is None:
                    rd.t0 = now
                off = now - rd.t0
                if len(seen) == 1:
                    arrival = off
                    rd.first_off[host_id] = off
                    rd.arrivals.append((host_id, off))
                rd.last_off[host_id] = off
                if len(seen) >= total:
                    spread = off - rd.first_off[host_id]
                if rd.hosts_done() >= self.n_hosts:
                    # round complete: freeze its timeline into the ring
                    self._arrivals.append({
                        "epoch": int(epoch), "table": int(table),
                        "arrivals": {str(h): round(o, 6)
                                     for h, o in rd.arrivals},
                        "last": {str(h): round(o, 6)
                                 for h, o in rd.last_off.items()},
                        "chunks": {str(h): len(s)
                                   for h, s in rd.chunks_seen.items()},
                        "wait_s": round(max(o for _, o in rd.arrivals), 6),
                    })
            self._gc_locked()
        if obs_gate.enabled():
            if arrival is not None:
                self.registry.observe(
                    labeled("hier_round_wait_seconds", host=str(host_id)),
                    arrival,
                )
            if spread is not None:
                self.registry.observe(
                    labeled("hier_round_chunk_spread_seconds",
                            host=str(host_id)),
                    spread,
                )

    def _pull(self, host_id: int, epoch: int, table: int,
              coded: bool = False, bits: int = CODED_BITS):
        """One host's pull of a round.  Returns None while withheld;
        else the merged ``(uids, rows)`` — or, with ``coded``, the
        round's ``(ids_bytes, coded_section)`` wire bytes.  The coded
        encode happens HERE, under the same lock hold that found the
        round: the owner EF carry advances exactly once per round and
        every host receives byte-identical codes — a GC racing between
        the lookup and the encode (a straggler host vs the epoch-lag
        reaper) can no longer re-encode through an already-advanced
        carry.  ``bits`` picks the code width of that ONE encode (the
        q4_ef nibble wire asks for 4); the first pull's width wins and
        the cached section self-describes, so a skewed puller still
        decodes correctly."""
        bar = self._bar(epoch)
        with self._lock:
            rd = self._rounds.get((epoch, table))
            if rd is None or (rd.merged is None
                              and rd.hosts_done() < bar):
                self._counts["withheld"] += 1
                return None
            if rd.merged is None:
                if self.streaming:
                    # the streaming accumulator IS the merge — chunks
                    # already segment-summed off the wire as they arrived
                    uniq = (rd.acc_keys if rd.acc_keys is not None
                            else np.zeros(0, np.int64))
                    merged = (rd.acc_rows if rd.acc_rows is not None
                              else np.zeros((0, rd.dim), np.float32))
                    rd.merged = (uniq, merged)
                    rd.acc_keys = rd.acc_rows = None
                else:
                    # deterministic barrier merge: (host-id, chunk-idx)
                    # order, one segment sum
                    parts = [p for h in sorted(rd.contrib)
                             for p in sorted(rd.contrib[h],
                                             key=lambda q: q[0])]
                    keys = (np.concatenate([p[1] for p in parts])
                            if parts else np.zeros(0, np.int64))
                    rows = (np.concatenate([p[2] for p in parts])
                            if parts else np.zeros((0, rd.dim),
                                                   np.float32))
                    uniq, inv = np.unique(keys, return_inverse=True)
                    merged = np.zeros((uniq.size, rd.dim), np.float32)
                    np.add.at(merged, inv.reshape(-1), rows)
                    rd.merged = (uniq, merged)
                    rd.contrib.clear()
                self._counts["rounds_merged"] += 1
            if coded and rd.coded_section is None:
                uniq, merged = rd.merged
                carry = self._owner_carry.get(table)
                if carry is None or carry.dim != merged.shape[1]:
                    carry = self._owner_carry[table] = _EFCarry(
                        merged.shape[1]
                    )
                carried = carry.get(uniq)
                val = merged + carried
                rd.coded_section, dec = wire.pack_codes_section(
                    val, bits
                )
                carry.set(uniq, val - dec)
                rd.ids_bytes = wire.pack_ids(uniq)
                self._counts["coded_rounds"] += 1
            self._counts["pulls"] += 1
            out = ((rd.ids_bytes, rd.coded_section) if coded
                   else rd.merged)
            rd.pulled.add(host_id)
            # REAL rounds are retained until the epoch-lag GC even after
            # every host pulled: a pull whose REPLY was lost to a
            # transient reset is retried by the client, and the retry
            # must be served, not withheld until the timeout (pulls are
            # as at-least-once-safe as pushes).  Probe rounds (bar 1,
            # negative epoch) delete eagerly — a failed probe degrades
            # to the default bandwidth by design.
            if epoch < 0 and len(rd.pulled) >= bar:
                del self._rounds[(epoch, table)]
            return out

    def memory_bytes(self) -> Dict[str, int]:
        """One-call ``obs.resources.MemorySampler`` source: the live
        round high-water mark lands in ``resource_memory_bytes{kind=
        "<prefix>_peak_round"}`` next to host RSS and the tiered-store
        tiers, budget-checkable by the memory_pressure detector."""
        with self._lock:
            return {"peak_round": int(self._peak_round_bytes)}

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self._counts)
            out["rounds_open"] = len(self._rounds)
            out["n_hosts"] = self.n_hosts
            out["streaming"] = self.streaming
            # high-water mark of live round payload bytes: the bench's
            # flat-as-n_hosts-doubles shard peak-memory column
            out["peak_round_bytes"] = int(self._peak_round_bytes)
            # undelivered owner-side EF mass per table: with the dynamic
            # per-round range this stays sub-bucket noise (tested) — a
            # growing number here means the codec is eating gradient
            out["owner_ef_mass"] = {
                str(t): round(c.mass(), 6)
                for t, c in self._owner_carry.items()
            }
            # the bounded per-round arrival ring (newest last): who each
            # recent round waited for, readable from one stats scrape
            out["arrivals"] = list(self._arrivals)
        out["telemetry"] = self.registry.snapshot()
        return out

    # -- grouped shared-id frames ------------------------------------------

    @staticmethod
    def _split_group_header(buf: bytes):
        """varint [G] + tables[G] + dims[G] -> (tables, dims, consumed)."""
        g_hdr, used = wire.split_varint(buf, 1)
        g = int(g_hdr[0])
        if not 1 <= g <= 4096:
            raise ValueError(f"group frame claims {g} tables")
        tables, used2 = wire.split_varint(buf[used:], g)
        dims, used3 = wire.split_varint(buf[used + used2:], g)
        if (dims <= 0).any():
            raise ValueError(f"group frame dims must be positive: {dims}")
        return ([int(t) for t in tables], [int(d) for d in dims],
                used + used2 + used3)

    def _group_push(self, host_id: int, epoch: int, flags: int,
                    buf: bytes, chunk: Tuple[int, int] = (0, 1)) -> None:
        """One grouped push: a shared tagged id stream + per-table value
        sections — the ids of a (host, field group) ride the wire ONCE
        and land as one contribution per table's round.  The WHOLE frame
        decodes and validates (sections, trailing bytes) BEFORE the
        first round mutates, matching the single-frame path's
        reject-loudly-never-half-parse invariant — a malformed frame
        must not count its host toward any round's bar.  A chunked group
        frame lands the SAME chunk window in every listed table's round
        (the group shares one id stream, so it shares one chunking)."""
        tables, dims, pos = self._split_group_header(buf)
        keys, used = wire.split_ids(buf[pos:])
        pos += used
        if len(keys) > 1 and not (np.diff(keys) > 0).all():
            raise ValueError("reduce push keys must be sorted unique")
        sections = []
        for table, dim in zip(tables, dims):
            rows, used = _decode_section(buf[pos:], len(keys), dim, flags)
            pos += used
            sections.append((table, dim, rows))
        if pos != len(buf):
            raise ValueError(
                f"group push frame length mismatch: consumed {pos} of "
                f"{len(buf)} bytes"
            )
        for table, dim, rows in sections:
            self._push(host_id, epoch, table, keys, rows, dim, chunk=chunk)

    def _group_pull_reply(self, host_id: int, epoch: int, flags: int,
                          buf: bytes) -> Optional[bytes]:
        """One grouped pull: every listed table's round must be complete
        (else WITHHELD — the client retries the whole group), the merged
        unions must coincide (tables sharing a field group contribute
        identical id streams by construction — anything else is a
        protocol error, not a silent id/value misalignment), and the
        reply ships the union ONCE with per-table value sections."""
        tables, dims, _ = self._split_group_header(buf)
        coded = bool(flags & FLAG_CODED)
        bits = NIBBLE_BITS if flags & FLAG_NIBBLE else CODED_BITS
        outs = []
        for table in tables:
            out = self._pull(host_id, epoch, table, coded=coded, bits=bits)
            if out is None:
                return None
            outs.append(out)
        # tables of one field group contribute identical id streams by
        # construction — anything else is a protocol error, not a silent
        # id/value misalignment (coded rounds compare the cached id
        # section bytes, which encode the union bijectively)
        base = outs[0][0]
        for table, out in zip(tables[1:], outs[1:]):
            same = (out[0] == base if coded
                    else np.array_equal(base, out[0]))
            if not same:
                raise ValueError(
                    f"group pull unions diverge (table {table}): grouped "
                    "tables must share one id stream"
                )
        if coded:
            parts = [base] + [out[1] for out in outs]
        else:
            parts = [wire.pack_ids(base)]
            for out in outs:
                if flags & FLAG_F32:
                    parts.append(np.ascontiguousarray(
                        out[1], np.float32).tobytes())
                else:
                    parts.append(wire.pack_values(out[1])[0])
        return b"".join(parts)

    # -- socket plumbing (the ps_server shape) ------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._peers = [(x, c) for x, c in self._peers if x.is_alive()]
            self._peers.append((t, conn))

    def _serve(self, conn: socket.socket):
        reg = self.registry
        try:
            while True:
                raw_type, payload = _recv_msg(conn, cap=MAX_FRAME_BYTES)
                msg_type = raw_type & ~wire.TRACE_FLAG & 0xFF
                frame_bytes = 5 + len(payload)
                telem = obs_gate.enabled()
                t0 = time.perf_counter() if telem else 0.0
                try:
                    rctx = None
                    if raw_type & wire.TRACE_FLAG:
                        rctx, used = wire.split_trace_ctx(payload)
                        payload = payload[used:]
                    op = {MSG_PUSH: "push", MSG_PULL: "pull",
                          MSG_STATS: "stats"}.get(msg_type, "unknown")
                    span_cm = obs_trace.span(
                        "hier/" + op, remote=rctx, n_bytes=len(payload),
                    ) if (msg_type != MSG_CLOSE
                          and (rctx is not None or obs_trace.enabled())) \
                        else _null_cm()
                    sent = 0
                    with span_cm:
                        if msg_type == MSG_PUSH:
                            hdr, used = wire.split_varint(payload, 5)
                            host_id, epoch, table, dim, flags = (
                                int(x) for x in hdr
                            )
                            body = payload[used:]
                            chunk = (0, 1)
                            if flags & FLAG_CHUNK:
                                chunk, used2 = wire.split_chunk_header(body)
                                body = body[used2:]
                            if flags & FLAG_GROUP:
                                self._group_push(host_id, epoch, flags,
                                                 body, chunk=chunk)
                            else:
                                keys, rows = _decode_payload(
                                    body, dim, flags
                                )
                                if len(keys) > 1 and not \
                                        (np.diff(keys) > 0).all():
                                    raise ValueError(
                                        "reduce push keys must be sorted "
                                        "unique"
                                    )
                                self._push(host_id, epoch, table, keys,
                                           rows, dim, chunk=chunk)
                            conn.sendall(struct.pack("<IB", 1, 0) + b"\x00")
                            sent = 6
                        elif msg_type == MSG_PULL:
                            hdr, used = wire.split_varint(payload, 5)
                            host_id, epoch, table, dim, flags = (
                                int(x) for x in hdr
                            )
                            if flags & FLAG_GROUP:
                                body = self._group_pull_reply(
                                    host_id, epoch, flags, payload[used:]
                                )
                            else:
                                coded = bool(flags & FLAG_CODED)
                                bits = (NIBBLE_BITS
                                        if flags & FLAG_NIBBLE
                                        else CODED_BITS)
                                out = self._pull(host_id, epoch, table,
                                                 coded=coded, bits=bits)
                                if out is None:
                                    body = None
                                elif coded:
                                    body = (bytes([wire.CODED_MAGIC])
                                            + out[0] + out[1])
                                else:
                                    body = _encode_payload(
                                        out[0], out[1], flags
                                    )
                            if body is None:
                                # round incomplete: the SSP withheld byte,
                                # the client retries with backoff
                                conn.sendall(
                                    struct.pack("<IB", 1, 0) + b"\x01"
                                )
                                sent = 6
                            else:
                                conn.sendall(
                                    struct.pack("<IB", 1 + len(body), 0)
                                    + b"\x00" + body
                                )
                                sent = 6 + len(body)
                        elif msg_type == MSG_STATS:
                            body = json.dumps(self.stats()).encode()
                            conn.sendall(
                                struct.pack("<IB", len(body), 0) + body
                            )
                            sent = 5 + len(body)
                        elif msg_type == MSG_CLOSE:
                            return
                        else:
                            conn.sendall(struct.pack("<IB", 1, 0) + b"\xff")
                            sent = 6
                    if telem:
                        reg.inc(labeled("hier_reduce_requests_total", op=op))
                        reg.observe(labeled("hier_reduce_op_seconds", op=op),
                                    time.perf_counter() - t0)
                        reg.inc("hier_reduce_bytes_received_total",
                                frame_bytes)
                        reg.inc("hier_reduce_bytes_sent_total", sent)
                except (ValueError, struct.error):
                    with self._lock:
                        self._counts["protocol_errors"] += 1
                    conn.sendall(struct.pack("<IB", 1, 0) + b"\xff")
                    if telem:
                        reg.inc("hier_reduce_protocol_errors_total")
                    return
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    def close(self):
        self._stop.set()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        self._accept_thread.join(timeout=2.0)
        for t, conn in self._peers:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for t, _ in self._peers:
            t.join(timeout=2.0)
        self._peers = [(t, c) for t, c in self._peers if t.is_alive()]


def _null_cm():
    import contextlib

    return contextlib.nullcontext()


class HierExchangeClient:
    """Host-side stub of the hierarchical exchange: one transport per
    reduce shard (the :class:`~lightctr_tpu_torch.dist.ps_server.PSClient`
    machinery — reconnect with backoff+jitter, trace headers, byte
    counters), payloads owner-partitioned by ``uid % n_shards`` exactly
    like the PS key router, so the intra-host merge output lands on the
    shard that owns it without re-hashing.

    ``codec``: ``"f32"`` (default — exact, the dense-psum-exact branch
    contract), ``"f16"`` (the PS hot-path ``pack_rows`` frame, half the
    value bytes), ``"q8_ef"`` (the quantile-coded error-feedback wire:
    1-byte codes over a per-frame dynamic range, a member-side sparse EF
    carry per table on the push side and the shard's owner-side carry on
    pulls — module docstring), or ``"q4_ef"`` (the same EF recipe at
    4-bit nibble codes, two per byte — the quantize layer's packing on
    the socket wire; coarser buckets, more carried residual, half the
    code bytes).  ``pull_timeout_s`` bounds the withheld-retry loop — a
    peer host that died mid-step must surface as an error, not a hang.

    Streaming dispatch: ``chunk_rows=R`` windows every shard
    partition into ceil(n/R)-chunk pushes so the shard can segment-merge
    off the wire, and transmissions ride ONE single-thread FIFO executor
    per shard — different stripes transmit concurrently (aggregate DCN
    bandwidth scales with shard count) while each shard's socket stays
    strictly ordered (``PSClient`` is not thread-safe).  ``push_async``
    returns once every frame is HANDED to its stripe pipeline;
    ``commit`` joins the in-flight transmissions and re-raises the first
    failure — the dispatch/commit ticket contract of the tiered
    embedding, here overlapping the trainer's compute with the
    DCN push.  ``pull``/``pull_group`` commit defensively, so a pull can
    never overtake this host's own pushes on a stripe.
    ``chunk_rows=None`` (default) ships the legacy single frame per
    shard, byte-identical to the unchunked wire.
    """

    #: withheld-pull backoff: start fast (the peer host is usually mid
    #:  push), cap low (the rendezvous is latency-critical)
    PULL_BACKOFF_BASE_S = 0.001
    PULL_BACKOFF_CAP_S = 0.05

    def __init__(self, addresses, host_id: int, n_hosts: int,
                 codec: str = "f32", pull_timeout_s: float = 120.0,
                 timeout: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 chunk_rows: Optional[int] = None):
        if not addresses:
            raise ValueError("need at least one reduce shard address")
        if codec not in ("f32", "f16", "q8_ef", "q4_ef"):
            raise ValueError(f"unknown wire codec {codec!r}")
        if chunk_rows is not None and int(chunk_rows) < 1:
            raise ValueError("chunk_rows must be >= 1 (or None)")
        # per-round client latency telemetry (HIER_ROUND_SERIES): defaults
        # to the process registry like the trainers
        self.registry = registry if registry is not None else \
            default_registry()
        # first-push perf_counter per open round, popped when the pull is
        # satisfied -> hier_round_client_seconds (bounded: an abandoned
        # round — peer crash before our pull — must not pin entries)
        self._round_t0: Dict[Tuple, float] = {}
        self.addresses = [tuple(a) for a in addresses]
        self.n_shards = len(self.addresses)
        self.host_id = int(host_id)
        self.n_hosts = int(n_hosts)
        self.codec = codec
        self._coded_bits = NIBBLE_BITS if codec == "q4_ef" else CODED_BITS
        self.chunk_rows = None if chunk_rows is None else int(chunk_rows)
        self.pull_timeout_s = float(pull_timeout_s)
        # streaming-dispatch machinery (class docstring): one lazily
        # created single-thread FIFO executor per shard, plus the
        # in-flight frame futures `commit` joins
        self._pools: List[Optional[ThreadPoolExecutor]] = \
            [None] * self.n_shards
        # (future, dispatch-stamp) pairs: commit's join turns the stamps
        # into resource_queue_wait_seconds{queue=hier_stripe_inflight}
        self._inflight: List = []
        self._inflight_lock = threading.Lock()
        # resource-plane face of the stripe pipelines (capacity-less:
        # depth/wait series only — backpressure is the commit join)
        self._inflight_iq = obs_resources.InstrumentedQueue(
            "hier_stripe_inflight", registry=self.registry,
            register=False)
        # chunk-fill accounting (rows shipped vs rows the dispatched
        # windows could hold) — the trainer's chunk telemetry reads these
        self.chunk_pushes_total = 0
        self.chunk_rows_total = 0
        self.chunk_capacity_rows_total = 0
        # member-side EF carries, one sparse table-keyed carry per table
        # (q8_ef only): last step's quantization error re-enters this
        # step's encode, so coded mass is delivered late, never lost
        self._carry: Dict[int, _EFCarry] = {}
        # wire-level shared-id accounting: bytes the grouped frames did
        # NOT ship because tables shared one id stream ((G-1) x the id
        # section, push and pull alike) — metrics_report's dedup ratio
        self.shared_id_saved_bytes = 0
        # PSClient as pure transport: dim is per-call in this protocol
        # (rides the header), so the stub's own dim is never consulted.
        # The transports connect at first use, so a client built on every
        # rank of a host opens sockets only where the host's wire hop runs
        self._timeout = timeout
        self._clients: Optional[List[PSClient]] = None
        self._clients_lock = threading.Lock()

    @property
    def clients(self) -> List[PSClient]:
        """One transport per reduce shard, connected at first use."""
        with self._clients_lock:
            if self._clients is None:
                self._clients = [PSClient(a, dim=1, timeout=self._timeout)
                                 for a in self.addresses]
            return self._clients

    @property
    def connected(self) -> bool:
        """True once the transports were opened."""
        return self._clients is not None

    # -- accounting ---------------------------------------------------------

    @property
    def bytes_sent(self) -> int:
        return sum(c.bytes_sent for c in self._clients or ())

    @property
    def bytes_received(self) -> int:
        return sum(c.bytes_received for c in self._clients or ())

    def carry_mass(self) -> float:
        """Total member-side undelivered EF mass (sum |carry| over
        tables) — sub-bucket noise under the dynamic-range codec."""
        return sum(c.mass() for c in self._carry.values())

    def _note_push(self, key: Tuple) -> None:
        """Stamp a round's FIRST push (later pushes of a retried frame
        keep the original stamp — the latency is push-to-pull-satisfied,
        the whole wait this host saw)."""
        if key not in self._round_t0:
            while len(self._round_t0) >= 1024:  # abandoned-round bound
                self._round_t0.pop(next(iter(self._round_t0)))
            self._round_t0[key] = time.perf_counter()

    def _note_pull_done(self, key: Tuple) -> None:
        t0 = self._round_t0.pop(key, None)
        if t0 is not None and obs_gate.enabled():
            self.registry.observe("hier_round_client_seconds",
                                  time.perf_counter() - t0)

    def _carry_for(self, table: int, dim: int) -> _EFCarry:
        carry = self._carry.get(table)
        if carry is None or carry.dim != dim:
            carry = self._carry[table] = _EFCarry(dim)
        return carry

    def _flags(self, exact: bool = False, group: bool = False) -> int:
        if exact or self.codec == "f32":
            flags = FLAG_F32
        elif self.codec == "q8_ef":
            flags = FLAG_CODED
        elif self.codec == "q4_ef":
            # the NIBBLE bit asks the owner-side pull encode for 4-bit
            # codes; push sections self-describe their width, and an old
            # shard fails loud on the halved code stream (tested)
            flags = FLAG_CODED | FLAG_NIBBLE
        else:
            flags = 0
        return flags | (FLAG_GROUP if group else 0)

    def _hdr(self, epoch: int, table: int, dim: int, flags: int) -> bytes:
        return wire.pack_varint(np.array(
            [self.host_id, epoch, table, dim, flags], np.int64
        ))

    # -- the exchange -------------------------------------------------------

    def _shard_of(self, uids: np.ndarray) -> np.ndarray:
        return ((uids % self.n_shards).astype(np.int64) if len(uids)
                else np.zeros(0, np.int64))

    def _coded_body(self, table: int, uids: np.ndarray, rows: np.ndarray
                    ) -> bytes:
        """One shard partition's coded push frame: compensate from the
        member carry, encode, carry the fresh quantization error — the
        push-side EF recipe (shard partitions touch disjoint uid sets, so
        per-partition encodes share one table-keyed carry safely)."""
        carry = self._carry_for(table, rows.shape[1])
        val = rows + carry.get(uids)
        body, dec = wire.pack_rows_coded(uids, val, self._coded_bits)
        carry.set(uids, val - dec)
        return body

    # -- streaming dispatch ------------------------------------------------

    def _pool(self, s: int) -> ThreadPoolExecutor:
        pool = self._pools[s]
        if pool is None:
            pool = self._pools[s] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"hier-stripe-{s}"
            )
        return pool

    def _dispatch(self, s: int, frame: bytes, what: str,
                  span_attrs: Dict) -> None:
        """Hand one push frame to shard ``s``'s FIFO pipeline.  The
        worker transmits and checks the ack; `commit` re-raises its
        failure.  Stripe byte accounting lands HERE, on the caller
        thread at dispatch, so scrapes never race the workers."""
        if obs_gate.enabled():
            self.registry.inc(
                labeled("hier_stripe_push_bytes_total", stripe=str(s)),
                len(frame),
            )
        client = self.clients[s]

        def _send():
            with obs_trace.span("hier_client/push_chunk",
                                host=self.host_id, **span_attrs):
                reply = client._rpc(MSG_PUSH, frame)
            if reply != b"\x00":
                raise ConnectionError(f"reduce shard {s} refused {what}")

        fut = self._pool(s).submit(_send)
        with self._inflight_lock:
            self._inflight.append((fut, time.monotonic()))
            depth = len(self._inflight)
        self._inflight_iq.note_enqueue()
        self._inflight_iq.set_depth(depth)

    def commit(self) -> None:
        """Join every dispatched push frame — the commit half of the
        overlap ticket (class docstring): block until the in-flight
        transmissions drain, re-raising the first failure.  Idempotent
        and cheap when nothing is in flight."""
        with self._inflight_lock:
            pending, self._inflight = self._inflight, []
        err = None
        for fut, t0 in pending:
            try:
                fut.result()
                self._inflight_iq.note_wait(time.monotonic() - t0)
            except BaseException as e:
                if err is None:
                    err = e
        if pending:
            self._inflight_iq.set_depth(0)
        if err is not None:
            raise err

    def _chunk_windows(self, n: int) -> Optional[List[Tuple[int, int]]]:
        """Row windows ``[(lo, hi)]`` of one n-row shard partition, or
        None for the legacy unchunked single frame (chunk_rows unset).
        An empty partition still yields one (empty) window — the round
        bar counts hosts, so every shard hears from every host."""
        if self.chunk_rows is None:
            return None
        step = self.chunk_rows
        n_chunks = max(1, -(-n // step))
        return [(i * step, min(n, (i + 1) * step))
                for i in range(n_chunks)]

    def push_async(self, table: int, uids: np.ndarray, rows: np.ndarray,
                   epoch: int, exact: bool = False) -> None:
        """Dispatch this host's merged (sorted-unique uids [n], rows
        [n, dim]) contribution for round ``(epoch, table)``,
        owner-partitioned across the shards and windowed into
        ``chunk_rows``-row chunks.  Returns once every frame is handed
        to its stripe pipeline — overlap compute here, `commit` before
        the round's pull.  Every shard receives at least one frame
        (possibly empty — the round bar counts HOSTS, so a host whose
        batch touched no ids owned by a shard must still check in
        there).  Encoding — including the member EF carry advance —
        happens on the CALLER thread in shard-then-chunk order, so
        carries stay deterministic no matter how stripe transmissions
        interleave.  ``exact=True`` forces the fp32 frame regardless of
        codec (the dense+loss pseudo-table: the loss readout must not
        wobble with the wire codec)."""
        uids = np.ascontiguousarray(uids, np.int64)
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[0] != len(uids):
            raise ValueError(
                f"hier push rows must be [n_uids, dim], got {rows.shape} "
                f"for {len(uids)} uids"
            )
        dim = rows.shape[1]
        if len(uids) > 1 and not (np.diff(uids) > 0).all():
            raise ValueError("hier push uids must be sorted unique")
        flags = self._flags(exact)
        chunked = self.chunk_rows is not None
        if chunked:
            flags |= FLAG_CHUNK
        hdr = self._hdr(epoch, table, dim, flags)
        shard = self._shard_of(uids)
        self._note_push((epoch, int(table)))
        with obs_trace.span("hier_client/push", n_keys=int(uids.size),
                            table=table, epoch=epoch, host=self.host_id):
            for s in range(self.n_shards):
                idx = np.flatnonzero(shard == s)
                su, sr = uids[idx], rows[idx]
                wins = self._chunk_windows(len(su)) or [(0, len(su))]
                for ci, (lo, hi) in enumerate(wins):
                    if flags & FLAG_CODED:
                        body = self._coded_body(table, su[lo:hi],
                                                sr[lo:hi])
                    else:
                        body = _encode_payload(su[lo:hi], sr[lo:hi],
                                               flags)
                    prefix = (wire.pack_chunk_header(ci, len(wins))
                              if chunked else b"")
                    self.chunk_pushes_total += 1
                    self.chunk_rows_total += hi - lo
                    self.chunk_capacity_rows_total += (
                        self.chunk_rows if chunked else hi - lo
                    )
                    self._dispatch(
                        s, hdr + prefix + body,
                        f"push for round ({epoch}, {table})",
                        {"table": table, "epoch": epoch, "chunk": ci,
                         "n_keys": hi - lo},
                    )

    def push(self, table: int, uids: np.ndarray, rows: np.ndarray,
             epoch: int, exact: bool = False) -> None:
        """Synchronous push: `push_async` + `commit` — ship and confirm
        this host's contribution before returning (the original call
        shape)."""
        self.push_async(table, uids, rows, epoch, exact=exact)
        self.commit()

    def push_group_async(self, tables, uids: np.ndarray, rows_list,
                         epoch: int) -> None:
        """Grouped dispatch for tables sharing ONE id stream (the same
        batch-field tuple): the tagged id section rides each chunk frame
        once and every table contributes a value section referencing it
        by position — the wire twin of the in-host shared streams.
        ``rows_list[i]`` is table ``tables[i]``'s [n, dim_i] rows over
        the SHARED sorted-unique ``uids``.  A chunk windows the shared
        ids, so it lands the same window in every listed table's round."""
        tables = [int(t) for t in tables]
        uids = np.ascontiguousarray(uids, np.int64)
        rows_list = [np.asarray(r, np.float32) for r in rows_list]
        if len(tables) != len(rows_list) or not tables:
            raise ValueError("push_group needs one rows array per table")
        for r in rows_list:
            if r.ndim != 2 or r.shape[0] != len(uids):
                raise ValueError(
                    f"group rows must be [n_uids, dim], got {r.shape} "
                    f"for {len(uids)} uids"
                )
        if len(uids) > 1 and not (np.diff(uids) > 0).all():
            raise ValueError("hier push uids must be sorted unique")
        dims = [r.shape[1] for r in rows_list]
        flags = self._flags(group=True)
        chunked = self.chunk_rows is not None
        if chunked:
            flags |= FLAG_CHUNK
        hdr = self._hdr(epoch, tables[0], dims[0], flags)
        g_hdr = (wire.pack_varint(np.array([len(tables)], np.int64))
                 + wire.pack_varint(np.array(tables, np.int64))
                 + wire.pack_varint(np.array(dims, np.int64)))
        shard = self._shard_of(uids)
        self._note_push((epoch, tuple(tables)))
        with obs_trace.span("hier_client/push_group", n_keys=int(uids.size),
                            tables=len(tables), table=tables[0],
                            epoch=epoch, host=self.host_id):
            for s in range(self.n_shards):
                idx = np.flatnonzero(shard == s)
                su = uids[idx]
                srs = [r[idx] for r in rows_list]
                wins = self._chunk_windows(len(su)) or [(0, len(su))]
                for ci, (lo, hi) in enumerate(wins):
                    cu = su[lo:hi]
                    ids_sec = wire.pack_ids(cu)
                    self.shared_id_saved_bytes += \
                        (len(tables) - 1) * len(ids_sec)
                    parts = [g_hdr, ids_sec]
                    for t, r in zip(tables, srs):
                        cr = r[lo:hi]
                        if flags & FLAG_CODED:
                            carry = self._carry_for(t, cr.shape[1])
                            val = cr + carry.get(cu)
                            sec, dec = wire.pack_codes_section(
                                val, self._coded_bits
                            )
                            carry.set(cu, val - dec)
                        elif flags & FLAG_F32:
                            sec = np.ascontiguousarray(
                                cr, np.float32
                            ).tobytes()
                        else:
                            sec = wire.pack_values(cr)[0]
                        parts.append(sec)
                    prefix = (wire.pack_chunk_header(ci, len(wins))
                              if chunked else b"")
                    self.chunk_pushes_total += 1
                    self.chunk_rows_total += hi - lo
                    self.chunk_capacity_rows_total += (
                        self.chunk_rows if chunked else hi - lo
                    )
                    self._dispatch(
                        s, hdr + prefix + b"".join(parts),
                        f"group push for epoch {epoch} tables {tables}",
                        {"table": tables[0], "tables": len(tables),
                         "epoch": epoch, "chunk": ci, "n_keys": hi - lo},
                    )

    def push_group(self, tables, uids: np.ndarray, rows_list,
                   epoch: int) -> None:
        """Synchronous grouped push: `push_group_async` + `commit`."""
        self.push_group_async(tables, uids, rows_list, epoch)
        self.commit()

    def _pull_one(self, c, s: int, hdr: bytes, what: str):
        """One shard's pull with the withheld-retry loop -> reply body."""
        deadline = time.monotonic() + self.pull_timeout_s
        attempt = 0
        while True:
            # a shard-side protocol error replies b"\xff", which _rpc
            # surfaces as ProtocolRejection (raised, never retried
            # here); only the WITHHELD byte b"\x01" loops
            reply = c._rpc(MSG_PULL, hdr)
            if reply[:1] == b"\x00":
                if obs_gate.enabled():
                    self.registry.inc(
                        labeled("hier_stripe_pull_bytes_total",
                                stripe=str(s)),
                        len(reply) - 1,
                    )
                return reply[1:]
            if obs_gate.enabled():
                self.registry.inc("hier_round_withheld_retries_total")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"reduce round {what} never completed on shard {s} "
                    f"within {self.pull_timeout_s}s (peer host down?)"
                )
            time.sleep(min(self.PULL_BACKOFF_CAP_S,
                           self.PULL_BACKOFF_BASE_S * (2 ** attempt)))
            attempt += 1

    @staticmethod
    def _splice(keys_parts, rows_parts, dim: int):
        keys = np.concatenate(keys_parts) if keys_parts else \
            np.zeros(0, np.int64)
        rows = np.concatenate(rows_parts) if rows_parts else \
            np.zeros((0, dim), np.float32)
        order = np.argsort(keys, kind="stable")
        return keys[order], rows[order], order

    def pull(self, table: int, epoch: int, dim: int, exact: bool = False
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch round ``(epoch, table)``'s cross-host merge: per shard,
        retry withheld replies with capped backoff until the round
        completes, then splice the shard unions into one globally sorted
        (uids [U], rows [U, dim]) pair.  Commits first: a pull must never
        overtake this host's own dispatched pushes on a stripe.  The
        per-shard pulls ride the stripe pipelines CONCURRENTLY — the
        aggregate DCN bandwidth of the striped topology applies to the
        pull leg exactly as to the push leg (each shard is its own
        link), and the per-stripe FIFO keeps each shard's connection
        single-threaded."""
        self.commit()
        flags = self._flags(exact)
        hdr = self._hdr(epoch, table, dim, flags)
        keys_parts, rows_parts = [], []
        with obs_trace.span("hier_client/pull", table=table, epoch=epoch,
                            host=self.host_id):
            futs = [self._pool(s).submit(self._pull_one, c, s, hdr,
                                         f"({epoch}, {table})")
                    for s, c in enumerate(self.clients)]
            for fut in futs:
                body = fut.result()
                k, r = _decode_payload(body, dim, flags)
                keys_parts.append(k)
                rows_parts.append(r)
        self._note_pull_done((epoch, int(table)))
        keys, rows, _ = self._splice(keys_parts, rows_parts, dim)
        return keys, rows

    def pull_group(self, tables, epoch: int, dims
                   ) -> Tuple[np.ndarray, list]:
        """Grouped pull: one request per shard fetches every listed
        table's merged round behind ONE shared id stream -> (globally
        sorted union uids [U], [rows_i [U, dim_i] per table]).  The
        shard withholds until ALL the group's rounds complete.  Commits
        first and rides the stripe pipelines concurrently, like
        `pull`."""
        self.commit()
        tables = [int(t) for t in tables]
        dims = [int(d) for d in dims]
        flags = self._flags(group=True)
        hdr = self._hdr(epoch, tables[0], dims[0], flags)
        req = (wire.pack_varint(np.array([len(tables)], np.int64))
               + wire.pack_varint(np.array(tables, np.int64))
               + wire.pack_varint(np.array(dims, np.int64)))
        keys_parts = []
        rows_parts = [[] for _ in tables]
        with obs_trace.span("hier_client/pull_group", tables=len(tables),
                            table=tables[0], epoch=epoch,
                            host=self.host_id):
            futs = [self._pool(s).submit(self._pull_one, c, s, hdr + req,
                                         f"({epoch}, group {tables})")
                    for s, c in enumerate(self.clients)]
            for fut in futs:
                body = fut.result()
                keys, pos = wire.split_ids(body)
                self.shared_id_saved_bytes += (len(tables) - 1) * pos
                keys_parts.append(keys)
                for i, d in enumerate(dims):
                    rows, used = _decode_section(
                        body[pos:], len(keys), d, flags
                    )
                    pos += used
                    rows_parts[i].append(rows)
                if pos != len(body):
                    raise ValueError(
                        f"group pull reply length mismatch: consumed "
                        f"{pos} of {len(body)} bytes"
                    )
        self._note_pull_done((epoch, tuple(tables)))
        keys, rows0, order = self._splice(keys_parts, rows_parts[0],
                                          dims[0])
        out_rows = [rows0]
        for i in range(1, len(tables)):
            stacked = (np.concatenate(rows_parts[i]) if rows_parts[i]
                       else np.zeros((0, dims[i]), np.float32))
            out_rows.append(stacked[order])
        return keys, out_rows

    def exchange(self, table: int, uids: np.ndarray, rows: np.ndarray,
                 epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        """push + pull for one round — the per-table wire half of the
        hierarchical exchange.  Blocks until every host's contribution
        arrived (the rendezvous barrier)."""
        rows = np.asarray(rows, np.float32)
        self.push(table, uids, rows, epoch)
        return self.pull(table, epoch, rows.shape[1])

    # -- the DCN bandwidth probe (cost-model input) --------------------------

    def probe_bw(self, payload_bytes: int = 1 << 18, reps: int = 3) -> float:
        """Measured DCN bytes/s: round-trip a reduce round of
        ``payload_bytes`` through shard 0 (push + pull moves the payload
        both ways) on the reserved probe table, ``reps`` times, median.
        Probe rounds ride NEGATIVE epochs, which the shard completes at a
        single contribution — the probe needs no peer hosts (each host's
        probe epochs are disjoint, so concurrent probes cannot collide)."""
        self.commit()  # the probe talks to shard 0 directly: drain first
        dim = 64
        n = max(1, payload_bytes // (4 * dim))
        uids = np.arange(1, n + 1, dtype=np.int64) * self.n_shards  # shard 0
        rows = np.ones((n, dim), np.float32)
        c = self.clients[0]
        # the probe measures LINK speed: always the exact fp32 frame, so
        # probe rounds never touch the EF carries and a coded config
        # measures the same wire a flat config would
        flags = FLAG_F32
        body = _encode_payload(uids, rows, flags)
        ts = []
        for i in range(reps):
            hdr = wire.pack_varint(np.array(
                [self.host_id, -(self.host_id * reps + i + 1), PROBE_TABLE,
                 dim, flags], np.int64
            ))
            t0 = time.perf_counter()
            if c._rpc(MSG_PUSH, hdr + body) != b"\x00":
                raise ConnectionError("probe push refused")
            reply = c._rpc(MSG_PULL, hdr)
            if reply[:1] != b"\x00":
                raise ConnectionError("probe pull withheld (n_hosts > 1?)")
            ts.append(time.perf_counter() - t0)
        moved = 2 * len(body)  # push up + pull down
        return moved / max(float(np.median(ts)), 1e-9)

    def stats(self) -> List[Dict]:
        self.commit()  # stats share the shard sockets: drain first
        out = []
        for c in self.clients:
            out.append(json.loads(c._rpc(MSG_STATS, b"").decode()))
        return out

    def close(self) -> None:
        for pool in self._pools:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        for c in self._clients or ():
            try:
                c.close()
            except OSError:
                pass


#: reserved table id for bandwidth-probe rounds — no real table uses it
PROBE_TABLE = (1 << 30) - 1
