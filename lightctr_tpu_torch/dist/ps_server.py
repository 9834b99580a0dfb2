"""Network parameter server — the DCN/socket transport of the PS capability.

The reference's PS is a network service: workers push/pull over ZeroMQ with
every value fp16-coded (``paramserver.h:161-163``) and key batches
VarUint-packed (``buffer.h:112-128``).  The repo's other two PS forms cover
one process (``embed/async_ps.py``) and one host (``embed/shm_ps.py``); this
module is the multi-NODE form: a threaded socket server wrapping
:class:`AsyncParamServer` as the store, with ``dist.wire``'s codecs carrying
the actual bytes — sorted-delta varint key streams and fp16 value payloads —
so the hot-path traffic is ~2.3 bytes/key + 2 bytes/element instead of
8 + 4.

Framing (length-prefixed messages over a stream socket):

    [u32 little-endian payload length][1 byte type][payload]

    PULL  -> varint([worker_id+1, epoch]) ++ pack_keys(keys)
    PULL reply <- status byte (0 ok / 1 withheld-or-unrouted)
                  ++ pack_keys(keys) ++ fp16 rows in sorted-key order
    PUSH  -> varint([worker_id, epoch]) ++ pack_keys(keys)
             ++ fp16 grads in sorted-key order
    PUSH reply <- status byte (0 applied / 1 dropped)
    PRELOAD -> pack_keys(keys) ++ fp32 rows (admin op, exact bytes)
    SNAPSHOT -> empty; reply pack_keys(all keys) ++ fp32 rows (admin op)

Admin ops use fp32 (exact); the hot path rides the reference's fp16 policy,
so a pulled row equals the server row to half precision — the identical
numerics the reference's workers train with.
"""

from __future__ import annotations

import contextlib
import json
import logging
import random
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from lightctr_tpu_torch.dist import wire
from lightctr_tpu_torch.dist.elastic import frame_checksum
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
from lightctr_tpu_torch.obs import flight as obs_flight
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs import health as obs_health
from lightctr_tpu_torch.obs import trace as obs_trace
from lightctr_tpu_torch.obs.registry import default_registry, labeled

MSG_PULL = 1
MSG_PUSH = 2
MSG_PRELOAD = 3
MSG_SNAPSHOT = 4
MSG_CLOSE = 5
MSG_BEAT = 6
MSG_STATS = 7
MSG_FAREWELL = 8
# control-plane ops: a MASTER process (owner of the heartbeat monitor)
# broadcasts routing decisions to PS shards that have no monitor of their
# own — the reference's master/paramserver role split (master.h:202-262
# decides, network.h:148-151 the PS obeys)
MSG_UNROUTE = 9
MSG_READMIT = 10
# elastic-membership ops (docs/ELASTICITY.md):
#   ROUTE   -> empty; reply JSON routing table (epoch, members, addresses,
#              workers, rebalancing) — the master publishes, clients poll;
#              a shard with no route provider replies {"epoch": -1}
#   MIGRATE -> varint([epoch]) ++ pack_rows(keys, rows); the shard applies
#              the rows (preload semantics) then replies JSON {"n", "fnv"}
#              where fnv is the lane-FNV checksum of the rows RE-READ from
#              its store — the zero-row-loss verification the rebalance
#              protocol asserts on
#   EVICT   -> pack_keys(keys); reply JSON {"evicted": n} — rows migrated
#              away must not survive as stale duplicates
#   GRACE   -> varint([factor_x1000]); widens (1000 restores) the SSP
#              staleness budget while a rebalance is in flight
MSG_ROUTE = 11
MSG_MIGRATE = 12
MSG_EVICT = 13
MSG_GRACE = 14
# serving-plane ops (lightctr_tpu/serve, docs/SERVING.md) — dispatched by
# the PredictionServer, which shares this module's framing/trace machinery
# (a ParamServerService receiving one replies with the protocol-error
# byte, same as any op it does not serve):
#   PREDICT       -> wire.pack_predict_batch frame with B == 1; reply
#                    status 0x00 ++ fp16 scores, or 0x02 = overloaded/shed
#   PREDICT_BATCH -> same frame, any B (client-side batching)
MSG_PREDICT = 15
MSG_PREDICT_BATCH = 16
# optimizer-state-carrying admin ops (docs/TIERED_STORE.md — the PR 6
# follow-up: an elastic rebalance migrates accumulators, not just rows):
#   MIGRATE_STATE  -> varint([epoch]) ++ pack_rows(keys, rows) ++ fp32
#                     accums in the same sorted-key order (exact bytes:
#                     adagrad accums are unbounded, the fp16 row codec
#                     would overflow them); the shard lands
#                     rows AND accums (migrate_in_state) and replies JSON
#                     {"n", "fnv", "epoch"} where fnv checksums the frame
#                     rebuilt from rows+accums RE-READ from its store.
#                     An old shard replies the protocol-error byte and the
#                     master degrades to row-only MSG_MIGRATE.
#   SNAPSHOT_STATE -> empty; reply pack_keys(keys) ++ fp32 rows ++ fp32
#                     accums (admin op, exact bytes) — the donor-side
#                     source of a state-carrying join migration.
MSG_MIGRATE_STATE = 17
MSG_SNAPSHOT_STATE = 18
# online-learning op (lightctr_tpu/online, docs/ONLINE.md): push-based
# serving freshness off the store's bounded write log —
#   SUBSCRIBE -> varint([since_version, timeout_ms]); the handler LONG-POLLS
#                the store (wait_write_delta, capped at
#                SUBSCRIBE_MAX_WAIT_S server-side) until write_version moves
#                past since_version or the wait expires, then replies JSON
#                {"write_version", "floor", "covered", "entries":
#                 [[version, [uids...], write_ts], ...]} with every logged
#                entry past since_version.  covered=False means the log
#                floor advanced beyond the subscriber's observation — only
#                a full cache drop is safe.  A store without the write-log
#                surface answers the protocol-error byte; subscribers
#                degrade to MSG_STATS polling.
MSG_SUBSCRIBE = 19

# wire-op names for the telemetry series (obs registry)
_OP_NAMES = {
    MSG_PULL: "pull", MSG_PUSH: "push", MSG_PRELOAD: "preload",
    MSG_SNAPSHOT: "snapshot", MSG_BEAT: "beat", MSG_STATS: "stats",
    MSG_FAREWELL: "farewell", MSG_UNROUTE: "unroute",
    MSG_READMIT: "readmit", MSG_ROUTE: "route", MSG_MIGRATE: "migrate",
    MSG_EVICT: "evict", MSG_GRACE: "grace", MSG_PREDICT: "predict",
    MSG_PREDICT_BATCH: "predict_batch",
    MSG_MIGRATE_STATE: "migrate_state",
    MSG_SNAPSHOT_STATE: "snapshot_state",
    MSG_SUBSCRIBE: "subscribe",
}

# server-side cap on one SUBSCRIBE long-poll: bounds how long a handler
# thread can sit parked on the store condition (service shutdown joins
# connection threads with a short timeout), while keeping the idle re-poll
# cost to one tiny RTT every couple of seconds
SUBSCRIBE_MAX_WAIT_S = 2.0

# One garbage length prefix must not make the server buffer gigabytes before
# any validation: cap frames well above any real payload (2^20 keys at
# dim 33 fp32 is ~132 MB).
MAX_FRAME_BYTES = 256 * 1024 * 1024


def _send_msg(
    sock: socket.socket,
    msg_type: int,
    payload: bytes,
    trace_ctx=None,
) -> int:
    """Frame and send one message; returns the framed byte count.  With
    ``trace_ctx=(trace_id, span_id)`` the payload is prefixed with the
    varint trace header and the type byte carries ``wire.TRACE_FLAG`` —
    headerless frames stay bit-identical to the pre-trace format."""
    if trace_ctx is not None:
        msg_type |= wire.TRACE_FLAG
        payload = wire.pack_trace_ctx(*trace_ctx) + payload
    frame = struct.pack("<IB", len(payload), msg_type) + payload
    sock.sendall(frame)
    return len(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # recv_into a preallocated buffer: one kernel->user copy per chunk and
    # one final bytes() snapshot, instead of a bytearray.extend per chunk
    # (which re-copies the accumulated prefix as it grows — quadratic-ish
    # on the soak's multi-MB row payloads)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed mid-message")
        got += r
    return bytes(buf)


def _recv_msg(
    sock: socket.socket, cap: Optional[int] = None
) -> Tuple[int, bytes]:
    header = _recv_exact(sock, 5)
    length, msg_type = struct.unpack("<IB", header)
    if cap is not None and length > cap:
        # the SERVER rejects oversized inbound requests before allocating;
        # the client passes no cap — a large snapshot reply (Criteo-scale
        # vocab x fp32 rows) is legitimate and bounded by the u32 framing
        raise ConnectionError(
            f"frame length {length} exceeds cap {cap} "
            "(corrupt prefix or protocol skew)"
        )
    return msg_type, _recv_exact(sock, length) if length else b""


def _keys_and_rows(payload: bytes, dim: int, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Split a payload framed as pack_keys(keys) ++ rows into both parts.
    The fp16 hot path IS the unified sparse-rows frame (wire.unpack_rows);
    fp32 stays the admin-op exact encoding."""
    if dtype is np.float16:
        keys, rows, consumed = wire.unpack_rows(payload, dim)
        if consumed != len(payload):
            # unpack_rows is frame-composable (tolerates trailing bytes);
            # the PS protocol is not — a peer whose configured dim differs
            # must fail loud (protocol-error reply), not silently decode
            # the first dim columns of every row as a valid gradient
            raise ValueError(
                f"sparse-rows frame length mismatch: consumed {consumed} "
                f"of {len(payload)} bytes (peer dim skew?)"
            )
        return keys, rows
    keys, consumed = wire.split_keys(payload)
    rows = np.frombuffer(payload[consumed:], dtype)
    return keys, rows.reshape(len(keys), dim).astype(np.float32)


def _pack_state_frame(keys: np.ndarray, rows: np.ndarray,
                      accums: np.ndarray) -> bytes:
    """The MIGRATE_STATE body: ``pack_rows(keys, rows)`` ++ EXACT fp32
    accums in the same sorted-key order.  Both sides of the migration
    build this frame from THEIR copy (source from the checkpoint,
    destination from a store re-read) and FNV it — matching checksums
    certify rows AND optimizer state landed.  Accums are fp32, not the
    fp16 row codec: Adagrad accumulators are unbounded sums of g^2 (a
    hot key easily exceeds fp16's 65504), so the lossy codec would ship
    inf/truncated state that the checksum could not catch — both sides
    would hash the same post-quantization bytes."""
    return wire.pack_rows(keys, rows) + np.ascontiguousarray(
        accums, np.float32
    ).tobytes()


def _unpack_state_frame(
    payload: bytes, dim: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of :func:`_pack_state_frame` -> (keys, rows, accums); the
    trailing bytes after the rows frame must be EXACTLY the fp32 accum
    block (a dim-skewed peer fails loud, never half-parses)."""
    keys, rows, consumed = wire.unpack_rows(payload, dim)
    rest = payload[consumed:]
    if len(rest) != 4 * len(keys) * dim:
        raise ValueError(
            f"state frame accum block is {len(rest)} bytes, expected "
            f"{4 * len(keys) * dim} (peer dim skew?)"
        )
    accums = np.frombuffer(rest, np.float32).reshape(len(keys), dim).copy()
    return keys, rows, accums


class ParamServerService:
    """Threaded socket front-end over an :class:`AsyncParamServer` store.
    Listens on localhost TCP (or a caller-supplied bound socket); one thread
    per connection — the reference PS is likewise a concurrent server, its
    per-key consistency guarded by the store's lock."""

    def __init__(
        self,
        ps: AsyncParamServer,
        host: str = "127.0.0.1",
        port: int = 0,
        monitor=None,
        on_farewell=None,
        health=None,
        route_provider=None,
        fault_prefetch_echo: bool = True,
    ):
        """``monitor``: optional HeartbeatMonitor; when given, MSG_BEAT
        frames drive it (workers heartbeat over their PS connection, the
        reference's heartbeats likewise ride the network — master.h:202)
        and its death/recovery events should be wired to ``ps`` routing by
        the caller (``wire_heartbeat``).  ``on_farewell(wid)``: extra hook
        on clean departures — the master role uses it to clear the
        departing worker's routes on every shard.  ``health``: an
        existing :class:`~lightctr_tpu_torch.obs.health.HealthMonitor` to serve
        verdicts from (the master passes its own); None builds one for
        this shard with an SSP-staleness detector wired to the store.
        ``route_provider``: zero-arg callable returning the current
        routing-table dict — the MASTER role passes its cluster map so
        clients can poll ``MSG_ROUTE``; plain shards leave it None.
        ``fault_prefetch_echo``: when the hosted store runs the fault
        prefetch pipeline (:class:`~lightctr_tpu.embed.tiered.
        TieredEmbeddingStore` — docs/TIERED_STORE.md "Device-resident
        hot tier"), every landed MSG_PUSH echoes its key cover into
        ``dispatch_prefetch``: the hosted trainer's next pull repeats
        most of the working set (skewed CTR streams), so the push's
        admission-rejected warm/cold rows are staged while the worker
        computes its next batch — the wire analogue of the in-process
        dispatch/commit pair, with no lookahead protocol needed.  The
        stage is best-effort: a wrong guess costs one wasted copy, and
        the store's plan guards keep the landed bytes identical."""
        self.ps = ps
        self._pf_echo = getattr(ps, "dispatch_prefetch", None) \
            if fault_prefetch_echo else None
        self.monitor = monitor
        self.on_farewell = on_farewell
        self.route_provider = route_provider
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        # the store's registry is where this shard's numbers live — make
        # the crash flight recorder snapshot it alongside the default
        self._flight_name = f"ps_shard_{self.address[1]}"
        obs_flight.register_registry(self._flight_name, ps.registry)
        # per-shard health verdict: served in every MSG_STATS reply and
        # aggregated cluster-wide by ShardedPSClient.cluster_health()
        self._owns_health = health is None
        if health is None:
            health = obs_health.HealthMonitor(
                component=self._flight_name, registry=ps.registry,
            )
            health.ensure_detector(obs_health.StalenessDetector(
                slo=getattr(ps, "staleness_threshold", 10),
            ))
            if getattr(ps, "feeds_tier_flow", False):
                # a tiered store feeds tier_flow deltas every N pushes;
                # without the detector the feed is silently discarded and
                # hot-tier thrash never degrades the shard's verdict
                health.ensure_detector(obs_health.TierThrashDetector())
        self.health = health
        # the store feeds its SSP ledger drift on every push
        ps.health = health
        self._peers = []  # [(thread, conn)] of live connections
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            # prune finished peers so a long-lived service stays bounded
            self._peers = [(x, c) for x, c in self._peers if x.is_alive()]
            self._peers.append((t, conn))

    def _serve(self, conn: socket.socket):
        dim = self.ps.dim
        reg = self.ps.registry
        out_count = [0]

        def send(data: bytes) -> None:
            conn.sendall(data)
            out_count[0] += len(data)

        try:
            while True:
                raw_type, payload = _recv_msg(conn, cap=MAX_FRAME_BYTES)
                msg_type = raw_type & ~wire.TRACE_FLAG & 0xFF
                # exact framed bytes, BEFORE the trace header (if any) is
                # stripped below — ps_bytes_received_total promises what
                # crossed the wire, not what reached the handler
                frame_bytes = 5 + len(payload)
                telem = obs_gate.enabled()
                t0 = time.perf_counter() if telem else 0.0
                try:
                    rctx = None
                    if raw_type & wire.TRACE_FLAG:
                        # inbound trace header: adopt the caller's span as
                        # parent so this handler's span stitches into the
                        # worker's step trace across the process boundary
                        rctx, used = wire.split_trace_ctx(payload)
                        payload = payload[used:]
                    span_cm = contextlib.nullcontext()
                    if msg_type != MSG_CLOSE and (
                            rctx is not None or obs_trace.enabled()):
                        # MSG_CLOSE is connection teardown, not work — a
                        # span per disconnect would be pure ring noise
                        span_cm = obs_trace.span(
                            "ps/" + _OP_NAMES.get(msg_type, "unknown"),
                            remote=rctx, n_bytes=len(payload),
                        )
                    with span_cm:
                        if msg_type == MSG_PULL:
                            hdr, hdr_len = wire.split_varint(payload, 2)
                            # hdr[0]: worker_id + 1 (0 = anonymous), or -1
                            # = anonymous READ-ONLY (the serving plane's
                            # pulls — unknown keys must not allocate).  An
                            # old server reading -1 takes this same branch
                            # with wid=-2 -> anonymous create, today's
                            # behavior: peers degrade, never misparse.
                            wid = int(hdr[0]) - 1
                            epoch = int(hdr[1])
                            keys = wire.unpack_keys(payload[hdr_len:])
                            rows = self.ps.pull_batch(
                                keys, worker_epoch=epoch,
                                worker_id=None if wid < 0 else wid,
                                create=int(hdr[0]) != -1,
                            )
                            if rows is None:
                                send(struct.pack("<IB", 1, 0) + b"\x01")
                            else:
                                # the unified sparse-rows frame (varint ids
                                # + fp16 rows) — same bytes the on-mesh
                                # exchange's host boundary ships
                                body = wire.pack_rows(keys, rows)
                                send(
                                    struct.pack("<IB", 1 + len(body), 0)
                                    + b"\x00" + body
                                )
                        elif msg_type == MSG_PUSH:
                            hdr, hdr_len = wire.split_varint(payload, 2)
                            wid, epoch = int(hdr[0]), int(hdr[1])
                            keys, grads = _keys_and_rows(
                                payload[hdr_len:], dim, np.float16
                            )
                            if len(keys) and not (np.diff(keys) > 0).all():
                                # duplicate keys would mis-apply under the
                                # vectorized (fancy-indexed) updater — refuse
                                # the frame rather than corrupt rows
                                raise ValueError("push keys must be unique")
                            ok = self.ps.push_batch(
                                wid, keys, grads, worker_epoch=epoch
                            )
                            send(
                                struct.pack("<IB", 1, 0)
                                + (b"\x00" if ok else b"\x01")
                            )
                            if ok and self._pf_echo is not None:
                                # push-echo fault prefetch: stage this
                                # cover's non-resident rows behind the
                                # worker's next compute window (reply
                                # already on the wire — the echo never
                                # adds push latency)
                                self._pf_echo(keys)
                        elif msg_type == MSG_PRELOAD:
                            keys, rows = _keys_and_rows(
                                payload, dim, np.float32
                            )
                            self.ps.preload_batch(keys, rows)
                            send(struct.pack("<IB", 1, 0) + b"\x00")
                        elif msg_type == MSG_SNAPSHOT:
                            keys, rows = self.ps.snapshot_arrays()
                            body = (wire.pack_keys(keys)
                                    + rows.astype(np.float32).tobytes())
                            send(struct.pack("<IB", len(body), 0) + body)
                        elif msg_type == MSG_BEAT:
                            wid = int(wire.unpack_varint(payload, 1)[0])
                            if self.monitor is not None:
                                self.monitor.beat(str(wid))
                            send(struct.pack("<IB", 1, 0) + b"\x00")
                        elif msg_type == MSG_STATS:
                            stats = self.ps.stats()
                            # per-shard registry snapshot rides the stats op:
                            # master/clients merge these cluster-wide
                            # (obs.merge_snapshots) — the exposition path
                            stats["telemetry"] = self.ps.registry.snapshot()
                            # so does the shard's health verdict — the
                            # cluster_health() aggregation input
                            stats["health"] = self.health.verdict()
                            if self.monitor is not None:
                                # liveness map rides the stats op, so the
                                # launcher/ops plane can read the master's
                                # view of every beating node (master.h:202
                                # ledger).  peek(), not check(): a stats
                                # request must stay read-only — transitions
                                # (and their blocking broadcast callbacks)
                                # belong to the monitor's period thread, not
                                # this connection's thread
                                stats["liveness"] = self.monitor.peek()
                            body = json.dumps(stats).encode()
                            send(struct.pack("<IB", len(body), 0) + body)
                        elif msg_type == MSG_ROUTE:
                            rp = self.route_provider
                            table = rp() if rp is not None else {"epoch": -1}
                            body = json.dumps(table).encode()
                            send(struct.pack("<IB", len(body), 0) + body)
                        elif msg_type == MSG_MIGRATE:
                            hdr, hdr_len = wire.split_varint(payload, 1)
                            epoch = int(hdr[0])
                            keys, rows = _keys_and_rows(
                                payload[hdr_len:], dim, np.float16
                            )
                            if len(keys) and not (np.diff(keys) > 0).all():
                                raise ValueError(
                                    "migrate keys must be sorted unique"
                                )
                            # apply + read back: the checksum certifies the
                            # rows LANDED in this store (docs/ELASTICITY.md)
                            back = self.ps.migrate_in(keys, rows)
                            fnv = frame_checksum(wire.pack_rows(keys, back))
                            body = json.dumps({
                                "n": int(len(keys)), "fnv": fnv,
                                "epoch": epoch,
                            }).encode()
                            send(struct.pack("<IB", len(body), 0) + body)
                            if telem:
                                reg.inc("ps_migrated_rows_total", len(keys))
                        elif msg_type == MSG_MIGRATE_STATE:
                            hdr, hdr_len = wire.split_varint(payload, 1)
                            epoch = int(hdr[0])
                            keys, rows, accums = _unpack_state_frame(
                                payload[hdr_len:], dim
                            )
                            if len(keys) and not (np.diff(keys) > 0).all():
                                raise ValueError(
                                    "migrate keys must be sorted unique"
                                )
                            # rows AND accumulators land together; the
                            # read-back covers both, so the checksum
                            # certifies optimizer state survived the
                            # membership change (docs/TIERED_STORE.md).
                            # A store without the state surface gets the
                            # protocol-error reply — the master then
                            # degrades to row-only MSG_MIGRATE.
                            mig = getattr(self.ps, "migrate_in_state", None)
                            if mig is None:
                                raise ValueError(
                                    "store has no migrate_in_state"
                                )
                            b_rows, b_accs = mig(keys, rows, accums)
                            fnv = frame_checksum(
                                _pack_state_frame(keys, b_rows, b_accs)
                            )
                            body = json.dumps({
                                "n": int(len(keys)), "fnv": fnv,
                                "epoch": epoch, "accums": True,
                            }).encode()
                            send(struct.pack("<IB", len(body), 0) + body)
                            if telem:
                                reg.inc("ps_migrated_rows_total", len(keys))
                                reg.inc("ps_migrated_accum_rows_total",
                                        len(keys))
                        elif msg_type == MSG_SNAPSHOT_STATE:
                            snap = getattr(
                                self.ps, "snapshot_state_arrays", None
                            )
                            if snap is None:
                                raise ValueError(
                                    "store has no snapshot_state_arrays"
                                )
                            keys, rows, accs = snap()
                            body = (wire.pack_keys(keys)
                                    + rows.astype(np.float32).tobytes()
                                    + accs.astype(np.float32).tobytes())
                            send(struct.pack("<IB", len(body), 0) + body)
                        elif msg_type == MSG_SUBSCRIBE:
                            hdr, _ = wire.split_varint(payload, 2)
                            since, tmo_ms = int(hdr[0]), int(hdr[1])
                            waiter = getattr(
                                self.ps, "wait_write_delta", None
                            )
                            if waiter is None:
                                # a store without the write-log surface
                                # (or one that disabled it): deterministic
                                # rejection — subscribers degrade to
                                # MSG_STATS polling, never to staleness
                                raise ValueError(
                                    "store has no write-delta subscription"
                                )
                            rep = waiter(
                                since,
                                min(max(tmo_ms, 0) / 1e3,
                                    SUBSCRIBE_MAX_WAIT_S),
                            )
                            body = json.dumps(rep).encode()
                            send(struct.pack("<IB", len(body), 0) + body)
                        elif msg_type == MSG_EVICT:
                            keys = wire.unpack_keys(payload)
                            n = self.ps.evict_batch(keys)
                            body = json.dumps({"evicted": int(n)}).encode()
                            send(struct.pack("<IB", len(body), 0) + body)
                        elif msg_type == MSG_GRACE:
                            f = int(wire.unpack_varint(payload, 1)[0])
                            self.ps.set_staleness_grace(f / 1000.0)
                            send(struct.pack("<IB", 1, 0) + b"\x00")
                        elif msg_type == MSG_UNROUTE:
                            wid = int(wire.unpack_varint(payload, 1)[0])
                            self.ps.unroute_worker(wid)
                            send(struct.pack("<IB", 1, 0) + b"\x00")
                        elif msg_type == MSG_READMIT:
                            wid = int(wire.unpack_varint(payload, 1)[0])
                            self.ps.readmit_worker(wid)
                            send(struct.pack("<IB", 1, 0) + b"\x00")
                        elif msg_type == MSG_FAREWELL:
                            # clean departure (FIN, master.h:146-190): stop
                            # liveness tracking so deliberate exits are not
                            # declared deaths, and clear any unroute flag
                            wid = int(wire.unpack_varint(payload, 1)[0])
                            if self.monitor is not None:
                                self.monitor.forget(str(wid))
                            self.ps.readmit_worker(wid)
                            if self.on_farewell is not None:
                                self.on_farewell(wid)
                            send(struct.pack("<IB", 1, 0) + b"\x00")
                        elif msg_type == MSG_CLOSE:
                            return
                        else:
                            # protocol skew must error out, not deadlock
                            # the client
                            send(struct.pack("<IB", 1, 0) + b"\xff")
                        if telem:
                            op = _OP_NAMES.get(msg_type, "unknown")
                            reg.inc(labeled("ps_requests_total", op=op))
                            reg.observe(labeled("ps_op_seconds", op=op),
                                        time.perf_counter() - t0)
                            reg.inc("ps_bytes_received_total", frame_bytes)
                            reg.inc("ps_bytes_sent_total", out_count[0])
                            out_count[0] = 0
                except (ValueError, struct.error):
                    # malformed frame (truncated varint, row bytes not a
                    # multiple of dim*n_keys, ...): reply with the protocol
                    # error byte instead of killing the thread with a raw
                    # traceback, then drop the connection — the stream can't
                    # be trusted past a framing error
                    send(struct.pack("<IB", 1, 0) + b"\xff")
                    if telem:
                        reg.inc("ps_protocol_errors_total")
                    return
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    def close(self):
        self._stop.set()
        obs_flight.unregister_registry(self._flight_name)
        if self._owns_health:
            self.health.close()
        if self.ps.health is self.health:
            self.ps.health = None
        # shutdown() BEFORE close(): the accept thread blocked in accept()
        # holds the kernel's open file description, so close() alone leaves
        # the port listening (and accepting!) until that syscall returns —
        # shutdown wakes it with an error instead
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        self._accept_thread.join(timeout=2.0)
        # sever live connections so "closed" really stops serving, then
        # reap the per-connection threads
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


class ProtocolRejection(RuntimeError):
    """The server answered the protocol-error byte: a DETERMINISTIC
    rejection (unknown/unsupported op, malformed frame) — resending the
    identical frame can never succeed, unlike a transient socket error.
    Subclasses RuntimeError so existing broad handlers keep working;
    callers that must distinguish (the master's degrade-to-row-only
    migration paths) match on this type instead of the message text."""


class PSClient:
    """Worker-side stub with the ShmAsyncParamServer protocol surface
    (``pull(keys, worker_epoch, worker_id)`` / ``push(worker_id, grads,
    worker_epoch)``), carrying wire-coded bytes over one TCP connection.
    Tracks ``bytes_sent``/``bytes_received`` so tests can assert the
    compaction is real."""

    # one bounded reconnect per failed rpc, with exponential backoff +
    # jitter between the failure and the retry: a single transient RST
    # (peer restart, accept-queue overflow, conntrack flush) must look
    # like latency, not like a dead shard — only EXHAUSTED retries reach
    # ShardedPSClient._mark_down and the rebalance machinery above it
    RECONNECT_ATTEMPTS = 1
    BACKOFF_BASE_S = 0.05
    BACKOFF_CAP_S = 1.0

    def __init__(self, address: Tuple[str, int], dim: int,
                 timeout: Optional[float] = None):
        """``timeout``: per-socket-op deadline in seconds (None = block
        forever).  Control-plane clients (the master's shard admins) set
        one so a wedged shard raises instead of stalling heartbeats."""
        self.dim = dim
        self.address = tuple(address)
        self.timeout = timeout
        self._sock = self._connect()
        self.bytes_sent = 0
        self.bytes_received = 0
        self.withheld_pulls = 0
        self.dropped_pushes = 0
        self.reconnects = 0

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address, timeout=self.timeout)
        if sock.getsockname() == sock.getpeername():
            # Linux TCP self-connect: a connect() to a FREE port in the
            # ephemeral range can be assigned that same port as its source
            # and succeed against itself — observed when reconnecting to a
            # dead shard's old address; the "server" would then be this
            # client's own echo.  Treat it as the refusal it really is.
            sock.close()
            raise ConnectionRefusedError(
                f"self-connect to {self.address} (no listener)"
            )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    @classmethod
    def _backoff_s(cls, attempt: int) -> float:
        """Capped exponential backoff with full jitter (attempt 0 -> up to
        BACKOFF_BASE_S): decorrelates a thundering herd of workers all
        retrying the same restarted shard."""
        return min(cls.BACKOFF_CAP_S, cls.BACKOFF_BASE_S * (2 ** attempt)) \
            * random.random()

    def reconnect(self) -> None:
        """Tear down and re-dial the same address (the transport may have
        died while the service lives on — or a fresh incarnation may be
        serving on it)."""
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = self._connect()
        self.reconnects += 1
        if obs_gate.enabled():
            default_registry().inc("ps_client_reconnects_total")

    def _send(self, msg_type: int, payload: bytes) -> None:
        """Fire a request without waiting for the reply (pipelining
        primitive — the server answers requests on one connection in
        order, so N sends followed by N receives is safe).  When a
        sampled span is open on this thread, its context rides the frame
        as the wire trace header — the server's handler span becomes its
        child."""
        self.bytes_sent += _send_msg(
            self._sock, msg_type, payload,
            trace_ctx=obs_trace.current_context(),
        )
        self._inflight_type = msg_type

    def _recv_reply(self) -> bytes:
        reply_type, reply = _recv_msg(self._sock)
        del reply_type  # replies reuse the length framing; type byte unused
        self.bytes_received += 5 + len(reply)
        if reply == b"\xff":
            raise ProtocolRejection(
                f"PS server rejected message type "
                f"{getattr(self, '_inflight_type', '?')} (protocol skew)"
            )
        return reply

    def _rpc(self, msg_type: int, payload: bytes) -> bytes:
        """Round-trip with bounded retry: a socket-level failure (RST,
        timeout, peer restart) gets RECONNECT_ATTEMPTS reconnect+resend
        cycles, each preceded by capped exponential backoff with jitter,
        before the error propagates.  Retried requests are at-least-once:
        a PUSH whose reply was lost may apply twice — the same lossy
        async-push semantics the reference accepts (push.h:55-66)."""
        try:
            self._send(msg_type, payload)
            return self._recv_reply()
        except (ConnectionError, OSError) as first_err:
            err = first_err
            for attempt in range(self.RECONNECT_ATTEMPTS):
                time.sleep(self._backoff_s(attempt))
                try:
                    self.reconnect()
                    self._send(msg_type, payload)
                    return self._recv_reply()
                except (ConnectionError, OSError) as e:
                    err = e
            raise err

    def pull_arrays(
        self,
        keys: np.ndarray,
        worker_epoch: int,
        worker_id: Optional[int] = None,
        create: bool = True,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Vectorized pull -> (sorted keys, [n, dim] fp32 rows in that
        order), or None when SSP-withheld/unrouted.  The hot path: no
        per-key Python on either side of the wire.  ``create=False`` is
        the read-only serving form: unknown keys come back as zero rows
        and allocate nothing server-side (header value -1; an old server
        treats it as a plain anonymous pull — degrades, never misparses).
        """
        if not create and worker_id is not None:
            raise ValueError("read-only pulls are anonymous (worker_id None)")
        hdr = wire.pack_varint(np.array(
            [-1 if not create
             else (worker_id if worker_id is not None else -1) + 1,
             worker_epoch],
            np.int64,
        ))
        keys_arr = np.ascontiguousarray(keys, np.int64)
        if len(keys_arr) > 1 and not (np.diff(keys_arr) >= 0).all():
            # the wire sorts the key stream (pack_keys), so an unsorted
            # request would get rows back in a DIFFERENT order than asked —
            # silent misalignment; fail loud instead
            raise ValueError("pull_arrays keys must be sorted")
        with obs_trace.span("ps_client/pull", n_keys=int(keys_arr.size)):
            reply = self._rpc(MSG_PULL, hdr + wire.pack_keys(keys_arr))
        if reply[:1] == b"\x01":
            self.withheld_pulls += 1
            return None
        return _keys_and_rows(reply[1:], self.dim, np.float16)

    def pull(
        self, keys, worker_epoch: int, worker_id: Optional[int] = None
    ) -> Optional[Dict[int, np.ndarray]]:
        out = self.pull_arrays(
            np.asarray(list(keys), np.int64), worker_epoch, worker_id
        )
        if out is None:
            return None
        skeys, rows = out
        return {int(k): rows[i] for i, k in enumerate(skeys)}

    def push_arrays(
        self,
        worker_id: int,
        keys: np.ndarray,
        rows: np.ndarray,
        worker_epoch: int,
    ) -> bool:
        """Vectorized push of [n, dim] grads for SORTED-unique keys (the
        wire's key stream is sorted; rows must already be in key order)."""
        keys_arr = np.ascontiguousarray(keys, np.int64)
        r = np.asarray(rows, np.float32).reshape(-1, self.dim)
        if len(keys_arr) > 1 and not (np.diff(keys_arr) > 0).all():
            # pack_keys sorts the stream while the row bytes keep caller
            # order: unsorted/duplicate keys would scatter grads onto the
            # wrong rows with ok=True
            raise ValueError("push_arrays keys must be sorted unique")
        hdr = wire.pack_varint(np.array([worker_id, worker_epoch], np.int64))
        payload = hdr + wire.pack_rows(keys_arr, r)
        with obs_trace.span("ps_client/push", n_keys=int(keys_arr.size)):
            ok = self._rpc(MSG_PUSH, payload) == b"\x00"
        if not ok:
            self.dropped_pushes += 1
        return ok

    def push(
        self, worker_id: int, grads: Dict[int, np.ndarray], worker_epoch: int
    ) -> bool:
        keys = np.array(sorted(grads), np.int64)
        rows = np.stack([
            np.asarray(grads[int(k)], np.float32).reshape(self.dim)
            for k in keys
        ]) if len(keys) else np.zeros((0, self.dim), np.float32)
        return self.push_arrays(worker_id, keys, rows, worker_epoch)

    def preload_arrays(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Vectorized preload: rows[i] -> keys[i]; keys must be sorted
        unique (admin op, exact fp32 bytes)."""
        keys_arr = np.ascontiguousarray(keys, np.int64)
        r = np.asarray(rows, np.float32).reshape(-1, self.dim)
        if len(keys_arr) > 1 and not (np.diff(keys_arr) > 0).all():
            raise ValueError("preload_arrays keys must be sorted unique")
        self._rpc(MSG_PRELOAD, wire.pack_keys(keys_arr) + r.tobytes())

    def preload(self, values: Dict[int, np.ndarray]) -> None:
        keys = np.array(sorted(values), np.int64)
        rows = np.stack([
            np.asarray(values[int(k)], np.float32).reshape(self.dim)
            for k in keys
        ])
        self.preload_arrays(keys, rows)

    def snapshot_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized snapshot -> (sorted keys, [n, dim] fp32 rows)."""
        reply = self._rpc(MSG_SNAPSHOT, b"")
        return _keys_and_rows(reply, self.dim, np.float32)

    def snapshot(self) -> Dict[int, np.ndarray]:
        keys, rows = self.snapshot_arrays()
        return {int(k): rows[i] for i, k in enumerate(keys)}

    def beat(self, worker_id: int) -> None:
        """Heartbeat over the PS connection (master.h:202 topology: liveness
        rides the same network as parameters).  The round-trip time lands in
        the process registry (``heartbeat_rtt_seconds``) — worker-observed
        control-plane latency, the number that predicts false death
        declarations."""
        if not obs_gate.enabled():
            self._rpc(MSG_BEAT,
                      wire.pack_varint(np.array([worker_id], np.int64)))
            return
        t0 = time.perf_counter()
        with obs_trace.span("ps_client/beat"):
            self._rpc(MSG_BEAT,
                      wire.pack_varint(np.array([worker_id], np.int64)))
        reg = default_registry()
        reg.observe("heartbeat_rtt_seconds", time.perf_counter() - t0)
        reg.inc("heartbeats_total")

    def stats(self) -> Dict:
        """Server-side counter snapshot (withheld/dropped/rejected, unrouted
        set, epoch ledger) — the artifact-facing admin op."""
        return json.loads(self._rpc(MSG_STATS, b"").decode())

    def subscribe_deltas(self, since: int, timeout_ms: int = 2000) -> Dict:
        """Long-poll the shard's bounded write log (MSG_SUBSCRIBE): blocks
        server-side until ``write_version`` moves past ``since`` or the
        wait expires (capped at :data:`SUBSCRIBE_MAX_WAIT_S` server-side),
        returning ``{"write_version", "floor", "covered", "entries"}`` —
        the push-based freshness feed :class:`lightctr_tpu.online.
        FreshnessSubscriber` drives serving-cache invalidation with.
        Construct the client with a socket ``timeout`` comfortably above
        ``timeout_ms``, or the long-poll reads as a dead shard.  Raises
        :class:`ProtocolRejection` against a store without the write-log
        surface (callers degrade to :meth:`stats` polling)."""
        payload = wire.pack_varint(np.array(
            [max(0, int(since)), max(0, int(timeout_ms))], np.int64
        ))
        reply = self._rpc(MSG_SUBSCRIBE, payload)
        return json.loads(reply.decode())

    def farewell(self, worker_id: int) -> None:
        """Clean departure: deregister from liveness tracking (FIN)."""
        self._rpc(
            MSG_FAREWELL, wire.pack_varint(np.array([worker_id], np.int64))
        )

    def unroute(self, worker_id: int) -> None:
        """Control-plane op (master -> shard): delete the worker's route."""
        self._rpc(
            MSG_UNROUTE, wire.pack_varint(np.array([worker_id], np.int64))
        )

    def readmit(self, worker_id: int) -> None:
        """Control-plane op (master -> shard): restore the worker's route."""
        self._rpc(
            MSG_READMIT, wire.pack_varint(np.array([worker_id], np.int64))
        )

    # -- elastic membership ops (docs/ELASTICITY.md) ------------------------

    def route(self) -> Dict:
        """Fetch the current routing table (master op).  A peer with no
        route provider answers ``{"epoch": -1}`` — callers treat any
        epoch below their own as 'no news'."""
        return json.loads(self._rpc(MSG_ROUTE, b"").decode())

    def migrate_rows(
        self, keys: np.ndarray, rows: np.ndarray, epoch: int
    ) -> Dict:
        """Ship a sorted-unique (keys, rows) range to this shard as part
        of an epoch's rebalance.  Returns the verification record::

            {"n": rows landed, "fnv": dest read-back checksum,
             "src_fnv": this side's frame checksum, "verified": bool}

        ``verified`` means the destination re-read the rows from its
        store and their lane-FNV matches the frame this side shipped —
        zero row loss AND zero corruption, end to end."""
        keys_arr = np.ascontiguousarray(keys, np.int64)
        r = np.asarray(rows, np.float32).reshape(-1, self.dim)
        if len(keys_arr) > 1 and not (np.diff(keys_arr) > 0).all():
            raise ValueError("migrate_rows keys must be sorted unique")
        frame = wire.pack_rows(keys_arr, r)
        src_fnv = frame_checksum(
            # checksum what the destination will be able to reproduce:
            # the fp16-coded frame round-trips losslessly through the
            # store (fp16 -> fp32 -> fp16), so equal checksums == landed
            frame
        )
        hdr = wire.pack_varint(np.array([int(epoch)], np.int64))
        with obs_trace.span("ps_client/migrate", n_keys=int(keys_arr.size)):
            reply = json.loads(self._rpc(MSG_MIGRATE, hdr + frame).decode())
        reply["src_fnv"] = src_fnv
        reply["verified"] = (
            int(reply.get("n", -1)) == int(keys_arr.size)
            and int(reply.get("fnv", -1)) == src_fnv
        )
        return reply

    def migrate_state(
        self, keys: np.ndarray, rows: np.ndarray, accums: np.ndarray,
        epoch: int,
    ) -> Dict:
        """State-carrying migration (MSG_MIGRATE_STATE): ship sorted-unique
        (keys, rows, accums) and verify the destination's read-back
        checksum over BOTH — rows and optimizer state landed, end to end.
        Raises RuntimeError against an old shard without the op (callers
        degrade to :meth:`migrate_rows`)."""
        keys_arr = np.ascontiguousarray(keys, np.int64)
        r = np.asarray(rows, np.float32).reshape(-1, self.dim)
        a = np.asarray(accums, np.float32).reshape(-1, self.dim)
        if len(keys_arr) > 1 and not (np.diff(keys_arr) > 0).all():
            raise ValueError("migrate_state keys must be sorted unique")
        frame = _pack_state_frame(keys_arr, r, a)
        src_fnv = frame_checksum(frame)
        hdr = wire.pack_varint(np.array([int(epoch)], np.int64))
        with obs_trace.span("ps_client/migrate_state",
                            n_keys=int(keys_arr.size)):
            reply = json.loads(
                self._rpc(MSG_MIGRATE_STATE, hdr + frame).decode()
            )
        reply["src_fnv"] = src_fnv
        reply["verified"] = (
            int(reply.get("n", -1)) == int(keys_arr.size)
            and int(reply.get("fnv", -1)) == src_fnv
        )
        return reply

    def snapshot_state_arrays(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized state snapshot -> (sorted keys, fp32 rows, fp32
        accums) — the donor-side source of a state-carrying join
        migration.  Raises RuntimeError against an old shard."""
        reply = self._rpc(MSG_SNAPSHOT_STATE, b"")
        keys, consumed = wire.split_keys(reply)
        block = len(keys) * self.dim * 4
        if len(reply) - consumed != 2 * block:
            raise ValueError(
                f"state snapshot carries {len(reply) - consumed} value "
                f"bytes, expected {2 * block} (peer dim skew?)"
            )
        rows = np.frombuffer(reply[consumed:consumed + block], np.float32)
        accs = np.frombuffer(reply[consumed + block:], np.float32)
        n = len(keys)
        return keys, rows.reshape(n, self.dim).copy(), \
            accs.reshape(n, self.dim).copy()

    def evict(self, keys: np.ndarray) -> int:
        """Drop keys from this shard's store (rows migrated away must not
        survive as stale duplicates).  Returns how many were present."""
        keys_arr = np.ascontiguousarray(keys, np.int64)
        reply = json.loads(
            self._rpc(MSG_EVICT, wire.pack_keys(keys_arr)).decode()
        )
        return int(reply.get("evicted", 0))

    def grace(self, factor: float) -> None:
        """Widen (factor > 1) or restore (factor == 1) the shard's SSP
        staleness budget for the duration of a rebalance."""
        self._rpc(MSG_GRACE, wire.pack_varint(
            np.array([int(round(factor * 1000))], np.int64)
        ))

    def close(self) -> None:
        try:
            _send_msg(self._sock, MSG_CLOSE, b"")
        except OSError:
            pass
        self._sock.close()


class ShardedPSClient:
    """Key-partitioned client over N PS service shards — the reference's
    scale-out topology (one worker talks to MANY paramserver processes,
    keys routed by consistent hash, ``consistent_hash.h`` +
    ``distributed_algo_abst.h:176-280``).  Routing policy is pluggable
    (dist/partition.py): ``"modulo"`` — ``key % n_shards``, uniform for
    folded ids but remaps ~everything on a shard-count change — or
    ``"ring"`` — the reference's virtual-node consistent-hash ring,
    vectorized, remapping only ~1/n keys when a shard joins/leaves.

    Same array protocol surface as :class:`PSClient`; each call splits the
    sorted key batch per shard, sends every sub-request before reading any
    reply (the shards work concurrently), and merges the replies back into
    request order.  Updater math is per-key independent, so a preloaded
    sharded deployment whose gates never trip is bit-identical to a single
    store (tested).  As in the reference's real topology, each shard keeps
    its OWN staleness ledger: a push may be dropped by one shard and
    applied by another (the return value is False if ANY shard dropped),
    and a pull withheld by any shard is retried whole.

    ELASTIC MEMBERSHIP: routing is epoch-numbered (dist/elastic.py).  The
    client holds one immutable :class:`RoutingTable`; every data op
    snapshots it ONCE at entry, so an epoch swap (``apply_routing`` — the
    master's rebalance publishing a new member set) lands atomically
    BETWEEN batches: no pull/push ever splits one batch across two
    epochs.  With a route source attached (``attach_route_source``), a
    failed batch polls the master for a newer table before the caller's
    retry, so shard death -> rebalance -> resume needs no restart.
    """

    def __init__(self, addresses, dim: int, partition: str = "modulo"):
        if not addresses:
            raise ValueError("need at least one PS shard address")
        from .elastic import RoutingTable

        self.dim = dim
        self.addresses = [tuple(a) for a in addresses]
        # a shard that is down at CLIENT construction must not abort it:
        # a worker (re)starting mid-outage leaves the slot None — every
        # data op attempts a reconnect per call (_ensure), same as a shard
        # that dies later
        self.clients = []
        for a in self.addresses:
            try:
                self.clients.append(PSClient(a, dim))
            except OSError:
                self.clients.append(None)
        self.n_shards = len(self.clients)
        # epoch-numbered routing: every data op snapshots ONE (epoch,
        # partition, members) view at entry and uses it for the whole
        # batch — apply_routing swaps the snapshot atomically between
        # batches, never inside one (the atomicity test_chaos.py asserts)
        self._route_lock = threading.Lock()
        self._route_source = None  # zero-arg callable -> table dict | None
        self._apply_table_locked(RoutingTable(
            epoch=0,
            members=range(self.n_shards),
            addresses={i: a for i, a in enumerate(self.addresses)},
            partition=partition,
        ))
        # shard-failure tolerance: a dead shard's client slot goes None and
        # every data op attempts one reconnect per call (the reference
        # worker likewise reconnects to a relaunched paramserver); counters
        # of discarded clients accumulate here so accounting survives
        self.reconnects = 0
        self._base = {"bytes_sent": 0, "bytes_received": 0,
                      "withheld_pulls": 0, "dropped_pushes": 0}

    # -- routing epochs (elastic membership, docs/ELASTICITY.md) ------------

    def _apply_table_locked(self, table) -> None:
        """Install a routing table (caller context: ctor or under
        _route_lock).  Grows the shard-id-indexed address/client lists for
        newly admitted shards; departed members keep their slots (ids are
        stable forever) but leave the live set."""
        self._table = table
        self.partition = table.partition()
        self.members = list(table.members)

    def _route(self):
        """The immutable routing snapshot a single batch operates under:
        (epoch, members, partition).  One acquisition per data op — the
        table object is never mutated in place, so using the captured
        reference for the whole batch is race-free by construction."""
        with self._route_lock:
            return self._table, self.partition, self.members

    @property
    def routing(self):
        """The current (immutable) RoutingTable — workers read its epoch
        + worker list to derive their data-shard assignment."""
        with self._route_lock:
            return self._table

    @property
    def route_epoch(self) -> int:
        with self._route_lock:
            return self._table.epoch

    @property
    def rebalancing(self) -> bool:
        with self._route_lock:
            return self._table.rebalancing

    def apply_routing(self, table) -> bool:
        """Adopt a newer routing table (dict or RoutingTable).  Stale or
        same-epoch tables are ignored (False) EXCEPT a same-epoch change
        of the rebalancing flag, which is advisory and adopted in place.
        New member addresses are dialed lazily on first use."""
        from .elastic import RoutingTable

        if isinstance(table, dict):
            if int(table.get("epoch", -1)) < 0:
                return False  # "no route provider" sentinel
            table = RoutingTable.from_dict(table)
        with self._route_lock:
            if table.partition_name != self._table.partition_name:
                # a policy swap would re-home ~the whole keyspace under
                # rows placed by the OLD policy — silent loss far beyond
                # any membership change.  This is a deployment
                # misconfiguration (client and master must agree);
                # refuse loudly and keep serving under the local policy.
                logging.getLogger(__name__).error(
                    "refusing routing table at epoch %d: partition policy "
                    "%r != client's %r (client/master misconfiguration)",
                    table.epoch, table.partition_name,
                    self._table.partition_name,
                )
                return False
            if table.epoch < self._table.epoch:
                return False
            if (table.epoch == self._table.epoch
                    and table.rebalancing == self._table.rebalancing):
                return False
            for sid in table.members:
                while len(self.addresses) <= sid:
                    self.addresses.append(None)
                    self.clients.append(None)
                addr = tuple(table.addresses[sid])
                if self.addresses[sid] != addr:
                    # new shard, or a shard re-homed to a new address:
                    # drop the stale transport, dial lazily on first use
                    old = self.clients[sid]
                    if old is not None:
                        for k in self._base:
                            self._base[k] += getattr(old, k)
                        try:
                            old.close()
                        except OSError:
                            pass
                    self.addresses[sid] = addr
                    self.clients[sid] = None
            self.n_shards = len(self.addresses)
            self._apply_table_locked(table)
        return True

    def attach_route_source(self, source) -> None:
        """``source`` is a zero-arg callable returning the latest routing
        table dict (or None/raising when the master is unreachable) —
        typically ``master_client.route``.  ``refresh_route`` polls it;
        data ops do so automatically after a failed batch, so a rebalance
        is adopted without restart the moment the master publishes it."""
        self._route_source = source

    def refresh_route(self) -> bool:
        """Poll the route source once; adopt the table if it is newer.
        Never raises (an unreachable master is a retry-later)."""
        src = self._route_source
        if src is None:
            return False
        try:
            table = src()
        except (ConnectionError, OSError, RuntimeError, ValueError):
            return False
        if not table:
            return False
        return self.apply_routing(table)

    # -- shard liveness -----------------------------------------------------

    def _mark_down(self, i: int) -> None:
        c = self.clients[i]
        if c is not None:
            for k in self._base:
                self._base[k] += getattr(c, k)
            try:
                c.close()
            except OSError:
                pass
            self.clients[i] = None

    def _ensure(self, i: int):
        """Client for shard i, attempting one reconnect if it is down.
        Returns None while the shard stays unreachable."""
        if self.clients[i] is None:
            if self.addresses[i] is None:
                return None
            try:
                self.clients[i] = PSClient(self.addresses[i], self.dim)
                self.reconnects += 1
            except OSError:
                return None
        return self.clients[i]

    def _retry_shard(self, i: int, send_fn):
        """One reconnect + resend for shard ``i`` after a socket-level
        failure (PSClient._backoff_s jitter applied): a transient RST must
        cost one retry, not a _mark_down — only when the retry ALSO fails
        does the shard get declared down (and the caller's rebalance
        machinery above it get a say).  Returns the live client or None."""
        self._mark_down(i)
        time.sleep(PSClient._backoff_s(0))
        c = self._ensure(i)
        if c is None:
            return None
        try:
            send_fn(c)
            return c
        except (ConnectionError, OSError):
            self._mark_down(i)
            return None

    # -- accounting (aggregated over shards) --------------------------------

    def _sum(self, attr: str) -> int:
        return self._base[attr] + sum(
            getattr(c, attr) for c in self.clients if c is not None
        )

    @property
    def bytes_sent(self) -> int:
        return self._sum("bytes_sent")

    @property
    def bytes_received(self) -> int:
        return self._sum("bytes_received")

    @property
    def withheld_pulls(self) -> int:
        return self._sum("withheld_pulls")

    @property
    def dropped_pushes(self) -> int:
        return self._sum("dropped_pushes")

    def _split(self, keys: np.ndarray, partition=None, members=None):
        """shard id per key (partition policy: modulo or consistent-hash
        ring, over the LIVE members of one routing epoch) + the per-shard
        sorted key arrays (sorted input stays sorted within each shard) +
        scatter indices to merge replies back into request order.
        Returns [(shard_id, keys, idx)] for non-empty destinations.
        ``partition``/``members`` come from ONE _route() snapshot so a
        concurrent epoch swap cannot split the batch across epochs."""
        if partition is None:
            _, partition, members = self._route()
        shard = partition.shard_of(keys)
        out = []
        for s in members:
            idx = np.flatnonzero(shard == s)
            if idx.size:
                out.append((s, keys[idx], idx))
        return out

    @staticmethod
    def _check_sorted(keys_arr: np.ndarray, *, unique: bool, op: str) -> None:
        """Same loud-failure contract as PSClient: pack_keys sorts the wire
        key stream while row bytes keep caller order, so unsorted (or, for
        row-carrying ops, duplicate) keys would silently misalign rows.
        The per-shard split preserves order, so checking the full batch
        once covers every shard."""
        if len(keys_arr) > 1:
            d = np.diff(keys_arr)
            if not ((d > 0).all() if unique else (d >= 0).all()):
                kind = "sorted unique" if unique else "sorted"
                raise ValueError(f"{op} keys must be {kind}")

    @staticmethod
    def _drain(pending, handle) -> None:
        """Receive every pending shard reply even when one errors — a
        protocol-error reply from shard i must not leave shards i+1..n
        undrained (a caller that catches and retries would read stale
        replies, silently desynced).  Re-raises the first error after the
        drain."""
        err = None
        for item in pending:
            try:
                handle(item)
            except (RuntimeError, OSError, ValueError) as e:
                # ValueError: a malformed reply payload (_keys_and_rows
                # reshape/varint skew) must also not abort the drain
                if err is None:
                    err = e
        if err is not None:
            raise err

    def pull_arrays(self, keys, worker_epoch, worker_id=None, create=True):
        keys_arr = np.ascontiguousarray(keys, np.int64)
        self._check_sorted(keys_arr, unique=False, op="pull_arrays")
        if not create and worker_id is not None:
            raise ValueError("read-only pulls are anonymous (worker_id None)")
        # ONE routing snapshot for the whole batch: the epoch the reply
        # is merged under is the epoch every sub-request was split under
        table, partition, members = self._route()
        parts = self._split(keys_arr, partition, members)
        hdr = wire.pack_varint(np.array(
            [-1 if not create
             else (worker_id if worker_id is not None else -1) + 1,
             worker_epoch],
            np.int64,
        ))
        live = []
        state = {"withheld": False, "failed": False}
        rows = np.empty((len(keys_arr), self.dim), np.float32)

        def handle(item):
            i, c, idx, msg = item
            try:
                reply = c._recv_reply()
            except (ConnectionError, OSError):
                # died between send and reply.  After an RST the first
                # send usually lands in the kernel buffer and the failure
                # only surfaces HERE — so the transient-blip retry must
                # cover this side too.  Pulls are idempotent: reconnect,
                # resend this shard's sub-request, read once.
                c = self._retry_shard(i, lambda cc: cc._send(MSG_PULL, msg))
                if c is None:
                    state["failed"] = True
                    return
                try:
                    reply = c._recv_reply()
                except (ConnectionError, OSError):
                    self._mark_down(i)
                    state["failed"] = True
                    return
            if reply[:1] == b"\x01":
                # any shard withholding means the whole pull retries — the
                # reference worker likewise blocks until every PS replies
                c.withheld_pulls += 1
                state["withheld"] = True
                return  # still drain the remaining replies
            _, r = _keys_and_rows(reply[1:], self.dim, np.float16)
            rows[idx] = r

        # one span covers the whole fan-out: every per-shard _send fires
        # inside it, so each shard's server span is this span's child
        with obs_trace.span("ps_client/pull", n_keys=int(keys_arr.size),
                            shards=len(members), epoch=table.epoch):
            for i, part, idx in parts:
                c = self._ensure(i)
                if c is None:
                    # shard down: same retry contract as a withheld pull —
                    # the caller backs off and retries until it returns
                    state["failed"] = True
                    continue
                msg = hdr + wire.pack_keys(part)
                try:
                    c._send(MSG_PULL, msg)
                except (ConnectionError, OSError):
                    # transient-RST tolerance: one reconnect+resend before
                    # the shard is declared down (satellite: a blip must
                    # not trigger a rebalance)
                    c = self._retry_shard(i, lambda cc: cc._send(
                        MSG_PULL, msg))
                    if c is None:
                        state["failed"] = True
                        continue
                live.append((i, c, idx, msg))
            self._drain(live, handle)
        if state["failed"]:
            # a shard died or the route is mid-rebalance: adopt a newer
            # epoch if the master published one, so the caller's retry
            # re-splits instead of hammering the dead address.  Withheld
            # (SSP backpressure) is NOT a membership signal — polling the
            # master once per stall retry would hammer its admin plane.
            self.refresh_route()
        if state["withheld"] or state["failed"]:
            return None
        return keys_arr, rows

    def push_arrays(self, worker_id, keys, rows, worker_epoch) -> bool:
        keys_arr = np.ascontiguousarray(keys, np.int64)
        r = np.asarray(rows, np.float32).reshape(-1, self.dim)
        self._check_sorted(keys_arr, unique=True, op="push_arrays")
        table, partition, members = self._route()
        parts = self._split(keys_arr, partition, members)
        hdr = wire.pack_varint(np.array([worker_id, worker_epoch], np.int64))
        live = []
        state = {"ok": True}

        def handle(item):
            i, c = item
            try:
                reply = c._recv_reply()
            except (ConnectionError, OSError):
                self._mark_down(i)
                state["ok"] = False
                return
            if reply != b"\x00":
                c.dropped_pushes += 1
                state["ok"] = False  # partial application is possible
                # (per-shard ledgers — see class docstring); caller
                # semantics match the reference's lossy async pushes

        with obs_trace.span("ps_client/push", n_keys=int(keys_arr.size),
                            shards=len(members), epoch=table.epoch):
            for i, part, idx in parts:
                c = self._ensure(i)
                if c is None:
                    # shard down: that slice of the push is lost — the
                    # reference's async pushes are likewise lossy
                    state["ok"] = False
                    continue
                msg = hdr + wire.pack_rows(part, r[idx])
                try:
                    c._send(MSG_PUSH, msg)
                except (ConnectionError, OSError):
                    # send never reached the server: resending after one
                    # reconnect cannot double-apply
                    c = self._retry_shard(i, lambda cc: cc._send(
                        MSG_PUSH, msg))
                    if c is None:
                        state["ok"] = False
                        continue
                live.append((i, c))
            self._drain(live, handle)
        if not state["ok"]:
            self.refresh_route()
        return state["ok"]

    def preload_arrays(self, keys, rows) -> None:
        """Admin op: fails LOUD (ConnectionError) when any owning shard is
        unreachable — a silently partial preload would corrupt a restore."""
        keys_arr = np.ascontiguousarray(keys, np.int64)
        r = np.asarray(rows, np.float32).reshape(-1, self.dim)
        self._check_sorted(keys_arr, unique=True, op="preload_arrays")
        parts = self._split(keys_arr)
        live = []
        err = None
        for i, part, idx in parts:
            c = self._ensure(i)
            if c is None:
                err = err or ConnectionError(
                    f"PS shard {i} ({self.addresses[i]}) unreachable"
                )
                continue
            try:
                c._send(MSG_PRELOAD, wire.pack_keys(part) + r[idx].tobytes())
                live.append((i, c))
            except (ConnectionError, OSError) as e:
                self._mark_down(i)
                err = err or e

        def handle(item):
            i, c = item
            try:
                c._recv_reply()
            except (ConnectionError, OSError):
                self._mark_down(i)
                raise

        try:
            self._drain(live, handle)
        except (RuntimeError, OSError, ValueError) as e:
            err = err or e
        if err is not None:
            raise err

    def snapshot_shard(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Snapshot ONE shard (the backup agent's op).  Loud on failure."""
        c = self._ensure(i)
        if c is None:
            raise ConnectionError(
                f"PS shard {i} ({self.addresses[i]}) unreachable"
            )
        try:
            return c.snapshot_arrays()
        except (ConnectionError, OSError):
            self._mark_down(i)
            raise

    def snapshot_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        keys_parts, rows_parts = [], []
        for i in self._route()[2]:
            k, r = self.snapshot_shard(i)
            keys_parts.append(k)
            rows_parts.append(r)
        keys = np.concatenate(keys_parts)
        rows = np.concatenate(rows_parts) if len(keys) else \
            np.zeros((0, self.dim), np.float32)
        order = np.argsort(keys, kind="stable")
        return keys[order], rows[order]

    def _best_effort(self, fn) -> None:
        """Run a liveness/courtesy op against every reachable LIVE-member
        shard, marking unreachable ones down instead of raising."""
        for i in self._route()[2]:
            c = self._ensure(i)
            if c is None:
                continue
            try:
                fn(c)
            except (ConnectionError, OSError, RuntimeError):
                self._mark_down(i)

    def beat(self, worker_id: int) -> None:
        self._best_effort(lambda c: c.beat(worker_id))

    def stats(self):
        """Per-shard stats list (shard i = addresses[i]).  Every slot is a
        dict carrying ``addr`` and ``down``; a DOWN shard yields
        ``{"addr": ..., "down": True, "error": ...}`` — distinguishable
        from a healthy-but-empty shard (which reports its real counters) —
        so aggregators can count unreachable shards instead of treating
        them as zero traffic."""
        out = []
        for i in self._route()[2]:
            addr = list(self.addresses[i])
            c = self._ensure(i)
            if c is None:
                out.append({"shard": int(i), "addr": addr, "down": True,
                            "error": "unreachable (reconnect failed)"})
                continue
            try:
                st = c.stats()
                st["shard"] = int(i)
                st["addr"] = addr
                st["down"] = False
                out.append(st)
            except (ConnectionError, OSError, RuntimeError) as e:
                self._mark_down(i)
                out.append({"shard": int(i), "addr": addr, "down": True,
                            "error": str(e)})
        return out

    def cluster_health(self) -> Dict:
        """Aggregate health verdict over every shard (from the ``health``
        section each MSG_STATS reply now carries).  A DOWN shard degrades
        the aggregate instead of crashing the call — and a cluster whose
        every shard is down is UNHEALTHY outright.  Shards predating the
        health plane (no ``health`` in stats) count as ok."""
        shards = []
        statuses = []
        down = 0
        for st in self.stats():
            entry = {"addr": st.get("addr"), "down": bool(st.get("down"))}
            if st.get("down"):
                down += 1
                entry["status"] = obs_health.DEGRADED
                entry["error"] = st.get("error")
            else:
                v = st.get("health") or {}
                entry["status"] = v.get("status", obs_health.OK)
                entry["detectors"] = v.get("detectors", {})
            statuses.append(entry["status"])
            shards.append(entry)
        status = obs_health.worst(statuses)
        if down and down == len(statuses):
            status = obs_health.UNHEALTHY
        return {"status": status, "down_shards": down, "shards": shards}

    def farewell(self, worker_id: int) -> None:
        self._best_effort(lambda c: c.farewell(worker_id))

    def close(self) -> None:
        for c in self.clients:
            if c is not None:
                c.close()


def make_client(addresses, dim: int, partition: str = "modulo"):
    """One shard address -> plain PSClient; several -> key-partitioned
    :class:`ShardedPSClient` (the policy both the cluster launcher and the
    Criteo soak use).  ``partition`` picks the key->shard policy
    ("modulo" or consistent-hash "ring", see dist/partition.py)."""
    if len(addresses) == 1:
        return PSClient(tuple(addresses[0]), dim)
    return ShardedPSClient(addresses, dim, partition=partition)
