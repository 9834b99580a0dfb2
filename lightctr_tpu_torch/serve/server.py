"""PredictionServer: the MSG_PREDICT socket service with micro-batching
and admission control.

Rides the SAME socket machinery as the training PS (dist/ps_server.py
framing: u32 length + type byte, optional varint trace header under
``wire.TRACE_FLAG`` — headerless frames stay bit-identical, so old peers
interoperate) and adds the two things a latency-bound service needs that a
throughput-bound trainer does not:

**Micro-batching.**  Per-connection handler threads enqueue decoded
requests; ONE scorer thread drains the queue into batches of up to
``max_batch`` rows, waiting at most ``max_wait_us`` after the first
request of a batch, and scores each batch in one call on the model's
device — the device sees large batches while the caller sees bounded
added latency (the wait cap).

**Admission control / load shedding.**  The queue is BOUNDED in rows:
a request that would overflow it is refused AT ARRIVAL with the overload
reply (``0x02`` — the wire's 503), and a queued request whose deadline
expires before the scorer reaches it is dropped rather than scored (its
caller already gave up; scoring it would tax every request behind it).
Shedding is what keeps p99 bounded past saturation: offered load beyond
capacity turns into overload replies, not into an unbounded queue
(tools/serve_bench.py measures exactly this knee; docs/SERVING.md has
the policy discussion).

The server feeds its own latency histogram deltas to a
:class:`~lightctr_tpu_torch.obs.health.LatencySLODetector` (p50/p99 against the
configured SLO), so ``/healthz`` degrades BEFORE users notice, and its
:class:`~lightctr_tpu_torch.serve.cache.HotEmbeddingCache` sits in front of PS
pulls for PS-row-backed models (write-versioned invalidation via the
``stats`` op's ``write_version``).

The port's counterpart of ``lightctr_tpu/serve/server.py``: the same wire,
batching, admission and invalidation.  The server runs on ``device``
(``"cuda"`` by default); on CUDA the cache's gather kernel is built at
construction, so a kernel that does not build fails the server's start
instead of turning every later request into a shed.  ``drift=`` takes an
:class:`~lightctr_tpu_torch.obs.quality.DriftMonitor`, fed from each scored
batch's scores and its per-field deduped id streams (host numpy, no
launch): a score or coverage shift against its frozen reference degrades
this server's ``/healthz``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lightctr_tpu_torch.dist import wire
from lightctr_tpu_torch.dist.ps_server import (
    MSG_CLOSE,
    MSG_PREDICT,
    MSG_PREDICT_BATCH,
    MSG_STATS,
    _OP_NAMES,
    _recv_msg,
)

# inbound frame cap: far above any sane predict batch (a 4096-row x
# 128-slot request is ~3 MB) and far below the training PS's 256 MB
# snapshot-grade cap — the serving plane should refuse giant frames
# before buffering them
MAX_PREDICT_FRAME_BYTES = 16 * 1024 * 1024
from lightctr_tpu_torch.obs import flight as obs_flight
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs import health as obs_health
from lightctr_tpu_torch.obs import quality as obs_quality
from lightctr_tpu_torch.obs import resources as obs_resources
from lightctr_tpu_torch.obs import trace as obs_trace
from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.obs.registry import (
    MetricsRegistry,
    histogram_quantile,
    labeled,
)
from lightctr_tpu_torch.ops import sparse_kernels
from lightctr_tpu_torch.serve.cache import HotEmbeddingCache

_LOG = logging.getLogger(__name__)

#: reply status bytes (first payload byte of a predict reply)
STATUS_OK = b"\x00"
STATUS_OVERLOADED = b"\x02"

#: row-count buckets for the micro-batch size histogram
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class _Pending:
    """One enqueued request: decoded arrays + the rendezvous the handler
    thread blocks on until the scorer distributes results."""

    __slots__ = ("arrays", "n", "t_in", "deadline", "event", "scores",
                 "status")

    def __init__(self, arrays: Dict, n: int, t_in: float, deadline: float):
        self.arrays = arrays
        self.n = n
        self.t_in = t_in
        self.deadline = deadline
        self.event = threading.Event()
        self.scores: Optional[np.ndarray] = None
        self.status = "pending"   # -> ok | shed | error


class PredictionServer:
    """Threaded socket front-end over a :class:`ServingModel`.

    ``ps``: optional PSClient/ShardedPSClient — required when the model
    has ``row_leaves`` (PS-row-backed sparse leaves); misses route
    through the ``cache``.  ``deadline_ms``: per-request service budget
    (arrival to score) — expired queue entries are shed.  ``queue_cap``:
    admission bound in ROWS.  ``version_poll_s``: poll the PS write
    version at most this often (0 disables; :meth:`refresh_version`
    polls on demand).  ``score_delay_s``: deliberate per-batch scoring
    delay — a test/bench hook for driving the server into overload
    deterministically; never set it in production.  ``drift``: a
    :class:`~lightctr_tpu_torch.obs.quality.DriftMonitor` fed from every
    scored batch (one built without a health monitor binds this
    server's).  ``device``: where
    the cache block lives and scoring runs — the model's device type
    must match (``"cuda"`` by default; raises on a host without CUDA
    unless ``"cpu"`` is passed).
    """

    def __init__(
        self,
        model,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 256,
        max_wait_us: int = 2000,
        queue_cap: int = 1024,
        deadline_ms: float = 100.0,
        ps=None,
        cache: Optional[HotEmbeddingCache] = None,
        cache_capacity: int = 65536,
        version_poll_s: float = 0.0,
        slo_p99_s: float = 0.05,
        slo_p50_s: Optional[float] = None,
        slo_feed_every: int = 8,
        health: Optional[obs_health.HealthMonitor] = None,
        score_delay_s: float = 0.0,
        drift: Optional[obs_quality.DriftMonitor] = None,
        device="cuda",
    ):
        if model.row_leaves and ps is None:
            raise ValueError(
                "model has PS-row-backed leaves; pass the ps client"
            )
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(
                f"model on {model.device}, server on {self.device}"
            )
        if self.device.type == "cuda":
            sparse_kernels.load("gather_rows")
        self.model = model
        self.ps = ps
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_us) / 1e6
        self.queue_cap = int(queue_cap)
        self.deadline_s = float(deadline_ms) / 1e3
        self.version_poll_s = float(version_poll_s)
        self.score_delay_s = float(score_delay_s)
        self.registry = MetricsRegistry()
        if ps is not None and cache is None:
            cache = HotEmbeddingCache(
                dim=model.row_dim, capacity=cache_capacity,
                registry=self.registry, device=self.device,
            )
        elif cache is not None:
            cache.registry = self.registry
        self.cache = cache

        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._flight_name = f"serve_{self.address[1]}"
        obs_flight.register_registry(self._flight_name, self.registry)

        self._owns_health = health is None
        if health is None:
            health = obs_health.HealthMonitor(
                component=self._flight_name, registry=self.registry,
            )
        health.ensure_detector(obs_health.LatencySLODetector(
            p99_slo_s=slo_p99_s, p50_slo_s=slo_p50_s,
        ))
        self.health = health
        # model-quality drift (obs/quality.py): score-distribution and
        # per-field coverage sketches off the scored batches; a monitor
        # built without its own HealthMonitor inherits this server's, so a
        # drift trip degrades THIS server's /healthz
        self.drift = drift
        if drift is not None and drift.monitor is None:
            drift.bind_monitor(self.health)
        # resource plane (obs/resources.py): micro-batch queue saturation
        # telemetry — depth/capacity against the row bound, per-request
        # queue wait; a sustained-full queue degrades /healthz BEFORE
        # admission control starts shedding
        self._rq = obs_resources.InstrumentedQueue(
            f"{self._flight_name}_queue", capacity=self.queue_cap,
            registry=self.registry, monitor=self.health,
        )
        self._slo_feed_every = max(1, int(slo_feed_every))
        self._slo_prev_counts: Optional[List[int]] = None
        self._batches_scored = 0
        self._last_version_poll = 0.0

        self._queue: List[_Pending] = []
        self._queue_rows = 0
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._peers: List = []
        self._scorer = threading.Thread(
            target=self._score_loop, name="serve-scorer", daemon=True,
        )
        self._scorer.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
        )
        self._accept_thread.start()
        if self.ps is not None and self.cache is not None:
            # arm the write-version baseline at serve start: the FIRST
            # post-start PS write is already an invalidation, not a
            # baseline observation
            self.refresh_version()

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

    # -- admission ----------------------------------------------------------

    def _admit(self, arrays: Dict, n: int) -> Optional[_Pending]:
        """Bounded-queue admission: None = refused (shed at arrival)."""
        now = time.monotonic()
        item = _Pending(arrays, n, now, now + self.deadline_s)
        with self._cond:
            if self._queue_rows + n > self.queue_cap:
                depth, admitted = self._queue_rows, False
            else:
                self._queue.append(item)
                self._queue_rows += n
                depth, admitted = self._queue_rows, True
                self._cond.notify()
        # resource telemetry outside the queue lock: the saturation feed
        # can trigger a flight dump, which must not block admission
        if admitted:
            self._rq.note_enqueue(n)
        else:
            self._rq.note_drop(n)
        self._rq.set_depth(depth)
        return item if admitted else None

    def _shed(self, reason: str, n: int = 1) -> None:
        if obs_gate.enabled():
            self.registry.inc(labeled("serve_shed_total", reason=reason))
            self.registry.inc("serve_shed_rows_total", n)

    def _serve(self, conn: socket.socket):
        reg = self.registry
        out_count = [0]

        def send(data: bytes) -> None:
            conn.sendall(data)
            out_count[0] += len(data)

        def reply(body: bytes) -> None:
            send(struct.pack("<IB", len(body), 0) + body)

        try:
            while True:
                raw_type, payload = _recv_msg(conn,
                                              cap=MAX_PREDICT_FRAME_BYTES)
                msg_type = raw_type & ~wire.TRACE_FLAG & 0xFF
                frame_bytes = 5 + len(payload)
                telem = obs_gate.enabled()
                t0 = time.perf_counter() if telem else 0.0
                try:
                    rctx = None
                    if raw_type & wire.TRACE_FLAG:
                        rctx, used = wire.split_trace_ctx(payload)
                        payload = payload[used:]
                    span_cm = contextlib.nullcontext()
                    if msg_type != MSG_CLOSE and (
                            rctx is not None or obs_trace.enabled()):
                        span_cm = obs_trace.span(
                            "serve/" + _OP_NAMES.get(msg_type, "unknown"),
                            remote=rctx, n_bytes=len(payload),
                        )
                    with span_cm:
                        if msg_type in (MSG_PREDICT, MSG_PREDICT_BATCH):
                            arrays, used = wire.unpack_predict_batch(payload)
                            if used != len(payload):
                                raise ValueError(
                                    f"predict frame length mismatch: "
                                    f"{used} of {len(payload)} bytes"
                                )
                            # layout validation AT ADMISSION: a frame that
                            # does not match this model rejects alone (its
                            # connection's protocol error) instead of
                            # poisoning the micro-batch it would join
                            arrays = self.model.canonicalize_request(arrays)
                            n = int(arrays["fids"].shape[0])
                            if msg_type == MSG_PREDICT and n != 1:
                                raise ValueError(
                                    f"MSG_PREDICT carries one row, got {n}"
                                    " (use MSG_PREDICT_BATCH)"
                                )
                            item = self._admit(arrays, n)
                            if item is None:
                                self._shed("queue_full", n)
                                reply(STATUS_OVERLOADED)
                            else:
                                # generous rendezvous bound: the scorer
                                # sheds on the DEADLINE; this only guards
                                # against a wedged scorer thread
                                item.event.wait(self.deadline_s + 30.0)
                                if item.status == "ok":
                                    reply(STATUS_OK
                                          + wire.pack_values(item.scores)[0])
                                else:
                                    reply(STATUS_OVERLOADED)
                            if telem:
                                reg.inc("serve_rows_total", n)
                        elif msg_type == MSG_STATS:
                            body = json.dumps(self.stats()).encode()
                            reply(body)
                        elif msg_type == MSG_CLOSE:
                            return
                        else:
                            reply(b"\xff")
                        if telem:
                            op = _OP_NAMES.get(msg_type, "unknown")
                            reg.inc(labeled("serve_requests_total", op=op))
                            reg.observe(labeled("serve_op_seconds", op=op),
                                        time.perf_counter() - t0)
                            reg.inc("serve_bytes_received_total", frame_bytes)
                            reg.inc("serve_bytes_sent_total", out_count[0])
                            out_count[0] = 0
                except (ValueError, struct.error):
                    reply(b"\xff")
                    if telem:
                        reg.inc("serve_protocol_errors_total")
                    return
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    # -- the scorer ---------------------------------------------------------

    def _collect(self) -> List[_Pending]:
        """Block for the first request, then gather up to ``max_batch``
        rows, waiting at most ``max_wait_s`` past the first arrival."""
        with self._cond:
            while not self._queue and not self._stop.is_set():
                self._cond.wait(timeout=0.1)
            if self._stop.is_set() and not self._queue:
                return []
            t_limit = time.monotonic() + self.max_wait_s
            while (sum(i.n for i in self._queue) < self.max_batch
                   and not self._stop.is_set()):
                remaining = t_limit - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            batch: List[_Pending] = []
            rows = 0
            while self._queue:
                item = self._queue[0]
                if batch and rows + item.n > self.max_batch:
                    break
                batch.append(self._queue.pop(0))
                rows += item.n
            self._queue_rows -= rows
            depth = self._queue_rows
            if obs_gate.enabled():
                self.registry.gauge_set("serve_queue_rows", depth)
        if batch:
            now = time.monotonic()
            for item in batch:
                self._rq.note_wait(now - item.t_in)
        self._rq.set_depth(depth)
        return batch

    @staticmethod
    def _concat(items: List[_Pending]) -> Dict:
        """Concatenate request arrays row-wise, padding each field to the
        widest per-row slot count in the batch (zero fids + zero vals are
        inert: every model multiplies values in)."""
        fields = items[0].arrays.keys()
        out = {}
        for f in fields:
            parts = [np.asarray(i.arrays[f]) for i in items]
            width = max(p.shape[1] for p in parts)
            padded = []
            for p in parts:
                if p.shape[1] != width:
                    pad = np.zeros((p.shape[0], width - p.shape[1]),
                                   p.dtype)
                    p = np.concatenate([p, pad], axis=1)
                padded.append(p)
            out[f] = np.concatenate(padded, axis=0)
        return out

    def _score_loop(self):
        while not self._stop.is_set():
            batch: List[_Pending] = []
            try:
                batch = self._collect()
                if not batch:
                    continue
                self._score_batch(batch)
            except Exception:
                # the scorer must survive anything — fail the in-flight
                # requests, keep serving the next batch
                _LOG.exception("serve scorer batch failed")
                for item in batch:
                    if not item.event.is_set():
                        item.status = "error"
                        item.event.set()

    def _score_batch(self, batch: List[_Pending]) -> None:
        reg = self.registry
        telem = obs_gate.enabled()
        now = time.monotonic()
        live: List[_Pending] = []
        for item in batch:
            if now > item.deadline:
                # its caller's budget is spent: scoring it would only tax
                # the requests behind it (deadline-aware drop)
                item.status = "shed"
                self._shed("deadline", item.n)
                item.event.set()
            else:
                live.append(item)
        if not live:
            return
        arrays = self._concat(live)
        n_rows = int(arrays["fids"].shape[0])
        t0 = time.perf_counter()
        if self.score_delay_s:
            time.sleep(self.score_delay_s)
        try:
            with obs_trace.span("serve/score", rows=n_rows,
                                requests=len(live)):
                if self.model.row_leaves:
                    scores = self._score_ps_backed(arrays)
                else:
                    scores = self.model.score(arrays)
        except (ConnectionError, OSError, RuntimeError, ValueError):
            _LOG.warning("serve batch failed (PS unreachable?)",
                         exc_info=True)
            for item in live:
                item.status = "error"
                self._shed("backend_error", item.n)
                item.event.set()
            return
        dt = time.perf_counter() - t0
        ofs = 0
        t_done = time.monotonic()
        for item in live:
            item.scores = scores[ofs:ofs + item.n]
            ofs += item.n
            item.status = "ok"
            if telem:
                reg.observe("serve_predict_seconds", t_done - item.t_in)
            item.event.set()
        if telem:
            reg.inc("serve_batches_total")
            reg.inc("serve_scored_rows_total", n_rows)
            reg.observe("serve_batch_rows", float(n_rows),
                        buckets=_BATCH_BUCKETS)
            reg.observe("serve_score_seconds", dt)
        self._batches_scored += 1
        if self.drift is not None:
            self._feed_drift(arrays, scores)
        if self._batches_scored % self._slo_feed_every == 0:
            self._feed_slo()
        if (self.ps is not None and self.version_poll_s
                and t_done - self._last_version_poll > self.version_poll_s):
            self.refresh_version()

    def _score_ps_backed(self, arrays: Dict) -> np.ndarray:
        """The hot sparse path: dedup -> cache -> pull misses -> score on
        the gathered row block (the serving mirror of the sparse
        trainer's O(touched) recipe)."""
        cache = self.cache
        uids = self.model.touched_uids(arrays)
        cache.note_touched(uids)
        device = getattr(cache, "device_rows", False)
        if device:
            # the fused serve-side row path: hits are ONE registry-kernel
            # gather off the cache's resident block and stay on device
            # straight into the scorer
            rows, present = cache.lookup_device(uids)
        else:
            rows, present = cache.lookup(uids)
        miss = uids[~present]
        if miss.size:
            # create=False: a READ-ONLY pull — unknown fids come back as
            # zero rows (zero model contribution) and must not allocate
            # slots in the training store (query traffic would otherwise
            # grow it without bound)
            with obs_trace.span("serve/ps_pull", n_keys=int(miss.size)):
                out = self.ps.pull_arrays(miss, worker_epoch=0,
                                          worker_id=None, create=False)
            if out is None:
                raise ConnectionError(
                    "PS pull withheld/failed for serving miss batch"
                )
            _, pulled = out
            if device:
                rows.index_copy_(
                    0,
                    torch.from_numpy(np.flatnonzero(~present)).to(
                        rows.device),
                    torch.from_numpy(
                        np.ascontiguousarray(pulled, np.float32)).to(
                        rows.device))
            else:
                rows[~present] = pulled
            cache.insert(miss, pulled)
        return self.model.score_rows(arrays, uids, rows)

    # -- quality drift feed --------------------------------------------------

    def _feed_drift(self, arrays: Dict, scores) -> None:
        """Label-free quality sketches off data the scorer already holds:
        the batch scores and the per-field id streams (deduped, the streams
        ``touched_uids`` folds for the PS path).  A failed feed is logged
        and never fails the batch it rides."""
        try:
            fields: Dict[str, np.ndarray] = {}
            for f in getattr(self.model, "id_fields", ()):
                col = arrays.get(f)
                if col is not None:
                    fields[f] = np.unique(
                        np.asarray(col).reshape(-1).astype(np.int64))
            self.drift.observe(scores=np.asarray(scores), fields=fields)
        except Exception:
            _LOG.debug("drift feed failed", exc_info=True)

    # -- SLO feed -----------------------------------------------------------

    def _feed_slo(self) -> None:
        """Feed the latency detector the p50/p99 of the WINDOW since the
        last feed (histogram delta, not lifetime — a latency regression
        must not be averaged away by a long healthy history)."""
        if not obs_health.enabled():
            return
        snap = self.registry.snapshot()
        hist = snap.get("histograms", {}).get("serve_predict_seconds")
        if not hist:
            return
        counts = list(hist["counts"])
        prev = self._slo_prev_counts or [0] * len(counts)
        delta = [c - p for c, p in zip(counts, prev)]
        n = sum(delta)
        self._slo_prev_counts = counts
        if n <= 0:
            return
        window = {"le": hist["le"], "counts": delta, "count": n,
                  "sum": 0.0}
        self.health.observe(latency_quantiles={
            "p50": histogram_quantile(window, 0.5),
            "p99": histogram_quantile(window, 0.99),
            "count": n,
        })

    # -- serve-start cache warm-up ------------------------------------------

    def warm_from_ledger(self, ledger, k: Optional[int] = None) -> int:
        """Pre-pull the shared frequency ledger's top-``k`` keys into the
        hot-embedding cache at serve start (read-only PS pulls — unknown
        keys come back zero and allocate nothing in the training store).
        Returns rows warmed; 0 when the server has no PS-backed cache or
        the pull is withheld (warm-up is best-effort — a cold start is a
        latency cliff, not an error)."""
        if self.ps is None or self.cache is None:
            return 0

        def pull(uids: np.ndarray) -> np.ndarray:
            with obs_trace.span("serve/warmup_pull", n_keys=int(uids.size)):
                out = self.ps.pull_arrays(uids, worker_epoch=0,
                                          worker_id=None, create=False)
            if out is None:
                raise ConnectionError("warm-up pull withheld/failed")
            return out[1]

        try:
            return self.cache.warm_from_ledger(ledger, pull, k)
        except (ConnectionError, OSError, RuntimeError, ValueError):
            logging.getLogger(__name__).warning(
                "serve cache warm-up failed; starting cold", exc_info=True,
            )
            return 0

    # -- PS write-version invalidation --------------------------------------

    def refresh_version(self) -> bool:
        """Poll the PS shards' ``write_version`` and invalidate the cache
        when the tuple moved.  Never raises (an unreachable shard is a
        retry-later; its slot reads -1 so recovery also invalidates).

        PER-KEY DELTAS: each shard's stats may carry ``write_delta`` (the
        store's bounded write log).  When every moved shard's log still
        covers the cache's last-seen version, only the uids that actually
        changed are dropped (:meth:`HotEmbeddingCache.apply_delta`) — the
        rest of the hot set keeps serving.  A shard that is down, predates
        the log, or overflowed it degrades THIS poll to the whole-cache
        drop, never to staleness."""
        if self.ps is None or self.cache is None:
            return False
        self._last_version_poll = time.monotonic()
        try:
            st = self.ps.stats()
        except (ConnectionError, OSError, RuntimeError, ValueError):
            return False
        shards = st if isinstance(st, list) else [st]
        version = tuple(int(s.get("write_version", -1)) for s in shards)
        prev = self.cache.version
        if prev is None or len(prev) != len(version) or version == prev:
            return self.cache.set_version(version)  # arm / no-op / reshape
        changed: list = []
        for s, v_new, v_old in zip(shards, version, prev):
            if v_new == v_old:
                continue
            wd = s.get("write_delta")
            if (v_new < v_old or not wd
                    or v_old < int(wd.get("floor", 1 << 62))):
                return self.cache.set_version(version)  # not covered
            for entry in wd.get("entries", ()):
                # [version, uids] or [version, uids, write-ts] — the log
                # grew a wall timestamp for the freshness plane; this
                # poll-path consumer needs only the first two fields
                if int(entry[0]) > v_old:
                    changed.extend(entry[1])
        self.cache.apply_delta(version, changed)
        return True

    # -- reads / lifecycle ---------------------------------------------------

    def stats(self) -> Dict:
        out = {
            "address": list(self.address),
            "queue_rows": self._queue_rows,
            "queue_cap": self.queue_cap,
            "max_batch": self.max_batch,
            "batches_scored": self._batches_scored,
            "telemetry": self.registry.snapshot(),
            "health": self.health.verdict(),
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        obs_flight.unregister_registry(self._flight_name)
        self._rq.close()
        if self.drift is not None:
            self.drift.close()
        if self._owns_health:
            self.health.close()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        self._accept_thread.join(timeout=2.0)
        self._scorer.join(timeout=5.0)
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
