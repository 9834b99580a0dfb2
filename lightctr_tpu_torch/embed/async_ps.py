"""Host-driven asynchronous parameter server — SSP/DCASGD parity mode.

The synchronous mesh path (``lightctr_tpu.embed.table``) is the TPU-natural
replacement for the reference's PS; this module preserves the reference's
*asynchronous* semantics — bounded staleness (SSP) and delayed-compensation
updates — as a host-side coordinator for workloads that want them
(SURVEY.md §7 hard part (c)).

Reference semantics reproduced from ``distribut/paramserver.h``:

  - epoch-version ledger: the PS tracks ``last_epoch_version`` and the
    slowest worker's staleness (paramserver.h:189-210);
  - SSP pull gate: a pull from a worker *ahead* of the slowest by more than
    ``kStalenessStepThreshold`` (=10, paramserver.h:20) returns nothing and
    the worker retries after a sleep (pull.h:50-67);
  - push drop: a push more than the threshold *behind* is discarded
    (paramserver.h:201-205);
  - per-key update rules SGD / Adagrad / DCASGD / DCASGDA with per-worker
    shadow copies (paramserver.h:252-300);
  - lazy param init: first pull of a key creates it ~ N(0,1)*sqrt(1/dim)
    (paramserver.h:315-339).

Storage is slot-contiguous: weights / Adagrad accumulators / DCASGD shadow
copies live in dense ``[capacity, dim]`` arrays with a key->slot index, so
pull is one fancy-index gather and push is one vectorized updater step over
the whole batch — the role the reference fills with lock-free per-key C++
serving at scale (paramserver.h:138-210).  The per-key dict API is kept as a
thin wrapper for parity tests; the hot path is ``pull_batch``/``push_batch``.

Workers here are threads or host processes driving device steps; the "wire"
is in-process numpy (the reference's VarUint+fp16 codec belongs to ZeroMQ
transport, which has no equivalent need on a single host).
"""

from __future__ import annotations

import threading
import time
from itertools import repeat
from typing import Dict, Optional

import numpy as np

from lightctr_tpu_torch.native import bindings
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs import trace as obs_trace
from lightctr_tpu_torch.embed.ssp import SSPGateMixin
from lightctr_tpu_torch.embed.write_log import WriteLogMixin
from lightctr_tpu_torch.obs.registry import MetricsRegistry

STALENESS_THRESHOLD = 10  # kStalenessStepThreshold, paramserver.h:20


class _RowView:
    """Dict-like window onto one slot-contiguous array, keyed by feature id.
    Exists so parity tests can keep poking ``ps._data[key]`` / setting rows
    directly, exactly as they could when the store was a dict of rows."""

    def __init__(self, store: "AsyncParamServer", attr: str):
        self._store = store
        self._attr = attr  # the backing array is re-allocated on growth;
        # resolve it by name at every access

    def _arr(self) -> np.ndarray:
        return getattr(self._store, self._attr)

    def __getitem__(self, key: int) -> np.ndarray:
        slot = self._store._slot[int(key)]
        if self._attr == "_shw":
            self._store._ensure_shadow()
            return self._arr()[:, slot]
        return self._arr()[slot]

    def __setitem__(self, key: int, value) -> None:
        # direct set creates the slot WITHOUT an RNG draw (a plain dict store
        # would likewise not consume randomness on assignment)
        slot = self._store._slot_for_set(int(key))
        if self._attr == "_shw":
            self._store._ensure_shadow()
            self._arr()[:, slot] = np.asarray(value, np.float32)
        else:
            self._arr()[slot] = np.asarray(value, np.float32).reshape(
                self._store.dim
            )

    def __contains__(self, key: int) -> bool:
        return int(key) in self._store._slot

    def __len__(self) -> int:
        return self._store._n

    def keys(self):
        return self._store._slot.keys()

    def items(self):
        if self._attr == "_shw":
            self._store._ensure_shadow()
        for k, slot in self._store._slot.items():
            if self._attr == "_shw":
                yield k, self._arr()[:, slot]
            else:
                yield k, self._arr()[slot]


class AsyncParamServer(SSPGateMixin, WriteLogMixin):
    """Sparse KV store with bounded-staleness async updates."""

    def __init__(
        self,
        dim: int = 1,
        updater: str = "adagrad",
        learning_rate: float = 0.1,
        n_workers: int = 1,
        staleness_threshold: int = STALENESS_THRESHOLD,
        dcasgd_lambda: float = 0.1,
        momentum_rate: float = 0.95,
        seed: int = 0,
        eps: float = 1e-7,
        registry: Optional[MetricsRegistry] = None,
    ):
        if updater not in ("sgd", "adagrad", "dcasgd", "dcasgda"):
            raise ValueError(f"unknown updater {updater!r}")
        # per-STORE registry (not the process default): N shards hosted in
        # one process must report distinct snapshots over the stats op
        self.registry = registry if registry is not None else MetricsRegistry()
        # optional HealthMonitor (the socket service wires one in): the
        # store feeds its SSP staleness drift into it on every push
        self.health = None
        self.dim = dim
        self.updater = updater
        self.lr = learning_rate
        self.n_workers = n_workers
        self.staleness_threshold = staleness_threshold
        self.dcasgd_lambda = dcasgd_lambda
        self.momentum_rate = momentum_rate
        self.eps = eps
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        # slot-contiguous storage + key->slot index
        self._slot: Dict[int, int] = {}
        # lazily-built (sorted_keys, slots) snapshot for vectorized lookup
        # on large batches; never invalidated (slots are immutable), only
        # extended — allocations queue in _pending and merge in when the
        # drift passes a bound
        self._key_cache: Optional[tuple] = None
        self._pending: list = []  # [(keys, slots)] allocated post-snapshot
        self.key_cache_builds = 0   # full dict-walk snapshot (re)builds
        self.key_cache_merges = 0   # incremental _merge_pending folds
        self._n = 0
        self._cap = 0
        self._W = np.zeros((0, dim), np.float32)
        self._acc = np.zeros((0, dim), np.float32)
        # per-worker shadow copies exist for the delayed-compensation
        # updaters only (paramserver.h:252-300); sgd/adagrad never read
        # them, and at Criteo vocab an [n_workers, 2^20, dim] block would
        # dwarf the store itself — allocate lazily on first need
        self._needs_shadow = updater in ("dcasgd", "dcasgda")
        self._shw = np.zeros((n_workers, 0, dim), np.float32)
        # dict-like parity views (same names the dict-backed store exposed)
        self._data = _RowView(self, "_W")
        self._accum = _RowView(self, "_acc")
        self._shadow = _RowView(self, "_shw")
        self.last_epoch_version = 0
        self.staleness = 0
        self.staleness_worker: Optional[int] = None
        self.dropped_pushes = 0
        self.withheld_pulls = 0
        # unrouted workers (heartbeat-declared dead, master.h:202-262: the
        # master deletes the dead node's router; here that means its traffic
        # is rejected until it re-registers)
        self._unrouted: set = set()
        self.rejected_pushes = 0
        self.rejected_pulls = 0
        # elastic-rebalance grace: while a row migration is in flight the
        # SSP budget runs widened (workers stall on dead-shard retries, so
        # honest drift grows without anything being wrong) — the BASE
        # threshold is kept so the budget snaps back when the grace ends
        self._base_staleness_threshold = staleness_threshold
        self.evicted_keys = 0
        # monotonic WRITE version: bumped by every mutation of row values
        # (push/preload/migrate/evict).  The serving plane's hot-embedding
        # cache reads it over MSG_STATS and drops cached rows when it
        # moves — versioned invalidation with bounded staleness
        # (docs/SERVING.md), no per-row timestamps on the hot path
        self.write_version = 0
        # per-key invalidation DELTAS (embed/write_log.py WriteLogMixin):
        # a bounded log of (version, touched uids, write ts) per bump,
        # shipped in stats()["write_delta"] and over MSG_SUBSCRIBE so the
        # serving cache can drop ONLY the rows that actually changed
        self._init_write_log(self._lock)

    # -- storage -----------------------------------------------------------

    def _grow(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = max(64, self._cap)
        while cap < need:
            cap *= 2
        for name in ("_W", "_acc"):
            old = getattr(self, name)
            new = np.zeros((cap, self.dim), np.float32)
            new[: self._n] = old[: self._n]
            setattr(self, name, new)
        if self._needs_shadow:
            old = self._shw
            new = np.zeros((self.n_workers, cap, self.dim), np.float32)
            new[:, : self._n] = old[:, : self._n]
            self._shw = new
        self._cap = cap

    def _ensure_shadow(self) -> None:
        """Allocate the shadow block on demand (a test poking ``_shadow``
        on an sgd/adagrad store, or a future updater switch).  Later-created
        rows keep shadow == init via _slots_create; rows that existed
        before this call get shadow == their CURRENT value — for updaters
        that never read shadows this is unobservable."""
        if not self._needs_shadow:
            self._needs_shadow = True
            self._shw = np.tile(self._W[None, : self._cap], (self.n_workers, 1, 1)) \
                if self._cap else np.zeros((self.n_workers, 0, self.dim), np.float32)

    def _alloc_slots(self, new_keys: np.ndarray) -> np.ndarray:
        """Allocate fresh zero-filled slots for UNIQUE unseen keys; the one
        place the grow/assign/advance bookkeeping lives.  Callers layer
        their own row init on top (RNG rows in _slots_create, explicit
        rows in preload)."""
        m = len(new_keys)
        self._grow(self._n + m)
        sl = np.arange(self._n, self._n + m)
        for k, s in zip(new_keys.tolist(), sl.tolist()):
            self._slot[k] = s
        self._n += m
        # The sorted lookup snapshot (_key_cache) stays valid — slots are
        # immutable, so it is merely incomplete; post-snapshot batches
        # queue here until the drift passes the merge bound.  Without a
        # snapshot there is nothing to queue FOR (the first build walks
        # the whole dict), so skip the append — a small-batch workload
        # that never reaches the vectorized lookup would otherwise
        # accumulate (keys, slots) pairs forever (ADVICE.md round 5) —
        # and bound the queue HERE, not only in the >=4096-key lookup
        # path, so _pending cannot outgrow the drift bound no matter
        # which call pattern allocates.
        if self._key_cache is not None:
            self._pending.append((new_keys, sl))
            if (len(self._slot) - len(self._key_cache[0])
                    > max(4096, len(self._key_cache[0]) // 8)):
                self._merge_pending()
            elif obs_gate.enabled():
                self.registry.gauge_set(
                    "ps_store_pending_depth", len(self._pending)
                )
        return sl

    def _merge_pending(self) -> None:
        """Fold the post-snapshot allocation queue into the sorted lookup
        snapshot with one sorted-merge ``np.insert`` — O(n) memcpy, no
        dict walk / full argsort (the p99 spikes of the rebuild-from-dict
        form were ~10x the p50).  No-op when there is no snapshot."""
        if self._key_cache is None or not self._pending:
            return
        sk, sv = self._key_cache
        pk = np.concatenate([k for k, _ in self._pending])
        pv = np.concatenate([s for _, s in self._pending])
        order = np.argsort(pk)
        pk, pv = pk[order], pv[order]
        pos = np.searchsorted(sk, pk)
        self._key_cache = (np.insert(sk, pos, pk), np.insert(sv, pos, pv))
        self._pending = []
        self.key_cache_merges += 1
        if obs_gate.enabled():
            self.registry.inc("ps_store_key_cache_merges_total")
            self.registry.gauge_set("ps_store_pending_depth", 0)

    def _slot_for_set(self, key: int) -> int:
        """Slot for a direct row assignment: allocate zero-filled, no RNG."""
        slot = self._slot.get(key)
        if slot is None:
            slot = int(self._alloc_slots(np.array([key], np.int64))[0])
        return slot

    def _dict_slots(self, keys: np.ndarray) -> np.ndarray:
        """key->slot through the dict (C-level map over native ints, ~2.3x
        a per-key generator); -1 for unknown keys.  The one dict-resolution
        idiom, shared by the small-batch path, the snapshot-miss path, and
        preload."""
        kl = keys.tolist()
        return np.fromiter(
            map(self._slot.get, kl, repeat(-1)), np.int64, count=len(kl)
        )

    def _slots_create(self, keys: np.ndarray) -> np.ndarray:
        """key->slot for a batch, lazily creating missing keys in
        first-occurrence order ~ N(0,1)*sqrt(1/dim) (paramserver.h:315-339).
        The batch RNG draw consumes the stream in the same order as the old
        one-key-at-a-time creation, so seeded trajectories are unchanged."""
        if len(keys) >= 4096 and self._slot:
            # vectorized searchsorted against a sorted SNAPSHOT of the key
            # index: ~5x the dict-get map at network-PS batch sizes.
            # Slots are immutable once assigned, so a stale snapshot is
            # still CORRECT for every key it contains — keys allocated
            # since the snapshot simply miss into the dict below.  The
            # snapshot is only rebuilt when the drift grows (amortized: a
            # lazy-init workload that allocates on every request must not
            # pay an O(n_keys) rebuild per request — measured 49ms p50
            # pulls at 2^20 vocab under rebuild-on-every-alloc).
            if self._key_cache is None:
                # first build: one dict walk
                sk = np.fromiter(self._slot.keys(), np.int64,
                                 count=len(self._slot))
                sv = np.fromiter(self._slot.values(), np.int64,
                                 count=len(self._slot))
                order = np.argsort(sk)
                self._key_cache = (sk[order], sv[order])
                self._pending = []
                self.key_cache_builds += 1
            elif (len(self._slot) - len(self._key_cache[0])
                    > max(4096, len(self._key_cache[0]) // 8)):
                # incremental: fold queued post-snapshot allocations in
                # (_merge_pending; _alloc_slots also merges eagerly at
                # this same bound, so the queue stays bounded even for
                # workloads that never reach this vectorized path)
                self._merge_pending()
            sk, sv = self._key_cache
            if len(sk):
                pos = np.searchsorted(sk, keys)
                pos_c = np.minimum(pos, len(sk) - 1)
                slots = np.where(sk[pos_c] == keys, sv[pos_c], -1)
            else:
                slots = np.full(len(keys), -1, np.int64)
            newer = np.flatnonzero(slots < 0)
            if newer.size:
                # keys allocated after the snapshot (or genuinely new):
                # resolve through the dict; remaining -1s are real misses
                slots[newer] = self._dict_slots(keys[newer])
        else:
            slots = self._dict_slots(keys)
        miss_idx = np.flatnonzero(slots < 0)
        if miss_idx.size:
            miss_keys = keys[miss_idx]
            uniq, first = np.unique(miss_keys, return_index=True)
            new_keys = uniq[np.argsort(first)]  # first-occurrence order
            m = len(new_keys)
            sl = self._alloc_slots(new_keys)
            rows = (
                self._rng.standard_normal((m, self.dim))
                * np.sqrt(1.0 / self.dim)
            ).astype(np.float32)
            self._W[sl] = rows
            self._acc[sl] = 0.0
            if self._needs_shadow:
                self._shw[:, sl] = rows  # every worker's shadow = init
            slots[miss_idx] = np.fromiter(
                map(self._slot.__getitem__, miss_keys.tolist()),
                np.int64,
                count=miss_idx.size,
            )
        return slots

    # -- protocol ----------------------------------------------------------

    def pull(
        self, keys, worker_epoch: int, worker_id: Optional[int] = None
    ) -> Optional[Dict[int, np.ndarray]]:
        """Returns key->value, or None when SSP-withheld (the worker should
        sleep and retry, pull.h:63-67) or when the worker is unrouted
        (heartbeat-dead: no route exists until it re-registers).

        Routing enforcement needs the caller's identity: pass ``worker_id``
        (the reference's pull is implicitly identified by the sender's node
        id on its connection; this API models that only when told who is
        asking).  Anonymous pulls skip the route check."""
        with self._lock:
            if not self._pull_gate(worker_epoch, worker_id):
                return None
            keys_arr = np.fromiter(
                (int(k) for k in keys), np.int64
            ) if not isinstance(keys, np.ndarray) else keys.astype(np.int64)
            # evaluate _slots_create BEFORE indexing: creation can grow
            # (reallocate) the backing array
            slots = self._slots_create(keys_arr)
            rows = self._W[slots]
            return {int(k): rows[i] for i, k in enumerate(keys_arr)}

    def pull_batch(
        self,
        keys: np.ndarray,
        worker_epoch: int,
        worker_id: Optional[int] = None,
        create: bool = True,
    ) -> Optional[np.ndarray]:
        """Vectorized pull: ``[n, dim]`` rows in ``keys`` order (a fresh
        copy), or None when withheld/unrouted.  The network PS hot path.

        ``create=False`` is the READ-ONLY form (the serving plane's):
        unknown keys yield zero rows and allocate NOTHING — query traffic
        must not grow the training store (a stream of junk fids would
        otherwise expand ``_W`` without bound and leak into snapshots,
        checkpoints and elastic migration)."""
        if not obs_gate.enabled():
            return self._pull_batch(keys, worker_epoch, worker_id, create)
        t0 = time.perf_counter()
        with obs_trace.span("ps_store/pull", n_keys=int(len(keys))):
            out = self._pull_batch(keys, worker_epoch, worker_id, create)
        reg = self.registry
        reg.observe("ps_store_pull_seconds", time.perf_counter() - t0)
        reg.inc("ps_store_pulls_total")
        if out is None:
            reg.inc("ps_store_gated_pulls_total")
        else:
            reg.inc("ps_store_pulled_keys_total", len(keys))
        return out

    def _pull_batch(
        self,
        keys: np.ndarray,
        worker_epoch: int,
        worker_id: Optional[int] = None,
        create: bool = True,
    ) -> Optional[np.ndarray]:
        with self._lock:
            if not self._pull_gate(worker_epoch, worker_id):
                return None
            keys_arr = np.ascontiguousarray(keys, np.int64)
            if not create:
                slots = self._dict_slots(keys_arr)
                known = slots >= 0
                rows = np.zeros((len(keys_arr), self.dim), np.float32)
                if known.any():
                    rows[known] = self._W[slots[known]]
                return rows
            slots = self._slots_create(keys_arr)
            return self._W[slots]

    def _apply(
        self, worker_id: int, slots: np.ndarray, g: np.ndarray
    ) -> None:
        """One vectorized updater step over a batch of unique slots
        (paramserver.h:252-300).  Uniqueness is validated by push_batch
        BEFORE any state mutation — every call here carries unique
        slots."""
        if self.updater == "sgd":
            self._W[slots] -= self.lr * g
        elif self.updater == "adagrad":
            if len(slots) >= 4096 and bindings.available():
                # fused one-pass native kernel (ps_rows.cpp) vs numpy's
                # five passes over the batch — the network-PS push hot path
                bindings.rows_adagrad_native(
                    self._W, self._acc, slots, g, self.lr, self.eps
                )
            else:
                acc = self._acc[slots] + g * g
                self._acc[slots] = acc
                self._W[slots] -= self.lr * g / np.sqrt(acc + self.eps)
        elif self.updater == "dcasgd":
            w = self._W[slots]
            shadow = self._shw[worker_id, slots]
            w -= self.lr * (
                g + self.dcasgd_lambda * g * g * (w - shadow)
            )
            self._W[slots] = w
            self._shw[worker_id, slots] = w
        elif self.updater == "dcasgda":
            acc = (
                self.momentum_rate * self._acc[slots]
                + (1.0 - self.momentum_rate) * g * g
            )
            self._acc[slots] = acc
            w = self._W[slots]
            shadow = self._shw[worker_id, slots]
            w -= self.lr * (
                g
                + self.dcasgd_lambda
                * g
                * g
                * (w - shadow)
                / np.sqrt(acc + self.eps)
            )
            self._W[slots] = w
            self._shw[worker_id, slots] = w

    def push(self, worker_id: int, grads: Dict[int, np.ndarray], worker_epoch: int) -> bool:
        """Apply per-key grads; returns False when dropped as too stale
        (paramserver.h:201-205) or when the worker is unrouted (heartbeat
        declared it dead).  Grads are batch-summed; they are divided by the
        minibatch size by the caller (we take pre-averaged grads)."""
        keys = np.fromiter((int(k) for k in grads), np.int64, count=len(grads))
        if len(grads):
            g = np.stack(
                [np.asarray(v, np.float32).reshape(self.dim)
                 for v in grads.values()]
            )
        else:
            g = np.zeros((0, self.dim), np.float32)
        return self.push_batch(worker_id, keys, g, worker_epoch)

    def push_batch(
        self,
        worker_id: int,
        keys: np.ndarray,
        grads: np.ndarray,
        worker_epoch: int,
    ) -> bool:
        """Vectorized push of ``[n, dim]`` grads for UNIQUE ``keys`` (the
        wire sends sorted-unique key streams); one fancy-indexed updater
        step instead of a per-key Python loop."""
        if not obs_gate.enabled():
            return self._push_batch(worker_id, keys, grads, worker_epoch)
        t0 = time.perf_counter()
        with obs_trace.span("ps_store/push", n_keys=int(len(keys))):
            ok = self._push_batch(worker_id, keys, grads, worker_epoch)
        reg = self.registry
        reg.observe("ps_store_push_seconds", time.perf_counter() - t0)
        reg.inc("ps_store_pushes_total")
        if ok:
            reg.inc("ps_store_pushed_keys_total", len(keys))
        else:
            reg.inc("ps_store_gated_pushes_total")
        # staleness drift the SSP ledger currently holds (slowest worker)
        reg.gauge_set("ps_store_staleness", self.staleness)
        hm = self.health
        if hm is not None:
            # SSP SLO detector input — same number the gauge above holds
            hm.observe(staleness=self.staleness)
        return ok

    def _push_batch(
        self,
        worker_id: int,
        keys: np.ndarray,
        grads: np.ndarray,
        worker_epoch: int,
    ) -> bool:
        with self._lock:
            keys_arr = np.ascontiguousarray(keys, np.int64)
            # UNIQUE is a hard contract, enforced server-side BEFORE any
            # state mutation (the staleness ledger must not advance and
            # no rows may lazily allocate for a push that is rejected):
            # on a duplicate slot the numpy fancy-assign updaters are
            # last-write-wins (one update per slot) while the native
            # kernel (ps_rows.cpp) accumulates every occurrence — a
            # violating caller must fail loud here, not silently diverge
            # between the two branches.  One sort + diff over int64 keys
            # is noise next to the dim-wide row updates.
            if keys_arr.size > 1:
                srt = np.sort(keys_arr)
                if np.any(np.diff(srt) == 0):
                    raise ValueError(
                        "push carries duplicate keys: per-push keys must "
                        "be unique (batch duplicate-key gradients are "
                        "summed client-side, push.h:55-66)"
                    )
            if not self._push_gate(worker_id, worker_epoch):
                return False
            if keys_arr.size:
                g = np.asarray(grads, np.float32).reshape(-1, self.dim)
                self._apply(worker_id, self._slots_create(keys_arr), g)
                self.write_version += 1
                self._note_write(keys_arr)
            return True

    # -- elastic membership (rebalance support) -----------------------------

    def migrate_in(self, keys: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Apply migrated rows (preload semantics: overwrite, reset
        accum/shadow — the row-only migration op, MSG_MIGRATE) and return
        the rows RE-READ from the store.  The read-back is what the
        migration protocol checksums: a matching FNV certifies the rows
        landed in this store, not merely that the bytes arrived."""
        self.preload_batch(keys, rows)
        with self._lock:
            slots = self._dict_slots(np.ascontiguousarray(keys, np.int64))
            return self._W[slots].copy()

    def migrate_in_state(
        self, keys: np.ndarray, rows: np.ndarray, accums: np.ndarray
    ):
        """Optimizer-state-carrying migration (MSG_MIGRATE_STATE): rows
        AND their Adagrad/DCASGDA accumulators land together, and both are
        re-read for the checksum verification — an elastic rebalance no
        longer resets the receiving shard's optimizer state
        (docs/ELASTICITY.md follow-up closed in docs/TIERED_STORE.md)."""
        self.preload_batch(keys, rows, accums=accums)
        with self._lock:
            slots = self._dict_slots(np.ascontiguousarray(keys, np.int64))
            return self._W[slots].copy(), self._acc[slots].copy()

    def evict_batch(self, keys: np.ndarray) -> int:
        """Remove keys from the store (rows migrated AWAY during a
        rebalance must not survive as stale duplicates — a later epoch
        migrating them back would resurrect pre-migration values).
        Returns how many of ``keys`` were present.  Slots are NOT
        recycled (slot immutability is what keeps concurrent readers of
        the sorted lookup snapshot safe); the snapshot itself is
        invalidated, because its contract is "every key it contains is
        live" and these no longer are."""
        with self._lock:
            keys_arr = np.ascontiguousarray(keys, np.int64)
            n = 0
            for k in keys_arr.tolist():
                if self._slot.pop(k, None) is not None:
                    n += 1
            if n:
                self._key_cache = None
                self._pending = []
                self.evicted_keys += n
                self.write_version += 1
                self._note_write(keys_arr)
        if n and obs_gate.enabled():
            self.registry.inc("ps_store_evicted_keys_total", n)
        return n

    def preload(self, values: Dict[int, np.ndarray]) -> None:
        """Coordinator-side deterministic row init BEFORE workers start —
        the master's syncInitializer broadcast (same contract as
        ``ShmAsyncParamServer.preload``)."""
        keys = np.fromiter(
            (int(k) for k in values), np.int64, count=len(values)
        )
        rows = (
            np.stack(
                [np.asarray(v, np.float32).reshape(self.dim)
                 for v in values.values()]
            )
            if len(values)
            else np.zeros((0, self.dim), np.float32)
        )
        self.preload_batch(keys, rows)

    def preload_batch(self, keys: np.ndarray, rows: np.ndarray,
                      accums: Optional[np.ndarray] = None) -> None:
        """Vectorized preload: rows[i] becomes the value of keys[i].
        Overwrites accum/shadow, not setdefault: a lazily-created key must
        not keep its stale random shadow/accum after the coordinator
        re-initializes the row (DCASGD compensation would pull toward the
        discarded random init).  ``accums`` sets the optimizer
        accumulators alongside (the state-carrying migration path) instead
        of resetting them."""
        with self._lock:
            keys_arr = np.ascontiguousarray(keys, np.int64)
            r = np.asarray(rows, np.float32).reshape(-1, self.dim)
            slots = self._dict_slots(keys_arr)
            miss = np.flatnonzero(slots < 0)
            if miss.size:
                # bulk zero-init allocation (no RNG — same as the one-key
                # _slot_for_set path).  Dedup the misses: a repeated new
                # key must map to ONE slot, not leak one per occurrence
                uniq, first = np.unique(keys_arr[miss], return_index=True)
                new_keys = uniq[np.argsort(first)]
                self._alloc_slots(new_keys)
                slots[miss] = np.fromiter(
                    map(self._slot.get, keys_arr[miss].tolist()),
                    np.int64, count=miss.size,
                )
            self._W[slots] = r
            self._acc[slots] = (
                0.0 if accums is None
                else np.asarray(accums, np.float32).reshape(-1, self.dim)
            )
            if self._needs_shadow:
                self._shw[:, slots] = r
            if keys_arr.size:
                self.write_version += 1
                self._note_write(keys_arr)

    def snapshot(self) -> Dict[int, np.ndarray]:
        with self._lock:
            return {
                k: self._W[slot].copy() for k, slot in self._slot.items()
            }

    def stats(self) -> Dict:
        """Counter snapshot for admin/monitoring surfaces (one authoritative
        implementation; the network PS serves this over MSG_STATS).
        ``pending_depth``/``key_cache_drift`` surface the sorted-lookup
        snapshot's allocation backlog (PR 1's merge rule bounds both).
        The ``store`` section (rows / capacity / load factor /
        bytes-resident) is the occupancy surface ``tools/metrics_report.py
        --store`` renders — the same shape the tiered store reports, so
        flat and tiered deployments read off one dashboard."""
        with self._lock:
            cache_len = (
                len(self._key_cache[0]) if self._key_cache is not None else 0
            )
            # resident bytes: W + acc (+ the lazily-allocated shadows)
            blocks = 2 + (self.n_workers if self._needs_shadow else 0)
            store = {
                "kind": "flat",
                "rows": len(self._slot),
                "capacity": self._cap,
                "load_factor": (
                    round(self._n / self._cap, 5) if self._cap else 0.0
                ),
                "bytes_resident": self._cap * self.dim * 4 * blocks,
                "dim": self.dim,
            }
            # ONE lock hold for the whole dict: the snapshot must be
            # internally consistent (gauges ride after release — registry
            # work stays off the store lock)
            out = {
                "store": store,
                "withheld_pulls": self.withheld_pulls,
                "dropped_pushes": self.dropped_pushes,
                "rejected_pulls": self.rejected_pulls,
                "rejected_pushes": self.rejected_pushes,
                "unrouted": sorted(self._unrouted),
                "last_epoch_version": self.last_epoch_version,
                "staleness": self.staleness,
                "staleness_budget": self.staleness_threshold,
                "evicted_keys": self.evicted_keys,
                "write_version": self.write_version,
                # per-key invalidation deltas (docs/SERVING.md): the
                # bounded write log as [[version, [uids...], ts], ...] — a
                # consumer at version v >= floor drops only the uids of
                # entries with version > v; below the floor it must drop
                # everything (the log no longer covers it)
                "write_delta": self._write_delta_record(),
                "n_keys": len(self._slot),
                # sorted-lookup snapshot health (async_ps._alloc_slots):
                "pending_depth": len(self._pending),
                "key_cache_drift": (
                    len(self._slot) - cache_len
                    if self._key_cache is not None else 0
                ),
                "key_cache_builds": self.key_cache_builds,
                "key_cache_merges": self.key_cache_merges,
            }
        if obs_gate.enabled():
            reg = self.registry
            reg.gauge_set("ps_store_rows", store["rows"])
            reg.gauge_set("ps_store_capacity_rows", store["capacity"])
            reg.gauge_set("ps_store_bytes_resident",
                          store["bytes_resident"])
        return out

    def _snapshot_slots(self):
        """(sorted keys, their slots) — the shared enumeration under the
        lock.  Caller holds the lock."""
        keys = np.fromiter(
            self._slot.keys(), np.int64, count=len(self._slot)
        )
        order = np.argsort(keys, kind="stable")
        slots = np.fromiter(
            self._slot.values(), np.int64, count=len(self._slot)
        )[order]
        return keys[order], slots

    def snapshot_arrays(self):
        """Vectorized snapshot -> (sorted int64 keys, [n, dim] rows).
        Row-only on purpose: the worker-facing MSG_SNAPSHOT path must not
        pay an n*dim accumulator copy it would throw away."""
        with self._lock:
            keys, slots = self._snapshot_slots()
            return keys, self._W[slots]

    def snapshot_state_arrays(self):
        """Snapshot WITH optimizer state -> (sorted keys, rows, accums) —
        the MSG_SNAPSHOT_STATE payload and the state-carrying checkpoint
        source (elastic rebalance migrates accumulators instead of
        resetting them)."""
        with self._lock:
            keys, slots = self._snapshot_slots()
            return keys, self._W[slots], self._acc[slots]
