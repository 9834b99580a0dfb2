"""Cross-process asynchronous parameter server backed by the native ShmKV.

:class:`~lightctr_tpu_torch.embed.async_ps.AsyncParamServer` preserves the
reference PS's SSP/DCASGD semantics for threads of one process; this module
is the multi-process form — the one-host counterpart of the reference's
multi-node PS cluster (``distribut/paramserver.h`` over ZeroMQ): N worker
*processes* push/pull against file-backed shared memory with the same
float-CAS update discipline as ``util/shm_hashtable.h``.

Layout (four ShmKV stores under one base path):
  ``<base>.data``    key -> float[dim]       parameter rows
  ``<base>.accum``   key -> float[dim]       Adagrad / DCASGDA accumulators
  ``<base>.shadow``  (worker<<SHIFT)|key -> float[dim]  per-worker shadows
  ``<base>.meta``    version/routing ledger, one row per concern so every
                     row has exactly ONE writer (no read-modify-write races):
                       worker              -> epoch as two fp32 limbs
                                              (lo = e % 2^24, hi = e // 2^24
                                              — exact to 2^48 steps; a raw
                                              fp32 would saturate at 2^24)
                       ROUTE_BASE + worker -> [routed, 0] (coordinator-owned)

Async-by-design concurrency notes (all match the reference's tolerance):
  - sgd/adagrad updates are atomic float-CAS adds — concurrent pushes from
    any number of processes interleave without loss;
  - the adagrad read-after-add of the accumulator may observe a competitor's
    increment (slightly smaller step) — same as the PS applying pushes in
    arrival order;
  - DCASGDA's EMA accumulator is last-writer-wins (``set``), the in-arrival
    -order behavior of paramserver.h:269-287;
  - lazy init races resolve to the sum of the racers' random rows — still a
    valid random init (variance sqrt(2)x at worst, once per key ever).

The SSP gate uses the min over live workers' ledger epochs: a pull from a
worker more than ``staleness_threshold`` epochs ahead of the slowest is
withheld (pull.h:50-67); a push more than the threshold behind the fastest
is dropped (paramserver.h:201-205).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from lightctr_tpu_torch.native.bindings import ShmKV, available

STALENESS_THRESHOLD = 10  # kStalenessStepThreshold, paramserver.h:20
_WORKER_SHIFT = 48  # shadow composite keys: (worker << 48) | key
_ROUTE_BASE = 1 << 32  # meta keys for routing flags (distinct writer per row)
_LIMB = 1 << 24  # fp32 exact-integer range: epochs stored as (lo, hi) limbs
_FORMAT_KEY = 1 << 33  # meta row holding [format_version, 0]
_FORMAT_VERSION = 2.0  # v2 = limb-encoded epochs + separate routing rows


def _encode_epoch(epoch: int) -> np.ndarray:
    return np.array([epoch % _LIMB, epoch // _LIMB], np.float32)


def _decode_epoch(row) -> int:
    if row is None:
        return 0
    return int(row[0]) + int(row[1]) * _LIMB


class ShmAsyncParamServer:
    """Multi-process sparse async PS.  One process calls :meth:`create`;
    every worker process calls :meth:`open` with its ``worker_id`` and then
    uses :meth:`pull` / :meth:`push` — the same protocol surface as
    ``AsyncParamServer``, minus the in-process heartbeat wiring (routing
    flags live in the meta store and survive process restarts)."""

    def __init__(
        self,
        stores,
        dim: int,
        n_workers: int,
        updater: str,
        learning_rate: float,
        staleness_threshold: int,
        dcasgd_lambda: float,
        momentum_rate: float,
        eps: float,
        seed: int,
    ):
        if updater not in ("sgd", "adagrad", "dcasgd", "dcasgda"):
            raise ValueError(f"unknown updater {updater!r}")
        self._data, self._accum, self._shadow, self._meta = stores
        self.dim = dim
        self.n_workers = n_workers
        self.updater = updater
        self.lr = learning_rate
        self.staleness_threshold = staleness_threshold
        self.dcasgd_lambda = dcasgd_lambda
        self.momentum_rate = momentum_rate
        self.eps = eps
        self._rng = np.random.default_rng(seed)
        self.dropped_pushes = 0
        self.withheld_pulls = 0

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(
        cls,
        base_path: str,
        capacity: int,
        dim: int,
        n_workers: int,
        updater: str = "adagrad",
        learning_rate: float = 0.1,
        staleness_threshold: int = STALENESS_THRESHOLD,
        dcasgd_lambda: float = 0.1,
        momentum_rate: float = 0.95,
        eps: float = 1e-7,
        seed: int = 0,
    ) -> "ShmAsyncParamServer":
        if not available():  # pragma: no cover - build env dependent
            raise RuntimeError("native shm_kv library unavailable")
        shadow_cap = capacity * (n_workers if updater.startswith("dcasgd") else 1)
        stores = (
            ShmKV.create(base_path + ".data", capacity, dim),
            ShmKV.create(base_path + ".accum", capacity, dim),
            ShmKV.create(base_path + ".shadow", shadow_cap, dim),
            ShmKV.create(base_path + ".meta", 4 * (n_workers + 1), 2),
        )
        ps = cls(
            stores, dim, n_workers, updater, learning_rate,
            staleness_threshold, dcasgd_lambda, momentum_rate, eps, seed,
        )
        ps._meta.set(_FORMAT_KEY, np.array([_FORMAT_VERSION, 0.0], np.float32))
        for w in range(n_workers):
            ps._meta.set(w, _encode_epoch(0))
            ps._meta.set(_ROUTE_BASE + w, np.array([1.0, 0.0], np.float32))
        return ps

    @classmethod
    def open(
        cls,
        base_path: str,
        n_workers: int,
        updater: str = "adagrad",
        learning_rate: float = 0.1,
        staleness_threshold: int = STALENESS_THRESHOLD,
        dcasgd_lambda: float = 0.1,
        momentum_rate: float = 0.95,
        eps: float = 1e-7,
        seed: Optional[int] = None,
    ) -> "ShmAsyncParamServer":
        if not available():  # pragma: no cover - build env dependent
            raise RuntimeError("native shm_kv library unavailable")
        stores = (
            ShmKV.open(base_path + ".data"),
            ShmKV.open(base_path + ".accum"),
            ShmKV.open(base_path + ".shadow"),
            ShmKV.open(base_path + ".meta"),
        )
        fmt = stores[3].get(_FORMAT_KEY)
        if fmt is None or float(fmt[0]) != _FORMAT_VERSION:
            found = None if fmt is None else float(fmt[0])
            for s in stores:  # don't leak the four fresh mmap handles
                s.close()
            raise RuntimeError(
                f"{base_path}.meta ledger format {found} != "
                f"{_FORMAT_VERSION}: recreate the store (a stale-layout "
                "ledger would silently decode garbage epochs)"
            )
        dim = stores[0].dim
        return cls(
            stores, dim, n_workers, updater, learning_rate,
            staleness_threshold, dcasgd_lambda, momentum_rate, eps,
            seed if seed is not None else os.getpid(),
        )

    def close(self) -> None:
        for s in (self._data, self._accum, self._shadow, self._meta):
            s.close()

    # -- ledger ------------------------------------------------------------

    def _ledger(self):
        """(epochs[n_workers], routed[n_workers]) from the meta store."""
        wids = np.arange(self.n_workers, dtype=np.uint64)
        erows, efound = self._meta.get_batch(wids)
        rrows, rfound = self._meta.get_batch(_ROUTE_BASE + wids)
        limbs = erows.astype(np.int64)  # fp32 limbs hold exact ints < 2^24
        epochs = np.where(
            efound.astype(bool), limbs[:, 0] + limbs[:, 1] * _LIMB, 0
        )
        routed = np.where(rfound.astype(bool), rrows[:, 0], 1.0)
        return epochs, routed.astype(bool)

    def advance_epoch(self, worker_id: int, epoch: int) -> None:
        """Record the worker's ledger epoch.  Each worker is the SOLE writer
        of its epoch row (routing lives in a separate coordinator-owned row,
        so this write can never resurrect a cleared routing flag); regressions
        are ignored."""
        cur = _decode_epoch(self._meta.get(int(worker_id)))
        self._meta.set(int(worker_id), _encode_epoch(max(cur, int(epoch))))

    def unroute_worker(self, worker_id: int) -> None:
        self._meta.set(
            _ROUTE_BASE + int(worker_id), np.array([0.0, 0.0], np.float32)
        )

    def readmit_worker(self, worker_id: int) -> None:
        self._meta.set(
            _ROUTE_BASE + int(worker_id), np.array([1.0, 0.0], np.float32)
        )

    def _routed(self, worker_id: int) -> bool:
        row = self._meta.get(_ROUTE_BASE + int(worker_id))
        return row is None or bool(row[0] > 0.5)

    def attach_heartbeat(self, monitor) -> None:
        """Wire a :class:`~lightctr_tpu_torch.dist.bootstrap.HeartbeatMonitor` on
        the coordinator: dead -> unroute, returning beat -> readmit — the
        same contract as ``AsyncParamServer.attach_heartbeat``, with the
        routing flags visible to every worker PROCESS through the shared
        meta store.  Keep the monitor stopped before :meth:`close` — the
        listeners write through this handle."""
        from lightctr_tpu_torch.dist.bootstrap import wire_heartbeat

        wire_heartbeat(monitor, self, self.n_workers)

    # -- protocol ----------------------------------------------------------

    def preload(self, values: Dict[int, np.ndarray]) -> None:
        """Coordinator-side row initialization BEFORE workers start — the
        master's ``syncInitializer`` broadcast of starting parameters
        (ring_collect.h:74-79 / master.h:146-190).  Rows written here are
        never lazy-inited by workers, so every process trains from the same
        deterministic start."""
        keys = np.array(sorted(values), np.int64)
        if not len(keys):
            return
        rows = np.stack([
            np.asarray(values[int(k)], np.float32).reshape(self.dim)
            for k in keys
        ])
        self.preload_batch(keys, rows)

    def preload_batch(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Vectorized coordinator-side preload: rows[i] -> keys[i] in one
        native set_batch call."""
        self._data.set_batch(
            np.ascontiguousarray(keys, np.int64).astype(np.uint64),
            np.ascontiguousarray(rows, np.float32),
        )

    def _lazy_init(self, key: int) -> np.ndarray:
        """First touch creates ~ N(0,1)*sqrt(1/dim) (paramserver.h:315-339)
        via atomic add from the zero row ShmKV inserts."""
        v = self._data.get(key)
        if v is None:
            init = (
                self._rng.standard_normal(self.dim) * np.sqrt(1.0 / self.dim)
            ).astype(np.float32)
            self._data.add(key, init)
            v = self._data.get(key)
        return v

    def _rows_create(self, keys_arr: np.ndarray) -> np.ndarray:
        """Vectorized get + lazy init: one get_batch, one add_batch for the
        missing keys (first-touch random init via atomic add — racing
        initializers sum, same tolerance as the scalar path), one re-read.
        ``keys_arr`` must be unique (callers dedupe)."""
        ks = np.ascontiguousarray(keys_arr, np.int64).astype(np.uint64)
        rows, found = self._data.get_batch(ks)
        missing = ~found
        if missing.any():
            miss = ks[missing]
            init = (
                self._rng.standard_normal((len(miss), self.dim))
                * np.sqrt(1.0 / self.dim)
            ).astype(np.float32)
            self._data.add_batch(miss, init)
            rows[missing] = self._data.get_batch(miss)[0]
        return rows

    def _pull_gate(self, worker_epoch: int, worker_id: Optional[int]) -> bool:
        if worker_id is not None:
            if not self._routed(worker_id):
                return False
            self.advance_epoch(worker_id, worker_epoch)
        epochs, routed = self._ledger()
        if routed.any():
            slowest = float(epochs[routed].min())
            if worker_epoch - slowest > self.staleness_threshold:
                self.withheld_pulls += 1
                return False
        return True

    def pull_batch(
        self,
        keys: np.ndarray,
        worker_epoch: int,
        worker_id: Optional[int] = None,
    ) -> Optional[np.ndarray]:
        """Vectorized pull: ``[n, dim]`` fp32 rows in ``keys`` order (unique
        keys required), or None when SSP-withheld/unrouted — the same array
        contract as ``AsyncParamServer.pull_batch``, carried by ONE
        get_batch/add_batch crossing instead of 2-3 C calls per key."""
        if not self._pull_gate(worker_epoch, worker_id):
            return None
        keys_arr = np.ascontiguousarray(keys, np.int64)
        if len(keys_arr) > 1 and not (np.diff(np.sort(keys_arr)) > 0).all():
            raise ValueError("pull_batch keys must be unique")
        return self._rows_create(keys_arr)

    def pull(
        self, keys, worker_epoch: int, worker_id: Optional[int] = None
    ) -> Optional[Dict[int, np.ndarray]]:
        """key->value, or None when SSP-withheld (too far ahead of the
        slowest routed worker) or the caller is unrouted."""
        keys_list = [int(k) for k in keys]
        uniq = np.array(sorted(set(keys_list)), np.int64)
        rows = self.pull_batch(uniq, worker_epoch, worker_id)
        if rows is None:
            return None
        by_key = {int(k): rows[i] for i, k in enumerate(uniq)}
        return {k: by_key[k].copy() for k in keys_list}

    def _push_gate(self, worker_id: int, worker_epoch: int) -> bool:
        if not self._routed(worker_id):
            return False
        epochs, routed = self._ledger()
        # only routed workers count: a dead sprinter must not wedge the
        # survivors' pushes behind an unreachable fastest epoch
        fastest = float(epochs[routed].max()) if routed.any() else 0.0
        if worker_epoch + self.staleness_threshold < fastest:
            self.dropped_pushes += 1
            return False
        self.advance_epoch(worker_id, max(worker_epoch, 0))
        return True

    def push_batch(
        self,
        worker_id: int,
        keys: np.ndarray,
        grads: np.ndarray,
        worker_epoch: int,
    ) -> bool:
        """Vectorized push of ``[n, dim]`` grads for UNIQUE keys; False =
        dropped (stale beyond threshold, or unrouted).  Updater math is
        identical to the scalar path, but each store is touched a constant
        number of times per BATCH: sgd = one add_batch; adagrad = one fused
        native call over (data, accum); dcasgd(a) = batched shadow/accum
        reads + one add_batch + batched shadow write."""
        keys_arr = np.ascontiguousarray(keys, np.int64)
        if len(keys_arr) and int(keys_arr.max()) >= (1 << _WORKER_SHIFT):
            raise ValueError(
                f"key {int(keys_arr.max())} >= 2^{_WORKER_SHIFT} "
                "(shadow keyspace)"
            )
        if len(keys_arr) > 1 and not (np.diff(np.sort(keys_arr)) > 0).all():
            raise ValueError("push_batch keys must be unique")
        if not self._push_gate(worker_id, worker_epoch):
            return False
        if not len(keys_arr):
            return True
        g = np.ascontiguousarray(grads, np.float32).reshape(-1, self.dim)
        ks = keys_arr.astype(np.uint64)
        # first-touch init BEFORE the update, as the scalar path does
        w = self._rows_create(keys_arr)
        if self.updater == "sgd":
            self._data.add_batch(ks, -self.lr * g)
        elif self.updater == "adagrad":
            self._data.adagrad_batch(self._accum, ks, g, self.lr, self.eps)
        else:
            skeys = (np.uint64(worker_id) << np.uint64(_WORKER_SHIFT)) | ks
            shadow, sfound = self._shadow.get_batch(skeys)
            shadow[~sfound] = w[~sfound]
            if self.updater == "dcasgd":
                comp = g + self.dcasgd_lambda * g * g * (w - shadow)
            else:  # dcasgda
                acc = self._accum.get_batch(ks)[0]  # zeros when missing
                acc = (
                    self.momentum_rate * acc
                    + (1.0 - self.momentum_rate) * g * g
                )
                self._accum.set_batch(ks, acc)
                comp = g + (
                    self.dcasgd_lambda * g * g * (w - shadow)
                    / np.sqrt(acc + self.eps)
                )
            self._data.add_batch(ks, -self.lr * comp)
            self._shadow.set_batch(skeys, self._data.get_batch(ks)[0])
        return True

    def push(
        self, worker_id: int, grads: Dict[int, np.ndarray], worker_epoch: int
    ) -> bool:
        """Apply per-key grads with atomic float-CAS adds; False = dropped
        (stale beyond threshold, or unrouted)."""
        keys = np.array(sorted(grads), np.int64)
        rows = np.stack([
            np.asarray(grads[int(k)], np.float32).reshape(self.dim)
            for k in keys
        ]) if len(keys) else np.zeros((0, self.dim), np.float32)
        return self.push_batch(worker_id, keys, rows, worker_epoch)
