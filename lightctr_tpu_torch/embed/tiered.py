"""Tiered embedding store: card-hot / shm-warm / mmap-cold rows.

The port's copy of ``lightctr_tpu/embed/tiered.py``.  Numpy mode
(``device_hot=False``, the committed host buffer of a PS host without a
card) is the JAX module's code unchanged; device mode keeps the hot tier
as a pair of float32 tensors on ``device`` (CUDA by default), read by the
``gather_rows`` kernel and written in place (``index_copy_``; the trainer
fast path's ``merge_apply``).  The JAX module's ``LIGHTCTR_DEVICE_HOT``
environment and backend probe is replaced by the explicit ``device_hot``
and ``device`` arguments.

Every other store in ``embed/`` must FIT somewhere — ``AsyncParamServer``
in host RAM, ``ShmAsyncParamServer`` in a fixed-capacity shm segment —
which caps vocabulary size well below the billion-row regime the
reference's mmap ``PersistentBuffer`` handled (persistent_buffer.h:26-90).
This module removes that ceiling: a :class:`TieredEmbeddingStore` presents
the same ``pull_batch``/``push_batch``/``preload``/``evict_batch``/
``migrate_in``/``snapshot_arrays``/``stats`` surface as
``AsyncParamServer`` (so ``ParamServerService`` hosts it behind the
unchanged MSG_PULL/MSG_PUSH wire — tier faults are invisible to clients
except latency), backed by three tiers:

  hot   bounded resident block (``hot_rows`` x dim fp32, device-feedable
        — the block a training step can gather from), slot-recycled,
        searchsorted key index (no per-key Python on the hot path);
  warm  the file-backed ``ShmKV`` (native/shm_kv.cpp) holding
        ``[row || accum]`` pairs — host shared memory, wider than HBM;
  cold  the mmap row log (``embed/mmap_store.py``) — disk-bounded, the
        PersistentBuffer role, crash-safe via checksum-framed appends.

Because CTR id traffic is extremely skewed (the observation that made the
sparse exchange O(touched) — Parallax, 1808.02621), a small hot set
absorbs almost all pulls/pushes: bounding the fast-tier footprint loses
little throughput while removing the memory ceiling (the storage-axis
analogue of bounding per-replica update state, 2004.13336).

Admission/promotion/demotion ride the SAME touched-uid frequency streams
the health plane's hot/dead-key detector and the serving cache's TinyLFU
already consume, through one shared :class:`~lightctr_tpu_torch.embed.ledger.
FrequencyLedger`: every batch's deduped ids bump it, and a missed row is
**admitted** to a full hot tier only when its touch count strictly beats
the coldest resident's (TinyLFU's insight, the same rule as
``serve/cache.py`` — admission, not eviction policy, is what keeps
one-hit wonders from flushing the hot set).  Admitted rows batch-fault
cold -> warm -> hot and the displaced lowest-frequency residents demote
tier-down (dirty rows written back ``[row || accum]`` BEFORE their slots
are reused — no lost push); rejected rows are served **in place**: pulls
read them from their tier, pushes apply the updater out-of-place and
write the result straight back, so tail traffic costs sequential log
appends instead of churning the hot set.

Optimizer accumulators tier alongside their rows, so a row's Adagrad
state survives any number of demotion/promotion round trips bit-exactly
(fp32 end to end), and a tiered store trained on the same stream as a
flat ``AsyncParamServer`` follows the identical trajectory — lazy init
~ N(0,1)*sqrt(1/dim) consumes the seeded RNG stream in the same
first-occurrence order whether a created row lands hot or bypasses to
cold (tests/test_tiered.py).

Per-tier occupancy/hit/fault/demotion metrics land in the store's
registry under the series declared in :data:`TIER_SERIES` (the AST lint
in tests/test_obs.py refuses undeclared ``tiered_*`` counters), and a
:class:`~lightctr_tpu_torch.obs.health.TierThrashDetector` watches the
promotion/demotion flow for a working set that no longer fits.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.embed.ledger import FrequencyLedger
from lightctr_tpu_torch.embed.ssp import SSPGateMixin
from lightctr_tpu_torch.embed.write_log import WriteLogMixin
from lightctr_tpu_torch.embed.mmap_store import (
    MmapRowStore,
    sorted_delete,
    sorted_insert,
)
from lightctr_tpu_torch.native import bindings
from lightctr_tpu_torch.obs import device as obs_device
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs import resources as obs_resources
from lightctr_tpu_torch.obs import trace as obs_trace
from lightctr_tpu_torch.obs.registry import MetricsRegistry, labeled

STALENESS_THRESHOLD = 10  # kStalenessStepThreshold, paramserver.h:20

_LOG = logging.getLogger(__name__)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a float32 tensor — ``np.sqrt``'s
    result, on any device.  ``torch.sqrt`` of a CPU float32 tensor is not
    correctly rounded, and neither is its float64 square root, so the
    float64 root rounded to float32 is corrected by at most one ulp
    against the exact float64 squares of the midpoints on either side
    (a midpoint has 25 significant bits, its square 50: exact)."""
    xd = x.double()
    s = torch.sqrt(xd).float()
    lo = torch.nextafter(s, torch.zeros_like(s))
    hi = torch.nextafter(s, torch.full_like(s, float("inf")))
    sd = s.double()
    m_lo = (sd + lo.double()) * 0.5
    m_hi = (sd + hi.double()) * 0.5
    s = torch.where(xd < m_lo * m_lo, lo, s)
    return torch.where(xd > m_hi * m_hi, hi, s)


class _PyWarmKV:
    """Pure-numpy stand-in for the native ``ShmKV`` warm tier: the same
    fixed-capacity no-delete contract (and the same ``RuntimeError`` on a
    full segment), host-RAM resident.  Used when the native library
    cannot build, so the three-tier design — and its bench/test surface —
    does not silently collapse to hot <-> cold.  NOT cross-process (that
    is what the real shm segment buys).

    Internals differ from the shm segment on purpose: in-process, a
    sorted-key searchsorted index costs ~5 numpy calls per batch op where
    the open-addressed probe loop costs dozens — and numpy CALL overhead,
    not element work, dominates the tiered fault path."""

    def __init__(self, capacity: int, width: int):
        self.capacity = int(capacity)
        self.width = int(width)
        self._sk = np.zeros(0, np.uint64)  # sorted resident keys
        self._sr = np.zeros(0, np.int64)   # aligned key -> row index
        self._rows = np.zeros((self.capacity, width), np.float32)
        self._rowkey = np.zeros(self.capacity, np.uint64)  # row -> key
        self.used = 0

    @classmethod
    def create(cls, path: str, capacity: int, width: int) -> "_PyWarmKV":
        del path  # interface parity with bindings.ShmKV.create
        return cls(capacity, width)

    def _lookup(self, ks: np.ndarray):
        """(row index per key, found mask) — one vectorized binary
        search (row index is meaningless where ``found`` is False)."""
        if not len(self._sk):
            return np.zeros(len(ks), np.int64), np.zeros(len(ks), bool)
        pos = np.minimum(self._sk.searchsorted(ks), len(self._sk) - 1)
        found = self._sk[pos] == ks
        return self._sr[pos], found

    def set_batch(self, keys: np.ndarray, rows: np.ndarray) -> None:
        ks = np.ascontiguousarray(keys, np.uint64)
        r = np.asarray(rows, np.float32).reshape(-1, self.width)
        if not len(ks):
            return
        if len(ks) == 1 or bool(np.all(ks[1:] > ks[:-1])):
            uniq, ur = ks, r  # the common case: callers pass sorted-unique
        else:
            uniq, inv = np.unique(ks, return_inverse=True)
            if len(uniq) != len(ks):
                ur = np.empty((len(uniq), self.width), np.float32)
                ur[inv] = r  # duplicate keys: last write wins, like the segment
            else:
                ur = r[np.argsort(ks, kind="stable")]
        ridx, found = self._lookup(uniq)
        if found.any():
            self._rows[ridx[found]] = ur[found]
        new = ~found
        n_new = int(new.sum())
        if not n_new:
            return
        if self.used + n_new > self.capacity:
            raise RuntimeError("warm segment full")
        nk = uniq[new]
        nr = np.arange(self.used, self.used + n_new, dtype=np.int64)
        ins = self._sk.searchsorted(nk)
        self._sk = sorted_insert(self._sk, ins, nk)
        self._sr = sorted_insert(self._sr, ins, nr)
        self._rows[nr] = ur[new]
        self._rowkey[nr] = nk
        self.used += n_new

    def get_batch(self, keys: np.ndarray):
        ks = np.ascontiguousarray(keys, np.uint64)
        out = np.zeros((len(ks), self.width), np.float32)
        if not len(ks):
            return out, np.zeros(0, bool)
        ridx, found = self._lookup(ks)
        if found.any():
            out[found] = self._rows[ridx[found]]
        return out, found

    def set_batch_refs(self, keys: np.ndarray,
                       rows: np.ndarray) -> np.ndarray:
        """:meth:`set_batch` that also returns each key's row index —
        :meth:`update_rows` tickets for the writer's next write."""
        self.set_batch(keys, rows)
        ks = np.ascontiguousarray(keys, np.uint64)
        return self._lookup(ks)[0]

    def get_batch_refs(self, keys: np.ndarray,
                       out: Optional[np.ndarray] = None):
        """:meth:`get_batch` plus each found key's ROW index (-1 for
        misses) — an :meth:`update_rows` ticket.  Rows never move once
        placed (the segment contract: no deletes), so a ticket stays
        valid for as long as the key is resident.  MISS rows are
        UNDEFINED (not zero): the tiered fault path overwrites every
        miss from the tier below, so zero-filling them was waste.
        ``out`` lets the caller land found rows straight in its own
        [n, width] buffer (one less allocation + copy per fault)."""
        ks = np.ascontiguousarray(keys, np.uint64)
        if out is None:
            out = np.empty((len(ks), self.width), np.float32)
        recs = np.full(len(ks), -1, np.int64)
        if not len(ks):
            return out, np.zeros(0, bool), recs
        ridx, found = self._lookup(ks)
        if found.any():
            fr = ridx[found]
            out[found] = self._rows[fr]
            recs[found] = fr
        return out, found, recs

    def update_rows(self, ridx: np.ndarray, keys: np.ndarray,
                    rows: np.ndarray) -> None:
        """In-place update of EXISTING rows by ticket: one scatter, no
        key lookup.  Stale tickets fail loud (same contract as the cold
        tier's ``update_records``)."""
        ks = np.ascontiguousarray(keys, np.uint64)
        if not len(ks):
            return
        if (ridx < 0).any() or (ridx >= self.used).any() or \
                not np.array_equal(self._rowkey[ridx], ks):
            raise ValueError("stale warm row tickets")
        self._rows[ridx] = np.asarray(rows, np.float32).reshape(
            -1, self.width)

    def close(self) -> None:
        pass

#: every ``tiered_*`` metric series this module writes — the AST lint in
#: tests/test_obs.py asserts the set matches the emission calls below, so
#: a tier-transition counter cannot ship dark (unregistered, undocumented)
TIER_SERIES = (
    "tiered_hot_hits_total",        # counter: touched keys already hot
    "tiered_fault_cache_hits_total",  # counter: misses served from the
                                      # fault-batch cache (no tier read)
    "tiered_warm_faults_total",     # counter: misses read from the warm tier
    "tiered_cold_faults_total",     # counter: misses read from the cold tier
    "tiered_creates_total",         # counter: first-touch row creations
    "tiered_promotions_total",      # counter: rows admitted into hot
    "tiered_admission_rejects_total",  # counter: misses denied residency
    "tiered_bypass_rows_total",     # counter: rows served/updated in place
    "tiered_demotions_total",       # counter, {to}: rows demoted tier-down
    "tiered_writeback_rows_total",  # counter: dirty rows persisted on demote
    "tiered_clean_demotions_total",  # counter: demotions that skipped the write
    "tiered_evicted_keys_total",    # counter: keys evicted from ALL tiers
    "tiered_cold_compactions_total",  # counter: cold-log compactions
    "tiered_hot_rows",              # gauge: current hot-resident rows
    "tiered_hot_row_budget",        # gauge: configured hot capacity
    "tiered_peak_hot_rows",         # gauge: max hot occupancy ever
    "tiered_warm_rows",             # gauge: warm-resident rows
    "tiered_cold_rows",             # gauge: cold-resident rows
    "tiered_bytes_resident",        # gauge: fast-tier (hot+warm) bytes
    "tiered_fault_seconds",         # histogram: fault-path latency
    # -- fault prefetch pipeline (device-resident hot tier) ---------------
    "tiered_fault_prefetch_batches_total",  # counter: dispatch tickets staged
    "tiered_fault_prefetch_rows_total",     # counter: miss rows staged ahead
    "tiered_fault_overlap_rows_total",  # counter: fault rows served from a
                                        # stage (read overlapped the step)
    "tiered_fault_sync_rows_total",     # counter: fault rows read in-line
    "tiered_fault_prefetch_stale_total",  # counter: staged rows invalidated
                                          # by an interleaved write pre-use
    "tiered_fault_overlap_ratio",   # gauge: overlap / (overlap + sync)
    "tiered_pull_plan_commits_total",  # counter: pulls served off a
                                       # dispatched plan (fast commit)
    "tiered_pull_plan_fallbacks_total",  # counter: plans invalidated by an
                                         # interleaved mutation (sync path)
    "tiered_dev_syncs_total",       # counter, {dir}: device block exports
)


class TieredEmbeddingStore(SSPGateMixin, WriteLogMixin):
    """Bounded-fast-tier sparse KV store with SSP async-update semantics.

    Drop-in for :class:`~lightctr_tpu_torch.embed.async_ps.AsyncParamServer`
    where the vocabulary does not fit: same protocol surface, same SSP
    gates (paramserver.h:189-205), same lazy init
    ~ N(0,1)*sqrt(1/dim) consuming the seeded RNG stream in the same
    first-occurrence order — so flat and tiered stores trained on one
    stream produce identical rows.

    ``hot_rows`` bounds resident fast rows; batches of ANY unique-key
    count work (rows the admission policy declines are served from their
    tier in place, so a batch wider than the budget costs bypass traffic,
    never an error).  ``warm_rows`` sizes the shm tier (0 disables;
    ``None`` defaults to ``4 * hot_rows``); without the native library
    the warm tier is gated off and rows fault cold <-> hot directly.
    ``updater`` is ``sgd`` or ``adagrad`` — the delayed-compensation
    updaters keep per-worker shadow copies, which do not tier (use the
    flat store for those).

    ``device_hot`` (default True) keeps the hot tier as a pair of float32
    tensors on ``device`` (default ``"cuda"``, which raises without CUDA;
    ``device="cpu"`` runs the same code on the CPU with the kernels'
    plain versions); ``device_hot=False`` is the numpy mode, which needs
    no device."""

    #: the store feeds ``tier_flow`` deltas to its health monitor —
    #: ``ParamServerService`` reads this to install a
    #: :class:`~lightctr_tpu_torch.obs.health.TierThrashDetector` on the
    #: monitor it owns (without it the feed would be silently dropped)
    feeds_tier_flow = True

    def __init__(
        self,
        dim: int,
        hot_rows: int,
        path: Optional[str] = None,
        updater: str = "adagrad",
        learning_rate: float = 0.1,
        n_workers: int = 1,
        staleness_threshold: int = STALENESS_THRESHOLD,
        eps: float = 1e-7,
        seed: int = 0,
        warm_rows: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
        ledger: Optional[FrequencyLedger] = None,
        health_feed_every: int = 16,
        cold_compact_factor: int = 4,
        device_hot: bool = True,
        prefetch: Optional[bool] = None,
        device="cuda",
    ):
        if updater not in ("sgd", "adagrad"):
            raise ValueError(
                f"tiered store supports sgd/adagrad, not {updater!r} "
                "(dcasgd shadow copies do not tier)"
            )
        if hot_rows < 1:
            raise ValueError("hot_rows must be >= 1")
        self.dim = int(dim)
        self.hot_rows = int(hot_rows)
        self.updater = updater
        self.lr = float(learning_rate)
        self.n_workers = int(n_workers)
        self.staleness_threshold = int(staleness_threshold)
        self._base_staleness_threshold = int(staleness_threshold)
        self.eps = float(eps)
        self._rng = np.random.default_rng(seed)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.health = None
        if ledger is None:
            # internal ledger: no top-uid side table (the store keeps
            # exact per-slot resident counts of its own, below)
            ledger = FrequencyLedger(top_cap=0)
        self.ledger = ledger
        self._ledger_decays_seen = ledger.decays
        self._health_feed_every = max(1, int(health_feed_every))
        self._cold_compact_factor = max(2, int(cold_compact_factor))
        self._lock = threading.Lock()

        # -- hot tier: slot-recycled resident block --------------------------
        #
        # Two representations behind ONE accessor family (_payload /
        # _hot_rows_of / _hot_land / _apply_slots):
        #   numpy mode (the committed host buffer — the CPU default, and
        #     what JAX_PLATFORMS=cpu parity tests exercise unchanged):
        #     _W/_acc host ndarrays, fancy-indexed;
        #   device mode (device_hot=True, the default): a pinned pair of
        #     float32 tensors [hot_rows, dim] (rows, accums) on
        #     ``device`` that the gather kernel reads and the scatter and
        #     apply write in place, so the pull → gather → apply chain
        #     for hot-resident uids never leaves the device.  The updater
        #     expression is IDENTICAL to the numpy form (w -
        #     lr*g/sqrt(acc+eps), fp32 end to end, each op correctly
        #     rounded), so flat/tiered trajectory parity holds
        #     bit-for-bit either way.
        # Demotion write-back, snapshots and migration all read the
        # authoritative rows through _payload/_read_values — the accessor
        # syncs (gathers from) the device block, never a stale mirror.
        cap = self.hot_rows
        self.device_hot = bool(device_hot)
        self.device = resolve_device(device) if self.device_hot else None
        if self.device_hot:
            # the pinned pair: rows and accums as separate device tensors
            # so the trainer fast path's merge_apply can write each in
            # place (adopt_device_tables marks the touched slots dirty)
            self._W = None
            self._acc = None
            self._devW = self._dev_zeros(cap, dim)
            self._devA = self._dev_zeros(cap, dim)
        else:
            self._W = np.zeros((cap, dim), np.float32)
            self._acc = np.zeros((cap, dim), np.float32)
            self._devW = None
            self._devA = None
        self._slot_keys = np.full(cap, -1, np.int64)
        # free-slot LIFO as an array stack (top = _n_free; pops take slot
        # 0 first) — a python list's per-slot pop showed on the fault path
        self._free = np.arange(cap - 1, -1, -1, dtype=np.int64)
        self._n_free = cap
        self._dirty = np.zeros(cap, bool)
        # EXACT per-slot touch counts for residents (one fancy-index add
        # per batch): victim selection never hashes — the sketch is only
        # consulted for non-resident candidates.  Kept in step with the
        # ledger's decay cadence (_sync_freq_decay).
        self._slot_freq = np.zeros(cap, np.float64)
        # lowest tier holding a (possibly stale) copy of the slot's row:
        # 0 = nowhere (created in hot, never persisted), 1 = warm,
        # 2 = cold.  A CLEAN demotion of a row whose copy below is current
        # skips the write-back entirely.
        self._lower = np.zeros(cap, np.int8)
        # searchsorted key index over the resident set (rebuilt after any
        # residency change): the hot-path lookup is one vectorized binary
        # search, never a per-key dict walk
        self._hk = np.zeros(0, np.int64)
        self._hs = np.zeros(0, np.int64)
        self.peak_hot_rows = 0

        # -- warm tier: ShmKV of [row || accum] ------------------------------
        if path is None:
            path = tempfile.mkdtemp(prefix="lightctr_tiered_") + "/store"
        else:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        self.path = path
        if warm_rows is None:
            warm_rows = 4 * self.hot_rows
        self._warm_store = None
        self.warm_rows = 0
        if warm_rows > 0:
            if bindings.available():
                self._warm_store = bindings.ShmKV.create(
                    path + ".warm", int(warm_rows), 2 * dim
                )
            else:  # no g++: host-RAM fallback (same contract, in-process)
                _LOG.info(
                    "native shm_kv unavailable: tiered store %s warm tier "
                    "falls back to host RAM (not cross-process)", path,
                )
                self._warm_store = _PyWarmKV.create(
                    path + ".warm", int(warm_rows), 2 * dim
                )
            self.warm_rows = int(warm_rows)
        # whether the warm backend supports row tickets (the native
        # ShmKV does not; the in-process fallback does): with tickets,
        # the push write-back scatters straight to warm rows the pull
        # just read — no second key lookup
        self._warm_refs_ok = hasattr(self._warm_store, "update_rows")
        self._warm: Dict[int, bool] = {}  # warm-resident keys (host index)
        # keys evicted while warm-resident: the segment cannot delete
        # (open addressing, no unlink), so reads mask these out.  Usually
        # EMPTY — eviction is the rare elastic path — so the fault path
        # pays nothing for it.
        self._warm_dead: set = set()

        # -- cold tier: mmap row log of [row || accum] -----------------------
        self._cold = MmapRowStore.create(path + ".cold.log", 2 * dim)

        # -- SSP ledger (paramserver.h:189-205, same as the flat store) ------
        self.last_epoch_version = 0
        self.staleness = 0
        self.staleness_worker: Optional[int] = None
        self.dropped_pushes = 0
        self.withheld_pulls = 0
        self.rejected_pulls = 0
        self.rejected_pushes = 0
        self._unrouted: set = set()
        self.evicted_keys = 0
        # EXACT total-key count maintained arithmetically (+creates,
        # +preloads of unseen keys, -evictions): the MSG_STATS monitoring
        # path must not pay an O(vocab) three-tier enumeration — nor
        # flush pending creates as a side effect — on every poll.
        # n_keys() stays the enumerating ground truth (tests assert the
        # two agree).
        self._total_keys = 0
        self.write_version = 0
        # per-key write log (embed/write_log.py WriteLogMixin): the
        # freshness surface MSG_SUBSCRIBE long-polls — tiered shards now
        # serve push-based subscribers instead of rejecting them into
        # the stats-polling degrade
        self._init_write_log(self._lock)
        # fault-batch cache: the last miss batch's (sorted keys, payload,
        # origin, tier tickets, mutation epoch, valid mask).  A trainer's
        # push reuses the rows its own pull just read (the universal
        # pull -> compute -> push cycle) — on an exact cover the cache
        # arrays alias straight through, zero copies.  Write-through
        # keeps it exact: pushes update the cached arrays in place as
        # they persist, and every operation that could make a cached row
        # stale (demotion write-back -> per-row valid mask, eviction/
        # preload/migration -> ``_mut_epoch`` bump, always flush-first)
        # invalidates it.
        self._fault_cache: Optional[tuple] = None
        self._cache_serial = 0  # bumps on every cache INSTALL (plan guard)
        # cache installed by a DISPATCH (speculative serve): the pull
        # side probes it (the rows were read off the critical path — the
        # probe is how partial-cover dispatches, e.g. the hosted push
        # echo, still overlap) and counts its hits as overlap rows
        self._cache_speculative = False
        self._cache_hits_speculative = 0
        self._mut_epoch = 0
        # whether the cache may hold PENDING creates (origin
        # _ORIGIN_PENDING): rows that consumed the rng stream but are not
        # yet persisted anywhere — their matching push persists the
        # post-update row in ONE write instead of two.  Every path that
        # could orphan them (cache replacement, snapshot/enumeration,
        # preload/evict cache invalidation, close) flushes them first.
        self._cache_pending = False
        self._cache_hits_last = 0
        self._cache_hit_info: Optional[tuple] = None
        self._cache_alias = False
        # pull-side cover cache: (sorted unique keys, their hot slots,
        # residency epoch).  The trainer's push carries exactly the
        # pull's unique cover, so a matching push skips its own index
        # probe AND the duplicate-key sort; _res_epoch (bumped on any
        # promotion/demotion/eviction) invalidates stale slot maps.
        self._slot_cache: Optional[tuple] = None
        self._res_epoch = 0
        self._last_admitted: Optional[tuple] = None
        # tier-flow deltas for the thrash detector feed
        self._flow_promotions = 0
        self._flow_demotions = 0
        self._flow_bypass = 0
        self._pushes_since_feed = 0
        self._occupancy_skips = 0
        # -- fault prefetch pipeline (docs/TIERED_STORE.md "Device-resident
        # hot tier"): dispatch_prefetch(next_keys) stages the NEXT batch's
        # miss payloads on a worker thread while the current step computes;
        # the committing pull serves staged rows without touching the slow
        # tiers.  Double-buffered: one stage in flight, one queued.  Every
        # write that could stale a staged row invalidates it surgically
        # (_pf_invalidate) or wholesale (_mut_epoch) — overlap NEVER
        # changes which bytes land (the overlap-vs-sync equivalence test).
        if prefetch is None:
            env = os.environ.get("LIGHTCTR_TIERED_PREFETCH", "").strip()
            prefetch = env not in ("0", "off", "false")
        self._prefetch_enabled = bool(prefetch)
        self._pf_thread = None
        self._pf_queue = None
        # resource-plane face of the ticket queue: depth/drop/wait land in
        # the store registry as resource_queue_* series (NOT tiered_* —
        # the TIER_SERIES lint covers only this module's own emissions)
        self._pf_iq = obs_resources.InstrumentedQueue(
            "tiered_prefetch", capacity=2, registry=self.registry,
            register=False)
        self._pf_cond = threading.Condition()
        self._pf_ticket = 0
        self._pf_completed = 0
        self._pf_stage: Optional[tuple] = None
        self._pf_plan: Optional[dict] = None
        self._stage_hits_last = 0
        self._pf_overlap_rows = 0
        self._pf_sync_rows = 0
        self._closed = False
        if obs_gate.enabled():
            self.registry.gauge_set("tiered_hot_row_budget", self.hot_rows)

    # -- device-resident hot block --------------------------------------------

    def _dev_zeros(self, rows: int, width: int) -> torch.Tensor:
        return torch.zeros((rows, width), dtype=torch.float32,
                           device=self.device)

    def _dev_slots(self, slots: np.ndarray) -> torch.Tensor:
        """int32 slot indices on the store's device."""
        return torch.from_numpy(
            np.ascontiguousarray(slots, np.int32)).to(self.device)

    def _dev_gather(self, arr, slots: np.ndarray) -> np.ndarray:
        from lightctr_tpu_torch.ops.sparse_kernels import next_pow2

        n = len(slots)
        if n == 0:
            return np.zeros((0, int(arr.shape[1])), np.float32)
        # pad to the shared pow2 ladder: hit counts differ nearly every
        # batch, and the padded lengths keep the kernel's shapes (and the
        # compile tracker's signatures) a bounded set
        sp = np.zeros(next_pow2(n), np.int32)
        sp[:n] = slots
        out = self._dev_fns()["gather"](arr, self._dev_slots(sp))
        return out[:n].cpu().numpy()

    @staticmethod
    def _pad_scatter(slots: np.ndarray, rows: np.ndarray):
        """(padded slots, padded rows) for the device scatter: lengths
        land on the shared pow2 ladder (bounded signature set) and the pad
        entries DUPLICATE the last real (slot, row) pair, so every
        repeat of that slot set-writes identical bytes — the scatter's
        undefined duplicate order cannot matter."""
        from lightctr_tpu_torch.ops.sparse_kernels import next_pow2

        n = len(slots)
        up = next_pow2(n)
        sp = np.full(up, slots[n - 1], np.int32)
        sp[:n] = slots
        rp = np.empty((up, rows.shape[1]), np.float32)
        rp[:n] = rows
        rp[n:] = rows[n - 1]
        return sp, rp

    # The device hot-tier ops run op by op ON PURPOSE: each elementwise
    # op is correctly rounded (the square root through sqrt_rn), so the
    # updater (acc' = acc + g*g ; w' = w - lr*g / sqrt(acc' + eps)) is
    # BIT-IDENTICAL to the numpy committed-buffer path and the flat
    # store.  A fused kernel could contract mul+add into an FMA or turn
    # /sqrt into *rsqrt, which is exactly the single-ulp drift the
    # flat/tiered parity contract forbids.  The rows still never leave
    # the device: the cost is per-op dispatch, not host↔device row
    # traffic.  The FUSED in-place chain (gather → merge_apply on the
    # pair) lives in the trainer fast path (models/sparse_trainer.py
    # TieredDeviceEmbedding), whose parity oracle is merge_apply itself.
    _DEV_FNS: Optional[dict] = None

    @classmethod
    def _dev_fns(cls) -> dict:
        if cls._DEV_FNS is None:
            from lightctr_tpu_torch.ops import sparse_kernels

            def gather(arr, slots):
                return sparse_kernels.gather_rows(arr, slots)

            def scatter(arr, slots, rows):
                return arr.index_copy_(0, slots.long(), rows)

            # The scatter is pure data movement — no arithmetic, so the
            # bit-parity contract above is untouched — and writes the
            # pinned block in place instead of copying all [hot_rows,
            # dim] per write.
            cls._DEV_FNS = {
                "gather": gather,
                # in-place writing verified by the device plane when
                # armed — a copy here is per-write memory doubling on
                # exactly the pinned block (obs/device.py)
                "scatter": obs_device.verify_donation(
                    "tiered_dev_scatter",
                    obs_resources.track_jit("tiered_dev_scatter", scatter),
                    donate_argnums=(0,)),
            }
        return cls._DEV_FNS

    def _note_dev_sync(self, direction: str) -> None:
        if obs_gate.enabled():
            self.registry.inc(
                labeled("tiered_dev_syncs_total", dir=direction)
            )

    def device_tables(self):
        """The hot tier as a ``(rows, accums)`` pair of float32 tensors
        ``[hot_rows, dim]`` each.  Device mode: THE pinned tensors
        themselves — the trainer fast path gathers from them and runs
        ``merge_apply`` on them in place, then reports the touched slots
        through :meth:`adopt_device_tables`.  Treat as read-only outside
        that path; the store owns mutation.  Numpy mode: a copy of the
        host buffers as CPU tensors, for callers wanting the API
        uniformly."""
        with self._lock:
            if self.device_hot:
                return self._devW, self._devA
            self._note_dev_sync("export")
            return (torch.from_numpy(self._W.copy()),
                    torch.from_numpy(self._acc.copy()))

    def device_block(self):
        """The hot tier as ONE ``[hot_rows, 2*dim]`` ``[rows ‖ accums]``
        export (a concat copy in either mode) — the serving-side block
        form.  Mutating consumers want :meth:`device_tables`."""
        w, a = self.device_tables()
        if self.device_hot:  # numpy mode: device_tables counted the export
            self._note_dev_sync("export")
        return torch.cat([w, a], dim=1)

    def adopt_device_tables(
        self, rows, accums, touched_slots: Optional[np.ndarray] = None,
        expect_res_epoch: Optional[int] = None,
    ) -> None:
        """Install the externally-updated device pair (the trainer fast
        path's post-step hand-back).  Device mode only; shapes must match.
        The fast path's ``merge_apply`` writes the pair it got from
        :meth:`device_tables` in place, so adopting that pair only marks
        ``touched_slots`` dirty (all occupied slots otherwise) and bumps
        ``write_version``; another pair of the right shape replaces it.
        ``expect_res_epoch`` fails loud when residency moved between the
        caller's gather and this adopt (its slot tickets were stale — the
        update must be retried on fresh tickets, never silently written
        through dead slots)."""
        if not self.device_hot:
            raise ValueError("adopt_device_tables needs device_hot mode")
        want = (self.hot_rows, self.dim)
        if tuple(rows.shape) != want or tuple(accums.shape) != want:
            raise ValueError(
                f"table shapes {tuple(rows.shape)}/{tuple(accums.shape)}"
                f" != {want}"
            )
        with self._lock:
            if expect_res_epoch is not None and \
                    expect_res_epoch != self._res_epoch:
                raise ValueError(
                    "stale slot tickets: residency moved "
                    f"({expect_res_epoch} -> {self._res_epoch})"
                )
            self._devW = rows
            self._devA = accums
            if touched_slots is not None:
                ts = np.asarray(touched_slots, np.int64)
                self._dirty[ts] = True
                self._note_write(self._slot_keys[ts])
            else:
                self._dirty[self._slot_keys >= 0] = True
            self.write_version += 1
            self._note_dev_sync("adopt")

    def hot_slots(self, keys: np.ndarray) -> np.ndarray:
        """Public vectorized key -> hot slot map (-1 = not resident) —
        the slot tickets the trainer fast path gathers by.  A ticket is
        valid until the next residency change (``res_epoch``)."""
        with self._lock:
            return self._hot_slots(np.ascontiguousarray(keys, np.int64))

    @property
    def res_epoch(self) -> int:
        """Residency epoch: bumps on any promotion/demotion/eviction —
        slot tickets from an older epoch must be re-probed."""
        return self._res_epoch

    # -- fault prefetch pipeline ----------------------------------------------
    #
    # The dispatch/commit ticket pair: ``dispatch_prefetch(next_keys)``
    # (fire-and-forget) stages the NEXT batch's miss payloads — warm/cold
    # reads only, NO creates (the rng stream is consumed at pull time in
    # request order), NO admission, NO ledger touch — on a worker thread,
    # overlapping the copy with the current step's execution.  The
    # matching ``pull_batch`` commits: staged rows serve the fault path
    # without touching the slow tiers (counted ``tiered_fault_overlap_
    # rows_total``); anything not staged, staled by an interleaved write
    # (``tiered_fault_prefetch_stale_total``), or on a store with the
    # pipeline disabled falls back to the synchronous read — the bytes
    # that land are identical either way.

    def dispatch_prefetch(self, keys: np.ndarray) -> int:
        """Stage the miss payloads a future ``pull_batch(keys)`` will
        need.  Returns the dispatch ticket (0 = pipeline disabled or
        queue full — the pull simply reads synchronously).  Safe to call
        from any thread; never blocks on tier I/O."""
        if not self._prefetch_enabled or self._closed:
            return 0
        # the RAW id stream, exactly as the pull will receive it: the
        # plan precomputes the dedup (unique + inverse) too
        keys_arr = np.ascontiguousarray(keys, np.int64).reshape(-1).copy()
        if not len(keys_arr):
            return 0
        self._pf_ensure_thread()
        if self._pf_queue is None:
            return 0
        with self._pf_cond:
            self._pf_ticket += 1
            ticket = self._pf_ticket
        try:
            self._pf_queue.put_nowait((ticket, keys_arr, time.monotonic()))
        except Exception:
            # double-buffer full: this batch reads synchronously.  The
            # ticket completes immediately so prefetch_wait never hangs.
            with self._pf_cond:
                if ticket > self._pf_completed:
                    self._pf_completed = ticket
                self._pf_cond.notify_all()
            self._pf_iq.note_drop()
            return 0
        self._pf_iq.note_enqueue()
        self._pf_iq.set_depth(self._pf_queue.qsize())
        return ticket

    def prefetch_wait(self, ticket: Optional[int] = None,
                      timeout: float = 30.0) -> bool:
        """Block until dispatch ``ticket`` (default: the latest) has been
        staged or dropped — the deterministic handle tests and drain paths
        use; production callers never need it (commit falls back to the
        synchronous read)."""
        with self._pf_cond:
            want = self._pf_ticket if ticket is None else ticket
            return self._pf_cond.wait_for(
                lambda: self._pf_completed >= want, timeout=timeout
            )

    def _pf_ensure_thread(self) -> None:
        if self._pf_thread is not None and self._pf_thread.is_alive():
            return
        try:
            import queue as _queue

            # depth 2 = the double buffer: one stage in flight on the
            # worker, one queued behind it
            self._pf_queue = _queue.Queue(maxsize=2)
            t = threading.Thread(
                target=self._pf_worker, name="tiered-fault-prefetch",
                daemon=True,
            )
            t.start()
            self._pf_thread = t
        except Exception:
            _LOG.warning("fault prefetch worker failed to start; the "
                         "store stays on the synchronous fault path",
                         exc_info=True)
            self._prefetch_enabled = False
            self._pf_queue = None

    def _pf_worker(self) -> None:
        while True:
            item = self._pf_queue.get()
            if item is None:
                return
            ticket, keys_arr, t_enq = item
            self._pf_iq.note_wait(time.monotonic() - t_enq)
            self._pf_iq.set_depth(self._pf_queue.qsize())
            try:
                self._pf_stage_batch(keys_arr)
            except Exception:
                _LOG.warning("fault prefetch stage failed; batch will "
                             "read synchronously", exc_info=True)
            finally:
                with self._pf_cond:
                    if ticket > self._pf_completed:
                        self._pf_completed = ticket
                    self._pf_cond.notify_all()

    def _pf_stage_batch(self, keys_raw: np.ndarray) -> None:
        """Worker-side stage: run the commit pull's ENTIRE fault side —
        dedup, hot probe, ledger touch, admission, demotion write-back,
        fault-in, fault-cache install — ahead of the pull, behind the
        step.  Legal because pushes change neither the ledger nor
        residency: every admission input (and so every decision) is
        identical whether taken here or at the pull, and the updater
        math is identical on every path, so the trajectory cannot move
        (the overlap-vs-sync equivalence contract).  The ONE thing a
        dispatch must not do is consume the rng stream: a batch with
        unseen keys degrades to a plain payload stage (reads only), and
        its commit runs the normal path with the stage in front.

        On success the pull PLAN (dedup arrays + post-admission slot
        map + guard epochs) is recorded: the matching pull reduces to a
        guarded hot gather plus cache copies (:meth:`_commit_plan`).
        Holds the store lock throughout (tier mutation must not
        interleave a torn view); the foreground only contends here
        during its own store calls — which is the point: the stage
        overlaps the step's compute, not the store's protocol ops."""
        with self._lock:
            if self._closed:
                return
            uniq, inverse = np.unique(keys_raw, return_inverse=True)
            slots_u = self._hot_slots(uniq)
            hit = slots_u >= 0
            hs = slots_u[hit]
            miss = ~hit
            n_staged = 0
            if miss.any():
                served = self._serve_misses(
                    uniq[miss], hs, grads=None, speculative=True,
                )
                if served is None:
                    # unseen keys: degrade to the payload-only stage (no
                    # admission, no rng) — the commit pull runs the
                    # normal path with these reads in front
                    miss_keys = uniq[miss]
                    payload, origin, tickets = self._read_payload(
                        miss_keys)
                    self._pf_stage = (
                        miss_keys, payload, origin, tickets,
                        self._mut_epoch, np.ones(len(miss_keys), bool),
                    )
                    self._pf_plan = None
                    if obs_gate.enabled():
                        reg = self.registry
                        reg.inc("tiered_fault_prefetch_batches_total")
                        reg.inc("tiered_fault_prefetch_rows_total",
                                len(miss_keys))
                    return
                la = self._last_admitted
                if la is not None:
                    midx = np.flatnonzero(miss)
                    slots_u[midx[la[0]]] = la[1]
                n_staged = int(miss.sum())
            self._pf_plan = {
                "ids": keys_raw,
                "uniq": uniq,
                "inverse": inverse,
                "slots": slots_u,
                "prehit": hs,
                "res_epoch": self._res_epoch,
                "mut_epoch": self._mut_epoch,
                "cache_serial": self._cache_serial,
            }
            if obs_gate.enabled():
                reg = self.registry
                reg.inc("tiered_fault_prefetch_batches_total")
                if n_staged:
                    reg.inc("tiered_fault_prefetch_rows_total", n_staged)

    def _commit_plan(self, plan: dict,
                     keys_arr: np.ndarray) -> Optional[np.ndarray]:
        """The fast half of a planned pull: validate the guards (no
        interleaved mutation moved residency, the cache is still the
        dispatch's install, the request is byte-identical), then serve
        hot rows by gather and planned misses from the fault cache.
        Returns None on any guard failure — the caller falls through to
        the normal path, which is state-agnostic and therefore always
        correct.  Caller holds the lock."""
        if (plan["mut_epoch"] != self._mut_epoch
                or plan["res_epoch"] != self._res_epoch
                or plan["cache_serial"] != self._cache_serial
                or len(plan["ids"]) != len(keys_arr)
                or not bool(np.array_equal(plan["ids"], keys_arr))):
            return None
        uniq = plan["uniq"]
        slots_u = plan["slots"]
        hit = slots_u >= 0
        miss = ~hit
        # validate BEFORE mutating anything (a failed commit must leave
        # the store exactly as the normal path expects to find it)
        n_miss = int(miss.sum())
        if n_miss:
            fc = self._fault_cache
            if fc is None or fc[4] != self._mut_epoch or not len(fc[0]):
                return None
            ck = fc[0]
            pos = np.minimum(np.searchsorted(ck, uniq[miss]), len(ck) - 1)
            ok = (ck[pos] == uniq[miss]) & fc[5][pos]
            if not bool(ok.all()):
                return None
        rows_u = np.empty((len(uniq), self.dim), np.float32)
        hs = slots_u[hit]
        if len(hs):
            rows_u[hit] = self._hot_rows_of(hs)
        prehit = plan["prehit"]
        if len(prehit):
            # the pull-side resident bump, exactly the slots the sync
            # path would have counted (pre-admission hits)
            self._slot_freq[prehit] += 1.0
        if n_miss:
            rows_u[miss] = fc[1][pos][:, : self.dim]
            self._pf_overlap_rows += n_miss
        telem = obs_gate.enabled()
        if telem:
            reg = self.registry
            reg.inc("tiered_hot_hits_total", int(len(prehit)))
            reg.inc("tiered_pull_plan_commits_total")
            if n_miss:
                reg.inc("tiered_fault_overlap_rows_total", n_miss)
        self._slot_cache = (uniq, slots_u, self._res_epoch)
        return rows_u[plan["inverse"]]

    def _pf_invalidate(self, keys: np.ndarray) -> None:
        """Surgically drop staged entries for keys whose tier copy just
        changed (in-place bypass write-backs, demotion write-backs,
        pending-create flushes).  Caller holds the lock."""
        st = self._pf_stage
        if st is None or not len(keys):
            return
        sk, _, _, _, epoch, valid = st
        if epoch != self._mut_epoch:
            return  # wholesale-invalid already
        pos = np.minimum(np.searchsorted(sk, keys), len(sk) - 1)
        stale = (sk[pos] == keys) & valid[pos]
        if stale.any():
            valid[pos[stale]] = False
            if obs_gate.enabled():
                self.registry.inc("tiered_fault_prefetch_stale_total",
                                  int(stale.sum()))

    def _pf_consume(
        self, miss_keys: np.ndarray, payload: np.ndarray,
        origin: np.ndarray, cold_recs: np.ndarray,
        unfilled: np.ndarray,
    ) -> np.ndarray:
        """Fill ``unfilled`` miss rows from the prefetch stage (valid,
        epoch-current entries only).  Returns the still-unfilled mask.
        Caller holds the lock."""
        st = self._pf_stage
        if st is None or not unfilled.any():
            return unfilled
        sk, sp, so, sr, epoch, valid = st
        if epoch != self._mut_epoch or not len(sk):
            return unfilled
        pos = np.minimum(np.searchsorted(sk, miss_keys), len(sk) - 1)
        hit = (sk[pos] == miss_keys) & valid[pos] & unfilled
        if not hit.any():
            return unfilled
        hp = pos[hit]
        payload[hit] = sp[hp]
        origin[hit] = so[hp]
        cold_recs[hit] = sr[hp]
        self._stage_hits_last += int(hit.sum())
        return unfilled & ~hit

    # -- hot-tier bookkeeping -------------------------------------------------

    def _sync_freq_decay(self) -> None:
        """Mirror the ledger's decay onto the resident counts so admission
        keeps comparing like with like across aging epochs."""
        d = self.ledger.decays
        if d != self._ledger_decays_seen:
            self._slot_freq *= (
                self.ledger.decay_factor ** (d - self._ledger_decays_seen)
            )
            self._ledger_decays_seen = d

    def _hot_count(self) -> int:
        return self.hot_rows - self._n_free

    def _rebuild_hot_index(self) -> None:
        occ = np.flatnonzero(self._slot_keys >= 0)
        keys = self._slot_keys[occ]
        order = np.argsort(keys, kind="stable")
        self._hk = keys[order]
        self._hs = occ[order]

    def _hot_index_insert(self, keys: np.ndarray,
                          slots: np.ndarray) -> None:
        """Merge-insert SORTED new keys into the resident index — one
        searchsorted + two np.insert memcpys, no re-sort (residency
        changes are per-batch events; argsort-ing the whole hot set each
        time dominated the fault path)."""
        pos = self._hk.searchsorted(keys)
        self._hk = sorted_insert(self._hk, pos, keys)
        self._hs = sorted_insert(self._hs, pos, slots)

    def _hot_index_remove(self, keys: np.ndarray) -> None:
        """Drop keys (present, any order) from the resident index."""
        pos = self._hk.searchsorted(keys)
        self._hk = sorted_delete(self._hk, pos)
        self._hs = sorted_delete(self._hs, pos)

    def _hot_slots(self, keys_arr: np.ndarray) -> np.ndarray:
        """Vectorized key -> hot slot (-1 = not resident)."""
        out = np.full(len(keys_arr), -1, np.int64)
        nk = len(self._hk)
        if not nk or not len(keys_arr):
            return out
        pos = np.minimum(self._hk.searchsorted(keys_arr), nk - 1)
        hit = self._hk[pos] == keys_arr
        out[hit] = self._hs[pos[hit]]
        return out

    def _note_occupancy(self, force: bool = False) -> None:
        n = self._hot_count()
        if n > self.peak_hot_rows:
            self.peak_hot_rows = n
        # peak tracking is exact per call; the GAUGE writes are cadenced
        # (5 registry ops per fault batch showed up in the fault path)
        self._occupancy_skips += 1
        if not force and self._occupancy_skips < 16:
            return
        self._occupancy_skips = 0
        if obs_gate.enabled():
            reg = self.registry
            reg.gauge_set("tiered_hot_rows", n)
            reg.gauge_set("tiered_peak_hot_rows", self.peak_hot_rows)
            reg.gauge_set("tiered_warm_rows", len(self._warm))
            reg.gauge_set("tiered_cold_rows", self._cold.n_rows)
            reg.gauge_set(
                "tiered_bytes_resident",
                self.hot_rows * self.dim * 8
                + len(self._warm) * self.dim * 8,
            )
            total = self._pf_overlap_rows + self._pf_sync_rows
            reg.gauge_set(
                "tiered_fault_overlap_ratio",
                round(self._pf_overlap_rows / total, 5) if total else 0.0,
            )

    def _payload(self, slots: np.ndarray) -> np.ndarray:
        """[row || accum] block for hot slots — the tier-down wire and
        the ONE accessor demotion/snapshot/migration read authoritative
        hot rows through (device mode gathers from the pinned block)."""
        if self.device_hot:
            return np.concatenate(
                [self._dev_gather(self._devW, slots),
                 self._dev_gather(self._devA, slots)], axis=1,
            )
        return np.concatenate([self._W[slots], self._acc[slots]], axis=1)

    def _hot_rows_of(self, slots: np.ndarray) -> np.ndarray:
        """[n, dim] ROWS half for hot slots (the pull path's gather)."""
        if self.device_hot:
            return self._dev_gather(self._devW, slots)
        return self._W[slots]

    def _hot_land(self, slots: np.ndarray, payload: np.ndarray,
                  rows: Optional[np.ndarray] = None,
                  accums: Optional[np.ndarray] = None) -> None:
        """Scatter [row ‖ accum] payloads (or a rows/accums pair) into hot
        slots — admission landing and hot-branch preloads."""
        if payload is None:
            payload = np.concatenate(
                [np.asarray(rows, np.float32),
                 np.asarray(accums, np.float32)], axis=1,
            )
        if self.device_hot:
            if not len(slots):
                return
            scatter = self._dev_fns()["scatter"]
            sp, pp = self._pad_scatter(slots, payload)
            s32 = self._dev_slots(sp)
            pd = torch.from_numpy(pp).to(self.device)
            rows_d = pd[:, : self.dim].contiguous()
            # specs captured before the call — the block is written in place
            obs_device.offer("tiered_dev_scatter", scatter,
                             (self._devW, s32, rows_d))
            self._devW = scatter(self._devW, s32, rows_d)
            self._devA = scatter(
                self._devA, s32, pd[:, self.dim:].contiguous())
            return
        self._W[slots] = payload[:, : self.dim]
        self._acc[slots] = payload[:, self.dim:]

    def _warm_probe(
        self, keys_arr: np.ndarray, refs: bool = False,
        out: Optional[np.ndarray] = None,
    ):
        """(payload rows, found mask[, row tickets]) from the warm
        segment for int64 keys, the eviction dead-set masked out.  ONE
        vectorized probe — warm membership never walks a per-key host
        structure on the fault path (the host dict is only the
        enumeration index).  With ``refs``, the third element is the
        per-key row ticket (None when the backend has no ticket
        support) and ``out`` (if given) receives found rows in place."""
        ws = self._warm_store
        if ws is None or not self._warm:
            empty = np.zeros(len(keys_arr), bool)
            return (None, empty, None) if refs else (None, empty)
        wrecs = None
        if refs and self._warm_refs_ok:
            rows, found, wrecs = ws.get_batch_refs(
                keys_arr.view(np.uint64), out=out)
        else:
            rows, found = ws.get_batch(keys_arr.view(np.uint64))
        if self._warm_dead and found.any():
            dead = np.isin(keys_arr, np.fromiter(
                self._warm_dead, np.int64, count=len(self._warm_dead)
            ))
            found &= ~dead
        return (rows, found, wrecs) if refs else (rows, found)

    def _note_warm(self, keys_list) -> None:
        """Record keys as warm-resident (host enumeration index +
        resurrect-from-dead bookkeeping)."""
        self._warm.update(dict.fromkeys(keys_list, True))
        if self._warm_dead:
            self._warm_dead.difference_update(keys_list)

    def _warm_has_room(self, n_new: int) -> bool:
        ws = self._warm_store
        if ws is None:
            return False
        # ShmKV slots are never reclaimed (open addressing without
        # deletion), so route to cold once the segment is nearly full —
        # a full table would make every set O(capacity)
        return ws.used + n_new <= int(self.warm_rows * 0.9)

    # -- tier movement --------------------------------------------------------

    def _demote(self, victim_slots: np.ndarray) -> None:
        """Write victims tier-down (dirty rows and rows with no lower copy
        write BEFORE the slot is reused — the no-lost-push ordering), then
        free their slots.  Caller holds the lock and rebuilds the hot
        index afterwards."""
        keys = self._slot_keys[victim_slots]
        self._hot_index_remove(keys)
        need_write = self._dirty[victim_slots] | (
            self._lower[victim_slots] == 0
        )
        telem = obs_gate.enabled()
        n_warm = n_cold = 0
        if need_write.any():
            w_slots = victim_slots[need_write]
            w_keys = keys[need_write]
            payload = self._payload(w_slots)
            _, in_warm = self._warm_probe(w_keys)
            to_warm = in_warm.copy()
            n_new = int((~in_warm).sum())
            if n_new and self._warm_has_room(n_new):
                to_warm[:] = True
            if to_warm.any() and self._warm_store is not None:
                try:
                    self._warm_store.set_batch(
                        w_keys[to_warm].view(np.uint64), payload[to_warm]
                    )
                    self._note_warm(w_keys[to_warm].tolist())
                    n_warm = int(to_warm.sum())
                except RuntimeError:
                    # segment filled under us: retry the guaranteed
                    # capacity-free updates (keys ALREADY warm), route
                    # the rest cold — a raise must not lose write-backs
                    to_warm[:] = False
                    n_warm = 0
                    if in_warm.any():
                        try:
                            self._warm_store.set_batch(
                                w_keys[in_warm].view(np.uint64),
                                payload[in_warm],
                            )
                            to_warm[:] = in_warm
                            n_warm = int(in_warm.sum())
                        except RuntimeError:
                            pass  # cold takes them all
            to_cold = ~to_warm
            if to_cold.any():
                self._cold.set_batch(w_keys[to_cold], payload[to_cold])
                n_cold = int(to_cold.sum())
                # a cold write supersedes any stale warm copy: keys sent
                # cold while warm-resident would otherwise read back the
                # OLD warm row (warm precedes cold on the read path), so
                # they leave the host index AND join the dead-set (the
                # segment itself cannot delete)
                for k in w_keys[to_cold].tolist():
                    if self._warm.pop(k, None):
                        self._warm_dead.add(k)
            # staged copies of written-back rows are stale (pre-demotion
            # tier bytes): surgically drop them from the prefetch stage,
            # exactly like the fault-cache entries below
            self._pf_invalidate(w_keys)
        n_clean = int(len(victim_slots) - need_write.sum())
        # free the slots only AFTER the write-back landed
        self._slot_keys[victim_slots] = -1
        self._dirty[victim_slots] = False
        self._lower[victim_slots] = 0
        self._slot_freq[victim_slots] = 0.0
        self._free[self._n_free:self._n_free + len(victim_slots)] = \
            victim_slots
        self._n_free += len(victim_slots)
        self._res_epoch += 1
        self._flow_demotions += int(len(victim_slots))
        # a demoted key may sit in the fault cache with its pre-admission
        # payload (it was a miss once): the write-back above just made
        # that copy stale — surgically drop THOSE entries (victim batches
        # are tiny; killing the whole cache would forfeit every reuse in
        # admission-churny phases)
        fc = self._fault_cache
        if fc is not None and fc[4] == self._mut_epoch and len(fc[0]):
            ck, valid = fc[0], fc[5]
            pos = np.minimum(np.searchsorted(ck, keys), len(ck) - 1)
            stale = ck[pos] == keys
            if stale.any():
                valid[pos[stale]] = False
        if telem:
            reg = self.registry
            if n_warm:
                reg.inc(labeled("tiered_demotions_total", to="warm"), n_warm)
            if n_cold:
                reg.inc(labeled("tiered_demotions_total", to="cold"), n_cold)
            if n_clean:
                reg.inc(labeled("tiered_demotions_total", to="none"),
                        n_clean)
                reg.inc("tiered_clean_demotions_total", n_clean)
            if n_warm or n_cold:
                reg.inc("tiered_writeback_rows_total", n_warm + n_cold)
        self._maybe_compact_cold()

    def _maybe_compact_cold(self) -> None:
        c = self._cold
        if c.n_records > max(4096,
                             self._cold_compact_factor * max(1, c.n_rows)):
            # NOTE: cached cold tickets go stale here, but that is safe —
            # update_records validates them and the write falls back to
            # the probing path — so the fault cache itself survives
            c.compact()
            if obs_gate.enabled():
                self.registry.inc("tiered_cold_compactions_total")

    def _read_payload(
        self, miss_keys: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(payload [n, 2*dim], origin int8, tier tickets) for
        non-resident keys: origin 0 = unseen (caller creates), 1 = warm,
        2 = cold.  A ticket is the row's address WITHIN its origin tier
        (warm row index or cold record index, -1 = none): a bypass
        write-back scatters straight to it, skipping the tier's own key
        probe.  Caller holds the lock."""
        n_miss = len(miss_keys)
        # empty, not zeros: every row is either scatter-filled from its
        # tier below or created by _create_rows (which zeroes the fresh
        # row's accumulator half) — zero-filling ~0.5 MB per fault batch
        # was pure memset on the hot path
        payload = np.empty((n_miss, 2 * self.dim), np.float32)
        origin = np.zeros(n_miss, np.int8)
        tickets = np.full(n_miss, -1, np.int64)
        wrows, in_warm, wrecs = self._warm_probe(miss_keys, refs=True,
                                                 out=payload)
        if in_warm.any():
            if wrows is not payload:
                payload[in_warm] = wrows[in_warm]
            origin[in_warm] = 1
            if wrecs is not None:
                tickets[in_warm] = wrecs[in_warm]
        rest = ~in_warm
        if rest.any():
            crows, cfound, crecs = self._cold.get_batch_refs(
                miss_keys[rest])
            rest_idx = np.flatnonzero(rest)
            payload[rest_idx[cfound]] = crows[cfound]
            origin[rest_idx[cfound]] = 2
            tickets[rest_idx] = crecs
        return payload, origin, tickets

    def _read_payload_staged(
        self, miss_keys: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """:meth:`_read_payload` with the prefetch stage in front: rows
        the dispatch ticket already staged (and no interleaved write has
        staled) serve without touching the slow tiers — the commit half
        of the fault pipeline.  Caller holds the lock."""
        st = self._pf_stage
        if st is None or st[4] != self._mut_epoch:
            return self._read_payload(miss_keys)
        n = len(miss_keys)
        payload = np.empty((n, 2 * self.dim), np.float32)
        origin = np.zeros(n, np.int8)
        recs = np.full(n, -1, np.int64)
        unfilled = self._pf_consume(
            miss_keys, payload, origin, recs, np.ones(n, bool)
        )
        if unfilled.all():
            return self._read_payload(miss_keys)
        if unfilled.any():
            p2, o2, r2 = self._read_payload(miss_keys[unfilled])
            payload[unfilled] = p2
            origin[unfilled] = o2
            recs[unfilled] = r2
        return payload, origin, recs

    def _read_payload_cached(
        self, miss_keys: np.ndarray, alias_ok: bool = False
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """:meth:`_read_payload` with the fault-batch cache in front: keys
        the LAST miss batch read (and persisted) come straight from the
        cached copy — in the pull -> compute -> push cycle that is every
        push's whole miss set.  With ``alias_ok`` (the push path) and a
        full exact-cover cache, the CACHE ARRAYS THEMSELVES are returned
        — zero copies out, and the updater's in-place application IS the
        cache write-through, so the scatter-back is skipped too.  The
        prefetch stage sits behind the cache (:meth:`_read_payload_staged`)
        so a dispatched batch's rows commit without slow-tier reads.
        Caller holds the lock."""
        self._cache_hits_last = 0
        self._cache_hits_speculative = 0
        self._stage_hits_last = 0
        self._cache_hit_info = None
        self._cache_alias = False
        fc = self._fault_cache
        if fc is None or fc[4] != self._mut_epoch or not len(fc[0]):
            return self._read_payload_staged(miss_keys)
        if not alias_ok and not self._cache_pending \
                and not self._cache_speculative:
            # CLEAN cache on the pull side: every cached row equals its
            # tier copy bit-for-bit (pushes write through), so re-reading
            # a hit costs the same as serving it — and consecutive miss
            # sets barely overlap on skewed streams (hot keys are hot-
            # RESIDENT; misses are churny mid/tail keys — the probe found
            # ~15 hits per 2000-row batch at zipf 0.8).  Skip the probe.
            # Only a PENDING create (exists nowhere but the cache) forces
            # it — re-reading one from a tier would re-draw its rng row
            return self._read_payload_staged(miss_keys)
        ck, cp, co, cr, _, valid = fc
        if alias_ok and len(ck) == len(miss_keys) and \
                bool(valid.all()) and \
                bool(np.array_equal(ck, miss_keys)):
            self._cache_hits_last = len(miss_keys)
            if self._cache_speculative:
                self._cache_hits_speculative = len(miss_keys)
            self._cache_alias = True
            return cp, co, cr
        pos = np.searchsorted(ck, miss_keys)
        pos_c = np.minimum(pos, len(ck) - 1)
        hit = (ck[pos_c] == miss_keys) & valid[pos_c]
        if not hit.any():
            return self._read_payload_staged(miss_keys)
        self._cache_hits_last = int(hit.sum())
        if self._cache_speculative:
            self._cache_hits_speculative = self._cache_hits_last
        self._cache_hit_info = (hit, pos_c[hit])
        n = len(miss_keys)
        # empty: hit rows gather from the cache, the rest scatter in
        # from _read_payload — every row is written exactly once
        payload = np.empty((n, 2 * self.dim), np.float32)
        origin = np.zeros(n, np.int8)
        cold_recs = np.full(n, -1, np.int64)
        hp = pos_c[hit]
        payload[hit] = cp[hp]
        origin[hit] = co[hp]
        cold_recs[hit] = cr[hp]
        rest = ~hit
        if rest.any():
            p2, o2, c2 = self._read_payload_staged(miss_keys[rest])
            payload[rest] = p2
            origin[rest] = o2
            cold_recs[rest] = c2
        return payload, origin, cold_recs

    def _create_rows(self, payload: np.ndarray, new: np.ndarray,
                     create_order: Optional[np.ndarray]) -> int:
        """First-touch creation into ``payload`` rows flagged ``new`` —
        the SAME rng stream consumption ORDER as ``AsyncParamServer``
        (first occurrence in the request batch), so seeded flat/tiered
        trajectories match whether a created row lands hot or cold.
        ``create_order``: first-occurrence rank per miss row (None = the
        payload order already is the request order, the push case)."""
        m = int(new.sum())
        if not m:
            return 0
        rows = (
            self._rng.standard_normal((m, self.dim))
            * np.sqrt(1.0 / self.dim)
        ).astype(np.float32)
        new_idx = np.flatnonzero(new)
        if create_order is not None:
            new_idx = new_idx[np.argsort(create_order[new_idx],
                                         kind="stable")]
        payload[new_idx, : self.dim] = rows
        # the payload buffer is np.empty: a fresh row's accumulator half
        # must start at zero explicitly
        payload[new_idx, self.dim:] = 0.0
        self._total_keys += m
        return m

    #: ``origin`` code for a created row whose first persist is DEFERRED
    #: to its matching push (or to a cache flush): it exists only in the
    #: fault cache.  Distinct from 0 ("unseen") so a later read of the
    #: cached entry does not re-create it (a second rng draw would break
    #: flat-store parity).
    _ORIGIN_PENDING = 3

    #: a miss displaces a resident only when its count beats the
    #: resident's by this factor — hysteresis against equal-frequency
    #: ping-pong (every pointless swap costs a demotion write-back) and
    #: against the sketch's upper-bound bias admitting one-hit wonders.
    #: 2.0 measured best across zipf {0.8, 1.1} at 1/16 residency with
    #: the ticketed write-back path: looser margins (1.2-1.5) paid more
    #: demotion churn than the extra hits earned, tighter (2.5-3.0) was
    #: a wash (tools/tiered_bench.py sweep)
    ADMIT_MARGIN = 2.0

    def _admit_plan(
        self, miss_keys: np.ndarray, mf: np.ndarray, pin_slots: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """TinyLFU admission for one batch's misses (``mf``: their ledger
        counts): free slots go to the highest-frequency candidates; past
        that, a candidate enters only by beating the coldest non-pinned
        resident by :data:`ADMIT_MARGIN` (who then demotes).
        Deterministic (ties break on key).  Returns (admit mask over
        misses, victim slots to demote)."""
        n = len(miss_keys)
        admit = np.zeros(n, bool)
        f = self._n_free
        if f:
            order = np.lexsort((miss_keys, -mf))  # freq desc, key asc
            admit[order[:f]] = True
            rest = order[f:]
        else:
            rest = None  # sort lazily — most full-tier batches swap nothing
        none = np.zeros(0, np.int64)
        if rest is not None and not rest.size:
            return admit, none
        # pinned residents (touched by THIS batch) never demote
        pin_mask = np.zeros(self.hot_rows, bool)
        pin_mask[pin_slots] = True
        occ = np.flatnonzero((self._slot_keys >= 0) & ~pin_mask)
        if not occ.size:
            return admit, none
        vf = self._slot_freq[occ]
        # steady-state fast path: no candidate clears the bar -> no sorts
        bar = float(vf.min()) * self.ADMIT_MARGIN
        if float(mf.max(initial=0.0)) <= bar:
            return admit, none
        if rest is None:
            # only misses above the coldest resident's bar can possibly
            # admit (victims are compared coldest-first): sort just those
            # — the whole-batch lexsort dominated steady-state admission
            cand = np.flatnonzero(mf > bar)
            rest = cand[np.lexsort((miss_keys[cand], -mf[cand]))]
        m = min(len(rest), len(occ))
        # only the m coldest residents can possibly demote: partial-select
        # them instead of sorting the whole resident set
        if m < len(occ):
            part = np.argpartition(vf, m)[:m + 1]
            vsel = part[np.lexsort((self._slot_keys[occ[part]], vf[part]))]
        else:
            vsel = np.lexsort((self._slot_keys[occ], vf))
        beats = mf[rest[:m]] > vf[vsel[:m]] * self.ADMIT_MARGIN
        k = int(m if beats.all() else np.argmin(beats))
        if not k:
            return admit, none
        admit[rest[:k]] = True
        return admit, occ[vsel[:k]]

    def _fault_in(self, keys: np.ndarray, payload: np.ndarray,
                  origin: np.ndarray, freqs: np.ndarray,
                  dirty: bool) -> np.ndarray:
        """Land admitted rows in hot slots (caller already made room and
        holds the lock; caller rebuilds the index).  Returns the slots."""
        n = len(keys)
        # pop n slots off the stack (reversed slice = the same slot order
        # sequential pops produced, so admission stays bit-deterministic)
        slots = self._free[self._n_free - n:self._n_free][::-1].copy()
        self._n_free -= n
        self._hot_land(slots, payload)
        self._slot_keys[slots] = keys
        self._slot_freq[slots] = freqs
        # a created row (fresh, or pending in the fault cache) exists
        # nowhere below: dirty until persisted
        self._dirty[slots] = dirty | (origin == 0) | \
            (origin == self._ORIGIN_PENDING)
        self._lower[slots] = np.where(origin <= 2, origin, 0)
        self._hot_index_insert(keys, slots)
        self._res_epoch += 1
        self._flow_promotions += n
        return slots

    def _serve_misses(
        self, miss_keys: np.ndarray, pin_slots: np.ndarray,
        grads: Optional[np.ndarray],
        create_order: Optional[np.ndarray] = None,
        admit: bool = True,
        speculative: bool = False,
    ) -> Optional[np.ndarray]:
        """The fault path shared by pull and push: read missed rows from
        their tier, create unseen keys (rng order = first occurrence in
        the request), admit winners into hot (demoting losers), and serve
        the rest IN PLACE — pulls just read them; pushes (``grads``
        given) apply the updater out-of-place and write the result
        straight back to the row's tier.  Returns the [n_miss, dim] row
        block (post-update when pushing).  Caller holds the lock.

        Admission is a PULL-side decision (``admit=False`` on the push
        path): the pull is where a row is about to feed the device, and
        its push mirrors the same key set moments later — re-judging
        there would double-count every training cycle's touch and pay
        the ledger+admission machinery twice per step.

        Only MISSES touch the shared ledger: resident keys count exactly
        in ``_slot_freq``, so a sketch count reads as "touches while
        outside the hot tier" — the doorkeeper quantity TinyLFU admission
        actually compares.

        ``speculative`` is the DISPATCH half of the fault pipeline: the
        worker runs this whole path (reads, ledger touch, admission,
        demotion, fault-in, cache install) for a batch that has not been
        pulled yet — legal because pushes touch neither the ledger nor
        residency, so every admission input is frozen between the
        dispatch and its commit pull.  The one thing it must NOT do is
        consume the rng stream: any unseen key bails out (returns None,
        NO state mutated) and the caller stages plain payloads instead."""
        telem = obs_gate.enabled()
        t0 = time.perf_counter() if telem else 0.0
        payload, origin, cold_recs = self._read_payload_cached(
            miss_keys, alias_ok=grads is not None and not admit)
        # tier-residency fault counts, BEFORE creates get re-labeled with
        # the tier that takes them
        n_warm_f = int((origin == 1).sum())
        n_cold_f = int((origin == 2).sum())
        new = origin == 0
        if speculative and new.any():
            # an unseen key's creation order is the PULL's contract —
            # abort before any mutation (reads mutated nothing)
            return None
        if admit:
            mf = self.ledger.touch_and_get(miss_keys)
            self._sync_freq_decay()
        n_created = self._create_rows(payload, new, create_order)
        if grads is not None:
            self._apply_payload(payload, grads)
        self._last_admitted = None
        if admit:
            admitted, victims = self._admit_plan(miss_keys, mf, pin_slots)
            if victims.size:
                self._demote(victims)
            if admitted.any():
                aslots = self._fault_in(
                    miss_keys[admitted], payload[admitted],
                    origin[admitted], mf[admitted],
                    dirty=grads is not None,
                )
                self._last_admitted = (admitted, aslots)
        else:
            admitted = np.zeros(len(miss_keys), bool)
        bypass = ~admitted
        n_bypass = int(bypass.sum())
        if n_bypass:
            bidx = np.flatnonzero(bypass)
            if grads is not None:
                # write-back: the push must land SOMEWHERE before it is
                # acknowledged — in place in the row's own tier.  The
                # aliased/all-bypass case passes the arrays straight
                # through (all-True mask copies were ~256KB of memcpy)
                if n_bypass == len(miss_keys):
                    b_keys, b_pay = miss_keys, payload
                    b_org, b_tix = origin, cold_recs
                else:
                    b_keys, b_pay = miss_keys[bypass], payload[bypass]
                    b_org, b_tix = origin[bypass], cold_recs[bypass]
                rest_mask, rest_tier, rest_recs = self._write_in_place(
                    b_keys, b_pay, b_org, b_tix)
                # staged copies of rows this push just rewrote are stale
                self._pf_invalidate(b_keys)
                if rest_tier:
                    ridx = bidx[rest_mask]
                    origin[ridx] = rest_tier
                    if rest_recs is not None:
                        cold_recs[ridx] = rest_recs
            else:
                # created-but-rejected rows consumed the rng stream but
                # persist LAZILY: they ride the fault cache as PENDING
                # and land tier-side post-update on the matching push —
                # one write instead of an append now plus an update
                # moments later.  Any path that would orphan them
                # (_flush_cache_writes) persists the cached copy.
                b_new = new[bypass]
                if b_new.any():
                    origin[bidx[b_new]] = self._ORIGIN_PENDING
        # cache this batch's read (post-update; persisted — or PENDING —
        # rows match what their tier holds/will hold) for the next serve
        if admit:
            # pendings carried into the next cache (probe hits) may stay
            # pending; dropped ones persist now or never
            keep = None if self._cache_hit_info is None \
                else self._cache_hit_info[1]
            self._flush_cache_writes(keep=keep)
            # INVARIANT: a valid cache entry's key is never hot-resident
            # — rows admitted THIS pull enter the cache pre-invalidated
            # (their newest copy lives in hot; demotion owns the write-
            # back), and admission only ever picks from the current miss
            # set, so no later event can make a valid entry's key hot.
            # The flush relies on this: no per-row hot probe needed.
            # The pull path's miss keys are a subset of a sorted unique
            # cover — already ordered, no sort needed.
            self._cache_serial += 1
            if create_order is None and len(miss_keys) > 1 and \
                    not bool(np.all(miss_keys[1:] > miss_keys[:-1])):
                order = np.argsort(miss_keys, kind="stable")
                self._fault_cache = (
                    miss_keys[order], payload[order], origin[order],
                    cold_recs[order], self._mut_epoch, ~admitted[order],
                )
            else:
                self._fault_cache = (
                    miss_keys, payload, origin, cold_recs,
                    self._mut_epoch, ~admitted,
                )
            self._cache_speculative = speculative
            self._cache_pending = bool(
                (origin == self._ORIGIN_PENDING).any()
            )
            # the stage is one-shot: whatever this pull did not consume
            # is for a batch that will never commit it (the next dispatch
            # replaces it) — absences especially must not outlive the
            # writes that could create them
            self._pf_stage = None
        elif self._cache_alias:
            # aliased push: the updater ran in place on the cache arrays
            # and the write-back just landed — refresh the pending flag
            # (pendings the push persisted left PENDING-state via
            # _write_in_place's rest branch updating fc[2] in place)
            if self._cache_pending:
                fc = self._fault_cache
                self._cache_pending = bool(
                    ((fc[2] == self._ORIGIN_PENDING) & fc[5]).any()
                )
        elif self._cache_hit_info is not None:
            # push path: the cache keeps the PULL's key set — scatter the
            # post-update rows (and any fresh tier tickets) back into it
            # in place so it stays exact
            hit, hp = self._cache_hit_info
            fc = self._fault_cache
            fc[1][hp] = payload[hit]
            fc[2][hp] = origin[hit]
            fc[3][hp] = cold_recs[hit]
            if self._cache_pending:
                self._cache_pending = bool(
                    ((fc[2] == self._ORIGIN_PENDING) & fc[5]).any()
                )
        # pipeline honesty: fault rows served from the dispatch stage vs
        # read in-line (the overlap ratio the bench's fault_overlap column
        # and the ``tiered_fault_overlap_ratio`` gauge report).  A
        # speculative (dispatch-side) serve counts NOTHING here: its tier
        # reads are off the critical path by construction, and the commit
        # records them as overlap rows when it serves them.
        n_overlap = 0 if speculative else (
            self._stage_hits_last + self._cache_hits_speculative
        )
        n_sync = 0 if speculative else max(
            0, len(miss_keys) - self._cache_hits_last - self._stage_hits_last
        )
        self._pf_overlap_rows += n_overlap
        self._pf_sync_rows += n_sync
        if telem:
            reg = self.registry
            if n_overlap:
                reg.inc("tiered_fault_overlap_rows_total", n_overlap)
            if n_sync:
                reg.inc("tiered_fault_sync_rows_total", n_sync)
            if self._cache_hits_last:
                reg.inc("tiered_fault_cache_hits_total",
                        self._cache_hits_last)
            if n_warm_f:
                reg.inc("tiered_warm_faults_total", n_warm_f)
            if n_cold_f:
                reg.inc("tiered_cold_faults_total", n_cold_f)
            if n_created:
                reg.inc("tiered_creates_total", n_created)
            n_admitted = int(admitted.sum())
            if n_admitted:
                reg.inc("tiered_promotions_total", n_admitted)
            if n_bypass:
                if admit:
                    reg.inc("tiered_admission_rejects_total", n_bypass)
                reg.inc("tiered_bypass_rows_total", n_bypass)
            reg.observe("tiered_fault_seconds", time.perf_counter() - t0)
        self._flow_bypass += n_bypass
        self._note_occupancy()
        return payload[:, : self.dim]

    def _persist_new(
        self, keys: np.ndarray, payload: np.ndarray
    ) -> Tuple[int, Optional[np.ndarray]]:
        """First landing spot for rows that exist NOWHERE below the hot
        tier (admission-rejected creates): warm while it has room — the
        recency-biased early misses are disproportionately hot keys, and
        a warm landing makes their later faults cheap — spilling to the
        cold log once the segment fills.  Returns (origin code of the
        tier that took them — 1 warm, 2 cold — and their tier tickets
        so the matching push updates in place instead of re-probing).
        Caller holds the lock."""
        if self._warm_has_room(len(keys)):
            try:
                if self._warm_refs_ok:
                    recs = self._warm_store.set_batch_refs(
                        keys.view(np.uint64), payload
                    )
                else:
                    self._warm_store.set_batch(
                        keys.view(np.uint64), payload
                    )
                    recs = None
                self._note_warm(keys.tolist())
                return 1, recs
            except RuntimeError:
                pass  # filled under us: fall through to cold
        self._maybe_compact_cold()  # compact BEFORE: tickets stay valid
        recs = self._cold.set_batch_refs(keys, payload)
        return 2, recs

    def _flush_cache_writes(
        self, keep: Optional[np.ndarray] = None
    ) -> None:
        """Persist created rows still PENDING in the fault cache (they
        consumed the rng stream but were never pushed — they exist
        nowhere else).  Called before the cache is replaced (``keep`` =
        positions carried into the next cache, which may stay pending),
        before any wholesale invalidation or whole-store enumeration/
        read-through, and at close — a created row can never be silently
        lost.  Rows admitted into hot while cached need no skip-probe:
        a valid entry's key is never hot-resident (the cache-
        construction invariant — admitted rows enter pre-invalidated).
        Caller holds the lock."""
        if not self._cache_pending:
            return
        fc = self._fault_cache
        if fc is None or fc[4] != self._mut_epoch:
            # wholesale invalidation paths flush BEFORE bumping the
            # epoch, so a stale cache cannot hold unpersisted creates
            self._cache_pending = False
            return
        ck, cp, co, cr, _, valid = fc
        need = (co == self._ORIGIN_PENDING) & valid
        if keep is not None and need.any():
            need[keep] = False
        if need.any():
            nidx = np.flatnonzero(need)
            tier, recs = self._persist_new(ck[nidx], cp[nidx])
            co[nidx] = tier
            if recs is not None:
                cr[nidx] = recs
            # a staged ABSENCE for a key that just landed tier-side would
            # re-create it at commit (a second rng draw): drop it
            self._pf_invalidate(ck[nidx])
        if keep is None:
            self._cache_pending = False

    def _write_in_place(
        self, keys: np.ndarray, payload: np.ndarray, origin: np.ndarray,
        tickets: np.ndarray,
    ) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
        """Persist updated [row || accum] payloads back to their own tier
        (warm and cold rows scatter to their TICKET — no second key
        probe; fresh creates append).  Returns (mask of rows persisted
        via :meth:`_persist_new`, their origin code, their tickets)."""
        to_warm = origin == 1
        if to_warm.any():
            wt = tickets[to_warm]
            done = False
            if self._warm_refs_ok and bool((wt >= 0).all()):
                try:
                    self._warm_store.update_rows(
                        wt, keys[to_warm].view(np.uint64),
                        payload[to_warm],
                    )
                    done = True
                except ValueError:
                    pass  # stale tickets: the key-probing path below
            if not done:
                self._warm_store.set_batch(
                    keys[to_warm].view(np.uint64), payload[to_warm]
                )
        ticketed = (tickets >= 0) & (origin == 2)
        if ticketed.any():
            try:
                self._cold.update_records(
                    tickets[ticketed], keys[ticketed], payload[ticketed]
                )
            except ValueError:
                # a demotion-triggered compact moved the records between
                # read and write: the probing path still lands them
                self._cold.set_batch(keys[ticketed], payload[ticketed])
        rest = ~to_warm & ~ticketed
        rest_tier = 0
        rest_recs = None
        if rest.any():
            rest_tier, rest_recs = self._persist_new(
                keys[rest], payload[rest])
        return rest, rest_tier, rest_recs

    # -- updater math (identical expressions to the flat store) ---------------

    def _apply_slots(self, slots: np.ndarray, g: np.ndarray) -> None:
        """One vectorized updater step over unique hot slots — the same
        math (and, for large adagrad batches, the same fused native
        kernel) as ``AsyncParamServer._apply``, so flat/tiered
        trajectories agree bit-for-bit in both regimes.  Device mode runs
        the expression-identical ops on the pinned pair, each correctly
        rounded, and scatters the result in place — the push never
        materializes hot rows on the host."""
        if self.device_hot:
            if not len(slots):
                return
            fns = self._dev_fns()
            gather, scatter = fns["gather"], fns["scatter"]
            # padded lanes duplicate the last (slot, g) pair: they
            # compute bit-identical update values, so their repeated
            # set-writes are harmless and every shape below lands on
            # the bounded pow2 ladder
            sp, gp = self._pad_scatter(
                slots, np.asarray(g, np.float32).reshape(len(slots), -1))
            g_dev = torch.from_numpy(gp).to(self.device)
            s32 = self._dev_slots(sp)
            lr = torch.tensor(self.lr, dtype=torch.float32,
                              device=self.device)
            if self.updater == "sgd":
                w = gather(self._devW, s32) - lr * g_dev
                self._devW = scatter(self._devW, s32, w)
            else:
                eps = torch.tensor(self.eps, dtype=torch.float32,
                                   device=self.device)
                acc = gather(self._devA, s32) + g_dev * g_dev
                w = gather(self._devW, s32) - lr * g_dev / sqrt_rn(acc + eps)
                self._devA = scatter(self._devA, s32, acc)
                self._devW = scatter(self._devW, s32, w)
            return
        if self.updater == "sgd":
            self._W[slots] -= self.lr * g
        else:  # adagrad
            if len(slots) >= 4096 and bindings.available():
                bindings.rows_adagrad_native(
                    self._W, self._acc, slots, g, self.lr, self.eps
                )
            else:
                acc = self._acc[slots] + g * g
                self._acc[slots] = acc
                self._W[slots] -= self.lr * g / np.sqrt(acc + self.eps)

    def _apply_payload(self, payload: np.ndarray, g: np.ndarray) -> None:
        """The same updater step applied out-of-place to a [n, 2*dim]
        payload block (rows || accums) — the bypass path's math, float-op
        identical to the slot form."""
        rows = payload[:, : self.dim]
        accs = payload[:, self.dim:]
        if self.updater == "sgd":
            rows -= self.lr * g
        else:
            accs += g * g
            rows -= self.lr * g / np.sqrt(accs + self.eps)

    @staticmethod
    def _first_occurrence_unique(keys_arr: np.ndarray) -> np.ndarray:
        uniq, first = np.unique(keys_arr, return_index=True)
        return uniq[np.argsort(first)]

    # -- protocol -------------------------------------------------------------

    def pull_batch(
        self,
        keys: np.ndarray,
        worker_epoch: int,
        worker_id: Optional[int] = None,
        create: bool = True,
    ) -> Optional[np.ndarray]:
        """Vectorized pull: ``[n, dim]`` rows in ``keys`` order, or None
        when SSP-withheld/unrouted.  ``create=True`` (training traffic)
        lazily creates unseen keys and routes every touched row through
        the admission policy; ``create=False`` (the serving plane's
        read-only pulls) reads rows from WHEREVER they reside — no
        promotion, no creation: query traffic can neither grow the store
        nor thrash the training residency."""
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

    def _pull_batch(self, keys, worker_epoch, worker_id, create):
        with self._lock:
            if not self._pull_gate(worker_epoch, worker_id):
                return None
            keys_arr = np.ascontiguousarray(keys, np.int64)
            if not len(keys_arr):
                return np.zeros((0, self.dim), np.float32)
            if not create:
                # read-through sees only the tiers: pending creates must
                # land first or a serving pull would miss rows that exist
                self._flush_cache_writes()
                uniq, inverse = np.unique(keys_arr, return_inverse=True)
                rows, _, _ = self._read_values(uniq)
                return rows[inverse]
            # planned pull: a matching dispatch already ran the whole
            # fault side (dedup, ledger, admission, demotion, fault-in)
            # behind the previous step — commit is a guarded gather
            plan = self._pf_plan
            if plan is not None:
                self._pf_plan = None  # one-shot, consumed or wasted
                out = self._commit_plan(plan, keys_arr)
                if out is not None:
                    return out
                if obs_gate.enabled():
                    self.registry.inc("tiered_pull_plan_fallbacks_total")
            # ONE dedup up front: every downstream pass (index probe, hot
            # gather, ledger touch, fault reads) runs at unique width, and
            # the sorted cover + its post-admission slot map are cached
            # for the matching push — the trainer pushes exactly
            # np.unique(ids), so that push skips its own index probe AND
            # the duplicate-key sort.
            uniq, inverse = np.unique(keys_arr, return_inverse=True)
            slots_u = self._hot_slots(uniq)
            hit = slots_u >= 0
            rows_u = np.empty((len(uniq), self.dim), np.float32)
            hs = slots_u[hit]
            if len(hs):
                rows_u[hit] = self._hot_rows_of(hs)
                self._slot_freq[hs] += 1.0
            if obs_gate.enabled():
                self.registry.inc("tiered_hot_hits_total", int(len(hs)))
            miss = ~hit
            if miss.any():
                # the rng-order contract needs each unique's FIRST
                # occurrence in the request: a reversed scatter (last
                # write wins -> position of the first duplicate) costs
                # one gather, where np.unique(return_index=True) would
                # force the stable argsort
                first_idx = np.empty(len(uniq), np.int64)
                first_idx[inverse[::-1]] = np.arange(
                    len(keys_arr) - 1, -1, -1,
                )
                rows_u[miss] = self._serve_misses(
                    uniq[miss], hs, grads=None,
                    create_order=first_idx[miss],
                )
                la = self._last_admitted
                if la is not None:
                    # fold the admissions into the cover's slot map
                    midx = np.flatnonzero(miss)
                    slots_u[midx[la[0]]] = la[1]
            self._slot_cache = (uniq, slots_u, self._res_epoch)
            return rows_u[inverse]

    def pull(
        self, keys, worker_epoch: int, worker_id: Optional[int] = None
    ) -> Optional[Dict[int, np.ndarray]]:
        keys_arr = np.fromiter((int(k) for k in keys), np.int64)
        rows = self.pull_batch(keys_arr, worker_epoch, worker_id)
        if rows is None:
            return None
        return {int(k): rows[i] for i, k in enumerate(keys_arr)}

    def push_batch(
        self,
        worker_id: int,
        keys: np.ndarray,
        grads: np.ndarray,
        worker_epoch: int,
    ) -> bool:
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
        reg.gauge_set("ps_store_staleness", self.staleness)
        self._feed_health()
        return ok

    def _push_batch(self, worker_id, keys, grads, worker_epoch) -> bool:
        with self._lock:
            keys_arr = np.ascontiguousarray(keys, np.int64)
            # the pull -> compute -> push cycle: a push whose keys are
            # exactly the last pull's unique cover (and whose residency
            # epoch still holds) reuses the pull's slot map — no probe,
            # and the cover is unique by construction
            sc = self._slot_cache
            reuse = (
                sc is not None and sc[2] == self._res_epoch
                and len(sc[0]) == len(keys_arr)
                and bool(np.array_equal(sc[0], keys_arr))
            )
            # UNIQUE is the same hard server-side contract as the flat
            # store: enforced BEFORE any state mutation (strictly
            # ascending keys — the common np.unique output — prove
            # uniqueness without the sort)
            if not reuse and keys_arr.size > 1:
                d = np.diff(keys_arr)
                if not bool((d > 0).all()):
                    srt = np.sort(keys_arr)
                    if np.any(np.diff(srt) == 0):
                        raise ValueError(
                            "push carries duplicate keys: per-push keys "
                            "must be unique (batch duplicate-key "
                            "gradients are summed client-side, "
                            "push.h:55-66)"
                        )
            if not self._push_gate(worker_id, worker_epoch):
                return False
            if keys_arr.size:
                g = np.asarray(grads, np.float32).reshape(-1, self.dim)
                slots = sc[1] if reuse else self._hot_slots(keys_arr)
                hit = slots >= 0
                if hit.any():
                    hs = slots[hit]
                    self._apply_slots(hs, g[hit])
                    self._dirty[hs] = True
                if obs_gate.enabled():
                    self.registry.inc("tiered_hot_hits_total",
                                      int(hit.sum()))
                miss = ~hit
                if miss.any():
                    # admission (and the frequency bump) happened on the
                    # pull side of this cycle: write misses in place
                    self._serve_misses(keys_arr[miss], slots[hit],
                                       grads=g[miss], admit=False)
                self.write_version += 1
                self._note_write(keys_arr)
            self._pushes_since_feed += 1
        return True

    def push(
        self, worker_id: int, grads: Dict[int, np.ndarray], worker_epoch: int
    ) -> bool:
        keys = np.fromiter((int(k) for k in grads), np.int64,
                           count=len(grads))
        g = np.stack([
            np.asarray(v, np.float32).reshape(self.dim)
            for v in grads.values()
        ]) if len(grads) else np.zeros((0, self.dim), np.float32)
        return self.push_batch(worker_id, keys, g, worker_epoch)

    # -- health feed ----------------------------------------------------------

    def _feed_health(self) -> None:
        hm = self.health
        if hm is None:
            return
        hm.observe(staleness=self.staleness)
        with self._lock:
            if self._pushes_since_feed < self._health_feed_every:
                return
            flow = {
                "promotions": self._flow_promotions,
                "demotions": self._flow_demotions,
                "bypass": self._flow_bypass,
                "batches": self._pushes_since_feed,
                "hot_rows": self._hot_count(),
                "budget": self.hot_rows,
            }
            self._flow_promotions = 0
            self._flow_demotions = 0
            self._flow_bypass = 0
            self._pushes_since_feed = 0
        hm.observe(tier_flow=flow)

    # -- preload / migration / eviction ---------------------------------------

    def preload_batch(self, keys: np.ndarray, rows: np.ndarray,
                      accums: Optional[np.ndarray] = None) -> None:
        """rows[i] -> keys[i], accumulators reset (or set to ``accums`` —
        the optimizer-state migration path).  Resident copies update in
        place; everything else lands in the COLD tier directly, so a
        full-vocabulary preload/restore never churns the fast tiers."""
        with self._lock:
            keys_arr = np.ascontiguousarray(keys, np.int64)
            if not len(keys_arr):
                return
            # pending creates persist FIRST: the epoch bump below would
            # orphan their only copy, and flushing after the preload
            # writes could overwrite a just-preloaded key with the stale
            # cached row
            self._flush_cache_writes()
            r = np.asarray(rows, np.float32).reshape(-1, self.dim)
            a = (np.asarray(accums, np.float32).reshape(-1, self.dim)
                 if accums is not None
                 else np.zeros_like(r))
            slots = self._hot_slots(keys_arr)
            hot = slots >= 0
            if hot.any():
                hs = slots[hot]
                self._hot_land(hs, None, rows=r[hot], accums=a[hot])
                self._dirty[hs] = True
            rest = ~hot
            if rest.any():
                rest_keys = keys_arr[rest]
                payload = np.concatenate([r[rest], a[rest]], axis=1)
                _, in_warm = self._warm_probe(rest_keys)
                if in_warm.any():
                    self._warm_store.set_batch(
                        rest_keys[in_warm].view(np.uint64),
                        payload[in_warm],
                    )
                cold_sel = ~in_warm
                if cold_sel.any():
                    # preloaded keys the store has never seen enter here
                    # (callers pass unique keys — the migration/preload
                    # contract): count them into the running total
                    unseen = ~self._cold.contains_batch(rest_keys[cold_sel])
                    self._total_keys += int(unseen.sum())
                    self._cold.set_batch(
                        rest_keys[cold_sel], payload[cold_sel]
                    )
            self.write_version += 1
            self._note_write(keys_arr)
            self._mut_epoch += 1  # cached copies of preloaded keys stale
            self._note_occupancy(force=True)

    def preload(self, values: Dict[int, np.ndarray]) -> None:
        keys = np.fromiter(
            (int(k) for k in values), np.int64, count=len(values)
        )
        rows = np.stack([
            np.asarray(v, np.float32).reshape(self.dim)
            for v in values.values()
        ]) if len(values) else np.zeros((0, self.dim), np.float32)
        self.preload_batch(keys, rows)

    def _read_values(
        self, uniq: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, accums, known mask) for unique keys with hot > warm >
        cold precedence, residency untouched.  Caller holds the lock."""
        n = len(uniq)
        rows = np.zeros((n, self.dim), np.float32)
        accs = np.zeros((n, self.dim), np.float32)
        known = np.zeros(n, bool)
        if not n:
            return rows, accs, known
        slots = self._hot_slots(uniq)
        hot = slots >= 0
        rest_idx = np.flatnonzero(~hot)
        if rest_idx.size:
            rest_keys = uniq[rest_idx]
            wrows, in_warm = self._warm_probe(rest_keys)
            if in_warm.any():
                widx = rest_idx[in_warm]
                rows[widx] = wrows[in_warm, : self.dim]
                accs[widx] = wrows[in_warm, self.dim:]
                known[widx] = True
            cold_sel = ~in_warm
            if cold_sel.any():
                crows, cfound = self._cold.get_batch(rest_keys[cold_sel])
                cidx = rest_idx[cold_sel]
                rows[cidx[cfound]] = crows[cfound, : self.dim]
                accs[cidx[cfound]] = crows[cfound, self.dim:]
                known[cidx[cfound]] = True
        if hot.any():
            hs = slots[hot]
            pay = self._payload(hs)
            rows[hot] = pay[:, : self.dim]
            accs[hot] = pay[:, self.dim:]
            known[hot] = True
        return rows, accs, known

    def pull_state_batch(
        self, keys: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Read-only ``(rows, accums, known)`` for keys wherever they
        reside — residency untouched, nothing created.  The trainer fast
        path reads its staged (non-resident) rows' optimizer state here;
        unknown keys read zeros with ``known`` False."""
        with self._lock:
            keys_arr = np.ascontiguousarray(keys, np.int64)
            self._flush_cache_writes()  # pending creates must be visible
            return self._read_values(keys_arr)

    def migrate_in(self, keys: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Apply migrated rows (accumulators reset) and return the rows
        RE-READ from the store — the FNV read-back the migration protocol
        checksums (docs/ELASTICITY.md)."""
        self.preload_batch(keys, rows)
        with self._lock:
            uniq = np.ascontiguousarray(keys, np.int64)
            return self._read_values(uniq)[0]

    def migrate_in_state(
        self, keys: np.ndarray, rows: np.ndarray, accums: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Optimizer-state-carrying migration: rows AND accumulators land
        and are re-read for checksum verification."""
        self.preload_batch(keys, rows, accums=accums)
        with self._lock:
            uniq = np.ascontiguousarray(keys, np.int64)
            out_rows, out_accs, _ = self._read_values(uniq)
            return out_rows, out_accs

    def evict_batch(self, keys: np.ndarray) -> int:
        """Remove keys from EVERY tier (rows migrated away must not
        survive as stale duplicates).  Returns how many of ``keys`` were
        present — each key counted once, whatever tier(s) held it."""
        with self._lock:
            keys_arr = np.ascontiguousarray(keys, np.int64)
            if not len(keys_arr):
                return 0
            # pending creates persist FIRST: flushing after the evict
            # would resurrect an evicted key from the fault cache, and
            # the epoch bump below would orphan non-evicted pendings
            self._flush_cache_writes()
            uniq = np.unique(keys_arr)
            slots = self._hot_slots(uniq)
            hot = slots >= 0
            _, in_warm = self._warm_probe(uniq)
            in_cold = self._cold.contains_batch(uniq)
            present = hot | in_warm | in_cold
            n = int(present.sum())
            if hot.any():
                hs = slots[hot]
                self._slot_keys[hs] = -1
                self._dirty[hs] = False
                self._lower[hs] = 0
                self._slot_freq[hs] = 0.0
                self._free[self._n_free:self._n_free + len(hs)] = hs
                self._n_free += len(hs)
                self._res_epoch += 1
                self._rebuild_hot_index()
            for k in uniq[in_warm].tolist():
                self._warm.pop(k, None)
                # the segment cannot unlink: the dead-set masks the
                # stale row until (if ever) the key is re-admitted warm
                self._warm_dead.add(k)
            if in_cold.any():
                self._cold.delete_batch(uniq[in_cold])
            if n:
                self.evicted_keys += n
                self._total_keys -= n
                self.write_version += 1
                self._note_write(uniq[present])
                self._mut_epoch += 1  # cached copies of evicted keys die
                if obs_gate.enabled():
                    self.registry.inc("tiered_evicted_keys_total", n)
            self._note_occupancy(force=True)
            return n

    def snapshot_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted keys, rows) across ALL tiers, hot > warm > cold."""
        keys, rows, _ = self.snapshot_state_arrays()
        return keys, rows

    def snapshot_state_arrays(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(sorted keys, rows, accums) across all tiers — the checkpoint
        and migration source (optimizer state included)."""
        with self._lock:
            all_keys = self._all_keys_locked()
            rows, accs, known = self._read_values(all_keys)
            del known
            return all_keys, rows, accs

    def snapshot(self) -> Dict[int, np.ndarray]:
        keys, rows = self.snapshot_arrays()
        return {int(k): rows[i].copy() for i, k in enumerate(keys)}

    # -- reads ----------------------------------------------------------------

    def _all_keys_locked(self) -> np.ndarray:
        """Sorted union of keys across tiers (hot/warm/cold may shadow
        each other — membership counts once)."""
        # created rows pending in the fault cache live in NO tier yet:
        # persist them so enumeration (snapshots, checkpoints, n_keys)
        # never misses a row that consumed the rng stream
        self._flush_cache_writes()
        hot_keys = self._hk
        warm_keys = np.fromiter(
            self._warm.keys(), np.int64, count=len(self._warm)
        )
        cold_keys = self._cold.keys()
        if not (len(hot_keys) + len(warm_keys) + len(cold_keys)):
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate([hot_keys, warm_keys, cold_keys]))

    def n_keys(self) -> int:
        """EXACT enumerated key count (flushes pending creates, walks all
        three tiers) — the ground truth the cheap ``stats()`` counter is
        tested against."""
        with self._lock:
            return int(len(self._all_keys_locked()))

    def memory_bytes(self) -> Dict[str, int]:
        """Resident bytes per tier, shaped for a
        :class:`~lightctr_tpu_torch.obs.resources.MemorySampler` source — the
        dict fans out to ``resource_memory_bytes{kind=<name>_<tier>}``.
        Hot/warm count ``[row || accum]`` fp32 pairs (dim*8 bytes/row,
        the same arithmetic as ``tiered_bytes_resident``); cold is the
        mmap log's file footprint; the device block doubles the hot
        bytes when the pinned HBM copy exists."""
        with self._lock:
            out = {
                "hot": self.hot_rows * self.dim * 8,
                "warm": len(self._warm) * self.dim * 8,
                "cold": int(self._cold.stats().get("file_bytes", 0)),
            }
            if self.device_hot:
                out["device_block"] = self.hot_rows * self.dim * 8
        return out

    def stats(self) -> Dict:
        """The flat store's stats shape + the per-tier ``store`` section
        (tools/metrics_report.py --store renders it).  The key total is
        the running arithmetic counter — a monitoring poll must not pay
        an O(vocab) three-tier enumeration (or flush pending creates)
        under the store lock."""
        with self._lock:
            self._note_occupancy(force=True)  # gauges current at read time
            n_hot = self._hot_count()
            n_warm = len(self._warm)
            n_cold = self._cold.n_rows
            total = int(self._total_keys)
            out = {
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
                # the same bounded per-key delta record the flat store
                # ships — the stats-polling freshness path reads it, and
                # MSG_SUBSCRIBE long-polls the same log (WriteLogMixin)
                "write_delta": self._write_delta_record(),
                "n_keys": total,
                "store": {
                    "kind": "tiered",
                    "rows": total,
                    "capacity": self.hot_rows,
                    "device_hot": self.device_hot,
                    "fault_pipeline": {
                        "enabled": self._prefetch_enabled,
                        "overlap_rows": self._pf_overlap_rows,
                        "sync_rows": self._pf_sync_rows,
                        "overlap_ratio": round(
                            self._pf_overlap_rows
                            / (self._pf_overlap_rows + self._pf_sync_rows),
                            5,
                        ) if (self._pf_overlap_rows
                              + self._pf_sync_rows) else 0.0,
                    },
                    "load_factor": round(n_hot / self.hot_rows, 5),
                    "bytes_resident": (
                        self.hot_rows * self.dim * 8
                        + n_warm * self.dim * 8
                    ),
                    "dim": self.dim,
                    "tiers": {
                        "hot": {"rows": n_hot, "capacity": self.hot_rows,
                                "peak_rows": self.peak_hot_rows},
                        "warm": {"rows": n_warm,
                                 "capacity": self.warm_rows},
                        "cold": dict(self._cold.stats()),
                    },
                },
                "ledger": self.ledger.stats(),
            }
        return out

    def close(self) -> None:
        # stop the prefetch worker FIRST (it takes the store lock): no
        # stage may land after the tiers go away
        self._closed = True
        if self._pf_thread is not None and self._pf_thread.is_alive():
            # the queue may be FULL (double buffer occupied): drain stale
            # items until the shutdown sentinel lands — a swallowed
            # sentinel would leave the worker parked in get() forever and
            # burn the whole join timeout on every close
            for _ in range(3):
                try:
                    self._pf_queue.put_nowait(None)
                    break
                except Exception:
                    try:
                        self._pf_queue.get_nowait()
                    except Exception:
                        pass
            self._pf_thread.join(timeout=10.0)
        with self._lock:
            # a created-but-unpushed row's only copy may still sit in the
            # fault cache: persist it before the tiers go away
            self._flush_cache_writes()
        if self._warm_store is not None:
            self._warm_store.close()
            self._warm_store = None
        self._cold.close()
