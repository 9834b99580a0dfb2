"""Master control-plane role — the reference's standalone master process.

The port's copy of ``lightctr_tpu/dist/master.py``.  The reference
deploys three distinct roles: master (heartbeat + routing
decisions, ``master.h:146-262``), N paramserver processes (serve keys,
obey routing, ``network.h:148-151``), M workers.  The repo's mesh path
subsumes the master with ``torch.distributed``; THIS module is the
socket-topology form: a small service that owns the
:class:`~lightctr_tpu_torch.dist.bootstrap.HeartbeatMonitor` and broadcasts its
death/recovery decisions to every PS shard over the control-plane ops
(``MSG_UNROUTE``/``MSG_READMIT``).

Workers heartbeat HERE (``PSClient.beat`` against the master address);
parameter traffic goes straight to the shards — exactly the reference's
separation, where liveness and data ride different connections to
different roles.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Optional

import numpy as np

from lightctr_tpu_torch.ckpt import checkpoint as ckpt_mod
from lightctr_tpu_torch.dist.bootstrap import (
    DEAD_AFTER_S,
    HEARTBEAT_PERIOD_S,
    STALE_AFTER_S,
    HeartbeatMonitor,
)
from lightctr_tpu_torch.dist.elastic import RoutingTable, plan_migration
from lightctr_tpu_torch.dist.ps_server import (
    ParamServerService,
    ProtocolRejection,
    PSClient,
)
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
from lightctr_tpu_torch.obs import device as obs_device
from lightctr_tpu_torch.obs import emit_event
from lightctr_tpu_torch.obs import exporter as obs_exporter
from lightctr_tpu_torch.obs import flight as obs_flight
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs import health as obs_health
from lightctr_tpu_torch.obs import resources as obs_resources
from lightctr_tpu_torch.obs import trace as obs_trace
from lightctr_tpu_torch.obs.cluster import ClusterRollup, attribute_stragglers
from lightctr_tpu_torch.obs.quality import quality_rollup
from lightctr_tpu_torch.obs.registry import labeled


# Beats with ids at/above this base are PS-SHARD liveness (shard i beats
# with SHARD_ID_BASE + i), disjoint from worker ids — the reference master
# monitors every registered node kind in one ledger (master.h:202-262).
SHARD_ID_BASE = 1 << 20


class MasterService:
    """Heartbeat/routing authority over a set of PS shards.

    ``beat``/``farewell`` frames arrive on this service's socket; when the
    monitor declares a worker dead (or sees it return), the decision is
    pushed to every shard via admin ops.  The local store is a dim-1 dummy
    — the master serves no parameters (master.h's master holds no table
    either).

    SHARDS heartbeat here too (ids ``SHARD_ID_BASE + shard_index``): a dead
    shard shows up as ``dead`` in the STATS liveness map (the ops plane
    reads it to trigger relaunch+restore), and a returning shard's first
    beat auto-replays every routing decision it missed while down.

    There is no binary alive/dead cliff: ``degraded_after_missed`` missed
    heartbeat periods mark a node DEGRADED first (counted in
    ``master_degraded_total{kind=...}``, evented, and reflected in the
    master's own :class:`~lightctr_tpu_torch.obs.health.HealthMonitor` — its
    verdict rides this service's MSG_STATS replies and ``/healthz``)
    before ``dead_after_s`` declares it dead."""

    def __init__(
        self,
        shard_addresses,
        host: str = "127.0.0.1",
        port: int = 0,
        stale_after_s: float = STALE_AFTER_S,
        dead_after_s: float = DEAD_AFTER_S,
        period_s: float = HEARTBEAT_PERIOD_S,
        shard_rpc_timeout_s: float = 5.0,
        degraded_after_missed: Optional[int] = None,
        elastic: bool = False,
        partition: str = "ring",
        dim: int = 1,
        ckpt_dir: Optional[str] = None,
        grace_factor: float = 3.0,
        scrape_period_s: Optional[float] = None,
        scrape_targets=None,
    ):
        """``elastic=True`` turns detection into ACTION (docs/ELASTICITY.md):
        the master owns an epoch-numbered :class:`RoutingTable` (served
        over ``MSG_ROUTE``), and membership transitions drive checkpointed
        row migration — a dead shard's rows move from its latest snapshot
        under ``ckpt_dir/shard_<i>`` to its ring successors, a joining
        shard receives (and the donors evict) exactly its arcs' rows.
        ``dim`` must then be the PS row width (admin migrate/snapshot ops
        decode rows); ``grace_factor`` widens every surviving shard's SSP
        staleness budget for the duration of a rebalance."""
        # ``degraded_after_missed`` (k): a node is marked DEGRADED after
        # k missed heartbeat periods — expressed to the monitor as the
        # stale threshold, overriding stale_after_s when given
        if degraded_after_missed is not None:
            if degraded_after_missed < 1:
                raise ValueError("degraded_after_missed must be >= 1")
            stale_after_s = degraded_after_missed * period_s
        # per-op socket timeout: a wedged shard must raise (and be
        # retried), not stall heartbeat processing under the dispatch lock
        self._shard_addresses = [tuple(a) for a in shard_addresses]
        self._timeout = shard_rpc_timeout_s
        self.elastic = bool(elastic)
        self.dim = int(dim)
        self.ckpt_dir = ckpt_dir
        self.grace_factor = float(grace_factor)
        # routing state: membership sets are the source of truth; every
        # publish derives a fresh immutable RoutingTable at epoch+1
        self._route_lock = threading.Lock()
        self._members = list(range(len(self._shard_addresses)))
        self._workers: set = set()
        self._partition_name = str(partition)
        self._routing = RoutingTable(
            epoch=0,
            members=self._members,
            addresses=self._addr_map(),
            partition=self._partition_name,
        )
        # serializes whole rebalances (a second death mid-migration waits)
        self._rebalance_lock = threading.Lock()
        self.migrations: list = []  # verification records, newest last
        # admin connections are LAZY (None until first use, re-None'd on
        # failure): a shard that is down at master startup — or dies later —
        # must degrade to queued decisions, not crash the control plane
        self._shards: list = [None] * len(self._shard_addresses)
        # per-shard queue of routing decisions the shard missed, replayed
        # in order on next successful contact (see _broadcast)
        self._pending = [[] for _ in self._shard_addresses]
        # serializes ALL admin traffic: _broadcast arrives from the
        # monitor's dispatch thread AND per-connection farewell handlers,
        # flush_pending from arbitrary callers, and the rebalance threads'
        # migrate/evict/grace traffic — the admin PSClients' sockets and
        # the pending queues are not thread-safe.  RLock: _admin_rpc
        # acquires it itself, and _broadcast/_replay call it while already
        # holding it
        self._admin_lock = threading.RLock()
        # shards that deterministically rejected a state-carrying op
        # (old peer / store without the surface): later ranges and joins
        # skip the doomed MIGRATE_STATE/SNAPSHOT_STATE attempt instead of
        # re-shipping the full payload per range
        self._no_state_ops: set = set()
        self.monitor = HeartbeatMonitor(
            stale_after_s=stale_after_s,
            dead_after_s=dead_after_s,
            period_s=period_s,
            on_dead=self._broadcast_unroute,
            on_recover=self._broadcast_readmit,
            on_stale=self._on_stale,
            on_stale_clear=self._on_stale_clear,
            on_join=self._on_join,
        )
        # dummy store: gives the service something to answer STATS with;
        # routing state that matters lives on the shards.  Clean departures
        # (FIN) must clear the departing worker's routes on the SHARDS,
        # not just here — hence on_farewell.
        self._store = AsyncParamServer(dim=1, n_workers=1)
        # the master's failover counters live in its store's registry, so
        # they ride the same MSG_STATS wire op as every shard's telemetry
        self.registry = self._store.registry
        # cluster-liveness health verdict: stale peers degrade it, dead
        # peers make it unhealthy; the service below serves it over
        # MSG_STATS (and the ops exporter over /healthz)
        self.health = obs_health.HealthMonitor(
            component="master", registry=self.registry,
        )
        self.health.ensure_detector(obs_health.HeartbeatGapDetector())
        self._svc = ParamServerService(
            self._store, host=host, port=port, monitor=self.monitor,
            on_farewell=self._on_farewell_wid, health=self.health,
            route_provider=self.routing_dict,
        )
        self.address = self._svc.address
        # cluster telemetry rollup (docs/OBSERVABILITY.md):
        # ``scrape_period_s`` arms a daemon loop that polls every
        # member's MSG_STATS telemetry snapshot — the PS shards the
        # master routes, plus any extra (name, address) ``scrape_targets``
        # (rendezvous reduce shards) — into ONE member-labeled registry
        # view.  The rollup registers with the flight recorder, so the
        # master's ops exporter serves the whole cluster at /metrics and
        # the straggler-attribution verdict at /stragglerz.
        self.rollup: Optional[ClusterRollup] = None
        self.scrape_period_s = scrape_period_s
        self._scrape_stop = threading.Event()
        self._scrape_thread: Optional[threading.Thread] = None
        self._scrape_clients: dict = {}
        self._scrape_extra = [(str(n), tuple(a))
                              for n, a in (scrape_targets or [])]
        self._scrape_iq: Optional[obs_resources.InstrumentedQueue] = None
        self._ring_watch: Optional[obs_resources.EventRingWatch] = None
        if scrape_period_s is not None:
            if scrape_period_s <= 0:
                raise ValueError("scrape_period_s must be positive")
            self.rollup = ClusterRollup()
            # the route and registry names are process-global: a second
            # scrape-armed master in one process takes them over (warned
            # — latest wins), and close() only unhooks what is still OURS
            # so closing the old master cannot break the survivor
            if "cluster" in obs_flight.registered_registries() \
                    or "/stragglerz" in obs_exporter.json_routes():
                logging.getLogger(__name__).warning(
                    "another cluster rollup is registered in this "
                    "process; /stragglerz, /qualityz, /resourcez, "
                    "/devicez and /metrics now serve THIS master's view"
                )
            # sweep saturation telemetry: depth = members pending this
            # sweep, wait = whole-sweep seconds (a sweep that stops
            # fitting inside scrape_period_s shows up here first), plus
            # the event ring's occupancy sampled once per sweep
            self._scrape_iq = obs_resources.InstrumentedQueue(
                "master_scrape", register=False)
            self._ring_watch = obs_resources.EventRingWatch(register=False)
            obs_flight.register_registry("cluster", self.rollup)
            obs_exporter.register_json_route("/stragglerz", self.stragglerz)
            obs_exporter.register_json_route("/qualityz", self.qualityz)
            obs_exporter.register_json_route("/resourcez", self.resourcez)
            obs_exporter.register_json_route("/devicez", self.devicez)
            self._scrape_thread = threading.Thread(
                target=self._scrape_loop, name="master-scrape", daemon=True,
            )
            self._scrape_thread.start()
        self.monitor.start()

    @staticmethod
    def _to_wid(worker: str):
        try:
            wid = int(worker)
        except (TypeError, ValueError):
            return None
        # shard liveness ids are not workers: no routing broadcast for them
        return wid if 0 <= wid < SHARD_ID_BASE else None

    @staticmethod
    def _to_shard(worker: str):
        try:
            wid = int(worker)
        except (TypeError, ValueError):
            return None
        return wid - SHARD_ID_BASE if wid >= SHARD_ID_BASE else None

    # retry pacing for admin delivery: capped exponential backoff with
    # jitter BETWEEN attempts — back-to-back retries against a shard that
    # is restarting all land in the same refused window, and a jitterless
    # fleet of masters (tests run many) would synchronize
    BACKOFF_BASE_S = 0.05
    BACKOFF_CAP_S = 2.0

    @classmethod
    def _backoff_s(cls, attempt: int) -> float:
        return min(cls.BACKOFF_CAP_S, cls.BACKOFF_BASE_S * (2 ** attempt)) \
            * (0.5 + 0.5 * random.random())

    def _admin_rpc(self, i: int, fn, attempts: int = 3):
        """Run ``fn(client)`` against shard ``i`` up to ``attempts`` times,
        reconnecting between tries (so every reconnect is followed by an
        op retry, never wasted on the final slot) with capped exponential
        backoff + jitter before each retry.  Returns (ok, result-or-error);
        retries and exhaustions land in the metrics registry."""
        telem = obs_gate.enabled()
        err = None
        with self._admin_lock:
            for attempt in range(attempts):
                if attempt:
                    if telem:
                        self.registry.inc("master_delivery_retries_total")
                    time.sleep(self._backoff_s(attempt - 1))
                try:
                    if self._shards[i] is None:
                        self._shards[i] = PSClient(
                            self._shard_addresses[i], self.dim,
                            timeout=self._timeout,
                        )
                    return True, fn(self._shards[i])
                except (ConnectionError, OSError, RuntimeError) as e:
                    err = e
                    if self._shards[i] is not None:
                        try:
                            self._shards[i].close()
                        except OSError:
                            pass
                        self._shards[i] = None
                    if isinstance(e, ProtocolRejection):
                        # deterministic rejection (old peer without the
                        # op): retrying resends the identical doomed
                        # frame — fail fast so the caller degrades
                        break
        if telem:
            self.registry.inc("master_delivery_exhausted_total")
        return False, err

    def _note_state_rejection(self, shard: int, err) -> bool:
        """Memoize a DETERMINISTIC state-op rejection (old peer / store
        without the surface) so later ranges and joins skip the doomed
        MIGRATE_STATE/SNAPSHOT_STATE attempt; transient failures stay
        retryable.  Returns True when the error WAS a rejection."""
        if isinstance(err, ProtocolRejection):
            self._no_state_ops.add(int(shard))
            return True
        return False

    def _deliver(self, i: int, op: str, wid: int, attempts: int = 3) -> bool:
        ok, _ = self._admin_rpc(
            i, lambda c: getattr(c, op)(wid), attempts=attempts
        )
        return ok

    def _replay(self, i: int) -> bool:
        """Drain shard ``i``'s missed-decision queue in order, stopping at
        the first failed delivery.  True iff the queue emptied.  Caller
        holds _admin_lock."""
        pending = self._pending[i]
        while pending:
            p_op, p_wid = pending[0]
            if not self._deliver(i, p_op, p_wid):
                return False
            pending.pop(0)
            if obs_gate.enabled():
                self.registry.inc("master_replayed_decisions_total")
        return True

    # -- elastic membership: routing + row migration (docs/ELASTICITY.md) ---

    def _addr_map(self):
        return {i: a for i, a in enumerate(self._shard_addresses)}

    def routing_dict(self):
        """Current routing table as a JSON-ready dict — the MSG_ROUTE
        payload (and the thing clients poll)."""
        with self._route_lock:
            return self._routing.to_dict()

    @property
    def routing(self) -> RoutingTable:
        with self._route_lock:
            return self._routing

    def _publish(self, members=None, workers_add=None, workers_remove=None,
                 rebalancing=None, bump=True,
                 action="route_update") -> RoutingTable:
        """Derive + install a new routing table from the membership sets.
        One lock, one swap: clients fetching MSG_ROUTE see either the old
        epoch or the new one, never a half-built table.  Worker changes
        are expressed as add/remove MUTATIONS applied under the lock — a
        read-modify-write against a snapshot would let a concurrent
        join/leave on another thread be lost."""
        with self._route_lock:
            if members is not None:
                self._members = sorted(int(m) for m in members)
            if workers_add is not None:
                self._workers.add(int(workers_add))
            if workers_remove is not None:
                self._workers.discard(int(workers_remove))
            flag = (self._routing.rebalancing if rebalancing is None
                    else bool(rebalancing))
            table = RoutingTable(
                epoch=self._routing.epoch + (1 if bump else 0),
                members=self._members,
                addresses=self._addr_map(),
                partition=self._partition_name,
                workers=sorted(self._workers),
                rebalancing=flag,
            )
            self._routing = table
        if obs_gate.enabled():
            self.registry.gauge_set("master_route_epoch", table.epoch)
            self.registry.inc("master_route_publishes_total")
        emit_event("failover", action=action, epoch=table.epoch,
                   members=list(table.members),
                   workers=list(table.workers),
                   rebalancing=table.rebalancing)
        return table

    def _broadcast_grace(self, members, factor: float) -> None:
        """Widen (or restore, factor=1) the SSP staleness budget on every
        given shard — the rebalance grace window.  Best effort with the
        usual retry/backoff; a shard that misses the restore re-syncs on
        its next grace cycle."""
        for i in members:
            self._admin_rpc(i, lambda c: c.grace(factor))

    def _migrate_ranges(self, keys, rows, new_table, reason="shard_death",
                        accums=None):
        """Ship (keys, rows[, accums]) to their owners under ``new_table``
        with per-range row-count + FNV read-back verification; appends one
        record per range to ``self.migrations`` and returns
        (all_verified, records).  With ``accums`` the range rides
        MSG_MIGRATE_STATE so the receiving shard lands optimizer STATE
        next to its rows (no accumulator reset on rebalance); an old shard that rejects the op degrades that range
        to row-only MSG_MIGRATE, recorded as ``accums: False``."""
        records = []
        ok_all = True
        plan = plan_migration(keys, new_table)
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        for dst, dkeys in sorted(plan.items()):
            pos = np.searchsorted(sorted_keys, dkeys)
            drows = rows[order[pos]]
            rec = {
                "dst": int(dst), "n": int(len(dkeys)), "reason": reason,
                "epoch": int(new_table.epoch),
            }
            ok, rep = False, None
            state_failed_transient = False
            if accums is not None and dst not in self._no_state_ops:
                daccs = accums[order[pos]]
                ok, rep = self._admin_rpc(
                    dst, lambda c: c.migrate_state(
                        dkeys, drows, daccs, new_table.epoch),
                )
                if not ok:
                    if self._note_state_rejection(dst, rep):
                        logging.getLogger(__name__).warning(
                            "shard %d rejected MSG_MIGRATE_STATE (%s): "
                            "degrading range to row-only migration "
                            "(accumulators reset on the receiver)",
                            dst, rep,
                        )
                    else:
                        # transient failure against a (presumably)
                        # state-capable shard: do NOT silently land the
                        # range rows-only — record it failed, so the
                        # episode retries with optimizer state intact
                        state_failed_transient = True
            if not ok and not state_failed_transient:
                ok, rep = self._admin_rpc(
                    dst,
                    lambda c: c.migrate_rows(dkeys, drows, new_table.epoch),
                )
                if ok:
                    rep.setdefault("accums", False)
            if ok:
                rec.update(rep)
            else:
                rec.update({"verified": False, "error": str(rep)})
            if not rec.get("verified"):
                ok_all = False
            records.append(rec)
            if obs_gate.enabled():
                self.registry.inc(labeled(
                    "master_migrated_rows_total", verified=str(
                        bool(rec.get("verified"))).lower(),
                ), len(dkeys))
                if rec.get("accums"):
                    self.registry.inc(
                        "master_migrated_accum_rows_total", len(dkeys)
                    )
        self.migrations.extend(records)
        return ok_all, records

    def _rebalance_episode(self, action, shard, target_members,
                           publish_action, work_fn):
        """Shared rebalance choreography: serialize episodes, widen the
        SSP budget on the surviving members, run ``work_fn`` (the actual
        row movement; returns the records), publish the epoch bump with
        ``target_members``, then restore the budget and publish the
        settled flag.  The membership publish happens in a ``finally`` ON
        PURPOSE: these run on fire-and-forget threads, and a work_fn
        crash (bad checkpoint, dim skew) must degrade to
        members-published-rows-unverified — evented and counted — never
        to routing stranded at the dead epoch forever.  The episode is
        evented begin/done and — when the flight recorder is armed —
        dumped as a bundle, so the postmortem story survives the run."""
        with self._rebalance_lock:
            t0 = time.monotonic()
            emit_event("failover", action=f"{action}_begin", shard=shard)
            with obs_trace.span(f"master/{action}", shard=shard):
                survivors = [m for m in self.routing.members
                             if m != shard] or list(self.routing.members)
                self._broadcast_grace(survivors, self.grace_factor)
                verified, records = False, []
                try:
                    verified, records = work_fn()
                except Exception:
                    logging.getLogger(__name__).exception(
                        "%s: row migration for shard %s failed; publishing "
                        "the membership change anyway (rows unverified)",
                        action, shard,
                    )
                    emit_event("failover", action=f"{action}_error",
                               shard=shard)
                    if obs_gate.enabled():
                        self.registry.inc(labeled(
                            "master_rebalance_errors_total", kind=action))
                finally:
                    self._publish(members=target_members, rebalancing=True,
                                  action=publish_action)
                    self._broadcast_grace(survivors, 1.0)
                    self._publish(rebalancing=False, bump=False,
                                  action=f"{action}_settled")
            dt = time.monotonic() - t0
            if obs_gate.enabled():
                self.registry.inc(labeled("master_rebalances_total",
                                          kind=action))
                self.registry.observe("master_rebalance_seconds", dt)
            emit_event("failover", action=f"{action}_done", shard=shard,
                       verified=verified, seconds=round(dt, 6),
                       ranges=records, epoch=self.routing.epoch)
            logging.getLogger(__name__).warning(
                "%s: shard %s rebalanced in %.3fs (%d ranges, verified=%s, "
                "epoch %d)", action, shard, dt, len(records), verified,
                self.routing.epoch,
            )
            # the flight recorder captures the episode at act time — the
            # chaos harness reads this bundle back via trace_report --flight
            if obs_flight.armed():
                obs_flight.dump(f"{action}:shard{shard}")
            return verified

    def _shard_ckpt_source(self, shard: int):
        """(keys, rows, accums-or-None) from the dead shard's newest intact
        snapshot under ``ckpt_dir/shard_<i>`` — the migration source when
        the process is gone.  Empty when no checkpoint exists (rows are
        then lazily re-initialized by their new owners, counted as lost);
        ``accums`` is None for snapshots written before the state-carrying
        format (the rebalance then degrades to row-only migration)."""
        empty = (np.zeros(0, np.int64),
                 np.zeros((0, self.dim), np.float32), None)
        if self.ckpt_dir is None:
            return empty
        out = ckpt_mod.load_latest_state(
            os.path.join(self.ckpt_dir, f"shard_{int(shard)}")
        )
        if out is None:
            return empty
        _, keys, rows, accums = out
        return keys, rows, accums

    def _rebalance_drop(self, shard: int) -> bool:
        """A member shard died: migrate its rows (from its checkpoint) to
        their new owners under the shrunken ring, THEN publish the epoch
        bump — clients keep retrying the dead address until the rows are
        in place, so no pull ever lazily re-initializes a row the
        migration is about to land (zero row loss, checksum-verified)."""
        if shard not in self.routing.members:
            return False
        if len(self.routing.members) <= 1:
            logging.getLogger(__name__).error(
                "last PS shard %d died: nothing to rebalance onto", shard,
            )
            return False

        new_table = self.routing.without_shard(shard)

        def work():
            keys, rows, accums = self._shard_ckpt_source(shard)
            if not len(keys):
                emit_event("failover", action="migration_source_empty",
                           shard=shard)
            return self._migrate_ranges(
                keys, rows, new_table, reason="shard_death", accums=accums,
            )

        return self._rebalance_episode(
            "rebalance_drop", shard, new_table.members, "shard_dropped",
            work,
        )

    def _rebalance_join(self, shard: int) -> bool:
        """A shard (re)joined: donors snapshot, the joiner receives
        exactly the keys the grown ring maps onto it (checksum-verified),
        donors evict what they handed off, and only then does the epoch
        bump route traffic at the joiner.  A re-joining shard is wiped
        first — its rows predate the epochs it missed."""

        with self._route_lock:
            members = sorted(set(self._members) | {int(shard)})

        def work():
            joined = RoutingTable(
                epoch=self.routing.epoch + 1, members=members,
                addresses=self._addr_map(),
                partition=self._partition_name,
            )
            # wipe the joiner: whatever it holds is from before it left
            ok, snap = self._admin_rpc(shard, lambda c: c.snapshot_arrays())
            if ok and len(snap[0]):
                self._admin_rpc(shard, lambda c, k=snap[0]: c.evict(k))
            verified = True
            records = []
            for donor in self.routing.members:
                if donor == shard:
                    continue
                # donors snapshot WITH optimizer state when they can; an
                # old donor without the op degrades to rows-only (the
                # joiner's accumulators for those arcs restart at zero)
                ok, daccs_all = False, None
                if donor not in self._no_state_ops:
                    ok, snap = self._admin_rpc(
                        donor, lambda c: c.snapshot_state_arrays()
                    )
                    if not ok:
                        self._note_state_rejection(donor, snap)
                if ok:
                    dkeys, drows, daccs_all = snap
                else:
                    logging.getLogger(__name__).warning(
                        "donor %d has no state snapshot: join ranges "
                        "degrade to row-only (the joiner's accumulators "
                        "for those arcs restart at zero)", donor,
                    )
                    ok, snap = self._admin_rpc(
                        donor, lambda c: c.snapshot_arrays()
                    )
                    if ok:
                        dkeys, drows = snap
                if not ok:
                    verified = False
                    records.append({"dst": int(shard), "donor": int(donor),
                                    "verified": False, "error": str(snap)})
                    continue
                moving = plan_migration(dkeys, joined).get(int(shard))
                if moving is None or not len(moving):
                    continue
                pos = np.searchsorted(dkeys, moving)
                v, recs = self._migrate_ranges(
                    moving, drows[pos], joined, reason="shard_join",
                    accums=None if daccs_all is None else daccs_all[pos],
                )
                for r in recs:
                    r["donor"] = int(donor)
                verified = verified and v
                if v:
                    # hand-off complete: the donor must not keep stale
                    # duplicates of rows it no longer owns
                    self._admin_rpc(
                        donor, lambda c, k=moving: c.evict(k)
                    )
                records.extend(recs)
            return verified, records

        return self._rebalance_episode(
            "rebalance_join", shard, members, "shard_joined", work,
        )

    def admit_shard(self, address) -> int:
        """Admit a NEW shard process into the cluster: allocates the next
        stable shard id, migrates its ring share over (donors evict), and
        publishes the epoch.  Returns the shard id (its heartbeats should
        use ``SHARD_ID_BASE + id``)."""
        if not self.elastic:
            raise RuntimeError("admit_shard requires elastic=True")
        with self._admin_lock:
            shard = len(self._shard_addresses)
            self._shard_addresses.append(tuple(address))
            self._shards.append(None)
            self._pending.append([])
        emit_event("failover", action="shard_admitted", shard=shard,
                   address=list(address))
        self._rebalance_join(shard)
        return shard

    def _on_join(self, worker: str) -> None:
        """First-ever beat: a WORKER joining bumps the membership epoch so
        every process derives the same data-shard map from the same table
        (elastic worker join).  Shard first-beats are just startup."""
        if not self.elastic:
            return
        wid = self._to_wid(worker)
        if wid is None:
            return
        with self._route_lock:
            known = wid in self._workers
        if not known:
            emit_event("failover", action="worker_joined", worker=wid)
            self._publish(workers_add=wid, action="worker_joined")

    def _on_farewell_wid(self, wid: int) -> None:
        """Clean worker departure: readmit routes (historic behavior) and,
        in elastic mode, shrink the worker set under a new epoch so the
        departed worker's data shards are re-dealt."""
        self._broadcast("readmit", wid)
        if self.elastic and wid in self.routing.workers:
            emit_event("failover", action="worker_left", worker=wid)
            self._publish(workers_remove=wid, action="worker_left")

    def _broadcast(self, op: str, wid: int) -> None:
        """Deliver a routing decision to every shard; decisions a shard
        misses (down OR wedged) are queued per shard and replayed in order
        on the next successful contact — monitor transitions fire exactly
        once, so an abandoned delivery would leave that shard's routing
        permanently diverged from the master's view."""
        telem = obs_gate.enabled()
        # failover spans: the admin-op _send calls inside carry this span's
        # context, so each shard's unroute/readmit handler stitches under
        # the master's broadcast — a replayed decision is causally visible
        with obs_trace.span("master/broadcast", op=op, worker=wid), \
                self._admin_lock:
            for i in range(len(self._shards)):
                # missed decisions first: order matters
                if not self._replay(i) or not self._deliver(i, op, wid):
                    self._pending[i].append((op, wid))
                    if telem:
                        self.registry.inc("master_queued_decisions_total")
                    logging.getLogger(__name__).warning(
                        "PS shard %s unreachable: queued %s(%d) for replay "
                        "(%d pending)",
                        self._shard_addresses[i], op, wid,
                        len(self._pending[i]),
                    )
                elif telem:
                    self.registry.inc(
                        labeled("master_admin_ops_total", op=op)
                    )
            if telem:
                self.registry.gauge_set(
                    "master_pending_decisions",
                    sum(len(p) for p in self._pending),
                )

    def flush_pending(self) -> int:
        """Replay queued routing decisions against every shard (call after
        a shard restart/restore).  Returns the number still undelivered."""
        with self._admin_lock:
            for i in range(len(self._shards)):
                self._replay(i)
            return sum(len(p) for p in self._pending)

    def _observe_peers(self) -> None:
        """Feed the liveness picture into the master's health monitor
        (called on every stale/dead/recover transition)."""
        if not obs_health.enabled():
            return
        self.health.observe(peers={
            "stale": sorted(self.monitor.stale_workers()),
            "dead": sorted(self.monitor.dead_workers()),
        })

    def _on_stale(self, worker: str) -> None:
        """A node missed ``degraded_after_missed`` heartbeat periods:
        DEGRADED — counted and evented, so the binary alive/dead cliff
        has a visible intermediate stage.  No routing change: routes are
        only deleted at the dead line."""
        shard = self._to_shard(worker)
        kind = "worker" if shard is None else "shard"
        if obs_gate.enabled():
            self.registry.inc(labeled("master_degraded_total", kind=kind))
        if shard is not None:
            emit_event("failover", action="shard_degraded", shard=shard)
            logging.getLogger(__name__).warning(
                "PS shard %d degraded (missed heartbeats)", shard
            )
        else:
            wid = self._to_wid(worker)
            emit_event("failover", action="worker_degraded",
                       worker=wid if wid is not None else str(worker))
        self._observe_peers()

    def _on_stale_clear(self, worker: str) -> None:
        """A degraded node resumed beating (or departed cleanly) without
        ever crossing the dead line: re-feed the shrunken degraded set so
        the health verdict recovers — without this, a stale-then-alive
        worker would pin the master DEGRADED forever."""
        del worker
        self._observe_peers()

    def _broadcast_unroute(self, worker: str) -> None:
        wid = self._to_wid(worker)
        if wid is not None:
            emit_event("failover", action="unroute", worker=wid)
            self._broadcast("unroute", wid)
            if self.elastic and wid in self.routing.workers:
                # elastic worker LEAVE: shrink the worker set under a new
                # epoch — survivors re-deal the dead worker's data shards
                # from the same table, no coordination needed
                emit_event("failover", action="worker_left", worker=wid)
                self._publish(workers_remove=wid, action="worker_left")
            self._observe_peers()
            return
        shard = self._to_shard(worker)
        if shard is not None:
            if obs_gate.enabled():
                self.registry.inc("master_shard_deaths_total")
            emit_event("failover", action="shard_dead", shard=shard)
            logging.getLogger(__name__).warning(
                "PS shard %d declared dead (heartbeat silence)", shard
            )
            if self.elastic and shard in self.routing.members:
                # ACT, off the monitor's dispatch thread: migration does
                # socket I/O with retries, and the monitor must keep
                # sweeping other peers while rows move
                threading.Thread(
                    target=self._rebalance_drop, args=(shard,), daemon=True,
                ).start()
            self._observe_peers()

    def _broadcast_readmit(self, worker: str) -> None:
        wid = self._to_wid(worker)
        if wid is not None:
            emit_event("failover", action="readmit", worker=wid)
            self._broadcast("readmit", wid)
            if self.elastic and wid not in self.routing.workers:
                # a readmitted worker resumes from the NEW epoch's shard
                # map, exactly like a fresh join
                emit_event("failover", action="worker_joined", worker=wid)
                self._publish(workers_add=wid, action="worker_joined")
            self._observe_peers()
            return
        shard = self._to_shard(worker)
        if shard is not None:
            self._resync_shard(shard)
            if self.elastic and shard not in self.routing.members \
                    and 0 <= shard < len(self._shard_addresses):
                # partition healed / fresh incarnation on a known address:
                # fold the shard back in with a join migration (its store
                # predates the epochs it missed and is wiped first)
                threading.Thread(
                    target=self._rebalance_join, args=(shard,), daemon=True,
                ).start()
            self._observe_peers()

    def _resync_shard(self, shard: int) -> None:
        """A (re)joining shard may be a FRESH process whose store lost
        every routing decision delivered to its predecessor — replaying
        only queued (undelivered) decisions is not enough.  Push the
        master's entire current dead-set to THAT shard as unroutes, then
        replay anything still queued for every shard."""
        if not (0 <= shard < len(self._shards)):
            return
        # a returning shard may be an UPGRADED process: forget any cached
        # state-op rejection so the next rebalance probes it afresh (one
        # extra doomed RPC at worst, vs silently resetting accumulators
        # on a now-capable shard forever)
        self._no_state_ops.discard(int(shard))
        with obs_trace.span("master/resync_shard", shard=shard), \
                self._admin_lock:
            for w in sorted(self.monitor.dead_workers()):
                wid = self._to_wid(w)
                if wid is not None and not self._deliver(shard, "unroute", wid):
                    # the returning shard wedged mid-resync (it may keep
                    # heartbeating): queue the miss exactly like
                    # _broadcast does so the next successful contact
                    # replays it — an abandoned delivery would leave the
                    # shard serving workers the master holds dead until
                    # some unrelated dead/return transition
                    self._pending[shard].append(("unroute", wid))
        left = self.flush_pending()
        if obs_gate.enabled():
            self.registry.inc("master_deadset_resyncs_total")
        emit_event("failover", action="shard_resync", shard=shard,
                   pending=left)
        logging.getLogger(__name__).warning(
            "PS shard %d returned; resynced dead-set + replayed missed "
            "decisions (%d still pending)", shard, left,
        )

    def _broadcast_readmit_wid(self, wid: int) -> None:
        self._broadcast("readmit", wid)

    # -- cluster telemetry rollup (docs/OBSERVABILITY.md) --------------------

    def _scrape_targets_now(self):
        """(name, address) pairs to scrape this sweep: shard names are
        STABLE ids (``shard_<i>``), so the rollup's member labels survive
        elastic membership; extra targets (rendezvous shards, ...) ride
        under their caller-given names."""
        with self._admin_lock:
            shards = [(f"shard_{i}", tuple(a))
                      for i, a in enumerate(self._shard_addresses)]
        return shards + list(self._scrape_extra)

    def scrape_once(self) -> None:
        """One rollup sweep over every member's MSG_STATS (the scrape
        loop's body; callable directly for deterministic tests).  Scrape
        connections are SEPARATE from the admin clients: a sweep must not
        queue behind a rebalance episode, and a wedged member costs one
        socket timeout, never the admin lock."""
        if self.rollup is None:
            return
        targets = self._scrape_targets_now()
        t0 = time.monotonic()
        if self._scrape_iq is not None:
            self._scrape_iq.note_enqueue(len(targets))
            self._scrape_iq.set_depth(len(targets))
        for i, (name, addr) in enumerate(targets):
            c = self._scrape_clients.get(name)
            try:
                if c is None:
                    c = PSClient(addr, self.dim, timeout=self._timeout)
                    self._scrape_clients[name] = c
                self.rollup.update(name, c.stats())
            except (ConnectionError, OSError, RuntimeError,
                    ValueError) as e:
                if c is not None:
                    try:
                        c.close()
                    except OSError:
                        pass
                self._scrape_clients[name] = None
                self.rollup.mark_down(name, e)
                # a down member is work this sweep refused to finish
                if self._scrape_iq is not None:
                    self._scrape_iq.note_drop()
            if self._scrape_iq is not None:
                self._scrape_iq.set_depth(len(targets) - i - 1)
        if self._scrape_iq is not None:
            self._scrape_iq.note_wait(time.monotonic() - t0)
        if self._ring_watch is not None:
            self._ring_watch.sample()

    def _scrape_loop(self) -> None:
        while not self._scrape_stop.wait(self.scrape_period_s):
            try:
                self.scrape_once()
            except Exception:
                # the rollup must never take the control plane down
                logging.getLogger(__name__).debug(
                    "cluster scrape sweep failed", exc_info=True)

    def stragglerz(self) -> dict:
        """The straggler-attribution verdict over the current rollup —
        the ``/stragglerz`` ops route's payload (obs/cluster.py)."""
        if self.rollup is None:
            return {"error": "cluster scrape loop not armed "
                             "(set scrape_period_s)"}
        return attribute_stragglers(self.rollup.members())

    def qualityz(self) -> dict:
        """Cluster-wide model-quality rollup — per-member calibration/
        AUC/drift series merged from the scraped snapshots, the
        ``/qualityz`` ops route's payload (obs/quality.py)."""
        if self.rollup is None:
            return {"error": "cluster scrape loop not armed "
                             "(set scrape_period_s)"}
        return quality_rollup(self.rollup.members())

    def resourcez(self) -> dict:
        """Cluster-wide resource rollup — per-member ``resource_*``
        series merged from the scraped snapshots plus the fullest-queue
        and most-compiles verdicts, the ``/resourcez`` ops route's
        payload on the master (obs/resources.py)."""
        if self.rollup is None:
            return {"error": "cluster scrape loop not armed "
                             "(set scrape_period_s)"}
        return obs_resources.resource_rollup(self.rollup.members())

    def devicez(self) -> dict:
        """Cluster-wide device rollup — per-member ``device_*`` program/
        census/donation series merged from the scraped snapshots plus the
        lowest-utilization, donation-miss and biggest-live-buffer
        verdicts, the ``/devicez`` ops route's payload on the master
        (obs/device.py)."""
        if self.rollup is None:
            return {"error": "cluster scrape loop not armed "
                             "(set scrape_period_s)"}
        return obs_device.device_rollup(self.rollup.members())

    def close(self) -> None:
        self.monitor.stop()
        if self._scrape_thread is not None:
            self._scrape_stop.set()
            self._scrape_thread.join(timeout=2.0)
            self._scrape_thread = None
        if self.rollup is not None:
            # unhook only OUR registrations: a newer scrape-armed master
            # may have taken the global names over since (latest wins)
            if obs_exporter.json_routes().get("/stragglerz") \
                    == self.stragglerz:
                obs_exporter.unregister_json_route("/stragglerz")
            if obs_exporter.json_routes().get("/qualityz") \
                    == self.qualityz:
                obs_exporter.unregister_json_route("/qualityz")
            if obs_exporter.json_routes().get("/resourcez") \
                    == self.resourcez:
                obs_exporter.unregister_json_route("/resourcez")
            if obs_exporter.json_routes().get("/devicez") \
                    == self.devicez:
                obs_exporter.unregister_json_route("/devicez")
            if obs_flight.registered_registries().get("cluster") \
                    is self.rollup:
                obs_flight.unregister_registry("cluster")
        if self._ring_watch is not None:
            self._ring_watch.close()
            self._ring_watch = None
        if self._scrape_iq is not None:
            self._scrape_iq.close()
            self._scrape_iq = None
        for c in self._scrape_clients.values():
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass
        for c in self._shards:
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass
        self._svc.close()
        self.health.close()
