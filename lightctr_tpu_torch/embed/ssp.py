"""Shared SSP gate + liveness-routing semantics for PS stores.

The staleness ledger (paramserver.h:189-205), heartbeat-driven worker
routing (master.h:202-262), and the rebalance grace window are
semantics-critical and IDENTICAL for every store behind the
``ParamServerService`` wire — the flat ``AsyncParamServer`` and the
``TieredEmbeddingStore`` both inherit this mixin so a future fix to the
staleness accounting cannot silently diverge SSP behavior between
deployments.

Host-class contract: ``_lock``, ``_unrouted`` (set), the gate counters
(``rejected_pulls``/``rejected_pushes``/``withheld_pulls``/
``dropped_pushes``), the staleness ledger fields (``staleness``,
``staleness_worker``, ``staleness_threshold``,
``_base_staleness_threshold``, ``last_epoch_version``), ``health``, and
``registry``.
"""

from __future__ import annotations

from typing import Optional

from lightctr_tpu_torch.obs import gate as obs_gate


class SSPGateMixin:
    """SSP pull/push gates + worker routing + staleness grace, shared by
    every store hosted behind the PS wire."""

    # -- SSP gates (paramserver.h:189-205) ----------------------------------

    def _pull_gate(self, worker_epoch: int,
                   worker_id: Optional[int]) -> bool:
        """True when the pull may proceed; bumps reject/withhold counters.
        Caller holds the lock."""
        if worker_id is not None and worker_id in self._unrouted:
            self.rejected_pulls += 1
            return False
        if (
            worker_epoch > self.last_epoch_version
            and self.staleness > self.staleness_threshold
        ):
            self.withheld_pulls += 1
            return False
        return True

    def _push_gate(self, worker_id: int, worker_epoch: int) -> bool:
        """Routing + staleness-ledger bookkeeping (paramserver.h:189-205);
        True when the push should apply.  Caller holds the lock."""
        if worker_id in self._unrouted:
            self.rejected_pushes += 1
            return False
        behind = self.last_epoch_version - worker_epoch
        if self.staleness > 0 and worker_id == self.staleness_worker:
            self.staleness = max(0, behind)
        if behind > self.staleness:
            self.staleness = behind
            self.staleness_worker = worker_id
        if worker_epoch + self.staleness_threshold < self.last_epoch_version:
            self.dropped_pushes += 1
            return False
        self.last_epoch_version = max(self.last_epoch_version, worker_epoch)
        return True

    # -- liveness routing (master.h:202-262 / network.h:148-151) ------------

    def unroute_worker(self, worker_id: int) -> None:
        """Heartbeat declared the worker dead: delete its route.  Its
        pushes and pulls are rejected until :meth:`readmit_worker`."""
        with self._lock:
            self._unrouted.add(int(worker_id))

    def readmit_worker(self, worker_id: int) -> None:
        """Returning node re-registered (master.h:80-82): restore its
        route.  Per-worker state the store kept (e.g. DCASGD shadows)
        stays, exactly as the PS keeps shadow_copies across
        re-registration."""
        with self._lock:
            self._unrouted.discard(int(worker_id))

    def attach_heartbeat(self, monitor) -> None:
        """Wire a :class:`~lightctr_tpu_torch.dist.bootstrap.HeartbeatMonitor`
        so its death/recovery events drive routing: dead -> unroute,
        returning beat -> readmit (shared wiring — see
        ``dist.bootstrap.wire_heartbeat``).  No upper id bound: push/pull
        accept any worker id here."""
        from lightctr_tpu_torch.dist.bootstrap import wire_heartbeat

        wire_heartbeat(monitor, self)

    # -- elastic membership (rebalance support) -----------------------------

    def set_staleness_grace(self, factor: float) -> None:
        """Widen (or restore) the SSP staleness budget for the duration of
        a rebalance: ``factor`` scales the BASE threshold (1.0 restores
        it).  The widened budget is fed to the health plane's existing
        staleness detector too — its SLO tracks the effective threshold,
        so an in-flight rebalance reads as a grace window, not a false
        staleness alarm (docs/ELASTICITY.md)."""
        if factor < 1.0:
            raise ValueError("grace factor must be >= 1.0")
        with self._lock:
            self.staleness_threshold = int(
                round(self._base_staleness_threshold * factor)
            )
            eff = self.staleness_threshold
        hm = self.health
        if hm is not None:
            # retune the existing detector instead of stacking a new one
            det = hm.detector("staleness")
            if det is not None:
                det.slo = float(eff)
        if obs_gate.enabled():
            self.registry.gauge_set("ps_store_staleness_budget", eff)
