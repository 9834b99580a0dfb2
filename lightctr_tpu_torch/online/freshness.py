"""Push-based serving freshness: write-log subscription -> cache deltas,
the port's counterpart of ``lightctr_tpu/online/freshness.py``.

The serving cache invalidates per key, but a server that polls
``write_version`` every ``version_poll_s`` DISCOVERS writes late —
bounded staleness, paid for in poll latency.  This module closes the loop
push-side (docs/ONLINE.md): a :class:`FreshnessSubscriber` parks one
long-poll per PS shard on the new ``MSG_SUBSCRIBE`` wire op, so a trained
key reaches :meth:`HotEmbeddingCache.apply_delta` one notify after the
push lands instead of at the next poll tick.

Degrade ladder (freshness may degrade, correctness may not):

  - a shard whose store lacks the write-log surface (both shipped stores
    carry it — this rung covers only stores that disable it or lack the
    mixin) answers the protocol-error byte ->
    the subscriber falls back to ``MSG_STATS`` **polling** for that
    shard, consuming the same ``write_delta`` record the poll path
    always used;
  - a reply whose log FLOOR advanced past this replica's observation
    (the subscriber fell off the bounded log) -> **full cache drop**,
    exactly as the polling path degrades;
  - an unreachable shard -> full drop + backoff + reconnect (recovery
    re-arms from the shard's current version, another full drop).

The subscriber also owns the freshness *measurement*: every applied
write-log entry carries the server-stamped wall time of the write AND
every reply carries ``server_time`` — the server's clock at reply — so
apply ages are computed SERVER-relative (``server_time - write ts``,
both stamps from one clock) and cross-host wall-clock skew cancels
instead of polluting the measurement.  The number
feeds the :class:`~lightctr_tpu_torch.obs.health.FreshnessSLODetector` — the
serving replica's ``/healthz`` degrades when serving lags training,
whether the lag is a wedged subscriber or a stalled trainer.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from lightctr_tpu_torch.dist.ps_server import ProtocolRejection, PSClient
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs import health as obs_health
from lightctr_tpu_torch.obs.registry import labeled

_LOG = logging.getLogger(__name__)

#: "tell me your current version, do not wait": a since value no real
#: write_version reaches, used to ARM a shard slot without consuming the
#: whole log as a delta
_ARM_SINCE = 1 << 62


class FreshnessSubscriber:
    """Per-shard write-log subscription driving a PredictionServer's
    hot-embedding cache (one daemon thread per PS shard).

    ``server``: the :class:`~lightctr_tpu_torch.serve.server.PredictionServer`
    whose cache/registry/health this subscriber feeds (the server should
    run with ``version_poll_s=0`` — subscription replaces polling).
    ``addresses``: the PS shard addresses (the same list the server's
    ``ps`` client talks to).  ``slo_s``: the freshness SLO fed to the
    :class:`~lightctr_tpu_torch.obs.health.FreshnessSLODetector` installed on
    the server's monitor.  ``poll_ms``: client-side long-poll budget per
    round trip (the server caps its own wait at
    :data:`~lightctr_tpu_torch.dist.ps_server.SUBSCRIBE_MAX_WAIT_S`).
    ``degraded_poll_s``: cadence of the stats-poll fallback and of
    reconnect attempts.
    """

    def __init__(
        self,
        server,
        addresses,
        dim: int,
        slo_s: float = 10.0,
        hard_slo_factor: float = 3.0,
        poll_ms: int = 2000,
        degraded_poll_s: float = 0.5,
    ):
        if server.cache is None:
            raise ValueError(
                "server has no hot-embedding cache to keep fresh"
            )
        self.cache = server.cache
        self.registry = server.registry
        self.health = server.health
        self.health.ensure_detector(obs_health.FreshnessSLODetector(
            slo_s=slo_s, hard_factor=hard_slo_factor,
        ))
        self.addresses = [tuple(a) for a in addresses]
        self.dim = int(dim)
        self.poll_ms = int(poll_ms)
        self.degraded_poll_s = float(degraded_poll_s)
        n = len(self.addresses)
        self._lock = threading.Lock()
        self._since: List[Optional[int]] = [None] * n
        self._mode = ["subscribe"] * n
        self._clients: List[Optional[PSClient]] = [None] * n
        self._last_update_ts: Optional[float] = None
        self.applied_entries = 0
        self.dropped_rows = 0
        self.full_refreshes = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FreshnessSubscriber":
        if self._threads:
            return self
        for i in range(len(self.addresses)):
            t = threading.Thread(
                target=self._run, args=(i,), daemon=True,
                name=f"freshness-sub-{i}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        # close the transports so a parked long-poll wakes with an error
        # instead of riding out its full timeout
        for i, c in enumerate(self._clients):
            if c is not None:
                try:
                    c._sock.close()
                except OSError:
                    pass
        for t in self._threads:
            t.join(timeout=self.poll_ms / 1e3 + 2.0)
        self._threads = []

    close = stop

    # -- the per-shard loop --------------------------------------------------

    def _run(self, i: int) -> None:
        while not self._stop.is_set():
            cli = self._clients[i]
            if cli is None:
                try:
                    cli = PSClient(
                        self.addresses[i], self.dim,
                        timeout=self.poll_ms / 1e3 + 5.0,
                    )
                    self._clients[i] = cli
                except OSError:
                    self._degrade(i, "down")
                    self._stop.wait(self.degraded_poll_s)
                    continue
            try:
                if self._mode[i] == "subscribe":
                    since = self._since[i]
                    # arming (since unknown) must NOT long-poll: the
                    # sentinel never satisfies the wait, and a write
                    # landing inside the parked window would degrade the
                    # very first delta into a full drop
                    rep = cli.subscribe_deltas(
                        _ARM_SINCE if since is None else since,
                        timeout_ms=0 if since is None else self.poll_ms,
                    )
                else:
                    rep = self._delta_from_stats(cli.stats(), i)
            except ProtocolRejection:
                # store without the write-log surface: permanent (for
                # this shard) degrade to stats polling — same consumer,
                # pull cadence instead of push latency
                self._mode[i] = "stats_poll"
                continue
            except (ConnectionError, OSError, ValueError):
                if self._stop.is_set():
                    return
                try:
                    cli._sock.close()
                except OSError:
                    pass
                self._clients[i] = None
                self._degrade(i, "down")
                self._stop.wait(self.degraded_poll_s)
                continue
            self._apply(i, rep)
            self._feed_health()
            if self._mode[i] == "stats_poll":
                self._stop.wait(self.degraded_poll_s)
        cli = self._clients[i]
        if cli is not None:
            try:
                cli.close()
            except OSError:
                pass

    def _delta_from_stats(self, st: Dict, i: int) -> Dict:
        """Shape a MSG_STATS reply like a subscribe reply: the stats op
        has always carried ``write_version`` (+ ``write_delta`` on stores
        with the log).  The subscribe path's ``covered`` is computed
        server-side against the request's since; here the client must do
        it — a shard whose log FLOOR advanced past this replica's last
        observation does not cover it, and only the full drop is safe."""
        wd = st.get("write_delta") or {}
        since = self._since[i]
        floor = int(wd.get("floor", 1 << 62))
        return {
            "write_version": int(st.get("write_version", -1)),
            "floor": floor,
            "covered": "entries" in wd and (since is None
                                            or since >= floor),
            "entries": wd.get("entries", []),
            # the server clock that stamped the entry ts values rides the
            # write_delta record too, so the poll path ages updates
            # server-relative exactly like the subscribe path
            "server_time": wd.get("server_time"),
        }

    # -- applying deltas -----------------------------------------------------

    def _version_tuple(self) -> tuple:
        return tuple(-1 if v is None else int(v) for v in self._since)

    def _degrade(self, i: int, reason: str) -> None:
        """Unreachable/uncovered shard: the only safe move is the full
        drop (bounded staleness never rides on subscription health)."""
        with self._lock:
            had = self._since[i] is not None
            self._since[i] = None
            version = self._version_tuple()
            if had:
                self.cache.set_version(version)
                self.full_refreshes += 1
                self._last_update_ts = time.time()
        if had and obs_gate.enabled():
            self.registry.inc(labeled(
                "serve_freshness_full_refresh_total", reason=reason,
            ))

    def _apply(self, i: int, rep: Dict) -> None:
        telem = obs_gate.enabled()
        if telem:
            self.registry.inc("serve_freshness_polls_total")
        wv = int(rep.get("write_version", -1))
        now = time.time()
        with self._lock:
            prev = self._since[i]
            self._since[i] = wv
            version = self._version_tuple()
            if prev is None:
                # first observation arms this shard's slot: the cache
                # baseline moves (a recovery re-arm already dropped
                # everything in _degrade; a fresh start only arms)
                self.cache.set_version(version)
                return
            if wv <= prev:
                return  # idle long-poll timeout: nothing new
            if not rep.get("covered", False):
                # fell off the log floor: this replica's observation
                # predates what the log still covers — full drop
                self.cache.set_version(version)
                self.full_refreshes += 1
                self._last_update_ts = now
                if telem:
                    self.registry.inc(labeled(
                        "serve_freshness_full_refresh_total",
                        reason="floor",
                    ))
                return
            uids: list = []
            applied = 0
            newest_ts = None
            # apply ages are SERVER-relative when the reply carries the
            # server clock (the same clock that stamped the entry ts
            # values — cross-host wall-clock skew cancels); only an old
            # server's reply falls back to comparing raw wall clocks
            server_now = rep.get("server_time")
            ref_now = float(server_now) if server_now is not None else now
            for entry in rep.get("entries", ()):
                if int(entry[0]) <= prev:
                    continue
                uids.extend(entry[1])
                ts = float(entry[2]) if len(entry) > 2 else ref_now
                newest_ts = ts if newest_ts is None else max(newest_ts, ts)
                applied += 1
                if telem:
                    self.registry.observe(
                        "serve_freshness_apply_age_seconds",
                        max(0.0, ref_now - ts),
                    )
            dropped = self.cache.apply_delta(version, uids)
            self.applied_entries += applied
            self.dropped_rows += dropped
            # _last_update_ts lives on the LOCAL clock (age_s compares it
            # to local time.time()): translate the newest write's
            # server-relative age into local terms instead of storing a
            # remote wall clock verbatim
            if newest_ts is None:
                self._last_update_ts = now
            elif server_now is not None:
                self._last_update_ts = now - max(0.0, ref_now - newest_ts)
            else:
                self._last_update_ts = newest_ts
        if telem:
            self.registry.inc(
                "serve_freshness_deltas_applied_total", applied)
            if dropped:
                self.registry.inc(
                    "serve_freshness_rows_dropped_total", dropped)

    # -- the freshness measurement -------------------------------------------

    def age_s(self) -> Optional[float]:
        """Age of the newest update this replica applied (None until the
        first one — an online plane that has not seen training yet is
        unarmed, not stale)."""
        with self._lock:
            lt = self._last_update_ts
        return None if lt is None else max(0.0, time.time() - lt)

    def _feed_health(self) -> None:
        age = self.age_s()
        if age is None:
            return
        if obs_gate.enabled():
            self.registry.gauge_set("serve_freshness_age_seconds", age)
        self.health.observe(freshness={
            "age_s": age,
            "applied": self.applied_entries,
            "full_refreshes": self.full_refreshes,
        })

    # -- reads ---------------------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            return {
                "shards": len(self.addresses),
                "modes": list(self._mode),
                "versions": self._version_tuple(),
                "applied_entries": self.applied_entries,
                "dropped_rows": self.dropped_rows,
                "full_refreshes": self.full_refreshes,
                "last_update_ts": self._last_update_ts,
            }
