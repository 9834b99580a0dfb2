"""Cluster-wide telemetry rollup + straggler attribution.

The port's copy of ``lightctr_tpu/obs/cluster.py``.  Telemetry, tracing
and health are all per-process:
every member of a run buffers its own registry and serves it over
``MSG_STATS`` (or its own ops exporter), but nothing merges the cluster
into ONE scrape — and nothing can rank which member is dragging a
rendezvous round.  This module is that missing aggregation layer:

  - :class:`ClusterRollup` — per-member ``MSG_STATS`` snapshots merged
    into one member-labeled registry view.  It duck-types
    ``snapshot()``, so the master registers it with the flight recorder
    like a real registry and the ops exporter's ``/metrics`` then serves
    the whole cluster (``lightctr_ps_pushes_total{member="shard_0"}``)
    from the master process.  A member whose scrape FAILS is marked
    ``scrape_down`` — it stays visible (``cluster_member_up{member=...}
    0`` plus the error in the members view, the down-shard shape of the
    sharded PS client)
    instead of silently vanishing from the rollup.
  - :func:`attribute_stragglers` — the verdict behind the master's
    ``/stragglerz`` route and ``tools/metrics_report.py --cluster``:
    ranks HOSTS by their round-wait contribution (the rendezvous shards'
    per-host ``hier_round_wait_seconds`` histograms, dist/hier.py) and
    MEMBERS by step-time skew (each member's ``trainer_step_seconds``
    mean against the cluster median).

The scrape loop lives on :class:`~lightctr_tpu_torch.dist.master.MasterService`
(``scrape_period_s=``): the master already owns the member list and the
admin wire, so cluster aggregation rides the same role that owns
liveness.  See docs/OBSERVABILITY.md "Cluster rollup & stall diagnosis".
"""

from __future__ import annotations

import re
import statistics
import threading
import time
from typing import Dict, List, Optional

from lightctr_tpu_torch.obs.registry import (
    MetricsRegistry,
    _split_series,
    escape_label_value,
    histogram_quantile,
    labeled,
)

#: every series this module writes — the AST lint in
#: tests/test_torch_hier.py pins emissions to this declaration (both
#: directions), the same contract as EXCHANGE_SERIES / HEALTH_SERIES
CLUSTER_SERIES = (
    "cluster_member_up",              # gauge {member} — 1 scraped, 0 down
    "cluster_scrapes_total",          # counter {member}
    "cluster_scrape_failures_total",  # counter {member}
    "cluster_last_scrape_ts",         # gauge — wall time of the last sweep
)


def _member_series(name: str, member: str) -> str:
    """Inject a ``member`` label into a (possibly already-labeled) series
    key — the relabeling every scraped series gets in the merged view."""
    base, inner = _split_series(name)
    mem = f'member="{escape_label_value(member)}"'
    return (f"{base}{{{mem},{inner}}}" if inner
            else f"{base}{{{mem}}}")


def _label_value(inner: str, key: str) -> Optional[str]:
    m = re.search(rf'{key}="((?:[^"\\]|\\.)*)"', inner)
    return m.group(1) if m else None


class ClusterRollup:
    """Member-labeled merged view over per-member stats snapshots.

    ``update(member, stats)`` accepts a ``MSG_STATS`` reply (snapshot
    under ``"telemetry"``) or a bare registry snapshot;
    ``mark_down(member, error)`` records a failed scrape WITHOUT dropping
    the member.  ``snapshot()`` matches the
    :class:`~lightctr_tpu_torch.obs.registry.MetricsRegistry` read surface, so
    a rollup registers with ``obs.flight.register_registry`` and rides
    ``/metrics`` / flight bundles unchanged."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        # the rollup's OWN series (scrape health) live in a private
        # registry so they merge into snapshot() like any member's
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._members: Dict[str, Dict] = {}

    def update(self, member: str, stats: Dict) -> None:
        member = str(member)
        snap: Dict = {}
        if isinstance(stats, dict):
            telem = stats.get("telemetry")
            if isinstance(telem, dict):
                snap = telem
            elif "counters" in stats or "gauges" in stats \
                    or "histograms" in stats:
                snap = stats
        entry = {
            "member": member, "scrape_down": False, "ts": time.time(),
            "stats": stats, "snapshot": snap,
        }
        with self._lock:
            self._members[member] = entry
        reg = self.registry
        reg.gauge_set(labeled("cluster_member_up", member=member), 1)
        reg.inc(labeled("cluster_scrapes_total", member=member))
        reg.gauge_set("cluster_last_scrape_ts", entry["ts"])

    def mark_down(self, member: str, error) -> None:
        """A failed scrape: the member is marked — never dropped — so the
        rollup can say "unreachable" instead of pretending zero traffic
        (the sharded client's down-shard stats shape)."""
        member = str(member)
        now = time.time()
        with self._lock:
            prev = self._members.get(member) or {}
            self._members[member] = {
                "member": member, "scrape_down": True, "ts": now,
                "error": str(error), "stats": None, "snapshot": {},
                "last_ok_ts": (prev.get("ts") if not prev.get("scrape_down")
                               else prev.get("last_ok_ts")),
            }
        reg = self.registry
        reg.gauge_set(labeled("cluster_member_up", member=member), 0)
        reg.inc(labeled("cluster_scrape_failures_total", member=member))
        reg.gauge_set("cluster_last_scrape_ts", now)

    def members(self) -> Dict[str, Dict]:
        """JSON-ready per-member view (newest scrape or the scrape_down
        marker) — the :func:`attribute_stragglers` input."""
        with self._lock:
            return {m: dict(e) for m, e in self._members.items()}

    def snapshot(self, reset: bool = False) -> Dict:
        """The merged member-labeled snapshot: the rollup's own
        ``cluster_*`` series plus every live member's series relabeled
        with ``member="..."``.  ``reset`` is accepted for registry
        duck-typing and ignored — the members own their counters."""
        del reset
        out = self.registry.snapshot()
        with self._lock:
            live = [(m, e["snapshot"]) for m, e in self._members.items()
                    if not e.get("scrape_down") and e.get("snapshot")]
        for member, snap in live:
            for kind in ("counters", "gauges"):
                for name, v in (snap.get(kind) or {}).items():
                    out[kind][_member_series(name, member)] = v
            for name, h in (snap.get("histograms") or {}).items():
                out["histograms"][_member_series(name, member)] = h
        return out


def attribute_stragglers(members: Dict[str, Dict], top: int = 10) -> Dict:
    """The straggler verdict over a rollup members view ({member ->
    entry with ``snapshot``/``scrape_down``}):

    - **hosts** ranked by round-wait contribution: the rendezvous
      shards' ``hier_round_wait_seconds{host=...}`` histograms record
      each contributor's arrival offset behind the round's FIRST push
      (dist/hier.py), so summing them across shards names the host every
      round waits for.
    - **members** with step-time mean and skew (mean / cluster median of
      ``trainer_step_seconds``) — the worker-side mirror of the same
      question.  Scrape-down members ride along marked, never dropped.
    """
    hosts: Dict[str, Dict] = {}
    member_rows: List[Dict] = []
    step_means: Dict[str, float] = {}
    for member, entry in sorted(members.items()):
        if entry.get("scrape_down"):
            member_rows.append({"member": member, "scrape_down": True,
                                "error": entry.get("error")})
            continue
        snap = entry.get("snapshot") or {}
        hists = snap.get("histograms") or {}
        row: Dict = {"member": member, "scrape_down": False}
        for name, h in hists.items():
            base, inner = _split_series(name)
            if base != "hier_round_wait_seconds":
                continue
            host = _label_value(inner, "host") or "?"
            agg = hosts.setdefault(host, {
                "host": host, "arrivals": 0, "wait_total_s": 0.0,
                "wait_p99_s": 0.0,
            })
            agg["arrivals"] += int(h.get("count", 0))
            agg["wait_total_s"] += float(h.get("sum", 0.0))
            agg["wait_p99_s"] = max(agg["wait_p99_s"],
                                    histogram_quantile(h, 0.99))
        st = hists.get("trainer_step_seconds")
        if st and st.get("count"):
            mean = float(st["sum"]) / int(st["count"])
            row["steps"] = int(st["count"])
            row["step_mean_s"] = round(mean, 6)
            step_means[member] = mean
        member_rows.append(row)

    if step_means:
        med = statistics.median(step_means.values())
        for row in member_rows:
            if "step_mean_s" in row and med > 0:
                row["step_skew"] = round(row["step_mean_s"] / med, 3)

    host_rows = sorted(hosts.values(), key=lambda h: -h["wait_total_s"])
    for h in host_rows:
        h["wait_total_s"] = round(h["wait_total_s"], 6)
        h["wait_p99_s"] = round(h["wait_p99_s"], 6)
        h["wait_mean_s"] = round(
            h["wait_total_s"] / h["arrivals"], 6) if h["arrivals"] else 0.0
    member_rows.sort(key=lambda r: -r.get("step_skew", 0.0))

    verdict: Dict = {}
    if host_rows:
        verdict["slowest_host"] = host_rows[0]["host"]
        verdict["slowest_host_wait_s"] = host_rows[0]["wait_total_s"]
    skewed = [r for r in member_rows if "step_skew" in r]
    if skewed:
        verdict["slowest_member"] = skewed[0]["member"]
        verdict["slowest_member_skew"] = skewed[0]["step_skew"]
    return {
        "hosts": host_rows[:top],
        "members": member_rows,
        "scrape_down": sorted(r["member"] for r in member_rows
                              if r.get("scrape_down")),
        "verdict": verdict,
    }
