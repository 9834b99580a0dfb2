"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The reference ships its operational numbers as DEBUG printf lines and
ad-hoc per-module counters (SURVEY §5); this is the TPU-repo successor: one
thread-safe registry whose increments are cheap enough for host callbacks
and runloop threads, with a snapshot/reset cycle for scraping.

Design points:

  - **Names are the series key.**  A metric name may carry baked-in
    Prometheus labels (``ps_op_seconds{op="pull"}``, built with
    :func:`labeled`), so the registry itself stays a flat dict — no label
    cartesian bookkeeping on the hot path, and :func:`render_prometheus`
    emits the stored key verbatim.
  - **Histograms are fixed-bucket** (cumulative-style counts plus sum and
    count), so merging shard snapshots is elementwise addition and
    quantiles come from :func:`histogram_quantile` — the standard
    bucket-interpolation estimator.
  - **Snapshots are plain JSON types** (ints/floats/lists), so they ride
    the PS ``MSG_STATS`` wire op unchanged and aggregate cluster-wide with
    :func:`merge_snapshots`.

Per-shard isolation: every :class:`~lightctr_tpu_torch.embed.async_ps.AsyncParamServer`
owns its own registry (so N shards hosted in one test process still report
distinct snapshots); trainers and clients default to the process-wide
:func:`default_registry`.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence

# log-spaced seconds buckets, ~10us .. 10s: wide enough for a socket RPC
# and a full trainer step on the same scale
DEFAULT_TIME_BUCKETS_S: tuple = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def escape_label_value(value) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote, and newline must be escaped or the scrape line is corrupt.
    Applied where values are BAKED into series names (:func:`labeled`),
    so snapshot keys stay parseable and :func:`render_prometheus` can
    emit them verbatim — member addresses like ``127.0.0.1:5555`` and
    error strings flow into labels via the cluster rollup
    (obs/cluster.py)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def labeled(name: str, **labels) -> str:
    """Bake Prometheus labels into a series name:
    ``labeled("x_total", op="pull")`` -> ``x_total{op="pull"}``.
    Labels are sorted so the same label set always yields the same key;
    values are exposition-escaped (:func:`escape_label_value`)."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{escape_label_value(labels[k])}"' for k in sorted(labels)
    )
    return f"{name}{{{inner}}}"


def _jsonable(v: float):
    """ints stay ints in snapshots (byte counters should not render 1792.0)."""
    f = float(v)
    return int(f) if f.is_integer() else f


class _Histogram:
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float]):
        self.edges: List[float] = sorted(float(e) for e in edges)
        if not self.edges:
            raise ValueError("histogram needs at least one bucket edge")
        # counts[i] = observations <= edges[i]; counts[-1] = +Inf overflow
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.edges, value)] += 1
        self.sum += value
        self.count += 1


class MetricsRegistry:
    """Thread-safe counters / gauges / fixed-bucket histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}

    # -- writes (hot path) --------------------------------------------------

    def inc(self, name: str, value: float = 1.0) -> None:
        """Monotonic counter add."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: float) -> None:
        """Point-in-time gauge."""
        with self._lock:
            self._gauges[name] = float(value)

    def observe(
        self, name: str, value: float,
        buckets: Optional[Sequence[float]] = None,
    ) -> None:
        """Histogram observation; ``buckets`` fixes the edges on FIRST use
        of a name (later calls reuse them — fixed-bucket by design)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = _Histogram(buckets or DEFAULT_TIME_BUCKETS_S)
                self._hists[name] = h
            h.observe(value)

    # -- reads --------------------------------------------------------------

    def snapshot(self, reset: bool = False) -> Dict:
        """JSON-ready state dump; ``reset=True`` zeroes counters/histograms
        (gauges keep their last value) atomically with the read."""
        with self._lock:
            snap = {
                "counters": {k: _jsonable(v)
                             for k, v in self._counters.items()},
                "gauges": {k: _jsonable(v) for k, v in self._gauges.items()},
                "histograms": {
                    k: {
                        "le": list(h.edges),
                        "counts": list(h.counts),
                        "sum": h.sum,
                        "count": h.count,
                    }
                    for k, h in self._hists.items()
                },
            }
            if reset:
                self._counters.clear()
                self._hists.clear()
            return snap

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (trainers, clients, tools)."""
    return _default


# -- aggregation / exposition ----------------------------------------------


def merge_snapshots(snapshots: Iterable[Dict]) -> Dict:
    """Cluster-wide aggregate of per-shard snapshots: counters and histogram
    buckets add elementwise; gauges ADD too (depths/backlogs across shards
    sum into the cluster total — scrape per shard when you need one node's
    level).  Histograms under the same name must share bucket edges."""
    out: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        if not snap:
            continue
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = _jsonable(out["counters"].get(k, 0) + v)
        for k, v in snap.get("gauges", {}).items():
            out["gauges"][k] = _jsonable(out["gauges"].get(k, 0) + v)
        for k, h in snap.get("histograms", {}).items():
            acc = out["histograms"].get(k)
            if acc is None:
                out["histograms"][k] = {
                    "le": list(h["le"]), "counts": list(h["counts"]),
                    "sum": h["sum"], "count": h["count"],
                }
                continue
            if acc["le"] != list(h["le"]):
                raise ValueError(
                    f"histogram {k!r}: bucket edges differ across shards"
                )
            acc["counts"] = [a + b for a, b in zip(acc["counts"], h["counts"])]
            acc["sum"] += h["sum"]
            acc["count"] += h["count"]
    return out


def histogram_quantile(hist: Dict, q: float) -> float:
    """Prometheus-style quantile estimate from a snapshot histogram dict
    (linear interpolation inside the winning bucket; the +Inf bucket clamps
    to the last finite edge)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    edges, counts = hist["le"], hist["counts"]
    total = hist["count"]
    if total == 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank and c:
            if i >= len(edges):          # +Inf bucket
                return float(edges[-1])
            lo = edges[i - 1] if i else 0.0
            hi = edges[i]
            frac = min(1.0, max(0.0, (rank - prev_cum) / c))
            return float(lo + (hi - lo) * frac)
    return float(edges[-1])


def _split_series(name: str):
    """``base{labels}`` -> (base, 'labels') — '' when unlabeled."""
    if name.endswith("}") and "{" in name:
        base, inner = name.split("{", 1)
        return base, inner[:-1]
    return name, ""


def render_prometheus(snapshot: Dict, prefix: str = "") -> str:
    """Snapshot -> Prometheus text exposition format.  Histograms render
    the standard cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``
    triple; labels baked into series names pass through."""
    lines: List[str] = []
    typed: set = set()

    def emit_type(base: str, kind: str):
        if base not in typed:
            lines.append(f"# TYPE {prefix}{base} {kind}")
            typed.add(base)

    for kind_name, kind in (("counters", "counter"), ("gauges", "gauge")):
        for name in sorted(snapshot.get(kind_name, {})):
            base, labels = _split_series(name)
            emit_type(base, kind)
            series = f"{prefix}{base}" + (f"{{{labels}}}" if labels else "")
            lines.append(f"{series} {snapshot[kind_name][name]}")
    for name in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][name]
        base, labels = _split_series(name)
        emit_type(base, "histogram")
        cum = 0
        for edge, c in zip(h["le"] + ["+Inf"], h["counts"]):
            cum += c
            lab = f'le="{edge}"' if not labels else f'{labels},le="{edge}"'
            lines.append(f"{prefix}{base}_bucket{{{lab}}} {cum}")
        tail = f"{{{labels}}}" if labels else ""
        lines.append(f"{prefix}{base}_sum{tail} {h['sum']}")
        lines.append(f"{prefix}{base}_count{tail} {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
