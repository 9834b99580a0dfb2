"""Model-quality observability plane: streaming calibration, online AUC
and drift sketches, from ``lightctr_tpu/obs/quality.py``.

The systems planes (metrics, traces, health) say whether the machinery is
healthy; this module says whether the predictions are.

- **On-device sketch**: :func:`quality_sketch` turns a batch of predicted
  probabilities and labels into a fixed-size ``f32[4 * num_bins]`` vector
  (per-score-bucket example counts, label sums, probability sums and
  logloss sums) with ONE segment sum, ``ops.sparse_kernels.merge_rows``:
  the ``merge_rows`` kernel on a CUDA tensor, its plain version on the
  CPU, both in slot order, so an armed step stays bit-reproducible.  The
  trainers concatenate it onto the ``[loss, grad_norm]`` health vector,
  so it rides the health feed's event-gated drain: arming it never syncs
  the in-flight step.
- **Host accumulators**: :class:`QualityAccumulator` folds sketches into
  float64 totals and derives the per-bucket calibration table, the
  calibration ratio, the rank-statistic AUC over the positives/negatives
  histograms, and logloss.
- **Windows**: :class:`QualityTracker` rolls a window accumulator, freezes
  the first full window as the baseline (AUC, logloss, score
  distribution), tracks a logloss EWMA against it, and feeds the detectors
  below.
- **Label-free drift**: :class:`DriftMonitor` (the server's ``drift=``)
  sketches the live score distribution and per-field coverage histograms
  off the deduped uid streams, freezes a reference window, and scores live
  windows against it with PSI or symmetric KL.
- **Detectors**: :class:`CalibrationDetector`,
  :class:`AUCRegressionDetector` and :class:`DriftDetector` register into
  ``health.KNOWN_DETECTORS``; a trip degrades ``/healthz`` and the
  anomaly-time flight bundle carries the sketches (trackers register as
  ``quality:<component>`` flight registries).
- **Exports**: every tracker and monitor is a ``/qualityz`` provider;
  :func:`quality_rollup` extracts per-member quality series from a cluster
  rollup dump (host code; the master that scrapes it is not ported yet).
"""

from __future__ import annotations

import logging
import math
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from lightctr_tpu_torch.obs import exporter as exporter_mod
from lightctr_tpu_torch.obs import flight as flight_mod
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.obs.registry import MetricsRegistry, default_registry, labeled

_LOG = logging.getLogger("lightctr.obs.quality")

# Fine probability bins per sketch row.  512 keeps the on-device payload at
# 4 * 512 * 4B = 8 KiB per step while the rank-statistic AUC over 512 bins
# stays within ~1/512 of exact.
DEFAULT_BINS = 512
# Rows of the sketch matrix, in order.
SKETCH_ROWS = 4
_ROW_COUNT, _ROW_LABEL, _ROW_PROB, _ROW_LOGLOSS = range(SKETCH_ROWS)
_LL_EPS = 1e-7

# Every series this plane emits (both-directions AST lint in
# tests/test_torch_quality.py).
QUALITY_SERIES = (
    "quality_examples_total",
    "quality_windows_total",
    "quality_calibration_ratio",
    "quality_auc",
    "quality_logloss_ewma",
    "quality_logloss_baseline",
    "quality_drift_score",
    "quality_coverage_total",
)


def sketch_width(num_bins: int = DEFAULT_BINS) -> int:
    """Length of the flattened sketch vector for ``num_bins``."""
    return SKETCH_ROWS * int(num_bins)


def resolve_bins(explicit: Optional[int] = None) -> Optional[int]:
    """Sketch bin count for a trainer: an explicit ctor argument wins
    (``0`` forces off even when the env arms it); otherwise
    ``LIGHTCTR_QUALITY`` — ``1``/``true`` arms :data:`DEFAULT_BINS`, an
    integer arms that many bins, unset/falsy leaves the sketch off (and
    the health vector byte-identical to the unarmed layout)."""
    if explicit is not None:
        b = int(explicit)
        return b if b > 0 else None
    v = os.environ.get("LIGHTCTR_QUALITY", "").strip().lower()
    if v in ("", "0", "false", "off", "no"):
        return None
    if v in ("1", "true", "on", "yes"):
        return DEFAULT_BINS
    try:
        b = int(v)
    except ValueError:
        return DEFAULT_BINS
    return b if b > 0 else None


# -- on-device sketch --------------------------------------------------------


def quality_sketch(probs, labels, num_bins: int = DEFAULT_BINS):
    """Device-side quality sketch: ``f32[4 * num_bins]`` on the device of
    ``probs``.

    One segment sum over equal-width probability buckets of the stacked
    ``[ones, labels, probs, per-example logloss]`` rows (an [n, 4] block):
    ``ops.sparse_kernels.merge_rows``, which sums each bucket's rows in
    slot order (the ``merge_rows`` kernel on a CUDA tensor, its plain
    version on the CPU), so the sketch is the same run to run.  Row layout
    (flattened row-major): counts, label sums, probability sums, logloss
    sums.  Positives histogram == label sums; negatives == counts - label
    sums.
    """
    import torch

    from lightctr_tpu_torch.ops import sparse_kernels

    p = probs.reshape(-1).to(torch.float32)
    y = labels.reshape(-1).to(torch.float32)
    idx = torch.clamp((p * num_bins).to(torch.int32), 0, num_bins - 1)
    pc = torch.clamp(p, _LL_EPS, 1.0 - _LL_EPS)
    ll = -(y * torch.log(pc) + (1.0 - y) * torch.log1p(-pc))
    stacked = torch.stack([torch.ones_like(p), y, p, ll], dim=1)  # [n, 4]
    sums = sparse_kernels.merge_rows(stacked.contiguous(), idx,
                                     int(num_bins))
    return sums.t().reshape(-1)


def sketch_from_scores(probs, labels,
                       num_bins: int = DEFAULT_BINS) -> np.ndarray:
    """Host-side (NumPy) twin of :func:`quality_sketch`.

    Used by paths that already hold scores on the host, so they share one
    accumulator contract with the device feed.
    """
    p = np.asarray(probs, np.float64).reshape(-1)
    y = np.asarray(labels, np.float64).reshape(-1)
    idx = np.clip((p * num_bins).astype(np.int64), 0, num_bins - 1)
    pc = np.clip(p, _LL_EPS, 1.0 - _LL_EPS)
    ll = -(y * np.log(pc) + (1.0 - y) * np.log1p(-pc))
    out = np.zeros((SKETCH_ROWS, num_bins), np.float64)
    out[_ROW_COUNT] = np.bincount(idx, minlength=num_bins)
    out[_ROW_LABEL] = np.bincount(idx, weights=y, minlength=num_bins)
    out[_ROW_PROB] = np.bincount(idx, weights=p, minlength=num_bins)
    out[_ROW_LOGLOSS] = np.bincount(idx, weights=ll, minlength=num_bins)
    return out.reshape(-1)


# -- histogram statistics ----------------------------------------------------


def auc_from_counts(pos: np.ndarray, neg: np.ndarray) -> float:
    """Rank-statistic AUC from per-bucket positive/negative counts.

    ``P(score_pos > score_neg) + 0.5 * P(equal)``, swept over buckets in
    ascending score order — the streaming estimate is exact up to
    within-bucket ties (error bounded by the bin width).
    """
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    n_pos = float(pos.sum())
    n_neg = float(neg.sum())
    if n_pos <= 0.0 or n_neg <= 0.0:
        return float("nan")
    cum_neg = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    num = float(np.sum(pos * (cum_neg + 0.5 * neg)))
    return num / (n_pos * n_neg)


def _normalize(hist: np.ndarray, eps: float) -> np.ndarray:
    h = np.asarray(hist, np.float64) + eps
    return h / h.sum()


def psi(ref, live, eps: float = 1e-4) -> float:
    """Population Stability Index between two histograms.

    Standard credit-scoring bands: < 0.1 stable, 0.1-0.25 shifting,
    > 0.25 drifted (the detector defaults sit at 0.2 / 0.5).
    """
    r = _normalize(ref, eps)
    l = _normalize(live, eps)
    return float(np.sum((l - r) * np.log(l / r)))


def symmetric_kl(ref, live, eps: float = 1e-4) -> float:
    """Symmetric (Jeffreys) KL divergence between two histograms."""
    r = _normalize(ref, eps)
    l = _normalize(live, eps)
    return 0.5 * float(np.sum(r * np.log(r / l)) + np.sum(l * np.log(l / r)))


DRIFT_METHODS: Dict[str, Callable[..., float]] = {
    "psi": psi,
    "sym_kl": symmetric_kl,
}


def fold_hist(hist: np.ndarray, buckets: int) -> np.ndarray:
    """Fold a fine histogram into ``buckets`` coarse buckets (sum-pool)."""
    h = np.asarray(hist, np.float64).reshape(-1)
    n = h.shape[0]
    buckets = max(1, min(int(buckets), n))
    if n % buckets:
        pad = buckets - (n % buckets)
        h = np.concatenate([h, np.zeros(pad)])
    return h.reshape(buckets, -1).sum(axis=1)


# -- host accumulators -------------------------------------------------------


class QualityAccumulator:
    """Float64 fold of quality sketches + the statistics derived from it."""

    def __init__(self, num_bins: int = DEFAULT_BINS):
        self.num_bins = int(num_bins)
        self.rows = np.zeros((SKETCH_ROWS, self.num_bins), np.float64)
        self.updates = 0

    @property
    def count(self) -> float:
        return float(self.rows[_ROW_COUNT].sum())

    @property
    def counts(self) -> np.ndarray:
        return self.rows[_ROW_COUNT]

    @property
    def pos_hist(self) -> np.ndarray:
        return self.rows[_ROW_LABEL]

    @property
    def neg_hist(self) -> np.ndarray:
        return self.rows[_ROW_COUNT] - self.rows[_ROW_LABEL]

    def update(self, sketch) -> None:
        sk = np.asarray(sketch, np.float64).reshape(-1)
        if sk.shape[0] != SKETCH_ROWS * self.num_bins:
            raise ValueError(
                f"sketch length {sk.shape[0]} != "
                f"{SKETCH_ROWS} * {self.num_bins}")
        self.rows += sk.reshape(SKETCH_ROWS, self.num_bins)
        self.updates += 1

    def update_scores(self, probs, labels) -> None:
        self.update(sketch_from_scores(probs, labels, self.num_bins))

    def merge(self, other: "QualityAccumulator") -> None:
        self.rows += other.rows
        self.updates += other.updates

    def reset(self) -> None:
        self.rows[:] = 0.0
        self.updates = 0

    def calibration_ratio(self) -> float:
        """sum(predicted) / sum(observed) — 1.0 is perfectly calibrated."""
        observed = float(self.rows[_ROW_LABEL].sum())
        predicted = float(self.rows[_ROW_PROB].sum())
        if observed <= 0.0:
            return float("nan")
        return predicted / observed

    def auc(self) -> float:
        return auc_from_counts(self.pos_hist, self.neg_hist)

    def ece(self, buckets: int = 10) -> float:
        """Expected calibration error: count-weighted mean
        |predicted - observed| over coarse buckets.  Catches SHAPE
        miscalibration (a temperature-scaled head pulls every score
        toward 0.5) that the global ratio averages away whenever the
        base rate sits near the mean score."""
        n = self.count
        if n <= 0.0:
            return float("nan")
        total = 0.0
        for row in self.calibration_table(buckets):
            total += row["count"] * abs(row["predicted"] - row["observed"])
        return total / n

    def logloss(self) -> float:
        n = self.count
        if n <= 0.0:
            return float("nan")
        return float(self.rows[_ROW_LOGLOSS].sum()) / n

    def calibration_table(self, buckets: int = 10) -> List[Dict]:
        """Per-coarse-bucket predicted CTR vs observed rate."""
        rows = []
        folded = np.stack([fold_hist(r, buckets) for r in self.rows])
        n = folded.shape[1]
        for b in range(n):
            cnt = float(folded[_ROW_COUNT, b])
            if cnt <= 0.0:
                continue
            rows.append({
                "bucket": b,
                "lo": b / n,
                "hi": (b + 1) / n,
                "count": int(cnt),
                "predicted": float(folded[_ROW_PROB, b]) / cnt,
                "observed": float(folded[_ROW_LABEL, b]) / cnt,
            })
        return rows

    def snapshot(self, hist_buckets: int = 32) -> Dict:
        return {
            "quality": True,
            "num_bins": self.num_bins,
            "updates": self.updates,
            "examples": int(self.count),
            "calibration_ratio": _round(self.calibration_ratio()),
            "auc": _round(self.auc()),
            "logloss": _round(self.logloss()),
            "calibration": self.calibration_table(),
            "pos_hist": fold_hist(self.pos_hist, hist_buckets).tolist(),
            "neg_hist": fold_hist(self.neg_hist, hist_buckets).tolist(),
        }


def _round(x: Optional[float], nd: int = 6) -> Optional[float]:
    if x is None:
        return None
    x = float(x)
    if not math.isfinite(x):
        return None
    return round(x, nd)


# -- detectors ---------------------------------------------------------------


class CalibrationDetector(health_mod.Detector):
    """Overall calibration ratio (predicted CTR / observed rate) drifting
    off 1.0 — the classic silent CTR failure: AUC holds while every bid
    is over- or under-priced.  Deviation is measured in log space so 2x
    over- and 2x under-prediction trip symmetrically."""

    name = "calibration"
    signals = ("calibration",)

    def __init__(self, tolerance: float = 0.25, hard_factor: float = 2.0,
                 min_count: int = 1000):
        self.tolerance = float(tolerance)
        self.hard_factor = float(hard_factor)
        self.min_count = int(min_count)

    def check(self, signals):
        cal = signals["calibration"]
        n = float(cal.get("count", 0.0))
        if n < self.min_count:
            return health_mod.OK, {"skipped": "warmup", "count": int(n)}
        ratio = float(cal.get("ratio", float("nan")))
        if not math.isfinite(ratio) or ratio <= 0.0:
            return health_mod.UNHEALTHY, {"ratio": str(ratio)}
        dev = abs(math.log(ratio))
        tol = math.log1p(self.tolerance)
        status = health_mod.OK
        if dev > tol * self.hard_factor:
            status = health_mod.UNHEALTHY
        elif dev > tol:
            status = health_mod.DEGRADED
        return status, {"ratio": round(ratio, 4),
                        "tolerance": self.tolerance, "count": int(n)}


class AUCRegressionDetector(health_mod.Detector):
    """Window AUC dropping below the frozen baseline window, or the
    logloss EWMA regressing relative to the baseline logloss — ranking
    quality rotting even while losses stay finite."""

    name = "auc_regression"
    signals = ("auc_quality",)

    def __init__(self, auc_margin: float = 0.02,
                 logloss_margin: float = 0.10, hard_factor: float = 2.0,
                 min_count: int = 1000):
        self.auc_margin = float(auc_margin)
        self.logloss_margin = float(logloss_margin)
        self.hard_factor = float(hard_factor)
        self.min_count = int(min_count)

    def check(self, signals):
        q = signals["auc_quality"]
        n = float(q.get("count", 0.0))
        if n < self.min_count:
            return health_mod.OK, {"skipped": "warmup", "count": int(n)}
        auc = float(q.get("auc", float("nan")))
        base_auc = float(q.get("baseline_auc", float("nan")))
        ll = float(q.get("logloss_ewma", float("nan")))
        base_ll = float(q.get("logloss_baseline", float("nan")))
        detail: Dict = {"count": int(n)}
        status = health_mod.OK
        if math.isfinite(auc) and math.isfinite(base_auc):
            drop = base_auc - auc
            detail["auc"] = round(auc, 4)
            detail["auc_drop"] = round(drop, 4)
            if drop > self.auc_margin * self.hard_factor:
                status = health_mod.UNHEALTHY
            elif drop > self.auc_margin:
                status = health_mod.DEGRADED
        if math.isfinite(ll) and math.isfinite(base_ll) and base_ll > 0.0:
            rel = ll / base_ll - 1.0
            detail["logloss_rel"] = round(rel, 4)
            if rel > self.logloss_margin * self.hard_factor:
                status = health_mod.UNHEALTHY
            elif rel > self.logloss_margin and status == health_mod.OK:
                status = health_mod.DEGRADED
        return status, detail


class DriftDetector(health_mod.Detector):
    """Distribution drift of a live window against the frozen reference
    (PSI per feature field and per score distribution).  Thresholds are
    the standard PSI bands; the detail names the worst field so a single
    scrape answers *which* input went sideways."""

    name = "drift"
    signals = ("drift",)

    def __init__(self, degraded: float = 0.2, unhealthy: float = 0.5,
                 min_count: int = 500):
        self.degraded = float(degraded)
        self.unhealthy = float(unhealthy)
        self.min_count = int(min_count)

    def check(self, signals):
        d = signals["drift"]
        n = float(d.get("count", 0.0))
        fields = d.get("fields") or {}
        if n < self.min_count or not fields:
            return health_mod.OK, {"skipped": "warmup", "count": int(n)}
        worst_field, worst = max(fields.items(), key=lambda kv: kv[1])
        status = health_mod.OK
        if worst > self.unhealthy:
            status = health_mod.UNHEALTHY
        elif worst > self.degraded:
            status = health_mod.DEGRADED
        detail = {"worst_field": worst_field, "worst": round(float(worst), 4),
                  "fields": {k: round(float(v), 4) for k, v in fields.items()},
                  "count": int(n)}
        return status, detail


QUALITY_DETECTORS = (CalibrationDetector, AUCRegressionDetector,
                     DriftDetector)
health_mod.KNOWN_DETECTORS.update(
    {cls.name: cls for cls in QUALITY_DETECTORS})


def ensure_quality_detectors(monitor: health_mod.HealthMonitor,
                             **overrides) -> None:
    """Install the quality detectors on ``monitor`` (idempotent)."""
    for cls in QUALITY_DETECTORS:
        monitor.ensure_detector(cls(**overrides.get(cls.name, {})))


# -- /qualityz provider registry ---------------------------------------------

_providers: Dict[str, Callable[[], Dict]] = {}
_providers_lock = threading.Lock()


def quality_payload() -> Dict:
    """The ``/qualityz`` JSON body: every registered provider's payload."""
    with _providers_lock:
        items = list(_providers.items())
    out: Dict = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as e:  # one broken provider must not 500 the route
            out[name] = {"error": str(e)}
    return {"quality": out}


def register_provider(name: str, fn: Callable[[], Dict]) -> None:
    """Register a ``/qualityz`` section provider and (lazily) the route."""
    with _providers_lock:
        _providers[name] = fn
    exporter_mod.register_json_route("/qualityz", quality_payload)


def unregister_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


# -- trackers ----------------------------------------------------------------


class QualityTracker:
    """Host side of the trainer sketch stream.

    Folds drained sketches into a total + a rolling window accumulator;
    when a window fills it derives calibration ratio / AUC / logloss,
    freezes the FIRST full window as the baseline (AUC, logloss, score
    distribution), updates the logloss EWMA, publishes the
    ``quality_*`` gauges, and feeds ``calibration`` / ``auc_quality`` /
    ``drift`` signals into the health monitor.  Registers itself as a
    flight registry (``quality:<component>``) and a ``/qualityz``
    provider.
    """

    def __init__(self, component: str = "trainer",
                 num_bins: int = DEFAULT_BINS,
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 registry: Optional[MetricsRegistry] = None,
                 window_updates: int = 32, min_window_count: int = 256,
                 ewma_alpha: float = 0.2, drift_method: str = "psi",
                 feed_drift: bool = False,
                 detector_overrides: Optional[Dict] = None):
        self.component = str(component)
        self.num_bins = int(num_bins)
        self.registry = registry if registry is not None else default_registry()
        self.monitor = None
        self.total = QualityAccumulator(self.num_bins)
        self.window = QualityAccumulator(self.num_bins)
        self.window_updates = int(window_updates)
        self.min_window_count = int(min_window_count)
        self.ewma_alpha = float(ewma_alpha)
        self.drift_fn = DRIFT_METHODS[drift_method]
        self.drift_method = drift_method
        # score-distribution drift vs the frozen baseline is EXPORTED as
        # a gauge always, but only fed to the DriftDetector on request:
        # a converging trainer's score distribution legitimately walks
        # away from its first window (drift detection belongs to the
        # serving-side DriftMonitor with its frozen post-warmup reference)
        self.feed_drift = bool(feed_drift)
        self.baseline: Optional[Dict] = None
        self.logloss_ewma: Optional[float] = None
        self.last_window: Optional[Dict] = None
        self.windows = 0
        self._lock = threading.Lock()
        self._detector_overrides = dict(detector_overrides or {})
        if monitor is not None:
            self.bind_monitor(monitor)
        flight_mod.register_registry(f"quality:{self.component}", self)
        register_provider(self.component, self.payload)

    def bind_monitor(self, monitor: health_mod.HealthMonitor) -> None:
        self.monitor = monitor
        ensure_quality_detectors(monitor, **self._detector_overrides)

    def close(self) -> None:
        flight_mod.unregister_registry(f"quality:{self.component}")
        unregister_provider(self.component)

    def update(self, sketch) -> None:
        """Fold one drained sketch (``f32[4 * num_bins]``)."""
        signals = None
        with self._lock:
            self.total.update(sketch)
            self.window.update(sketch)
            if (self.window.updates >= self.window_updates
                    and self.window.count >= self.min_window_count):
                signals = self._roll_window()
        # monitor feed OUTSIDE the lock: an unhealthy transition can
        # trigger a flight dump, and the dump reads this tracker's own
        # snapshot() — which takes the same (non-reentrant) lock
        if signals and self.monitor is not None:
            self.monitor.observe(**signals)

    def update_scores(self, probs, labels) -> None:
        self.update(sketch_from_scores(probs, labels, self.num_bins))

    def freeze_baseline(self) -> None:
        """Force the next full window to re-freeze the baseline."""
        with self._lock:
            self.baseline = None

    def _roll_window(self) -> Optional[Dict]:
        # lock held; returns the health signals for the caller to feed
        # AFTER releasing the lock (see update())
        w = self.window
        ratio = w.calibration_ratio()
        auc = w.auc()
        ll = w.logloss()
        if math.isfinite(ll):
            if self.logloss_ewma is None:
                self.logloss_ewma = ll
            else:
                a = self.ewma_alpha
                self.logloss_ewma = (1.0 - a) * self.logloss_ewma + a * ll
        if self.baseline is None:
            self.baseline = {"auc": auc, "logloss": ll,
                             "hist": w.counts.copy()}
        drift = self.drift_fn(self.baseline["hist"], w.counts)
        self.windows += 1
        reg = self.registry
        comp = self.component
        reg.inc(labeled("quality_examples_total", component=comp),
                w.count)
        reg.inc(labeled("quality_windows_total", component=comp))
        if math.isfinite(ratio):
            reg.gauge_set(labeled("quality_calibration_ratio",
                                  component=comp), ratio)
        if math.isfinite(auc):
            reg.gauge_set(labeled("quality_auc", component=comp), auc)
        if self.logloss_ewma is not None:
            reg.gauge_set(labeled("quality_logloss_ewma", component=comp),
                          self.logloss_ewma)
        base_ll = self.baseline.get("logloss")
        if base_ll is not None and math.isfinite(base_ll):
            reg.gauge_set(labeled("quality_logloss_baseline",
                                  component=comp), base_ll)
        reg.gauge_set(labeled("quality_drift_score", component=comp,
                              field="score"), drift)
        self.last_window = {
            "examples": int(w.count),
            "calibration_ratio": _round(ratio),
            "auc": _round(auc),
            "logloss": _round(ll),
            "drift_score": _round(drift),
        }
        signals = dict(
            calibration={"ratio": ratio, "count": w.count},
            auc_quality={
                "auc": auc,
                "baseline_auc": self.baseline["auc"],
                "logloss_ewma": (self.logloss_ewma
                                 if self.logloss_ewma is not None
                                 else float("nan")),
                "logloss_baseline": self.baseline["logloss"],
                "count": w.count,
            },
        )
        if self.feed_drift:
            signals["drift"] = {"fields": {"score": drift},
                                "count": w.count}
        w.reset()
        return signals

    # flight duck-type: the bundle's {"kind": "metrics"} record carries
    # the full sketch snapshot, so an anomaly dump is self-diagnosing.
    def snapshot(self, reset: bool = False) -> Dict:
        with self._lock:
            snap = self.total.snapshot()
            snap.update({
                "component": self.component,
                "windows": self.windows,
                "logloss_ewma": _round(self.logloss_ewma),
                "baseline": None if self.baseline is None else {
                    "auc": _round(self.baseline["auc"]),
                    "logloss": _round(self.baseline["logloss"]),
                },
                "last_window": self.last_window,
            })
            return snap

    def payload(self) -> Dict:
        return self.snapshot()


class DriftMonitor:
    """Label-free drift sketches for serving paths.

    Feeds off data the scorer already materializes: the scored
    probabilities and the deduped per-field uid streams.  Scores are
    histogrammed over [0, 1]; uids are folded into a fixed number of
    coverage buckets (mixed, then modulo), so a vocabulary shift shows up
    as mass moving between buckets.  The first ``reference_examples``
    scored examples freeze the reference; afterwards every
    ``window_examples`` live window is scored against it (PSI or
    symmetric KL) per field and for the score distribution, feeding the
    ``drift`` signal and the ``quality_drift_score`` gauges.
    """

    SCORE_FIELD = "score"

    def __init__(self, component: str = "serve",
                 score_bins: int = 64, coverage_buckets: int = 64,
                 reference_examples: int = 2048, window_examples: int = 1024,
                 drift_method: str = "psi",
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 registry: Optional[MetricsRegistry] = None,
                 detector_overrides: Optional[Dict] = None):
        self.component = str(component)
        self.score_bins = int(score_bins)
        self.coverage_buckets = int(coverage_buckets)
        self.reference_examples = int(reference_examples)
        self.window_examples = int(window_examples)
        self.drift_fn = DRIFT_METHODS[drift_method]
        self.drift_method = drift_method
        self.registry = registry if registry is not None else default_registry()
        self.monitor = None
        self._detector_overrides = dict(detector_overrides or {})
        self._lock = threading.Lock()
        self._ref: Optional[Dict[str, np.ndarray]] = None
        self._live: Dict[str, np.ndarray] = {}
        self._live_count = 0
        self.windows = 0
        self.last_scores: Optional[Dict[str, float]] = None
        if monitor is not None:
            self.bind_monitor(monitor)
        flight_mod.register_registry(f"quality:{self.component}", self)
        register_provider(self.component, self.payload)

    def bind_monitor(self, monitor: health_mod.HealthMonitor) -> None:
        self.monitor = monitor
        ensure_quality_detectors(monitor, **self._detector_overrides)

    def close(self) -> None:
        flight_mod.unregister_registry(f"quality:{self.component}")
        unregister_provider(self.component)

    def _bucket_uids(self, uids: np.ndarray) -> np.ndarray:
        u = np.asarray(uids, np.int64).reshape(-1)
        # cheap integer mix so striding in the raw id space doesn't alias
        # into a single coverage bucket
        mixed = (u ^ (u >> 17)) * np.int64(0x9E3779B1)
        idx = (mixed & np.int64(0x7FFFFFFF)) % self.coverage_buckets
        return np.bincount(idx, minlength=self.coverage_buckets).astype(
            np.float64)

    def observe(self, scores=None,
                fields: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Fold one scored batch: ``scores`` are probabilities, ``fields``
        maps field name -> (deduped) uid array."""
        feed = None
        with self._lock:
            n = 0
            if scores is not None:
                s = np.asarray(scores, np.float64).reshape(-1)
                n = s.shape[0]
                idx = np.clip((s * self.score_bins).astype(np.int64), 0,
                              self.score_bins - 1)
                hist = np.bincount(idx, minlength=self.score_bins).astype(
                    np.float64)
                self._fold(self.SCORE_FIELD, hist)
            for fname, uids in (fields or {}).items():
                hist = self._bucket_uids(uids)
                self._fold(fname, hist)
                self.registry.inc(
                    labeled("quality_coverage_total",
                            component=self.component, field=fname),
                    float(hist.sum()))
            self._live_count += n
            if self._ref is None:
                if self._live_count >= self.reference_examples:
                    self._freeze_reference()
            elif self._live_count >= self.window_examples:
                feed = self._score_window()
        # monitor feed OUTSIDE the lock: a drift trip can trigger a
        # flight dump that reads this monitor's own snapshot(), which
        # takes the same (non-reentrant) lock
        if feed is not None and self.monitor is not None:
            self.monitor.observe(drift=feed)

    def _fold(self, name: str, hist: np.ndarray) -> None:
        cur = self._live.get(name)
        if cur is None or cur.shape != hist.shape:
            self._live[name] = hist.astype(np.float64)
        else:
            cur += hist

    def freeze_reference(self) -> None:
        """Freeze the current live window as the reference immediately."""
        with self._lock:
            self._freeze_reference()

    def _freeze_reference(self) -> None:
        # lock held
        self._ref = {k: v.copy() for k, v in self._live.items()}
        self._reset_live()

    def _reset_live(self) -> None:
        self._live = {}
        self._live_count = 0

    def _score_window(self) -> Optional[Dict]:
        # lock held; returns the drift signal for the caller to feed
        # AFTER releasing the lock (see observe())
        assert self._ref is not None
        verdicts: Dict[str, float] = {}
        for fname, live in self._live.items():
            ref = self._ref.get(fname)
            if ref is None or ref.shape != live.shape:
                continue
            score = self.drift_fn(ref, live)
            verdicts[fname] = score
            self.registry.gauge_set(
                labeled("quality_drift_score", component=self.component,
                        field=fname), score)
        self.windows += 1
        self.last_scores = {k: _round(v, 4) for k, v in verdicts.items()}
        count = self._live_count
        self._reset_live()
        if not verdicts:
            return None
        return {"fields": verdicts, "count": count}

    def snapshot(self, reset: bool = False) -> Dict:
        with self._lock:
            return {
                "quality": True,
                "component": self.component,
                "method": self.drift_method,
                "reference_frozen": self._ref is not None,
                "windows": self.windows,
                "live_examples": self._live_count,
                "drift": dict(self.last_scores or {}),
                "reference": {k: v.tolist()
                              for k, v in (self._ref or {}).items()},
            }

    def payload(self) -> Dict:
        return self.snapshot()


# -- cluster rollup extraction ----------------------------------------------


def _parse_labels(series: str) -> Tuple[str, Dict[str, str]]:
    """``name{k="v",...}`` -> (name, labels)."""
    if "{" not in series:
        return series, {}
    name, rest = series.split("{", 1)
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            labels[k.strip()] = v.strip().strip('"')
    return name, labels


def quality_rollup(members: Dict[str, Dict]) -> Dict:
    """Extract the per-member quality series from a cluster rollup dump.

    ``members`` is ``ClusterRollup.members()``-shaped: name -> entry with
    a ``snapshot`` metrics dict (MSG_STATS payload).  Returns per-member
    quality gauges/counters plus a cluster verdict naming the member with
    the worst drift score — one scrape answers "which host's data went
    sideways".
    """
    out: Dict = {"members": {}, "worst_drift": None}
    worst: Optional[Tuple[str, str, float]] = None
    for member, entry in sorted((members or {}).items()):
        snap = (entry or {}).get("snapshot") or {}
        rec: Dict = {"gauges": {}, "counters": {}}
        for kind in ("gauges", "counters"):
            for series, value in (snap.get(kind) or {}).items():
                name, labels = _parse_labels(series)
                if not name.startswith("quality_"):
                    continue
                rec[kind][series] = value
                if name == "quality_drift_score":
                    v = float(value)
                    if worst is None or v > worst[2]:
                        worst = (member, labels.get("field", "?"), v)
        if rec["gauges"] or rec["counters"]:
            out["members"][member] = rec
    if worst is not None:
        out["worst_drift"] = {"member": worst[0], "field": worst[1],
                              "score": _round(worst[2], 4)}
    return out
