"""Resource & saturation plane — the port's copy of the queue half.

:class:`InstrumentedQueue` gives a bounded pipeline (the serve
micro-batch queue) depth/capacity gauges, enqueue/drop counters and a
wait-time histogram, feeding :class:`QueueSaturationDetector` — sustained
depth/capacity above the band degrades the verdict BEFORE admission
control starts shedding.  Queues are ``/resourcez`` providers on the
shared exporter.

The JAX package's compile tracker (``CompileTracker``/``track_jit``), the
recompile-storm and memory-pressure detectors and the memory sampler read
jit caches and device buffers that the port does not have yet; they are
not copied here.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from lightctr_tpu_torch.obs import exporter as exporter_mod
from lightctr_tpu_torch.obs import gate
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.obs.registry import MetricsRegistry, default_registry, labeled

# -- detectors ---------------------------------------------------------------


class QueueSaturationDetector(health_mod.Detector):
    """Sustained queue depth/capacity above a band — the pipeline is
    about to shed (serve queue), stall the step (stripe dispatch), or
    drop work (prefetch tickets).  Saturation must SUSTAIN for
    ``sustain`` consecutive observations of the same queue before it
    counts (a single full batch is micro-batching working as designed);
    the streaks are tracked per queue internally since one detector sees
    every instrumented queue interleaved, so the monitor-level hysteresis
    stays at one observation."""

    name = "queue_saturation"
    signals = ("queue_saturation",)
    trip_after = 1
    recover_after = 1

    def __init__(self, degraded_fill: float = 0.85,
                 unhealthy_fill: float = 0.97, sustain: int = 3,
                 min_capacity: int = 2):
        self.degraded_fill = float(degraded_fill)
        self.unhealthy_fill = float(unhealthy_fill)
        self.sustain = int(sustain)
        self.min_capacity = int(min_capacity)
        # queue -> [consecutive over-band observations, worst level seen]
        self._streaks: Dict[str, list] = {}

    def check(self, signals):
        q = signals["queue_saturation"]
        name = str(q.get("queue", "?"))
        depth = float(q.get("depth", 0.0))
        cap = float(q.get("capacity", 0.0))
        if cap < self.min_capacity:
            return health_mod.OK, {"skipped": "capacity", "queue": name}
        fill = depth / cap
        if fill >= self.unhealthy_fill:
            level = 2
        elif fill >= self.degraded_fill:
            level = 1
        else:
            level = 0
        if level == 0:
            self._streaks.pop(name, None)
        else:
            streak = self._streaks.setdefault(name, [0, 0])
            streak[0] += 1
            streak[1] = max(streak[1], level)
        worst_level = 0
        worst_queue = None
        for qname, (n, lvl) in self._streaks.items():
            if n >= self.sustain and lvl > worst_level:
                worst_level, worst_queue = lvl, qname
        detail: Dict = {"queue": name, "fill": round(fill, 4),
                        "degraded_fill": self.degraded_fill}
        if worst_level == 0:
            return health_mod.OK, detail
        detail["sustained_queue"] = worst_queue
        detail["sustained"] = self._streaks[worst_queue][0]
        status = (health_mod.UNHEALTHY if worst_level >= 2
                  else health_mod.DEGRADED)
        return status, detail

RESOURCE_DETECTORS = (QueueSaturationDetector,)
health_mod.KNOWN_DETECTORS.update(
    {cls.name: cls for cls in RESOURCE_DETECTORS})


def ensure_resource_detectors(monitor: health_mod.HealthMonitor,
                              **overrides) -> None:
    """Install the resource detectors on ``monitor`` (idempotent)."""
    for cls in RESOURCE_DETECTORS:
        monitor.ensure_detector(cls(**overrides.get(cls.name, {})))


# -- /resourcez provider registry --------------------------------------------

_providers: Dict[str, Callable[[], Dict]] = {}
_providers_lock = threading.Lock()


def resource_payload() -> Dict:
    """The ``/resourcez`` JSON body: every registered provider's payload."""
    with _providers_lock:
        items = list(_providers.items())
    out: Dict = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as e:  # one broken provider must not 500 the route
            out[name] = {"error": str(e)}
    return {"resources": out}


def register_provider(name: str, fn: Callable[[], Dict]) -> None:
    """Register a ``/resourcez`` section provider and (lazily) the route."""
    with _providers_lock:
        _providers[name] = fn
    exporter_mod.register_json_route("/resourcez", resource_payload)


def unregister_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


# -- instrumented queues -----------------------------------------------------


class InstrumentedQueue:
    """Depth/capacity/wait telemetry for one bounded pipeline.

    Not a queue itself — a metrics face the owning pipeline calls from
    its own enqueue/dequeue sites (``set_depth`` / ``note_enqueue`` /
    ``note_wait`` / ``note_drop``), so the serve queue, stripe FIFOs,
    prefetch tickets, event rings, and scrape sweeps all speak one
    ``resource_queue_*`` family without changing their locking.  With a
    ``monitor``, every depth sample feeds the ``queue_saturation``
    signal (capacity-less pipelines get depth/wait series only).
    """

    def __init__(self, name: str, capacity: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 register: bool = True,
                 detector_overrides: Optional[Dict] = None):
        self.name = str(name)
        self.capacity = None if capacity is None else int(capacity)
        self.registry = registry if registry is not None else default_registry()
        self.monitor = monitor
        self._detector_overrides = dict(detector_overrides or {})
        if monitor is not None:
            ensure_resource_detectors(monitor, **self._detector_overrides)
        self._lock = threading.Lock()
        self._depth = 0
        self._enqueued = 0
        self._dropped = 0
        self._waits = 0
        self._wait_sum = 0.0
        if self.capacity is not None:
            self.registry.gauge_set(
                labeled("resource_queue_capacity", queue=self.name),
                self.capacity)
        self._registered = bool(register)
        if self._registered:
            register_provider(f"queue:{self.name}", self.payload)

    def close(self) -> None:
        if self._registered:
            unregister_provider(f"queue:{self.name}")
            self._registered = False

    def set_capacity(self, capacity: Optional[int]) -> None:
        cap = None if capacity is None else int(capacity)
        if cap == self.capacity:
            return
        self.capacity = cap
        if cap is not None and gate.enabled():
            self.registry.gauge_set(
                labeled("resource_queue_capacity", queue=self.name), cap)

    def set_depth(self, depth: int) -> None:
        """Record the current depth; feeds saturation when monitored."""
        with self._lock:
            self._depth = int(depth)
        if not gate.enabled():
            return
        self.registry.gauge_set(
            labeled("resource_queue_depth", queue=self.name), int(depth))
        if (self.monitor is not None and self.capacity
                and self.monitor.wants("queue_saturation")):
            self.monitor.observe(queue_saturation={
                "queue": self.name, "depth": int(depth),
                "capacity": self.capacity,
            })

    def note_enqueue(self, n: int = 1) -> None:
        with self._lock:
            self._enqueued += n
        if gate.enabled():
            self.registry.inc(
                labeled("resource_queue_enqueued_total", queue=self.name), n)

    def note_drop(self, n: int = 1) -> None:
        """Work refused/evicted at the queue boundary (shed rows, full
        ticket queues, ring overwrites)."""
        with self._lock:
            self._dropped += n
        if gate.enabled():
            self.registry.inc(
                labeled("resource_queue_dropped_total", queue=self.name), n)

    def note_wait(self, seconds: float) -> None:
        """Time one item spent queued before service."""
        with self._lock:
            self._waits += 1
            self._wait_sum += float(seconds)
        if gate.enabled():
            self.registry.observe(
                labeled("resource_queue_wait_seconds", queue=self.name),
                float(seconds))

    def fill(self) -> Optional[float]:
        if not self.capacity:
            return None
        with self._lock:
            return self._depth / self.capacity

    def payload(self) -> Dict:
        with self._lock:
            out = {
                "resources": True,
                "queue": self.name,
                "depth": self._depth,
                "capacity": self.capacity,
                "enqueued": self._enqueued,
                "dropped": self._dropped,
                "waits": self._waits,
                "wait_sum_s": round(self._wait_sum, 6),
            }
        f = self.fill()
        if f is not None:
            out["fill"] = round(f, 4)
        return out
