"""Resource & saturation observability plane, the port's counterpart of
``lightctr_tpu/obs/resources.py``: compile tracking, queue telemetry and
memory-pressure accounting.  Three families:

- **compile observability** — :class:`CompileTracker` counts the kernel
  builds of ``ops/sparse_kernels.py`` process-wide (each library's nvcc
  build and ``ctypes`` load, with their seconds) and tracks, per
  registered callable, the distinct input signatures it has seen
  (``fn._cache_size()``).  Eager PyTorch compiles nothing: the port's
  counterpart of a jit cache entry is a distinct signature (the shapes and
  dtypes of the tensors it is called with), which
  :class:`TrackedCallable` counts.  A shape leak (an unpadded batch tail,
  a drifting pad width) is then a :class:`RecompileStormDetector` trip —
  ``/healthz`` DEGRADED/503 and a flight bundle — as in the JAX package.
- **queue/pipeline saturation** — :class:`InstrumentedQueue` gives any
  bounded pipeline (the serve micro-batch queue, the ingest prefetch
  queue, event rings) depth/capacity gauges, enqueue/drop counters, and a
  wait-time histogram, feeding :class:`QueueSaturationDetector`.
- **memory pressure** — :class:`MemorySampler` rolls host RSS, each CUDA
  device's allocated bytes (``torch.cuda.memory_stats``) and any
  registered byte source into one ``resource_memory_bytes{kind}`` family,
  checked against budgets by :class:`MemoryPressureDetector`.

Every tracker/queue/sampler is a ``/resourcez`` provider (the route
mounts lazily on the shared exporter, per process);
:func:`resource_rollup` extracts the cluster view from member snapshots.
Compile trackers register as ``resources:<component>`` flight registries.
``LIGHTCTR_RESOURCES=1`` arms the per-trainer compile watch
(:func:`resolve_armed`); everything is gated on the obs switch.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lightctr_tpu_torch.obs import events as events_mod
from lightctr_tpu_torch.obs import exporter as exporter_mod
from lightctr_tpu_torch.obs import flight as flight_mod
from lightctr_tpu_torch.obs import gate
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.obs.registry import MetricsRegistry, default_registry, labeled

_LOG = logging.getLogger("lightctr.obs.resources")

# Every series this plane emits (both-directions AST lint in
# tests/test_resources.py, same contract as QUALITY/TIER/HEALTH_SERIES).
# All resource_* emissions live in THIS module — wiring call sites go
# through the helpers below, so the lint covers the whole family.
RESOURCE_SERIES = (
    "resource_jit_compiles_total",     # counter, {fn} — cache-entry growth
    "resource_jit_cache_entries",      # gauge, {fn} — live ladder size
    "resource_backend_compiles_total",  # counter — real XLA compiles
    "resource_compile_seconds",        # histogram — per backend compile
    "resource_queue_depth",            # gauge, {queue}
    "resource_queue_capacity",         # gauge, {queue}
    "resource_queue_wait_seconds",     # histogram, {queue}
    "resource_queue_enqueued_total",   # counter, {queue}
    "resource_queue_dropped_total",    # counter, {queue}
    "resource_memory_bytes",           # gauge, {kind}
    "resource_memory_budget_bytes",    # gauge, {kind}
)


def resolve_armed(explicit: Optional[bool] = None) -> bool:
    """Whether the per-trainer resource watch is armed: an explicit ctor
    argument wins; otherwise ``LIGHTCTR_RESOURCES`` (``1``/``true`` arms,
    unset/falsy leaves it off — zero per-step cost when dark)."""
    if explicit is not None:
        return bool(explicit)
    v = os.environ.get("LIGHTCTR_RESOURCES", "").strip().lower()
    return v not in ("", "0", "false", "off", "no")


# -- detectors ---------------------------------------------------------------


class RecompileStormDetector(health_mod.Detector):
    """Compiles (new input signatures) per step past a band after
    warmup — a shape leak (unpadded batch tails, drifting ladder keys)
    that, in the JAX package, re-traces every step and quietly slows the
    run 10x, and in the port defeats the pow2 ladder the kernels and the
    caching allocator are sized for.  The feed
    (``CompileTracker.poll``) already windows over several steps, so the
    detector trips and recovers in one observation, like the stall
    detector."""

    name = "recompile_storm"
    signals = ("recompile",)
    trip_after = 1
    recover_after = 1

    def __init__(self, warmup_steps: int = 16, max_per_step: float = 0.5,
                 hard_factor: float = 2.0, min_steps: int = 4):
        self.warmup_steps = int(warmup_steps)
        self.max_per_step = float(max_per_step)
        self.hard_factor = float(hard_factor)
        self.min_steps = int(min_steps)

    def check(self, signals):
        r = signals["recompile"]
        total = int(r.get("total_steps", 0))
        steps = int(r.get("steps", 0))
        compiles = float(r.get("compiles", 0.0))
        if total <= self.warmup_steps:
            # the pow2 ladder legitimately compiles one program per rung
            # while it warms up
            return health_mod.OK, {"skipped": "warmup", "steps": total}
        if steps < self.min_steps:
            return health_mod.OK, {"skipped": "window", "steps": steps}
        rate = compiles / max(steps, 1)
        detail: Dict = {"rate": round(rate, 4), "compiles": int(compiles),
                        "steps": steps, "max_per_step": self.max_per_step}
        per_fn = r.get("per_fn") or {}
        if per_fn:
            worst_fn = max(per_fn.items(), key=lambda kv: kv[1])
            if worst_fn[1] > 0:
                detail["worst_fn"] = worst_fn[0]
        if rate > self.max_per_step * self.hard_factor:
            return health_mod.UNHEALTHY, detail
        if rate > self.max_per_step:
            return health_mod.DEGRADED, detail
        return health_mod.OK, detail


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


class MemoryPressureDetector(health_mod.Detector):
    """Any tracked byte family past its configured budget fraction —
    host RSS toward the cgroup limit, the tiered store's resident bytes
    toward its planned footprint, the device block toward HBM.  Kinds
    with no budget are tracked but never judged."""

    name = "memory_pressure"
    signals = ("memory_pressure",)
    trip_after = 1
    recover_after = 1

    def __init__(self, degraded: float = 0.85, unhealthy: float = 0.95):
        self.degraded = float(degraded)
        self.unhealthy = float(unhealthy)

    def check(self, signals):
        m = signals["memory_pressure"]
        budgets = m.get("budgets") or {}
        sizes = m.get("bytes") or {}
        worst_kind, worst = None, 0.0
        for kind, budget in budgets.items():
            b = float(budget)
            if b <= 0.0 or kind not in sizes:
                continue
            frac = float(sizes[kind]) / b
            if frac > worst:
                worst_kind, worst = kind, frac
        if worst_kind is None:
            return health_mod.OK, {"skipped": "no budgets"}
        detail = {"worst_kind": worst_kind, "fraction": round(worst, 4),
                  "degraded": self.degraded}
        if worst > self.unhealthy:
            return health_mod.UNHEALTHY, detail
        if worst > self.degraded:
            return health_mod.DEGRADED, detail
        return health_mod.OK, detail


RESOURCE_DETECTORS = (RecompileStormDetector, QueueSaturationDetector,
                      MemoryPressureDetector)
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


# -- signature counting ------------------------------------------------------


def _leaf_signature(x):
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, np.ndarray):
        return ("a", x.shape, str(x.dtype))
    if isinstance(x, (bool, int, float, complex)):
        return ("s", type(x).__name__)
    if x is None:
        return ("n",)
    return ("o", type(x).__name__)


def call_signature(args=(), kwargs=None) -> tuple:
    """A hashable signature of a call's arguments: the shape, dtype and
    device type of every tensor or array in them (dicts, lists and tuples
    walked), the type of every other leaf — what decides whether a traced
    program would be reused."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                out.append(("k", str(k)))
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            out.append(("(", len(x)))
            for y in x:
                walk(y)
        else:
            out.append(_leaf_signature(x))

    walk(tuple(args))
    if kwargs:
        walk(dict(kwargs))
    return tuple(out)


class TrackedCallable:
    """A callable that counts the distinct input signatures it has been
    called with (:func:`call_signature`): ``_cache_size()`` is that count,
    the port's counterpart of a jit wrapper's cache-entry count, so a
    :class:`CompileTracker` reads it duck-typed.  The call itself is
    forwarded unchanged."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._sigs: set = set()
        self.__wrapped__ = fn
        self.__name__ = getattr(fn, "__name__", type(fn).__name__)

    def __call__(self, *args, **kwargs):
        self._sigs.add(call_signature(args, kwargs))
        return self.fn(*args, **kwargs)

    def _cache_size(self) -> int:
        return len(self._sigs)


# -- compile tracker ---------------------------------------------------------

# the kernel registry keeps its build listeners for the process, so the
# process installs exactly ONE module-level listener that dispatches to
# whichever trackers are live (a closed tracker just drops out of the
# weak set).
_live_trackers: "weakref.WeakSet[CompileTracker]" = weakref.WeakSet()
_listener_state = {"installed": False}
_listener_lock = threading.Lock()


def _on_compile_event(event: str, duration: float, **_kw) -> None:
    # ops/sparse_kernels reports each kernel library it loads, with the
    # seconds of its nvcc build (when that ran in this process) and of
    # its ctypes load
    if str(event) != "kernel_build":
        return
    for tr in list(_live_trackers):
        tr._on_backend_compile(float(duration))


def _install_listener() -> None:
    with _listener_lock:
        if _listener_state["installed"]:
            return
        from lightctr_tpu_torch.ops import sparse_kernels
        sparse_kernels.add_build_listener(_on_compile_event)
        _listener_state["installed"] = True


class CompileTracker:
    """Process/compile observability for a set of registered callables.

    ``track(name, fn)`` registers any callable exposing ``_cache_size()``
    (a :class:`TrackedCallable` does: its distinct input signatures);
    ``poll()`` turns growth since the last poll into
    ``resource_jit_compiles_total{fn}`` increments and live
    ``resource_jit_cache_entries{fn}`` gauges, counts the kernel builds
    ``ops/sparse_kernels`` reports, and feeds the
    ``recompile`` signal (compiles per step over the window) into the
    health monitor.  ``note_step()`` is the per-step hook — a counter
    bump, with an automatic ``poll()`` every ``poll_every`` steps.

    Registers as a ``resources:<component>`` flight registry and a
    ``/resourcez`` provider; ``close()`` unregisters both.
    """

    def __init__(self, component: str = "process",
                 registry: Optional[MetricsRegistry] = None,
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 poll_every: int = 16,
                 detector_overrides: Optional[Dict] = None):
        self.component = str(component)
        self.registry = registry if registry is not None else default_registry()
        self.poll_every = int(poll_every)
        self.monitor = None
        self._detector_overrides = dict(detector_overrides or {})
        self._lock = threading.Lock()
        self._fns: Dict[str, Callable[[], int]] = {}
        self._last_entries: Dict[str, int] = {}
        self._compiles: Dict[str, int] = {}
        self._steps = 0
        self._last_poll_steps = 0
        self._backend_compiles = 0
        self._last_backend = 0
        self._compile_seconds = 0.0
        self._last_rate: Optional[float] = None
        if monitor is not None:
            self.bind_monitor(monitor)
        _install_listener()
        _live_trackers.add(self)
        flight_mod.register_registry(f"resources:{self.component}", self)
        register_provider(self.component, self.payload)

    def bind_monitor(self, monitor: health_mod.HealthMonitor) -> None:
        self.monitor = monitor
        ensure_resource_detectors(monitor, **self._detector_overrides)

    def close(self) -> None:
        _live_trackers.discard(self)
        flight_mod.unregister_registry(f"resources:{self.component}")
        unregister_provider(self.component)

    # -- registration --------------------------------------------------------

    def track(self, name: str, fn) -> None:
        """Track a callable's live signature count.  Latest registration
        wins per name (a rebuilt replacement resets the baseline), and a
        callable without ``_cache_size`` registers as a constant-zero
        source rather than raising — registration must be safe from any
        ctor."""
        sizer = getattr(fn, "_cache_size", None)
        if not callable(sizer):
            sizer = lambda: 0  # noqa: E731
        with self._lock:
            self._fns[str(name)] = sizer
            self._last_entries[str(name)] = self._read_size(sizer)
            self._compiles.setdefault(str(name), 0)

    def untrack(self, name: str) -> None:
        with self._lock:
            self._fns.pop(str(name), None)
            self._last_entries.pop(str(name), None)

    @staticmethod
    def _read_size(sizer) -> int:
        try:
            return int(sizer())
        except Exception:
            return 0

    # -- feed ----------------------------------------------------------------

    def _on_backend_compile(self, seconds: float) -> None:
        with self._lock:
            self._backend_compiles += 1
            self._compile_seconds += seconds
        if gate.enabled():
            self.registry.inc("resource_backend_compiles_total")
            self.registry.observe("resource_compile_seconds", seconds)

    def note_step(self, n: int = 1) -> None:
        """Per-step hook: a counter bump, with an automatic poll every
        ``poll_every`` steps (0 disables auto-polling)."""
        with self._lock:
            self._steps += n
            due = (self.poll_every > 0
                   and self._steps - self._last_poll_steps >= self.poll_every)
        if due:
            self.poll()

    def poll(self) -> Dict:
        """Fold cache-entry growth into the metrics + the health feed.
        Returns the window summary (also the ``recompile`` signal)."""
        on = gate.enabled()
        with self._lock:
            per_fn: Dict[str, int] = {}
            entries: Dict[str, int] = {}
            for name, sizer in self._fns.items():
                n = self._read_size(sizer)
                d = n - self._last_entries.get(name, 0)
                self._last_entries[name] = n
                entries[name] = n
                if d > 0:
                    per_fn[name] = d
                    self._compiles[name] = self._compiles.get(name, 0) + d
            d_steps = self._steps - self._last_poll_steps
            self._last_poll_steps = self._steps
            d_backend = self._backend_compiles - self._last_backend
            self._last_backend = self._backend_compiles
            total_steps = self._steps
            compiles = sum(per_fn.values())
            if d_steps > 0:
                self._last_rate = compiles / d_steps
        if on:
            reg = self.registry
            for name, d in per_fn.items():
                reg.inc(labeled("resource_jit_compiles_total", fn=name), d)
            for name, n in entries.items():
                reg.gauge_set(labeled("resource_jit_cache_entries", fn=name),
                              n)
        signal = {"compiles": compiles, "steps": d_steps,
                  "total_steps": total_steps, "per_fn": per_fn,
                  "backend": d_backend}
        # monitor feed OUTSIDE the lock: an unhealthy transition can
        # trigger a flight dump that reads this tracker's own snapshot(),
        # which takes the same (non-reentrant) lock
        if self.monitor is not None and d_steps > 0:
            self.monitor.observe(recompile=signal)
        return signal

    # -- reads (flight duck-type + /resourcez section) -----------------------

    def snapshot(self, reset: bool = False) -> Dict:
        with self._lock:
            return {
                "resources": True,
                "component": self.component,
                "steps": self._steps,
                "backend_compiles": self._backend_compiles,
                "compile_seconds": round(self._compile_seconds, 6),
                "compiles_total": int(sum(self._compiles.values())),
                "last_rate": (None if self._last_rate is None
                              or not math.isfinite(self._last_rate)
                              else round(self._last_rate, 6)),
                "fns": {
                    name: {"cache_entries": self._last_entries.get(name, 0),
                           "compiles": self._compiles.get(name, 0)}
                    for name in sorted(self._fns)
                },
            }

    def payload(self) -> Dict:
        return self.snapshot()


_default_lock = threading.Lock()
_default_tracker: Optional[CompileTracker] = None


def default_tracker() -> CompileTracker:
    """The process-wide compile tracker (the serve scorers and the online
    step register into it; a trainer-owned tracker polls its own set).
    Lazy."""
    global _default_tracker
    with _default_lock:
        if _default_tracker is None:
            _default_tracker = CompileTracker(component="process")
        return _default_tracker


def reset_default_tracker() -> None:
    """Drop the process tracker (tests)."""
    global _default_tracker
    with _default_lock:
        if _default_tracker is not None:
            _default_tracker.close()
            _default_tracker = None


def track_jit(name: str, fn):
    """Register ``fn`` with the process tracker and return it — ctor
    wiring sugar: ``self._step = resources.track_jit("online_grads_fm",
    step)``.  A callable without ``_cache_size`` is wrapped in a
    :class:`TrackedCallable` first (the returned object), so its distinct
    input signatures are what the tracker counts; the JAX package's
    program names are kept."""
    if not callable(getattr(fn, "_cache_size", None)):
        fn = TrackedCallable(fn)
    default_tracker().track(name, fn)
    return fn


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


class EventRingWatch:
    """MessageQueue-style telemetry for an obs event ring: the bounded
    in-memory buffer of an :class:`~lightctr_tpu_torch.obs.events.EventLog`.
    ``sample()`` publishes the ring's occupancy/capacity and folds
    oldest-dropped overwrites into the queue drop counter.  With no
    explicit log it follows the process-default log at sample time (so a
    ``configure_event_log`` swap is picked up, not pinned)."""

    def __init__(self, log=None, name: str = "event_ring",
                 registry: Optional[MetricsRegistry] = None,
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 register: bool = True):
        self._log = log
        self.queue = InstrumentedQueue(
            name, capacity=self._resolve().capacity, registry=registry,
            monitor=monitor, register=register)
        self._last_dropped = self._resolve().dropped

    def _resolve(self):
        return self._log if self._log is not None else events_mod.get_event_log()

    def sample(self) -> None:
        log = self._resolve()
        self.queue.set_capacity(log.capacity)
        self.queue.set_depth(len(log.records()))
        d = log.dropped
        if d > self._last_dropped:
            self.queue.note_drop(d - self._last_dropped)
        self._last_dropped = d

    def close(self) -> None:
        self.queue.close()


# -- memory pressure ---------------------------------------------------------


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process from ``/proc/self/status``
    (``VmRSS`` kB), or None where procfs is unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def device_hbm_bytes() -> Optional[Dict[str, int]]:
    """Per-device bytes the caching allocator has handed out
    (``torch.cuda.memory_stats(i)["allocated_bytes.all.current"]``) — a
    dict source (``{devN: bytes}`` fanning out as ``hbm_devN``) where CUDA
    is available; None on the CPU, so the sample is skipped honestly
    rather than reported as zero."""
    try:
        if not torch.cuda.is_available():
            return None
        n = torch.cuda.device_count()
    except Exception:
        return None
    out: Dict[str, int] = {}
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            continue
        out[f"dev{i}"] = int(stats.get("allocated_bytes.all.current", 0))
    return out or None


class MemorySampler:
    """Rolls every tracked byte family into ``resource_memory_bytes{kind}``.

    Sources are zero-arg callables returning bytes (or None to skip this
    sample) — the tiered store's ``memory_bytes()`` tiers, a device
    block, peak round bytes.  Host RSS and per-device HBM use
    (:func:`device_hbm_bytes` — ``hbm_devN`` kinds, skipped on backends
    without allocator stats) are built-in sources.  Budgets (bytes per
    kind) publish as ``resource_memory_budget_bytes{kind}`` and drive
    :class:`MemoryPressureDetector`; kinds without budgets are tracked
    but never judged — :meth:`budget_devices` budgets each device at a
    fraction of its total memory."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 budgets: Optional[Dict[str, float]] = None,
                 include_host: bool = True, include_device: bool = True,
                 register: bool = True,
                 name: str = "memory",
                 detector_overrides: Optional[Dict] = None):
        self.name = str(name)
        self.registry = registry if registry is not None else default_registry()
        self.monitor = monitor
        self._detector_overrides = dict(detector_overrides or {})
        if monitor is not None:
            ensure_resource_detectors(monitor, **self._detector_overrides)
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], Optional[float]]] = {}
        self.budgets: Dict[str, float] = {
            str(k): float(v) for k, v in (budgets or {}).items()}
        self._last: Dict[str, int] = {}
        if include_host:
            self._sources["host_rss"] = host_rss_bytes
        if include_device:
            self._sources["hbm"] = device_hbm_bytes
        self._registered = bool(register)
        if self._registered:
            register_provider(f"memory:{self.name}", self.payload)

    def close(self) -> None:
        if self._registered:
            unregister_provider(f"memory:{self.name}")
            self._registered = False

    def add_source(self, kind: str, fn: Callable[[], Optional[float]]) -> None:
        with self._lock:
            self._sources[str(kind)] = fn

    def remove_source(self, kind: str) -> None:
        with self._lock:
            self._sources.pop(str(kind), None)

    def set_budget(self, kind: str, budget_bytes: Optional[float]) -> None:
        with self._lock:
            if budget_bytes is None:
                self.budgets.pop(str(kind), None)
            else:
                self.budgets[str(kind)] = float(budget_bytes)

    def budget_devices(self, fraction: float = 0.9) -> Dict[str, float]:
        """Budget each CUDA device's ``hbm_devN`` kind at ``fraction`` of
        its total memory (``torch.cuda.mem_get_info``) so HBM fill drives
        the memory-pressure detector like any tier budget.  Returns the
        budgets set — empty on the CPU: no device means no budget, never
        a guessed one."""
        out: Dict[str, float] = {}
        try:
            if not torch.cuda.is_available():
                return out
            n = torch.cuda.device_count()
        except Exception:
            return out
        for i in range(n):
            try:
                _free, total = torch.cuda.mem_get_info(i)
            except Exception:
                continue
            b = float(total) * float(fraction)
            out[f"hbm_dev{i}"] = b
            self.set_budget(f"hbm_dev{i}", b)
        return out

    def sample(self) -> Dict[str, int]:
        """Read every source, publish the gauges, feed the detector.
        Returns the sampled {kind: bytes} map."""
        with self._lock:
            sources = dict(self._sources)
            budgets = dict(self.budgets)
        # sources returning dicts fan out into per-kind series (the
        # tiered store reports all its tiers from one call)
        flat: Dict[str, int] = {}
        for kind, fn in sources.items():
            try:
                v = fn()
            except Exception:
                continue
            if v is None:
                continue
            if isinstance(v, dict):
                for sub, sv in v.items():
                    flat[f"{kind}_{sub}"] = int(sv)
            else:
                flat[kind] = int(v)
        on = gate.enabled()
        if on:
            for kind, v in flat.items():
                self.registry.gauge_set(
                    labeled("resource_memory_bytes", kind=kind), v)
            for kind, b in budgets.items():
                self.registry.gauge_set(
                    labeled("resource_memory_budget_bytes", kind=kind), b)
        with self._lock:
            self._last = dict(flat)
        if (self.monitor is not None and budgets
                and self.monitor.wants("memory_pressure")):
            self.monitor.observe(memory_pressure={
                "bytes": flat, "budgets": budgets})
        return flat

    def payload(self) -> Dict:
        with self._lock:
            return {
                "resources": True,
                "name": self.name,
                "bytes": dict(self._last),
                "budgets": dict(self.budgets),
            }


# -- cluster rollup extraction ----------------------------------------------


def resource_rollup(members: Dict[str, Dict]) -> Dict:
    """Extract the per-member resource series from a cluster rollup dump.

    ``members`` is ``ClusterRollup.members()``-shaped: name -> entry with
    a ``snapshot`` metrics dict.  Returns per-member ``resource_*``
    gauges/counters plus a cluster verdict naming the fullest
    instrumented queue (``worst_saturation``) and the biggest
    compile count (``most_compiles``) — one scrape answers "which host
    is saturating" before the shed counters start moving.
    """
    from lightctr_tpu_torch.obs.quality import _parse_labels

    out: Dict = {"members": {}, "worst_saturation": None,
                 "most_compiles": None}
    worst_sat: Optional[Tuple[str, str, float]] = None
    most_comp: Optional[Tuple[str, float]] = None
    for member, entry in sorted((members or {}).items()):
        snap = (entry or {}).get("snapshot") or {}
        rec: Dict = {"gauges": {}, "counters": {}}
        depths: Dict[str, float] = {}
        caps: Dict[str, float] = {}
        compiles = 0.0
        for kind in ("gauges", "counters"):
            for series, value in (snap.get(kind) or {}).items():
                name, labels = _parse_labels(series)
                if not name.startswith("resource_"):
                    continue
                rec[kind][series] = value
                if name == "resource_queue_depth":
                    depths[labels.get("queue", "?")] = float(value)
                elif name == "resource_queue_capacity":
                    caps[labels.get("queue", "?")] = float(value)
                elif name == "resource_jit_compiles_total":
                    compiles += float(value)
        for qname, depth in depths.items():
            cap = caps.get(qname, 0.0)
            if cap <= 0.0:
                continue
            fill = depth / cap
            if worst_sat is None or fill > worst_sat[2]:
                worst_sat = (member, qname, fill)
        if compiles > 0 and (most_comp is None or compiles > most_comp[1]):
            most_comp = (member, compiles)
        if rec["gauges"] or rec["counters"]:
            out["members"][member] = rec
    if worst_sat is not None:
        out["worst_saturation"] = {"member": worst_sat[0],
                                   "queue": worst_sat[1],
                                   "fill": round(worst_sat[2], 4)}
    if most_comp is not None:
        out["most_compiles"] = {"member": most_comp[0],
                                "compiles": int(most_comp[1])}
    return out
