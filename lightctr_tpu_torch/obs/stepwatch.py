"""Step stall watchdog: say the cluster is WEDGED, not just slow.

The health plane (obs/health.py) judges the numbers a step produces — but
a step that never completes produces no numbers: a dead
``SparseReduceShard`` stalls every host's rendezvous pull until the
timeout, and nothing in the per-step feeds ever fires.  This module
watches the one signal that survives a wedge: wall time since the last
COMPLETED step, against a deadline derived from an EWMA of recent step
times.

A :class:`StepWatch` is armed by the trainer (``LIGHTCTR_STALL=1`` or
:meth:`~lightctr_tpu_torch.models.ctr_trainer.CTRTrainer.arm_stepwatch`) and
rides the same per-step drain as the health feed: every
``_record_step``/``flush_health`` cycle calls :meth:`step_completed`,
and the trainer marks the current phase (``input`` / ``exec`` /
``exchange`` / ``apply``) as the step moves through its regions — the
same names the live span stack carries — so a trip can say WHERE the
step is stuck, not just that it is.  A daemon thread polls
:meth:`check`; on trip it:

  - emits one ``stall`` event (phase, wait, deadline, EWMA),
  - triggers the PR-4 rate-limited flight dump AT STALL TIME (the
    postmortem bundle of a wedge must be captured while wedged — after
    recovery the rings have rolled past it),
  - feeds the monitor's :class:`~lightctr_tpu_torch.obs.health.StallDetector`
    (``KNOWN_DETECTORS``): ``/healthz`` goes DEGRADED the moment the
    deadline passes and escalates to UNHEALTHY (HTTP 503, plus the
    monitor's own anomaly dump) once the wait exceeds ``hard_factor``
    times it,

and recovers in ONE observation when the next step completes (the
detector declares its own trip/recover hysteresis of 1 — the wait signal
already carries the time hysteresis).

Deadline math: ``deadline = max(min_s, factor * ewma_step_seconds)``,
with no trips before ``warmup`` completed steps (the first step carries
jit compilation; an EWMA of one compile is not a baseline).  Knobs:
``LIGHTCTR_STALL_FACTOR`` (default 10) and ``LIGHTCTR_STALL_MIN_S``
(default 5) — see docs/OBSERVABILITY.md "Cluster rollup & stall
diagnosis".
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from lightctr_tpu_torch.obs import events as events_mod
from lightctr_tpu_torch.obs import flight as flight_mod
from lightctr_tpu_torch.obs import gate
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.obs.registry import MetricsRegistry, default_registry

_LOG = logging.getLogger(__name__)

#: every series this module writes — the AST lint in tests/test_obs.py
#: pins emissions to this declaration (both directions), the same
#: contract as EXCHANGE_SERIES / HEALTH_SERIES
STALL_SERIES = (
    "stall_trips_total",        # counter — stall episodes begun
    "stall_current",            # gauge — 1 while wedged, 0 otherwise
    "stall_seconds",            # histogram — episode durations at recovery
    "stall_deadline_seconds",   # gauge — the live trip deadline
    "stall_flight_dumps_total",  # counter — at-stall-time bundles landed
)

DEFAULT_FACTOR = 10.0
DEFAULT_MIN_S = 5.0


def _env_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if not val:
        return default
    try:
        return float(val)
    except ValueError:
        _LOG.warning("%s=%r is not a number; using %s", name, val, default)
        return default


def enabled_from_env() -> bool:
    """``LIGHTCTR_STALL=1`` arms the watchdog in every trainer of a
    launched run (the same inherit-the-env pattern as LIGHTCTR_FLIGHT)."""
    return os.environ.get("LIGHTCTR_STALL", "").strip().lower() in (
        "1", "true", "on", "yes",
    )


def maybe_from_env(monitor) -> Optional["StepWatch"]:
    """A started :class:`StepWatch` against ``monitor`` when the env arms
    one (and the health plane is on), else None — the trainer ctor hook."""
    if not enabled_from_env() or monitor is None or not health_mod.enabled():
        return None
    return StepWatch(monitor=monitor)


class StepWatch:
    """Wall-time-since-last-step watchdog (module docstring).

    ``monitor`` gains a :class:`~lightctr_tpu_torch.obs.health.StallDetector`
    (idempotent).  ``clock``/``start=False`` exist for deterministic
    tests; production callers keep the defaults and the poll thread."""

    def __init__(
        self,
        monitor: Optional[health_mod.HealthMonitor] = None,
        factor: Optional[float] = None,
        min_s: Optional[float] = None,
        warmup: int = 3,
        alpha: float = 0.25,
        hard_factor: float = 2.0,
        poll_s: Optional[float] = None,
        registry: Optional[MetricsRegistry] = None,
        flight_min_interval_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        start: bool = True,
    ):
        self.monitor = (monitor if monitor is not None
                        else health_mod.default_monitor())
        self.monitor.ensure_detector(
            health_mod.StallDetector(hard_factor=hard_factor)
        )
        self.factor = (float(factor) if factor is not None
                       else _env_float("LIGHTCTR_STALL_FACTOR",
                                       DEFAULT_FACTOR))
        self.min_s = (float(min_s) if min_s is not None
                      else _env_float("LIGHTCTR_STALL_MIN_S", DEFAULT_MIN_S))
        if self.factor <= 0 or self.min_s <= 0:
            raise ValueError("stall factor and min_s must be positive")
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.hard_factor = float(hard_factor)
        self.poll_s = (float(poll_s) if poll_s is not None
                       else max(0.05, self.min_s / 5.0))
        self.registry = registry if registry is not None else default_registry()
        self.flight_min_interval_s = float(flight_min_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._phase = "idle"
        self._ewma: Optional[float] = None
        self._steps = 0
        self._last_done = clock()
        # paused = deliberately not stepping (training finished, between
        # runs): the deadman must not read that as a wedge.  Any
        # completed step resumes the watch.
        self._paused = False
        self._stalled = False
        self._stall_t0 = 0.0
        self._trips = 0
        self._last_flight: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- trainer-side feed ---------------------------------------------------

    def mark(self, phase: str) -> None:
        """Record the phase the step is entering (``input`` / ``exec`` /
        ``exchange`` / ``apply`` — the live span-stack names): one
        attribute store, cheap enough for the un-traced hot path."""
        self._phase = str(phase)

    def step_completed(self, dt: float) -> None:
        """One step finished in ``dt`` seconds: fold it into the EWMA,
        reset the wall-time clock, and — if wedged — recover the verdict
        in this one observation."""
        now = self._clock()
        recovered = None
        with self._lock:
            d = float(dt)
            self._ewma = (d if self._ewma is None
                          else self._ewma + self.alpha * (d - self._ewma))
            self._steps += 1
            self._paused = False
            if self._stalled:
                recovered = now - self._stall_t0
                self._stalled = False
            self._last_done = now
            self._phase = "idle"
        if recovered is None:
            return
        if gate.enabled():
            self.registry.gauge_set("stall_current", 0)
            self.registry.observe("stall_seconds", recovered)
        events_mod.emit("stall", action="recovered", steps=self._steps,
                        stalled_s=round(recovered, 3))
        _LOG.warning("stepwatch: recovered after %.3fs wedged", recovered)
        self._observe(stalled=False, wait_s=0.0, ratio=0.0, phase="idle",
                      deadline_s=self.deadline())

    def deadline(self) -> float:
        """The live trip deadline, ``max(min_s, factor * ewma)``."""
        with self._lock:
            return max(self.min_s, self.factor * (self._ewma or 0.0))

    # -- the watch -----------------------------------------------------------

    def check(self, now: Optional[float] = None) -> Dict:
        """One watchdog observation (the poll thread's body; callable
        with an explicit ``now`` for deterministic tests).  Returns the
        status dict the stall signal carries."""
        now = self._clock() if now is None else now
        with self._lock:
            steps, ewma, phase = self._steps, self._ewma, self._phase
            wait = now - self._last_done
            deadline = max(self.min_s, self.factor * (ewma or 0.0))
            armed = steps >= self.warmup and not self._paused
            first_trip = False
            if armed and wait > deadline and not self._stalled:
                self._stalled = True
                # the wedge began when the last step finished — the
                # recovery histogram measures the whole gap
                self._stall_t0 = self._last_done
                self._trips += 1
                first_trip = True
            stalled = self._stalled
        status = {
            "stalled": stalled, "armed": armed, "steps": steps,
            "phase": phase, "wait_s": round(wait, 6),
            "deadline_s": round(deadline, 6),
            "ewma_s": round(ewma, 6) if ewma is not None else None,
            "ratio": round(wait / deadline, 4) if deadline > 0 else 0.0,
        }
        if stalled:
            # every poll while wedged: the detector escalates DEGRADED ->
            # UNHEALTHY as the ratio crosses hard_factor, and the
            # monitor's own pending-flight retry gets its observations.
            # Observed BEFORE the trip's flight dump, so the bundle's
            # health section already carries the stall verdict.
            self._observe(**{k: status[k] for k in
                             ("stalled", "wait_s", "deadline_s", "ratio",
                              "phase")})
        if first_trip:
            if gate.enabled():
                self.registry.inc("stall_trips_total")
                self.registry.gauge_set("stall_current", 1)
                self.registry.gauge_set("stall_deadline_seconds", deadline)
            events_mod.emit("stall", action="stall", phase=phase,
                            wait_s=status["wait_s"],
                            deadline_s=status["deadline_s"],
                            ewma_s=status["ewma_s"], steps=steps)
            _LOG.warning(
                "stepwatch: no step for %.3fs (deadline %.3fs, phase %s) — "
                "STALLED", wait, deadline, phase,
            )
            # the postmortem bundle of a wedge is only capturable WHILE
            # wedged — dump now, rate-limited like the health plane's
            # anomaly dumps
            self._maybe_flight(phase)
        return status

    def _observe(self, **signal) -> None:
        if self.monitor is None or not health_mod.enabled():
            return
        self.monitor.observe(stall=signal)

    def _maybe_flight(self, phase: str) -> Optional[str]:
        if not flight_mod.armed():
            return None
        now = self._clock()
        if (self._last_flight is not None
                and now - self._last_flight < self.flight_min_interval_s):
            return None
        path = flight_mod.dump(
            f"stall:{self.monitor.component}:{phase}"
        )
        if path is not None:
            self._last_flight = now
            if gate.enabled():
                self.registry.inc("stall_flight_dumps_total")
        return path

    # -- lifecycle -----------------------------------------------------------

    def pause(self) -> None:
        """Stand down until the next completed step: the trainer is
        DELIBERATELY idle (``fit`` returned, between runs), which the
        deadman must not read as a wedge.  A live stall recovers first —
        a pause is a statement about the future, not an amnesty for a
        wedge already in progress (callers reach the end of a run only
        after the last step completed anyway)."""
        now = self._clock()
        recovered = None
        with self._lock:
            if self._stalled:
                recovered = now - self._stall_t0
                self._stalled = False
            self._paused = True
        if recovered is not None:
            if gate.enabled():
                self.registry.gauge_set("stall_current", 0)
                self.registry.observe("stall_seconds", recovered)
            self._observe(stalled=False, wait_s=0.0, ratio=0.0,
                          phase="idle", deadline_s=self.deadline())

    def start(self) -> None:
        """Start the poll thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="lightctr-stepwatch", daemon=True,
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:
                # the watchdog must never take down what it watches
                _LOG.debug("stepwatch check failed", exc_info=True)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
