"""Host-side liveness — the port's copy of the JAX package's control plane
minus ``initialize_multihost`` (which joins the JAX distributed runtime).

``HeartbeatMonitor`` is reference-equivalent liveness bookkeeping for the
host-side async components (the AsyncParamServer workers, data-feeder
threads): ``beat(worker)``, stale at 10s, dead at 20s (master.h:202-262),
and :func:`wire_heartbeat` routes its death/recovery events into a
parameter server's unroute/readmit.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

HEARTBEAT_PERIOD_S = 5.0   # master.h:202 (5 s period)
STALE_AFTER_S = 10.0       # master.h: 10 s -> immediate re-ping
DEAD_AFTER_S = 20.0        # master.h: 20 s -> declared dead


class HeartbeatMonitor:
    """Liveness ledger for host-side workers (master.h:202-262 semantics):
    ``beat(worker)`` marks liveness; a monitor thread declares workers stale
    at 10s and dead at 20s, invoking ``on_dead`` once per death."""

    def __init__(
        self,
        on_dead: Optional[Callable[[str], None]] = None,
        stale_after_s: float = STALE_AFTER_S,
        dead_after_s: float = DEAD_AFTER_S,
        period_s: float = HEARTBEAT_PERIOD_S,
        clock: Callable[[], float] = time.monotonic,
        on_recover: Optional[Callable[[str], None]] = None,
        on_stale: Optional[Callable[[str], None]] = None,
        on_stale_clear: Optional[Callable[[str], None]] = None,
        on_join: Optional[Callable[[str], None]] = None,
    ):
        self._last: Dict[str, float] = {}
        self._dead: set = set()
        # workers past stale_after_s but not yet dead — the DEGRADED
        # stage between alive and the dead cliff: entering it fires
        # on_stale ONCE (the master counts/events the transition); a
        # beat fires on_stale_clear (a listener tracking the degraded
        # set must see the improvement too), death supersedes it
        self._stale: set = set()
        # listener tuples:
        # (on_dead, on_recover, on_stale, on_stale_clear, on_join) —
        # on_join fires on a NEVER-SEEN worker's first beat (elastic
        # membership: a fresh node announcing itself is a join event the
        # master turns into an epoch bump, master.h:80-82 registration)
        self._listeners: list = []
        if any(cb is not None for cb in
               (on_dead, on_recover, on_stale, on_stale_clear, on_join)):
            self._listeners.append(
                (on_dead, on_recover, on_stale, on_stale_clear, on_join)
            )
        self.stale_after_s = stale_after_s
        self.dead_after_s = dead_after_s
        self.period_s = period_s
        self._clock = clock
        self._lock = threading.Lock()
        # liveness transitions append ("dead"|"recover", worker) events under
        # _lock; callbacks drain the queue under _dispatch_lock OUTSIDE _lock
        # (they may call back into the monitor).  The single ordered queue
        # makes callback order match the _dead-set transition order, so a
        # beat racing a death sweep can never leave a live worker unrouted.
        self._events: list = []
        # RLock: a callback may call beat()/check(), whose _dispatch
        # re-enters on the same thread
        self._dispatch_lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_listener(
        self,
        on_dead: Optional[Callable[[str], None]] = None,
        on_recover: Optional[Callable[[str], None]] = None,
        on_stale: Optional[Callable[[str], None]] = None,
        on_stale_clear: Optional[Callable[[str], None]] = None,
        on_join: Optional[Callable[[str], None]] = None,
    ) -> None:
        """Register death/recovery/staleness/join callbacks (the public
        wiring point for consumers like AsyncParamServer.attach_heartbeat)."""
        with self._lock:
            self._listeners.append(
                (on_dead, on_recover, on_stale, on_stale_clear, on_join)
            )

    def _dispatch(self) -> None:
        while True:
            with self._dispatch_lock:
                with self._lock:
                    if not self._events:
                        return
                    kind, worker = self._events.pop(0)
                    listeners = list(self._listeners)
                idx = {"dead": 0, "recover": 1, "stale": 2,
                       "stale_clear": 3, "join": 4}[kind]
                for cbs in listeners:
                    cb = cbs[idx]
                    if cb is not None:
                        cb(worker)

    def beat(self, worker: str) -> None:
        with self._lock:
            joined = worker not in self._last
            self._last[worker] = self._clock()
            if joined:
                # first-ever beat: a join event (clean departures forget()
                # the worker, so a later return is a fresh join again)
                self._events.append(("join", worker))
            if worker in self._stale:
                # returned before the dead line: clear the degraded
                # stage, drop any queued-but-undispatched stale event,
                # and tell listeners the degraded set SHRANK — a health
                # verdict fed only on worsening transitions would stay
                # degraded forever for a worker that never actually died
                self._stale.discard(worker)
                self._events = [
                    e for e in self._events
                    if not (e[0] == "stale" and e[1] == worker)
                ]
                self._events.append(("stale_clear", worker))
            if worker in self._dead:
                # re-registration of a returning node is tolerated
                # (master.h:80-82)
                self._dead.discard(worker)
                self._events.append(("recover", worker))
        self._dispatch()

    def forget(self, worker: str) -> None:
        """Clean departure (the reference's FIN shutdown handshake,
        master.h:146-190): stop tracking the worker so its silence after a
        deliberate exit is not declared a death.

        Takes _dispatch_lock FIRST (the same dispatch->state order
        _dispatch uses): a ('dead', w) event already popped but not yet
        delivered would otherwise fire after this purge and re-unroute the
        departed worker; waiting for the in-flight delivery keeps the
        caller's subsequent readmit broadcast strictly after it."""
        with self._dispatch_lock:
            with self._lock:
                self._last.pop(worker, None)
                self._dead.discard(worker)
                was_stale = worker in self._stale
                self._stale.discard(worker)
                # also purge queued transitions enqueued by a racing
                # check() sweep but not yet dispatched
                self._events = [e for e in self._events if e[1] != worker]
                if was_stale:
                    # a clean departure of a degraded worker still shrinks
                    # the degraded set — listeners must see it
                    self._events.append(("stale_clear", worker))
            self._dispatch()

    def peek(self) -> Dict[str, str]:
        """READ-ONLY view of worker -> 'alive' | 'stale' | 'dead', computed
        from beat ages without recording transitions or dispatching
        callbacks — the STATS wire op's view (transitions belong to the
        period thread's check() sweeps, never to a request thread)."""
        now = self._clock()
        out = {}
        with self._lock:
            for w, t in self._last.items():
                age = now - t
                out[w] = ("dead" if age >= self.dead_after_s else
                          "stale" if age >= self.stale_after_s else "alive")
        return out

    def dead_workers(self) -> set:
        """Copy of the declared-dead set (the master's routing view)."""
        with self._lock:
            return set(self._dead)

    def stale_workers(self) -> set:
        """Copy of the degraded (stale-but-not-dead) set."""
        with self._lock:
            return set(self._stale)

    def check(self) -> Dict[str, str]:
        """One sweep; returns worker -> 'alive' | 'stale' | 'dead'."""
        now = self._clock()
        out = {}
        with self._lock:
            for w, t in self._last.items():
                age = now - t
                if age >= self.dead_after_s:
                    out[w] = "dead"
                    self._stale.discard(w)  # death supersedes degraded
                    if w not in self._dead:
                        self._dead.add(w)
                        self._events.append(("dead", w))
                elif age >= self.stale_after_s:
                    out[w] = "stale"
                    if w not in self._stale and w not in self._dead:
                        # the degraded stage before the dead cliff:
                        # evented exactly once per silence episode
                        self._stale.add(w)
                        self._events.append(("stale", w))
                else:
                    out[w] = "alive"
        self._dispatch()
        return out

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.period_s):
                self.check()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.period_s)
            self._thread = None


def wire_heartbeat(monitor: "HeartbeatMonitor", ps, n_workers=None) -> None:
    """Route the monitor's death/recovery events into a parameter server's
    unroute_worker/readmit_worker (master.h:202-262 semantics), shared by the
    in-process and shared-memory PS.  PS workers beat with ``str(worker_id)``;
    non-integer (or negative) names belong to other components sharing the
    monitor and are ignored.  ``n_workers`` adds an exclusive upper bound on
    accepted ids — required for the shm PS, whose fixed-capacity ledger a
    stray id would grow; leave None for the in-process PS, which accepts any
    worker id (its n_workers only sizes DCASGD shadows)."""

    def to_wid(w):
        try:
            wid = int(w)
        except (TypeError, ValueError):
            return None
        if wid < 0 or (n_workers is not None and wid >= n_workers):
            return None
        return wid

    def on_dead(w):
        wid = to_wid(w)
        if wid is not None:
            ps.unroute_worker(wid)

    def on_recover(w):
        wid = to_wid(w)
        if wid is not None:
            ps.readmit_worker(wid)

    monitor.add_listener(on_dead=on_dead, on_recover=on_recover)
