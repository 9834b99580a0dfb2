"""Causal span tracer: end-to-end timelines from trainer step to PS shard.

The registry (obs/registry.py) answers *how much*; this module answers
*why a step was slow*: every instrumented region is a **span** — a named
interval with a ``trace_id`` (one per causal tree), a ``span_id``, and a
``parent_id`` — so a trainer step, the PS client RPC it issued, and the
server-side handler that served it line up as one tree even across
process boundaries (the client sends its current context as a varint
trace header on the PS wire, ``dist.wire.pack_trace_ctx``).

Design points:

  - **Off by default, one-branch cheap.**  Tracing activates only when
    the obs gate is on AND a sampling rate > 0 is set (``LIGHTCTR_TRACE``
    env or :func:`set_rate`).  Disabled, :func:`span` returns a shared
    ``nullcontext`` — no allocation, no lock — which is what the tier-1
    overhead guard measures.
  - **Sampling is per-trace.**  The head (root span) rolls the dice once;
    children and remote continuations inherit the decision, so a sampled
    trace is always complete and an unsampled one costs nothing but the
    roll.
  - **Bounded ring + EventLog sink.**  Finished spans land in a bounded
    in-memory ring (the crash flight recorder dumps it, obs/flight.py)
    and, when a path is configured (``LIGHTCTR_TRACE_DIR`` or
    :func:`configure`), stream to a JSONL file through the same
    :class:`~lightctr_tpu_torch.obs.events.EventLog` machinery the event log
    uses (bounded, thread-safe, atexit-flushed).
  - **Timestamps are wall-clock, durations are monotonic.**  ``ts`` is
    ``time.time()`` (the only clock processes share — Perfetto aligns
    multi-process traces with it); ``dur_s`` is a ``perf_counter`` delta.

``tools/trace_report.py`` summarizes span files (and flight bundles) and
exports Chrome-trace/Perfetto JSON.  See docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import collections
import contextlib
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from lightctr_tpu_torch.obs import gate
from lightctr_tpu_torch.obs.events import EventLog

SPAN_SCHEMA_VERSION = 1

#: ids are 63-bit so they survive the zigzag-varint int64 wire codec
_ID_BITS = 63


def _parse_rate(val: Optional[str]) -> float:
    """``LIGHTCTR_TRACE`` -> sampling rate: unset/0/off -> 0.0 (tracing
    disabled), ``1`` -> every trace, a float in (0, 1] -> head sampling."""
    if not val:
        return 0.0
    v = val.strip().lower()
    if v in ("0", "false", "off", "no", ""):
        return 0.0
    if v in ("1", "true", "on", "yes"):
        return 1.0
    try:
        rate = float(v)
    except ValueError:
        return 0.0
    return min(1.0, max(0.0, rate))


_rate: float = _parse_rate(os.environ.get("LIGHTCTR_TRACE"))
_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=4096)
_sink: Optional[EventLog] = None


class _Ctx(threading.local):
    """Per-thread span stack: entries are (trace_id, span_id) tuples for
    live sampled spans, or ``None`` for an unsampled trace head (so the
    whole subtree below it skips without re-rolling)."""

    def __init__(self):
        self.stack: list = []


_ctx = _Ctx()
_NULL = contextlib.nullcontext()


def _new_id() -> int:
    return random.getrandbits(_ID_BITS) or 1


def enabled() -> bool:
    """True when NEW root spans may start in this process (obs gate on and
    sampling rate > 0).  Remote continuations only need the gate."""
    return _rate > 0.0 and gate.enabled()


def set_rate(rate: float) -> float:
    """Set the head-sampling rate; returns the PREVIOUS rate."""
    global _rate
    prev = _rate
    _rate = min(1.0, max(0.0, float(rate)))
    return prev


@contextlib.contextmanager
def override_rate(rate: float):
    """Scoped sampling-rate override (tests, targeted captures)."""
    prev = set_rate(rate)
    try:
        yield
    finally:
        set_rate(prev)


def current_context() -> Optional[Tuple[int, int]]:
    """(trace_id, span_id) of the innermost live sampled span on THIS
    thread, or None — the tuple a client packs into the wire trace
    header.  Gate-checked so a disabled process never leaks context."""
    stack = _ctx.stack
    if not stack or not gate.enabled():
        return None
    return stack[-1]  # may be None: unsampled head marker


class _SpanCM:
    """Context manager for one span.  Records on exit; never raises."""

    __slots__ = ("_name", "_attrs", "_remote", "_rec", "_t0")

    def __init__(self, name: str, remote: Optional[Tuple[int, int]], attrs):
        self._name = name
        self._attrs = attrs
        self._remote = remote
        self._rec = None

    def __enter__(self):
        stack = _ctx.stack
        if self._remote is not None:
            trace_id, parent = self._remote
        elif stack:
            top = stack[-1]
            if top is None:  # inside an unsampled trace
                stack.append(None)
                return self
            trace_id, parent = top
        else:
            # trace head: one sampling roll decides the whole tree
            if _rate < 1.0 and random.random() >= _rate:
                stack.append(None)
                return self
            trace_id, parent = _new_id(), None
        span_id = _new_id()
        rec = {
            "kind": "span",
            "v": SPAN_SCHEMA_VERSION,
            "trace": f"{trace_id:016x}",
            "span": f"{span_id:016x}",
            "name": self._name,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if parent is not None:
            rec["parent"] = f"{parent:016x}"
        if self._attrs:
            rec["attrs"] = self._attrs
        self._rec = rec
        stack.append((trace_id, span_id))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0 if self._rec is not None else 0.0
        _ctx.stack.pop()
        rec = self._rec
        if rec is None:
            return False
        rec["dur_s"] = round(dur, 9)
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        with _lock:
            _ring.append(rec)
            sink = _sink
        if sink is not None:
            # outside the module lock: EventLog has its own lock, and its
            # periodic file flush must not serialize every thread's span
            # exits (PS connection threads all finish spans concurrently)
            sink.emit("span", **{k: v for k, v in rec.items()
                                 if k != "kind"})
        return False


def span(name: str, remote: Optional[Tuple[int, int]] = None, **attrs):
    """Span context manager.

    ``remote=(trace_id, parent_span_id)`` continues a trace started in
    ANOTHER process (the server side of the wire trace header): the
    sender already made the sampling decision, so only the obs gate is
    checked.  Without ``remote``, a root span rolls the sampling dice and
    children inherit the parent's decision — including children of a
    remote continuation in a process whose OWN rate is 0 (a PS server
    without LIGHTCTR_TRACE still records the full subtree under a traced
    request; the rate only gates NEW roots).

    Returns a shared nullcontext when tracing is off — the disabled path
    is one rate comparison plus a thread-local stack peek."""
    if remote is not None:
        if not gate.enabled():
            return _NULL
        return _SpanCM(name, remote, attrs)
    stack = _ctx.stack
    if stack:
        # a live parent carries the inherited sampling decision: record
        # (or skip) with it, independent of this process's head rate
        if stack[-1] is None or not gate.enabled():
            return _NULL
        return _SpanCM(name, None, attrs)
    if _rate <= 0.0 or not gate.enabled():
        return _NULL
    return _SpanCM(name, None, attrs)


# -- ring / sink management --------------------------------------------------


def finished() -> List[Dict]:
    """The bounded ring of finished span records, oldest first."""
    with _lock:
        return list(_ring)


def reset() -> None:
    """Drop all buffered spans (tests)."""
    with _lock:
        _ring.clear()


def configure(
    path: Optional[str] = None,
    capacity: int = 4096,
    flush_every: int = 16,
) -> None:
    """(Re)configure the span ring size and the JSONL file sink, starting
    a FRESH ring (spans from a previous configuration never leak into the
    next capture or flight bundle).  With a ``path``, finished spans
    stream to it through an EventLog (appended, flushed every
    ``flush_every`` spans and at exit).  ``configure()`` with no
    arguments drops the sink and resets the ring."""
    global _sink, _ring
    with _lock:
        if _sink is not None:
            _sink.close()
        _sink = (
            EventLog(path=path, capacity=capacity, flush_every=flush_every)
            if path is not None else None
        )
        _ring = collections.deque(maxlen=int(capacity))


def flush() -> None:
    """Flush the file sink (no-op without one)."""
    with _lock:
        sink = _sink
    if sink is not None:
        sink.flush()


def sink_path() -> Optional[str]:
    with _lock:
        return _sink.path if _sink is not None else None


# -- export ------------------------------------------------------------------


def to_chrome_trace(records) -> Dict:
    """Span records -> Chrome trace-event JSON (Perfetto-loadable): one
    complete ("X") event per span, plus flow arrows ("s"/"f") for edges
    that cross a process boundary, so the stitching is visible."""
    by_span = {}
    for r in records:
        if r.get("kind", "span") == "span" and "span" in r:
            by_span[r["span"]] = r
    events = []
    for r in by_span.values():
        args = {"trace": r.get("trace"), "span": r.get("span")}
        if "parent" in r:
            args["parent"] = r["parent"]
        if "error" in r:
            args["error"] = r["error"]
        args.update(r.get("attrs") or {})
        ts_us = float(r["ts"]) * 1e6
        dur_us = float(r.get("dur_s", 0.0)) * 1e6
        base = {"pid": r.get("pid", 0), "tid": r.get("tid", 0)}
        events.append({
            "name": r["name"], "cat": "lightctr", "ph": "X",
            "ts": ts_us, "dur": dur_us, "args": args, **base,
        })
        parent = by_span.get(r.get("parent"))
        if parent is not None and parent.get("pid") != r.get("pid"):
            # cross-process edge: draw the flow arrow parent -> child
            flow_id = int(r["span"], 16) & 0x7FFFFFFF
            events.append({
                "name": "rpc", "cat": "lightctr", "ph": "s",
                "id": flow_id, "ts": float(parent["ts"]) * 1e6,
                "pid": parent.get("pid", 0), "tid": parent.get("tid", 0),
            })
            events.append({
                "name": "rpc", "cat": "lightctr", "ph": "f", "bp": "e",
                "id": flow_id, "ts": ts_us,
                **base,
            })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- env wiring --------------------------------------------------------------

_dir = os.environ.get("LIGHTCTR_TRACE_DIR")
if _dir:
    # one span file per process: tools/trace_report.py merges the set.
    # Deliberately independent of the local rate — a PS server deployed
    # with only LIGHTCTR_TRACE_DIR still records (and must persist) the
    # subtrees of remote-continued traces; the file is not created until
    # a span actually flushes
    try:
        os.makedirs(_dir, exist_ok=True)
        configure(path=os.path.join(_dir, f"trace-{os.getpid()}.jsonl"))
    except OSError:
        pass  # tracing must never break the traced process
