"""Structured JSONL event log: schema-versioned records, bounded ring,
periodic flush.

The reference traces with DEBUG printf; library code here emits typed
records instead — step events, exchange decisions, PS ops, failovers —
that a human tails and ``tools/metrics_report.py`` summarizes.

Record shape (one JSON object per line)::

    {"v": 1, "ts": <unix seconds>, "kind": "<event kind>", ...fields}

``v`` is the schema version: consumers must ignore records whose major
version they don't know.  Well-known kinds (docs/OBSERVABILITY.md):
``step``, ``epoch``, ``exchange``, ``failover``.

Buffering: events append to a bounded in-memory ring (oldest dropped once
``capacity`` is exceeded — ``dropped`` counts them).  With a ``path``, the
buffer flushes to the file (append, line-buffered JSONL) every
``flush_every`` events and on :meth:`flush`/:meth:`close`; the default
process log flushes at interpreter exit too.  Emission is thread-safe.
"""

from __future__ import annotations

import atexit
import json
import threading
import time
from typing import Dict, List, Optional

from lightctr_tpu_torch.obs import gate

SCHEMA_VERSION = 1


class EventLog:
    def __init__(
        self,
        path: Optional[str] = None,
        capacity: int = 4096,
        flush_every: int = 256,
    ):
        if flush_every < 1:
            raise ValueError("flush_every must be >= 1")
        if path is not None and flush_every > capacity:
            raise ValueError("flush_every must not exceed capacity (events "
                             "would drop before ever reaching the file)")
        self.path = path
        self.capacity = int(capacity)
        self.flush_every = int(flush_every)
        self._lock = threading.Lock()
        self._buf: List[Dict] = []  # records not yet flushed to the file
        self.emitted = 0
        self.dropped = 0
        self.flushed = 0
        self.flush_errors = 0
        if path is not None:
            # short-lived processes (benches, multiprocess-test workers)
            # must not lose the tail of the buffer between the last
            # flush_every boundary and interpreter exit
            atexit.register(self.flush)

    def emit(self, kind: str, **fields) -> None:
        """Append one record.  Fields must be JSON-serializable."""
        rec = {"v": SCHEMA_VERSION, "ts": round(time.time(), 6),
               "kind": str(kind)}
        rec.update(fields)
        with self._lock:
            self.emitted += 1
            self._buf.append(rec)
            if self.path is not None and len(self._buf) >= self.flush_every:
                self._flush_locked()
            elif len(self._buf) > self.capacity:
                del self._buf[0]
                self.dropped += 1

    def records(self) -> List[Dict]:
        """The buffered (not-yet-flushed) records, oldest first."""
        with self._lock:
            return list(self._buf)

    @staticmethod
    def _dump_record(rec: Dict) -> str:
        """One record -> one JSON line, never raising: a non-JSON value
        smuggled into a record (numpy scalar, set, ...) degrades THAT
        record via repr instead of poisoning the buffer forever — a
        TypeError escaping the flush would crash the instrumented caller
        and then re-raise on every later flush attempt."""
        try:
            return json.dumps(rec, sort_keys=True)
        except (TypeError, ValueError):
            try:
                return json.dumps(rec, sort_keys=True, default=repr)
            except (TypeError, ValueError):  # e.g. non-string dict keys
                return json.dumps({"unserializable": repr(rec)})

    def _flush_locked(self) -> None:
        if self.path is None or not self._buf:
            return
        try:
            with open(self.path, "a") as f:
                for rec in self._buf:
                    f.write(self._dump_record(rec) + "\n")
        except OSError:
            # telemetry must never kill the training step (full disk,
            # removed directory, ...): count the failure, fall back to
            # ring semantics so the buffer stays bounded, retry next flush
            self.flush_errors += 1
            overflow = len(self._buf) - self.capacity
            if overflow > 0:
                del self._buf[:overflow]
                self.dropped += overflow
            return
        self.flushed += len(self._buf)
        self._buf.clear()

    def flush(self) -> None:
        """Write every buffered record to ``path`` (no-op without one)."""
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        self.flush()
        if self.path is not None:
            # drop the atexit reference so a closed log can be collected
            try:
                atexit.unregister(self.flush)
            except Exception:
                pass


def read_jsonl(path: str, strict: bool = False) -> List[Dict]:
    """Load a JSONL event file back into records (blank lines skipped).

    Tolerant by default: a malformed line — the torn tail a crashed
    writer leaves behind, or a corrupted record — is skipped rather than
    aborting the whole read (``strict=True`` restores the raise), so a
    postmortem can always summarize what DID land."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if strict:
                    raise
    return out


_default = EventLog()
atexit.register(lambda: _default.flush())


def get_event_log() -> EventLog:
    return _default


def configure(
    path: Optional[str] = None,
    capacity: int = 4096,
    flush_every: int = 256,
) -> EventLog:
    """Replace the process-default event log (flushing the old one —
    close(), so a path-backed predecessor also drops its atexit
    registration instead of pinning itself for the process lifetime).
    ``configure()`` with no arguments resets to a fresh in-memory log."""
    global _default
    _default.close()
    _default = EventLog(path=path, capacity=capacity,
                        flush_every=flush_every)
    return _default


def emit(kind: str, **fields) -> None:
    """Emit to the process-default log; no-op while telemetry is disabled."""
    if gate.enabled():
        _default.emit(kind, **fields)
