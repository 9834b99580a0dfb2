"""Bounded per-key write log — the freshness surface PS stores share.

One mixin, two consumers (the flat :class:`~lightctr_tpu_torch.embed.async_ps.
AsyncParamServer` and the :class:`~lightctr_tpu.embed.tiered.
TieredEmbeddingStore`): every ``write_version`` bump logs the touched
uids with the server-side wall time of the write, bounded two ways
(entries AND total logged uids) so a stats/subscribe reply stays a
bounded control-plane payload whatever the write pattern.  Overflow
advances the FLOOR; a consumer whose last observation predates the floor
is told ``covered=False`` and must full-invalidate — correctness never
rides on the log's depth (docs/ONLINE.md).

Every delta record is stamped with ``server_time`` — the server's clock
at record time, the SAME clock that stamped the per-entry write times —
so a subscriber ages updates server-relative (``server_time - entry_ts``)
instead of comparing a remote wall clock against its own: cross-host
clock skew cancels out of the freshness measurement entirely (the PR 11
follow-up).

The long-poll (:meth:`WriteLogMixin.wait_write_delta`) parks on a
condition SHARING the store lock, so a push's ``notify_all`` costs one
syscall and a parked subscriber holds nothing while it waits.

Host stores call :meth:`WriteLogMixin._init_write_log` with their lock
in ``__init__`` and :meth:`WriteLogMixin._note_write` (lock held, version
already bumped) after every mutation of row values.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np


class WriteLogMixin:
    """Write-log surface: ``_note_write`` / ``write_delta_since`` /
    ``wait_write_delta`` + the ``stats()["write_delta"]`` record."""

    #: write-delta log bounds: entries AND total logged uids — a stats
    #: reply must stay a bounded control-plane payload no matter the
    #: write pattern (overflow advances the floor; consumers whose last
    #: observation predates the floor full-invalidate instead)
    WRITE_LOG_MAX_ENTRIES = 128
    WRITE_LOG_MAX_UIDS = 4096

    def _init_write_log(self, lock) -> None:
        """Arm the log.  ``lock`` is the STORE lock — the long-poll
        condition shares it, so a notify from ``_note_write`` is always
        owned."""
        self._write_cond = threading.Condition(lock)
        self._write_log: list = []       # [(version, np.int64 uids, ts)]
        self._write_log_uids = 0
        self._write_log_floor = 0        # log covers (floor, write_version]

    def _note_write(self, keys: np.ndarray) -> None:
        """Record the uids of one ``write_version`` bump (caller holds the
        lock and has ALREADY bumped).  A superset of the truly-changed
        keys is fine (the consumer merely drops a few extra cached rows);
        a miss is not — every bump must either log or advance the floor.
        Each entry carries the WALL time of the write, so a freshness
        subscriber can report the age of the newest update it applied
        (docs/ONLINE.md) without per-row timestamps on the hot path; and
        every bump wakes the long-poll waiters parked in
        :meth:`wait_write_delta`."""
        arr = np.ascontiguousarray(keys, np.int64).reshape(-1)
        self._write_log.append((self.write_version, arr, time.time()))
        self._write_log_uids += int(arr.size)
        while self._write_log and (
                len(self._write_log) > self.WRITE_LOG_MAX_ENTRIES
                or self._write_log_uids > self.WRITE_LOG_MAX_UIDS):
            ver, dropped, _ts = self._write_log.pop(0)
            self._write_log_uids -= int(dropped.size)
            self._write_log_floor = ver
        self._write_cond.notify_all()

    def _write_delta_record(self) -> Dict:
        """The ``stats()["write_delta"]`` section (caller holds the lock):
        the full bounded log as ``[version, uids, ts]`` triples plus the
        floor and the server clock — the record the polling degrade path
        consumes (freshness subscribers read the same shape)."""
        return {
            "floor": self._write_log_floor,
            # [version, uids, write wall-time] triples: the ts lets
            # freshness consumers age the updates they apply
            "entries": [[int(v), u.tolist(), t]
                        for v, u, t in self._write_log],
            # the same clock that stamped the entry ts values — consumers
            # age server-relative so cross-host skew cancels
            "server_time": time.time(),
        }

    def _delta_since_locked(self, since: int) -> Dict:
        """The write-log delta one subscriber observation consumes (caller
        holds the lock): every logged entry past ``since``, or — when the
        floor has advanced beyond ``since`` — ``covered=False``, telling
        the consumer its observation predates the log and only a full
        invalidation is safe (correctness never rides on log depth)."""
        covered = since >= self._write_log_floor
        entries = (
            [[int(v), u.tolist(), t] for v, u, t in self._write_log
             if v > since]
            if covered else []
        )
        return {
            "write_version": self.write_version,
            "floor": self._write_log_floor,
            "covered": bool(covered),
            "entries": entries,
            "server_time": time.time(),
        }

    def write_delta_since(self, since: int) -> Dict:
        """Non-blocking form of :meth:`wait_write_delta`."""
        with self._write_cond:
            return self._delta_since_locked(int(since))

    def wait_write_delta(self, since: int, timeout_s: float) -> Dict:
        """LONG-POLL the write log: block until ``write_version`` moves
        past ``since`` (or ``timeout_s`` elapses), then return the delta
        record of :meth:`write_delta_since`.  The push-based freshness
        primitive (docs/ONLINE.md): a serving replica parks here over
        ``MSG_SUBSCRIBE`` and learns of a trained key one notify after
        the push lands, instead of discovering it at the next version
        poll.  The condition shares the store lock and the wait releases
        it, so parked subscribers cost pushes one ``notify_all``."""
        since = int(since)
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        with self._write_cond:
            while self.write_version <= since:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._write_cond.wait(remaining)
            return self._delta_since_locked(since)
