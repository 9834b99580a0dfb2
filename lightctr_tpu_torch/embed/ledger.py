"""Shared touched-uid frequency ledger — the admission signal of the tiers.

CTR id traffic is power-law skewed, and the repo already computes the
touched-uid streams that expose it in three places: the sparse exchange
dedups every batch's ids (Parallax, 1808.02621), the health plane's
hot/dead-key detector classifies their density (obs/health.py
TableSkewDetector), and the serving cache's TinyLFU admission counts them
(serve/cache.py).  This module is the ONE ledger those consumers share:
a decayed per-uid touch count fed by deduped batch id streams, consulted
by

  - :class:`~lightctr_tpu_torch.embed.tiered.TieredEmbeddingStore` for TinyLFU
    admission (a missed row enters the full hot tier only when its count
    beats the coldest resident's), and
  - :class:`~lightctr_tpu_torch.serve.cache.HotEmbeddingCache.warm_from_ledger`
    serve-start pre-pulls.

The ledger sits on the PS hot path (every pull/push batch touches it), so
it is a **count-min sketch** — TinyLFU's own structure — not a hash map:
``depth`` counter rows indexed by independent lane-FNV hashes, a batch
touch is one vectorized scatter-add per row and a read is a gather + min.
No per-key Python, no probe chains, no growth; counts are upper bounds
whose bias is bounded by the sketch ``width`` (default 2^17 counters/row,
1 MB total — far wider than any working set the fast tiers can hold).

Decay halves every counter each ``decay_every`` touch batches (one
vectorized multiply — TinyLFU's aging), so frequencies track the RECENT
stream: yesterday's hot keys age out instead of squatting in the fast
tiers forever.

A sketch cannot enumerate its keys, so :meth:`top_k` (the serve-start
warm-up set) rides an exact bounded side-table of the highest-count uids
seen, maintained only for keys whose sketch count clears the table's
floor — ``top_cap=0`` disables it for owners that never enumerate (the
tiered store keeps per-slot resident counts of its own).
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np

from lightctr_tpu_torch.dist.partition import fnv1a64_keys

# distinct odd multipliers decorrelate the sketch rows (splitmix64 /
# Weyl-sequence constants; any fixed odd 64-bit constants work)
_ROW_SALTS = (
    0x9E3779B97F4A7C15,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x27D4EB2F165667C5,
)


class FrequencyLedger:
    """Decayed approximate touch counts over a deduped uid stream
    (thread-safe, count-min sketch)."""

    def __init__(
        self,
        decay_every: int = 1000,
        decay_factor: float = 0.5,
        width: int = 1 << 17,
        depth: int = 2,
        top_cap: int = 8192,
    ):
        """``width`` counters per row (rounded up to a power of two),
        ``depth`` rows (more rows -> tighter count upper bound, more
        cost per touch).  ``top_cap``: size of the exact top-uid side
        table behind :meth:`top_k` (0 disables it — cheapest)."""
        if not 1 <= depth <= len(_ROW_SALTS):
            raise ValueError(f"depth must be in [1, {len(_ROW_SALTS)}]")
        w = 1
        while w < width:
            w <<= 1
        self.width = w
        self.depth = int(depth)
        self.decay_every = int(decay_every)
        self.decay_factor = float(decay_factor)
        self.top_cap = int(top_cap)
        self._lock = threading.Lock()
        self._cms = np.zeros((self.depth, self.width), np.float32)
        self._mask = np.uint64(self.width - 1)
        self._salts = [np.uint64(s) for s in _ROW_SALTS[: self.depth]]
        # exact side table for top_k: uid -> last observed sketch count
        self._top: Dict[int, float] = {}
        self._top_floor = 0.0
        self.touch_batches = 0
        self.decays = 0

    def _rows_idx(self, uids: np.ndarray) -> list:
        """Per-row counter indices for a uid batch (one vectorized hash,
        salted per row)."""
        h = fnv1a64_keys(np.ascontiguousarray(uids, np.int64))
        return [((h * s) >> np.uint64(13)) & self._mask
                for s in self._salts]

    # -- feed ----------------------------------------------------------------

    def touch(self, uids: np.ndarray) -> None:
        """Bump counts for ONE batch's deduped ids (callers dedup — the
        same per-batch unique stream the exchange/skew-detector use)."""
        uids = np.ascontiguousarray(uids, np.int64)
        with self._lock:
            if len(uids):
                idx = self._rows_idx(uids)
                for r in range(self.depth):
                    # callers dedup, so plain fancy-add is exact per row
                    # (sketch collisions remain upper-bound noise)
                    self._cms[r, idx[r]] += 1.0
                if self.top_cap:
                    counts = self._cms[0, idx[0]]
                    for r in range(1, self.depth):
                        np.minimum(counts, self._cms[r, idx[r]], out=counts)
                    self._note_top(uids, counts)
            self.touch_batches += 1
            if self.decay_every and \
                    self.touch_batches % self.decay_every == 0:
                self._decay_locked()

    def touch_and_get(self, uids: np.ndarray) -> np.ndarray:
        """Fused :meth:`touch` + :meth:`get` for ONE batch's deduped ids:
        bump and return the post-bump counts with a single hash pass and
        lock acquisition — the store's fault path calls this every miss
        batch, so the sketch is consulted exactly once per batch."""
        uids = np.ascontiguousarray(uids, np.int64)
        with self._lock:
            if not len(uids):
                counts = np.zeros(0, np.float64)
            else:
                idx = self._rows_idx(uids)
                self._cms[0, idx[0]] += 1.0
                counts = self._cms[0, idx[0]].astype(np.float64)
                for r in range(1, self.depth):
                    self._cms[r, idx[r]] += 1.0
                    np.minimum(counts, self._cms[r, idx[r]], out=counts)
                if self.top_cap:
                    self._note_top(uids, counts)
            self.touch_batches += 1
            if self.decay_every and \
                    self.touch_batches % self.decay_every == 0:
                self._decay_locked()
            return counts

    def _note_top(self, uids: np.ndarray, counts: np.ndarray) -> None:
        """Fold a batch's (uid, count) into the exact top table; only
        keys clearing the table's floor pay the per-key update."""
        passing = counts >= max(self._top_floor, 1.0)
        if not passing.any():
            return
        top = self._top
        for u, c in zip(uids[passing].tolist(),
                        counts[passing].tolist()):
            top[u] = c
        if len(top) > 2 * self.top_cap:
            self._prune_top()

    def _prune_top(self) -> None:
        vals = np.fromiter(self._top.values(), np.float64, count=len(self._top))
        floor = float(np.partition(vals, -self.top_cap)[-self.top_cap])
        self._top = {u: c for u, c in self._top.items() if c >= floor}
        self._top_floor = floor

    def _decay_locked(self) -> None:
        self._cms *= self.decay_factor
        if self._top:
            f = self.decay_factor
            self._top = {u: c * f for u, c in self._top.items()}
            self._top_floor *= f
        self.decays += 1

    def decay_now(self) -> None:
        """Force one decay step outside the cadence (tests, manual aging)."""
        with self._lock:
            self._decay_locked()

    # -- reads ---------------------------------------------------------------

    def get(self, uids: np.ndarray) -> np.ndarray:
        """Vectorized count read -> float64 array (sketch upper bound;
        0.0 for untouched uids)."""
        uids = np.ascontiguousarray(uids, np.int64)
        with self._lock:
            if not len(uids):
                return np.zeros(0, np.float64)
            idx = self._rows_idx(uids)
            counts = self._cms[0, idx[0]].astype(np.float64)
            for r in range(1, self.depth):
                np.minimum(counts, self._cms[r, idx[r]], out=counts)
            return counts

    def freq(self, uid: int) -> float:
        return float(self.get(np.array([uid], np.int64))[0])

    def top_k(self, k: int) -> np.ndarray:
        """The ``k`` highest-count uids seen (ties broken by uid for
        determinism), hottest first — the serve-start warm-up set.
        Requires ``top_cap > 0``."""
        with self._lock:
            items = list(self._top.items())
        if not items or k <= 0:
            return np.zeros(0, np.int64)
        uids = np.fromiter((u for u, _ in items), np.int64, count=len(items))
        counts = np.fromiter(
            (c for _, c in items), np.float64, count=len(items)
        )
        order = np.lexsort((uids, -counts))
        return uids[order[: int(k)]]

    def __len__(self) -> int:
        with self._lock:
            return int(np.count_nonzero(self._cms[0]))

    def stats(self) -> Dict:
        with self._lock:
            return {
                "width": self.width,
                "depth": self.depth,
                "nonzero_counters": int(np.count_nonzero(self._cms[0])),
                "tracked_top_uids": len(self._top),
                "touch_batches": self.touch_batches,
                "decays": self.decays,
            }
