"""mmap-backed cold tier: the host-side ``PersistentBuffer``.

The reference keeps an mmap'd file-backed buffer for parameters that
outlive a process (``common/persistent_buffer.h:26-90``, O_CREAT +
ftruncate + mmap) but never wires it into the PS.  This module closes that
gap as the COLD tier of the tiered embedding store: a key -> float row
store on disk whose resident footprint is just the page cache — a
billion-row-vocabulary table costs file bytes, not host RAM.

Design (checksum-framed record file + sorted in-memory key index):

  - ``<path>`` holds a 16-byte header then fixed-size records::

        [u64 key][u64 flags][f32 row x width][pad to 8][u64 checksum]

    The file is ftruncate'd with HEADROOM and mapped ONCE as a writable
    shared mapping: a NEW key appends a record at the tail, an EXISTING
    key updates its record in place — both are vectorized scatters into
    the page cache (no per-batch seek/write/remap syscalls, the fixed
    costs that would dominate a push-heavy cold tier).  Deletes append a
    tombstone (``flags & 1``).
  - the key index is an in-memory sorted-key array pair (one vectorized
    binary search per lookup, merge-insert per append batch) mapping
    key -> newest record, rebuilt from the file at open.  In-place
    updates never touch it.

Crash safety (the ``ckpt/checkpoint.py`` discipline, at record
granularity):

  - file CREATION and COMPACTION stage into a same-directory tmp path,
    fsync, and atomically rename into place — a writer killed mid-compact
    leaves a ``*.tmp-*`` turd, never a half-written store;
  - every record carries a weighted-lane checksum of its own bytes, so a
    writer
    killed mid-write leaves records the next open DETECTS: recovery keeps
    every intact record, drops torn ones (``dropped_records``), and
    truncates the zero-filled headroom/tail — kill-mid-append loses at
    most the records of the interrupted batch, never the store (the
    kill-mid-append drill in tests/test_tiered.py).  An in-place update
    torn mid-write loses THAT row alone — bounded, unlike the flat
    store's lose-everything-since-last-checkpoint crash story.
"""

from __future__ import annotations

import mmap
import os
import threading
from typing import Dict, Tuple

import numpy as np

def sorted_insert(arr: np.ndarray, pos: np.ndarray,
                  vals: np.ndarray) -> np.ndarray:
    """``np.insert(arr, pos, vals)`` for the sorted-merge case (``vals``
    sorted, ``pos = arr.searchsorted(vals)``): two scatter copies instead
    of np.insert's generic python-level path — this merge sits on every
    tier-index append and every hot-residency change."""
    k = len(vals)
    out = np.empty(len(arr) + k, arr.dtype)
    dst = pos + np.arange(k)
    out[dst] = vals
    keep = np.ones(len(out), bool)
    keep[dst] = False
    out[keep] = arr
    return out


def sorted_delete(arr: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """``np.delete(arr, pos)`` as one boolean compress."""
    keep = np.ones(len(arr), bool)
    keep[pos] = False
    return arr[keep]


_MAGIC = b"LCMRS01\n"
_HEADER_BYTES = 16  # magic[8] + u32 width + u32 reserved
_EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)  # reserved key (all-ones)
_FLAG_TOMBSTONE = 1
_FLAG_BAD = 2  # in-memory only: record failed its checksum at recovery


def _rec_layout(width: int) -> Tuple[int, int]:
    """(record bytes, row padding bytes) for a row of ``width`` floats.
    The checksummed prefix (key + flags + row + pad) is 8-byte aligned so
    the whole file views as uint64 lanes."""
    pad = (-4 * width) % 8
    return 16 + 4 * width + pad + 8, pad


_W_CACHE: Dict[int, np.ndarray] = {}


def _lane_weights(k: int) -> np.ndarray:
    """Fixed per-position odd 64-bit weights (splitmix64 of the lane
    index) — position-dependent, so permuted lanes do not collide."""
    w = _W_CACHE.get(k)
    if w is None:
        x = np.arange(1, k + 1, dtype=np.uint64) \
            * np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        w = x | np.uint64(1)
        _W_CACHE[k] = w
    return w


def _lane_checksums(lanes: np.ndarray) -> np.ndarray:
    """One checksum per ROW of a [n, k] uint64 lane matrix: a weighted
    lane sum mod 2^64 (two vectorized ops, vs a k-step sequential FNV —
    this sits on every cold-tier write).  The nonzero basis means an
    all-zero record (unwritten headroom) can NEVER validate; per-position
    weights catch torn/reordered lanes."""
    w = _lane_weights(lanes.shape[1])
    with np.errstate(over="ignore"):
        return (
            (lanes * w).sum(axis=1, dtype=np.uint64)
            + np.uint64(0xCBF29CE484222325)
        )


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class MmapRowStore:
    """Durable key -> float[width] row store (single-writer, in-process).

    Not a cross-process store (that is the warm tier's ``ShmKV``): ONE
    tiered store owns it, so the index can live in host memory and writes
    need no cross-process atomicity — only crash-atomicity, which the
    per-record checksum framing provides."""

    def __init__(self, path: str, f, width: int, create: bool):
        self.path = path
        self.width = int(width)
        self.rec_bytes, self._pad = _rec_layout(self.width)
        self._lanes = (self.rec_bytes - 8) // 8
        # even widths (every [row || accum] payload) pad to nothing, so
        # records build/scatter/gather whole-lane in the u64 domain —
        # 8x fewer element copies than the byte path on the write-heavy
        # cold fault road
        self._u64_ok = self._pad == 0
        self._rec_lanes = self.rec_bytes // 8
        self._f = f
        self._mm = None
        self._mm_bytes = 0
        self._lock = threading.RLock()
        # record mirrors (parallel to the file): index rebuilds and
        # snapshot walks never re-read the file
        self._rk = np.zeros(0, np.uint64)   # record -> key
        self._rflags = np.zeros(0, np.uint8)
        self._n_rec = 0
        self.recovered_records = 0
        self.dropped_records = 0
        self._new_index()
        if not create:
            self._recover()

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, path: str, width: int) -> "MmapRowStore":
        """Create an empty store, replacing any file at ``path`` —
        atomically (tmp + fsync + rename), so a concurrent reader of an
        old incarnation never sees a half-written header."""
        tmp = os.path.join(
            os.path.dirname(path) or ".",
            f".{os.path.basename(path)}.tmp-{os.getpid()}",
        )
        with open(tmp, "wb") as f:
            f.write(_MAGIC + np.array([width, 0], "<u4").tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")
        return cls(path, open(path, "r+b"), width, create=True)

    @classmethod
    def open(cls, path: str) -> "MmapRowStore":
        f = open(path, "r+b")
        head = f.read(_HEADER_BYTES)
        if len(head) < _HEADER_BYTES or head[:8] != _MAGIC:
            f.close()
            raise ValueError(f"{path}: not an MmapRowStore (bad header)")
        width = int(np.frombuffer(head[8:12], "<u4")[0])
        if width <= 0:
            f.close()
            raise ValueError(f"{path}: corrupt header width {width}")
        return cls(path, f, width, create=False)

    @classmethod
    def open_or_create(cls, path: str, width: int) -> "MmapRowStore":
        if os.path.exists(path):
            store = cls.open(path)
            if store.width != width:
                store.close()
                raise ValueError(
                    f"{path}: existing store width {store.width} != {width}"
                )
            return store
        return cls.create(path, width)

    def _drop_map(self, flush: bool = True) -> None:
        """``flush=False`` skips the msync — safe when the mapping is
        dropped only to re-map the SAME file larger (the data sits in the
        page cache either way; durability is ``sync``/``close``'s job)."""
        if self._mm is not None:
            if flush:
                self._mm.flush()
            self._mm.close()
            self._mm = None
            self._mm_bytes = 0

    def close(self) -> None:
        with self._lock:
            self._drop_map()
            if self._f is not None:
                try:
                    # drop the headroom so the file on disk ends exactly
                    # at the last record (a clean log reopens with zero
                    # dropped records)
                    self._f.truncate(self.file_bytes)
                except OSError:
                    pass
                self._f.close()
                self._f = None

    def sync(self) -> None:
        with self._lock:
            if self._mm is not None:
                self._mm.flush()
            if self._f is not None:
                os.fsync(self._f.fileno())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the shared writable map ----------------------------------------------

    def _ensure_map(self, need: int) -> None:
        """One writable shared mapping with HEADROOM: the file is
        pre-extended (ftruncate) past the logical end and mapped once, so
        appends and in-place updates are vectorized numpy scatters into
        the page cache — zero per-batch syscalls.  The zero-filled
        headroom fails record checksums, so a crash mid-anything recovers
        record-by-record."""
        if self._mm is not None and self._mm_bytes >= need:
            return
        self._drop_map(flush=False)
        size = os.fstat(self._f.fileno()).st_size
        phys = max(2 * need, 1 << 20)
        if phys > size:
            os.ftruncate(self._f.fileno(), phys)
        else:
            phys = size
        self._mm = mmap.mmap(self._f.fileno(), phys,
                             access=mmap.ACCESS_WRITE)
        self._mm_bytes = phys

    def _records_view(self, n: int) -> np.ndarray:
        """[n, rec_bytes] uint8 view over the first ``n`` record slots of
        the mapping (extending it when ``n`` exceeds the mapped region).
        Caller holds the lock and must not keep the view past it —
        compaction swaps the mapping."""
        self._ensure_map(_HEADER_BYTES + n * self.rec_bytes)
        return np.frombuffer(
            self._mm, np.uint8, count=n * self.rec_bytes,
            offset=_HEADER_BYTES,
        ).reshape(n, self.rec_bytes)

    def _records_view64(self, n: int) -> np.ndarray:
        """[n, rec_lanes] uint64 view over the same region (the 16-byte
        header keeps records 8-aligned).  Caller holds the lock."""
        self._ensure_map(_HEADER_BYTES + n * self.rec_bytes)
        return np.frombuffer(
            self._mm, np.dtype("<u8"), count=n * self._rec_lanes,
            offset=_HEADER_BYTES,
        ).reshape(n, self._rec_lanes)

    # -- torn-write recovery ---------------------------------------------------

    def _recover(self) -> None:
        """Scan the file, validate every record's checksum, KEEP the
        intact ones (torn records — an interrupted in-place update, a
        half-appended batch, zeroed headroom — are dropped and counted),
        truncate past the last intact record, and rebuild the index
        last-record-wins."""
        self._drop_map()
        self._f.seek(0, os.SEEK_END)
        size = self._f.tell()
        n = (size - _HEADER_BYTES) // self.rec_bytes
        good_tail = 0
        if n > 0:
            recs = self._records_view(n)
            lanes = np.ascontiguousarray(
                recs[:, : self.rec_bytes - 8]
            ).view("<u8").reshape(n, -1)
            want = recs[:, self.rec_bytes - 8:].copy().view("<u8").reshape(n)
            ok = _lane_checksums(lanes) == want
            good_idx = np.flatnonzero(ok)
            good_tail = int(good_idx[-1]) + 1 if good_idx.size else 0
            self._rk = recs[:good_tail, :8].copy().view("<u8").reshape(
                good_tail)
            self._rflags = recs[:good_tail, 8].copy()
            # interior torn records: flagged BAD so the index rebuild
            # skips them (their key/flag bytes are not trustworthy)
            bad = ~ok[:good_tail]
            if bad.any():
                self._rflags[bad] |= _FLAG_BAD
            self.dropped_records = int(n - good_tail + bad.sum())
            self.recovered_records = int(good_tail - bad.sum())
            del lanes
            del recs  # release the mmap view before _drop_map below
        else:
            self.dropped_records = 0
            self.recovered_records = 0
        self._n_rec = good_tail
        valid_end = _HEADER_BYTES + good_tail * self.rec_bytes
        if valid_end != size:
            # drop the torn/zero tail so the next append lands on a clean
            # record boundary (and a later reopen sees a clean file)
            self._drop_map()
            self._f.truncate(valid_end)
            self._f.flush()
            os.fsync(self._f.fileno())
        self._rebuild_index()

    # -- sorted key index ------------------------------------------------------
    #
    # key -> newest-record map as TWO pairs of aligned arrays: ``_ik``/
    # ``_iv`` the big SORTED (u64 order) main run, ``_tk``/``_tv`` a small
    # sorted tail of recent inserts.  Lookups are one vectorized binary
    # search per run (~8 numpy calls per batch); inserts land in the tail
    # (two memcpys of <= _TAIL_MAX elements) and merge into the main run
    # only when the tail fills — a million-key index no longer pays an
    # O(n) whole-index copy per append batch, just one merge per
    # _TAIL_MAX new keys (numpy CALL overhead plus that copy dominated
    # the tiered fault path; the open-addressed probe loop this replaced
    # cost dozens of calls per batch).

    _TAIL_MAX = 4096

    def _new_index(self) -> None:
        self._ik = np.zeros(0, np.uint64)
        self._iv = np.zeros(0, np.int64)
        self._tk = np.zeros(0, np.uint64)
        self._tv = np.zeros(0, np.int64)

    def _merge_tail(self) -> None:
        """Fold the tail run into the main run (both sorted, disjoint:
        one searchsorted + two scatter copies)."""
        if not len(self._tk):
            return
        ins = self._ik.searchsorted(self._tk)
        self._ik = sorted_insert(self._ik, ins, self._tk)
        self._iv = sorted_insert(self._iv, ins, self._tv)
        self._tk = np.zeros(0, np.uint64)
        self._tv = np.zeros(0, np.int64)

    def _probe(self, ks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized lookup -> (record index per key, found mask); the
        record index is -1 (meaningless) where ``found`` is False."""
        recs = np.full(len(ks), -1, np.int64)
        found = np.zeros(len(ks), bool)
        n = len(self._ik)
        if n:
            pos = np.minimum(np.searchsorted(self._ik, ks), n - 1)
            f = self._ik[pos] == ks
            if f.any():
                recs[f] = self._iv[pos[f]]
                found |= f
        tn = len(self._tk)
        if tn:
            # the runs are disjoint: probing every key (not just main
            # misses) saves the subset fancy-index and cannot conflict
            tpos = np.minimum(np.searchsorted(self._tk, ks), tn - 1)
            tf = self._tk[tpos] == ks
            if tf.any():
                recs[tf] = self._tv[tpos[tf]]
                found |= tf
        return recs, found

    def _index_set(self, ks: np.ndarray, recs: np.ndarray) -> None:
        """Insert/overwrite key -> record mappings (duplicate keys within
        the batch resolve last-wins — the last-record-wins contract)."""
        uniq, inv = np.unique(ks, return_inverse=True)
        ur = np.empty(len(uniq), np.int64)
        ur[inv] = recs  # fancy assignment: last occurrence wins
        n = len(self._ik)
        if n:
            pos = np.minimum(np.searchsorted(self._ik, uniq), n - 1)
            fmain = self._ik[pos] == uniq
            if fmain.any():
                self._iv[pos[fmain]] = ur[fmain]
            rest = ~fmain
        else:
            rest = np.ones(len(uniq), bool)
        if not rest.any():
            return
        rk, rv = uniq[rest], ur[rest]
        tn = len(self._tk)
        if tn:
            tpos = np.minimum(np.searchsorted(self._tk, rk), tn - 1)
            ftail = self._tk[tpos] == rk
            if ftail.any():
                self._tv[tpos[ftail]] = rv[ftail]
            new = ~ftail
        else:
            new = np.ones(len(rk), bool)
        if new.any():
            ins = self._tk.searchsorted(rk[new])
            self._tk = sorted_insert(self._tk, ins, rk[new])
            self._tv = sorted_insert(self._tv, ins, rv[new])
            if len(self._tk) >= self._TAIL_MAX:
                self._merge_tail()

    def _rebuild_index(self) -> None:
        """Index = last record per key, tombstones and torn records
        excluded (vectorized: stable sort by key, boundary pick)."""
        self._new_index()
        if not self._n_rec:
            return
        usable = (self._rflags[: self._n_rec] & _FLAG_BAD) == 0
        recs_all = np.flatnonzero(usable)
        if not recs_all.size:
            return
        rk = self._rk[recs_all]
        order = np.argsort(rk, kind="stable")
        sk = rk[order]
        last = np.flatnonzero(np.concatenate([sk[1:] != sk[:-1], [True]]))
        keys = sk[last]
        recs = recs_all[order[last]].astype(np.int64)
        alive = (self._rflags[recs] & _FLAG_TOMBSTONE) == 0
        if alive.any():
            # keys are already sorted-unique: assign the index directly
            self._ik = keys[alive].copy()
            self._iv = recs[alive]

    # -- reads ----------------------------------------------------------------

    @property
    def n_rows(self) -> int:
        """Live (non-tombstoned, deduplicated) keys."""
        return len(self._ik) + len(self._tk)

    @property
    def n_records(self) -> int:
        """Total records (live + superseded + tombstones) — the
        compaction trigger reads this."""
        return self._n_rec

    @property
    def file_bytes(self) -> int:
        return _HEADER_BYTES + self._n_rec * self.rec_bytes

    @staticmethod
    def _as_u64(keys: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(keys, np.int64).view(np.uint64)

    def _read_rows(self, recs: np.ndarray) -> np.ndarray:
        """Gather rows for record indices: one fancy-index copy out of the
        page-cache-resident mapping."""
        if not len(recs):
            return np.zeros((0, self.width), np.float32)
        if self._u64_ok:
            lanes = self._records_view64(self._n_rec)[
                recs, 2:2 + self.width // 2
            ]
            return lanes.view("<f4").reshape(len(recs), self.width)
        rows = self._records_view(self._n_rec)[recs, 16:16 + 4 * self.width]
        return np.ascontiguousarray(rows).view("<f4").reshape(
            len(recs), self.width
        )

    def get_batch(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rows [n, width] fp32, found bool [n]); missing rows zero."""
        return self.get_batch_refs(keys, zero_misses=True)[:2]

    def get_batch_refs(
        self, keys: np.ndarray, zero_misses: bool = False
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Like :meth:`get_batch` but also returns each found key's RECORD
        index (-1 for misses) — an :meth:`update_records` ticket that
        saves the write path its own probe.  Tickets stay valid until the
        next append/delete/compact.  Unless ``zero_misses``, MISS rows
        are undefined — the tiered fault path never reads them, and
        zero-filling the buffer was pure memset."""
        with self._lock:
            ks = self._as_u64(keys)
            out = (np.zeros if zero_misses else np.empty)(
                (len(ks), self.width), np.float32)
            recs = np.full(len(ks), -1, np.int64)
            if not len(ks):
                return out, np.zeros(0, bool), recs
            precs, found = self._probe(ks)
            if found.any():
                recs[found] = precs[found]
                out[found] = self._read_rows(recs[found])
            return out, found, recs

    def update_records(self, recs: np.ndarray, keys: np.ndarray,
                       rows: np.ndarray) -> None:
        """In-place update of EXISTING records by ticket (from
        :meth:`get_batch_refs`): one vectorized checksummed scatter, no
        probe, index untouched.  Stale tickets (key moved by an
        intervening compact/delete) fail loud."""
        with self._lock:
            ks = self._as_u64(keys)
            r = np.asarray(rows, np.float32).reshape(-1, self.width)
            if not len(ks):
                return
            if (recs < 0).any() or (recs >= self._n_rec).any() or \
                    not np.array_equal(self._rk[recs], ks):
                raise ValueError("stale record tickets (store mutated "
                                 "between read and update)")
            if self._u64_ok:
                # in-place lane update: the key/flags lanes are already
                # right (tickets validated above), so scatter only the
                # row lanes and recompute the checksum from the record
                # in the map — no staging matrix, ~40% less copying on
                # the write-back path
                view = self._records_view64(self._n_rec)
                view[recs, 2:2 + self.width // 2] = \
                    np.ascontiguousarray(r, "<f4").view(np.dtype("<u8"))
                lanes = view[recs, :-1]
                view[recs, -1] = _lane_checksums(lanes)
            else:
                self._records_view(self._n_rec)[recs] = \
                    self._build_records(ks, r, flags=0)

    def contains_batch(self, keys: np.ndarray) -> np.ndarray:
        with self._lock:
            ks = self._as_u64(keys)
            if not len(ks):
                return np.zeros(0, bool)
            return self._probe(ks)[1]

    def keys(self) -> np.ndarray:
        """All live keys, sorted int64."""
        with self._lock:
            self._merge_tail()
            return np.sort(self._ik.astype(np.int64))

    # -- writes ---------------------------------------------------------------

    def _build_records64(self, ks: np.ndarray, rows: np.ndarray,
                         flags: int) -> np.ndarray:
        """One checksummed [n, rec_lanes] uint64 record block — the
        pad-free fast path (lane-identical to :meth:`_build_records`,
        so either side validates the other's records)."""
        n = len(ks)
        rec = np.zeros((n, self._rec_lanes), np.dtype("<u8"))
        rec[:, 0] = ks
        rec[:, 1] = flags & 0xFF
        rec[:, 2:2 + self.width // 2] = np.ascontiguousarray(
            rows, "<f4"
        ).view(np.dtype("<u8"))
        w = _lane_weights(self._rec_lanes - 1)
        with np.errstate(over="ignore"):
            rec[:, -1] = (
                rec[:, :-1] * w
            ).sum(axis=1, dtype=np.uint64) + np.uint64(0xCBF29CE484222325)
        return rec

    def _build_records(self, ks: np.ndarray, rows: np.ndarray,
                       flags: int) -> np.ndarray:
        """One checksummed [n, rec_bytes] record block (vectorized)."""
        n = len(ks)
        recs = np.zeros((n, self.rec_bytes), np.uint8)
        recs[:, :8] = ks.view(np.uint8).reshape(n, 8)
        recs[:, 8] = flags & 0xFF
        recs[:, 16:16 + 4 * self.width] = np.ascontiguousarray(
            rows, "<f4"
        ).view(np.uint8).reshape(n, 4 * self.width)
        lanes = np.ascontiguousarray(
            recs[:, : self.rec_bytes - 8]
        ).view("<u8").reshape(n, -1)
        recs[:, self.rec_bytes - 8:] = _lane_checksums(
            lanes
        ).view(np.uint8).reshape(n, 8)
        return recs

    def _grow_mirrors(self, need: int) -> None:
        """Amortized-growth record mirrors (concatenating per append
        batch would copy the whole history every time)."""
        cap = len(self._rk)
        if need <= cap:
            return
        new_cap = max(64, cap)
        while new_cap < need:
            new_cap *= 2
        rk = np.zeros(new_cap, np.uint64)
        rk[: self._n_rec] = self._rk[: self._n_rec]
        rf = np.zeros(new_cap, np.uint8)
        rf[: self._n_rec] = self._rflags[: self._n_rec]
        self._rk = rk
        self._rflags = rf

    def _append_records(self, ks: np.ndarray, rows: np.ndarray,
                        flags: int) -> None:
        """Append one checksummed record per key (one vectorized store
        into the mapping) and index them last-wins.  Caller holds the
        lock."""
        n = len(ks)
        first = self._n_rec
        if self._u64_ok:
            view = self._records_view64(first + n)
            view[first:first + n] = self._build_records64(ks, rows, flags)
        else:
            view = self._records_view(first + n)
            view[first:first + n] = self._build_records(ks, rows, flags)
        self._grow_mirrors(first + n)
        self._rk[first:first + n] = ks
        self._rflags[first:first + n] = flags & 0xFF
        self._n_rec += n
        if flags & _FLAG_TOMBSTONE:
            return
        # last occurrence within the batch wins the index (dup keys in one
        # set_batch are legal and resolve like consecutive appends)
        self._index_set(ks, np.arange(first, first + n, dtype=np.int64))

    def set_batch(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """rows[i] -> keys[i]: EXISTING keys update their record in place
        (one vectorized scatter, index untouched), new keys append."""
        self.set_batch_refs(keys, rows)

    def set_batch_refs(self, keys: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """:meth:`set_batch` that also returns each key's record index —
        :meth:`update_records` tickets for the writer's NEXT write to the
        same keys (the tiered store's pull-side create -> push-side update
        cycle).  Tickets stay valid until the next delete/compact."""
        with self._lock:
            ks = self._as_u64(keys)
            r = np.asarray(rows, np.float32).reshape(-1, self.width)
            if len(ks) != len(r):
                raise ValueError("keys/rows length mismatch")
            if not len(ks):
                return np.zeros(0, np.int64)
            if bool((ks == _EMPTY).any()):
                raise ValueError("key 2^64-1 is reserved")
            out = np.empty(len(ks), np.int64)
            precs, found = self._probe(ks)
            if found.any():
                recs = precs[found]
                out[found] = recs
                if self._u64_ok:
                    self._records_view64(self._n_rec)[recs] = \
                        self._build_records64(ks[found], r[found], flags=0)
                else:
                    self._records_view(self._n_rec)[recs] = \
                        self._build_records(ks[found], r[found], flags=0)
            miss = ~found
            if miss.any():
                first = self._n_rec
                self._append_records(ks[miss], r[miss], flags=0)
                out[miss] = np.arange(first, self._n_rec, dtype=np.int64)
            return out

    def delete_batch(self, keys: np.ndarray) -> int:
        """Tombstone present keys; returns how many were live.  The index
        is rebuilt (linear-probe tables cannot unlink in place without
        breaking chains — and deletes are the rare elastic-evict path)."""
        with self._lock:
            ks = self._as_u64(keys)
            if not len(ks):
                return 0
            _, found = self._probe(ks)
            hit = np.unique(ks[found])
            if not len(hit):
                return 0
            self._append_records(
                hit, np.zeros((len(hit), self.width), np.float32),
                flags=_FLAG_TOMBSTONE,
            )
            self._rebuild_index()
            return int(len(hit))

    def compact(self) -> int:
        """Rewrite the store with only the newest live record per key, via
        tmp + fsync + atomic rename (the checkpoint discipline).  Returns
        records dropped.  The open file handle moves to the new inode."""
        with self._lock:
            self._merge_tail()
            recs = np.sort(self._iv)
            dropped = self._n_rec - len(recs)
            if dropped <= 0:
                return 0
            rows = self._read_rows(recs)
            ks = self._rk[recs]
            tmp = os.path.join(
                os.path.dirname(self.path) or ".",
                f".{os.path.basename(self.path)}.tmp-{os.getpid()}",
            )
            self._drop_map()
            self._f.close()
            self._f = None
            try:
                with open(tmp, "wb") as f:
                    f.write(_MAGIC + np.array([self.width, 0],
                                              "<u4").tobytes())
                    f.flush()
                    os.fsync(f.fileno())
                self._f = open(tmp, "r+b")
                self._rk = np.zeros(0, np.uint64)
                self._rflags = np.zeros(0, np.uint8)
                self._n_rec = 0
                self._new_index()
                if len(ks):
                    self._append_records(ks, rows, flags=0)
                self._drop_map()
                self._f.truncate(self.file_bytes)
                os.fsync(self._f.fileno())
                os.replace(tmp, self.path)
                _fsync_dir(os.path.dirname(self.path) or ".")
            except OSError:
                if self._f is not None:
                    self._f.close()
                # fall back to the intact pre-compaction file on disk
                self._f = open(self.path, "r+b")
                self._recover()
                raise
            return dropped

    def stats(self) -> Dict:
        with self._lock:
            return {
                "rows": int(self.n_rows),
                "records": int(self._n_rec),
                "file_bytes": int(self.file_bytes),
                "width": self.width,
                "recovered_records": self.recovered_records,
                "dropped_records": self.dropped_records,
            }
