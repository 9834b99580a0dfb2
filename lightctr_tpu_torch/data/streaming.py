"""Streaming libFFM reader — Criteo-scale ingest, copied from
``lightctr_tpu/data/streaming.py`` (its native parser is the port's copy
in ``lightctr_tpu_torch/native``).

The in-memory loader (:func:`lightctr_tpu_torch.data.load_libffm`) materializes the
whole padded dataset; at Criteo-1TB scale (BASELINE.json north star) ingest
must stream.  ``iter_libffm_batches`` yields fixed-shape padded batch dicts
straight from the file with bounded memory: rows longer than ``max_nnz`` are
truncated, ids are folded into the given vocabulary (the hashing trick the
eager loader applies), and the final partial batch is either dropped or
zero-padded with a row mask.

Ingest is native by default (the C chunk parser in
``native/libffm_parser.cpp`` — profiling the Criteo-proxy run showed Python
row parsing at ~94% of wall); the pure-Python path remains as the fallback
and the semantics oracle (``native=False``).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional

import numpy as np


def _stop_requested(stop) -> bool:
    """``stop`` is the loop/follow escape hatch for otherwise-infinite
    streams: None (never stop), a ``threading.Event``-like (``is_set``),
    or a zero-arg callable."""
    if stop is None:
        return False
    if hasattr(stop, "is_set"):
        return bool(stop.is_set())
    return bool(stop())


def _new_buffers(batch_size: int, max_nnz: int) -> Dict[str, np.ndarray]:
    return {
        "fids": np.zeros((batch_size, max_nnz), np.int32),
        "fields": np.zeros((batch_size, max_nnz), np.int32),
        "vals": np.zeros((batch_size, max_nnz), np.float32),
        "mask": np.zeros((batch_size, max_nnz), np.float32),
        "labels": np.zeros((batch_size,), np.float32),
        "row_mask": np.zeros((batch_size,), np.float32),
    }


def _fill_row(buf, fill, label, row, max_nnz, feature_cnt, field_cnt):
    """Write one parsed row into batch slot ``fill`` (the one row-packing
    idiom: the eager python path and the follow tailer share it)."""
    buf["labels"][fill] = label
    buf["row_mask"][fill] = 1.0
    for j, (field, fid, val) in enumerate(row[:max_nnz]):
        if feature_cnt is not None:
            fid %= feature_cnt
        if field_cnt is not None:
            field %= field_cnt
        buf["fids"][fill, j] = fid
        buf["fields"][fill, j] = field
        buf["vals"][fill, j] = val
        buf["mask"][fill, j] = 1.0


def iter_libffm_batches(
    path: str,
    batch_size: int,
    max_nnz: int,
    feature_cnt: Optional[int] = None,
    field_cnt: Optional[int] = None,
    drop_remainder: bool = True,
    native: Optional[bool] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    *,
    loop: bool = False,
    follow: bool = False,
    shuffle_batches: int = 0,
    seed: int = 0,
    stop=None,
    poll_s: float = 0.05,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batch dicts with keys fids/fields/vals/mask/labels (+``row_mask``
    flagging real rows when the tail batch is padded).  ``native=None``
    auto-selects the C chunk parser when the native library builds; the two
    paths yield identical batches (tested).

    ``process_index``/``process_count`` stream a per-worker shard: global row
    ``i`` belongs to worker ``i % process_count`` — the streaming counterpart
    of the reference's per-worker input split (``data/proc_file_split.py``)
    and of :func:`lightctr_tpu_torch.data.batching.shard_for_hosts`, so multi-host
    ingest needs no pre-split files.  Each worker's batches hold only its own
    rows (every batch still ``batch_size`` rows).

    ONLINE modes (docs/ONLINE.md — the continuous trainer's ingest):

    - ``loop=True``: infinite epochs — the file re-streams forever, each
      epoch optionally re-shuffled through a bounded batch buffer
      (``shuffle_batches``) whose rng is seeded ``(seed, epoch)``: the
      order is deterministic per (seed, epoch) and different across
      epochs.  ``drop_remainder`` applies per epoch, so every wrapped
      epoch yields the same batch count.
    - ``follow=True``: tail a GROWING file — at end-of-data the reader
      polls every ``poll_s`` seconds for appended lines instead of
      terminating.  A trailing PARTIAL line (no newline yet — a writer
      mid-append) is never parsed; it waits for its newline.  Batches
      are emitted only when full (a follow stream has no meaningful
      tail).  No sharding.  ``native=None`` auto-selects the C chunk
      parser here too: the tailer hands it the last known newline
      boundary as an explicit byte bound, so the partial-line contract
      holds natively (the Python row parser remains the fallback and
      oracle).
    - ``stop``: escape hatch for both (Event or callable) — checked
      between batches, so an infinite stream shuts down cleanly."""
    from lightctr_tpu_torch.native import bindings

    if (process_index is None) != (process_count is None):
        raise ValueError("process_index and process_count go together")
    if follow:
        if loop:
            raise ValueError("follow and loop are exclusive "
                             "(a tailed file never reaches its wrap)")
        if process_count is not None:
            raise ValueError("follow mode does not shard "
                             "(tail one file per follower)")
        yield from _iter_follow(
            path, batch_size, max_nnz, feature_cnt, field_cnt,
            shuffle_batches, seed, stop, poll_s, native,
        )
        return
    if loop:
        epoch = 0
        while not _stop_requested(stop):
            inner = iter_libffm_batches(
                path, batch_size, max_nnz, feature_cnt, field_cnt,
                drop_remainder, native, process_index, process_count,
            )
            if shuffle_batches > 1:
                inner = _shuffle_buffer(
                    inner, np.random.default_rng([seed, epoch]),
                    shuffle_batches,
                )
            for b in inner:
                if _stop_requested(stop):
                    return
                yield b
            epoch += 1
        return
    if shuffle_batches > 1:
        yield from _shuffle_buffer(
            iter_libffm_batches(
                path, batch_size, max_nnz, feature_cnt, field_cnt,
                drop_remainder, native, process_index, process_count,
            ),
            np.random.default_rng([seed, 0]),
            shuffle_batches,
        )
        return
    if process_count is not None:
        if not (0 <= process_index < process_count):
            raise ValueError(
                f"process_index {process_index} not in [0, {process_count})"
            )
        if native is None:
            native = bindings.available()
        if native:
            # scan-level shard: the C parser line-skips other workers'
            # rows (counted, not tokenized) — the fleet parses each row
            # exactly once; the rebatcher below is oblivious
            inner = _iter_native(
                path, batch_size, max_nnz, feature_cnt, field_cnt,
                drop_remainder=False,
                stride_count=process_count, stride_index=process_index,
            )
        else:
            inner = iter_libffm_batches(
                path, batch_size, max_nnz, feature_cnt, field_cnt,
                drop_remainder=False, native=False,
            )
        yield from _stride_rebatch(
            inner, batch_size, process_index, process_count, drop_remainder
        )
        return

    if native is None:
        native = bindings.available()
    if native:
        yield from _iter_native(
            path, batch_size, max_nnz, feature_cnt, field_cnt, drop_remainder
        )
        return

    from lightctr_tpu_torch.data.sparse import parse_libffm_line

    buf = _new_buffers(batch_size, max_nnz)
    fill = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parsed = parse_libffm_line(line, path, lineno)
            if parsed is None:
                continue
            label, row = parsed
            _fill_row(buf, fill, label, row, max_nnz, feature_cnt,
                      field_cnt)
            fill += 1
            if fill == batch_size:
                yield buf
                buf = _new_buffers(batch_size, max_nnz)
                fill = 0
    if fill and not drop_remainder:
        yield buf


def _shuffle_buffer(inner, rng, k: int):
    """Bounded-buffer stream shuffle at batch granularity: hold up to
    ``k`` batches, emit a uniformly random resident as each new one
    arrives (then drain in random order).  Deterministic for a given rng
    seed — the loop mode's per-epoch reshuffle."""
    buf: list = []
    for b in inner:
        buf.append(b)
        if len(buf) >= k:
            i = int(rng.integers(len(buf)))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    while buf:
        i = int(rng.integers(len(buf)))
        buf[i], buf[-1] = buf[-1], buf[i]
        yield buf.pop()


def _newline_bound(path: str, after: int) -> int:
    """Byte offset one past the LAST newline in ``path`` (scanning
    backward from EOF in chunks), or ``after`` when no newline lands at
    or beyond it — the native tailer's parse bound, so a writer's
    partial trailing line stays untouched."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        pos = f.tell()
        while pos > after:
            step = min(1 << 16, pos - after)
            f.seek(pos - step)
            chunk = f.read(step)
            nl = chunk.rfind(b"\n")
            if nl >= 0:
                return pos - step + nl + 1
            pos -= step
    return after


def _iter_follow(path, batch_size, max_nnz, feature_cnt, field_cnt,
                 shuffle_batches, seed, stop, poll_s, native=None):
    """Tail-follow reader: stream the file's current content, then poll
    for growth.  The one subtlety is the PARTIAL TAIL LINE — a writer
    caught mid-append leaves bytes with no newline; parsing them would
    misread half a row (or raise on a torn token), so everything after
    the last newline is buffered and re-joined with the next read.  A
    line is parsed exactly once, when its newline lands."""
    if shuffle_batches > 1:
        raise ValueError(
            "follow mode cannot shuffle (a tail has no epoch to buffer)"
        )
    del seed
    from lightctr_tpu_torch.native import bindings

    if native is None:
        native = bindings.available()
    if native:
        yield from _iter_follow_native(
            path, batch_size, max_nnz, feature_cnt, field_cnt, stop, poll_s
        )
        return
    from lightctr_tpu_torch.data.sparse import parse_libffm_line

    buf = _new_buffers(batch_size, max_nnz)
    fill = 0
    lineno = 0
    partial = ""
    with open(path) as f:
        while not _stop_requested(stop):
            chunk = f.read(1 << 16)
            if not chunk:
                time.sleep(poll_s)
                continue
            pieces = (partial + chunk).split("\n")
            partial = pieces.pop()  # no newline yet: wait for the writer
            for line in pieces:
                lineno += 1
                parsed = parse_libffm_line(line, path, lineno)
                if parsed is None:
                    continue
                label, row = parsed
                _fill_row(buf, fill, label, row, max_nnz, feature_cnt,
                          field_cnt)
                fill += 1
                if fill == batch_size:
                    yield buf
                    buf = _new_buffers(batch_size, max_nnz)
                    fill = 0


def _iter_follow_native(path, batch_size, max_nnz, feature_cnt, field_cnt,
                        stop, poll_s):
    """Native tail-follow: the C chunk parser consumes the file by byte
    offset up to an explicit bound at the last known newline, so the
    partial-line contract holds without a Python loop per row.  getline
    would hand back an unterminated final line as a (possibly torn) row —
    exactly the bytes a mid-append writer leaves — hence the bound, found
    by a backward scan from EOF (``_newline_bound``), not by trusting
    EOF.  Rows accumulate across polls into one fill buffer; batches are
    emitted only when full, same as the Python tailer."""
    from lightctr_tpu_torch.native.bindings import parse_libffm_chunk

    buf = _new_buffers(batch_size, max_nnz)
    fill = 0
    offset = 0
    bound = 0
    while not _stop_requested(stop):
        if offset >= bound:
            bound = _newline_bound(path, offset)
            if bound <= offset:
                time.sleep(poll_s)
                continue
        arrays, rows, offset = parse_libffm_chunk(
            path, offset, batch_size - fill, max_nnz,
            fold_fid=feature_cnt or 0, fold_field=field_cnt or 0,
            end=bound,
        )
        if rows == 0:
            continue  # the window held only blank lines
        buf["fids"][fill:fill + rows] = arrays["fids"][:rows]
        buf["fields"][fill:fill + rows] = arrays["fields"][:rows]
        buf["vals"][fill:fill + rows] = arrays["vals"][:rows]
        buf["mask"][fill:fill + rows] = arrays["mask"][:rows]
        buf["labels"][fill:fill + rows] = arrays["labels"][:rows]
        buf["row_mask"][fill:fill + rows] = 1.0
        fill += rows
        if fill == batch_size:
            yield buf
            buf = _new_buffers(batch_size, max_nnz)
            fill = 0


def _stride_rebatch(inner, batch_size, process_index, process_count, drop_remainder):
    """Select global rows ``process_index::process_count`` from a full-stream
    batch iterator and re-pack them into full ``batch_size`` batches.

    SPMD lockstep guarantee (``drop_remainder=True``): a completed batch —
    the ``k``-th — is held back until ``(k+1) * batch_size * process_count``
    global rows have streamed past, which is exactly the condition for EVERY
    worker to be able to fill its own ``k``-th batch.  So all workers yield
    the same number of batches regardless of where the file ends, the
    streaming form of ``shard_for_hosts``'s trim-to-common-multiple (a tail
    imbalance would strand one host in a collective)."""
    carry: Dict[str, np.ndarray] = {}
    carried = 0
    g = 0  # global row counter across inner batches
    pending = None  # completed batch awaiting the lockstep threshold
    n_done = 0  # batches fully completed (pending included)
    for batch in inner:
        rows = int(batch["row_mask"].sum())
        own = np.nonzero((g + np.arange(rows)) % process_count == process_index)[0]
        g += rows
        if pending is not None and g >= n_done * batch_size * process_count:
            yield pending
            pending = None
        if own.size == 0:
            continue
        take = {k: v[own] for k, v in batch.items()}
        if not carry:
            carry = {
                k: np.zeros((batch_size,) + v.shape[1:], v.dtype)
                for k, v in take.items()
            }
        ofs = 0
        while ofs < own.size:
            n = min(batch_size - carried, own.size - ofs)
            for k, v in take.items():
                carry[k][carried : carried + n] = v[ofs : ofs + n]
            carried += n
            ofs += n
            if carried == batch_size:
                if pending is not None:  # threshold passed when it completed
                    yield pending
                n_done += 1
                pending = carry
                if g >= n_done * batch_size * process_count:
                    yield pending
                    pending = None
                carry = {
                    k: np.zeros((batch_size,) + v.shape[1:], v.dtype)
                    for k, v in carry.items()
                }
                carried = 0
    if pending is not None:
        if not drop_remainder or g >= n_done * batch_size * process_count:
            yield pending
    if carried and not drop_remainder:
        yield carry


def _iter_native(path, batch_size, max_nnz, feature_cnt, field_cnt,
                 drop_remainder, stride_count=None, stride_index=None):
    """``stride_count``/``stride_index``: tokenize only the rows worker
    ``stride_index`` owns (global row % count == index) — the scan still
    COUNTS every data row, so the downstream ``_stride_rebatch`` arithmetic
    is unchanged, but a fleet of N workers tokenizes the file once total
    instead of N times.  Non-own rows ride through as zeros and are
    discarded by the rebatcher's own-row selection."""
    from lightctr_tpu_torch.native.bindings import parse_libffm_chunk

    offset = 0
    g = 0  # global data rows scanned so far (drives the per-chunk phase)
    while True:
        # folding happens natively on the exact long value (pre-narrowing,
        # same as the Python generator), so no np.mod post-pass is needed —
        # and padded slots stay zero because the fold runs per real token
        arrays, rows, offset = parse_libffm_chunk(
            path, offset, batch_size, max_nnz,
            fold_fid=feature_cnt or 0, fold_field=field_cnt or 0,
            stride=stride_count or 1,
            phase=((stride_index - g) % stride_count) if stride_count else 0,
        )
        g += rows
        if rows == 0:
            return
        if rows < batch_size and drop_remainder:
            return
        row_mask = np.zeros((batch_size,), np.float32)
        row_mask[:rows] = 1.0
        arrays["row_mask"] = row_mask
        yield arrays
        if rows < batch_size:
            return
