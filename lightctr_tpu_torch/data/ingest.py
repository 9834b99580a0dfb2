"""Compiled data plane: the binary shard cache and the K-deep prefetch
stage, from ``lightctr_tpu/data/ingest.py``.

- :func:`compile_shards` tokenizes a libFFM file once (through the native
  chunk parser when it builds) into checksum-framed binary shard files:
  varint-delta fids/fields, fp16 vals when the round trip is exact (an
  fp32 escape per block keeps bit parity), written tmp + fsync + rename so
  a killed compile is never mistaken for a finished one.  The format is
  the JAX package's (``lcshard-v1``): a cache either package writes is the
  same bytes, and each loads the other's.
- :func:`iter_shard_batches` / :func:`iter_ingest_batches` replay the
  cache as the exact batch stream the live reader yields: the shard reader
  feeds the same ``_stride_rebatch`` / ``_shuffle_buffer`` machinery as
  ``iter_libffm_batches``, so wrap, ``(seed, epoch)`` reshuffle and
  ``process_index % process_count`` striding are bit-identical by
  construction.  ``shard_shuffle`` adds a seeded shard-level permutation.
- :func:`as_arrays` materializes a whole cache as one padded array dict,
  which the trainers' ``fit`` and ``fit_fullbatch_scan`` take.
- :class:`FeatureSpec`: hash-fold, field remap and crosses as a config,
  applied vectorized over whole chunks in the compile pass and the live
  path alike.
- :func:`prefetch_batches`: a worker thread keeps ``depth`` batches in
  flight behind the step; the trainers' ``fit(prefetch=)`` and
  ``fit_stream(prefetch=)`` run it.

All of it is host numpy: the trainers move each batch to their device.
``INGEST_SERIES`` declares every ``ingest_*`` metric this module emits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue as queue_mod
import struct
import threading
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.data.streaming import (
    _new_buffers,
    _shuffle_buffer,
    _stop_requested,
    _stride_rebatch,
    iter_libffm_batches,
)
from lightctr_tpu_torch.native import bindings
from lightctr_tpu_torch.obs import resources as resources_mod

#: every metric series the compiled data plane writes (lint-enforced
#: exact in both directions by tests/test_torch_shard_cache.py)
INGEST_SERIES = (
    # shard cache (compile pass + replay)
    "ingest_shard_compiles_total",     # counter (cache builds)
    "ingest_shard_cache_hits_total",   # counter (manifest matched)
    "ingest_shard_recoveries_total",   # counter (stale/torn cache rebuilt)
    "ingest_shard_rows_total",         # counter (rows written at compile)
    "ingest_shard_bytes_total",        # counter (shard bytes written)
    "ingest_replay_blocks_total",      # counter (blocks decoded on replay)
    # prefetch pipeline
    "ingest_prefetch_batches_total",   # counter (batches delivered)
    "ingest_prefetch_ready_total",     # counter (gets served non-blocking)
    "ingest_overlap_ratio",            # gauge (ready/delivered — honesty)
    "ingest_wait_seconds",             # histogram (consumer queue wait)
)

_MAGIC = b"LCSHRD1\n"
_BLOCK_HEADER = struct.Struct("<IIIQ")  # payload_len, rows, flags, checksum
_FLAG_VALS_F16 = 1
_MANIFEST = "manifest.json"
_FORMAT = "lcshard-v1"
_SHARD_SALT = 0x5A  # rng-stream salt separating shard-order draws from
#                     the batch-buffer draws (both seeded (seed, epoch))


class ShardCorruption(RuntimeError):
    """A shard file failed its frame checksum / framing bounds — a torn
    tail or external truncation.  ``compile_shards`` treats it as a
    cache miss and rebuilds."""


# -- framing ------------------------------------------------------------------


_weight_cache = np.zeros(0, np.uint64)


def _lane_weights(k: int) -> np.ndarray:
    """splitmix64-of-index odd lane weights (the ``mmap_store``
    construction), memoized: replay validates every block on every
    epoch, so the 5-pass weight derivation must not be a per-block
    cost."""
    global _weight_cache
    if _weight_cache.size < k:
        with np.errstate(over="ignore"):
            x = np.arange(1, max(k, 1 << 14) + 1, dtype=np.uint64) \
                * np.uint64(0x9E3779B97F4A7C15)
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
            x *= np.uint64(0x94D049BB133111EB)
            x ^= x >> np.uint64(31)
        _weight_cache = x | np.uint64(1)
    return _weight_cache[:k]


def _checksum_bytes(data) -> int:
    """Weighted u64-lane checksum over a bytes-like: position weights —
    permuted or torn lanes do not cancel — plus an FNV offset and a
    length term, so truncated zero padding can never validate."""
    view = memoryview(data)
    n = view.nbytes
    pad = (-n) % 8
    if pad:
        lanes = np.frombuffer(bytes(view) + b"\x00" * pad, "<u8")
    else:
        lanes = np.frombuffer(view, "<u8")
    with np.errstate(over="ignore"):
        s = (lanes * _lane_weights(lanes.size)).sum(dtype=np.uint64) \
            + np.uint64(0xCBF29CE484222325) \
            + np.uint64(n) * np.uint64(0x100000001B3)
    return int(s)


def _pack_varint(vals: np.ndarray) -> bytes:
    """Zigzag+LEB128 (the native wire codec; pure-Python oracle when the
    library doesn't build)."""
    v = np.ascontiguousarray(vals, np.int64)
    if bindings.available():
        return bindings.varint_pack_native(v)
    out = bytearray()
    for x in v.tolist():
        z = ((x << 1) ^ (x >> 63)) & 0xFFFFFFFFFFFFFFFF
        while True:
            b = z & 0x7F
            z >>= 7
            if z:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def _unpack_varint(buf, n: int) -> Tuple[np.ndarray, int]:
    """Decode exactly ``n`` int64 values from a bytes-like (memoryviews
    pass through uncopied); returns (values, bytes consumed)."""
    if n == 0:
        return np.zeros(0, np.int64), 0
    if bindings.available():
        vals, consumed = bindings.varint_unpack_native(
            buf, n, return_consumed=True)
        return np.asarray(vals, np.int64), int(consumed)
    out = np.zeros(n, np.int64)
    pos = 0
    for i in range(n):
        z = 0
        shift = 0
        while True:
            if pos >= len(buf):
                raise ShardCorruption("truncated varint stream")
            b = buf[pos]
            pos += 1
            z |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 63:
                raise ShardCorruption("corrupt varint stream")
        out[i] = (z >> 1) ^ -(z & 1)
    return out, pos


def _encode_block(fids, fields, vals, labels, nnz) -> Tuple[bytes, int]:
    """One block of left-packed rows -> (payload, flags).  fids/fields
    ship as zigzag varints of their FLATTENED deltas (ids are
    near-sorted within a row, so deltas pack tight — the reference's
    VarUint Buffer idea); vals ship fp16 when the round-trip is exact
    for the whole block (the overwhelmingly common 1.0/0.5 libFFM case)
    and escape to fp32 otherwise, so replay stays BIT-identical to the
    parser either way."""
    rows_idx = np.repeat(np.arange(len(nnz)), nnz)
    col_idx = np.arange(int(nnz.sum())) - np.repeat(
        np.cumsum(nnz) - nnz, nnz)
    flat_fids = fids[rows_idx, col_idx].astype(np.int64)
    flat_fields = fields[rows_idx, col_idx].astype(np.int64)
    flat_vals = vals[rows_idx, col_idx].astype(np.float32)
    flags = 0
    f16 = flat_vals.astype(np.float16)
    if np.array_equal(f16.astype(np.float32), flat_vals):
        flags |= _FLAG_VALS_F16
        val_bytes = f16.astype("<f2").tobytes()
    else:
        val_bytes = flat_vals.astype("<f4").tobytes()
    parts = [
        _pack_varint(nnz),
        _pack_varint(np.diff(flat_fids, prepend=0)),
        _pack_varint(np.diff(flat_fields, prepend=0)),
        labels.astype("<f4").tobytes(),
        val_bytes,
    ]
    return b"".join(parts), flags


def _decode_block(payload, rows: int, flags: int,
                  width: int) -> Dict[str, np.ndarray]:
    """Inverse of :func:`_encode_block`: payload -> padded [rows, width]
    arrays + labels.  Rows come back LEFT-PACKED (the parser layout).
    This is the replay hot loop — everything is one numpy pass: a
    single flat-index vector drives all three scatters, the mask falls
    out of a broadcast compare, and the payload is only ever sliced as
    memoryviews.  When the native library builds, the whole decode is
    one C pass (``shard_decode_block`` in varint.cpp) — varint, delta
    accumulate, and scatter fused into a single sequential walk; the
    numpy path below stays as the portable oracle (parity pinned in
    tests)."""
    if bindings.available():
        out = {
            "fids": np.zeros((rows, width), np.int32),
            "fields": np.zeros((rows, width), np.int32),
            "vals": np.zeros((rows, width), np.float32),
            "mask": np.zeros((rows, width), np.float32),
            "labels": np.zeros(rows, np.float32),
        }
        try:
            bindings.shard_decode_native(
                payload, rows, width, flags & _FLAG_VALS_F16,
                out["fids"], out["fields"], out["vals"], out["mask"],
                out["labels"])
        except ValueError as e:
            raise ShardCorruption(str(e)) from None
        return out
    view = memoryview(payload)
    nnz, pos = _unpack_varint(view, rows)
    if nnz.min(initial=0) < 0 or nnz.max(initial=0) > width:
        raise ShardCorruption("block nnz out of range")
    total = int(nnz.sum())
    d_fids, used = _unpack_varint(view[pos:], total)
    pos += used
    d_fields, used = _unpack_varint(view[pos:], total)
    pos += used
    need = rows * 4 + total * (2 if flags & _FLAG_VALS_F16 else 4)
    if view.nbytes - pos != need:
        raise ShardCorruption("block payload length mismatch")
    labels = np.frombuffer(view, "<f4", count=rows, offset=pos).copy()
    pos += rows * 4
    if flags & _FLAG_VALS_F16:
        if bindings.available():
            flat_vals = bindings.f16_decode_native(
                view[pos:pos + total * 2], total)
        else:
            flat_vals = np.frombuffer(
                view, "<f2", count=total, offset=pos).astype(np.float32)
    else:
        flat_vals = np.frombuffer(
            view, "<f4", count=total, offset=pos).copy()
    out = {
        "fids": np.zeros((rows, width), np.int32),
        "fields": np.zeros((rows, width), np.int32),
        "vals": np.zeros((rows, width), np.float32),
        "mask": (np.arange(width) < nnz[:, None]).astype(np.float32),
        "labels": labels,
    }
    if total:
        # flat position of token t (row r, column t - row_start[r]) in
        # the padded [rows, width] grid: t + r*width - row_start[r]
        starts = np.cumsum(nnz) - nnz
        offsets = np.arange(rows) * width - starts
        flat_idx = np.arange(total) + np.repeat(offsets, nnz)
        out["fids"].ravel()[flat_idx] = np.cumsum(d_fids)
        out["fields"].ravel()[flat_idx] = np.cumsum(d_fields)
        out["vals"].ravel()[flat_idx] = flat_vals
    return out


# -- declarative feature spec -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Declarative feature transforms, applied VECTORIZED over whole
    chunks (never per-row) in both the compile pass and the live path.

    - ``fold_features`` / ``fold_fields``: the hashing trick — ids
      reduced modulo the vocabulary.  Applied AT THE PARSE (native fold
      on the exact long value, pre-int32-narrowing), exactly like
      passing ``feature_cnt``/``field_cnt`` to the streaming reader.
    - ``field_remap``: ``{old_field: new_field}`` relabeling (merge raw
      fields into model fields), applied after the fold.
    - ``crosses``: ``[(field_a, field_b), ...]`` — for each pair, rows
      holding both fields (their FIRST occurrence, post-remap) gain one
      token ``(cross_field_base + k, mix64(fid_a, fid_b) %
      cross_feature_cnt, val_a * val_b)``.  Output width grows by
      ``len(crosses)`` and rows are re-left-packed.
    """

    fold_features: Optional[int] = None
    fold_fields: Optional[int] = None
    field_remap: Optional[Dict[int, int]] = None
    crosses: Tuple[Tuple[int, int], ...] = ()
    cross_feature_cnt: Optional[int] = None
    cross_field_base: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self, "crosses",
            tuple((int(a), int(b)) for a, b in self.crosses))
        if self.field_remap is not None:
            object.__setattr__(
                self, "field_remap",
                {int(k): int(v) for k, v in self.field_remap.items()})
        if self.crosses and (self.cross_feature_cnt is None
                             or self.cross_field_base is None):
            raise ValueError(
                "crosses need cross_feature_cnt (hash vocabulary) and "
                "cross_field_base (first cross field id)")

    @property
    def extra_nnz(self) -> int:
        return len(self.crosses)

    def to_dict(self) -> Dict:
        return {
            "fold_features": self.fold_features,
            "fold_fields": self.fold_fields,
            "field_remap": {str(k): v for k, v in
                            sorted((self.field_remap or {}).items())},
            "crosses": [list(c) for c in self.crosses],
            "cross_feature_cnt": self.cross_feature_cnt,
            "cross_field_base": self.cross_field_base,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "FeatureSpec":
        return cls(
            fold_features=d.get("fold_features"),
            fold_fields=d.get("fold_fields"),
            field_remap={int(k): int(v) for k, v in
                         (d.get("field_remap") or {}).items()} or None,
            crosses=tuple(tuple(c) for c in d.get("crosses") or ()),
            cross_feature_cnt=d.get("cross_feature_cnt"),
            cross_field_base=d.get("cross_field_base"),
        )

    def digest(self) -> str:
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def apply(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Remap + crosses over one padded batch (the fold already
        happened at the parse).  Pure function of the batch — the
        compile pass and the live path call exactly this, so the two
        can never drift."""
        if self.field_remap is None and not self.crosses:
            return batch
        fields = batch["fields"]
        fids = batch["fids"]
        vals = batch["vals"]
        mask = batch["mask"]
        if self.field_remap:
            size = max(int(fields.max(initial=0)) + 1,
                       max(self.field_remap) + 1)
            lut = np.arange(size, dtype=np.int32)
            for old, new in self.field_remap.items():
                lut[old] = new
            fields = np.where(mask > 0, lut[fields], 0).astype(np.int32)
        if not self.crosses:
            out = dict(batch)
            out["fields"] = fields
            return out
        n, w = fields.shape
        wide = w + len(self.crosses)
        x_fields = np.concatenate(
            [fields, np.zeros((n, len(self.crosses)), np.int32)], axis=1)
        x_fids = np.concatenate(
            [fids, np.zeros((n, len(self.crosses)), np.int32)], axis=1)
        x_vals = np.concatenate(
            [vals, np.zeros((n, len(self.crosses)), np.float32)], axis=1)
        x_mask = np.concatenate(
            [mask, np.zeros((n, len(self.crosses)), np.float32)], axis=1)
        rows = np.arange(n)
        real = mask > 0
        for k, (fa, fb) in enumerate(self.crosses):
            is_a = real & (fields == fa)
            is_b = real & (fields == fb)
            has = is_a.any(axis=1) & is_b.any(axis=1)
            ia = is_a.argmax(axis=1)
            ib = is_b.argmax(axis=1)
            with np.errstate(over="ignore"):
                a = fids[rows, ia].astype(np.uint64)
                b = fids[rows, ib].astype(np.uint64)
                h = (a * np.uint64(0x9E3779B97F4A7C15)
                     ^ (b + np.uint64(0xD1B54A32D192ED03)))
                h ^= h >> np.uint64(33)
                h *= np.uint64(0xFF51AFD7ED558CCD)
                h ^= h >> np.uint64(33)
            cfid = (h % np.uint64(self.cross_feature_cnt)).astype(np.int32)
            col = w + k
            x_fields[:, col] = np.where(has, self.cross_field_base + k, 0)
            x_fids[:, col] = np.where(has, cfid, 0)
            x_vals[:, col] = np.where(
                has, vals[rows, ia] * vals[rows, ib], 0.0)
            x_mask[:, col] = has.astype(np.float32)
        packed = _left_pack(
            {"fields": x_fields, "fids": x_fids, "vals": x_vals,
             "mask": x_mask}, wide)
        out = dict(batch)
        out.update(packed)
        return out


def _left_pack(arrays: Dict[str, np.ndarray], width: int
               ) -> Dict[str, np.ndarray]:
    """Compact each row's real tokens (mask > 0) into a column prefix —
    the parser layout, restored after crosses leave gaps."""
    mask = arrays["mask"]
    m = mask > 0
    nnz = m.sum(axis=1)
    rows_idx, col_idx = np.nonzero(m)
    out_col = np.arange(rows_idx.size) - np.repeat(
        np.cumsum(nnz) - nnz, nnz)
    n = mask.shape[0]
    out = {
        "fields": np.zeros((n, width), np.int32),
        "fids": np.zeros((n, width), np.int32),
        "vals": np.zeros((n, width), np.float32),
        "mask": np.zeros((n, width), np.float32),
    }
    out["fields"][rows_idx, out_col] = arrays["fields"][rows_idx, col_idx]
    out["fids"][rows_idx, out_col] = arrays["fids"][rows_idx, col_idx]
    out["vals"][rows_idx, out_col] = arrays["vals"][rows_idx, col_idx]
    out["mask"][rows_idx, out_col] = 1.0
    return out


def _resolve_folds(feature_cnt, field_cnt, spec: Optional[FeatureSpec]
                   ) -> Tuple[Optional[int], Optional[int]]:
    """One fold source of truth: explicit counts and spec folds must
    agree when both are given."""
    if spec is not None:
        for name, cnt, fold in (("feature_cnt", feature_cnt,
                                 spec.fold_features),
                                ("field_cnt", field_cnt,
                                 spec.fold_fields)):
            if cnt is not None and fold is not None and cnt != fold:
                raise ValueError(
                    f"{name}={cnt} conflicts with the spec fold {fold}")
        feature_cnt = feature_cnt if feature_cnt is not None \
            else spec.fold_features
        field_cnt = field_cnt if field_cnt is not None \
            else spec.fold_fields
    return feature_cnt, field_cnt


# -- shard cache --------------------------------------------------------------


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


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename (the ``mmap_store`` crash discipline): the
    final name only ever points at complete, durable bytes."""
    d = os.path.dirname(path) or "."
    tmp = os.path.join(
        d, f".{os.path.basename(path)}.tmp-{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)


class ShardCache:
    """Handle on a compiled shard directory (manifest + shard files)."""

    def __init__(self, cache_dir: str, manifest: Dict):
        self.dir = cache_dir
        self.manifest = manifest

    @property
    def rows(self) -> int:
        return int(self.manifest["rows"])

    @property
    def width(self) -> int:
        return int(self.manifest["width"])

    @property
    def n_shards(self) -> int:
        return len(self.manifest["shards"])

    def shard_path(self, i: int) -> str:
        return os.path.join(self.dir, self.manifest["shards"][i]["file"])

    def iter_blocks(self, order: Optional[Iterable[int]] = None,
                    registry=None) -> Iterator[Dict[str, np.ndarray]]:
        """Decode blocks in shard ``order`` (sequential by default).
        Every block revalidates its frame checksum — a torn tail or
        truncated copy raises :class:`ShardCorruption` instead of
        yielding garbage rows."""
        reg = registry if registry is not None else obs.default_registry()
        width = self.width
        for si in (order if order is not None else range(self.n_shards)):
            path = self.shard_path(si)
            with open(path, "rb") as f:
                data = f.read()
            if data[:len(_MAGIC)] != _MAGIC:
                raise ShardCorruption(f"{path}: bad shard magic")
            pos = len(_MAGIC)
            while pos < len(data):
                if pos + _BLOCK_HEADER.size > len(data):
                    raise ShardCorruption(f"{path}: torn block header")
                payload_len, rows, flags, want = _BLOCK_HEADER.unpack_from(
                    data, pos)
                start = pos + _BLOCK_HEADER.size
                payload = data[start:start + payload_len]
                if len(payload) != payload_len:
                    raise ShardCorruption(f"{path}: torn block payload")
                if _checksum_bytes(data[pos:pos + 12] + payload) != want:
                    raise ShardCorruption(f"{path}: block checksum "
                                          "mismatch")
                if obs.enabled():
                    reg.inc("ingest_replay_blocks_total")
                yield _decode_block(payload, rows, flags, width)
                pos = start + payload_len

    def verify(self) -> int:
        """Walk every block (checksums included); returns total rows.
        Raises :class:`ShardCorruption` on the first bad frame."""
        total = 0
        for block in self.iter_blocks():
            total += len(block["labels"])
        return total


def default_cache_dir(path: str) -> str:
    return path + ".lcshards"


def _manifest_key(src_stat, max_nnz, feature_cnt, field_cnt, spec,
                  block_rows, shard_rows) -> Dict:
    return {
        "format": _FORMAT,
        "source_size": int(src_stat.st_size),
        "source_mtime_ns": int(src_stat.st_mtime_ns),
        "max_nnz": int(max_nnz),
        "feature_cnt": feature_cnt,
        "field_cnt": field_cnt,
        "spec_digest": spec.digest() if spec is not None else None,
        "block_rows": int(block_rows),
        "shard_rows": int(shard_rows),
    }


def load_cache(cache_dir: str) -> Optional[ShardCache]:
    """Open an existing cache (manifest present and shard files sized
    as recorded) — None on any mismatch, so callers fall through to a
    recompile rather than replaying a torn cache."""
    try:
        with open(os.path.join(cache_dir, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if manifest.get("format") != _FORMAT:
        return None
    for sh in manifest.get("shards", ()):
        p = os.path.join(cache_dir, sh["file"])
        try:
            if os.path.getsize(p) != int(sh["bytes"]):
                return None
        except OSError:
            return None
    return ShardCache(cache_dir, manifest)


def compile_shards(
    path: str,
    max_nnz: int,
    cache_dir: Optional[str] = None,
    feature_cnt: Optional[int] = None,
    field_cnt: Optional[int] = None,
    spec: Optional[FeatureSpec] = None,
    block_rows: int = 4096,
    shard_rows: int = 1 << 16,
    force: bool = False,
    native: Optional[bool] = None,
    registry=None,
) -> ShardCache:
    """Tokenize ``path`` once into the binary shard cache (idempotent:
    a matching manifest short-circuits as a cache hit).  Crash-safe by
    construction — shard files and the manifest land via
    tmp+fsync+rename, and the manifest is written LAST, so a compile
    killed at any byte leaves either the old complete cache or a
    recognizable miss (stale tmp turds are swept here).  A cache whose
    manifest matches but whose shard files are truncated/torn recompiles
    (counted as ``ingest_shard_recoveries_total``)."""
    reg = registry if registry is not None else obs.default_registry()
    cache_dir = cache_dir or default_cache_dir(path)
    feature_cnt, field_cnt = _resolve_folds(feature_cnt, field_cnt, spec)
    src_stat = os.stat(path)
    key = _manifest_key(src_stat, max_nnz, feature_cnt, field_cnt, spec,
                        block_rows, shard_rows)
    existing = load_cache(cache_dir)
    stale = False
    if existing is not None and not force:
        if all(existing.manifest.get(k) == v for k, v in key.items()):
            if obs.enabled():
                reg.inc("ingest_shard_cache_hits_total")
            return existing
        stale = True
    elif os.path.isdir(cache_dir) and os.listdir(cache_dir):
        # manifest missing/unreadable but debris present: a killed
        # compile (or torn copy) — rebuild, counted as a recovery
        stale = True

    os.makedirs(cache_dir, exist_ok=True)
    for name in os.listdir(cache_dir):
        if name.startswith("."):  # stale tmp turds from killed compiles
            try:
                os.unlink(os.path.join(cache_dir, name))
            except OSError:
                pass

    if native is None:
        native = bindings.available()
    width = max_nnz + (spec.extra_nnz if spec is not None else 0)

    def _chunks():
        if native:
            from lightctr_tpu_torch.native.bindings import parse_libffm_chunk

            offset = 0
            while True:
                arrays, rows, offset = parse_libffm_chunk(
                    path, offset, block_rows, max_nnz,
                    fold_fid=feature_cnt or 0, fold_field=field_cnt or 0)
                if rows == 0:
                    return
                yield {k: v[:rows] for k, v in arrays.items()}
                if rows < block_rows:
                    return
        else:
            for b in iter_libffm_batches(
                    path, block_rows, max_nnz, feature_cnt, field_cnt,
                    drop_remainder=False, native=False):
                rows = int(b["row_mask"].sum())
                yield {k: v[:rows] for k, v in b.items()
                       if k != "row_mask"}

    shard_idx = 0
    shard_blobs = [_MAGIC]
    shard_row_cnt = 0
    shards = []
    total_rows = 0
    total_bytes = 0

    def _flush():
        nonlocal shard_idx, shard_blobs, shard_row_cnt, total_bytes
        if shard_row_cnt == 0:
            return
        blob = b"".join(shard_blobs)
        fname = f"shard-{shard_idx:05d}.lcs"
        _atomic_write(os.path.join(cache_dir, fname), blob)
        shards.append({"file": fname, "rows": shard_row_cnt,
                       "bytes": len(blob)})
        total_bytes += len(blob)
        shard_idx += 1
        shard_blobs = [_MAGIC]
        shard_row_cnt = 0

    for chunk in _chunks():
        if spec is not None:
            chunk = spec.apply(chunk)
        rows = len(chunk["labels"])
        nnz = (chunk["mask"] > 0).sum(axis=1).astype(np.int64)
        payload, flags = _encode_block(
            chunk["fids"], chunk["fields"], chunk["vals"],
            chunk["labels"], nnz)
        header_tail = struct.pack("<III", len(payload), rows, flags)
        crc = _checksum_bytes(header_tail + payload)
        shard_blobs.append(_BLOCK_HEADER.pack(len(payload), rows, flags,
                                              crc))
        shard_blobs.append(payload)
        shard_row_cnt += rows
        total_rows += rows
        if shard_row_cnt >= shard_rows:
            _flush()
    _flush()

    manifest = dict(key)
    manifest.update({
        "source_path": os.path.abspath(path),
        "width": width,
        "spec": spec.to_dict() if spec is not None else None,
        "rows": total_rows,
        "shards": shards,
    })
    _atomic_write(os.path.join(cache_dir, _MANIFEST),
                  json.dumps(manifest, indent=1).encode())
    if obs.enabled():
        reg.inc("ingest_shard_compiles_total")
        if stale:
            reg.inc("ingest_shard_recoveries_total")
        if total_rows:
            reg.inc("ingest_shard_rows_total", total_rows)
        if total_bytes:
            reg.inc("ingest_shard_bytes_total", total_bytes)
    return ShardCache(cache_dir, manifest)


# -- replay -------------------------------------------------------------------


def _iter_cache_batches(cache: ShardCache, batch_size: int,
                        drop_remainder: bool,
                        order: Optional[Iterable[int]] = None,
                        registry=None) -> Iterator[Dict[str, np.ndarray]]:
    """Re-slice decoded blocks into ``batch_size`` batches with a
    ``row_mask`` — the exact shape contract of the live reader, so the
    stride/shuffle machinery downstream cannot tell the difference."""
    width = cache.width
    buf = _new_buffers(batch_size, width)
    fill = 0
    ones = np.ones(batch_size, np.float32)
    for block in cache.iter_blocks(order, registry=registry):
        rows = len(block["labels"])
        ofs = 0
        while ofs < rows:
            if fill == 0 and rows - ofs >= batch_size:
                # aligned fast path: a full batch is a pure slice of the
                # freshly-decoded block — no buffer copy
                yield {
                    "fids": block["fids"][ofs:ofs + batch_size],
                    "fields": block["fields"][ofs:ofs + batch_size],
                    "vals": block["vals"][ofs:ofs + batch_size],
                    "mask": block["mask"][ofs:ofs + batch_size],
                    "labels": block["labels"][ofs:ofs + batch_size],
                    "row_mask": ones,
                }
                ofs += batch_size
                continue
            n = min(batch_size - fill, rows - ofs)
            for k in ("fids", "fields", "vals", "mask"):
                buf[k][fill:fill + n] = block[k][ofs:ofs + n]
            buf["labels"][fill:fill + n] = block["labels"][ofs:ofs + n]
            buf["row_mask"][fill:fill + n] = 1.0
            fill += n
            ofs += n
            if fill == batch_size:
                yield buf
                buf = _new_buffers(batch_size, width)
                fill = 0
    if fill and not drop_remainder:
        yield buf


def iter_shard_batches(
    cache: ShardCache,
    batch_size: int,
    drop_remainder: bool = True,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    *,
    loop: bool = False,
    shuffle_batches: int = 0,
    seed: int = 0,
    shard_shuffle: bool = False,
    stop=None,
    registry=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Replay the compiled cache as the batch stream the live reader
    would yield — same wrap, same ``(seed, epoch)`` batch-buffer
    reshuffle, same ``process_index % process_count`` striding, BY
    CONSTRUCTION: the cache feeds the very ``_stride_rebatch`` /
    ``_shuffle_buffer`` generators the live path uses (parity pinned in
    tests).  ``shard_shuffle`` composes a seeded SHARD-level permutation
    (rng stream ``(seed, epoch, salt)``) underneath the batch buffer:
    every worker draws the same permutation, so the stride shard stays
    consistent across the fleet."""
    if (process_index is None) != (process_count is None):
        raise ValueError("process_index and process_count go together")
    if process_count is not None and not (
            0 <= process_index < process_count):
        raise ValueError(
            f"process_index {process_index} not in [0, {process_count})")

    def _epoch_stream(epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = None
        if shard_shuffle:
            rng = np.random.default_rng([seed, epoch, _SHARD_SALT])
            order = rng.permutation(cache.n_shards)
        if process_count is not None:
            inner = _iter_cache_batches(
                cache, batch_size, drop_remainder=False, order=order,
                registry=registry)
            return _stride_rebatch(
                inner, batch_size, process_index, process_count,
                drop_remainder)
        return _iter_cache_batches(
            cache, batch_size, drop_remainder, order=order,
            registry=registry)

    if loop:
        epoch = 0
        while not _stop_requested(stop):
            inner = _epoch_stream(epoch)
            if shuffle_batches > 1:
                inner = _shuffle_buffer(
                    inner, np.random.default_rng([seed, epoch]),
                    shuffle_batches)
            for b in inner:
                if _stop_requested(stop):
                    return
                yield b
            epoch += 1
        return
    inner = _epoch_stream(0)
    if shuffle_batches > 1:
        inner = _shuffle_buffer(
            inner, np.random.default_rng([seed, 0]), shuffle_batches)
    yield from inner


def iter_ingest_batches(
    path: str,
    batch_size: int,
    max_nnz: int,
    feature_cnt: Optional[int] = None,
    field_cnt: Optional[int] = None,
    drop_remainder: bool = True,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    *,
    loop: bool = False,
    shuffle_batches: int = 0,
    seed: int = 0,
    stop=None,
    spec: Optional[FeatureSpec] = None,
    compile: bool = True,
    cache_dir: Optional[str] = None,
    shard_shuffle: bool = False,
    block_rows: int = 4096,
    shard_rows: int = 1 << 16,
    registry=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """The compiled data plane's front door: ensure the shard cache
    (one-time compile; every later epoch and every fleet worker replays
    pre-tokenized rows) and stream batches from it.  ``compile=False``
    is the LIVE path — the text re-parses each epoch with the same spec
    applied, useful before a cache exists or as the parity oracle."""
    feature_cnt, field_cnt = _resolve_folds(feature_cnt, field_cnt, spec)
    if not compile:
        inner = iter_libffm_batches(
            path, batch_size, max_nnz, feature_cnt, field_cnt,
            drop_remainder, None, process_index, process_count,
            loop=loop, shuffle_batches=shuffle_batches, seed=seed,
            stop=stop)
        if spec is not None:
            inner = (spec.apply(b) for b in inner)
        yield from inner
        return
    cache = compile_shards(
        path, max_nnz, cache_dir=cache_dir, feature_cnt=feature_cnt,
        field_cnt=field_cnt, spec=spec, block_rows=block_rows,
        shard_rows=shard_rows, registry=registry)
    yield from iter_shard_batches(
        cache, batch_size, drop_remainder, process_index, process_count,
        loop=loop, shuffle_batches=shuffle_batches, seed=seed,
        shard_shuffle=shard_shuffle, stop=stop, registry=registry)


def as_arrays(source, max_nnz: Optional[int] = None, **compile_kw
              ) -> Dict[str, np.ndarray]:
    """Materialize a full padded-array dict (fids/fields/vals/mask/
    labels) from a :class:`ShardCache`, a cache DIRECTORY, or a raw
    libFFM path (compiled on first touch — re-runs load with zero parse
    work).  The full-batch trainers (``fit(batch_size=None)`` /
    ``fit_fullbatch_scan``) consume this directly."""
    if isinstance(source, ShardCache):
        cache = source
    elif isinstance(source, str) and \
            os.path.isfile(os.path.join(source, _MANIFEST)):
        cache = load_cache(source)
        if cache is None:
            raise ShardCorruption(f"{source}: unreadable shard cache")
    elif isinstance(source, str):
        if max_nnz is None:
            raise ValueError("compiling from a raw file needs max_nnz")
        cache = compile_shards(source, max_nnz, **compile_kw)
    else:
        raise TypeError(f"cannot load arrays from {type(source)!r}")
    blocks = list(cache.iter_blocks())
    if not blocks:
        w = cache.width
        return {"fids": np.zeros((0, w), np.int32),
                "fields": np.zeros((0, w), np.int32),
                "vals": np.zeros((0, w), np.float32),
                "mask": np.zeros((0, w), np.float32),
                "labels": np.zeros((0,), np.float32)}
    return {k: np.concatenate([b[k] for b in blocks], axis=0)
            for k in ("fids", "fields", "vals", "mask", "labels")}


# -- prefetch pipeline --------------------------------------------------------


def prefetch_batches(
    inner: Iterable,
    depth: int = 2,
    prepare=None,
    registry=None,
    monitor=None,
    name: str = "ingest_prefetch",
) -> Iterator:
    """Keep ``depth`` batches in flight behind the consumer: a worker
    thread drains ``inner``, runs ``prepare`` on each item (the trainer's
    staging of a batch onto its device: parse, pad and copy all happen OFF
    the step's critical path), and parks results in a bounded queue.

    The queue carries an :class:`~lightctr_tpu_torch.obs.resources.
    InstrumentedQueue` face (``resource_queue_*{queue=name}`` +
    ``queue_saturation`` when a monitor rides along), and the stage reports
    its own honesty gauge: ``ingest_overlap_ratio`` = fraction of consumer
    gets served without blocking.  A fully-hidden ingest reads ~1.0 (only
    the warm-up get blocks); a pipeline that secretly serializes reads
    ~0.0.

    Worker exceptions surface in the consumer (re-raised from the queue);
    closing the generator stops the worker and releases the queue
    telemetry."""
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    reg = registry if registry is not None else obs.default_registry()
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    iq = resources_mod.InstrumentedQueue(
        name, capacity=depth, registry=reg, monitor=monitor)
    stop_evt = threading.Event()

    def _put(kind, item) -> bool:
        """Park one queue entry, retrying until the consumer stops."""
        while not stop_evt.is_set():
            try:
                q.put((kind, item), timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _worker():
        try:
            for item in inner:
                out = prepare(item) if prepare is not None else item
                if not _put(0, out):
                    return
                iq.note_enqueue()
                iq.set_depth(q.qsize())
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            _put(2, e)
        else:
            _put(1, None)

    t = threading.Thread(target=_worker, name=f"{name}-worker",
                         daemon=True)
    t.start()
    delivered = 0
    ready = 0
    try:
        while True:
            t0 = time.perf_counter()
            try:
                kind, item = q.get_nowait()
                waited = 0.0
                was_ready = True
            except queue_mod.Empty:
                was_ready = False
                kind, item = q.get()
                waited = time.perf_counter() - t0
            iq.set_depth(q.qsize())
            if kind == 1:
                return
            if kind == 2:
                raise item
            delivered += 1
            ready += was_ready
            iq.note_wait(waited)
            if obs.enabled():
                reg.inc("ingest_prefetch_batches_total")
                if was_ready:
                    reg.inc("ingest_prefetch_ready_total")
                reg.observe("ingest_wait_seconds", waited)
                reg.gauge_set("ingest_overlap_ratio", ready / delivered)
            yield item
    finally:
        stop_evt.set()
        while True:  # unblock a worker stuck on a full queue
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        t.join(timeout=5.0)
        iq.close()
