"""ctypes bindings + on-demand build of the native components."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [
    "libffm_parser.cpp", "shm_kv.cpp", "varint.cpp", "fm_cpu.cpp",
    "ffm_cpu.cpp", "ps_rows.cpp",
]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None


def _source_digest() -> str:
    h = hashlib.sha256()
    for s in _SOURCES:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    # the build is host-tuned (-march=native), so the cache key must identify
    # the host ISA too: a repo on shared storage must not reuse an AVX-512
    # .so on an older machine (SIGILL on dlopen'd code)
    import platform

    h.update(platform.machine().encode())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    h.update(line.encode())
                    break
    except OSError:
        pass
    return h.hexdigest()[:16]


def _build() -> Optional[ctypes.CDLL]:
    global _BUILD_ERROR
    so_path = os.path.join(_DIR, f"_lightctr_native_{_source_digest()}.so")
    if not os.path.exists(so_path):
        # compile to a per-process temp path, then atomically rename: two
        # fresh processes may race here and must never dlopen a half-written so
        tmp_path = f"{so_path}.tmp.{os.getpid()}"

        def cmd(arch_flags):
            return [
                "g++", "-O3", "-std=c++17", "-shared", "-fPIC", *arch_flags,
                *[os.path.join(_DIR, s) for s in _SOURCES],
                "-o", tmp_path,
            ]

        try:
            # the .so is digest-keyed and built on the machine that runs it,
            # so tune for the host ISA (AVX2/512 inner loops in fm_cpu.cpp);
            # retry portable when the toolchain rejects -march=native
            try:
                subprocess.run(
                    cmd(["-march=native"]), check=True,
                    capture_output=True, text=True,
                )
            except subprocess.CalledProcessError:
                subprocess.run(
                    cmd([]), check=True, capture_output=True, text=True
                )
            os.replace(tmp_path, so_path)
        except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
            _BUILD_ERROR = getattr(e, "stderr", str(e)) or str(e)
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
            return None
    lib = ctypes.CDLL(so_path)
    # signatures
    lib.ffm_scan.restype = ctypes.c_int
    lib.ffm_scan.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_long)] * 5
    lib.ffm_parse.restype = ctypes.c_int
    lib.ffm_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ffm_parse_chunk.restype = ctypes.c_long
    lib.ffm_parse_chunk.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.shmkv_create.restype = ctypes.c_void_p
    lib.shmkv_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.shmkv_open.restype = ctypes.c_void_p
    lib.shmkv_open.argtypes = [ctypes.c_char_p]
    for name in ("shmkv_capacity", "shmkv_dim", "shmkv_used"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    lib.shmkv_get.restype = ctypes.c_int
    lib.shmkv_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
    lib.shmkv_set.restype = ctypes.c_int
    lib.shmkv_set.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
    lib.shmkv_add.restype = ctypes.c_int
    lib.shmkv_add.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
    lib.shmkv_get_batch.restype = ctypes.c_int
    lib.shmkv_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
    ]
    for name in ("shmkv_set_batch", "shmkv_add_batch"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
        ]
    lib.shmkv_adagrad_batch.restype = ctypes.c_int
    lib.shmkv_adagrad_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_float,
    ]
    lib.rows_adagrad.restype = None
    lib.rows_adagrad.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
    ]
    lib.f32_to_f16.restype = None
    lib.f32_to_f16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64,
    ]
    lib.f16_to_f32.restype = None
    lib.f16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.shmkv_sync.restype = ctypes.c_int
    lib.shmkv_sync.argtypes = [ctypes.c_void_p]
    lib.shmkv_close.restype = None
    lib.shmkv_close.argtypes = [ctypes.c_void_p]
    lib.varint_pack.restype = ctypes.c_long
    lib.varint_pack.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_long,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,
    ]
    lib.varint_unpack.restype = ctypes.c_long
    lib.varint_unpack.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_long,
    ]
    lib.shard_decode_block.restype = ctypes.c_long
    lib.shard_decode_block.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,  # payload, nbytes
        ctypes.c_long, ctypes.c_long, ctypes.c_int,     # rows, width, f16
        ctypes.POINTER(ctypes.c_int32),   # fids
        ctypes.POINTER(ctypes.c_int32),   # fields
        ctypes.POINTER(ctypes.c_float),   # vals
        ctypes.POINTER(ctypes.c_float),   # mask
        ctypes.POINTER(ctypes.c_float),   # labels
    ]
    lib.fm_train_fullbatch.restype = ctypes.c_int
    lib.fm_train_fullbatch.argtypes = [
        ctypes.POINTER(ctypes.c_int64),   # row_ptr
        ctypes.POINTER(ctypes.c_int32),   # fids
        ctypes.POINTER(ctypes.c_float),   # vals
        ctypes.POINTER(ctypes.c_float),   # labels
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # B, F, K
        ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),   # w
        ctypes.POINTER(ctypes.c_float),   # v
        ctypes.POINTER(ctypes.c_float),   # losses
    ]
    lib.ffm_train_fullbatch.restype = ctypes.c_int
    lib.ffm_train_fullbatch.argtypes = [
        ctypes.POINTER(ctypes.c_int64),   # row_ptr
        ctypes.POINTER(ctypes.c_int32),   # fids
        ctypes.POINTER(ctypes.c_int32),   # fields
        ctypes.POINTER(ctypes.c_float),   # vals
        ctypes.POINTER(ctypes.c_float),   # labels
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),   # w
        ctypes.POINTER(ctypes.c_float),   # v
        ctypes.POINTER(ctypes.c_float),   # losses
    ]
    return lib


def lib() -> Optional[ctypes.CDLL]:
    global _LIB
    with _LOCK:
        if _LIB is None and _BUILD_ERROR is None:
            _LIB = _build()
        return _LIB


def available() -> bool:
    return lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def parse_libffm_native(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Two-pass native parse -> (fields, fids, vals, mask, labels) padded
    arrays.  Raises on parse errors with the offending line number."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    n_rows = ctypes.c_long()
    max_nnz = ctypes.c_long()
    max_fid = ctypes.c_long()
    max_field = ctypes.c_long()
    err_line = ctypes.c_long()
    rc = l_.ffm_scan(
        path.encode(), ctypes.byref(n_rows), ctypes.byref(max_nnz),
        ctypes.byref(max_fid), ctypes.byref(max_field), ctypes.byref(err_line),
    )
    if rc == -1:
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"{path}:{err_line.value}: bad libFFM token (expected field:fid:val)")
    n, p = n_rows.value, max_nnz.value
    fields = np.zeros((n, p), np.int32)
    fids = np.zeros((n, p), np.int32)
    vals = np.zeros((n, p), np.float32)
    mask = np.zeros((n, p), np.float32)
    labels = np.zeros((n,), np.float32)
    if n > 0 and p > 0:
        rc = l_.ffm_parse(
            path.encode(), n, p, _iptr(fields), _iptr(fids), _fptr(vals),
            _fptr(mask), _fptr(labels),
        )
        if rc != 0:
            raise ValueError(f"{path}: parse failed (rc={rc})")
    return fields, fids, vals, mask, labels


def parse_libffm_chunk(
    path: str, offset: int, max_rows: int, max_nnz: int,
    fold_fid: int = 0, fold_field: int = 0,
    stride: int = 1, phase: int = 0, end: int = 0,
) -> Tuple[dict, int, int]:
    """Parse up to ``max_rows`` rows starting at byte ``offset`` into padded
    arrays.  Returns ``(arrays, rows_parsed, next_offset)`` where ``arrays``
    has fields/fids/vals/mask/labels of leading dim ``max_rows`` (tail rows
    zero when fewer were available).  Rows longer than ``max_nnz`` are
    truncated — the streaming-generator semantics.  ``fold_fid``/``fold_field``
    > 0 fold ids modulo the vocabulary natively on the exact long value (the
    hashing trick), matching the Python generator's pre-narrowing fold.
    ``stride``/``phase``: tokenize only chunk rows with index % stride ==
    phase (others are counted but line-skipped, their array rows zero) —
    the per-worker shard applied at the scan.  ``end`` > 0 bounds the scan:
    no line starting at or past that byte is read.  It must sit on a
    newline boundary — the follow tailer passes the last known one so a
    writer's partial trailing line is never parsed."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    fields = np.zeros((max_rows, max_nnz), np.int32)
    fids = np.zeros((max_rows, max_nnz), np.int32)
    vals = np.zeros((max_rows, max_nnz), np.float32)
    mask = np.zeros((max_rows, max_nnz), np.float32)
    labels = np.zeros((max_rows,), np.float32)
    off = ctypes.c_long(offset)
    err_line = ctypes.c_long()
    rc = l_.ffm_parse_chunk(
        path.encode(), ctypes.byref(off), end, max_rows, max_nnz,
        fold_fid, fold_field, stride, phase,
        _iptr(fields), _iptr(fids), _fptr(vals), _fptr(mask), _fptr(labels),
        ctypes.byref(err_line),
    )
    if rc == -1:
        raise OSError(f"cannot read {path} at offset {offset}")
    if rc == -2:
        raise ValueError(
            f"{path}: bad libFFM token ~{err_line.value} lines after "
            f"offset {offset}"
        )
    if rc == -3:
        missing = []
        if fold_fid <= 0:
            missing.append("feature_cnt")
        if fold_field <= 0:
            missing.append("field_cnt")
        raise ValueError(
            f"{path}: id exceeds int32 ~{err_line.value} lines after offset "
            f"{offset}; pass {' / '.join(missing) or 'a larger fold'} to fold "
            "large ids into the vocabulary"
        )
    if rc < 0:
        raise RuntimeError(f"{path}: native chunk parse failed (rc={rc})")
    arrays = {
        "fields": fields, "fids": fids, "vals": vals, "mask": mask,
        "labels": labels,
    }
    return arrays, int(rc), int(off.value)


class ShmKV:
    """Persistent shared-memory KV of float rows (ShmHashTable +
    PersistentBuffer parity; see shm_kv.cpp)."""

    def __init__(self, handle, dim: int):
        self._h = handle
        self.dim = dim

    @property
    def _handle(self):
        """Live handle or a loud error — the C side has no NULL guards, so a
        use-after-close must fail here, not as a segfault in shmkv_*."""
        if self._h is None:
            raise RuntimeError("ShmKV store is closed")
        return self._h

    @classmethod
    def create(cls, path: str, capacity: int, dim: int) -> "ShmKV":
        l_ = lib()
        if l_ is None:
            raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
        h = l_.shmkv_create(path.encode(), capacity, dim)
        if not h:
            raise OSError(f"cannot create store at {path}")
        return cls(h, dim)

    @classmethod
    def open(cls, path: str) -> "ShmKV":
        l_ = lib()
        if l_ is None:
            raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
        h = l_.shmkv_open(path.encode())
        if not h:
            raise OSError(f"cannot open store at {path}")
        return cls(h, lib().shmkv_dim(h))

    @property
    def capacity(self) -> int:
        return lib().shmkv_capacity(self._handle)

    @property
    def used(self) -> int:
        return lib().shmkv_used(self._handle)

    def get(self, key: int) -> Optional[np.ndarray]:
        out = np.zeros(self.dim, np.float32)
        rc = lib().shmkv_get(self._handle, key, _fptr(out))
        return out if rc == 0 else None

    _SENTINEL = (1 << 64) - 1  # EMPTY slot marker in shm_kv.cpp

    def _check_key(self, key: int) -> None:
        if not (0 <= key < self._SENTINEL):
            raise ValueError(f"key {key} out of range [0, 2^64-1)")

    def set(self, key: int, value: np.ndarray) -> None:
        self._check_key(key)
        v = np.ascontiguousarray(value, np.float32)
        if v.shape != (self.dim,):
            raise ValueError(f"value shape {v.shape} != ({self.dim},)")
        rc = lib().shmkv_set(self._handle, key, _fptr(v))
        if rc == -2:
            raise RuntimeError("store full")

    def add(self, key: int, delta: np.ndarray) -> None:
        self._check_key(key)
        v = np.ascontiguousarray(delta, np.float32)
        if v.shape != (self.dim,):
            raise ValueError(f"delta shape {v.shape} != ({self.dim},)")
        rc = lib().shmkv_add(self._handle, key, _fptr(v))
        if rc == -2:
            raise RuntimeError("store full")

    def get_batch(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ks = np.ascontiguousarray(keys, np.uint64)
        out = np.zeros((len(ks), self.dim), np.float32)
        found = np.zeros(len(ks), np.uint8)
        lib().shmkv_get_batch(
            self._handle, ks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(ks), _fptr(out), found.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out, found.astype(bool)

    def _batch_args(self, keys: np.ndarray, rows: np.ndarray, what: str):
        ks = np.ascontiguousarray(keys, np.uint64)
        if len(ks) and int(ks.max()) >= self._SENTINEL:
            raise ValueError(f"key {int(ks.max())} out of range [0, 2^64-1)")
        r = np.ascontiguousarray(rows, np.float32)
        if r.shape != (len(ks), self.dim):
            raise ValueError(
                f"{what} shape {r.shape} != ({len(ks)}, {self.dim})"
            )
        return ks, ks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), r

    def set_batch(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """rows[i] -> keys[i] in one native call (insert if absent)."""
        ks, kp, r = self._batch_args(keys, rows, "rows")
        if lib().shmkv_set_batch(self._handle, kp, len(ks), _fptr(r)) == -2:
            raise RuntimeError("store full")

    def add_batch(self, keys: np.ndarray, deltas: np.ndarray) -> None:
        """Atomic float-CAS adds of deltas[i] into keys[i], one native call
        for the whole batch (the shm push hot path)."""
        ks, kp, r = self._batch_args(keys, deltas, "deltas")
        if lib().shmkv_add_batch(self._handle, kp, len(ks), _fptr(r)) == -2:
            raise RuntimeError("store full")

    def adagrad_batch(self, accum: "ShmKV", keys: np.ndarray,
                      grads: np.ndarray, lr: float, eps: float) -> None:
        """Fused sparse-Adagrad over (self=data, accum) stores — see
        shmkv_adagrad_batch in shm_kv.cpp."""
        ks, kp, g = self._batch_args(keys, grads, "grads")
        rc = lib().shmkv_adagrad_batch(
            self._handle, accum._handle, kp, len(ks), _fptr(g),
            float(lr), float(eps),
        )
        if rc == -2:
            raise RuntimeError("store full")
        if rc == -4:
            raise ValueError("data/accum dim mismatch")

    def sync(self) -> None:
        lib().shmkv_sync(self._handle)

    def close(self) -> None:
        if self._h:
            lib().shmkv_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def varint_pack_native(vals: np.ndarray) -> bytes:
    """Zigzag+LEB128 pack of an int64 array (native)."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    v = np.ascontiguousarray(vals, np.int64)
    out = np.empty(10 * len(v) + 1, np.uint8)
    n = l_.varint_pack(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(v),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(out),
    )
    if n < 0:
        raise RuntimeError("varint_pack buffer overflow (cannot happen)")
    return out[:n].tobytes()


def varint_unpack_native(buf: bytes, n: int, return_consumed: bool = False):
    """Decode exactly ``n`` int64 values from a varint stream (native).
    With ``return_consumed`` also returns the bytes consumed."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    b = np.frombuffer(buf, np.uint8)
    out = np.empty(n, np.int64)
    rc = l_.varint_unpack(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(b),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n,
    )
    if rc == -1:
        raise ValueError("truncated varint stream")
    if rc == -2:
        raise ValueError("corrupt varint stream (value overflows 64 bits)")
    return (out, int(rc)) if return_consumed else out


def shard_decode_native(payload, rows: int, width: int, vals_f16: bool,
                        fids: np.ndarray, fields: np.ndarray,
                        vals: np.ndarray, mask: np.ndarray,
                        labels: np.ndarray) -> int:
    """One-pass decode of a shard-block payload (data/ingest.py wire
    format) into caller-ZEROED padded ``[rows, width]`` arrays
    (varint.cpp ``shard_decode_block``): varint+delta+scatter in a
    single sequential walk.  Returns total tokens; raises ValueError on
    a structurally corrupt payload."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    buf = np.frombuffer(payload, np.uint8)
    rc = l_.shard_decode_block(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(buf),
        rows, width, int(bool(vals_f16)),
        fids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fields.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc < 0:
        raise ValueError(
            {-1: "truncated varint stream", -2: "nnz out of range",
             -3: "payload length mismatch",
             -4: "id outside int32 range"}.get(rc, f"decode error {rc}"))
    return int(rc)


def rows_adagrad_native(W: np.ndarray, acc: np.ndarray, slots: np.ndarray,
                        g: np.ndarray, lr: float, eps: float) -> None:
    """Fused in-place sparse-Adagrad over slot-indexed rows of ``W``/``acc``
    (ps_rows.cpp): one memory pass instead of numpy _apply's five.  Caller
    must hold the store's lock; arrays must be C-contiguous fp32."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    s = np.ascontiguousarray(slots, np.int64)
    gg = np.ascontiguousarray(g, np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    l_.rows_adagrad(
        W.ctypes.data_as(fptr), acc.ctypes.data_as(fptr),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gg.ctypes.data_as(fptr), len(s), W.shape[1],
        ctypes.c_float(lr), ctypes.c_float(eps),
    )


def f16_encode_native(v: np.ndarray) -> np.ndarray:
    """fp32 -> fp16 bit pattern via the host's hardware converters
    (ps_rows.cpp); returns a uint16 array aliasing nothing."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    src = np.ascontiguousarray(v, np.float32)
    out = np.empty(src.size, np.uint16)
    l_.f32_to_f16(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), src.size,
    )
    return out


def f16_decode_native(buf, n: int) -> np.ndarray:
    """fp16 bytes/uint16 array -> fp32 array of ``n`` values (hardware
    converters, ps_rows.cpp)."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    src = np.frombuffer(buf, np.uint16) if isinstance(buf, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(buf, np.uint16)
    if src.size != n:
        raise ValueError(f"expected {n} fp16 values, got {src.size}")
    out = np.empty(n, np.float32)
    l_.f16_to_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    return out


def _csr_flatten(arrays: dict, feature_cnt: int, with_fields: bool = False):
    """Padded batch dict -> CSR (row_ptr, fids[, fields], vals, labels) for
    the native trainers; validates fid range."""
    mask = np.asarray(arrays["mask"]) > 0
    vals_p = (np.asarray(arrays["vals"], np.float32)
              * np.asarray(arrays["mask"], np.float32))
    nnz = mask.sum(axis=1).astype(np.int64)
    row_ptr = np.zeros(len(nnz) + 1, np.int64)
    np.cumsum(nnz, out=row_ptr[1:])
    fids = np.ascontiguousarray(np.asarray(arrays["fids"], np.int32)[mask])
    vals = np.ascontiguousarray(vals_p[mask], np.float32)
    labels = np.ascontiguousarray(arrays["labels"], np.float32)
    if fids.size and (fids.min() < 0 or fids.max() >= feature_cnt):
        raise ValueError("fid out of range for feature_cnt")
    if with_fields:
        fields = np.ascontiguousarray(
            np.asarray(arrays["fields"], np.int32)[mask]
        )
        return row_ptr, fids, fields, vals, labels
    return row_ptr, fids, vals, labels


def _check_param_buffers(feature_cnt, shapes_and_arrays):
    for name, arr, want_shape in shapes_and_arrays:
        if arr.shape != want_shape:
            raise ValueError(f"{name} shape {arr.shape} != {want_shape}")
        if arr.dtype != np.float32:
            # ctypes would silently reinterpret float64 memory as float32
            raise ValueError(f"{name} must be float32, got {arr.dtype}")
        if not arr.flags.c_contiguous:
            raise ValueError(f"{name} must be C-contiguous")


def fm_train_fullbatch_native(
    arrays: dict,
    feature_cnt: int,
    factor_cnt: int,
    epochs: int,
    learning_rate: float,
    lambda_l2: float,
    w: np.ndarray,
    v: np.ndarray,
    eps: float = 1e-7,
) -> np.ndarray:
    """Run `epochs` full-batch FM Adagrad steps natively, updating (w, v)
    in place from a padded batch dict; returns the per-epoch mean losses.
    Same trajectory as CTRTrainer(fm.logits_with_l2) to float rounding
    (tests/test_fm_native.py)."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    row_ptr, fids, vals, labels = _csr_flatten(arrays, feature_cnt)
    _check_param_buffers(feature_cnt, [
        ("w", w, (feature_cnt,)),
        ("v", v, (feature_cnt, factor_cnt)),
    ])
    losses = np.zeros(epochs, np.float32)
    rc = l_.fm_train_fullbatch(
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        fids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _fptr(vals), _fptr(labels),
        len(labels), feature_cnt, factor_cnt,
        epochs, learning_rate, lambda_l2, eps,
        _fptr(w), _fptr(v.reshape(-1)), _fptr(losses),
    )
    if rc != 0:
        raise RuntimeError(f"fm_train_fullbatch rc={rc}")
    return losses


def ffm_train_fullbatch_native(
    arrays: dict,
    feature_cnt: int,
    field_cnt: int,
    factor_cnt: int,
    epochs: int,
    learning_rate: float,
    lambda_l2: float,
    w: np.ndarray,
    v: np.ndarray,
    eps: float = 1e-7,
) -> np.ndarray:
    """Native full-batch FFM Adagrad, updating (w, v[F, Fl, K]) in place;
    returns per-epoch mean losses.  Trajectory parity with
    CTRTrainer(ffm.logits_with_l2) — tests/test_ffm_native.py."""
    l_ = lib()
    if l_ is None:
        raise RuntimeError(f"native library unavailable: {_BUILD_ERROR}")
    row_ptr, fids, fields, vals, labels = _csr_flatten(
        arrays, feature_cnt, with_fields=True
    )
    if fields.size and (fields.min() < 0 or fields.max() >= field_cnt):
        raise ValueError("field out of range for field_cnt")
    _check_param_buffers(feature_cnt, [
        ("w", w, (feature_cnt,)),
        ("v", v, (feature_cnt, field_cnt, factor_cnt)),
    ])
    losses = np.zeros(epochs, np.float32)
    rc = l_.ffm_train_fullbatch(
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        fids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fields.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _fptr(vals), _fptr(labels),
        len(labels), feature_cnt, field_cnt, factor_cnt,
        epochs, learning_rate, lambda_l2, eps,
        _fptr(w), _fptr(v.reshape(-1)), _fptr(losses),
    )
    if rc != 0:
        raise RuntimeError(f"ffm_train_fullbatch rc={rc}")
    return losses
