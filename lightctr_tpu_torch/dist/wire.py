"""Host wire formats for PS traffic that leaves the chip domain.

On-mesh collectives compress with the jittable quantile codec
(`dist.collectives`, `ops.quantize`); this module is the HOST boundary — the
byte format for sparse pull/push requests that ride DCN / sockets / files
between processes, the role of the reference's ZeroMQ ``Buffer`` packing:

  - key streams: VarUint packing (buffer.h:112-128) becomes sorted-delta +
    zigzag + LEB128 varints (``pack_keys``), implemented natively
    (``native/varint.cpp``) with a numpy/python fallback.  Sorted unique
    fids delta-code to tiny integers, so a request that is 8 bytes/key raw
    typically packs to ~1-2 bytes/key.
  - float payloads: the fp16 value codec the reference applies to every PS
    value (paramserver.h:161-163) — numpy half round-trip on host
    (``pack_values`` / ``unpack_values``).

A packed request frames as: ``n_keys`` varint, then the delta-coded key
stream — self-describing and byte-order independent.

Trace context (obs/trace.py) crosses the wire as an OPTIONAL varint-framed
header: a frame whose type byte carries :data:`TRACE_FLAG` (bit 7 — real
op types stay < 0x80) prefixes its payload with
``pack_trace_ctx(trace_id, span_id)``.  Headerless frames are bit-for-bit
the pre-trace format, and a tracing-disabled client emits exactly those —
so old and new peers interoperate whenever tracing is off, and an
unexpected flagged frame at an old server fails loud (protocol-error
reply), never silently misparses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lightctr_tpu_torch.native import bindings


def _pack_py(vals: np.ndarray) -> bytes:
    out = bytearray()
    for v in vals.tolist():
        u = (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1
        while True:
            b = u & 0x7F
            u >>= 7
            out.append(b | (0x80 if u else 0))
            if not u:
                break
    return bytes(out)


def _unpack_py(buf: bytes, n: int) -> Tuple[np.ndarray, int]:
    out = np.empty(n, np.int64)
    pos = 0
    for i in range(n):
        u = 0
        shift = 0
        while True:
            if pos >= len(buf):
                raise ValueError("truncated varint stream")
            b = buf[pos]
            pos += 1
            u |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                # match the native decoder's contract (varint.cpp rc=-2):
                # a run of >10 continuation bytes is a corrupt stream, not
                # a numpy OverflowError at assignment time
                raise ValueError("corrupt varint stream")
        # a final byte can still set bits >= 64 (shift == 63): the native
        # decoder's uint64 arithmetic truncates silently, so mask to agree
        # with it instead of overflowing the int64 assignment below
        u &= 0xFFFFFFFFFFFFFFFF
        out[i] = (u >> 1) ^ -(u & 1)
    return out, pos


# bit 7 of the frame-type byte: "payload starts with a trace header".
# Message types are small positive ints, so the flag never collides.
TRACE_FLAG = 0x80


def pack_trace_ctx(trace_id: int, span_id: int) -> bytes:
    """(trace_id, parent span_id) -> varint trace header.  Ids are 63-bit
    (obs/trace.py) so they ride the zigzag-int64 codec losslessly."""
    return pack_varint(np.array([trace_id, span_id], np.int64))


def split_trace_ctx(buf: bytes):
    """Decode a :func:`pack_trace_ctx` header -> ((trace_id, span_id),
    bytes consumed) — the remainder of ``buf`` is the original payload."""
    vals, consumed = split_varint(buf, 2)
    return (int(vals[0]), int(vals[1])), consumed


def pack_varint(vals: np.ndarray) -> bytes:
    """Zigzag+varint pack of an int64 array (native when built)."""
    v = np.ascontiguousarray(vals, np.int64)
    if bindings.available():
        return bindings.varint_pack_native(v)
    return _pack_py(v)


def split_varint(buf: bytes, n: int) -> Tuple[np.ndarray, int]:
    """Decode exactly ``n`` int64 values; also returns the bytes consumed,
    so framed messages can slice past the varint section without
    re-encoding it."""
    if bindings.available():
        return bindings.varint_unpack_native(buf, n, return_consumed=True)
    return _unpack_py(buf, n)


def unpack_varint(buf: bytes, n: int) -> np.ndarray:
    """Decode exactly ``n`` int64 values."""
    return split_varint(buf, n)[0]


def pack_keys(keys: np.ndarray) -> bytes:
    """Compact a key batch: sort, delta, varint — the VarUint request stream.
    Accepts any integer array; duplicates are preserved (delta 0 = 1 byte)."""
    k = np.sort(np.asarray(keys, np.int64).reshape(-1))
    deltas = np.diff(k, prepend=0)
    header = pack_varint(np.array([k.size], np.int64))
    return header + pack_varint(deltas)


def split_keys(buf: bytes) -> Tuple[np.ndarray, int]:
    """Decode a :func:`pack_keys` stream -> (sorted int64 keys, bytes
    consumed)."""
    hdr, hdr_len = split_varint(buf[:10], 1)
    deltas, body_len = split_varint(buf[hdr_len:], int(hdr[0]))
    return np.cumsum(deltas), hdr_len + body_len


def unpack_keys(buf: bytes) -> np.ndarray:
    """Inverse of :func:`pack_keys` -> sorted int64 keys."""
    return split_keys(buf)[0]


def pack_values(vals: np.ndarray) -> Tuple[bytes, tuple]:
    """fp16 value codec for PS payloads (paramserver.h:161-163): returns the
    half-precision bytes and the shape needed to decode.  Native path rides
    the host's hardware fp16 converters (~10x numpy's software astype)."""
    v = np.asarray(vals, np.float32)
    if bindings.available():
        return bindings.f16_encode_native(v).tobytes(), v.shape
    return v.astype(np.float16).tobytes(), v.shape


def unpack_values(buf: bytes, shape: tuple) -> np.ndarray:
    if bindings.available():
        n = int(np.prod(shape)) if shape else 1
        return bindings.f16_decode_native(buf, n).reshape(shape)
    return np.frombuffer(buf, np.float16).astype(np.float32).reshape(shape)


def pack_rows(uids: np.ndarray, rows: np.ndarray) -> bytes:
    """ONE self-describing frame for a sparse (uids, rows) payload — the
    socket-wire form of the on-mesh ``(uids, g_rows)`` exchange
    (dist/collectives.py sparse_all_reduce): ``n`` varint, the delta-coded
    sorted id stream, then the fp16 rows in that id order.

    Byte-compatible BY CONSTRUCTION with the framing the PS protocol has
    always used (``pack_keys(uids) ++ pack_values(rows)``) — unifying the
    codec changes zero wire bytes, old and new peers interoperate
    unconditionally (tested in test_wire_codec.py).  ``uids`` must be
    sorted (the id stream is delta-coded; rows keep the caller's order, so
    an unsorted input would silently misalign — callers validate, as
    PSClient.push_arrays does)."""
    return pack_keys(uids) + pack_values(np.asarray(rows, np.float32))[0]


def unpack_rows(buf: bytes, dim: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Inverse of :func:`pack_rows` -> (sorted int64 uids, [n, dim] fp32
    rows, bytes consumed).  ``dim`` is connection-level config in the PS
    protocol (the server's row width), not part of the frame."""
    keys, consumed = split_keys(buf)
    n_vals = len(keys) * int(dim)
    rows = unpack_values(buf[consumed:consumed + 2 * n_vals],
                         (len(keys), int(dim)))
    return keys, rows, consumed + 2 * n_vals


# -- quantile-coded row frames (the compressed DCN wire, ISSUE 13) -----------
#
# The hierarchical exchange's rendezvous rounds (dist/hier.py) shipped exact
# fp32 over the slowest link in the topology.  The coded frame puts the
# quantile codec of the in-jit collectives (ops/quantize — SparCML-style
# sparse quantized streams, arXiv:1802.08021) on the socket wire:
#
#   ``pack_rows_coded``:  MAGIC ++ id section ++ value section
#   value section:        u8 bits ++ f32 range ++ n*dim u8 codes
#
# The quantile table is the symmetric UNIFORM family parameterized by its
# dynamic range — boundaries/values are derived deterministically on both
# ends (:func:`coded_table`) instead of shipping 2^bits explicit edges, so
# the per-frame table cost is 5 bytes.  Codes are one byte each (bits <= 8);
# encode is ``searchsorted(boundaries, x, side='left')`` — the compare rule
# of ``ops.quantize.compress`` / the fused ``quantize_pack`` kernel, here in
# host numpy over the numpy-derived table (host peers only compare against
# each other's bytes, so the contract that matters is that every host
# derives the identical table from the shipped range).
#
# The id section carries its own 1-byte tag: delta-varint (the pack_keys
# stream — sparse unions) or a range BITMAP (base + span + 1 bit/candidate —
# DENSE unions, where consecutive deltas cost a full varint byte each but
# 1/8th of that as bits; SparCML's index-bitmap switch).  The encoder picks
# whichever is smaller, the decoder dispatches on the tag.
#
# Frames are TAGGED (a magic byte no old frame starts a payload with is
# checked before any decode), so a coded frame reaching an old reader fails
# loud rather than misparsing, and the old fp32/f16 frames are untouched —
# the new reader parses them byte-identically (tested in
# tests/test_wire_codec.py, the PR 3 trace-header interop discipline).

#: first byte of every coded rows frame / grouped section stream
CODED_MAGIC = 0xC3

#: first byte of every CHUNKED push payload (the streaming rendezvous,
#: ISSUE 16): a frame whose header flags carry the chunk bit prefixes its
#: payload with ``CHUNK_MAGIC ++ varint [chunk_idx, n_chunks]``.  The magic
#: is checked before any decode, so a chunked frame reaching an old reader
#: (which would try to parse the payload body directly) fails LOUD on the
#: magic-led varint garbage / row-count mismatch, never half-parses — the
#: same tagged-frame discipline as :data:`CODED_MAGIC`.
CHUNK_MAGIC = 0xC5

#: id-section tags
ID_DELTA = 0    # pack_keys: n varint + zigzag delta varints
ID_BITMAP = 1   # varint [n, base, span] + ceil(span/8) bitmap bytes (LSB0)

#: dynamic-range headroom + floor, the same policy as the in-jit
#: ``_coded_exchange`` (dist/collectives.py)
CODED_RANGE_HEADROOM = 1.05
CODED_RANGE_FLOOR = 1e-12


def coded_table(rng: float, bits: int):
    """(boundaries [2^bits - 1], values [2^bits]) of the symmetric uniform
    quantile table over ``[-rng, rng]`` — numpy twin of
    ``ops.quantize.build_table(-rng, rng, bits, mode='uniform')``, built
    identically on encoder and decoder from the 4-byte range the frame
    ships (both ends derive, neither trusts the other's arithmetic beyond
    fp32 round-trip of ``rng`` itself)."""
    n = 1 << int(bits)
    edges = np.linspace(np.float32(-rng), np.float32(rng), n + 1,
                        dtype=np.float64).astype(np.float32)
    values = (0.5 * (edges[:-1].astype(np.float64)
                     + edges[1:].astype(np.float64))).astype(np.float32)
    return edges[1:-1], values


def pack_ids(uids: np.ndarray) -> bytes:
    """Tagged id section for a SORTED UNIQUE id stream: delta-varint or
    range-bitmap, whichever is smaller (dense unions pack ~8x tighter as
    bits; sparse ones as deltas)."""
    u = np.ascontiguousarray(uids, np.int64).reshape(-1)
    delta = pack_keys(u)
    if u.size >= 2:
        base = int(u[0])
        span = int(u[-1]) - base + 1
        n_bytes = (span + 7) // 8
        hdr = pack_varint(np.array([u.size, base, span], np.int64))
        if len(hdr) + n_bytes < len(delta):
            bits = np.zeros(span, np.uint8)
            bits[(u - base).astype(np.int64)] = 1
            return bytes([ID_BITMAP]) + hdr + np.packbits(
                bits, bitorder="little"
            ).tobytes()
    return bytes([ID_DELTA]) + delta


def split_ids(buf: bytes) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`pack_ids` -> (sorted int64 uids, bytes consumed)."""
    if not buf:
        raise ValueError("empty id section")
    tag = buf[0]
    if tag == ID_DELTA:
        keys, used = split_keys(buf[1:])
        return keys, 1 + used
    if tag == ID_BITMAP:
        hdr, used = split_varint(buf[1:], 3)
        n, base, span = (int(x) for x in hdr)
        if n < 0 or span <= 0 or n > span:
            raise ValueError(f"corrupt id bitmap header {(n, base, span)}")
        n_bytes = (span + 7) // 8
        body = buf[1 + used:1 + used + n_bytes]
        if len(body) != n_bytes:
            raise ValueError("truncated id bitmap")
        bits = np.unpackbits(
            np.frombuffer(body, np.uint8), count=span, bitorder="little"
        )
        uids = np.flatnonzero(bits).astype(np.int64) + base
        if uids.size != n:
            raise ValueError(
                f"id bitmap popcount {uids.size} != declared n {n}"
            )
        return uids, 1 + used + n_bytes
    raise ValueError(f"unknown id-section tag {tag:#x}")


def _nibble_pack(codes: np.ndarray) -> bytes:
    """4-bit codes -> two per byte, little-nibble order (the EVEN element
    is the LOW nibble) — the host-numpy twin of
    ``ops.quantize.pack_nibbles``, so a kernel-packed stream and a
    host-packed stream are byte-identical.  An odd count pads one zero
    code that :func:`_nibble_unpack` slices back off."""
    c = np.ascontiguousarray(codes, np.uint8).reshape(-1)
    if c.size % 2:
        c = np.concatenate([c, np.zeros(1, np.uint8)])
    pairs = c.reshape(-1, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).astype(np.uint8).tobytes()


def _nibble_unpack(buf: bytes, n: int) -> np.ndarray:
    """Inverse of :func:`_nibble_pack`: ``n`` 4-bit codes (uint8 0..15)."""
    p = np.frombuffer(buf, np.uint8)
    lo = p & np.uint8(0x0F)
    hi = (p >> 4) & np.uint8(0x0F)
    return np.stack([lo, hi], axis=1).reshape(-1)[:n]


def _codes_section_bytes(n_vals: int, bits: int) -> int:
    """Code-stream bytes of a value section: 1 byte per code above 4 bits,
    BIT-PACKED two per byte at <= 4 (``_wire_row_bytes``'s pricing, now a
    wire form the section actually ships)."""
    return (n_vals + 1) // 2 if int(bits) <= 4 else n_vals


def pack_codes_section(vals: np.ndarray, bits: int = 8
                       ) -> Tuple[bytes, np.ndarray]:
    """Quantile-code one [n, dim] fp32 payload -> (section bytes, decoded
    view).  Section: ``u8 bits ++ f32 range ++ codes`` — one byte per code
    for 5..8-bit tables, NIBBLE-PACKED two per byte for <= 4 bits (the
    ``q4_ef`` wire, ISSUE 16: the kernel layer's ``pack_nibbles`` order,
    byte-identical on host and device).  The decoded view is what every
    receiver will reconstruct — the caller's error-feedback carry is
    ``vals - decoded`` (dist/hier.py).  Range is dynamic per payload (max
    |val| with headroom + floor), so the encode never clips and the EF
    carry stays sub-bucket.  A nibble-packed section reaching a reader
    that predates it fails LOUD on the code-stream length check (half the
    bytes it expects), never misparses — tested in test_wire_codec.py."""
    if not (1 <= int(bits) <= 8):
        raise ValueError(f"coded wire sections carry <=8-bit codes, "
                         f"got {bits}")
    v = np.ascontiguousarray(vals, np.float32)
    rng = float(max(CODED_RANGE_HEADROOM * float(np.max(np.abs(v)))
                    if v.size else 0.0, CODED_RANGE_FLOOR))
    rng = float(np.float32(rng))  # the frame ships fp32; derive from it
    boundaries, values = coded_table(rng, bits)
    codes = np.searchsorted(boundaries, v.reshape(-1),
                            side="left").astype(np.uint8)
    stream = (_nibble_pack(codes) if int(bits) <= 4 else codes.tobytes())
    body = bytes([int(bits)]) + np.float32(rng).tobytes() + stream
    return body, values[codes].reshape(v.shape).astype(np.float32)


def unpack_codes_section(buf: bytes, n: int, dim: int
                         ) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`pack_codes_section` -> ([n, dim] fp32 rows, bytes
    consumed).  Dispatches on the section's own ``bits`` byte: <= 4 reads
    the nibble-packed stream, 5..8 the one-byte codes."""
    if len(buf) < 5:
        raise ValueError("truncated coded value section")
    bits = buf[0]
    if not 1 <= bits <= 8:
        raise ValueError(f"coded section claims {bits}-bit codes")
    rng = float(np.frombuffer(buf[1:5], np.float32)[0])
    if not np.isfinite(rng) or rng <= 0:
        raise ValueError(f"coded section range {rng} is not positive finite")
    n_vals = int(n) * int(dim)
    need = _codes_section_bytes(n_vals, bits)
    body = buf[5:5 + need]
    if len(body) != need:
        raise ValueError(
            f"coded section carries {len(body)} code bytes for "
            f"{n_vals} {bits}-bit values (needs {need})"
        )
    _, values = coded_table(rng, bits)
    if bits <= 4:
        codes = _nibble_unpack(body, n_vals)
        if codes.size and int(codes.max()) >= values.size:
            raise ValueError(
                f"coded section carries codes beyond the {bits}-bit table"
            )
    else:
        codes = np.frombuffer(body, np.uint8)
    return values[codes].reshape(int(n), int(dim)).copy(), 5 + need


def pack_rows_coded(uids: np.ndarray, vals: np.ndarray, bits: int = 8
                    ) -> Tuple[bytes, np.ndarray]:
    """ONE tagged coded frame for a sparse (uids, rows) payload -> (frame,
    decoded view): MAGIC, the tagged id section, the quantile-coded value
    section.  ``vals`` must already be EF-compensated when the caller
    carries a residual; the decoded view is the receiver-side
    reconstruction the fresh carry is computed against."""
    u = np.ascontiguousarray(uids, np.int64).reshape(-1)
    v = np.ascontiguousarray(vals, np.float32)
    if v.ndim != 2 or v.shape[0] != u.size:
        raise ValueError(
            f"coded frame needs [n, dim] rows for {u.size} uids, "
            f"got {v.shape}"
        )
    section, dec = pack_codes_section(v, bits)
    return bytes([CODED_MAGIC]) + pack_ids(u) + section, dec


def unpack_rows_coded(buf: bytes, dim: int
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Inverse of :func:`pack_rows_coded` -> (sorted int64 uids, [n, dim]
    fp32 rows, bytes consumed).  Rejects loudly on a missing magic,
    unknown tag, truncated id stream or short code section — a coded
    frame must never half-parse."""
    if not buf or buf[0] != CODED_MAGIC:
        raise ValueError(
            "not a coded rows frame (bad magic byte — fp32/f16 peer?)"
        )
    uids, used = split_ids(buf[1:])
    rows, used2 = unpack_codes_section(buf[1 + used:], uids.size, dim)
    return uids, rows, 1 + used + used2


# -- chunked push framing (the streaming rendezvous, ISSUE 16) ---------------


def pack_chunk_header(chunk_idx: int, n_chunks: int) -> bytes:
    """Chunk header for one window of a chunked rendezvous push:
    ``CHUNK_MAGIC ++ varint [chunk_idx, n_chunks]``.  ``n_chunks`` is the
    host's declared chunk count for the round — every chunk of one
    (host, round) must declare the same total, which is how the shard
    knows when the host's contribution is complete without a separate
    end-of-stream frame (and a lost/retried chunk stays idempotent: the
    shard dedups on ``chunk_idx``)."""
    ci, nc = int(chunk_idx), int(n_chunks)
    if nc < 1 or not 0 <= ci < nc:
        raise ValueError(f"chunk {ci} of {nc} is not a valid window")
    return bytes([CHUNK_MAGIC]) + pack_varint(np.array([ci, nc], np.int64))


def split_chunk_header(buf: bytes) -> Tuple[Tuple[int, int], int]:
    """Decode a :func:`pack_chunk_header` -> ((chunk_idx, n_chunks), bytes
    consumed).  Rejects loudly on a missing magic or an out-of-window
    index — a chunked frame must never half-parse."""
    if not buf or buf[0] != CHUNK_MAGIC:
        raise ValueError(
            "not a chunked push payload (bad chunk magic — old peer?)"
        )
    hdr, used = split_varint(buf[1:], 2)
    ci, nc = int(hdr[0]), int(hdr[1])
    if nc < 1 or not 0 <= ci < nc:
        raise ValueError(f"chunk header claims chunk {ci} of {nc}")
    return (ci, nc), 1 + used


# -- prediction frames (serving plane, lightctr_tpu/serve) -------------------
#
# A predict request carries the CTR sparse-batch layout the models consume
# (``fids``/``vals`` and, for the field-representative family, ``rep_fids``/
# ``rep_mask``).  The id streams ride the zigzag varint codec UNSORTED (row
# order is the payload's meaning, so no delta trick applies) and the float
# payloads ride the same fp16 value codec as PS rows — the reference's
# serving numerics (paramserver.h:161-163 applies fp16 to every PS value,
# trained and served alike).  ``vals`` must arrive pre-masked
# (``vals * mask``): every model's logits path multiplies them anyway, so
# the mask carries no extra information the wire needs to pay for.


def pack_predict_batch(arrays: dict) -> bytes:
    """{"fids" [B, P] int, "vals" [B, P] f32, optional "rep_fids" [B, Fl]
    int + "rep_mask" [B, Fl] f32} -> one self-describing predict frame:
    ``varint([B, P, Fl])`` then the varint fid stream, fp16 vals, and (when
    ``Fl > 0``) the varint rep_fid stream + fp16 rep_mask."""
    fids = np.asarray(arrays["fids"], np.int64)
    vals = np.asarray(arrays["vals"], np.float32)
    if fids.ndim != 2 or vals.shape != fids.shape:
        raise ValueError(
            f"predict frame needs matching [B, P] fids/vals, got "
            f"{fids.shape} / {vals.shape}"
        )
    rep = arrays.get("rep_fids")
    fl = 0 if rep is None else int(np.asarray(rep).shape[1])
    out = pack_varint(np.array([fids.shape[0], fids.shape[1], fl], np.int64))
    out += pack_varint(fids.reshape(-1)) + pack_values(vals)[0]
    if fl:
        rep_arr = np.asarray(rep, np.int64)
        rep_mask = np.asarray(arrays["rep_mask"], np.float32)
        if rep_arr.shape != (fids.shape[0], fl) or \
                rep_mask.shape != rep_arr.shape:
            raise ValueError("rep_fids/rep_mask must be [B, Fl] and match")
        out += pack_varint(rep_arr.reshape(-1)) + pack_values(rep_mask)[0]
    return out


def unpack_predict_batch(buf: bytes) -> Tuple[dict, int]:
    """Inverse of :func:`pack_predict_batch` -> (arrays, bytes consumed).
    The decoded dict is model-ready: ``mask`` is reconstructed as ones
    (``vals`` arrive pre-masked, see above) and ids are int32."""
    hdr, pos = split_varint(buf, 3)
    b, p, fl = (int(x) for x in hdr)
    if b < 0 or p < 0 or fl < 0:
        raise ValueError(f"negative predict frame dims {(b, p, fl)}")
    # bound the claimed dims against the bytes actually present BEFORE
    # allocating decode buffers (a varint is >= 1 byte and an fp16 value
    # is 2): a 20-byte frame claiming b*p = 2^62 must fail loud here, not
    # reach np.empty
    if b * p > len(buf) or b * fl > len(buf):
        raise ValueError(
            f"predict frame dims {(b, p, fl)} exceed the "
            f"{len(buf)}-byte payload"
        )
    fids, used = split_varint(buf[pos:], b * p)
    pos += used
    vals = unpack_values(buf[pos:pos + 2 * b * p], (b, p))
    pos += 2 * b * p
    arrays = {
        "fids": fids.reshape(b, p).astype(np.int32),
        "vals": vals,
        "mask": np.ones((b, p), np.float32),
    }
    if fl:
        rep, used = split_varint(buf[pos:], b * fl)
        pos += used
        arrays["rep_fids"] = rep.reshape(b, fl).astype(np.int32)
        arrays["rep_mask"] = unpack_values(buf[pos:pos + 2 * b * fl], (b, fl))
        pos += 2 * b * fl
    return arrays, pos
