// Variable-width integer wire codec for sparse key streams.
//
// Role parity with the reference's VarUint Buffer packing
// (LightCTR/common/buffer.h:112-128): a PS pull/push request is a stream of
// feature ids whose magnitudes are small after delta-coding, so 7-bit
// continuation bytes shrink the request severalfold vs fixed 8-byte keys.
// Design is NOT a translation: zigzag mapping first (so signed deltas from
// the Python layer's sorted-key differencing pack tight), then LEB128-style
// little-endian 7-bit groups with the high bit as "more follows".

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ps_rows.cpp's wide fp16 converter (AVX-512/F16C/software ladder) —
// same shared object, so the fused shard decoder below can stream
// half-precision values through the hardware paths.
void f16_to_f32(const uint16_t* src, float* dst, int64_t n);

// Worst case 10 bytes per 64-bit value.  Returns bytes written, or -1 when
// `cap` is too small (caller sizes with varint_max_bytes).
long varint_pack(const long long* vals, long n, unsigned char* out, long cap) {
    long pos = 0;
    for (long i = 0; i < n; ++i) {
        uint64_t u = ((uint64_t)vals[i] << 1) ^ (uint64_t)(vals[i] >> 63);
        do {
            if (pos >= cap) return -1;
            unsigned char byte = u & 0x7f;
            u >>= 7;
            out[pos++] = byte | (u ? 0x80 : 0);
        } while (u);
    }
    return pos;
}

// Decodes exactly `n` values.  Returns bytes consumed, -1 on truncated
// stream, -2 on a value overflowing 64 bits (corrupt input).
long varint_unpack(const unsigned char* buf, long nbytes, long long* out, long n) {
    long pos = 0;
    for (long i = 0; i < n; ++i) {
        uint64_t u = 0;
        int shift = 0;
        for (;;) {
            if (pos >= nbytes) return -1;
            if (shift > 63) return -2;
            unsigned char byte = buf[pos++];
            u |= (uint64_t)(byte & 0x7f) << shift;
            if (!(byte & 0x80)) break;
            shift += 7;
        }
        out[i] = (long long)((u >> 1) ^ (~(u & 1) + 1));
    }
    return pos;
}

namespace {

// Bounded zigzag-varint read used by the shard decoder's inner loops.
inline bool read_varint(const unsigned char* buf, long nbytes, long& pos,
                        int64_t& out) {
    uint64_t u = 0;
    int shift = 0;
    for (;;) {
        if (pos >= nbytes || shift > 63) return false;
        unsigned char byte = buf[pos++];
        u |= (uint64_t)(byte & 0x7f) << shift;
        if (!(byte & 0x80)) break;
        shift += 7;
    }
    out = (int64_t)((u >> 1) ^ (~(u & 1) + 1));
    return true;
}

}  // namespace

// One-pass decode of a shard-block payload (lightctr_tpu/data/ingest.py
// format: nnz varints | zigzag-delta fids | zigzag-delta fields |
// f32 labels | fp16-or-f32 vals) into caller-zeroed padded
// [rows, width] arrays — the replay hot loop.  The numpy path needs
// three 1M-element fancy scatters plus two int64 cumsums per block;
// here the delta accumulate and the scatter are the same sequential
// walk.  vals_f16 mirrors the block's flag bit.  Returns total tokens
// >= 0, -1 truncated/corrupt varint stream, -2 nnz out of [0, width],
// -3 payload length mismatch, -4 a decoded id outside int32.
long shard_decode_block(const unsigned char* payload, long nbytes,
                        long rows, long width, int vals_f16,
                        int* fids, int* fields, float* vals,
                        float* mask, float* labels) {
    long pos = 0;
    int64_t* nnz = (int64_t*)malloc(sizeof(int64_t) * (rows ? rows : 1));
    if (!nnz) return -1;
    long total = 0;
    for (long r = 0; r < rows; ++r) {
        if (!read_varint(payload, nbytes, pos, nnz[r])) {
            free(nnz);
            return -1;
        }
        if (nnz[r] < 0 || nnz[r] > width) {
            free(nnz);
            return -2;
        }
        total += nnz[r];
    }
    int64_t acc = 0;
    for (long r = 0; r < rows; ++r) {
        int* row = fids + r * width;
        for (int64_t j = 0; j < nnz[r]; ++j) {
            int64_t d;
            if (!read_varint(payload, nbytes, pos, d)) {
                free(nnz);
                return -1;
            }
            acc += d;
            if (acc < -2147483648LL || acc > 2147483647LL) {
                free(nnz);
                return -4;
            }
            row[j] = (int)acc;
        }
    }
    acc = 0;
    for (long r = 0; r < rows; ++r) {
        int* row = fields + r * width;
        for (int64_t j = 0; j < nnz[r]; ++j) {
            int64_t d;
            if (!read_varint(payload, nbytes, pos, d)) {
                free(nnz);
                return -1;
            }
            acc += d;
            if (acc < -2147483648LL || acc > 2147483647LL) {
                free(nnz);
                return -4;
            }
            row[j] = (int)acc;
        }
    }
    const long need = rows * 4 + total * (vals_f16 ? 2 : 4);
    if (nbytes - pos != need) {
        free(nnz);
        return -3;
    }
    memcpy(labels, payload + pos, sizeof(float) * rows);
    pos += rows * 4;
    if (vals_f16) {
        // wide-convert the packed stream once, then row-wise memcpy into
        // the padded grid (the convert dominates; copies are linear)
        float* flat = (float*)malloc(sizeof(float) * (total ? total : 1));
        if (!flat) {
            free(nnz);
            return -1;
        }
        // payload slices are not 2-byte aligned in general: copy through
        // an aligned staging buffer before the vector converter
        uint16_t* halves =
            (uint16_t*)malloc(sizeof(uint16_t) * (total ? total : 1));
        if (!halves) {
            free(flat);
            free(nnz);
            return -1;
        }
        memcpy(halves, payload + pos, sizeof(uint16_t) * total);
        f16_to_f32(halves, flat, total);
        free(halves);
        const float* src = flat;
        for (long r = 0; r < rows; ++r) {
            memcpy(vals + r * width, src, sizeof(float) * nnz[r]);
            src += nnz[r];
        }
        free(flat);
    } else {
        const unsigned char* src = payload + pos;
        for (long r = 0; r < rows; ++r) {
            memcpy(vals + r * width, src, sizeof(float) * nnz[r]);
            src += sizeof(float) * nnz[r];
        }
    }
    for (long r = 0; r < rows; ++r) {
        float* row = mask + r * width;
        for (int64_t j = 0; j < nnz[r]; ++j) row[j] = 1.0f;
    }
    free(nnz);
    return total;
}

}  // extern "C"
