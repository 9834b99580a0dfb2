// Fast libFFM parser — native data-loader component.
//
// Role parity: FM_Algo_Abst::loadDataRow (fm_algo_abst.h:70-107) is the
// reference's C++ CSV/libFFM ingest; the TPU framework keeps ingest native
// too (Python parsing dominates end-to-end time on CTR-scale files).
// Two-pass design: scan for dimensions, then fill caller-allocated arrays —
// the padded static-shape layout lightctr_tpu.data.sparse.SparseDataset uses.
//
// C ABI, consumed via ctypes (no pybind11 in the image).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>

namespace {

// Bare-decimal fast paths.  strtol/strtod are the semantics of record
// (locale-aware, sign/exponent/ws handling) but cost ~100ns/call through
// the libc indirection — and the libFFM token stream is overwhelmingly
// plain digit runs ("field:fid:1").  These parse ONLY [0-9]+ prefixes and
// report failure for everything else (signs, '.', exponents, overflow
// guard), so the fallback keeps the accepted language and results
// bit-identical.
inline bool fast_ulong(const char*& p, long& out) {
    const char* q = p;
    long v = 0;
    int digits = 0;
    while (*q >= '0' && *q <= '9') {
        if (++digits > 18) return false;  // near LONG_MAX: strtol's job
        v = v * 10 + (*q - '0');          // guard BEFORE accumulate: no
        ++q;                              // signed overflow at 18 digits
    }
    if (digits == 0) return false;
    out = v;
    p = q;
    return true;
}

inline bool fast_uval(const char*& p, double& val) {
    const char* q = p;
    long v;
    if (!fast_ulong(q, v)) return false;
    if (v >= (1L << 53)) return false;  // double-exactness bound; p is
                                        // untouched so strtod re-parses
    // only a PURE integer token (delimiter follows) converts exactly;
    // '.', 'e', or anything else defers to strtod
    if (*q == ' ' || *q == '\n' || *q == '\t' || *q == '\r' || *q == '\0') {
        val = (double)v;
        p = q;
        return true;
    }
    return false;
}

// Parse "field:fid:val" starting at p; advances p past the token.
// Returns true on success.
inline bool parse_token(const char*& p, long& field, long& fid, double& val) {
    char* end = nullptr;
    if (!fast_ulong(p, field)) {
        field = strtol(p, &end, 10);
        if (end == p) return false;
        p = end;
    }
    if (*p != ':') return false;
    ++p;
    if (!fast_ulong(p, fid)) {
        fid = strtol(p, &end, 10);
        if (end == p) return false;
        p = end;
    }
    if (*p != ':') return false;
    ++p;
    if (!fast_uval(p, val)) {
        val = strtod(p, &end);
        if (end == p) return false;
        p = end;
    }
    return true;
}

inline void skip_ws(const char*& p) {
    while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
}

}  // namespace

extern "C" {

// Pass 1: dimensions. Returns 0 ok, -1 io error, -2 parse error (line no in
// *err_line).
int ffm_scan(const char* path, long* n_rows, long* max_nnz, long* max_fid,
             long* max_field, long* err_line) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char* line = nullptr;
    size_t cap = 0;
    long rows = 0, mnnz = 0, mfid = -1, mfield = -1, lineno = 0;
    ssize_t len;
    while ((len = getline(&line, &cap, f)) != -1) {
        ++lineno;
        const char* p = line;
        skip_ws(p);
        if (*p == '\n' || *p == '\0') continue;
        char* end = nullptr;
        strtod(p, &end);  // label
        if (end == p) { free(line); fclose(f); *err_line = lineno; return -2; }
        p = end;
        long nnz = 0;
        while (true) {
            skip_ws(p);
            if (*p == '\n' || *p == '\0') break;
            long field, fid; double val;
            if (!parse_token(p, field, fid, val)) {
                free(line); fclose(f); *err_line = lineno; return -2;
            }
            ++nnz;
            if (fid > mfid) mfid = fid;
            if (field > mfield) mfield = field;
        }
        if (nnz > mnnz) mnnz = nnz;
        ++rows;
    }
    free(line);
    fclose(f);
    *n_rows = rows;
    *max_nnz = mnnz;
    *max_fid = mfid;
    *max_field = mfield;
    return 0;
}

// Pass 2: fill caller-allocated [n_rows, max_nnz] arrays (zero-padded) and
// [n_rows] labels. mask gets 1.0 on real entries.
int ffm_parse(const char* path, long n_rows, long max_nnz, int* fields,
              int* fids, float* vals, float* mask, float* labels) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char* line = nullptr;
    size_t cap = 0;
    long r = 0;
    ssize_t len;
    memset(fields, 0, sizeof(int) * n_rows * max_nnz);
    memset(fids, 0, sizeof(int) * n_rows * max_nnz);
    memset(vals, 0, sizeof(float) * n_rows * max_nnz);
    memset(mask, 0, sizeof(float) * n_rows * max_nnz);
    while ((len = getline(&line, &cap, f)) != -1 && r < n_rows) {
        const char* p = line;
        skip_ws(p);
        if (*p == '\n' || *p == '\0') continue;
        char* end = nullptr;
        labels[r] = (float)strtod(p, &end);
        p = end;
        long j = 0;
        while (j < max_nnz) {
            skip_ws(p);
            if (*p == '\n' || *p == '\0') break;
            long field, fid; double val;
            if (!parse_token(p, field, fid, val)) { free(line); fclose(f); return -2; }
            const long o = r * max_nnz + j;
            fields[o] = (int)field;
            fids[o] = (int)fid;
            vals[o] = (float)val;
            mask[o] = 1.0f;
            ++j;
        }
        ++r;
    }
    free(line);
    fclose(f);
    return 0;
}

// Streaming chunk parse: up to max_rows rows starting at byte *offset.
// Rows longer than max_nnz are TRUNCATED (streaming semantics — the Python
// generator does the same), still validating the dropped tokens.  Fills
// caller-allocated [max_rows, max_nnz] arrays (zero-padded) and labels;
// advances *offset past the last consumed line.  fold_fid/fold_field > 0
// reduce ids modulo the fold (the hashing trick) ON THE LONG VALUE —
// matching the Python generator, which folds exact ints before any int32
// narrowing.  stride/phase implement the per-worker row shard AT THE SCAN:
// data row i (within this chunk) is tokenized only when i % stride ==
// phase; other rows are line-skipped but still COUNTED (their array rows
// stay zero) — each row is validated by exactly its owning worker, so a
// 4-worker fleet tokenizes the file once total instead of 4x.  stride=1
// parses everything (the single-process behavior).  end > 0 is a byte
// BOUND: no line starting at or past it is read.  The caller must place
// it on a newline boundary (one past a '\n'); the follow tailer uses it
// to stop short of a writer's partial trailing line, which getline would
// otherwise happily hand over as a (torn) final row at EOF.  Returns rows
// scanned >= 0, -1 on io error, -2 on parse error, -3 when an id exceeds
// int32 range and no fold was given (*err_line = line index within this
// chunk, 1-based).
long ffm_parse_chunk(const char* path, long* offset, long end, long max_rows,
                     long max_nnz, long fold_fid, long fold_field,
                     long stride, long phase,
                     int* fields, int* fids, float* vals,
                     float* mask, float* labels, long* err_line) {
    if (stride < 1) stride = 1;
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    if (fseek(f, *offset, SEEK_SET) != 0) { fclose(f); return -1; }
    char* line = nullptr;
    size_t cap = 0;
    long r = 0, lineno = 0;
    ssize_t len;
    memset(fields, 0, sizeof(int) * max_rows * max_nnz);
    memset(fids, 0, sizeof(int) * max_rows * max_nnz);
    memset(vals, 0, sizeof(float) * max_rows * max_nnz);
    memset(mask, 0, sizeof(float) * max_rows * max_nnz);
    memset(labels, 0, sizeof(float) * max_rows);
    while (r < max_rows && (end <= 0 || ftell(f) < end)
           && (len = getline(&line, &cap, f)) != -1) {
        ++lineno;
        const char* p = line;
        skip_ws(p);
        if (*p == '\n' || *p == '\0') { *offset = ftell(f); continue; }
        if (stride > 1 && (r % stride) != phase) {
            // another worker's row: getline already consumed the bytes;
            // count it and move on (its array row stays zeroed)
            ++r;
            *offset = ftell(f);
            continue;
        }
        char* end = nullptr;
        double label = strtod(p, &end);
        if (end == p) {
            free(line); fclose(f); *err_line = lineno; return -2;
        }
        labels[r] = (float)label;
        p = end;
        long j = 0;
        while (true) {
            skip_ws(p);
            if (*p == '\n' || *p == '\0') break;
            long field, fid; double val;
            if (!parse_token(p, field, fid, val)) {
                free(line); fclose(f); *err_line = lineno; return -2;
            }
            // Python-% semantics (result takes the divisor's sign) so both
            // paths agree on negative ids too
            if (fold_fid > 0) { fid %= fold_fid; if (fid < 0) fid += fold_fid; }
            if (fold_field > 0) { field %= fold_field; if (field < 0) field += fold_field; }
            if (fid > 2147483647L || field > 2147483647L ||
                fid < 0 || field < 0) {
                free(line); fclose(f); *err_line = lineno; return -3;
            }
            if (j < max_nnz) {
                const long o = r * max_nnz + j;
                fields[o] = (int)field;
                fids[o] = (int)fid;
                vals[o] = (float)val;
                mask[o] = 1.0f;
            }
            ++j;
        }
        ++r;
        *offset = ftell(f);
    }
    free(line);
    fclose(f);
    return r;
}

}  // extern "C"
