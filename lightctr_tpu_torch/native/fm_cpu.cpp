// Native full-batch FM trainer — the CPU-fallback compute path.
//
// Role: when no accelerator answers, bench/CLI training falls back to the
// host, where XLA's single-core CPU backend loses to the reference's
// hand-written AVX loops (LightCTR trains FM via its SIMD kernels +
// thread pool).  This kernel is the framework's native equivalent: the same
// batched-sumVX formulation as models/fm.py (train_fm_algo.cpp:63-117
// semantics re-derived, NOT translated).  The templated-K path runs a
// FID-MAJOR three-phase schedule (see train_k) so each table row is touched
// O(1) times per epoch; the runtime-K fallback keeps the simpler slot-major
// row streaming.  Numerics are kept bit-compatible in
// STRUCTURE with the JAX path (same loss, same per-occurrence L2, same
// eps-inside-sqrt Adagrad) so the two trajectories agree to float rounding —
// parity-tested in tests/test_fm_native.py.
//
// Exposed C ABI (ctypes, see bindings.py):
//   fm_train_fullbatch: runs `epochs` full-batch Adagrad steps in place on
//   (w, v) given CSR (row_ptr, fids, vals); writes the per-epoch mean loss
//   (logistic + l2 term, matching CTRTrainer's loss_fn) into `losses`.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__SSE__)
#include <pmmintrin.h>
#include <xmmintrin.h>
#endif

namespace {

// 64-byte-aligned scratch: numpy hands us arbitrarily-offset tables, so
// [K] rows can straddle cache lines; the hot arrays are copied into
// aligned storage for the duration of a call.
struct AlignedBuf {
    float* p;
    explicit AlignedBuf(size_t n)
        : p(static_cast<float*>(aligned_alloc(64, ((n * 4 + 63) / 64) * 64))) {}
    ~AlignedBuf() { free(p); }
    AlignedBuf(const AlignedBuf&) = delete;
    AlignedBuf& operator=(const AlignedBuf&) = delete;
};

// Flush-to-zero for the duration of a training call (restored on return):
// converged FM logits drive exp(-|z|) into denormals, which microcode at
// ~100x the cost on x86; XLA's CPU backend runs with FTZ on, so this also
// keeps the two paths' numerics aligned.
struct ScopedFtz {
#if defined(__SSE__)
    unsigned int saved;
    ScopedFtz() : saved(_mm_getcsr()) {
        _MM_SET_FLUSH_ZERO_MODE(_MM_FLUSH_ZERO_ON);
        _MM_SET_DENORMALS_ZERO_MODE(_MM_DENORMALS_ZERO_ON);
    }
    ~ScopedFtz() { _mm_setcsr(saved); }
#endif
};

// K as a compile-time constant so the j-loops vectorize at full width.
//
// The j-loops carry `#pragma GCC unroll 1`: without it, gcc completely
// peels any loop of <= 16 iterations (max-completely-peel-times) BEFORE
// the loop vectorizer runs, and SLP fails to re-roll the peeled
// read-modify-write sequences — K<=16 came out as 16 scalar vfmadd213ss
// per row while K=32 got single-ZMM vmovups/vfmadd132ps.  That inversion
// was the round-3 "k=16 anomaly" (k=16 absolutely slower than k=32);
// keeping the loops rolled hands them to the vectorizer and k=16 runs
// 2.3x faster (6.3 -> 2.7 ms/epoch on the bench shape, phases 1 and 3
// both vectorized).
//
// FID-MAJOR schedule: the batch is constant across a full-batch run, so the
// slots are re-bucketed BY FEATURE once (counting sort) and each epoch
// touches every table row exactly three times (norm, bucket pass, fused
// grad+Adagrad pass) instead of once per occurrence — the per-ROW partials
// (s[B][K], linear, selfsq, dz) stay L2-resident.  Per-fid gradients close
// over the row sums analytically:
//     gv[f] = sum_t (dz_r x_t) s[row_t] - (sum_t dz_r x_t^2) v[f]
//             + occ_f * (lambda/B) * v[f]
//     gw[f] = sum_t dz_r x_t + occ_f * (lambda/B) * w[f]
// and since a fid's gradient depends on no other fid's update, the Adagrad
// step fuses into the same pass (grads still evaluated at the pre-update
// parameters — identical trajectory to the slot-major form, modulo float
// summation order).  Measured: k=64 went memory-bound 35.5 ms/epoch ->
// compute-bound single-digit ms.
template <int K>
int train_k(
    const int64_t* row_ptr, const int32_t* fids, const float* vals,
    const float* labels, int64_t B, int64_t F,
    int64_t epochs, float lr, float lambda_l2, float eps,
    float* __restrict__ w, float* __restrict__ v, float* losses
) {
    const int64_t M = row_ptr[B];
    // counting-sort slots by fid (once — the batch is constant)
    std::vector<int64_t> fid_start(F + 1, 0);
    std::vector<int32_t> slot_row(M);
    std::vector<float> slot_x(M);
    {
        std::vector<int64_t> cnt(F, 0);
        for (int64_t t = 0; t < M; ++t) cnt[fids[t]]++;
        for (int64_t f = 0; f < F; ++f) fid_start[f + 1] = fid_start[f] + cnt[f];
        std::vector<int64_t> cur(fid_start.begin(), fid_start.end() - 1);
        for (int64_t i = 0; i < B; ++i)
            for (int64_t t = row_ptr[i]; t < row_ptr[i + 1]; ++t) {
                const int64_t pos = cur[fids[t]]++;
                slot_row[pos] = (int32_t)i;
                slot_x[pos] = vals[t];
            }
    }
    std::vector<float> aw(F, 0.0f);
    std::vector<float> linear(B), selfsq(B), dz(B);
    // aligned working copies of the row-strided hot arrays (see AlignedBuf)
    AlignedBuf va((size_t)F * K), av((size_t)F * K), s((size_t)B * K);
    if (!va.p || !av.p || !s.p) return -3;  // alloc failure: clean rc, not
                                            // a segfault in memcpy below
    std::memcpy(va.p, v, sizeof(float) * (size_t)F * K);
    std::memset(av.p, 0, sizeof(float) * (size_t)F * K);
    const float invB = 1.0f / (float)B;
    const float reg = lambda_l2 * invB;

    for (int64_t e = 0; e < epochs; ++e) {
        std::memset(s.p, 0, sizeof(float) * (size_t)B * K);
        std::memset(linear.data(), 0, sizeof(float) * B);
        std::memset(selfsq.data(), 0, sizeof(float) * B);
        double l2_total = 0.0;

        // phase 1 (fid-major): row sums; each v row read once
        for (int64_t f = 0; f < F; ++f) {
            const int64_t lo = fid_start[f], hi = fid_start[f + 1];
            if (lo == hi) continue;
            const float* __restrict__ vf = va.p + (size_t)f * K;
            const float wf = w[f];
            float norm2 = 0.0f;
            #pragma GCC unroll 1
            for (int j = 0; j < K; ++j) norm2 += vf[j] * vf[j];
            l2_total += (double)(hi - lo) * 0.5 * (wf * wf + norm2);
            for (int64_t t = lo; t < hi; ++t) {
                const float x = slot_x[t];
                float* __restrict__ sr = s.p + (size_t)slot_row[t] * K;
                #pragma GCC unroll 1
                for (int j = 0; j < K; ++j) sr[j] += x * vf[j];
                linear[slot_row[t]] += wf * x;
                selfsq[slot_row[t]] += x * x * norm2;
            }
        }

        // phase 2 (row-major): logits, loss, dz
        double loss = lambda_l2 * l2_total;
        for (int64_t i = 0; i < B; ++i) {
            const float* __restrict__ sr = s.p + (size_t)i * K;
            float inter = 0.0f;
            #pragma GCC unroll 1
            for (int j = 0; j < K; ++j) inter += sr[j] * sr[j];
            const float z = linear[i] + 0.5f * (inter - selfsq[i]);
            const float y = labels[i];
            const float zpos = z > 0.0f ? z : 0.0f;
            loss += (double)(zpos - y * z + log1pf(expf(z - 2.0f * zpos)));
            const float p = 1.0f / (1.0f + expf(-z));
            dz[i] = (p - y) * invB;
        }
        losses[e] = (float)(loss * invB);

        // phase 3 (fid-major): per-fid gradient closed over the row sums,
        // Adagrad fused (eps inside the sqrt, gradientUpdater.h:146);
        // untouched fids are exact no-ops as in the slot-major form
        for (int64_t f = 0; f < F; ++f) {
            const int64_t lo = fid_start[f], hi = fid_start[f + 1];
            if (lo == hi) continue;
            float* __restrict__ vf = va.p + (size_t)f * K;
            float* __restrict__ avf = av.p + (size_t)f * K;
            float a[K];
            #pragma GCC unroll 1
            for (int j = 0; j < K; ++j) a[j] = 0.0f;
            float gw = 0.0f, bsum = 0.0f;
            for (int64_t t = lo; t < hi; ++t) {
                const float x = slot_x[t];
                const float dzr = dz[slot_row[t]];
                const float dzx = dzr * x;
                const float* __restrict__ sr =
                    s.p + (size_t)slot_row[t] * K;
                #pragma GCC unroll 1
                for (int j = 0; j < K; ++j) a[j] += dzx * sr[j];
                gw += dzx;
                bsum += dzr * x * x;
            }
            const float occ_reg = (float)(hi - lo) * reg;
            gw += occ_reg * w[f];
            if (gw != 0.0f) {
                aw[f] += gw * gw;
                w[f] -= lr * gw / std::sqrt(aw[f] + eps);
            }
            const float vscale = occ_reg - bsum;
            // branchless on purpose: gj == 0 makes both updates exact
            // no-ops anyway (avf += 0, step = lr*0/sqrt(avf+eps) = 0), and
            // a branch in the j-loop would block vectorization
            #pragma GCC unroll 1
            for (int j = 0; j < K; ++j) {
                const float gj = a[j] + vscale * vf[j];
                avf[j] += gj * gj;
                vf[j] -= lr * gj / std::sqrt(avf[j] + eps);
            }
        }
    }
    std::memcpy(v, va.p, sizeof(float) * (size_t)F * K);  // publish back
    return 0;
}

// Runtime-K fallback: SLOT-MAJOR row streaming (NOT the templated path's
// fid-major schedule — fixes do not port 1:1 between the two; both are
// parity-tested against the JAX trajectory, train_generic via the K=3 case).
// Also the safe route for B beyond int32 (the fid-major buckets use i32 rows).
int train_generic(
    const int64_t* row_ptr, const int32_t* fids, const float* vals,
    const float* labels, int64_t B, int64_t F, int64_t K,
    int64_t epochs, float lr, float lambda_l2, float eps,
    float* w, float* v, float* losses
) {
    std::vector<float> gw(F), gv((size_t)F * K);
    std::vector<float> aw(F, 0.0f), av((size_t)F * K, 0.0f);
    std::vector<float> s(K);
    const float invB = 1.0f / (float)B;

    for (int64_t e = 0; e < epochs; ++e) {
        std::memset(gw.data(), 0, sizeof(float) * F);
        std::memset(gv.data(), 0, sizeof(float) * (size_t)F * K);
        double loss = 0.0;
        for (int64_t i = 0; i < B; ++i) {
            const int64_t lo = row_ptr[i], hi = row_ptr[i + 1];
            for (int64_t j = 0; j < K; ++j) s[j] = 0.0f;
            float linear = 0.0f, self_sq = 0.0f, l2 = 0.0f;
            for (int64_t t = lo; t < hi; ++t) {
                const float x = vals[t];
                const float* vf = v + (size_t)fids[t] * K;
                const float wf = w[fids[t]];
                linear += wf * x;
                float vv = 0.0f;
                for (int64_t j = 0; j < K; ++j) {
                    const float vx = vf[j] * x;
                    s[j] += vx;
                    self_sq += vx * vx;
                    vv += vf[j] * vf[j];
                }
                l2 += 0.5f * (wf * wf + vv);
            }
            float inter = 0.0f;
            for (int64_t j = 0; j < K; ++j) inter += s[j] * s[j];
            const float z = linear + 0.5f * (inter - self_sq);
            const float y = labels[i];
            const float zpos = z > 0.0f ? z : 0.0f;
            loss += (double)(zpos - y * z + log1pf(expf(z - 2.0f * zpos)));
            loss += (double)(lambda_l2 * l2);
            const float p = 1.0f / (1.0f + expf(-z));
            const float dz = (p - y) * invB;
            const float reg = lambda_l2 * invB;
            for (int64_t t = lo; t < hi; ++t) {
                const float x = vals[t];
                const int32_t f = fids[t];
                float* gvf = gv.data() + (size_t)f * K;
                const float* vf = v + (size_t)f * K;
                gw[f] += dz * x + reg * w[f];
                const float dzx = dz * x;
                const float dzx2 = dz * x * x;
                for (int64_t j = 0; j < K; ++j)
                    gvf[j] += dzx * s[j] - dzx2 * vf[j] + reg * vf[j];
            }
        }
        losses[e] = (float)(loss * invB);
        for (int64_t f = 0; f < F; ++f) {
            const float g = gw[f];
            if (g != 0.0f) {
                aw[f] += g * g;
                w[f] -= lr * g / std::sqrt(aw[f] + eps);
            }
            float* vf = v + (size_t)f * K;
            float* avf = av.data() + (size_t)f * K;
            const float* gvf = gv.data() + (size_t)f * K;
            for (int64_t j = 0; j < K; ++j) {
                const float gj = gvf[j];
                if (gj != 0.0f) {
                    avf[j] += gj * gj;
                    vf[j] -= lr * gj / std::sqrt(avf[j] + eps);
                }
            }
        }
    }
    return 0;
}

}  // namespace

extern "C" {

int fm_train_fullbatch(
    const int64_t* row_ptr,   // [B+1] CSR row offsets into fids/vals
    const int32_t* fids,      // [M]
    const float* vals,        // [M]
    const float* labels,      // [B] in {0, 1}
    int64_t B, int64_t F, int64_t K,
    int64_t epochs, float lr, float lambda_l2, float eps,
    float* w,                 // [F]     updated in place
    float* v,                 // [F*K]   updated in place
    float* losses             // [epochs] per-epoch mean loss
) {
    if (B <= 0 || F <= 0 || K <= 0 || epochs <= 0) return -1;
    ScopedFtz ftz;
    if (B > 2147483647LL)  // fid-major buckets store row ids as int32
        return train_generic(row_ptr, fids, vals, labels, B, F, K, epochs, lr, lambda_l2, eps, w, v, losses);
    switch (K) {
        case 2:  return train_k<2>(row_ptr, fids, vals, labels, B, F, epochs, lr, lambda_l2, eps, w, v, losses);
        case 4:  return train_k<4>(row_ptr, fids, vals, labels, B, F, epochs, lr, lambda_l2, eps, w, v, losses);
        case 8:  return train_k<8>(row_ptr, fids, vals, labels, B, F, epochs, lr, lambda_l2, eps, w, v, losses);
        case 16: return train_k<16>(row_ptr, fids, vals, labels, B, F, epochs, lr, lambda_l2, eps, w, v, losses);
        case 32: return train_k<32>(row_ptr, fids, vals, labels, B, F, epochs, lr, lambda_l2, eps, w, v, losses);
        case 64: return train_k<64>(row_ptr, fids, vals, labels, B, F, epochs, lr, lambda_l2, eps, w, v, losses);
        default: return train_generic(row_ptr, fids, vals, labels, B, F, K, epochs, lr, lambda_l2, eps, w, v, losses);
    }
}

}  // extern "C"
