// Native full-batch FFM trainer — host-fallback counterpart of fm_cpu.cpp.
//
// Same field-bucketed reformulation as models/ffm.py (NOT the reference's
// per-pair scalar loop, train_ffm_algo.cpp:62-70):
//
//   G[f, g, :] = sum_{i: field_i = f} x_i * V[fid_i, g, :]
//   z = w.x + 0.5 * ( sum_{f,g} <G[f,g,:], G[g,f,:]>
//                     - sum_i x_i^2 |V[fid_i, field_i, :]|^2 )
//
// O(nnz * Fl * K + Fl^2 * K) per row instead of O(nnz^2 * K), with
// K-contiguous inner loops (templated K) the compiler vectorizes.  Gradients
// analytically (d(half cross)/dG[f,g,:] = G[g,f,:]):
//   dV[fid_i, g, :] += dz * x_i * G[g, field_i, :]            (all g)
//   dV[fid_i, field_i, :] -= dz * x_i^2 * V[fid_i, field_i, :]
// plus the per-occurrence L2 term lambda/B * V[fid_i, :, :] over the whole
// [Fl, K] block (ffm.logits_with_l2 sums the FULL gathered block) — matching
// the JAX trajectory of CTRTrainer(ffm.logits_with_l2) to float rounding
// (tests/test_ffm_native.py).  FTZ as in fm_cpu.cpp.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__SSE__)
#include <pmmintrin.h>
#include <xmmintrin.h>
#endif

namespace {

struct ScopedFtzF {
#if defined(__SSE__)
    unsigned int saved;
    ScopedFtzF() : saved(_mm_getcsr()) {
        _MM_SET_FLUSH_ZERO_MODE(_MM_FLUSH_ZERO_ON);
        _MM_SET_DENORMALS_ZERO_MODE(_MM_DENORMALS_ZERO_ON);
    }
    ~ScopedFtzF() { _mm_setcsr(saved); }
#endif
};

template <int K>
int ffm_train_k(
    const int64_t* row_ptr, const int32_t* fids, const int32_t* fields,
    const float* vals, const float* labels,
    int64_t B, int64_t F, int64_t FL,
    int64_t epochs, float lr, float lambda_l2, float eps,
    float* __restrict__ w, float* __restrict__ v, float* losses
) {
    const size_t blk = (size_t)FL * K;     // one fid's [Fl, K] block
    std::vector<float> gw(F), gv((size_t)F * blk);
    std::vector<float> aw(F, 0.0f), av((size_t)F * blk, 0.0f);
    std::vector<float> G((size_t)FL * FL * K);  // per-row buckets [f, g, K]
    std::vector<float> norm2(F);                // per-fid |V block|^2
    const float invB = 1.0f / (float)B;

    for (int64_t e = 0; e < epochs; ++e) {
        std::memset(gw.data(), 0, sizeof(float) * F);
        std::memset(gv.data(), 0, sizeof(float) * gv.size());
        for (int64_t f = 0; f < F; ++f) {  // V constant within the epoch
            const float* vf = v + (size_t)f * blk;
            float acc = 0.0f;
            for (size_t t = 0; t < blk; ++t) acc += vf[t] * vf[t];
            norm2[f] = acc;
        }
        double loss = 0.0;

        for (int64_t i = 0; i < B; ++i) {
            const int64_t lo = row_ptr[i], hi = row_ptr[i + 1];
            std::memset(G.data(), 0, sizeof(float) * G.size());
            float linear = 0.0f, diag = 0.0f, l2 = 0.0f;
            // pass A: buckets + linear + diag + l2
            for (int64_t t = lo; t < hi; ++t) {
                const float x = vals[t];
                const int32_t fd = fids[t];
                const int32_t fl = fields[t];
                const float* __restrict__ vf = v + (size_t)fd * blk;
                linear += w[fd] * x;
                l2 += 0.5f * (w[fd] * w[fd] + norm2[fd]);
                // G[fl, :, :] += x * vf[:, :]   (one contiguous SAXPY)
                float* __restrict__ Gf = G.data() + (size_t)fl * blk;
                for (size_t u = 0; u < blk; ++u) Gf[u] += x * vf[u];
                // self pair: x^2 |V[fd, fl, :]|^2
                const float* vs = vf + (size_t)fl * K;
                float ss = 0.0f;
                for (int j = 0; j < K; ++j) ss += vs[j] * vs[j];
                diag += x * x * ss;
            }
            float cross = 0.0f;
            for (int64_t f = 0; f < FL; ++f)
                for (int64_t g = 0; g < FL; ++g) {
                    const float* a = G.data() + ((size_t)f * FL + g) * K;
                    const float* b = G.data() + ((size_t)g * FL + f) * K;
                    float d = 0.0f;
                    for (int j = 0; j < K; ++j) d += a[j] * b[j];
                    cross += d;
                }
            const float z = linear + 0.5f * (cross - diag);

            const float y = labels[i];
            const float zpos = z > 0.0f ? z : 0.0f;
            loss += (double)(zpos - y * z + log1pf(expf(z - 2.0f * zpos)));
            loss += (double)(lambda_l2 * l2);
            const float p = 1.0f / (1.0f + expf(-z));
            const float dz = (p - y) * invB;
            const float reg = lambda_l2 * invB;

            // pass B: per-slot gradients
            for (int64_t t = lo; t < hi; ++t) {
                const float x = vals[t];
                const int32_t fd = fids[t];
                const int32_t fl = fields[t];
                const float* __restrict__ vf = v + (size_t)fd * blk;
                float* __restrict__ gvf = gv.data() + (size_t)fd * blk;
                gw[fd] += dz * x + reg * w[fd];
                const float dzx = dz * x;
                // dV[fd, g, :] += dz*x*G[g, fl, :] + reg*V[fd, g, :]
                for (int64_t g = 0; g < FL; ++g) {
                    const float* __restrict__ Gc =
                        G.data() + ((size_t)g * FL + fl) * K;
                    float* __restrict__ dst = gvf + (size_t)g * K;
                    const float* __restrict__ src = vf + (size_t)g * K;
                    for (int j = 0; j < K; ++j)
                        dst[j] += dzx * Gc[j] + reg * src[j];
                }
                // self-pair correction on the own-field slice
                const float dzx2 = dz * x * x;
                float* __restrict__ dsts = gvf + (size_t)fl * K;
                const float* __restrict__ srcs = vf + (size_t)fl * K;
                for (int j = 0; j < K; ++j) dsts[j] -= dzx2 * srcs[j];
            }
        }
        losses[e] = (float)(loss * invB);

        // Adagrad, eps inside the sqrt; zero-grad entries are exact no-ops
        for (int64_t f = 0; f < F; ++f) {
            const float g = gw[f];
            if (g != 0.0f) {
                aw[f] += g * g;
                w[f] -= lr * g / std::sqrt(aw[f] + eps);
            }
            float* __restrict__ vf = v + (size_t)f * blk;
            float* __restrict__ avf = av.data() + (size_t)f * blk;
            const float* __restrict__ gvf = gv.data() + (size_t)f * blk;
            for (size_t u = 0; u < blk; ++u) {
                const float gu = gvf[u];
                if (gu != 0.0f) {
                    avf[u] += gu * gu;
                    vf[u] -= lr * gu / std::sqrt(avf[u] + eps);
                }
            }
        }
    }
    return 0;
}

int ffm_train_generic(
    const int64_t* row_ptr, const int32_t* fids, const int32_t* fields,
    const float* vals, const float* labels,
    int64_t B, int64_t F, int64_t FL, int64_t K,
    int64_t epochs, float lr, float lambda_l2, float eps,
    float* w, float* v, float* losses
) {
    // runtime-K fallback: same algorithm with K as a loop bound
    const size_t blk = (size_t)FL * K;
    std::vector<float> gw(F), gv((size_t)F * blk);
    std::vector<float> aw(F, 0.0f), av((size_t)F * blk, 0.0f);
    std::vector<float> G((size_t)FL * FL * K);
    std::vector<float> norm2(F);
    const float invB = 1.0f / (float)B;
    for (int64_t e = 0; e < epochs; ++e) {
        std::memset(gw.data(), 0, sizeof(float) * F);
        std::memset(gv.data(), 0, sizeof(float) * gv.size());
        for (int64_t f = 0; f < F; ++f) {
            const float* vf = v + (size_t)f * blk;
            float acc = 0.0f;
            for (size_t t = 0; t < blk; ++t) acc += vf[t] * vf[t];
            norm2[f] = acc;
        }
        double loss = 0.0;
        for (int64_t i = 0; i < B; ++i) {
            const int64_t lo = row_ptr[i], hi = row_ptr[i + 1];
            std::memset(G.data(), 0, sizeof(float) * G.size());
            float linear = 0.0f, diag = 0.0f, l2 = 0.0f;
            for (int64_t t = lo; t < hi; ++t) {
                const float x = vals[t];
                const int32_t fd = fids[t];
                const int32_t fl = fields[t];
                const float* vf = v + (size_t)fd * blk;
                linear += w[fd] * x;
                l2 += 0.5f * (w[fd] * w[fd] + norm2[fd]);
                float* Gf = G.data() + (size_t)fl * blk;
                for (size_t u = 0; u < blk; ++u) Gf[u] += x * vf[u];
                const float* vs = vf + (size_t)fl * K;
                float ss = 0.0f;
                for (int64_t j = 0; j < K; ++j) ss += vs[j] * vs[j];
                diag += x * x * ss;
            }
            float cross = 0.0f;
            for (int64_t f = 0; f < FL; ++f)
                for (int64_t g = 0; g < FL; ++g) {
                    const float* a = G.data() + ((size_t)f * FL + g) * K;
                    const float* b = G.data() + ((size_t)g * FL + f) * K;
                    float d = 0.0f;
                    for (int64_t j = 0; j < K; ++j) d += a[j] * b[j];
                    cross += d;
                }
            const float z = linear + 0.5f * (cross - diag);
            const float y = labels[i];
            const float zpos = z > 0.0f ? z : 0.0f;
            loss += (double)(zpos - y * z + log1pf(expf(z - 2.0f * zpos)));
            loss += (double)(lambda_l2 * l2);
            const float p = 1.0f / (1.0f + expf(-z));
            const float dz = (p - y) * invB;
            const float reg = lambda_l2 * invB;
            for (int64_t t = lo; t < hi; ++t) {
                const float x = vals[t];
                const int32_t fd = fids[t];
                const int32_t fl = fields[t];
                const float* vf = v + (size_t)fd * blk;
                float* gvf = gv.data() + (size_t)fd * blk;
                gw[fd] += dz * x + reg * w[fd];
                const float dzx = dz * x;
                for (int64_t g = 0; g < FL; ++g) {
                    const float* Gc = G.data() + ((size_t)g * FL + fl) * K;
                    float* dst = gvf + (size_t)g * K;
                    const float* src = vf + (size_t)g * K;
                    for (int64_t j = 0; j < K; ++j)
                        dst[j] += dzx * Gc[j] + reg * src[j];
                }
                const float dzx2 = dz * x * x;
                float* dsts = gvf + (size_t)fl * K;
                const float* srcs = vf + (size_t)fl * K;
                for (int64_t j = 0; j < K; ++j) dsts[j] -= dzx2 * srcs[j];
            }
        }
        losses[e] = (float)(loss * invB);
        for (int64_t f = 0; f < F; ++f) {
            const float g = gw[f];
            if (g != 0.0f) {
                aw[f] += g * g;
                w[f] -= lr * g / std::sqrt(aw[f] + eps);
            }
            float* vf = v + (size_t)f * blk;
            float* avf = av.data() + (size_t)f * blk;
            const float* gvf = gv.data() + (size_t)f * blk;
            for (size_t u = 0; u < blk; ++u) {
                const float gu = gvf[u];
                if (gu != 0.0f) {
                    avf[u] += gu * gu;
                    vf[u] -= lr * gu / std::sqrt(avf[u] + eps);
                }
            }
        }
    }
    return 0;
}

}  // namespace

extern "C" {

int ffm_train_fullbatch(
    const int64_t* row_ptr,   // [B+1] CSR row offsets
    const int32_t* fids,      // [M]
    const int32_t* fields,    // [M]
    const float* vals,        // [M]
    const float* labels,      // [B]
    int64_t B, int64_t F, int64_t FL, int64_t K,
    int64_t epochs, float lr, float lambda_l2, float eps,
    float* w,                 // [F]
    float* v,                 // [F*FL*K]
    float* losses             // [epochs]
) {
    if (B <= 0 || F <= 0 || FL <= 0 || K <= 0 || epochs <= 0) return -1;
    ScopedFtzF ftz;
    switch (K) {
        case 2:  return ffm_train_k<2>(row_ptr, fids, fields, vals, labels, B, F, FL, epochs, lr, lambda_l2, eps, w, v, losses);
        case 4:  return ffm_train_k<4>(row_ptr, fids, fields, vals, labels, B, F, FL, epochs, lr, lambda_l2, eps, w, v, losses);
        case 8:  return ffm_train_k<8>(row_ptr, fids, fields, vals, labels, B, F, FL, epochs, lr, lambda_l2, eps, w, v, losses);
        case 16: return ffm_train_k<16>(row_ptr, fids, fields, vals, labels, B, F, FL, epochs, lr, lambda_l2, eps, w, v, losses);
        default: return ffm_train_generic(row_ptr, fids, fields, vals, labels, B, F, FL, K, epochs, lr, lambda_l2, eps, w, v, losses);
    }
}

}  // extern "C"
