// Row-indexed fused updater kernels for the in-process PS store
// (embed/async_ps.py).  The numpy _apply path walks the batch in five
// full passes (gather acc, square-add, scatter acc, rsqrt-scale, scatter
// W) — ~5x the memory traffic of the math.  One pass here, no atomics:
// the store serializes writers under its own lock (unlike shm_kv.cpp's
// cross-process CAS kernels, this store is single-process by design).
// Reference role: gradientUpdater.h:138-150 applied server-side per push
// (paramserver.h:252-300).
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif

namespace {

// Scalar half converters for the vector loops' tails (and the whole
// array on pre-AVX builds).  ``_Float16`` needs GCC >= 12 on x86, so the
// ladder is: the native type when the compiler has it, the F16C scalar
// intrinsics when the ISA does, else a software round-to-nearest-even
// conversion — bit-identical to the hardware ones (tested against
// numpy's astype(float16)).
#if defined(__FLT16_MANT_DIG__)
inline uint16_t f32_to_f16_scalar(float f) {
    _Float16 h = (_Float16)f;
    uint16_t u;
    memcpy(&u, &h, 2);
    return u;
}
inline float f16_to_f32_scalar(uint16_t u) {
    _Float16 h;
    memcpy(&h, &u, 2);
    return (float)h;
}
#elif defined(__F16C__)
inline uint16_t f32_to_f16_scalar(float f) {
    return (uint16_t)_cvtss_sh(f, _MM_FROUND_TO_NEAREST_INT);
}
inline float f16_to_f32_scalar(uint16_t u) { return _cvtsh_ss(u); }
#else
inline uint16_t f32_to_f16_scalar(float f) {
    uint32_t x;
    memcpy(&x, &f, 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    x &= 0x7FFFFFFFu;
    if (x >= 0x47800000u) {              // overflow -> inf; inf/nan pass
        if (x > 0x7F800000u) return (uint16_t)(sign | 0x7E00u);  // nan
        return (uint16_t)(sign | 0x7C00u);
    }
    if (x < 0x38800000u) {               // subnormal half (or zero)
        if (x < 0x33000000u) return (uint16_t)sign;  // underflows to 0
        const int shift = 113 - (int)(x >> 23);
        const uint32_t mant = (x & 0x7FFFFFu) | 0x800000u;
        uint16_t h = (uint16_t)(sign | (mant >> (shift + 13)));
        const uint32_t rem = mant & ((1u << (shift + 13)) - 1u);
        const uint32_t half = 1u << (shift + 12);
        if (rem > half || (rem == half && (h & 1u))) ++h;
        return h;
    }
    uint16_t h = (uint16_t)(sign | ((x - 0x38000000u) >> 13));
    const uint32_t rem = x & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (h & 1u))) ++h;
    return h;
}
inline float f16_to_f32_scalar(uint16_t h) {
    const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t x;
    if (exp == 0) {
        if (mant == 0) {
            x = sign;                    // +-0
        } else {                         // subnormal: renormalize
            int e = 0;
            while (!(mant & 0x400u)) {
                mant <<= 1;
                ++e;
            }
            x = sign | ((uint32_t)(113 - e) << 23) | ((mant & 0x3FFu) << 13);
        }
    } else if (exp == 31) {              // inf/nan
        x = sign | 0x7F800000u | (mant << 13);
    } else {
        x = sign | ((exp + 112u) << 23) | (mant << 13);
    }
    float f;
    memcpy(&f, &x, 4);
    return f;
}
#endif

}  // namespace

extern "C" {

// W[slots[i]] and acc[slots[i]] are rows of length dim; g is [n, dim]
// dense in batch order.  slots MUST be unique: this loop applies every
// occurrence of a repeated slot sequentially, while the store's numpy
// fallback (fancy-index assignment) is last-write-wins — the two
// branches would silently diverge.  The store asserts unique keys
// server-side in push_batch (async_ps.py), before any state mutation,
// so a contract-violating push fails loud before reaching either branch.
void rows_adagrad(float* W, float* acc, const int64_t* slots,
                  const float* g, int64_t n, int64_t dim,
                  float lr, float eps) {
    for (int64_t i = 0; i < n; ++i) {
        float* w_row = W + slots[i] * dim;
        float* a_row = acc + slots[i] * dim;
        const float* g_row = g + i * dim;
#pragma GCC unroll 4
        for (int64_t d = 0; d < dim; ++d) {
            const float gv = g_row[d];
            const float a = a_row[d] + gv * gv;
            a_row[d] = a;
            w_row[d] -= lr * gv / sqrtf(a + eps);
        }
    }
}

// fp16 wire codec (paramserver.h:161-163 ships every PS value as fp16).
// numpy's astype(float16) runs ~0.3 GB/s here and gcc auto-vectorizes the
// plain cast loop into SCALAR vcvtsh2ss — so the wide converters are
// spelled out: 16 lanes per VCVTPH2PS/VCVTPS2PH on AVX-512, 8 on F16C.
void f32_to_f16(const float* src, uint16_t* dst, int64_t n) {
    int64_t i = 0;
#if defined(__AVX512F__)
    for (; i + 16 <= n; i += 16)
        _mm256_storeu_si256(
            reinterpret_cast<__m256i*>(dst + i),
            _mm512_cvtps_ph(_mm512_loadu_ps(src + i),
                            _MM_FROUND_TO_NEAREST_INT));
#elif defined(__F16C__)
    for (; i + 8 <= n; i += 8)
        _mm_storeu_si128(
            reinterpret_cast<__m128i*>(dst + i),
            _mm256_cvtps_ph(_mm256_loadu_ps(src + i),
                            _MM_FROUND_TO_NEAREST_INT));
#endif
    for (; i < n; ++i) dst[i] = f32_to_f16_scalar(src[i]);
}

void f16_to_f32(const uint16_t* src, float* dst, int64_t n) {
    int64_t i = 0;
#if defined(__AVX512F__)
    for (; i + 16 <= n; i += 16)
        _mm512_storeu_ps(
            dst + i,
            _mm512_cvtph_ps(_mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(src + i))));
#elif defined(__F16C__)
    for (; i + 8 <= n; i += 8)
        _mm256_storeu_ps(
            dst + i,
            _mm256_cvtph_ps(_mm_loadu_si128(
                reinterpret_cast<const __m128i*>(src + i))));
#endif
    for (; i < n; ++i) dst[i] = f16_to_f32_scalar(src[i]);
}

}  // extern "C"
