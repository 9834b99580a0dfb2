// flash_attention: exact multi-head attention over [B, T, H, D], forward
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] / sqrt(D))
//                   * v[b, j, h, :]
//
// optionally causal (key j > query i masked), computed tile by tile with an
// online softmax so the [T, T] score matrix never exists.  Scores and the
// running max m and denominator l are float32; p is rounded to the value
// dtype before the p.v product (lightctr_tpu/nn/flash_attention.py:96-98),
// which accumulates in float32; l == 0 divides by 1 (:93); the output has
// q's dtype.
//
// Replaces the TPU kernel lightctr_tpu/nn/flash_attention.py _flash_pallas /
// _flash_kernel: a (b*h, q-block, k-block) grid whose k axis runs in order
// on one core, carrying m, l and the accumulator in VMEM scratch as
// lane-replicated [block_q, 128] tiles, on inputs folded to [B*H, T, D] by
// transposes.  Here blocks run in parallel in no order, so nothing carries
// between them: one CTA owns (b*h, a tile of query rows) and walks the key
// tiles in a loop, m, l and the accumulator in registers.  It reads q, k
// and v with strides straight from [B, T, H, D] (no fold, no transpose
// copy), stages each key/value tile in shared memory, zero-fills columns
// past D and rows past T, and masks keys past T.  The causal variant stops
// at the last key tile that holds a key at or below the tile's last query:
// every row then has key 0 in its first tile, so m is finite after it.
//
//   bf16 / fp16: 4 warps of 16 query rows each, 64-row query and key
//     tiles; q.k^T and p.v on the tensor cores with mma.sync m16n8k16
//     (float32 accumulate).  The score fragment of two 8-key tiles is the
//     A fragment of the next product, so p never leaves registers.  At
//     D = 64 a key/value tile pair is 18 KB of shared memory.
//   fp32: full float32 FMAs, no TF32 (as the JAX interpret-mode reference
//     computes it): 32 query rows, 16-key tiles, 4 threads a row.
//
// D <= 128, padded to 32, 64 or 128 inside the kernel.
//
// Bound: at the bench's bf16 causal shapes, operations.  4*B*H*T^2*D/2
// FLOPs over 989 TFLOP/s against the bytes of q, k, v and o over 3.35 TB/s:
// (2, 4096, 8, 64) is 3.44e10 FLOPs, 0.035 ms, against 33.6 MB, 0.010 ms.
// This first version is simple: synchronous tile loads, no double
// buffering, mma.sync rather than wgmma, no TMA; it stays well above its
// bound (PERF.md).
//
// Plain C interface for ctypes; the entry returns the launch's CUDA error,
// which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// NEG_INF of the JAX kernel: -0.7 * float32 max, finite, so exp2 of a
// masked score minus a finite max is exactly 0
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f;

// -- element conversions ----------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// two floats rounded to T, packed: lo in bits 0-15, hi in bits 16-31 (the
// lower-indexed element of an mma fragment pair sits in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a * b on the tensor cores: A 16x16 (row), B 16x8 (col), D 16x8 f32
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the number of key tiles of width bk a query tile [q0, q0 + bq) visits
__device__ __forceinline__ int key_tiles(int q0, int bq, int bk, int t_len,
                                         int causal) {
  int n = (t_len + bk - 1) / bk;
  if (causal) {
    const int last = min(q0 + bq - 1, t_len - 1);
    n = min(n, last / bk + 1);
  }
  return n;
}

// -- bf16 / fp16: mma.sync ---------------------------------------------------

constexpr int kRows = 64;  // query and key tile of the tensor-core kernel

// rows [t0, t0 + 64) of one (b, h) slice into a [64][kDP + 8] tile of raw
// 16-bit values, zero past D and past T; 16-byte loads when every row
// starts 16-byte aligned (vec)
template <int kDP>
__device__ __forceinline__ void load_tile16(uint16_t* dst,
                                            const uint16_t* __restrict__ src,
                                            long long row_stride, int t0,
                                            int t_len, int d, int vec) {
  constexpr int kLd = kDP + 8;
  if (vec) {
    constexpr int kChunks = kDP / 8;
    for (int c = threadIdx.x; c < kRows * kChunks; c += blockDim.x) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < t_len && col < d)
        val = *reinterpret_cast<const uint4*>(src + (t0 + r) * row_stride +
                                              col);
      *reinterpret_cast<uint4*>(dst + r * kLd + col) = val;
    }
  } else {
    for (int c = threadIdx.x; c < kRows * kDP; c += blockDim.x) {
      const int r = c / kDP, col = c % kDP;
      uint16_t val = 0;
      if (t0 + r < t_len && col < d) val = src[(t0 + r) * row_stride + col];
      dst[r * kLd + col] = val;
    }
  }
}

template <typename T, int kDP>
__global__ void __launch_bounds__(128)
    flash_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
              int t_len, int heads, int d, float scale_log2, int causal,
              int vec) {
  constexpr int kLd = kDP + 8;
  constexpr int kSteps = kDP / 16;  // k-steps of q.k^T
  constexpr int kOut = kDP / 8;     // 8-column tiles of o
  __shared__ __align__(16) uint16_t ks[kRows * kLd];
  __shared__ __align__(16) uint16_t vs[kRows * kLd];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kRows;
  const long long row_stride = (long long)heads * d;
  const long long base = (long long)b * t_len * row_stride + (long long)h * d;

  // this warp's 16 query rows as A fragments, staged through ks
  load_tile16<kDP>(ks, q + base, row_stride, q0, t_len, d, vec);
  __syncthreads();
  uint32_t qa[kSteps][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = s * 16 + tg * 2;
    qa[s][0] = *reinterpret_cast<const uint32_t*>(&ks[r0 * kLd + c]);
    qa[s][1] = *reinterpret_cast<const uint32_t*>(&ks[(r0 + 8) * kLd + c]);
    qa[s][2] = *reinterpret_cast<const uint32_t*>(&ks[r0 * kLd + c + 8]);
    qa[s][3] =
        *reinterpret_cast<const uint32_t*>(&ks[(r0 + 8) * kLd + c + 8]);
  }

  // rows g and g + 8 of the warp's 16: running max, partial denominator
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int row_g = q0 + r0;

  const int n_kt = key_tiles(q0, kRows, kRows, t_len, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();  // every warp is done with the previous tile
    load_tile16<kDP>(ks, k + base, row_stride, k0, t_len, d, vec);
    load_tile16<kDP>(vs, v + base, row_stride, k0, t_len, d, vec);
    __syncthreads();

    // s = q . k^T over 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint16_t* kr = &ks[(n * 8 + g) * kLd + st * 16 + tg * 2];
        mma16816<T>(s[n], qa[st], *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale (in log2 units), mask, row max over the quad
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_g + (e >> 1) * 8;
        const int col = k0 + n * 8 + tg * 2 + (e & 1);
        float x = s[n][e] * scale_log2;
        if (col >= t_len || (causal && col > row)) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // o += p . v: p rounded to T; two 8-key score tiles are one A fragment
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        const uint16_t* vr = &vs[(kk * 16 + tg * 2) * kLd + n * 8 + g];
        const uint32_t b0 = (uint32_t)vr[0] | ((uint32_t)vr[kLd] << 16);
        const uint32_t b1 =
            (uint32_t)vr[8 * kLd] | ((uint32_t)vr[9 * kLd] << 16);
        mma16816<T>(acc[n], pa, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    inv[i] = l == 0.f ? 1.f : 1.f / l;
  }
  T* out = reinterpret_cast<T*>(o) + base;
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_g + (e >> 1) * 8;
      const int col = n * 8 + tg * 2 + (e & 1);
      if (row < t_len && col < d)
        out[row * row_stride + col] = from_f<T>(acc[n][e] * inv[e >> 1]);
    }
  }
}

// -- fp32: full float32 FMAs -------------------------------------------------

constexpr int kRowsF = 32;  // query rows of a CTA
constexpr int kKeysF = 16;  // keys of a tile

template <typename T, int kDP>
__global__ void __launch_bounds__(128)
    flash_fma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int t_len,
              int heads, int d, float scale_log2, int causal) {
  constexpr int kLd = kDP + 1;
  constexpr int kCols = kDP / 4;  // output columns of a thread
  __shared__ float qs[kRowsF * kLd];
  __shared__ float ks[kKeysF * kLd];
  __shared__ float vs[kKeysF * kLd];
  __shared__ float ps[kRowsF * (kKeysF + 1)];

  // 4 threads a row: thread j of row r takes keys j, j+4, .. of a tile and
  // output columns j, j+4, ..
  const int r = threadIdx.x >> 2, j = threadIdx.x & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kRowsF;
  const long long row_stride = (long long)heads * d;
  const long long base = (long long)b * t_len * row_stride + (long long)h * d;

  auto load = [&](float* dst, const T* src, int t0, int rows) {
    for (int c = threadIdx.x; c < rows * kDP; c += blockDim.x) {
      const int rr = c / kDP, col = c % kDP;
      float val = 0.f;
      if (t0 + rr < t_len && col < d)
        val = to_f<T>(src[base + (t0 + rr) * row_stride + col]);
      dst[rr * kLd + col] = val;
    }
  };
  load(qs, q, q0, kRowsF);

  const int row = q0 + r;
  float m_run = kNegInf, l_run = 0.f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  const int n_kt = key_tiles(q0, kRowsF, kKeysF, t_len, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKeysF;
    __syncthreads();
    load(ks, k, k0, kKeysF);
    load(vs, v, k0, kKeysF);
    __syncthreads();

    float s[kKeysF / 4];
    float mx = m_run;
#pragma unroll
    for (int i = 0; i < kKeysF / 4; ++i) {
      const int kl = j + 4 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int c = 0; c < kDP; ++c)
        dot = fmaf(qs[r * kLd + c], ks[kl * kLd + c], dot);
      float x = dot * scale_log2;
      if (k0 + kl >= t_len || (causal && k0 + kl > row)) x = kNegInf;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = quad_max(mx);
    const float alpha = exp2f(m_run - mx);
    m_run = mx;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < kKeysF / 4; ++i) {
      const float p = exp2f(s[i] - m_run);
      l_run += p;
      ps[r * (kKeysF + 1) + j + 4 * i] = to_f<T>(from_f<T>(p));
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int kl = 0; kl < kKeysF; ++kl)
        a = fmaf(ps[r * (kKeysF + 1) + kl], vs[kl * kLd + j + 4 * c], a);
      acc[c] = a;
    }
  }

  const float l = quad_sum(l_run);
  const float inv = l == 0.f ? 1.f : 1.f / l;
  if (row < t_len) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = j + 4 * c;
      if (col < d) o[base + row * row_stride + col] = from_f<T>(acc[c] * inv);
    }
  }
}

// -- launch ------------------------------------------------------------------

template <int kDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int dtype, int bh, int t_len, int heads, int d,
                   float scale_log2, int causal, int vec,
                   cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((t_len + kRowsF - 1) / kRowsF, bh);
    flash_fma<float, kDP><<<grid, 128, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), t_len, heads,
        d, scale_log2, causal);
  } else {
    const dim3 grid((t_len + kRows - 1) / kRows, bh);
    const uint16_t* q16 = static_cast<const uint16_t*>(q);
    const uint16_t* k16 = static_cast<const uint16_t*>(k);
    const uint16_t* v16 = static_cast<const uint16_t*>(v);
    uint16_t* o16 = static_cast<uint16_t*>(o);
    if (dtype == 1)
      flash_mma<__nv_bfloat16, kDP><<<grid, 128, 0, stream>>>(
          q16, k16, v16, o16, t_len, heads, d, scale_log2, causal, vec);
    else
      flash_mma<__half, kDP><<<grid, 128, 0, stream>>>(
          q16, k16, v16, o16, t_len, heads, d, scale_log2, causal, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  q, k, v and o are contiguous
// [B, T, H, D] of that dtype; D <= 128; B * H <= 65535.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype,
                                   long long batch, long long t_len,
                                   long long heads, long long d, int causal,
                                   void* stream_ptr) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return (int)cudaSuccess;
  if (d < 1 || d > 128 || dtype < 0 || dtype > 2 || batch * heads > 65535 ||
      t_len > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float scale_log2 = (1.0f / sqrtf((float)d)) * kLog2e;
  const int vec = (d % 8 == 0) &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0);
  const int bh = (int)(batch * heads);
  cudaError_t err;
  if (d <= 32)
    err = launch<32>(q, k, v, o, dtype, bh, (int)t_len, (int)heads, (int)d,
                     scale_log2, causal, vec, stream);
  else if (d <= 64)
    err = launch<64>(q, k, v, o, dtype, bh, (int)t_len, (int)heads, (int)d,
                     scale_log2, causal, vec, stream);
  else
    err = launch<128>(q, k, v, o, dtype, bh, (int)t_len, (int)heads, (int)d,
                      scale_log2, causal, vec, stream);
  return (int)err;
}
