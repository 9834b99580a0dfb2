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
// q's dtype.  The division by l is deferred to the end of the key loop,
// which moves results by float32 ulps.
//
// Replaces the TPU kernel lightctr_tpu/nn/flash_attention.py _flash_pallas /
// _flash_kernel: a (b*h, q-block, k-block) grid whose k axis runs in order
// on one core, carrying m, l and the accumulator in VMEM scratch as
// lane-replicated [block_q, 128] tiles, on inputs folded to [B*H, T, D] by
// transposes.  Here blocks run in parallel in no order, so nothing carries
// between them: one CTA owns (b*h, a tile of query rows) and walks the key
// tiles in a loop, m, l and the accumulator in registers.  Every kernel
// reads q, k and v with strides straight from [B, T, H, D] (no fold, no
// transpose copy).  Work items (b*h, query tile) are numbered on gridDim.x
// and walked in a grid-stride loop, so B*H is limited only by the int range
// of its tensors, not by gridDim.y.
//
// Three kernels; the Python wrapper picks one by a single shape/dtype rule
// (nn/flash_attention.py flash_route) and passes it in `variant`:
//
//   2  wgmma (bf16 / fp16, D % 8 == 0, D <= 256, 16-byte aligned bases):
//      the Hopper design.  One CTA = one producer warpgroup and two
//      consumer warpgroups of 64 query rows each (a 128-row query tile).
//      The producer's one thread loads the query tile once with TMA and
//      keeps key/value tiles in flight in a ring of kStages stages, each
//      with a full and an empty mbarrier for K and for V; it gives its
//      registers to the consumers (setmaxnreg 24 / 240).  A consumer
//      computes S = q.k^T with wgmma.mma_async from shared memory (both
//      K-major), runs the online softmax on the float32 accumulator in
//      registers (the max on the unscaled scores, p as one FMA and one
//      ex2.approx: at D = 64 an SM's 16 exponentials a clock take as long
//      as its tensor cores' 256 FLOPs a score), rounds p to the value dtype
//      in the layout of wgmma's A register fragment, and computes O += p.v
//      with wgmma's RS form, V read MN-major from the tile TMA stored
//      (transpose-B).  A consumer issues tile kt's q.k^T together with
//      tile kt-1's p.v, then runs tile kt's softmax while that p.v still
//      computes; the two consumers take turns to issue (FA3's ping-pong,
//      on a pair of mbarriers), so one's products run under the other's
//      exponentials.  While a wgmma is in flight no branch depends on the
//      thread (the mbarrier spin is inside the asm, every consumer thread
//      arrives), else ptxas serializes the wgmma.  Tensor maps cover the
//      4-D [B, T, H, D] tensors, head dim innermost, in boxes of 64 columns
//      x 64 rows with the 128-byte swizzle; TMA zero-fills rows past T and
//      columns past D.
//      Tiles (D padded to kNC * 64):
//        D <= 64  : 128-key tiles; Q 16 KB, a K+V stage 32 KB, 2 stages: 80 KB
//        D <= 128 : 128-key tiles; Q 32 KB, a stage 64 KB: 160 KB
//        D <= 192 : 64-key tiles;  Q 48 KB, a stage 48 KB: 144 KB
//        D <= 256 : 64-key tiles;  Q 64 KB, a stage 64 KB: 192 KB
//      Causal: key tiles wholly below the 128-row tile's diagonal run
//      unmasked, only a tile that crosses it (or T) is masked, the loop
//      stops at the diagonal (a 64-key tile wholly above one consumer's
//      rows is masked whole and adds exactly 0), and the query tiles with
//      the most key tiles are numbered first, so the last wave holds the
//      lightest tiles.  Every row has key 0 in its first tile, so m is
//      finite after it.
//   1  mma.sync (bf16 / fp16 that the wgmma kernel cannot take, D <= 128):
//      4 warps of 16 query rows each, 64-row query and key tiles,
//      synchronous tile loads through shared memory; q.k^T and p.v with
//      mma.sync m16n8k16 (float32 accumulate), the score fragment of two
//      8-key tiles is the A fragment of the next product.  D padded to 32,
//      64 or 128 inside the kernel.
//   0  fma (float32, and 16-bit shapes the other two cannot take): full
//      float32 FMAs, no TF32 (as the JAX interpret-mode reference computes
//      it): 32 query rows, 16-key tiles, 4 threads a row, p rounded to the
//      value dtype.  D <= 128 in one pass; a wider head is split into
//      128-column output slices over work items: each recomputes the
//      scores over the full D (q and k streamed through shared memory 128
//      columns at a time) and accumulates only its slice of v's columns.
//
// Bound: at the bench's bf16 causal shapes, operations.  4*B*H*T^2*D/2
// FLOPs over 989 TFLOP/s against the bytes of q, k, v and o over 3.35 TB/s:
// (2, 4096, 8, 64) is 3.44e10 FLOPs, 0.035 ms, against 33.6 MB, 0.010 ms.
//
// Plain C interface for ctypes; the entry returns the launch's CUDA error
// (or the driver's tensor-map error), which the Python wrapper turns into
// an exception.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstdint>

#include "wgmma_sm90.cuh"

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

// 2^x on the special-function unit (ex2.approx, relative error about
// 2^-22; results below 2^-126 flush to 0, which no 16-bit p can hold as a
// weight that moves a float32 sum)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// the (b*h, query tile) of a work item: tiles numbered last first, so a
// causal grid issues its heaviest tiles in the first wave
struct WorkItem {
  int bh, q0;
};
__device__ __forceinline__ WorkItem work_item(long long w, int bh_count,
                                              int n_qt, int bq) {
  WorkItem it;
  it.bh = (int)(w % bh_count);
  it.q0 = (n_qt - 1 - (int)(w / bh_count)) * bq;
  return it;
}

// ============================================================================
// variant 2: wgmma + TMA + a K/V ring, warp-specialised
// ============================================================================

constexpr int kWgThreads = 128;
constexpr int kBox = 64;               // rows and columns of a TMA box
constexpr int kBoxBytes = kBox * 128;  // 64 rows x 128 bytes

template <int kNC>
struct WgmmaCfg {
  static constexpr int kBK = kNC <= 2 ? 128 : 64;  // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kQBytes = 2 * kNC * kBoxBytes;  // two 64-row halves
  static constexpr int kTileBytes = kBK * 128 * kNC;   // one K or V tile
  // Q, the K ring, the V ring, then the barriers: q_full, q_empty, and a
  // full/empty pair for each K and V stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmemBytes = kBarOffset + (4 + 4 * kStages) * 8 + 1024;
};

template <typename T, int kNC>
__global__ void __launch_bounds__(3 * kWgThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, T* __restrict__ o,
                int t_len, int heads, int d, int bh_count, long long n_work,
                float scale_log2, int causal) {
  typedef WgmmaCfg<kNC> Cfg;
  constexpr int kBK = Cfg::kBK;
  constexpr int kStages = Cfg::kStages;
  constexpr int kS = kBK / 2;  // score registers a thread
  constexpr int kO = kNC * 32;  // output registers a thread (D padded)
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment for the 128-byte swizzle's atoms
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + Cfg::kQBytes;
  const uint32_t v_s = k_s + kStages * Cfg::kTileBytes;
  const uint32_t bars = base + Cfg::kBarOffset;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 16 + 8 * s; };
  auto k_empty = [&](int s) { return bars + 16 + 8 * (kStages + s); };
  auto v_full = [&](int s) { return bars + 16 + 8 * (2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 16 + 8 * (3 * kStages + s); };
  // the consumers' turns to issue their products, alternating
  auto turn = [&](int c) { return bars + 16 + 8 * (4 * kStages + c); };

  // every consumer thread arrives on the empty and turn barriers (no
  // branch on the thread while a wgmma is in flight)
  constexpr int kArrivals = 2 * kWgThreads;
  if (threadIdx.x == 0) {
    lct::mbar_init(q_full, 1);
    lct::mbar_init(q_empty, kArrivals);
    for (int s = 0; s < kStages; ++s) {
      lct::mbar_init(k_full(s), 1);
      lct::mbar_init(k_empty(s), kArrivals);
      lct::mbar_init(v_full(s), 1);
      lct::mbar_init(v_empty(s), kArrivals);
    }
    lct::mbar_init(turn(0), kWgThreads);
    lct::mbar_init(turn(1), kWgThreads);
    lct::mbar_fence_init();
  }
  __syncthreads();

  const int n_qt = (t_len + 127) / 128;
  const int wg = threadIdx.x / kWgThreads;

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
        const WorkItem it = work_item(w, bh_count, n_qt, 128);
        const int b = it.bh / heads, h = it.bh % heads;
        lct::mbar_wait(q_empty, q_phase ^ 1);
        lct::mbar_expect_tx(q_full, Cfg::kQBytes);
        for (int half = 0; half < 2; ++half)
          for (int c = 0; c < kNC; ++c)
            lct::tma_load_4d(q_s + (half * kNC + c) * kBoxBytes, &q_map,
                             q_full, c * kBox, h, it.q0 + half * kBox, b);
        q_phase ^= 1;
        const int n_kt = key_tiles(it.q0, 128, kBK, t_len, causal);
        for (int kt = 0; kt < n_kt; ++kt) {
          const int k0 = kt * kBK;
          lct::mbar_wait(k_empty(stage), phase ^ 1);
          lct::mbar_expect_tx(k_full(stage), Cfg::kTileBytes);
          for (int c = 0; c < kNC; ++c)
            for (int r = 0; r < kBK / kBox; ++r)
              lct::tma_load_4d(k_s + stage * Cfg::kTileBytes +
                                   c * kBK * 128 + r * kBoxBytes,
                               &k_map, k_full(stage), c * kBox, h,
                               k0 + r * kBox, b);
          lct::mbar_wait(v_empty(stage), phase ^ 1);
          lct::mbar_expect_tx(v_full(stage), Cfg::kTileBytes);
          for (int c = 0; c < kNC; ++c)
            for (int r = 0; r < kBK / kBox; ++r)
              lct::tma_load_4d(v_s + stage * Cfg::kTileBytes +
                                   c * kBK * 128 + r * kBoxBytes,
                               &v_map, v_full(stage), c * kBox, h,
                               k0 + r * kBox, b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    //
    // Tile kt's q.k^T and tile kt-1's p.v are issued together, in this
    // consumer's turn; the other consumer issues its pair while this one
    // runs the softmax of tile kt (FA3's ping-pong), so the tensor cores
    // and the exponentials overlap.  Control flow depends on the work item
    // only, never on the thread, while a wgmma is in flight.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    int stage = 0;
    uint32_t phase = 0, q_phase = 0, turn_phase = 0;
    auto advance = [&]() {
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    // consumer 0 takes the first turn
    if (cw == 1) lct::mbar_arrive(turn(0));
    for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
      const WorkItem it = work_item(w, bh_count, n_qt, 128);
      const int b = it.bh / heads, h = it.bh % heads;
      const int row0 = it.q0 + cw * kBox;  // first row of this WG
      const int r_lo = row0 + warp * 16 + g;
      const int rows[2] = {r_lo, r_lo + 8};
      float m_run[2] = {kNegInf, kNegInf};
      float l_run[2] = {0.f, 0.f};
      float acc[kO];
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] = 0.f;
      const uint32_t q_half = q_s + cw * kNC * kBoxBytes;

      float s[kS];
      // S = q . k^T of the tile in `stage`, issued
      auto issue_s = [&]() {
        const uint32_t k_tile = k_s + stage * Cfg::kTileBytes;
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da =
                lct::smem_desc(q_half + c * kBoxBytes + kk * 32, 16, 1024);
            const uint64_t db = lct::smem_desc(
                k_tile + c * kBK * 128 + kk * 32, 16, 1024);
            lct::wgmma_ss<T, kBK>(s, da, db, (c | kk) != 0);
          }
        }
        lct::wgmma_commit();
      };
      // O += p . v of the tile in stage vs, issued
      auto issue_pv = [&](int vs, const uint32_t (&p)[kBK / 16][4]) {
        const uint32_t v_tile = v_s + vs * Cfg::kTileBytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t db =
              lct::smem_desc(v_tile + kk * 16 * 128, kBK * 128, 1024);
          lct::wgmma_rs<T, kNC * 64>(acc, p[kk], db, 1);
        }
        lct::wgmma_commit();
      };
      // my turn to issue; then the other consumer's
      auto take_turn = [&]() {
        lct::mbar_wait(turn(cw), turn_phase);
        turn_phase ^= 1;
      };
      auto pass_turn = [&]() { lct::mbar_arrive(turn(cw ^ 1)); };
      // online softmax of key tile kt: mask, new running max and
      // denominator, p = 2^(s * scale_log2 - m * scale_log2) as one FMA
      // and one ex2 (the max on the unscaled scores: the scale is
      // positive), p rounded to T in wgmma's A fragment (keys [16kk,
      // 16kk + 16)); alpha rescales the accumulator.  The mask test is the
      // CTA's (both consumers take the same branch): a tile that crosses
      // the diagonal of the 128-row query tile or T.
      auto softmax = [&](int kt, uint32_t (&p)[kBK / 16][4],
                         float (&alpha)[2]) {
        const int k0 = kt * kBK;
        const bool masked =
            k0 + kBK > t_len || (causal && k0 + kBK - 1 > it.q0);
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          if (masked) {
            const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
            if (col >= t_len || (causal && col > rows[(i >> 1) & 1]))
              s[i] = kNegInf;
          }
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
        float neg_ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          alpha[r] = fast_exp2((m_run[r] - mx[r]) * scale_log2);
          m_run[r] = mx[r];
          neg_ms[r] = -mx[r] * scale_log2;
          l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const float e =
              fast_exp2(fmaf(s[i], scale_log2, neg_ms[(i >> 1) & 1]));
          s[i] = e;
          l_run[(i >> 1) & 1] += e;
        }
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          p[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
          p[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };

      lct::mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      // both consumers walk every key tile of the CTA: a causal tile
      // wholly above a consumer's rows is masked whole and adds exactly 0
      const int n_kt = key_tiles(it.q0, 128, kBK, t_len, causal);

      uint32_t pa[kBK / 16][4], pn[kBK / 16][4];
      float alpha[2];
      lct::mbar_wait(k_full(stage), phase);
      take_turn();
      lct::wgmma_fence();
      issue_s();
      pass_turn();
      lct::wgmma_wait<0>();
      lct::fence_regs(s);
      lct::mbar_arrive(k_empty(stage));
      softmax(0, pa, alpha);
      int v_stage = stage;
      uint32_t v_phase = phase;
      advance();
      for (int kt = 1; kt < n_kt; ++kt) {
        lct::mbar_wait(k_full(stage), phase);
        take_turn();
        // the accumulator of tiles < kt-1 to tile kt-1's max, before
        // tile kt-1's p.v adds to it
#pragma unroll
        for (int i = 0; i < kO; ++i) acc[i] *= alpha[(i >> 1) & 1];
        lct::wgmma_fence();
        issue_s();
        lct::mbar_wait(v_full(v_stage), v_phase);
        issue_pv(v_stage, pa);
        pass_turn();
        lct::wgmma_wait<1>();  // q.k^T done; p.v may still run
        lct::fence_regs(s);
        lct::mbar_arrive(k_empty(stage));
        softmax(kt, pn, alpha);
        lct::wgmma_wait<0>();
        lct::fence_regs(acc);
        lct::fence_regs(pa);
        lct::mbar_arrive(v_empty(v_stage));
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
        v_stage = stage;
        v_phase = phase;
        advance();
      }
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] *= alpha[(i >> 1) & 1];
      lct::mbar_wait(v_full(v_stage), v_phase);
      lct::wgmma_fence();
      issue_pv(v_stage, pa);
      lct::wgmma_wait<0>();
      lct::fence_regs(acc);
      lct::fence_regs(pa);
      lct::mbar_arrive(v_empty(v_stage));
      lct::mbar_arrive(q_empty);

      // epilogue: o = acc / l in T, rows < T and columns < D (D % 8 == 0,
      // so a column pair is whole and 4-byte aligned)
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(l_run[r]);
        inv[r] = l == 0.f ? 1.f : 1.f / l;
      }
      const long long row_stride = (long long)heads * d;
      T* out = o + (long long)b * t_len * row_stride + (long long)h * d;
#pragma unroll
      for (int i = 0; i < kO; i += 2) {
        const int r = (i >> 1) & 1;
        const int row = rows[r];
        const int col = 8 * (i >> 2) + 2 * tq;
        if (row < t_len && col < d)
          *reinterpret_cast<uint32_t*>(out + row * row_stride + col) =
              pack2<T>(acc[i] * inv[r], acc[i + 1] * inv[r]);
      }
    }
  }
}

// ============================================================================
// variant 1: mma.sync
// ============================================================================

constexpr int kRows = 64;  // query and key tile of the mma.sync kernel

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
              int t_len, int heads, int d, int bh_count, long long n_work,
              float scale_log2, int causal, int vec) {
  constexpr int kLd = kDP + 8;
  constexpr int kSteps = kDP / 16;  // k-steps of q.k^T
  constexpr int kOut = kDP / 8;     // 8-column tiles of o
  __shared__ __align__(16) uint16_t ks[kRows * kLd];
  __shared__ __align__(16) uint16_t vs[kRows * kLd];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n_qt = (t_len + kRows - 1) / kRows;
  const long long row_stride = (long long)heads * d;
  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const WorkItem it = work_item(w, bh_count, n_qt, kRows);
    const int b = it.bh / heads, h = it.bh % heads;
    const int q0 = it.q0;
    const long long base =
        (long long)b * t_len * row_stride + (long long)h * d;

    // this warp's 16 query rows as A fragments, staged through ks
    __syncthreads();  // the previous item is done with ks
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
}

// ============================================================================
// variant 0: full float32 FMAs
// ============================================================================

constexpr int kRowsF = 32;  // query rows of a work item
constexpr int kKeysF = 16;  // keys of a tile
constexpr int kSliceF = 128;  // output columns of a work item when D > 128

// kDP: D padded (<= 128), or the slice width when D > 128 (n_ch > 1)
template <typename T, int kDP>
__global__ void __launch_bounds__(128)
    flash_fma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int t_len,
              int heads, int d, int bh_count, long long n_work,
              float scale_log2, int causal) {
  constexpr int kLd = kDP + 1;
  constexpr int kCols = kDP / 4;  // output columns of a thread
  __shared__ float qs[kRowsF * kLd];
  __shared__ float ks[kKeysF * kLd];
  __shared__ float vs[kKeysF * kLd];
  __shared__ float ps[kRowsF * (kKeysF + 1)];

  // 4 threads a row: thread j of row r takes keys j, j+4, .. of a tile and
  // output columns j, j+4, ..
  const int r = threadIdx.x >> 2, j = threadIdx.x & 3;
  const int n_qt = (t_len + kRowsF - 1) / kRowsF;
  const int n_ch = (d + kDP - 1) / kDP;  // column chunks of q.k^T
  const long long row_stride = (long long)heads * d;
  // work item: (slice, b*h, query tile), slices outermost
  const long long per_slice = (long long)n_qt * bh_count;

  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int c0 = (int)(w / per_slice) * kDP;  // this item's output slice
    const WorkItem it = work_item(w % per_slice, bh_count, n_qt, kRowsF);
    const int b = it.bh / heads, h = it.bh % heads;
    const int q0 = it.q0;
    const long long base =
        (long long)b * t_len * row_stride + (long long)h * d;

    // rows [t0, t0 + rows) x columns [col0, col0 + kDP), zero past T and D
    auto load = [&](float* dst, const T* src, int t0, int rows, int col0) {
      for (int c = threadIdx.x; c < rows * kDP; c += blockDim.x) {
        const int rr = c / kDP, col = col0 + c % kDP;
        float val = 0.f;
        if (t0 + rr < t_len && col < d)
          val = to_f<T>(src[base + (t0 + rr) * row_stride + col]);
        dst[rr * kLd + c % kDP] = val;
      }
    };
    __syncthreads();  // the previous item is done with qs
    if (n_ch == 1) load(qs, q, q0, kRowsF, 0);

    const int row = q0 + r;
    float m_run = kNegInf, l_run = 0.f;
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

    const int n_kt = key_tiles(q0, kRowsF, kKeysF, t_len, causal);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * kKeysF;
      float dot[kKeysF / 4];
#pragma unroll
      for (int i = 0; i < kKeysF / 4; ++i) dot[i] = 0.f;
      for (int ch = 0; ch < n_ch; ++ch) {
        __syncthreads();
        if (n_ch > 1) load(qs, q, q0, kRowsF, ch * kDP);
        load(ks, k, k0, kKeysF, ch * kDP);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kKeysF / 4; ++i) {
          const int kl = j + 4 * i;
          float acc_d = dot[i];
#pragma unroll 8
          for (int c = 0; c < kDP; ++c)
            acc_d = fmaf(qs[r * kLd + c], ks[kl * kLd + c], acc_d);
          dot[i] = acc_d;
        }
      }
      load(vs, v, k0, kKeysF, c0);
      __syncthreads();

      float s[kKeysF / 4];
      float mx = m_run;
#pragma unroll
      for (int i = 0; i < kKeysF / 4; ++i) {
        const int kl = j + 4 * i;
        float x = dot[i] * scale_log2;
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
        const int col = c0 + j + 4 * c;
        if (col < d)
          o[base + row * row_stride + col] = from_f<T>(acc[c] * inv);
      }
    }
  }
}

// -- launch ------------------------------------------------------------------

// a 1-D grid over n_work items, each CTA walking w, w + grid, ..
inline unsigned grid_for(long long n_work) {
  return (unsigned)(n_work < INT_MAX ? n_work : INT_MAX);
}

template <typename T, int kDP>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int bh, int t_len, int heads, int d, float scale_log2,
                       int causal, cudaStream_t stream) {
  const long long n_slices = d <= kDP ? 1 : (d + kDP - 1) / kDP;
  const long long n_work =
      n_slices * bh * (long long)((t_len + kRowsF - 1) / kRowsF);
  flash_fma<T, kDP><<<grid_for(n_work), 128, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_len, heads, d, bh,
      n_work, scale_log2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_any(const void* q, const void* k, const void* v,
                           void* o, int bh, int t_len, int heads, int d,
                           float scale_log2, int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch_fma<T, 32>(q, k, v, o, bh, t_len, heads, d, scale_log2,
                             causal, stream);
  if (d <= 64)
    return launch_fma<T, 64>(q, k, v, o, bh, t_len, heads, d, scale_log2,
                             causal, stream);
  return launch_fma<T, kSliceF>(q, k, v, o, bh, t_len, heads, d, scale_log2,
                                causal, stream);
}

template <typename T, int kDP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int bh, int t_len, int heads, int d, float scale_log2,
                       int causal, int vec, cudaStream_t stream) {
  const long long n_work = bh * (long long)((t_len + kRows - 1) / kRows);
  flash_mma<T, kDP><<<grid_for(n_work), 128, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), t_len,
      heads, d, bh, n_work, scale_log2, causal, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_any(const void* q, const void* k, const void* v,
                           void* o, int bh, int t_len, int heads, int d,
                           float scale_log2, int causal, int vec,
                           cudaStream_t stream) {
  if (d <= 32)
    return launch_mma<T, 32>(q, k, v, o, bh, t_len, heads, d, scale_log2,
                             causal, vec, stream);
  if (d <= 64)
    return launch_mma<T, 64>(q, k, v, o, bh, t_len, heads, d, scale_log2,
                             causal, vec, stream);
  return launch_mma<T, 128>(q, k, v, o, bh, t_len, heads, d, scale_log2,
                            causal, vec, stream);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; looked up once
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qres;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &qres) != cudaSuccess ||
        qres != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &qres) != cudaSuccess ||
        qres != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// the 4-D [B, T, H, D] map of a 16-bit tensor, boxes of 64 columns x 64 rows
// of one (b, h), 128-byte swizzle, zero fill out of bounds
bool make_map(CUtensorMap* map, const void* ptr, int dtype, long long batch,
              long long t_len, long long heads, long long d) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)t_len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(d * 2),
                                 (cuuint64_t)(heads * d * 2),
                                 (cuuint64_t)(t_len * heads * d * 2)};
  const cuuint32_t box[4] = {kBox, 1, kBox, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int kNC>
cudaError_t launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km,
                         const CUtensorMap& vm, void* o, int bh, int t_len,
                         int heads, int d, float scale_log2, int causal,
                         cudaStream_t stream) {
  const int smem = WgmmaCfg<kNC>::kSmemBytes;
  // above 48 KB of dynamic shared memory needs the attribute, set once a
  // device (before the first launch, so not inside a graph capture)
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_wgmma<T, kNC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) attr_set[dev] = true;
  }
  const long long n_work = bh * (long long)((t_len + 127) / 128);
  flash_wgmma<T, kNC><<<grid_for(n_work), 3 * kWgThreads, smem, stream>>>(
      qm, km, vm, static_cast<T*>(o), t_len, heads, d, bh, n_work,
      scale_log2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_any(const CUtensorMap& qm, const CUtensorMap& km,
                             const CUtensorMap& vm, void* o, int bh,
                             int t_len, int heads, int d, float scale_log2,
                             int causal, cudaStream_t stream) {
  switch ((d + 63) / 64) {
    case 1:
      return launch_wgmma<T, 1>(qm, km, vm, o, bh, t_len, heads, d,
                                scale_log2, causal, stream);
    case 2:
      return launch_wgmma<T, 2>(qm, km, vm, o, bh, t_len, heads, d,
                                scale_log2, causal, stream);
    case 3:
      return launch_wgmma<T, 3>(qm, km, vm, o, bh, t_len, heads, d,
                                scale_log2, causal, stream);
    default:
      return launch_wgmma<T, 4>(qm, km, vm, o, bh, t_len, heads, d,
                                scale_log2, causal, stream);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  q, k, v and o are contiguous
// [B, T, H, D] of that dtype.  variant: 0 fma (any dtype, any D), 1
// mma.sync (16-bit, D <= 128), 2 wgmma (16-bit, D % 8 == 0, D <= 256, every
// base 16-byte aligned); a variant given a shape it cannot take returns
// cudaErrorInvalidValue.  B * H and T up to INT_MAX each.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype,
                                   long long batch, long long t_len,
                                   long long heads, long long d, int causal,
                                   int variant, void* stream_ptr) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return (int)cudaSuccess;
  if (d < 1 || dtype < 0 || dtype > 2 || batch * heads > INT_MAX ||
      t_len > INT_MAX - 128 || heads * d > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float scale_log2 = (1.0f / sqrtf((float)d)) * kLog2e;
  const int bh = (int)(batch * heads), t = (int)t_len, hh = (int)heads,
            dd = (int)d;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
  if (variant == 0) {
    if (dtype == 0)
      return (int)launch_fma_any<float>(q, k, v, o, bh, t, hh, dd, scale_log2,
                                        causal, stream);
    if (dtype == 1)
      return (int)launch_fma_any<__nv_bfloat16>(q, k, v, o, bh, t, hh, dd,
                                                scale_log2, causal, stream);
    return (int)launch_fma_any<__half>(q, k, v, o, bh, t, hh, dd, scale_log2,
                                       causal, stream);
  }
  if (dtype == 0) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (d > 128) return (int)cudaErrorInvalidValue;
    const int vec = (d % 8 == 0) && (bases % 16 == 0);
    if (dtype == 1)
      return (int)launch_mma_any<__nv_bfloat16>(q, k, v, o, bh, t, hh, dd,
                                                scale_log2, causal, vec,
                                                stream);
    return (int)launch_mma_any<__half>(q, k, v, o, bh, t, hh, dd, scale_log2,
                                       causal, vec, stream);
  }
  if (variant != 2 || d % 8 != 0 || d > 256 || bases % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, dtype, batch, t_len, heads, d) ||
      !make_map(&km, k, dtype, batch, t_len, heads, d) ||
      !make_map(&vm, v, dtype, batch, t_len, heads, d))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_wgmma_any<__nv_bfloat16>(qm, km, vm, o, bh, t, hh, dd,
                                                scale_log2, causal, stream);
  return (int)launch_wgmma_any<__half>(qm, km, vm, o, bh, t, hh, dd,
                                       scale_log2, causal, stream);
}
