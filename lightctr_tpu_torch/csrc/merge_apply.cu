// merge_apply: sparse Adagrad in place on the touched rows
//
//   for every slot s with uid = uids[s] that is not a pad (uid 0 past slot 0):
//     g           = merged[s] / denom
//     sumsq      += g*g
//     row         = uid < 0 ? uid + vocab : uid      (a uid in [-vocab, 0) wraps)
//     if 0 <= row < vocab:                            (any other uid is dropped)
//       accum[row] += g*g
//       table[row] -= lr * g * rsqrt(accum[row] + eps)
//
// `merged` is the per-uid rows of the apply mode (inv=None, the entry
// merge_apply_f32), or, in the merge mode (merge_apply_merge_f32), the
// slot-order segment merge of the gathered rows through their inv, which
// this entry computes and applies in one pass: the key pass and the radix
// sort of segment_runs.cuh, then its two walker launches (the short runs,
// then the long ones), whose epilogue applies each (segment, column) sum
// straight to the table, with no [S, d] scratch in between.  A segment
// that receives no kept row gets the update of a +0 sum, as in the plain
// version (it can change bits: a -0.0 accum becomes +0.0), except a pad
// slot, which is skipped in either mode.
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _merge_apply_pallas: _merge_kernel for the merge, then _apply_kernel,
// _apply_block_kernel or _apply_block_dma_kernel, one touched row per grid
// step (or rb rows), the row window steered by scalar-prefetched uids.  A
// TPU grid runs in order, so that kernel rotates slot 0 to run last and
// lets the pad slots (uid 0 past slot 0) write their no-op updates to row 0
// before the one real write.  Here blocks run in parallel, so pad slots are
// skipped outright (ROADMAP B.5): every other uid is distinct (the dedup
// contract), nothing races, and the table needs no atomics.  Pad slots
// carry zero gradient by contract (the apply mode's dispatch zeroes them,
// the merge leaves them at exact zeros), so skipping them leaves sumsq as
// the JAX reference computes it, which counts every merged row, those of
// uids outside the table too.
//
// Layout (apply mode): the S*d gradient values are flattened over a
// grid-stride loop, so neighbouring threads read neighbouring gradient
// floats and, for d = 32, one warp reads and writes one 128-byte table row
// and its accumulator row.  d = 1 (FM's w table) takes the same path with
// one row per thread.
// The merge mode's layout is the walker's (segment_runs.cuh): a thread a
// (segment, column), a warp a segment at d = 32, a thread one at d = 1.
//
// Rounding: each operation is written with an _rn intrinsic in the plain
// version's order (g/denom, g*g, a + g*g, a' + eps, lr*g, (lr*g)*r, w - ...)
// so nvcc cannot contract them into FMAs; rsqrtf matches torch.rsqrt on the
// card.  sumsq is accumulated in double per thread, reduced per block, and
// the per-block sums are added by one block in a fixed order, so it is the
// same from run to run (the grid depends only on S*d; in the merge mode on
// M, S and d, and the stable sort fixes which thread adds what).
//
// Bound: bytes.  The touched rows' table and accumulator are read and
// written once (4 * S_real * d * 4 bytes for S_real distinct ids), their
// S_real*d gradient floats read once, and all S uids read once; a pad slot
// reads its uid and skips its gradient row.  At the one-card trainer's shape
// (S = 159,744 slots, about 75,500 distinct, d = 32) that is about 49 MB,
// so about 15 us at 3.35 TB/s; chip_smoke.py computes the bound from the
// run's own uids.  The merge mode reads the M*d gathered floats and M
// segment ids in place of the S*d merged ones; its sort, like merge_rows',
// is a few launches of latency in sequence.
//
// Plain C interface for ctypes; each entry returns the first CUDA error of
// its launches, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "segment_runs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Fixed-order block sum of one double per thread; thread 0 holds it.
__device__ double block_sum(double x) {
  __shared__ double warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = threadIdx.x < (blockDim.x >> 5) ? warp_sums[lane] : 0.0;
  if (warp == 0) x = warp_sum(x);
  return x;
}

__global__ void apply_rows(float* __restrict__ table, float* __restrict__ accum,
                           const int32_t* __restrict__ uids,
                           const float* __restrict__ rows, long long vocab,
                           long long d, long long s, float lr, float eps,
                           float denom, bool scale,
                           double* __restrict__ partials) {
  double ssq = 0.0;
  const long long total = s * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long slot = t / d;
    const long long uid = uids[slot];
    // pad slots (uid 0 past slot 0) carry no gradient
    if (uid == 0 && slot > 0) continue;
    float g = rows[t];
    if (scale) g = __fdiv_rn(g, denom);
    const float g2 = __fmul_rn(g, g);
    ssq += (double)g2;
    // the JAX scatter's index rules: a negative uid wraps once, any other
    // uid outside the table is dropped
    const long long row = uid < 0 ? uid + vocab : uid;
    if (row < 0 || row >= vocab) continue;
    const long long e = row * d + (t - slot * d);
    const float a = __fadd_rn(accum[e], g2);
    accum[e] = a;
    table[e] = __fsub_rn(
        table[e], __fmul_rn(__fmul_rn(lr, g), rsqrtf(__fadd_rn(a, eps))));
  }
  ssq = block_sum(ssq);
  if (threadIdx.x == 0) partials[blockIdx.x] = ssq;
}

__global__ void sum_partials(const double* __restrict__ partials, int n,
                             float* __restrict__ out) {
  double x = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x += partials[i];
  x = block_sum(x);
  if (threadIdx.x == 0) *out = (float)x;
}

// The merge mode's walker epilogue: the (segment, column) sum, divided by
// denom, is applied as apply_rows applies a merged row, with the same
// rounding, index rules and pad skip; begin() loads the uid, the table and
// the accumulator before the sum, so their loads overlap the rows'.
struct ApplySums {
  float* table;
  float* accum;
  const int32_t* uids;
  long long vocab, d;
  float lr, eps, denom;
  bool scale;
  double* partials;

  struct Ctx {
    long long e;  // the element of table/accum, -1: none (dropped uid)
    bool pad;
    float a, w;
  };

  // pad slots carry no gradient
  __device__ bool skip(long long seg) const {
    return seg > 0 && uids[seg] == 0;
  }

  __device__ Ctx begin(long long seg, int c) const {
    Ctx x{-1, false, 0.0f, 0.0f};
    const long long uid = uids[seg];
    x.pad = uid == 0 && seg > 0;
    const long long row = uid < 0 ? uid + vocab : uid;
    if (!x.pad && row >= 0 && row < vocab) {
      x.e = row * d + c;
      x.a = accum[x.e];
      x.w = table[x.e];
    }
    return x;
  }

  __device__ double put(const Ctx& x, float sum) const {
    if (x.pad) return 0.0;  // pad slots carry no gradient
    float g = sum;
    if (scale) g = __fdiv_rn(g, denom);
    const float g2 = __fmul_rn(g, g);
    if (x.e >= 0) {
      const float a = __fadd_rn(x.a, g2);
      accum[x.e] = a;
      table[x.e] = __fsub_rn(
          x.w, __fmul_rn(__fmul_rn(lr, g), rsqrtf(__fadd_rn(a, eps))));
    }
    return (double)g2;
  }

  // the block's partial at `at` (segment_runs.cuh's walk_partials), which
  // sum_partials adds in that fixed order
  __device__ void finish(double ssq, long long at) const {
    ssq = block_sum(ssq);
    if (threadIdx.x == 0) partials[at] = ssq;
  }
};

}  // namespace

// Bytes of device scratch merge_apply_f32 needs: one double per block.
extern "C" long long merge_apply_workspace_bytes(void) {
  return (long long)kMaxBlocks * sizeof(double);
}

extern "C" int merge_apply_f32(void* table, void* accum, const void* uids,
                               const void* rows, long long vocab, long long d,
                               long long s, float lr, float eps, float denom,
                               void* sumsq, void* workspace,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long total = s * d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  double* partials = static_cast<double*>(workspace);
  apply_rows<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<float*>(table), static_cast<float*>(accum),
      static_cast<const int32_t*>(uids), static_cast<const float*>(rows),
      vocab, d, s, lr, eps, denom, denom != 1.0f, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kThreads, 0, stream>>>(partials, (int)blocks,
                                           static_cast<float*>(sumsq));
  return (int)cudaGetLastError();
}

// Bytes of device scratch merge_apply_merge_f32 needs for m gathered rows
// of width d onto s slots: the sort's keys, slots and notes, the segment
// and tile flags and the walkers' doubles.
extern "C" long long merge_apply_merge_workspace_bytes(long long m,
                                                       long long s,
                                                       long long d) {
  return (long long)lct::SegRunsWorkspace(nullptr, m, s, d, true).bytes;
}

extern "C" int merge_apply_merge_f32(void* table, void* accum,
                                     const void* uids, const void* rows,
                                     const void* inv, long long vocab,
                                     long long d, long long s, long long m,
                                     float lr, float eps, float denom,
                                     void* sumsq, void* workspace,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const lct::SegRunsWorkspace ws(workspace, m, s, d, true);
  const ApplySums epi{static_cast<float*>(table), static_cast<float*>(accum),
                      static_cast<const int32_t*>(uids), vocab, d, lr, eps,
                      denom, denom != 1.0f, ws.partials};
  cudaError_t err = lct::segment_runs(static_cast<const float*>(rows),
                                      static_cast<const int32_t*>(inv), m, d,
                                      s, ws, epi, stream);
  if (err != cudaSuccess) return (int)err;
  // one partial a block of each walker: a wider block to add them
  sum_partials<<<1, 1024, 0, stream>>>(ws.partials,
                                       (int)lct::walk_partials(m, s, d),
                                       static_cast<float*>(sumsq));
  return (int)cudaGetLastError();
}
