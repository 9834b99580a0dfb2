// merge_apply (apply mode): sparse Adagrad in place on the touched rows
//
//   for every slot s with uid = uids[s] that is not a pad (uid 0 past slot 0):
//     g           = rows[s] / denom
//     accum[uid] += g*g
//     table[uid] -= lr * g * rsqrt(accum[uid] + eps)
//   sumsq = sum over those slots of g*g
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _merge_apply_pallas in its apply-only form (inv=None): _apply_kernel,
// _apply_block_kernel and _apply_block_dma_kernel, one touched row per grid
// step (or rb rows), the row window steered by scalar-prefetched uids.  A
// TPU grid runs in order, so that kernel rotates slot 0 to run last and
// lets the pad slots (uid 0 past slot 0) write their no-op updates to row 0
// before the one real write.  Here blocks run in parallel, so pad slots are
// skipped outright (ROADMAP B.5): every other uid is distinct (the dedup
// contract), nothing races, and the table needs no atomics.  The merge mode
// (inv given, a segment-sum of duplicate rows first, TPU kernel
// _merge_kernel) is not here; the Python wrapper refuses it.
//
// Layout: the S*d gradient values are flattened over a grid-stride loop, so
// neighbouring threads read neighbouring gradient floats and, for d = 32,
// one warp reads and writes one 128-byte table row and its accumulator
// row.  d = 1 (FM's w table) takes the same path with one row per thread.
//
// Rounding: each operation is written with an _rn intrinsic in the plain
// version's order (g/denom, g*g, a + g*g, a' + eps, lr*g, (lr*g)*r, w - ...)
// so nvcc cannot contract them into FMAs; rsqrtf matches torch.rsqrt on the
// card.  sumsq is accumulated in double per thread, reduced per block, and
// the per-block sums are added by one block in a fixed order, so it is the
// same from run to run (the grid depends only on S*d).
//
// Bound: bytes.  The touched rows' table and accumulator are read and
// written once (4 * S_real * d * 4 bytes for S_real distinct ids), their
// S_real*d gradient floats read once, and all S uids read once; a pad slot
// reads its uid and skips its gradient row.  At the trainer's shape
// (S = 159,744 slots, about 75,500 distinct, d = 32) that is about 49 MB,
// so about 15 us at 3.35 TB/s; chip_smoke.py computes the bound from the
// run's own uids.
//
// Plain C interface for ctypes; the entry returns the first CUDA error of
// its launches, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

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
    // pad slots (uid 0 past slot 0) carry no gradient; a uid outside the
    // table is dropped rather than written out of bounds, as the plain
    // version drops it
    if ((uid == 0 && slot > 0) || uid < 0 || uid >= vocab) continue;
    float g = rows[t];
    if (scale) g = __fdiv_rn(g, denom);
    const float g2 = __fmul_rn(g, g);
    ssq += (double)g2;
    const long long e = uid * d + (t - slot * d);
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
