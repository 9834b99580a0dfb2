// merge_rows: out = segment_sum(rows, inv, nseg), in slot order
//
//   out[s] = ((0 + rows[i0]) + rows[i1]) + ...   over the slots i0 < i1 < ...
//            with inv[i] == s, for every s in [0, nseg); slots whose inv
//            lies outside [0, nseg), negative ones included, are dropped.
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _merge_pallas/_merge_kernel: a sequential scatter-accumulate over a grid
// that runs in order on one core, so each segment adds its rows in slot
// order and the result is bit-identical to jax.ops.segment_sum.  Blocks run
// in parallel here, and a float atomicAdd would add in no fixed order, so
// this port sorts instead and keeps the order:
//
//   1. keys (uint32(seg) << 32) | slot for the kept slots, all-ones for the
//      dropped ones, for the rows whose every value is +-0, and for the
//      padding to a power of two P;
//   2. a bitonic sort of the P keys (bitonic_sort.cuh): each segment's
//      slots now lie together, in increasing slot order;
//   3. warps walk the sorted positions; a warp that finds the start of a
//      segment's run sums the run's rows in order, one lane per column,
//      32 slots at a time (the lanes load the 32 keys, then each lane
//      loads its column of the 32 rows before it adds them in order).
//      Segments without rows stay at the zero they were set to.
//
// Leaving out the all-zero rows changes no bit: a sum that starts at +0.0
// and adds in round-to-nearest is never -0.0, and adding +-0 to any such
// value returns it unchanged.  It matters for speed: the allgather
// exchange's gathered payload holds every rank's dedup padding (slots of
// id 0 with zero rows, about half of each rank's K slots), which all land
// in the segment of id 0, a run one warp would otherwise walk in sequence.
//
// The sums are plain float adds (__fadd_rn, no contraction) from 0.0f in
// slot order: bit-identical to the plain version (merge_rows_plain, in
// lightctr_tpu_torch/ops/sparse_kernels.py) and to segment_sum.
//
// Bound: bytes.  The function reads M*d*4 bytes of rows and M*4 of inv and
// writes nseg*d*4: at the allgather exchange's shape (M = 2 x 79,872 rows,
// d = 32, nseg = M) about 41 MB, 0.012 ms at 3.35 TB/s.  The sort (about 36
// launches at P = 2^18) keeps it far from that bound, and a segment with
// many nonzero rows is walked by one warp in sequence: the order of the
// adds is the contract, so a tree reduction is not an option.

// Plain C interface for ctypes; the entry returns the first CUDA error of
// its launches, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic_sort.cuh"

namespace {

using lct::u64;

constexpr u64 kPadKey = ~0ull;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 2048;
constexpr unsigned kFull = 0xffffffffu;

__global__ void make_seg_keys(const int32_t* __restrict__ inv,
                              const float* __restrict__ rows, long long m,
                              long long d, long long p, long long nseg,
                              u64* __restrict__ keys) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride) {
    u64 key = kPadKey;
    if (i < m) {
      const long long seg = inv[i];
      bool zero = true;  // NaN compares unequal, so it is kept
      for (long long c = 0; c < d && zero; ++c) zero = rows[i * d + c] == 0.0f;
      if (seg >= 0 && seg < nseg && !zero) key = ((u64)seg << 32) | (u64)i;
    }
    keys[i] = key;
  }
}

__global__ void sum_runs(const u64* __restrict__ keys, long long m,
                         const float* __restrict__ rows, long long d,
                         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = warp; i < m; i += n_warps) {
    const u64 key = keys[i];
    if (key == kPadKey) continue;  // dropped and zero slots sort last
    const u64 seg = key >> 32;
    if (i > 0 && (keys[i - 1] >> 32) == seg) continue;  // not a run start
    for (long long c0 = 0; c0 < d; c0 += 32) {
      const long long c = c0 + lane;
      float acc = 0.0f;
      long long j = i;
      int batch = 32;
      while (batch == 32) {
        const u64 kk = j + lane < m ? keys[j + lane] : kPadKey;
        const unsigned same = __ballot_sync(kFull, (kk >> 32) == seg);
        // the run is contiguous: the batch holds its leading set bits
        batch = same == kFull ? 32 : __ffs(~same) - 1;
        const unsigned my_slot = (unsigned)(kk & 0xffffffffull);
        float v[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const unsigned slot = __shfl_sync(kFull, my_slot, t);
          v[t] = (t < batch && c < d) ? __ldg(rows + (long long)slot * d + c)
                                      : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < 32; ++t)
          if (t < batch) acc = __fadd_rn(acc, v[t]);
        j += batch;
      }
      if (c < d) out[seg * d + c] = acc;
    }
  }
}

}  // namespace

// Bytes of device scratch merge_rows_f32 needs for m rows: the padded keys.
extern "C" long long merge_rows_workspace_bytes(long long m) {
  return lct::pow2_at_least(m < 2 ? 2 : m) * (long long)sizeof(u64);
}

extern "C" int merge_rows_f32(const void* rows, const void* inv, long long m,
                              long long d, long long nseg, void* out,
                              void* workspace, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nseg <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(nseg * d) * 4, stream);
  if (err != cudaSuccess || m <= 0) return (int)err;
  const long long p = lct::pow2_at_least(m < 2 ? 2 : m);
  u64* keys = static_cast<u64*>(workspace);
  make_seg_keys<<<lct::sort_grid_for(p), lct::kSortThreads, 0, stream>>>(
      static_cast<const int32_t*>(inv), static_cast<const float*>(rows), m, d,
      p, nseg, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = lct::bitonic_sort<u64>(keys, p, stream)) != cudaSuccess)
    return (int)err;
  long long blocks = (m * 32 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sum_runs<<<(unsigned)blocks, kThreads, 0, stream>>>(
      keys, m, static_cast<const float*>(rows), d, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
