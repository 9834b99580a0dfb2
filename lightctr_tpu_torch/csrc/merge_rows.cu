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
// in parallel here, so this port sorts instead and keeps the order
// (segment_runs.cuh has the design): a key pass, a stable radix sort of
// (segment, slot) pairs, and two walker launches (the short runs, then the
// long ones) that sum each run of a segment's slots in slot order, one
// column a thread, and store the sum; +0 for a segment without kept rows.
//
// The sums are plain float adds (__fadd_rn, no contraction) from 0.0f in
// slot order: bit-identical to the plain version (merge_rows_plain, in
// lightctr_tpu_torch/ops/sparse_kernels.py) and to segment_sum.
//
// Bound: bytes.  The function reads M*d*4 bytes of rows and M*4 of inv and
// writes nseg*d*4: at the allgather exchange's shape (M = 2 x 79,872 rows,
// d = 32, nseg = M) about 41 MB, 0.012 ms at 3.35 TB/s.  The workspace
// memset, the key pass, the radix passes over 8-byte (key, slot) pairs (3
// at that nseg, each a chain of latency rather than bytes) and the two
// walkers are seven launches in sequence.
//
// Plain C interface for ctypes; the entry returns the first CUDA error of
// its launches, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "segment_runs.cuh"

namespace {

// the walker's epilogue: the sum is the output
struct StoreSums {
  float* out;
  long long d;
  __device__ bool skip(long long) const { return false; }
  __device__ float* begin(long long seg, int c) const {
    return out + seg * d + c;
  }
  __device__ double put(float* dst, float sum) const {
    *dst = sum;
    return 0.0;
  }
  __device__ void finish(double, long long) const {}
};

}  // namespace

// Bytes of device scratch merge_rows_f32 needs for m rows of width d onto
// nseg segments: the sort's keys, slots and notes and the segment flags.
extern "C" long long merge_rows_workspace_bytes(long long m, long long nseg,
                                                long long d) {
  return (long long)lct::SegRunsWorkspace(nullptr, m, nseg, d, false).bytes;
}

extern "C" int merge_rows_f32(const void* rows, const void* inv, long long m,
                              long long d, long long nseg, void* out,
                              void* workspace, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nseg <= 0) return (int)cudaSuccess;
  const lct::SegRunsWorkspace ws(workspace, m, nseg, d, false);
  return (int)lct::segment_runs(
      static_cast<const float*>(rows), static_cast<const int32_t*>(inv), m,
      d, nseg, ws, StoreSums{static_cast<float*>(out), d}, stream);
}
