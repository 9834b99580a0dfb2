// gather_rows: out[i, :] = block[clip(int32(idx[i]), 0, R - 1), :]
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _gather_pallas/_gather_kernel: a grid of n steps, each moving one (1, d)
// row window steered by scalar-prefetched indices.  Here the n*d output is
// flattened so neighbouring threads write neighbouring floats; each thread
// reads its row's index itself and applies the same int32 cast and clip as
// _gather_pallas (sparse_kernels.py:740).  A grid-stride loop covers any n*d.
//
// Bound: bytes.  The call reads n*d*4 bytes of rows and n*sizeof(idx) of
// indices and writes n*d*4 bytes.  At the serving shape (n padded to 16384,
// d = 33) that is about 4.4 MB, about 1.3 us at the H100's 3.35 TB/s, so the
// kernel is bound by its launch latency, not by the rows it moves.  The
// simple design is right for that: rows of 33 floats are not 16-byte
// aligned, so scalar 4-byte loads; no shared memory, no TMA, no vector
// loads until a caller gathers wide enough rows for them to matter.
//
// The result is a copy: no atomics, no reordering, bit-identical to the
// plain version (gather_rows_plain in lightctr_tpu_torch/ops/sparse_kernels.py).
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

template <typename IdxT>
__global__ void gather_rows_kernel(const float* __restrict__ block,
                                   const IdxT* __restrict__ idx,
                                   float* __restrict__ out,
                                   long long rows, long long d,
                                   long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long i = t / d;
    const long long c = t - i * d;
    long long r = (long long)static_cast<int32_t>(idx[i]);
    r = r < 0 ? 0 : (r > rows - 1 ? rows - 1 : r);
    out[t] = block[r * d + c];
  }
}

template <typename IdxT>
int launch(const void* block, const void* idx, void* out, long long rows,
           long long d, long long n, void* stream) {
  const long long total = n * d;
  if (total <= 0) return (int)cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<IdxT><<<(unsigned)blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(block), static_cast<const IdxT*>(idx),
      static_cast<float*>(out), rows, d, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_rows_f32_i32(const void* block, const void* idx,
                                   void* out, long long rows, long long d,
                                   long long n, void* stream) {
  return launch<int32_t>(block, idx, out, rows, d, n, stream);
}

extern "C" int gather_rows_f32_i64(const void* block, const void* idx,
                                   void* out, long long rows, long long d,
                                   long long n, void* stream) {
  return launch<int64_t>(block, idx, out, rows, d, n, stream);
}
