// quantize_pack: codes[i] = searchsorted(boundaries, x[i], side='left')
//
// The encode of every coded collective (dist/collectives.py): float32 values
// to uint8 codes (tables of up to 8 bits) or uint16 codes (up to 16 bits),
// bit-identical to ops/quantize.py `compress` (the plain version,
// quantize_pack_plain in lightctr_tpu_torch/ops/sparse_kernels.py) and to
// the JAX package's `quantize.compress`, NaN and +-inf included: NaN and
// +inf take the top code nb, -inf code 0.
//
// Replaces the TPU kernels lightctr_tpu/ops/sparse_kernels.py _qp_pallas:
// _qp_kernel (up to 8 bits, a compare-count sweep of every boundary per
// value, which suits the TPU's wide vector unit) and _qp_search_kernel
// (16 bits, a binary search over the boundary table in VMEM).  Here one
// thread encodes one value with a branchless lower bound of log2(nb) + 1
// reads (quantile_search.cuh): up to 8 bits the <= 255 boundaries sit in
// shared memory; at 16 bits the 65,535 boundaries (256 KB) exceed a block's
// shared memory, so the search reads them through the read-only cache,
// where the top levels of the search tree stay hot.
//
// Bound: bytes.  The function reads 4 bytes and writes 1 (or 2) per value:
// at the sparse exchange's payload (79,872 x 32 values) 12.8 MB at 8 bits,
// 0.004 ms at 3.35 TB/s.  The search's compares are a few dozen operations
// per value, far under the card's rate.
//
// Plain C interface for ctypes; each entry returns the launch's CUDA error,
// which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "quantile_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;
constexpr int kSharedBoundaries = 255;  // an 8-bit table

template <typename Code, bool kShared>
__global__ void encode(const float* __restrict__ bnd, int nb, int nbp,
                       const float* __restrict__ x, long long n,
                       Code* __restrict__ codes) {
  __shared__ float sb[kShared ? kSharedBoundaries : 1];
  if (kShared) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = bnd[i];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int code;
    if (kShared)
      code = lct::lower_bound_code(x[i], nb, nbp,
                                   [&](int j) { return sb[j]; });
    else
      code = lct::lower_bound_code(x[i], nb, nbp,
                                   [&](int j) { return __ldg(bnd + j); });
    codes[i] = (Code)code;
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename Code>
int launch(const void* bnd, long long nb, const void* x, long long n,
           void* codes, void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  if (nb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nbp = lct::search_width(nb);
  if (nb <= kSharedBoundaries)
    encode<Code, true><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const float*>(bnd), (int)nb, nbp,
        static_cast<const float*>(x), n, static_cast<Code*>(codes));
  else
    encode<Code, false><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const float*>(bnd), (int)nb, nbp,
        static_cast<const float*>(x), n, static_cast<Code*>(codes));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int quantize_pack_u8(const void* bnd, long long nb, const void* x,
                                long long n, void* codes, void* stream) {
  return launch<uint8_t>(bnd, nb, x, n, codes, stream);
}

extern "C" int quantize_pack_u16(const void* bnd, long long nb, const void* x,
                                 long long n, void* codes, void* stream) {
  return launch<uint16_t>(bnd, nb, x, n, codes, stream);
}
