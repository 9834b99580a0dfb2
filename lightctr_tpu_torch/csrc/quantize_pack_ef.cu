// quantize_pack_ef: the EF-folded payload encode
//
//   for every value i (row r = i / mask_div when the mask is one value per
//   row, mask_div = 1 when it is one value per value):
//     m        = mask[i / mask_div]
//     val      = rows[i] + carried[i] * m
//     code     = searchsorted(boundaries, val, side='left')
//     codes[i] = code
//     delta[i] = ((val - values[code]) - carried[i]) * m
//
// which is the JAX reference _qp_ef_reference: compensate with last step's
// carry, encode, decode, fresh error.  The caller scatters delta back at the
// rows' table slots itself (quantize_pack_ef_update.cu folds that scatter
// in as well).
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _qp_ef_pallas/_qp_ef_kernel: [1024, 1] payload blocks on a sequential
// grid, a compare-count encode over every boundary and a chunked one-hot
// decode over every table value, both of which suit the TPU's wide vector
// unit.  Here one thread encodes one value with the branchless lower bound
// of quantile_search.cuh (log2(nb) + 1 reads) and decodes it with one table
// read.  Up to 8 bits both tables sit in shared memory; at 16 bits (512 KB)
// they are read through the read-only cache.  JAX sends 16-bit tables to
// its XLA reference (the one-hot decode over 2^16 values wastes vector
// time); this kernel takes them as B8 does.  NaN takes the top code, as in
// the JAX reference (the TPU's compare-count gives it code 0).
//
// Rounding: carried * m is a product, not a select, so inf and NaN in the
// carry propagate as in the reference; __fadd_rn, __fsub_rn and __fmul_rn
// in the reference's order keep nvcc from contracting them into FMAs, so
// codes and delta are bit-identical to the plain version
// (quantize_pack_ef_plain in lightctr_tpu_torch/ops/sparse_kernels.py).
//
// Bound: bytes.  Per value the function reads the row and the carry (8
// bytes), writes the code (1 or 2) and delta (4), and reads the mask once
// per row or per value: at the exchange payload (79,872 x 32, 8 bits, a
// [P, 1] mask) about 33.5 MB, 0.010 ms at 3.35 TB/s.
//
// Plain C interface for ctypes; each entry returns the launch's CUDA error,
// which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "quantile_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;
constexpr int kSharedValues = 256;  // an 8-bit table

template <typename Code, bool kShared>
__global__ void ef_pack(const float* __restrict__ bnd, int nb, int nbp,
                        const float* __restrict__ values,
                        const float* __restrict__ rows,
                        const float* __restrict__ carried,
                        const float* __restrict__ mask, long long n,
                        long long mask_div, Code* __restrict__ codes,
                        float* __restrict__ delta) {
  __shared__ float sb[kShared ? kSharedValues : 1];
  __shared__ float sv[kShared ? kSharedValues : 1];
  if (kShared) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = bnd[i];
    for (int i = threadIdx.x; i <= nb; i += blockDim.x) sv[i] = values[i];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float m = mask[i / mask_div];
    const float car = carried[i];
    const float val = __fadd_rn(rows[i], __fmul_rn(car, m));
    int code;
    float dec;
    if (kShared) {
      code = lct::lower_bound_code(val, nb, nbp, [&](int j) { return sb[j]; });
      dec = sv[code];
    } else {
      code = lct::lower_bound_code(val, nb, nbp,
                                   [&](int j) { return __ldg(bnd + j); });
      dec = __ldg(values + code);
    }
    codes[i] = (Code)code;
    delta[i] = __fmul_rn(__fsub_rn(__fsub_rn(val, dec), car), m);
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename Code>
int launch(const void* bnd, long long nb, const void* values,
           const void* rows, const void* carried, const void* mask,
           long long n, long long mask_div, void* codes, void* delta,
           void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  if (nb < 1 || mask_div < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nbp = lct::search_width(nb);
  if (nb < kSharedValues)
    ef_pack<Code, true><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const float*>(bnd), (int)nb, nbp,
        static_cast<const float*>(values), static_cast<const float*>(rows),
        static_cast<const float*>(carried), static_cast<const float*>(mask),
        n, mask_div, static_cast<Code*>(codes), static_cast<float*>(delta));
  else
    ef_pack<Code, false><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const float*>(bnd), (int)nb, nbp,
        static_cast<const float*>(values), static_cast<const float*>(rows),
        static_cast<const float*>(carried), static_cast<const float*>(mask),
        n, mask_div, static_cast<Code*>(codes), static_cast<float*>(delta));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int quantize_pack_ef_u8(const void* bnd, long long nb,
                                   const void* values, const void* rows,
                                   const void* carried, const void* mask,
                                   long long n, long long mask_div,
                                   void* codes, void* delta, void* stream) {
  return launch<uint8_t>(bnd, nb, values, rows, carried, mask, n, mask_div,
                         codes, delta, stream);
}

extern "C" int quantize_pack_ef_u16(const void* bnd, long long nb,
                                    const void* values, const void* rows,
                                    const void* carried, const void* mask,
                                    long long n, long long mask_div,
                                    void* codes, void* delta, void* stream) {
  return launch<uint16_t>(bnd, nb, values, rows, carried, mask, n, mask_div,
                          codes, delta, stream);
}
