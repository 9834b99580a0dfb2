// quantize_pack_ef_update: the fixed-range sparse exchange's error-feedback
// encode, with the carry written back in place
//
//   for every slot s (uid = uids[s], m = mask[s]) and column c:
//     row   = uid < 0 ? uid + vocab : uid    (a uid in [-vocab, 0) wraps)
//     car   = residual[row, c], or NaN for a row outside the table
//     val   = rows[s, c] + car * m
//     code  = searchsorted(boundaries, val, side='left')
//     dec   = values[code]
//     codes[s, c] = code;  dec_out[s, c] = dec
//     if m != 0 and the row is in the table:
//       residual[row, c] = car + ((val - dec) - car) * m
//
// which is the JAX reference _qp_ef_update_reference (gather the carry,
// compensate, encode, decode, residual.at[uids].add(((val - dec) - carried)
// * mask)) for the dedup convention: at most one unmasked slot per uid.
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _qp_ef_update_pallas/_qp_ef_update_kernel: one payload row per grid step,
// the scalar-prefetched uid steering the residual window, a compare-count
// encode and a one-hot decode; a grid that runs in order lets masked slots
// write their window back unchanged, slot 0 rotated to run last.  Blocks run
// in parallel here, so masked slots SKIP the write instead (adding
// ((val - dec) - car) * 0 changes nothing), and the one unmasked slot of a
// uid is its only writer: no atomics.  A masked slot still reads the carry
// for its own code (car * 0), a read that may race the real slot's write;
// only the sign of that zero can depend on it, and it vanishes in
// rows + (+-0) unless the pad's row is -0, which a zero-gradient pad is not.
// The decode is one table read (dec = values[code]), so 16-bit tables run
// here too: the TPU sent them to its reference because a one-hot decode
// over 2^16 values wastes vector time.  Up to 8 bits both tables sit in
// shared memory; at 16 bits (512 KB) they are read through the read-only
// cache.
//
// Rounding: __fadd_rn, __fsub_rn and __fmul_rn in the reference's order, so
// nvcc cannot contract them into FMAs: codes, dec and the residual are
// bit-identical to the plain version (quantize_pack_ef_update_plain in
// lightctr_tpu_torch/ops/sparse_kernels.py).
//
// Bound: bytes.  Per value the function reads the row, the carry and
// (once per slot) the uid and mask, writes the code, dec and (for an
// unmasked slot) the carry: at the exchange's shape (79,872 slots x 32)
// about 43 MB at 8 bits, 0.013 ms at 3.35 TB/s.
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
__global__ void ef_update(const float* __restrict__ bnd, int nb, int nbp,
                          const float* __restrict__ values,
                          const float* __restrict__ rows,
                          const int32_t* __restrict__ uids,
                          float* __restrict__ residual,
                          const float* __restrict__ mask, long long s,
                          long long d, long long vocab,
                          Code* __restrict__ codes,
                          float* __restrict__ dec_out) {
  __shared__ float sb[kShared ? kSharedValues : 1];
  __shared__ float sv[kShared ? kSharedValues : 1];
  if (kShared) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = bnd[i];
    for (int i = threadIdx.x; i <= nb; i += blockDim.x) sv[i] = values[i];
    __syncthreads();
  }
  const long long total = s * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long slot = t / d;
    const long long uid = uids[slot];
    const float m = mask[slot];
    const long long row = uid < 0 ? uid + vocab : uid;
    const bool inside = row >= 0 && row < vocab;
    const long long e = row * d + (t - slot * d);
    const float car = inside ? residual[e] : __int_as_float(0x7fc00000);
    const float val = __fadd_rn(rows[t], __fmul_rn(car, m));
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
    codes[t] = (Code)code;
    dec_out[t] = dec;
    if (inside && m != 0.0f)
      residual[e] = __fadd_rn(
          car, __fmul_rn(__fsub_rn(__fsub_rn(val, dec), car), m));
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename Code>
int launch(const void* bnd, long long nb, const void* values,
           const void* rows, const void* uids, void* residual,
           const void* mask, long long s, long long d, long long vocab,
           void* codes, void* dec, void* stream_ptr) {
  if (s <= 0 || d <= 0) return (int)cudaSuccess;
  if (nb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nbp = lct::search_width(nb);
  const unsigned grid = grid_for(s * d);
  if (nb < kSharedValues)
    ef_update<Code, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(bnd), (int)nb, nbp,
        static_cast<const float*>(values), static_cast<const float*>(rows),
        static_cast<const int32_t*>(uids), static_cast<float*>(residual),
        static_cast<const float*>(mask), s, d, vocab,
        static_cast<Code*>(codes), static_cast<float*>(dec));
  else
    ef_update<Code, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(bnd), (int)nb, nbp,
        static_cast<const float*>(values), static_cast<const float*>(rows),
        static_cast<const int32_t*>(uids), static_cast<float*>(residual),
        static_cast<const float*>(mask), s, d, vocab,
        static_cast<Code*>(codes), static_cast<float*>(dec));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int quantize_pack_ef_update_u8(
    const void* bnd, long long nb, const void* values, const void* rows,
    const void* uids, void* residual, const void* mask, long long s,
    long long d, long long vocab, void* codes, void* dec, void* stream) {
  return launch<uint8_t>(bnd, nb, values, rows, uids, residual, mask, s, d,
                         vocab, codes, dec, stream);
}

extern "C" int quantize_pack_ef_update_u16(
    const void* bnd, long long nb, const void* values, const void* rows,
    const void* uids, void* residual, const void* mask, long long s,
    long long d, long long vocab, void* codes, void* dec, void* stream) {
  return launch<uint16_t>(bnd, nb, values, rows, uids, residual, mask, s, d,
                          vocab, codes, dec, stream);
}
