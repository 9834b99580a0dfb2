// The quantile codec's encode for one value, shared by quantize_pack.cu and
// quantize_pack_ef_update.cu: searchsorted(boundaries, x, side='left'), the
// number of boundaries strictly below x, as ops/quantize.py `compress`
// computes it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lct {

// The smallest power of two >= nb (nb >= 1).
inline int search_width(long long nb) {
  int p = 1;
  while (p < nb) p <<= 1;
  return p;
}

// Branchless lower bound over nb ascending boundaries, read through
// bnd(i), with positions nb .. nbp-1 of the power-of-two width nbp read as
// +inf (they never count).  log2(nbp) + 1 reads.  NaN takes code nb, as
// the JAX reference's searchsorted gives it (a compare-count, like the TPU
// kernel _qp_kernel, would give 0); +inf takes nb and -inf 0.
template <typename Load>
__device__ __forceinline__ int lower_bound_code(float x, int nb, int nbp,
                                                Load bnd) {
  if (isnan(x)) return nb;
  int pos = 0;
  for (int half = nbp >> 1; half >= 1; half >>= 1) {
    const int probe = pos + half - 1;
    const float b = probe < nb ? bnd(probe) : INFINITY;
    if (b < x) pos += half;
  }
  const float last = pos < nb ? bnd(pos) : INFINITY;
  return pos + (last < x ? 1 : 0);
}

}  // namespace lct
