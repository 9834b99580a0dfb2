// A bitonic sort of fixed-width keys in device memory, shared by the kernels
// that sort (id, slot) or (segment, slot) pairs: dedup_ids.cu and
// merge_rows.cu.
//
// Keys are 64-bit (u64) or 128-bit (Key128, compared hi first), padded by
// the caller to a power of two P with keys that sort last.  Stages whose
// partner distance is under kSortChunk run in shared memory, one block per
// chunk; wider ones run as global compare-exchange passes (log2(P/chunk) of
// them per stage).  At P = 2^18 that is 171 compare-exchange passes, most of
// them in shared memory, in about 36 launches.  Integer compares only: the
// order is exact and the same on every run.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lct {

typedef unsigned long long u64;

struct __align__(16) Key128 {
  u64 hi, lo;
};

__device__ __forceinline__ bool key_gt(u64 a, u64 b) { return a > b; }

__device__ __forceinline__ bool key_gt(const Key128& a, const Key128& b) {
  return a.hi > b.hi || (a.hi == b.hi && a.lo > b.lo);
}

constexpr int kSortThreads = 256;
constexpr long long kSortMaxBlocks = 4096;
constexpr int kSortChunk = 2048;  // keys per shared-memory sort block

inline unsigned sort_grid_for(long long n) {
  long long blocks = (n + kSortThreads - 1) / kSortThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks > kSortMaxBlocks ? kSortMaxBlocks : blocks);
}

inline long long pow2_at_least(long long k) {
  long long p = 2;
  while (p < k) p <<= 1;
  return p;
}

// One compare-exchange stage (k, j) with j >= the shared chunk: pair t
// holds elements i and i + j, sorted ascending where bit k of i is clear.
template <typename K>
__global__ void bitonic_global(K* __restrict__ keys, long long p, long long j,
                               long long k) {
  const long long half = p >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < half; t += stride) {
    const long long i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    const long long l = i + j;
    const bool asc = (i & k) == 0;
    const K a = keys[i], b = keys[l];
    if (key_gt(a, b) == asc) {
      keys[i] = b;
      keys[l] = a;
    }
  }
}

// The stages whose partners lie within one chunk, in shared memory.
// k_merge == 0: sort each chunk from scratch (stages k = 2 .. chunk);
// otherwise finish stage k_merge (partner distances chunk/2 .. 1).
template <typename K>
__global__ void bitonic_local(K* __restrict__ keys, int chunk,
                              long long k_merge) {
  extern __shared__ __align__(16) unsigned char sort_smem[];
  K* s = reinterpret_cast<K*>(sort_smem);
  const long long base = (long long)blockIdx.x * chunk;
  for (int x = threadIdx.x; x < chunk; x += blockDim.x) s[x] = keys[base + x];
  __syncthreads();
  const int half = chunk >> 1;
  const long long k_first = k_merge ? k_merge : 2;
  const long long k_last = k_merge ? k_merge : chunk;
  for (long long k = k_first; k <= k_last; k <<= 1) {
    for (int j = (int)((k >> 1) < half ? (k >> 1) : half); j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const bool asc = ((base + i) & k) == 0;
        const K a = s[i], b = s[l];
        if (key_gt(a, b) == asc) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int x = threadIdx.x; x < chunk; x += blockDim.x) keys[base + x] = s[x];
}

// Sort p keys ascending (p a power of two, at least 2) on `stream`;
// returns the first launch error.
template <typename K>
cudaError_t bitonic_sort(K* keys, long long p, cudaStream_t stream) {
  const int chunk = (int)(p < kSortChunk ? p : kSortChunk);
  const unsigned n_chunks = (unsigned)(p / chunk);
  const size_t smem = (size_t)chunk * sizeof(K);
  cudaError_t err;
  bitonic_local<K><<<n_chunks, chunk / 2, smem, stream>>>(keys, chunk, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (long long kk = 2LL * chunk; kk <= p; kk <<= 1) {
    for (long long j = kk >> 1; j >= chunk; j >>= 1) {
      bitonic_global<K><<<sort_grid_for(p / 2), kSortThreads, 0, stream>>>(
          keys, p, j, kk);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bitonic_local<K><<<n_chunks, chunk / 2, smem, stream>>>(keys, chunk, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace lct
