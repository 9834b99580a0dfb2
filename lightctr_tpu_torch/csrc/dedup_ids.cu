// dedup_ids: (uids, inv, count) = unique(ids, return_inverse, size, fill 0)
//
// The contract of jnp.unique(ids, return_inverse=True, size=size,
// fill_value=0) plus the distinct count, for int32 and int64 ids: uids are
// the sorted distinct ids (in the ids' type), padded with 0 past the count
// and cut at `size`; inv[i] is the rank of ids[i] among ALL distinct ids (so
// it may reach past `size` when the cut truncates); count = last rank + 1,
// left on the device (no host sync).
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _dedup_pallas/_dedup_kernel.  That kernel is sort-free: it ranks each id
// by an O(K^2) blocked compare on the vector unit, which a TPU grid runs in
// order.  At the trainer's K = 4096 x 39 = 159,744 ids that would be about
// 2.5e10 compares, so this port sorts instead:
//
//   1. keys: for int32 ids (uint32(id) ^ 0x80000000) << 32 | slot, 64 bits;
//      for int64 ids the pair (uint64(id) ^ 2^63, slot), 128 bits compared
//      id first.  The xor maps signed order onto unsigned order, so negative
//      ids and the type's limits sort right.  Padded to a power of two P
//      with all-ones keys that sort last;
//   2. a bitonic sort of the P keys (bitonic_sort.cuh);
//   3. mark where each sorted run of equal ids starts, inclusive-scan the
//      marks into ranks (a block scan per 4096-key tile, then one block
//      that scans the tile sums);
//   4. scatter inv[slot] = rank, and uids[rank] = id where a run starts and
//      rank < size (uids were zeroed first).
//
// Bound: bytes.  The function must read K*w bytes of ids (w = 4 or 8) and
// write K*4 of inv plus size*w of uids: about 12*K bytes for int32 ids,
// 1.9 MB at K = 159,744, 0.57 us at 3.35 TB/s.  No sort reaches that
// bound: the bitonic sort makes log2(P)*(log2(P)+1)/2 compare-exchange
// passes (171 at P = 2^18), most of them in shared memory, about 36
// launches in all; int64 keys move twice the bytes of int32 keys.  Simple
// and right first; a radix sort with one global pass per 8 bits is the
// faster design.
//
// The result is exact: integer compares and integer scans only, bit-identical
// to the plain version (dedup_ids_plain in lightctr_tpu_torch/ops/
// sparse_kernels.py, torch.unique padded with 0) for any int32 or int64
// stream.
//
// Plain C interface for ctypes; each entry returns the first CUDA error of
// its launches, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic_sort.cuh"

namespace {

using lct::Key128;
using lct::u64;

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kTile = kScanThreads * kScanItems;  // keys per scan block

// The key layout of one id width: make a key, read its id and slot back,
// and compare the id parts of two keys.
template <typename Id>
struct KeyOf;

template <>
struct KeyOf<int32_t> {
  typedef u64 K;
  __device__ static K make(int32_t id, unsigned slot) {
    return ((u64)((uint32_t)id ^ 0x80000000u) << 32) | (u64)slot;
  }
  __device__ static K pad() { return ~0ull; }
  __device__ static bool same_id(K a, K b) { return (a >> 32) == (b >> 32); }
  __device__ static int32_t id(K k) {
    return (int32_t)((uint32_t)(k >> 32) ^ 0x80000000u);
  }
  __device__ static unsigned slot(K k) {
    return (unsigned)(k & 0xffffffffull);
  }
};

template <>
struct KeyOf<int64_t> {
  typedef Key128 K;
  __device__ static K make(int64_t id, unsigned slot) {
    K k;
    k.hi = (u64)id ^ (1ull << 63);
    k.lo = (u64)slot;
    return k;
  }
  __device__ static K pad() {
    K k;
    k.hi = ~0ull;
    k.lo = ~0ull;
    return k;
  }
  __device__ static bool same_id(const K& a, const K& b) {
    return a.hi == b.hi;
  }
  __device__ static int64_t id(const K& k) {
    return (int64_t)(k.hi ^ (1ull << 63));
  }
  __device__ static unsigned slot(const K& k) { return (unsigned)k.lo; }
};

template <typename Id>
__device__ __forceinline__ bool run_starts(const typename KeyOf<Id>::K* keys,
                                           long long i) {
  return i == 0 || !KeyOf<Id>::same_id(keys[i], keys[i - 1]);
}

template <typename Id>
__global__ void make_keys(const Id* __restrict__ ids, long long k,
                          long long p, typename KeyOf<Id>::K* __restrict__ keys) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride)
    keys[i] = i < k ? KeyOf<Id>::make(ids[i], (unsigned)i) : KeyOf<Id>::pad();
}

// Inclusive scan over the block of ITEMS consecutive values per thread;
// returns the block total.  blockDim.x is a multiple of 32.
template <int ITEMS>
__device__ int block_inclusive_scan(int (&v)[ITEMS], int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int run = 0;
  for (int it = 0; it < ITEMS; ++it) {
    run += v[it];
    v[it] = run;
  }
  int x = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int offset = (warp ? warp_sums[warp - 1] : 0) + x - run;
  for (int it = 0; it < ITEMS; ++it) v[it] += offset;
  const int total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the caller's next scan
  return total;
}

// Per tile: run-start marks, scanned within the tile; the tile's total.
template <typename Id>
__global__ void rank_tiles(const typename KeyOf<Id>::K* __restrict__ keys,
                           long long k, int* __restrict__ ranks,
                           int* __restrict__ tile_sums) {
  __shared__ int warp_sums[32];
  const long long first =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kScanItems;
  int v[kScanItems];
  for (int it = 0; it < kScanItems; ++it) {
    const long long i = first + it;
    v[it] = (i < k && run_starts<Id>(keys, i)) ? 1 : 0;
  }
  const int total = block_inclusive_scan<kScanItems>(v, warp_sums);
  for (int it = 0; it < kScanItems; ++it)
    if (first + it < k) ranks[first + it] = v[it];
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: exclusive offsets of the tile sums, in order; the count.
__global__ void scan_tile_sums(const int* __restrict__ tile_sums, int n_tiles,
                               int* __restrict__ tile_offsets,
                               int32_t* __restrict__ count) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    int v[1] = {t < n_tiles ? tile_sums[t] : 0};
    const int own = v[0];
    const int total = block_inclusive_scan<1>(v, warp_sums);
    if (t < n_tiles) tile_offsets[t] = carry + v[0] - own;
    carry += total;
  }
  if (threadIdx.x == 0) *count = carry;
}

template <typename Id>
__global__ void scatter_ranks(const typename KeyOf<Id>::K* __restrict__ keys,
                              long long k, long long size,
                              const int* __restrict__ ranks,
                              const int* __restrict__ tile_offsets,
                              Id* __restrict__ uids,
                              int32_t* __restrict__ inv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += stride) {
    const typename KeyOf<Id>::K key = keys[i];
    const int rank = ranks[i] + tile_offsets[i / kTile] - 1;
    inv[KeyOf<Id>::slot(key)] = rank;
    if (rank < size && run_starts<Id>(keys, i)) uids[rank] = KeyOf<Id>::id(key);
  }
}

template <typename Id>
long long workspace_bytes(long long k) {
  const long long n_tiles = (k + kTile - 1) / kTile;
  return lct::pow2_at_least(k) * (long long)sizeof(typename KeyOf<Id>::K) +
         (k + 2 * n_tiles) * 4;
}

template <typename Id>
int dedup(const Id* ids, long long k, long long size, Id* uids,
          int32_t* inv, int32_t* count, void* workspace,
          cudaStream_t stream) {
  typedef typename KeyOf<Id>::K K;
  if (k <= 0) return (int)cudaSuccess;
  const long long p = lct::pow2_at_least(k);
  const long long n_tiles = (k + kTile - 1) / kTile;
  K* keys = static_cast<K*>(workspace);
  int* ranks = reinterpret_cast<int*>(keys + p);
  int* tile_sums = ranks + k;
  int* tile_offsets = tile_sums + n_tiles;
  cudaError_t err;
  if (size > 0) {
    err = cudaMemsetAsync(uids, 0, (size_t)size * sizeof(Id), stream);
    if (err != cudaSuccess) return (int)err;
  }
  make_keys<Id><<<lct::sort_grid_for(p), lct::kSortThreads, 0, stream>>>(
      ids, k, p, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = lct::bitonic_sort<K>(keys, p, stream)) != cudaSuccess)
    return (int)err;
  rank_tiles<Id><<<(unsigned)n_tiles, kScanThreads, 0, stream>>>(
      keys, k, ranks, tile_sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_tile_sums<<<1, kScanThreads, 0, stream>>>(tile_sums, (int)n_tiles,
                                                 tile_offsets, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scatter_ranks<Id><<<lct::sort_grid_for(k), lct::kSortThreads, 0, stream>>>(
      keys, k, size, ranks, tile_offsets, uids, inv);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device scratch a dedup of k ids needs (wide: int64 ids): the
// padded keys, the per-key tile ranks, the tile sums and the tile offsets.
extern "C" long long dedup_ids_workspace_bytes(long long k, int wide) {
  return wide ? workspace_bytes<int64_t>(k) : workspace_bytes<int32_t>(k);
}

extern "C" int dedup_ids_i32(const void* ids, long long k, long long size,
                             void* uids, void* inv, void* count,
                             void* workspace, void* stream_ptr) {
  return dedup<int32_t>(static_cast<const int32_t*>(ids), k, size,
                        static_cast<int32_t*>(uids),
                        static_cast<int32_t*>(inv),
                        static_cast<int32_t*>(count), workspace,
                        static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int dedup_ids_i64(const void* ids, long long k, long long size,
                             void* uids, void* inv, void* count,
                             void* workspace, void* stream_ptr) {
  return dedup<int64_t>(static_cast<const int64_t*>(ids), k, size,
                        static_cast<int64_t*>(uids),
                        static_cast<int32_t*>(inv),
                        static_cast<int32_t*>(count), workspace,
                        static_cast<cudaStream_t>(stream_ptr));
}
