// dedup_ids: (uids, inv, count) = unique(ids, return_inverse, size, fill 0)
//
// The contract of jnp.unique(ids, return_inverse=True, size=size,
// fill_value=0) plus the distinct count: uids are the sorted distinct ids,
// padded with 0 past the count and cut at `size`; inv[i] is the rank of
// ids[i] among ALL distinct ids (so it may reach past `size` when the cut
// truncates); count = last rank + 1, left on the device (no host sync).
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _dedup_pallas/_dedup_kernel.  That kernel is sort-free: it ranks each id
// by an O(K^2) blocked compare on the vector unit, which a TPU grid runs in
// order.  At the trainer's K = 4096 x 39 = 159,744 ids that would be about
// 2.5e10 compares, so this port sorts instead:
//
//   1. keys = (uint32(id) ^ 0x80000000) << 32 | slot, 64 bits, padded to a
//      power of two P with all-ones keys that sort last (the xor maps int32
//      order onto uint32 order, so negative ids and INT32_MIN/MAX sort right);
//   2. a bitonic sort of the P keys: stages whose partner distance is under
//      kSortChunk run in shared memory, one block per chunk; wider ones run
//      as global compare-exchange passes (log2(P/kSortChunk) of them per
//      stage);
//   3. mark where each sorted run of equal ids starts, inclusive-scan the
//      marks into ranks (a block scan per 4096-key tile, then one block
//      that scans the tile sums);
//   4. scatter inv[slot] = rank, and uids[rank] = id where a run starts and
//      rank < size (uids were zeroed first).
//
// Bound: bytes.  The function must read K*4 bytes of ids and write K*4 of
// inv plus size*4 of uids, about 12*K bytes: 1.9 MB at K = 159,744, 0.57 us
// at 3.35 TB/s.  No sort reaches that bound: the bitonic sort makes
// log2(P)*(log2(P)+1)/2 compare-exchange passes (171 at P = 2^18), most of
// them in shared memory, about 36 launches in all.  Simple and right first;
// a radix sort with one global pass per 8 bits is the faster design.
//
// The result is exact: integer compares and integer scans only, bit-identical
// to the plain version (dedup_ids_plain in lightctr_tpu_torch/ops/
// sparse_kernels.py, torch.unique padded with 0) for any int32 stream.
//
// Plain C interface for ctypes; each entry returns the first CUDA error of
// its launches, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;
constexpr int kSortChunk = 2048;             // keys per shared-memory sort block
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kTile = kScanThreads * kScanItems;  // keys per scan block
constexpr u64 kPadKey = ~0ull;

__device__ __forceinline__ u64 make_key(int32_t id, unsigned slot) {
  return ((u64)((uint32_t)id ^ 0x80000000u) << 32) | (u64)slot;
}

__device__ __forceinline__ int32_t key_id(u64 key) {
  return (int32_t)((uint32_t)(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ unsigned key_slot(u64 key) {
  return (unsigned)(key & 0xffffffffull);
}

__device__ __forceinline__ bool run_starts(const u64* keys, long long i) {
  return i == 0 || (keys[i] >> 32) != (keys[i - 1] >> 32);
}

__global__ void make_keys(const int32_t* __restrict__ ids, long long k,
                          long long p, u64* __restrict__ keys) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride)
    keys[i] = i < k ? make_key(ids[i], (unsigned)i) : kPadKey;
}

// One compare-exchange stage (k, j) with j >= the shared chunk: pair t
// holds elements i and i + j, sorted ascending where bit k of i is clear.
__global__ void bitonic_global(u64* __restrict__ keys, long long p,
                               long long j, long long k) {
  const long long half = p >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < half; t += stride) {
    const long long i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    const long long l = i + j;
    const bool asc = (i & k) == 0;
    const u64 a = keys[i], b = keys[l];
    if ((a > b) == asc) {
      keys[i] = b;
      keys[l] = a;
    }
  }
}

// The stages whose partners lie within one chunk, in shared memory.
// k_merge == 0: sort each chunk from scratch (stages k = 2 .. chunk);
// otherwise finish stage k_merge (partner distances chunk/2 .. 1).
__global__ void bitonic_local(u64* __restrict__ keys, int chunk,
                              long long k_merge) {
  extern __shared__ u64 s[];
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
        const u64 a = s[i], b = s[l];
        if ((a > b) == asc) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int x = threadIdx.x; x < chunk; x += blockDim.x) keys[base + x] = s[x];
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
__global__ void rank_tiles(const u64* __restrict__ keys, long long k,
                           int* __restrict__ ranks,
                           int* __restrict__ tile_sums) {
  __shared__ int warp_sums[32];
  const long long first =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kScanItems;
  int v[kScanItems];
  for (int it = 0; it < kScanItems; ++it) {
    const long long i = first + it;
    v[it] = (i < k && run_starts(keys, i)) ? 1 : 0;
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

__global__ void scatter_ranks(const u64* __restrict__ keys, long long k,
                              long long size, const int* __restrict__ ranks,
                              const int* __restrict__ tile_offsets,
                              int32_t* __restrict__ uids,
                              int32_t* __restrict__ inv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += stride) {
    const u64 key = keys[i];
    const int rank = ranks[i] + tile_offsets[i / kTile] - 1;
    inv[key_slot(key)] = rank;
    if (rank < size && run_starts(keys, i)) uids[rank] = key_id(key);
  }
}

long long pow2_at_least(long long k) {
  long long p = 2;
  while (p < k) p <<= 1;
  return p;
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// Bytes of device scratch dedup_ids_i32 needs for k ids: the padded keys,
// the per-key tile ranks, the tile sums and the tile offsets.
extern "C" long long dedup_ids_workspace_bytes(long long k) {
  const long long n_tiles = (k + kTile - 1) / kTile;
  return pow2_at_least(k) * 8 + (k + 2 * n_tiles) * 4;
}

extern "C" int dedup_ids_i32(const void* ids, long long k, long long size,
                             void* uids, void* inv, void* count,
                             void* workspace, void* stream_ptr) {
  if (k <= 0) return (int)cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long p = pow2_at_least(k);
  const long long n_tiles = (k + kTile - 1) / kTile;
  u64* keys = static_cast<u64*>(workspace);
  int* ranks = reinterpret_cast<int*>(keys + p);
  int* tile_sums = ranks + k;
  int* tile_offsets = tile_sums + n_tiles;
  cudaError_t err;
  if (size > 0) {
    err = cudaMemsetAsync(uids, 0, (size_t)size * 4, stream);
    if (err != cudaSuccess) return (int)err;
  }
  make_keys<<<grid_for(p), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(ids), k, p, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int chunk = (int)(p < kSortChunk ? p : kSortChunk);
  const unsigned n_chunks = (unsigned)(p / chunk);
  const size_t smem = (size_t)chunk * sizeof(u64);
  bitonic_local<<<n_chunks, chunk / 2, smem, stream>>>(keys, chunk, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (long long kk = 2LL * chunk; kk <= p; kk <<= 1) {
    for (long long j = kk >> 1; j >= chunk; j >>= 1) {
      bitonic_global<<<grid_for(p / 2), kThreads, 0, stream>>>(keys, p, j, kk);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    bitonic_local<<<n_chunks, chunk / 2, smem, stream>>>(keys, chunk, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  rank_tiles<<<(unsigned)n_tiles, kScanThreads, 0, stream>>>(keys, k, ranks,
                                                            tile_sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_tile_sums<<<1, kScanThreads, 0, stream>>>(
      tile_sums, (int)n_tiles, tile_offsets, static_cast<int32_t*>(count));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scatter_ranks<<<grid_for(k), kThreads, 0, stream>>>(
      keys, k, size, ranks, tile_offsets, static_cast<int32_t*>(uids),
      static_cast<int32_t*>(inv));
  return (int)cudaGetLastError();
}
