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
//   1. keys: uint(id) ^ sign bit, 32 bits for int32 ids and 64 for int64
//      (the xor maps signed order onto unsigned order, so negative ids and
//      the type's limits sort right), the slot as the value; the same pass
//      learns which bits vary and counts every digit;
//   2. a stable LSD radix sort of the (key, slot) pairs on 8-bit digits
//      (radix_sort.cuh): 4 passes for int32 ids, 8 for int64, each one
//      launch that counts, looks back over the earlier tiles and scatters
//      stably.  A digit that is the same in every id moves nothing and its
//      pass returns at once, decided on the device: the Criteo ids (20
//      varying bits) scatter 3 times at either width.  Stability keeps
//      the slots ascending within an id, the order the (id, slot) keys of
//      a comparison sort gave;
//   3. one launch over tiles of 4096 sorted keys: mark where each run of
//      equal ids starts, scan the marks (a block scan, then a decoupled
//      look-back over the earlier tiles for the tile's first rank), and
//      scatter inv[slot] = rank, and uids[rank] = id where a run starts
//      and rank < size (uids were zeroed first); the last tile writes the
//      count.
//
// Bound: bytes.  The function must read K*w bytes of ids (w = 4 or 8) and
// write K*4 of inv plus size*w of uids: about 12*K bytes for int32 ids,
// 1.9 MB at K = 159,744, 0.57 us at 3.35 TB/s.  The sort moves its (key,
// slot) pairs twice a varying digit, 2.6 MB (int32) or 3.8 MB (int64) at
// that K, in one launch a digit; the host sees no sync and nothing is
// allocated, so the whole dedup can be captured in a CUDA graph.
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

#include "radix_sort.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kTile = kScanThreads * kScanItems;  // keys per scan block
constexpr int kKeyThreads = 256;

// The key of one id width: the id's bits with the sign flipped, and back.
template <typename Id>
struct KeyOf;

template <>
struct KeyOf<int32_t> {
  typedef uint32_t K;
  __device__ static K make(int32_t id) { return (uint32_t)id ^ 0x80000000u; }
  __device__ static int32_t id(K k) { return (int32_t)(k ^ 0x80000000u); }
};

template <>
struct KeyOf<int64_t> {
  typedef u64 K;
  __device__ static K make(int64_t id) { return (u64)id ^ (1ull << 63); }
  __device__ static int64_t id(K k) { return (int64_t)(k ^ (1ull << 63)); }
};

template <typename K>
__device__ __forceinline__ bool run_starts(const K* keys, long long i) {
  return i == 0 || keys[i] != keys[i - 1];
}

// keys and slots, and the radix sort's notes: which bits vary, and every
// digit's count
template <typename Id>
__global__ void __launch_bounds__(kKeyThreads)
    make_keys(const Id* __restrict__ ids, long long k,
              typename KeyOf<Id>::K* __restrict__ keys,
              unsigned* __restrict__ slots, u64* __restrict__ bits,
              unsigned* __restrict__ totals) {
  typedef typename KeyOf<Id>::K K;
  __shared__ lct::RadixNotes<K> notes;
  lct::radix_zero_notes(notes);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of rounds (the notes
  // shuffle across the warp)
  const long long rounds = (k + stride - 1) / stride;
  for (long long r = 0; r < rounds; ++r) {
    const long long i =
        r * stride + (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool valid = i < k;
    K key = 0;
    if (valid) {
      key = KeyOf<Id>::make(ids[i]);
      keys[i] = key;
      slots[i] = (unsigned)i;
    }
    lct::radix_note_key(notes, key, valid);
  }
  __syncthreads();
  lct::radix_flush_notes(notes, bits, totals);
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

// the buffer of the ping-pong that holds the sorted pairs
template <typename K>
__device__ __forceinline__ int sorted_buffer(const u64* bits) {
  return lct::radix_src_buffer(bits, lct::RadixKey<K>::kPasses);
}

// Ranks and scatter, one launch: a tile of kTile sorted keys (numbered by
// a ticket) marks where runs of equal ids start and scans the marks; its
// run count is published and the tiles before it are looked back over
// (decoupled look-back, one warp, 32 tiles a round) for its first rank.
// Then inv[slot] = rank, and uids[rank] = id where a run starts and rank
// < size; the last tile writes the count.  status: tiles words and ticket:
// one word, zeroed.
template <typename Id>
__global__ void __launch_bounds__(kScanThreads)
    rank_scatter(const typename KeyOf<Id>::K* keys0,
                 const typename KeyOf<Id>::K* keys1, const unsigned* slots0,
                 const unsigned* slots1, const u64* bits, long long k,
                 long long size, unsigned* status, unsigned* ticket,
                 Id* __restrict__ uids, int32_t* __restrict__ inv,
                 int32_t* __restrict__ count) {
  typedef typename KeyOf<Id>::K K;
  __shared__ int warp_sums[32];
  __shared__ int tile_sh;
  __shared__ unsigned prefix_sh;
  if (threadIdx.x == 0) tile_sh = (int)atomicAdd(ticket, 1u);
  const int buf = sorted_buffer<K>(bits);
  const K* keys = buf ? keys1 : keys0;
  const unsigned* slots = buf ? slots1 : slots0;
  __syncthreads();
  const int tile = tile_sh;
  const long long first =
      (long long)tile * kTile + (long long)threadIdx.x * kScanItems;
  int v[kScanItems];
  bool start[kScanItems];
  for (int it = 0; it < kScanItems; ++it) {
    const long long i = first + it;
    start[it] = i < k && run_starts(keys, i);
    v[it] = start[it] ? 1 : 0;
  }
  const int total = block_inclusive_scan<kScanItems>(v, warp_sums);

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    volatile unsigned* st = status;
    if (lane == 0)
      st[tile] = (tile == 0 ? lct::kRadixInclusive : lct::kRadixAggregate) |
                 (unsigned)total;
    unsigned prefix = 0;
    for (int t = tile - 1; t >= 0; t -= 32) {
      const int idx = t - lane;
      unsigned word = lct::kRadixInclusive;
      if (idx >= 0) word = st[idx];
      while (!__all_sync(0xffffffffu, (word & ~lct::kRadixCountMask) != 0))
        if ((word & ~lct::kRadixCountMask) == 0) word = st[idx];
      const unsigned incl =
          __ballot_sync(0xffffffffu, (word & lct::kRadixInclusive) != 0);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      unsigned part = lane <= stop ? (word & lct::kRadixCountMask) : 0u;
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      prefix += part;
      if (incl) break;
    }
    if (lane == 0) {
      if (tile > 0) st[tile] = lct::kRadixInclusive | (prefix + total);
      prefix_sh = prefix;
      if ((long long)(tile + 1) * kTile >= k)
        *count = (int32_t)(prefix + total);
    }
  }
  __syncthreads();
  const int base = (int)prefix_sh - 1;
  for (int it = 0; it < kScanItems; ++it) {
    const long long i = first + it;
    if (i >= k) break;
    const int rank = base + v[it];
    inv[slots[i]] = rank;
    if (start[it] && rank < size) uids[rank] = KeyOf<Id>::id(keys[i]);
  }
}

inline unsigned grid_for(long long n, int threads, long long cap) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks > cap ? cap : blocks);
}

// The workspace, in order: the radix sort's varying-bits words, digit
// totals, look-back words and tile tickets, the rank stage's look-back
// words and ticket (all zeroed together), the two key buffers and the two
// slot buffers.
template <typename Id>
struct Workspace {
  typedef typename KeyOf<Id>::K K;
  static constexpr int kPasses = lct::RadixKey<K>::kPasses;
  u64* bits;
  unsigned* totals;
  unsigned* status;
  unsigned* tickets;
  unsigned* rank_status;
  unsigned* rank_ticket;
  K* keys[2];
  unsigned* slots[2];
  size_t zeroed;  // bytes from bits through rank_ticket
  size_t bytes;

  Workspace(void* base, long long k) {
    const long long n_tiles = (k + kTile - 1) / kTile;
    char* p = static_cast<char*>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      char* at = p ? p + off : nullptr;
      off += (n + 15) & ~(size_t)15;
      return at;
    };
    bits = reinterpret_cast<u64*>(take(2 * sizeof(u64)));
    totals = reinterpret_cast<unsigned*>(
        take(kPasses * lct::kRadixBins * sizeof(unsigned)));
    status = reinterpret_cast<unsigned*>(take(
        kPasses * lct::radix_tiles(k) * lct::kRadixBins * sizeof(unsigned)));
    tickets = reinterpret_cast<unsigned*>(take(kPasses * sizeof(unsigned)));
    rank_status =
        reinterpret_cast<unsigned*>(take(n_tiles * sizeof(unsigned)));
    rank_ticket = reinterpret_cast<unsigned*>(take(sizeof(unsigned)));
    zeroed = off;
    keys[0] = reinterpret_cast<K*>(take(k * sizeof(K)));
    keys[1] = reinterpret_cast<K*>(take(k * sizeof(K)));
    slots[0] = reinterpret_cast<unsigned*>(take(k * sizeof(unsigned)));
    slots[1] = reinterpret_cast<unsigned*>(take(k * sizeof(unsigned)));
    bytes = off;
  }
};

template <typename Id>
long long workspace_bytes(long long k) {
  return (long long)Workspace<Id>(nullptr, k).bytes;
}

template <typename Id>
int dedup(const Id* ids, long long k, long long size, Id* uids,
          int32_t* inv, int32_t* count, void* workspace,
          cudaStream_t stream) {
  typedef typename KeyOf<Id>::K K;
  if (k <= 0) return (int)cudaSuccess;
  Workspace<Id> ws(workspace, k);
  const long long n_tiles = (k + kTile - 1) / kTile;
  cudaError_t err;
  if (size > 0) {
    err = cudaMemsetAsync(uids, 0, (size_t)size * sizeof(Id), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if ((err = cudaMemsetAsync(ws.bits, 0, ws.zeroed, stream)) != cudaSuccess)
    return (int)err;
  // about two key blocks an SM: each flushes its digit counts with atomics
  make_keys<Id><<<grid_for(k, kKeyThreads, 256), kKeyThreads, 0, stream>>>(
      ids, k, ws.keys[0], ws.slots[0], ws.bits, ws.totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = lct::radix_sort_pairs<K>(ws.keys[0], ws.keys[1], ws.slots[0],
                                      ws.slots[1], k, ws.bits, ws.totals,
                                      ws.status, ws.tickets, stream)) !=
      cudaSuccess)
    return (int)err;
  rank_scatter<Id><<<(unsigned)n_tiles, kScanThreads, 0, stream>>>(
      ws.keys[0], ws.keys[1], ws.slots[0], ws.slots[1], ws.bits, k, size,
      ws.rank_status, ws.rank_ticket, uids, inv, count);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device scratch a dedup of k ids needs (wide: int64 ids): the
// radix sort's two (key, slot) buffers, its varying bits, digit totals,
// look-back words and tickets, and the rank stage's look-back words.
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
