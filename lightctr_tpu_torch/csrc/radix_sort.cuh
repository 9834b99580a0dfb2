// A stable LSD radix sort of (key, value) pairs in device memory, 8-bit
// digits, for 32- or 64-bit unsigned keys and 32-bit values: dedup_ids.cu
// sorts (id, slot) pairs with it.
//
// Before the passes, the caller's key pass (radix_note_key, one call a key)
// ORs every key and every key's complement into bits[0] and bits[1] (a bit
// varies iff it is set in both) and counts every digit of every key into
// totals[pass][digit].  Then each digit pass is ONE launch over tiles of
// kRadixTile keys (radix_onesweep):
//
//   - a tile takes its number from an atomic ticket, so every tile before
//     it has started;
//   - it counts its digits (warp ballots, __match_any_sync, over groups of
//     32 keys in input order), publishes its counts, then looks back over
//     the tiles before it for each digit's prefix (decoupled look-back: a
//     tile's word holds its count, then its inclusive prefix, with a flag);
//   - each key goes to the digit's start (an exclusive scan of the totals
//     over the digits) + the digit's prefix over the earlier tiles + its
//     rank among the tile's equal digits before it (per-warp counters
//     scanned across the warps in order), so the scatter is stable.
//
// A digit whose bits are the same in every key moves nothing: its pass
// returns at once, decided on the device, and the ping-pong buffer a pass
// reads is the parity of the varying digits below it (radix_src_buffer).
// No host sync, no allocation: a sort can be captured in a CUDA graph.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lct {

constexpr int kRadixThreads = 256;  // 8 warps
constexpr int kRadixItems = 8;      // keys a thread
constexpr int kRadixTile = kRadixThreads * kRadixItems;  // keys a tile
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kRadixBins = 256;

// the look-back word of a (tile, digit): flag in the top two bits
constexpr unsigned kRadixAggregate = 1u << 30;  // the tile's own count
constexpr unsigned kRadixInclusive = 2u << 30;  // count of tiles <= this
constexpr unsigned kRadixCountMask = (1u << 30) - 1u;

template <typename K>
struct RadixKey {
  static constexpr int kPasses = (int)sizeof(K);  // 8-bit digits
};

__device__ __forceinline__ unsigned long long radix_varying(
    const unsigned long long* bits) {
  return bits[0] & bits[1];
}

__device__ __forceinline__ bool radix_pass_moves(
    const unsigned long long* bits, int pass) {
  return ((radix_varying(bits) >> (8 * pass)) & 0xFFull) != 0;
}

// which of the two buffers pass `pass` reads (after the last pass: which
// holds the sorted pairs)
__device__ __forceinline__ int radix_src_buffer(
    const unsigned long long* bits, int pass) {
  const unsigned long long v = radix_varying(bits);
  int n = 0;
  for (int p = 0; p < pass; ++p) n += ((v >> (8 * p)) & 0xFFull) != 0;
  return n & 1;
}

template <typename K>
__device__ __forceinline__ int radix_digit(K key, int pass) {
  return (int)((key >> (8 * pass)) & (K)0xFF);
}

// Shared scratch of radix_note_key: per-pass digit counts and the block's
// OR words.  Zero it, __syncthreads, note every key, __syncthreads, then
// radix_flush_notes.
template <typename K>
struct RadixNotes {
  unsigned cnt[RadixKey<K>::kPasses][kRadixBins];
  unsigned long long bits[2];
};

template <typename K>
__device__ __forceinline__ void radix_zero_notes(RadixNotes<K>& nt) {
  unsigned* c = &nt.cnt[0][0];
  for (int i = threadIdx.x; i < RadixKey<K>::kPasses * kRadixBins;
       i += blockDim.x)
    c[i] = 0;
  if (threadIdx.x < 2) nt.bits[threadIdx.x] = 0;
}

// Note one key a lane (every lane of the warp calls it; `valid` lanes
// count): its digits into the block's counts, its bits into the ORs.
template <typename K>
__device__ __forceinline__ void radix_note_key(RadixNotes<K>& nt, K key,
                                               bool valid) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < RadixKey<K>::kPasses; ++p) {
    const int dg = valid ? radix_digit(key, p) : kRadixBins + lane;
    // a digit the whole warp shares (a constant digit) is one add;
    // otherwise each lane adds its own (shared-memory atomics)
    if (__all_sync(0xffffffffu, dg == __shfl_sync(0xffffffffu, dg, 0))) {
      if (lane == 0 && dg < kRadixBins) atomicAdd(&nt.cnt[p][dg], 32u);
    } else if (valid) {
      atomicAdd(&nt.cnt[p][dg], 1u);
    }
  }
  unsigned long long a = valid ? (unsigned long long)key : 0ull;
  unsigned long long b = valid ? (unsigned long long)(K)(~key) : 0ull;
  for (int o = 16; o > 0; o >>= 1) {
    a |= __shfl_xor_sync(0xffffffffu, a, o);
    b |= __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    atomicOr(&nt.bits[0], a);
    atomicOr(&nt.bits[1], b);
  }
}

// The block's notes into the global bits[2] and totals[pass][digit].
template <typename K>
__device__ __forceinline__ void radix_flush_notes(
    const RadixNotes<K>& nt, unsigned long long* bits, unsigned* totals) {
  const unsigned* c = &nt.cnt[0][0];
  for (int i = threadIdx.x; i < RadixKey<K>::kPasses * kRadixBins;
       i += blockDim.x)
    if (c[i]) atomicAdd(&totals[i], c[i]);
  if (threadIdx.x < 2 && nt.bits[threadIdx.x])
    atomicOr(&bits[threadIdx.x], nt.bits[threadIdx.x]);
}

// exclusive scan of one value a thread over the 256 threads of the block
__device__ __forceinline__ unsigned radix_block_exclusive(unsigned x,
                                                          unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + inc - x;
}

// One digit pass over one tile: warp w owns keys [w * 256, (w + 1) * 256)
// of the tile in 8 groups of 32, taken in order.  status: tiles * 256
// look-back words and ticket: one word, both zeroed before the pass.
template <typename K>
__global__ void __launch_bounds__(kRadixThreads)
    radix_onesweep(K* keys0, K* keys1, unsigned* vals0, unsigned* vals1,
                   long long n, int pass, const unsigned long long* bits,
                   const unsigned* __restrict__ totals, unsigned* status,
                   unsigned* ticket) {
  if (!radix_pass_moves(bits, pass)) return;
  __shared__ unsigned warp_off[kRadixWarps][kRadixBins];
  __shared__ unsigned warp_sums[kRadixWarps];
  __shared__ int tile_sh;
  if (threadIdx.x == 0) tile_sh = (int)atomicAdd(ticket, 1u);
  const unsigned total = totals[threadIdx.x];  // digit threadIdx.x's count
  const int src_buf = radix_src_buffer(bits, pass);
  const K* __restrict__ ksrc = src_buf ? keys1 : keys0;
  const unsigned* __restrict__ vsrc = src_buf ? vals1 : vals0;
  K* __restrict__ kdst = src_buf ? keys0 : keys1;
  unsigned* __restrict__ vdst = src_buf ? vals0 : vals1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int b = lane; b < kRadixBins; b += 32) warp_off[warp][b] = 0;
  __syncthreads();  // tile_sh
  const int tile = tile_sh;
  const long long seg = (long long)tile * kRadixTile +
                        (long long)warp * (32 * kRadixItems);

  K key[kRadixItems];
  unsigned val[kRadixItems];
  int dg[kRadixItems];
  unsigned peers[kRadixItems];
#pragma unroll
  for (int j = 0; j < kRadixItems; ++j) {
    const long long i = seg + j * 32 + lane;
    const bool valid = i < n;
    key[j] = valid ? ksrc[i] : (K)0;
    val[j] = valid ? vsrc[i] : 0u;
    dg[j] = valid ? radix_digit(key[j], pass) : kRadixBins + lane;
  }
#pragma unroll
  for (int j = 0; j < kRadixItems; ++j) {
    peers[j] = __match_any_sync(0xffffffffu, dg[j]);
    if (dg[j] < kRadixBins && lane == __ffs(peers[j]) - 1)
      warp_off[warp][dg[j]] += __popc(peers[j]);
    __syncwarp();
  }
  __syncthreads();

  // thread d: the tile's count of digit d, published; its prefix over the
  // earlier tiles by look-back, published inclusive; then the digit's
  // start, and the warps' counts scanned in warp order
  {
    const int d = threadIdx.x;
    unsigned count = 0;
    for (int w = 0; w < kRadixWarps; ++w) count += warp_off[w][d];
    volatile unsigned* st = status;
    const long long own = (long long)tile * kRadixBins + d;
    if (tile == 0) {
      st[own] = kRadixInclusive | count;
    } else {
      st[own] = kRadixAggregate | count;
    }
    // look back kLook tiles a round (their words loaded together), summing
    // counts down to the nearest inclusive prefix; spin on a word not yet
    // published
    constexpr int kLook = 8;
    unsigned prefix = 0;
    bool found = false;
    for (int t = tile - 1; t >= 0 && !found; t -= kLook) {
      unsigned word[kLook];
#pragma unroll
      for (int j = 0; j < kLook; ++j)
        word[j] = t - j >= 0 ? st[(long long)(t - j) * kRadixBins + d] : 0u;
#pragma unroll
      for (int j = 0; j < kLook; ++j) {
        if (found || t - j < 0) continue;
        while ((word[j] & ~kRadixCountMask) == 0)
          word[j] = st[(long long)(t - j) * kRadixBins + d];
        prefix += word[j] & kRadixCountMask;
        found = (word[j] & kRadixInclusive) != 0;
      }
    }
    if (tile > 0) st[own] = kRadixInclusive | (prefix + count);
    unsigned start = radix_block_exclusive(total, warp_sums) + prefix;
    for (int w = 0; w < kRadixWarps; ++w) {
      const unsigned c = warp_off[w][d];
      warp_off[w][d] = start;
      start += c;
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kRadixItems; ++j) {
    const bool valid = dg[j] < kRadixBins;
    unsigned pos = 0;
    if (valid) pos = warp_off[warp][dg[j]] + __popc(peers[j] & lt_mask);
    __syncwarp();
    if (valid) {
      kdst[pos] = key[j];
      vdst[pos] = val[j];
      if (lane == __ffs(peers[j]) - 1)
        warp_off[warp][dg[j]] += __popc(peers[j]);
    }
    __syncwarp();
  }
}

inline long long radix_tiles(long long n) {
  return (n + kRadixTile - 1) / kRadixTile;
}

// Sort the pairs (keys0, vals0) of n; (keys1, vals1) is the other buffer
// of the ping-pong.  bits and totals as radix_flush_notes left them;
// status: passes * tiles * 256 words and tickets: passes words, zeroed.
// The result lies in buffer radix_src_buffer(bits, passes).  Returns the
// first launch error.
template <typename K>
cudaError_t radix_sort_pairs(K* keys0, K* keys1, unsigned* vals0,
                             unsigned* vals1, long long n,
                             const unsigned long long* bits,
                             const unsigned* totals, unsigned* status,
                             unsigned* tickets, cudaStream_t stream) {
  const long long tiles = radix_tiles(n);
  for (int p = 0; p < RadixKey<K>::kPasses; ++p) {
    radix_onesweep<K><<<(unsigned)tiles, kRadixThreads, 0, stream>>>(
        keys0, keys1, vals0, vals1, n, p, bits, totals + p * kRadixBins,
        status + p * tiles * kRadixBins, tickets + p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace lct
