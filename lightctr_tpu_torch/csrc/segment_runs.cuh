// segment_runs: the slot-order segment merge on a radix sort, shared by
// merge_rows.cu (B4, the merge alone) and merge_apply.cu's merge mode (B5,
// the merge fused into the touched-row Adagrad)
//
//   sum[s] = ((+0 + rows[i0]) + rows[i1]) + ...   over the slots i0 < i1 < ...
//            with inv[i] == s, for every s in [0, nseg); slots whose inv
//            lies outside [0, nseg), negative ones included, are dropped,
//            and so are rows whose every value is +-0.
//
// The TPU kernels this serves (lightctr_tpu/ops/sparse_kernels.py
// _merge_pallas and _merge_apply_pallas) add each segment's rows in slot
// order because a TPU grid runs in order on one core.  Blocks run in
// parallel here and a float atomicAdd adds in no fixed order, so the merge
// sorts and keeps the order:
//
//   1. the key pass (seg_keys, one launch): key uint32(inv[i]) for a kept
//      slot and nseg for a dropped or all-zero one, the slot as the value.
//      The dropped slots sort last, and with every key <= nseg the digits
//      above nseg's top bit are the same in every key.  A warp tests its
//      32 rows for all-zero with coalesced (float4) loads.  The same launch
//      notes the radix sort's varying bits and digit counts, and flags each
//      segment that receives a kept row.
//   2. radix_sort_pairs<uint32_t> (radix_sort.cuh): a stable LSD sort on
//      8-bit digits that skips a constant digit on the device, so each
//      segment's slots come out together in increasing slot order.  At
//      nseg < 2^24 the top digit never moves: 3 passes at nseg = 159,744.
//   3. the run walkers (two launches over the same tiles of sorted
//      positions).  walk_runs: a block finds where the key changes in its
//      tile (a block ballot) and gives each (run, column) pair to one
//      thread, which adds the run's rows in slot order from +0
//      (__fadd_rn).  The tile shrinks as the row widens (walk_tile): at
//      d = 1 a thread takes runs, at d = 32 a warp takes a run, one lane
//      a column, never one lane of a warp alone.  A thread holds
//      kWalkUnroll items' loads in flight together (the epilogue's and the
//      first row's), since the walk is a chain of latency, not of bytes,
//      and kWalkBatch rows ahead.  A run longer than kWalkLong it leaves
//      to walk_long and puts on the run list instead: (first sorted
//      position, end, key, its rank among the long runs that start in the
//      tile), in the bucket of its length's top bit, with a count a bucket
//      (atomicAdd; the list's order within a bucket is any).  walk_long:
//      kLongBlocks walker blocks each take a ticket (atomicAdd), which
//      names the next unclaimed run, the longest buckets first, walk it,
//      then take the next ticket, so no walker starts a second run while
//      one is unclaimed, and the longest runs start first.  The walk of
//      a run is the whole block's: chunk by chunk staged in shared memory
//      by every thread (the next chunk's loads in flight during this
//      chunk's adds) and added by one thread a column; its own launch,
//      since its registers would cost walk_runs its occupancy.  Its
//      critical path is about max(longest run, long-run slots / walkers):
//      the Criteo layout's 13 numeric fields, one whole-batch run each,
//      go to 13 walkers, where a fixed assignment of tiles to blocks had
//      put several on one.  Either way each column's adds stay serial in
//      slot order: that order is the contract, and the schedule changes no
//      bit.  Long runs are real input: in the coded exchange the dedup
//      padding decodes to rows that are not zero, one run of about half
//      the gathered rows.  The epilogue (Epi) stores the sum (B4) or
//      applies Adagrad with it (B5); walk_runs also hands it a +0 sum for
//      each segment of its tile that received no kept row (the flags), so
//      B4's output needs no memset and B5 gives such a segment the plain
//      version's update.
//
// B5's sum of squares is a double a walk_runs tile (its place: the tile)
// and a double a long run, at a place fixed by the run and not by the
// walker that took it: after the tiles' doubles, kTileLongRuns places a
// tile, the run's rank among the long runs that start in its tile.
// walk_runs notes each tile's count of long runs; sum_partials then adds,
// tile by tile, the tile's double and its long runs' in rank order, so the
// sum is the same from call to call whatever walker took what.
//
// Each launch leaves in the workspace's first words the run list's bucket
// counts, the ticket, and three counters: the long runs walked, the most
// slots one walker took and the longest run's slots (kRunWords;
// ops/sparse_kernels.py's long_run_stats reads them on request).
//
// Leaving out the all-zero rows changes no bit: a sum that starts at +0.0
// and adds in round-to-nearest is never -0.0, and adding +-0 to any such
// value returns it unchanged.  It matters for speed: the allgather
// exchange's gathered payload holds every rank's dedup padding (zero rows,
// about half of the rows), which would otherwise make one long run.
//
// No host sync and no allocation: the caller hands in one workspace
// (SegRunsWorkspace), and the whole merge can be captured in a CUDA graph.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "radix_sort.cuh"

namespace lct {

constexpr int kSegKeyThreads = 256;
constexpr int kSegKeyMaxBlocks = 256;  // about two an SM: each flushes notes
constexpr int kSegKeyLoads = 8;        // a lane's row loads in flight
constexpr int kWalkThreads = 256;
constexpr int kWalkMinBlocks = 4;      // resident walker blocks an SM asks for
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kWalkItems = 2048;  // (run, column) items a walker block aims at
constexpr int kWalkUnroll = 2;    // items a thread has in flight together
constexpr int kWalkBatch = 8;     // a run's slots whose loads are in flight
constexpr int kWalkLong = 2 * kWalkBatch;  // longer runs: walk_long's
constexpr int kLongFloats = 8192;  // a long run's values staged at once
constexpr int kLongPer = kLongFloats / kWalkThreads;  // a thread's share
constexpr int kLongAdds = 8;  // a long run's values read ahead of their adds
constexpr int kLongBlocks = 128;  // walk_long's walkers
// long runs that can start in one tile: all but the last lie in the tile
constexpr int kTileLongRuns = (kWalkThreads - 1) / (kWalkLong + 1) + 1;
// the run list's buckets, by the top bit of a run's length (from
// kFirstBucket: a long run has more than kWalkLong slots)
constexpr int kRunBuckets = 32;
constexpr int kFirstBucket = 4;
static_assert((1 << kFirstBucket) <= kWalkLong + 1 &&
                  (2 << kFirstBucket) > kWalkLong + 1,
              "a long run's length has its top bit at kFirstBucket or above");
// the workspace's first words: a count a bucket, the ticket, then the
// counters (long runs walked, most slots one walker took, longest run)
constexpr int kRunTicket = kRunBuckets;
constexpr int kRunsWalked = kRunBuckets + 1;
constexpr int kBusiestWalker = kRunBuckets + 2;
constexpr int kLongestRun = kRunBuckets + 3;
constexpr int kRunWords = kRunBuckets + 4;

// Sorted positions (and segments) a walker block takes at row width d.
inline int walk_tile(long long d) {
  long long t = kWalkItems / (d < 1 ? 1 : d);
  if (t > kWalkThreads) t = kWalkThreads;
  if (t < 8) t = 8;
  return (int)t;
}

// Walker blocks: tiles over the m sorted positions and the nseg segments.
inline long long walk_blocks(long long m, long long nseg, long long d) {
  const long long n = nseg > m ? nseg : m;
  const long long tile = walk_tile(d);
  return (n + tile - 1) / tile;
}

// The doubles the walkers' epilogue may sum into: one a walk_runs tile,
// then kTileLongRuns a tile for its long runs.
inline long long walk_partials(long long m, long long nseg, long long d) {
  return walk_blocks(m, nseg, d) * (1 + kTileLongRuns);
}

// The run list's first entry of bucket k: the buckets below it hold at
// most m >> j runs each, since a run there has at least 2^j slots.
__host__ __device__ inline long long run_bucket_at(long long m, int k) {
  long long at = 0;
  for (int j = kFirstBucket; j < k; ++j) at += m >> j;
  return at;
}

// The workspace, in order: the run list's words (kRunWords), the radix
// sort's varying-bits words, digit totals, look-back words and tile
// tickets, and the segment flags (all zeroed together); then a walker
// tile's count of long runs, the run list, the two key and the two slot
// buffers and, for an epilogue that sums a double (the fused apply's sum
// of squares), the walkers' doubles (walk_partials).
struct SegRunsWorkspace {
  unsigned* runs;
  unsigned long long* bits;
  unsigned* totals;
  unsigned* status;
  unsigned* tickets;
  unsigned char* has_rows;
  unsigned char* long_runs;
  uint4* run_list;
  uint32_t* keys[2];
  unsigned* vals[2];
  double* partials;
  size_t zeroed;  // bytes from runs through has_rows
  size_t bytes;

  SegRunsWorkspace(void* base, long long m, long long nseg, long long d,
                   bool with_partials) {
    constexpr int kPasses = RadixKey<uint32_t>::kPasses;
    char* p = static_cast<char*>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      char* at = p ? p + off : nullptr;
      off += (n + 15) & ~(size_t)15;
      return at;
    };
    runs = reinterpret_cast<unsigned*>(take(kRunWords * sizeof(unsigned)));
    bits = reinterpret_cast<unsigned long long*>(
        take(2 * sizeof(unsigned long long)));
    totals = reinterpret_cast<unsigned*>(
        take(kPasses * kRadixBins * sizeof(unsigned)));
    status = reinterpret_cast<unsigned*>(
        take(kPasses * radix_tiles(m) * kRadixBins * sizeof(unsigned)));
    tickets = reinterpret_cast<unsigned*>(take(kPasses * sizeof(unsigned)));
    has_rows = reinterpret_cast<unsigned char*>(take(nseg));
    zeroed = off;
    long_runs = reinterpret_cast<unsigned char*>(take(walk_blocks(m, nseg, d)));
    run_list = reinterpret_cast<uint4*>(
        take(run_bucket_at(m, kRunBuckets) * sizeof(uint4)));
    keys[0] = reinterpret_cast<uint32_t*>(take(m * sizeof(uint32_t)));
    keys[1] = reinterpret_cast<uint32_t*>(take(m * sizeof(uint32_t)));
    vals[0] = reinterpret_cast<unsigned*>(take(m * sizeof(unsigned)));
    vals[1] = reinterpret_cast<unsigned*>(take(m * sizeof(unsigned)));
    partials = reinterpret_cast<double*>(take(
        with_partials ? walk_partials(m, nseg, d) * sizeof(double) : 0));
    bytes = off;
  }
};

// 1. keys, slots, segment flags and the radix sort's notes.  Each warp
// first reads its 32 consecutive rows together (coalesced, float4 when the
// rows allow) and marks the rows that hold a value other than +-0 (NaN
// compares unequal to 0, so it is kept).
static __global__ void __launch_bounds__(kSegKeyThreads)
    seg_keys(const int32_t* __restrict__ inv, const float* __restrict__ rows,
             long long m, long long d, long long nseg, bool vec4,
             uint32_t* __restrict__ keys, unsigned* __restrict__ vals,
             unsigned char* __restrict__ has_rows,
             unsigned long long* __restrict__ bits,
             unsigned* __restrict__ totals) {
  __shared__ RadixNotes<uint32_t> notes;
  __shared__ unsigned nonzero[kSegKeyThreads];
  radix_zero_notes(notes);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int wbase = threadIdx.x - lane;  // the warp's first slot in the block
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of rounds (the notes
  // shuffle across the warp)
  const long long rounds = (m + stride - 1) / stride;
  for (long long r = 0; r < rounds; ++r) {
    const long long w0 =
        r * stride + (long long)blockIdx.x * blockDim.x + wbase;
    const long long i = w0 + lane;
    nonzero[threadIdx.x] = 0;
    __syncwarp();
    const int wn = m - w0 >= 32 ? 32 : (m > w0 ? (int)(m - w0) : 0);
    if (vec4) {
      const float4* src = reinterpret_cast<const float4*>(rows + w0 * d);
      const unsigned per = (unsigned)(d / 4), n = (unsigned)wn * per;
      for (unsigned j0 = lane; j0 < n; j0 += 32 * kSegKeyLoads) {
        float4 x[kSegKeyLoads];
#pragma unroll
        for (int t = 0; t < kSegKeyLoads; ++t)
          x[t] = j0 + 32 * t < n ? __ldg(src + j0 + 32 * t)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int t = 0; t < kSegKeyLoads; ++t)
          if (x[t].x != 0.0f || x[t].y != 0.0f || x[t].z != 0.0f ||
              x[t].w != 0.0f)
            nonzero[wbase + (j0 + 32 * t) / per] = 1u;
      }
    } else {
      const float* src = rows + w0 * d;
      const unsigned dd = (unsigned)d, n = (unsigned)wn * dd;
      for (unsigned j0 = lane; j0 < n; j0 += 32 * kSegKeyLoads) {
        float x[kSegKeyLoads];
#pragma unroll
        for (int t = 0; t < kSegKeyLoads; ++t)
          x[t] = j0 + 32 * t < n ? __ldg(src + j0 + 32 * t) : 0.0f;
#pragma unroll
        for (int t = 0; t < kSegKeyLoads; ++t)
          if (x[t] != 0.0f) nonzero[wbase + (j0 + 32 * t) / dd] = 1u;
      }
    }
    __syncwarp();
    const bool valid = i < m;
    uint32_t key = 0;
    if (valid) {
      const long long seg = inv[i];
      const bool keep = seg >= 0 && seg < nseg && nonzero[threadIdx.x];
      key = keep ? (uint32_t)seg : (uint32_t)nseg;
      keys[i] = key;
      vals[i] = (unsigned)i;
      if (keep) has_rows[seg] = 1;
    }
    radix_note_key(notes, key, valid);
  }
  __syncthreads();
  radix_flush_notes(notes, bits, totals);
}

// first position q in [lo, m) whose key is not `key`, where keys[lo - 1]
// is `key` and the keys are sorted: one probe of 32 positions by the warp,
// then a binary search by lane 0 (a long run); every lane gets the answer
__device__ __forceinline__ long long run_end(const uint32_t* keys,
                                             long long lo, long long m,
                                             uint32_t key) {
  const int lane = threadIdx.x & 31;
  const long long q = lo + lane;
  const unsigned differs =
      __ballot_sync(0xffffffffu, q >= m || __ldg(keys + q) != key);
  if (differs) return lo + __ffs(differs) - 1;
  long long end = m;
  if (lane == 0) {
    long long a = lo + 32, b = m;  // keys[a - 1] == key; the end is in [a, b]
    while (a < b) {
      const long long mid = a + (b - a) / 2;
      if (__ldg(keys + mid) == key) a = mid + 1;
      else b = mid;
    }
    end = a;
  }
  return __shfl_sync(0xffffffffu, end, 0);
}

// The runs of walker tile `blockIdx.x` (sorted positions [t0, t0 + tile)):
// the positions where the key changes (a run of kept slots starts there,
// or the dropped slots do), compacted in order into bpos / bkey, with
// bpos[nb] the end of the last run, which may go on past the tile (not the
// dropped slots: nothing reads their end); and the tile's slots.  Every
// thread gets nb.
__device__ __forceinline__ int tile_runs(const uint32_t* keys,
                                         const unsigned* vals, long long m,
                                         long long nseg, int tile,
                                         long long t0, long long* bpos,
                                         uint32_t* bkey, unsigned* tslot,
                                         int* wcount) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = t0 + tid;
  bool bnd = false;
  uint32_t key = 0;
  if (tid < tile && i < m) {
    key = __ldg(keys + i);
    bnd = i == 0 || __ldg(keys + i - 1) != key;
    tslot[tid] = __ldg(vals + i);
  }
  const unsigned bal = __ballot_sync(0xffffffffu, bnd);
  if (lane == 0) wcount[warp] = __popc(bal);
  __syncthreads();
  int off = 0, nb = 0;
  for (int w = 0; w < kWalkWarps; ++w) {
    off += w < warp ? wcount[w] : 0;
    nb += wcount[w];
  }
  if (bnd) {
    const int p = off + __popc(bal & ((1u << lane) - 1u));
    bpos[p] = i;
    bkey[p] = key;
  }
  __syncthreads();
  if (warp == 0 && nb > 0) {
    long long end = m;
    const long long lo = t0 + tile;
    if (bkey[nb - 1] < nseg && lo < m) end = run_end(keys, lo, m, bkey[nb - 1]);
    if (lane == 0) bpos[nb] = end;
  }
  __syncthreads();
  return nb;
}

// A run of kept slots that walk_long takes (whole blocks) and walk_runs
// leaves alone.
__device__ __forceinline__ bool long_run(const long long* bpos,
                                         const uint32_t* bkey, int b,
                                         long long nseg) {
  return bkey[b] < nseg && bpos[b + 1] - bpos[b] > kWalkLong;
}

// Put the long run [start, end) of `key`, the rank-th long run of its
// tile, on the run list, in the bucket of its length's top bit.
__device__ __forceinline__ void push_run(unsigned* runs, uint4* run_list,
                                         long long m, long long start,
                                         long long end, uint32_t key,
                                         int rank) {
  const unsigned long long len = (unsigned long long)(end - start);
  const int k = 63 - __clzll((long long)len);
  const unsigned at = atomicAdd(runs + k, 1u);
  run_list[run_bucket_at(m, k) + at] =
      make_uint4((unsigned)start, (unsigned)end, key, (unsigned)rank);
  atomicMax(runs + kLongestRun, (unsigned)len);
}

// 3a. the run walker.  Epi: skip(seg) is true for a segment the epilogue
// leaves alone whatever its sum; begin(seg, c) loads what the epilogue
// needs of (segment, column) before the sum; put(ctx, sum) finishes it and
// returns its share of the double (0 when it has none); finish(x, at) is
// called by every thread with its total, `at` the double's place among
// walk_partials: blockIdx.x here, a long run's own place in walk_long.
template <class Epi>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks)
    walk_runs(const uint32_t* keys0, const uint32_t* keys1,
              const unsigned* vals0, const unsigned* vals1,
              const unsigned long long* bits, long long m, long long nseg,
              const float* __restrict__ rows, int d, int tile,
              const unsigned char* __restrict__ has_rows,
              unsigned char* __restrict__ long_runs, unsigned* runs,
              uint4* __restrict__ run_list, Epi epi) {
  typedef decltype(epi.begin(0ll, 0)) Ctx;
  __shared__ long long bpos[kWalkThreads + 1];
  __shared__ uint32_t bkey[kWalkThreads];
  __shared__ unsigned tslot[kWalkThreads];  // the tile's slots, sorted
  __shared__ int wcount[kWalkWarps];
  __shared__ int gap[kWalkWarps][32];
  const int buf = m > 0 ? radix_src_buffer(bits, RadixKey<uint32_t>::kPasses)
                        : 0;
  const uint32_t* keys = buf ? keys1 : keys0;
  const unsigned* vals = buf ? vals1 : vals0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * tile;
  const int nb = tile_runs(keys, vals, m, nseg, tile, t0, bpos, bkey, tslot,
                           wcount);

  // the tile's long runs onto the run list, each with its rank among them,
  // and their count (the order sum_partials adds their doubles in)
  {
    const bool is_long = tid < nb && long_run(bpos, bkey, tid, nseg);
    const unsigned bal = __ballot_sync(0xffffffffu, is_long);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int rank = __popc(bal & ((1u << lane) - 1u)), n_long = 0;
    for (int w = 0; w < kWalkWarps; ++w) {
      rank += w < warp ? wcount[w] : 0;
      n_long += wcount[w];
    }
    if (tid == 0) long_runs[blockIdx.x] = (unsigned char)n_long;
    if (is_long)
      push_run(runs, run_list, m, bpos[tid], bpos[tid + 1], bkey[tid], rank);
  }

  // each (run, column) item: the run's rows added in slot order from +0.
  // A thread takes kWalkUnroll items at once: their epilogue loads and
  // their first rows are all in flight before any sum
  double total = 0.0;
  const int n_items = nb * d;
  for (int base = tid; base < n_items; base += kWalkUnroll * kWalkThreads) {
    Ctx ctx[kWalkUnroll];
    float first[kWalkUnroll];
    long long next[kWalkUnroll], end[kWalkUnroll];
    int col[kWalkUnroll];
    bool on[kWalkUnroll];
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      const int item = base + u * kWalkThreads;
      const int b = item / d, c = item - b * d;
      // not the dropped slots, nor a long run (walk_long's)
      on[u] = item < n_items && bkey[b] < nseg &&
              !long_run(bpos, bkey, b, nseg);
      if (on[u]) {
        const long long j = bpos[b];
        ctx[u] = epi.begin(bkey[b], c);
        first[u] = __ldg(rows + (long long)tslot[j - t0] * d + c);
        next[u] = j + 1;
        end[u] = bpos[b + 1];
        col[u] = c;
      }
    }
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      if (!on[u]) continue;
      float acc = __fadd_rn(0.0f, first[u]);
      const int c = col[u];
      for (long long j = next[u]; j < end[u]; j += kWalkBatch) {
        unsigned slot[kWalkBatch];
        float v[kWalkBatch];
#pragma unroll
        for (int t = 0; t < kWalkBatch; ++t) {
          const long long q = j + t;
          slot[t] = q >= end[u] ? 0u
                    : q - t0 < tile ? tslot[q - t0] : __ldg(vals + q);
        }
#pragma unroll
        for (int t = 0; t < kWalkBatch; ++t)
          v[t] = j + t < end[u] ? __ldg(rows + (long long)slot[t] * d + c)
                                : 0.0f;
#pragma unroll
        for (int t = 0; t < kWalkBatch; ++t)
          if (j + t < end[u]) acc = __fadd_rn(acc, v[t]);
      }
      total += epi.put(ctx[u], acc);
    }
  }
  // the tile's segments that received no kept row get a +0 sum, as the
  // plain merge leaves them: each warp scans 32 segments at once, then
  // hands out their (segment, column) items
  const long long ns = nseg - t0 < tile ? nseg - t0 : tile;
  for (int s0 = warp * 32; s0 < ns; s0 += kWalkThreads) {
    const long long seg = t0 + s0 + lane;
    bool need = false;
    if (s0 + lane < ns) {
      const bool skip = epi.skip(seg);  // loads beside the flag's
      need = !has_rows[seg] & !skip;
    }
    const unsigned want = __ballot_sync(0xffffffffu, need);
    if (need) gap[warp][__popc(want & ((1u << lane) - 1u))] = s0 + lane;
    __syncwarp();
    const int n = __popc(want) * d;
    for (int item = lane; item < n; item += 32) {
      const int g = item / d, c = item - g * d;
      total += epi.put(epi.begin(t0 + gap[warp][g], c), 0.0f);
    }
    __syncwarp();
  }
  epi.finish(total, blockIdx.x);
}

// The next unclaimed long run for the ticket thread 0 takes: the longest
// buckets first (`count` a bucket, in shared memory); an empty run once
// every run is claimed.
__device__ __forceinline__ uint4 claim_run(unsigned* runs,
                                           const uint4* run_list,
                                           long long m,
                                           const unsigned* count) {
  unsigned t = atomicAdd(runs + kRunTicket, 1u);
  for (int k = kRunBuckets - 1; k >= kFirstBucket; --k) {
    if (t < count[k]) return run_list[run_bucket_at(m, k) + t];
    t -= count[k];
  }
  return make_uint4(0u, 0u, 0u, 0u);
}

// 3b. the long runs, one at a time a walker: kLongBlocks blocks, each
// taking the next unclaimed run of the run list by a ticket (claim_run)
// until none is left, so the schedule follows the runs the keys hold and
// no walker holds a second run while one waits.  A run is the whole
// block's: up to kWalkThreads columns at a time, kLongFloats / columns
// rows a chunk staged in shared memory by every thread (the next chunk's
// rows and the slots after them in flight during this chunk's adds), one
// thread a column adding in slot order.  Each run's double goes to its own
// place (its tile's, then its rank there), which no schedule changes.  A
// launch of its own, so that its registers do not cost walk_runs its
// occupancy.  At the end each walker adds its runs and notes its slots in
// the counters.
template <class Epi>
__global__ void __launch_bounds__(kWalkThreads, 1)
    walk_long(const unsigned* vals0, const unsigned* vals1,
              const unsigned long long* bits, long long m,
              const float* __restrict__ rows, int d, int tile,
              long long blocks, unsigned* runs,
              const uint4* __restrict__ run_list, Epi epi) {
  typedef decltype(epi.begin(0ll, 0)) Ctx;
  __shared__ float lbuf[kLongFloats];  // a chunk, [rows][columns]
  __shared__ unsigned count[kRunBuckets];
  __shared__ uint4 job;
  const int buf = m > 0 ? radix_src_buffer(bits, RadixKey<uint32_t>::kPasses)
                        : 0;
  const unsigned* vals = buf ? vals1 : vals0;
  const int tid = threadIdx.x;
  // the bucket counts are final: walk_runs has ended
  if (tid < kRunBuckets) count[tid] = runs[tid];
  unsigned walked = 0, slots = 0;
  for (;;) {
    __syncthreads();  // the counts are in; the last run's job read
    if (tid == 0) job = claim_run(runs, run_list, m, count);
    __syncthreads();
    const long long j0 = job.x, j1 = job.y;
    const uint32_t key = job.z;
    if (j1 <= j0) break;  // block-uniform: nothing left
    ++walked;
    slots += (unsigned)(j1 - j0);
    double total = 0.0;
    for (int c0 = 0; c0 < d; c0 += kWalkThreads) {
      const int cols = d - c0 < kWalkThreads ? d - c0 : kWalkThreads;
      const int chunk = kLongFloats / cols;
      // value e = tid + t * kWalkThreads of a chunk is row e / cols,
      // column c0 + e % cols, stepped over t without a division
      const int r_first = tid / cols, c_first = tid - r_first * cols;
      const int rstep = kWalkThreads / cols, cstep = kWalkThreads % cols;
      unsigned slot[kLongPer];
      float v[kLongPer];
      // the slots of the chunk at jc, then its rows
      auto load_slots = [&](long long jc) {
        const long long n = j1 - jc < chunk ? j1 - jc : chunk;
        int r = r_first, c = c_first;
#pragma unroll
        for (int t = 0; t < kLongPer; ++t) {
          slot[t] = r < n ? __ldg(vals + jc + r) : 0u;
          r += rstep;
          c += cstep;
          if (c >= cols) {
            c -= cols;
            ++r;
          }
        }
      };
      auto load_rows = [&](long long jc) {
        const long long n = j1 - jc < chunk ? j1 - jc : chunk;
        int r = r_first, c = c_first;
#pragma unroll
        for (int t = 0; t < kLongPer; ++t) {
          v[t] = r < n ? __ldg(rows + (long long)slot[t] * d + c0 + c)
                       : 0.0f;
          r += rstep;
          c += cstep;
          if (c >= cols) {
            c -= cols;
            ++r;
          }
        }
      };
      Ctx ctx;
      if (tid < cols) ctx = epi.begin(key, c0 + tid);
      float acc = 0.0f;
      long long j = j0;
      load_slots(j);
      load_rows(j);
      if (j + chunk < j1) load_slots(j + chunk);
      for (;;) {
        const int n = j1 - j < chunk ? (int)(j1 - j) : chunk;
#pragma unroll
        for (int t = 0; t < kLongPer; ++t) {
          const int e = tid + t * kWalkThreads;
          if (e < n * cols) lbuf[e] = v[t];
        }
        __syncthreads();
        const long long jn = j + chunk;
        if (jn < j1) {  // the next chunk's rows, and the slots after it
          load_rows(jn);
          if (jn + chunk < j1) load_slots(jn + chunk);
        }
        if (tid < cols) {
          // kLongAdds loads issued before their adds: the chain waits on
          // one shared-memory latency a batch, not one an add
          int r = 0;
          for (; r + kLongAdds <= n; r += kLongAdds) {
            float x[kLongAdds];
#pragma unroll
            for (int t = 0; t < kLongAdds; ++t)
              x[t] = lbuf[(r + t) * cols + tid];
#pragma unroll
            for (int t = 0; t < kLongAdds; ++t) acc = __fadd_rn(acc, x[t]);
          }
          for (; r < n; ++r) acc = __fadd_rn(acc, lbuf[r * cols + tid]);
        }
        __syncthreads();
        if (jn >= j1) break;
        j = jn;
      }
      if (tid < cols) total += epi.put(ctx, acc);
    }
    // the run's double at its own place: its tile's, then its rank there
    epi.finish(total, blocks + j0 / tile * kTileLongRuns + job.w);
  }
  if (tid == 0 && walked > 0) {
    atomicAdd(runs + kRunsWalked, walked);
    atomicMax(runs + kBusiestWalker, slots);
  }
}

// The merge on `stream`: zero the run list's words, the notes and the
// flags, the key pass and the sort (when there are rows), then the walkers
// with `epi`: the short runs and the gaps, then the long runs.  `rows` [m, d] float32, `inv` [m]
// int32; the workspace as SegRunsWorkspace lays it out.  Returns the first
// launch error.
template <class Epi>
cudaError_t segment_runs(const float* rows, const int32_t* inv, long long m,
                         long long d, long long nseg,
                         const SegRunsWorkspace& ws, Epi epi,
                         cudaStream_t stream) {
  // keys are uint32 with nseg itself the dropped slots' key; slots uint32
  if (m < 0 || nseg < 0 || m > 0xffffffffll || nseg > 0xffffffffll ||
      d < 1 || d > (1 << 20))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(ws.runs, 0, ws.zeroed, stream);
  if (err != cudaSuccess) return err;
  if (m > 0) {
    long long kb = (m + kSegKeyThreads - 1) / kSegKeyThreads;
    if (kb > kSegKeyMaxBlocks) kb = kSegKeyMaxBlocks;
    const bool vec4 =
        d % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
    seg_keys<<<(unsigned)kb, kSegKeyThreads, 0, stream>>>(
        inv, rows, m, d, nseg, vec4, ws.keys[0], ws.vals[0], ws.has_rows,
        ws.bits, ws.totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = radix_sort_pairs<uint32_t>(
             ws.keys[0], ws.keys[1], ws.vals[0], ws.vals[1], m, ws.bits,
             ws.totals, ws.status, ws.tickets, stream)) != cudaSuccess)
      return err;
  }
  const long long blocks = walk_blocks(m, nseg, d);
  if (blocks == 0) return cudaSuccess;
  walk_runs<Epi><<<(unsigned)blocks, kWalkThreads, 0, stream>>>(
      ws.keys[0], ws.keys[1], ws.vals[0], ws.vals[1], ws.bits, m, nseg, rows,
      (int)d, walk_tile(d), ws.has_rows, ws.long_runs, ws.runs, ws.run_list,
      epi);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  walk_long<Epi><<<kLongBlocks, kWalkThreads, 0, stream>>>(
      ws.vals[0], ws.vals[1], ws.bits, m, rows, (int)d, walk_tile(d), blocks,
      ws.runs, ws.run_list, epi);
  return cudaGetLastError();
}

}  // namespace lct
