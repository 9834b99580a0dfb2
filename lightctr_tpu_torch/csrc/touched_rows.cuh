// touched_rows: the walk over a deduped id stream's touched rows, shared by
// merge_apply.cu's apply mode (B5) and quantize_pack_ef_update.cu (B8)
//
//   for every slot i in [0, s) and every column c of its row:
//     op.load(i, slot i's keys, c) ... op.put(..., i, slot i's keys, c)
//
// Both kernels read a slot's keys (its uid, and B8's mask), then through
// the uid one row of a [vocab, d] table, beside the slot's own row of the
// [s, d] payload, and write back.  Each value is a chain of two memory
// latencies (the uid, then the rows it names), so the walk is laid out to
// keep many such chains in flight at once, which a flat loop over s*d
// values with one value a thread does not:
//
//   - A persistent grid (SMs x resident blocks, grid_for) of warps walks
//     tiles of slots: warp w takes tiles w, w + warps, ...  The static
//     order keeps a kernel's per-thread sums (B5's sum of squares) the
//     same from call to call.
//   - A tile's keys are loaded once, coalesced, one slot a lane, a tile
//     ahead: the next tile's keys are in flight while this tile's rows
//     are.  Lanes get their rows' keys by shuffle (kOwn false) or, where a
//     lane takes whole slots (a row of one vector: d = 1, or d = 4 on
//     float4), from their own loads (kOwn true).
//   - Lanes run over columns, V floats at a time: float4 (V = 4) where
//     d % 4 == 0 and every row pointer is 16-byte aligned, one float
//     (V = 1) otherwise.  A row of cv = d / V vectors takes cv lanes, so a
//     warp access covers rpa = 32 / cv rows (at d = 32 on float4: 8 lanes
//     a row, 4 rows an access); a row wider than 32 vectors takes the
//     whole warp, column chunk by column chunk.
//   - A lane takes U rows of the tile (U accesses), and starts the loads
//     of all U (op.load) before it uses the first (op.put).
//
// The lane's place in a tile (its row and first column) is worked out once
// per thread; no division appears in any per-value index.  A kernel
// launches its walk through launch_touched_rows, which alone picks the
// lane kind from d and sets the shape to match.
//
// The Op (a kernel's per-value epilogue) provides
//   Slot          the per-slot keys, a multiple of 4 bytes (shuffled as
//                 32-bit words)
//   Slot slot(i)  load slot i's keys
//   bool skip(i, k)  whether slot i does nothing at all (B5's pads)
//   Ctx           what the loads of one lane's V columns of a row give
//   Ctx load(i, k, col)   start those loads (col is the first float)
//   void put(ctx, i, k, col)  compute and store

#pragma once

#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <type_traits>
#include <cuda_runtime.h>

namespace lct {

constexpr unsigned kWarpMask = 0xffffffffu;

// V floats: one float or a float4.
template <int V>
struct FloatVec;
template <>
struct FloatVec<1> {
  using T = float;
};
template <>
struct FloatVec<4> {
  using T = float4;
};

__device__ __forceinline__ float& lane_of(float& x, int) { return x; }
__device__ __forceinline__ float& lane_of(float4& x, int j) {
  return (&x.x)[j];
}

template <int V>
__device__ __forceinline__ typename FloatVec<V>::T load_vec(const float* p) {
  return *reinterpret_cast<const typename FloatVec<V>::T*>(p);
}

// A read-only stream (the payload rows), read once: through the
// non-coherent path, evict first.
template <int V>
__device__ __forceinline__ typename FloatVec<V>::T stream_vec(const float* p) {
  return __ldcs(reinterpret_cast<const typename FloatVec<V>::T*>(p));
}

template <int V>
__device__ __forceinline__ void store_vec(float* p,
                                          const typename FloatVec<V>::T& x) {
  *reinterpret_cast<typename FloatVec<V>::T*>(p) = x;
}

template <int V>
__device__ __forceinline__ typename FloatVec<V>::T fill_vec(float x) {
  typename FloatVec<V>::T v;
#pragma unroll
  for (int j = 0; j < V; ++j) lane_of(v, j) = x;
  return v;
}

// Shuffle any 4-byte-multiple value from lane src.
template <typename T>
__device__ __forceinline__ T shfl_words(const T& x, int src) {
  static_assert(sizeof(T) % 4 == 0, "keys are 32-bit words");
  constexpr int n = sizeof(T) / 4;
  uint32_t w[n];
  memcpy(w, &x, sizeof(T));
#pragma unroll
  for (int i = 0; i < n; ++i) w[i] = __shfl_sync(kWarpMask, w[i], src);
  T y;
  memcpy(&y, w, sizeof(T));
  return y;
}

// Whether V = 4 may be used: d % 4 == 0 and every row pointer 16-byte
// aligned (a row then starts on 16 bytes too).
inline bool rows_take_float4(long long d,
                             std::initializer_list<const void*> ptrs) {
  if (d % 4 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The walk's shape, set on the host (touched_rows_shape).
struct TouchedRows {
  long long s;      // slots
  long long tiles;  // tiles of tile_rows slots
  int cv;           // vectors a row: d / V
  int rpa;          // rows one warp access covers: 32 / cv, 1 past 32
  int ueff;         // accesses a lane makes a tile (<= U)
  int tile_rows;    // slots a tile: 32 * U (kOwn), else rpa * ueff
};

// The walk's shape for lanes of kind kOwn (set by launch_touched_rows).
template <int V, int U, bool kOwn>
TouchedRows touched_rows_shape(long long s, long long d) {
  TouchedRows w;
  w.s = s;
  w.cv = (int)(d / V);
  if (kOwn) {
    w.rpa = 32;
    w.ueff = U;
    w.tile_rows = 32 * U;
  } else {
    w.rpa = w.cv >= 32 ? 1 : 32 / w.cv;
    w.ueff = U < 32 / w.rpa ? U : 32 / w.rpa;
    w.tile_rows = w.rpa * w.ueff;
  }
  w.tiles = (s + w.tile_rows - 1) / w.tile_rows;
  return w;
}

// The one place that picks a walk's lane kind: lanes take whole slots
// (kOwn, U = UOwn rows a lane) exactly when a row of width d is one
// V-float vector, else they run over columns (U = URows).  Calls
// launch(std::integral_constant<int, U>, std::bool_constant<kOwn>, shape)
// with the shape of that kind, which launches walk_touched_rows<V, U,
// kOwn>; a kernel's launch goes through here, so its walk and its shape
// always agree on kOwn.
template <int V, int URows, int UOwn, typename Launch>
cudaError_t launch_touched_rows(long long s, long long d, Launch&& launch) {
  if (d == V)
    return launch(std::integral_constant<int, UOwn>{}, std::true_type{},
                  touched_rows_shape<V, UOwn, true>(s, d));
  return launch(std::integral_constant<int, URows>{}, std::false_type{},
                touched_rows_shape<V, URows, false>(s, d));
}

// A persistent grid for `kernel` at `threads` a block (and smem bytes of
// dynamic shared memory): the device's SMs times the blocks of it that fit
// on one (at most max_per_sm where that is not 0), at most what the tiles
// (of one warp each) need and at most max_blocks.  Returns 0 on a CUDA
// error (the caller's cudaGetLastError reports it).
template <typename Kernel>
unsigned grid_for(Kernel kernel, int threads, long long tiles,
                  long long max_blocks, int max_per_sm = 0,
                  size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  if (max_per_sm > 0 && per_sm > max_per_sm) per_sm = max_per_sm;
  const long long warps = threads / 32;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (tiles + warps - 1) / warps;
  if (blocks > need) blocks = need;
  if (blocks > max_blocks) blocks = max_blocks;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <int V, int U, bool kOwn, typename Op>
__device__ __forceinline__ void walk_touched_rows(const TouchedRows& w,
                                                  Op& op) {
  using Slot = typename Op::Slot;
  using Ctx = typename Op::Ctx;
  constexpr int J = kOwn ? U : 1;  // keys a lane loads a tile
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // this lane's row in an access and its first vector column, once
  const int lrow = kOwn ? lane : (w.cv >= 32 ? 0 : lane / w.cv);
  const int lcol = kOwn ? 0 : (w.cv >= 32 ? lane : lane - lrow * w.cv);
  const bool active = lrow < w.rpa;

  Slot pre[J];
  auto fetch = [&](long long tile) {
    const long long base = tile * w.tile_rows;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int p = lane + 32 * j;
      if (tile < w.tiles && p < w.tile_rows && base + p < w.s)
        pre[j] = op.slot(base + p);
    }
  };
  fetch(warp);
  for (long long tile = warp; tile < w.tiles; tile += warps) {
    const long long base = tile * w.tile_rows;
    Slot key[U];
    long long idx[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = kOwn ? lane + 32 * u : lrow + w.rpa * u;
      key[u] = kOwn ? pre[u] : shfl_words(pre[0], p & 31);
      idx[u] = base + p;
      ok[u] = active && u < w.ueff && idx[u] < w.s &&
              !op.skip(idx[u], key[u]);
    }
    fetch(tile + warps);  // the next tile's keys, under this tile's rows
    for (int c = lcol; c < w.cv; c += 32) {
      Ctx x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) x[u] = op.load(idx[u], key[u], (long long)c * V);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) op.put(x[u], idx[u], key[u], (long long)c * V);
    }
  }
}

}  // namespace lct
