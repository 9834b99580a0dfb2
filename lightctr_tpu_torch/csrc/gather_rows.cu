// gather_rows: out[i, :] = block[clip(int32(idx[i]), 0, R - 1), :]
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _gather_pallas/_gather_kernel: a grid of n steps, each moving one (1, d)
// row window steered by scalar-prefetched indices.  Same int32 cast and
// clip as _gather_pallas (sparse_kernels.py:740); the result is a copy, bit
// for bit the plain version (gather_rows_plain in
// lightctr_tpu_torch/ops/sparse_kernels.py).
//
// Layout: a warp walks tiles of rows.  The tile's indices are loaded once,
// one a lane, coalesced, through the read-only path, the next tile's under
// this tile's row loads; each is cast and clipped once a row and reaches
// the lanes that copy its row by __shfl_sync, so no lane reloads an index.
// A tile's tile_rows x cv vectors (cv = d / 4 float4 vectors where
// d % 4 == 0 and block and out start on 16 bytes, d floats otherwise) are
// one flat range of the output: lane l copies vectors l, l + 32, ..., so
// the warp's stores are coalesced and a 33-float row spends no 32-lane pass
// on its last column.  Vector t of the tile is column t - q * cv of the
// tile's row q = t / cv, a 32-bit __umulhi by a multiplier the launch
// computes, which is exact on the tile's range.  The
// tile is sized so that a lane copies at most kVecRows float4 vectors or
// kScalarRows floats of it, all loaded before the first is stored (at
// d 32: 8 lanes a row, 4 rows a tile; at d 128: a row a tile; at d 33:
// 3 rows, 99 floats, 4 a lane).  A row of one vector (d 1, or d 4 on
// float4) is a lane's own: a tile of 32 * kOwnRows rows, each lane loading
// its kOwnRows indices itself.  Index math is 32-bit where n * d and R * d
// stay below 2^31, 64-bit otherwise.  launch() picks the lane kind, tile
// and index width from (R, d, n) and the two pointers.  The grid is sized
// to the tiles below one wave and persistent (SMs x resident blocks) above
// it.
//
// Bound: bytes: the distinct rows read (d * 4 bytes each), n indices and
// n * d * 4 bytes written.  Serve shape (R 65,536, d 33, n 8,192, int32):
// 2,130,512 B, 0.000636 ms at 3.35 TB/s, below any launch, so the launch
// and two dependent memory latencies (index, row) set the time there.
// Hot-row shape (R 2^20, d 32, n 159,744 uniform ids): about 40 MB,
// 0.0120 ms, bandwidth work.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools.kernel_ab, medians
// of three runs; warm = back-to-back calls in a CUDA graph, cold = each
// call after a 200 MB read): serve shape 0.00210 ms warm, 0.00389 cold
// (the flat grid-stride loop this replaced: 0.00273 / 0.00418;
// torch.index_select 0.00442 / 0.00794), where an empty kernel of the
// same launch shape takes about 0.0012 (chip_smoke.py's gather_floor
// line); hot-row shape 0.01090 warm, 0.01880 cold, 1.57x the bound (flat
// loop 0.03244 / 0.03859; index_select 0.09776 / 0.10381).  Cold, the
// random 128-byte rows run the memory at about 2.1 TB/s.  The constants
// below were set by a sweep (tools.kernel_ab over copies that each set
// one otherwise; PERF.md §6): one float4 a lane (four lost at small n and
// cold), four floats a one-float lane (with one or two, a 33-float row's
// last float takes a pass of its own: 0.0210 and 0.0186 ms at d 33,
// n 159,744 against 0.0111; three: 0.0129; eight: 0.0118), one row a lane
// where a row is one vector, 256 threads.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "touched_rows.cuh"

namespace {

// Set by a sweep on the H100 (PERF.md §6).
constexpr int kThreads = 256;
// vectors a lane has in flight, at most, a tile, by lane kind: float4
// lanes, one-float lanes, lanes that take whole rows (a row of one vector)
constexpr int kVecRows = 1;
constexpr int kScalarRows = 4;
constexpr int kOwnRows = 1;
constexpr long long kMaxBlocks = 1 << 20;

// The kernel's arguments, kept within 64 bytes: a launch reads them from
// a fresh constant bank, one cache line.
struct Gather {
  const float* block;
  const void* idx;
  float* out;
  long long n;      // indices
  long long tiles;  // tiles of tile_rows rows
  int cv;           // vectors a row
  int32_t last;     // the last row an int32 index reaches: min(R - 1, 2^31 - 1)
  int tile_rows;
  unsigned magic;   // q = __umulhi(t, magic) = t / cv on a tile's range
};
static_assert(sizeof(Gather) <= 64, "one constant cache line");

// The int32 cast (wrapping an int64 id) and the clip into [0, R - 1],
// in 32 bits: an int32 index never passes last = min(R - 1, 2^31 - 1).
template <typename IdxT>
__device__ __forceinline__ int32_t clip_row(IdxT raw, int32_t last) {
  const int32_t r = static_cast<int32_t>(raw);
  return r < 0 ? 0 : (r > last ? last : r);
}

// kOwn: a row is one vector and a lane's own (tile_rows = 32 * kOwnRows).
// I: the index math's type, uint32_t or long long.
template <int V, bool kOwn, typename IdxT, typename I>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(Gather g) {
  using F = typename lct::FloatVec<V>::T;
  constexpr int U = V == 4 ? kVecRows : kScalarRows;
  constexpr int J = kOwn ? kOwnRows : 1;  // indices a lane loads a tile
  const IdxT* idx = static_cast<const IdxT*>(g.idx);
  const int lane = threadIdx.x & 31;
  const I warp = ((I)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const I warps = ((I)gridDim.x * blockDim.x) >> 5;
  const I n = (I)g.n, tiles = (I)g.tiles, cv = (I)g.cv;
  const I tile_rows = (I)g.tile_rows;

  IdxT pre[J];
#pragma unroll
  for (int j = 0; j < J; ++j) pre[j] = 0;
  auto fetch = [&](I tile) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const I p = lane + 32 * j;
      if (tile < tiles && p < tile_rows && tile * tile_rows + p < n)
        pre[j] = __ldg(idx + tile * tile_rows + p);
    }
  };
  fetch(warp);
  for (I tile = warp; tile < tiles; tile += warps) {
    const I base = tile * tile_rows;
    int32_t r[J];
#pragma unroll
    for (int j = 0; j < J; ++j) r[j] = clip_row(pre[j], g.last);
    // the next tile's indices are fetched once this tile's row loads are
    // issued, so they wait on no index of their own
    if constexpr (kOwn) {
      F v[kOwnRows];
#pragma unroll
      for (int u = 0; u < kOwnRows; ++u)
        if (base + lane + 32 * u < n)
          v[u] = lct::load_vec<V>(g.block + (I)r[u] * V);
      fetch(tile + warps);
#pragma unroll
      for (int u = 0; u < kOwnRows; ++u)
        if (base + lane + 32 * u < n)
          lct::store_vec<V>(g.out + (base + lane + 32 * u) * V, v[u]);
    } else {
      // the vectors of the tile's rows (a short last tile has fewer);
      // the loop's bounds are warp-uniform: every lane takes part in every
      // shuffle
      const I span = (n - base < tile_rows ? n - base : tile_rows) * cv;
      for (I k = 0; k < span; k += 32 * U) {
        F v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const I t = k + lane + 32 * u;
          const I q = __umulhi((unsigned)t, g.magic);
          const int32_t row =
              __shfl_sync(lct::kWarpMask, r[0], (int)(q & 31));
          if (t < span)
            v[u] = lct::load_vec<V>(g.block + ((I)row * cv + t - q * cv) * V);
        }
        if (k == 0) fetch(tile + warps);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + lane + 32 * u < span)
            lct::store_vec<V>(g.out + (base * cv + k + lane + 32 * u) * V,
                              v[u]);
      }
    }
  }
}

// The floor: a kernel that does nothing, launched at the gather's shape.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// The grid: a block for every kThreads / 32 tiles (a warp each) below one
// wave, persistent (SMs x resident blocks) past it (lct::grid_for).
template <int V, bool kOwn, typename IdxT, typename I>
cudaError_t launch_kernel(const Gather& g, bool empty, cudaStream_t stream) {
  const auto kernel = gather_rows_kernel<V, kOwn, IdxT, I>;
  const unsigned grid = lct::grid_for(kernel, kThreads, g.tiles, kMaxBlocks);
  if (grid == 0) return cudaGetLastError();
  if (empty)
    empty_kernel<<<grid, kThreads, 0, stream>>>();
  else
    kernel<<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

template <int V, typename IdxT>
cudaError_t launch_vec(const Gather& g, bool wide, bool empty,
                       cudaStream_t stream) {
  const bool own = g.cv == 1;
  if (wide)
    return own ? launch_kernel<V, true, IdxT, long long>(g, empty, stream)
               : launch_kernel<V, false, IdxT, long long>(g, empty, stream);
  return own ? launch_kernel<V, true, IdxT, uint32_t>(g, empty, stream)
             : launch_kernel<V, false, IdxT, uint32_t>(g, empty, stream);
}

// The plan: float4 lanes where d % 4 == 0 and block and out start on 16
// bytes; a row of one vector a lane's own (32 * kOwnRows rows a tile);
// a wider row's tile as many rows (1 to 32) as keep a lane's share of its
// vectors within its kind's in-flight count, with the multiplier
// magic = floor((2^32 - 1) / cv) + 1, for which __umulhi(t, magic) = t / cv
// on t < tile_rows * cv <= 32 * per_lane; 64-bit index math where
// n * d or R * d reaches 2^31.
template <typename IdxT>
int launch(const void* block, const void* idx, void* out, long long rows,
           long long d, long long n, bool empty, void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  if (rows < 1 || d < 1 || d > INT32_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(block) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long cv = vec ? d / 4 : d;
  const bool wide = n * d >= (1LL << 31) || rows * d >= (1LL << 31);
  long long tile_rows = 32 * kOwnRows;
  unsigned magic = 0;
  if (cv > 1) {
    const long long per_lane = vec ? kVecRows : kScalarRows;
    tile_rows = 32 * per_lane / cv;
    tile_rows = tile_rows < 1 ? 1 : (tile_rows > 32 ? 32 : tile_rows);
    if (tile_rows > 1) magic = (unsigned)(0xffffffffu / cv + 1);
  }
  const Gather g{static_cast<const float*>(block),
                 idx,
                 static_cast<float*>(out),
                 n,
                 (n + tile_rows - 1) / tile_rows,
                 (int)cv,
                 (int32_t)(rows - 1 < INT32_MAX ? rows - 1 : INT32_MAX),
                 (int)tile_rows,
                 magic};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(vec ? launch_vec<4, IdxT>(g, wide, empty, stream)
                   : launch_vec<1, IdxT>(g, wide, empty, stream));
}

}  // namespace

extern "C" int gather_rows_f32_i32(const void* block, const void* idx,
                                   void* out, long long rows, long long d,
                                   long long n, void* stream) {
  return launch<int32_t>(block, idx, out, rows, d, n, false, stream);
}

extern "C" int gather_rows_f32_i64(const void* block, const void* idx,
                                   void* out, long long rows, long long d,
                                   long long n, void* stream) {
  return launch<int64_t>(block, idx, out, rows, d, n, false, stream);
}

// The launch's floor: an empty kernel at the grid and block that
// gather_rows_f32_i32 would launch for the same arguments; it moves
// nothing.
extern "C" int gather_rows_floor(const void* block, void* out,
                                 long long rows, long long d, long long n,
                                 void* stream) {
  return launch<int32_t>(block, nullptr, out, rows, d, n, true, stream);
}
