// merge_apply: sparse Adagrad in place on the touched rows
//
//   for every slot s with uid = uids[s] that is not a pad (uid 0 past slot 0):
//     g           = merged[s] / denom
//     sumsq      += g*g
//     row         = uid < 0 ? uid + vocab : uid      (a uid in [-vocab, 0) wraps)
//     if 0 <= row < vocab:                            (any other uid is dropped)
//       accum[row] += g*g
//       table[row] -= lr * g * rsqrt(accum[row] + eps)
//
// `merged` is the per-uid rows of the apply mode (inv=None, the entry
// merge_apply_f32), or, in the merge mode (merge_apply_merge_f32), the
// slot-order segment merge of the gathered rows through their inv, which
// this entry computes and applies in one pass: the key pass and the radix
// sort of segment_runs.cuh, then its two walker launches (the short runs,
// then the long ones), whose epilogue applies each (segment, column) sum
// straight to the table, with no [S, d] scratch in between.  A segment
// that receives no kept row gets the update of a +0 sum, as in the plain
// version (it can change bits: a -0.0 accum becomes +0.0), except a pad
// slot, which is skipped in either mode.
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _merge_apply_pallas: _merge_kernel for the merge, then _apply_kernel,
// _apply_block_kernel or _apply_block_dma_kernel, one touched row per grid
// step (or rb rows), the row window steered by scalar-prefetched uids.  A
// TPU grid runs in order, so that kernel rotates slot 0 to run last and
// lets the pad slots (uid 0 past slot 0) write their no-op updates to row 0
// before the one real write.  Here blocks run in parallel, so pad slots are
// skipped outright (ROADMAP B.5): every other uid is distinct (the dedup
// contract), nothing races, and the table needs no atomics.  Pad slots
// carry zero gradient by contract (the apply mode's dispatch zeroes them,
// the merge leaves them at exact zeros), so skipping them leaves sumsq as
// the JAX reference computes it, which counts every merged row, those of
// uids outside the table too.
//
// Layout (apply mode): touched_rows.cuh's walk.  A persistent grid of
// warps takes tiles of slots; a tile's uids are loaded once, coalesced, a
// tile ahead, and reach the lanes by shuffle.  Lanes run over a row's
// columns, float4 where d % 4 == 0 and table, accumulator and rows are
// 16-byte aligned (at d = 32, 8 lanes a row, 4 rows a warp access), one
// float otherwise; at d = 1 (FM's w table) a lane takes whole slots.  A
// lane starts the gradient, accumulator and table loads of kVecRows rows
// (kScalarRows, kOwnRows) before it applies the first, and the next
// tile's uids are in flight meanwhile.  At d = 32 that is 8 rows of 384
// bytes a warp; at the 32 warps an SM that its registers allow, about
// 96 KB an SM in flight, past the ~18 KB (3.35 TB/s x 0.7 us over 132
// SMs) that hides HBM latency.  More rows a lane cost occupancy and
// measured slower on the H100 at both widths.  The flat loop this
// replaced ran one value a thread, with a 64-bit division by d for its
// slot.  Each block writes its partial
// of the sum of squares at its own index and a second launch,
// sum_partials, adds them in block order.  One launch, whose last block
// (named by a ticket in the workspace) adds the partials, measured slower
// on the H100 at d 1 and d 32: the workspace is fresh scratch on every
// call, so the ticket needs a memset node before the walk, and every
// block a fence and an atomic after it.
// The merge mode's layout is the walker's (segment_runs.cuh): a thread a
// (segment, column), a warp a segment at d = 32, a thread one at d = 1.
//
// Rounding: each operation is written with an _rn intrinsic in the plain
// version's order (g/denom, g*g, a + g*g, a' + eps, lr*g, (lr*g)*r, w - ...)
// so nvcc cannot contract them into FMAs; rsqrtf matches torch.rsqrt on the
// card.  sumsq is accumulated in double per thread, reduced per block, and
// the per-block sums are added by one block in a fixed order, so it is the
// same from run to run (the apply mode's grid depends only on S, d and the
// card, and each warp's tiles are fixed; in the merge mode the stable sort
// fixes which thread of a walk_runs tile adds what, and a long run's
// double, summed by whichever walker took the run, has a place of its own).
//
// Bound: bytes.  The touched rows' table and accumulator are read and
// written once (4 * S_real * d * 4 bytes for S_real distinct ids), their
// S_real*d gradient floats read once, and all S uids read once; a pad slot
// reads its uid and skips its gradient row.  At the one-card trainer's shape
// (S = 159,744 slots, about 75,500 distinct, d = 32) that is about 49 MB,
// so about 15 us at 3.35 TB/s; chip_smoke.py computes the bound from the
// run's own uids.  The merge mode reads the M*d gathered floats and M
// segment ids in place of the S*d merged ones; its sort, like merge_rows',
// is a few launches of latency in sequence.
//
// Plain C interface for ctypes; each entry returns the first CUDA error of
// its launches, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "segment_runs.cuh"
#include "touched_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // the apply mode's partials
// rows a lane has in flight, by lane kind (touched_rows.cuh): float4
// lanes, one-float lanes (d % 4 != 0), lanes that take whole slots (d 1)
constexpr int kVecRows = 2;
constexpr int kScalarRows = 8;
constexpr int kOwnRows = 2;

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Fixed-order block sum of one double per thread; thread 0 holds it.
__device__ double block_sum(double x) {
  __shared__ double warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = threadIdx.x < (blockDim.x >> 5) ? warp_sums[lane] : 0.0;
  if (warp == 0) x = warp_sum(x);
  return x;
}

// The apply mode's arguments.
struct ApplyArgs {
  float* table;
  float* accum;
  const int32_t* uids;
  const float* rows;
  long long vocab, d;
  float lr, eps, denom;
  bool scale;
};

// The apply mode's epilogue on touched_rows.cuh's walk: V columns of one
// slot's row.  load() reads the gradient and, through the uid, the table
// and accumulator; put() applies the update and adds g*g to the thread's
// sum of squares.
template <int V>
struct ApplyRows : ApplyArgs {
  using F = typename lct::FloatVec<V>::T;
  double ssq;

  struct Slot {
    int32_t uid;
  };
  struct Ctx {
    long long e;  // the element of table/accum, -1: none (dropped uid)
    F g, a, w;
  };

  __device__ Slot slot(long long i) const { return {__ldg(uids + i)}; }

  // pad slots (uid 0 past slot 0) carry no gradient
  __device__ bool skip(long long i, const Slot& k) const {
    return k.uid == 0 && i > 0;
  }

  __device__ Ctx load(long long i, const Slot& k, long long c) const {
    Ctx x;
    x.g = lct::stream_vec<V>(rows + i * d + c);
    // the JAX scatter's index rules: a negative uid wraps once, any other
    // uid outside the table is dropped
    const long long row = k.uid < 0 ? (long long)k.uid + vocab : k.uid;
    x.e = row >= 0 && row < vocab ? row * d + c : -1;
    if (x.e >= 0) {
      x.a = lct::load_vec<V>(accum + x.e);
      x.w = lct::load_vec<V>(table + x.e);
    }
    return x;
  }

  __device__ void put(Ctx& x, long long, const Slot&, long long) {
    F g2;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float& g = lct::lane_of(x.g, j);
      if (scale) g = __fdiv_rn(g, denom);
      lct::lane_of(g2, j) = __fmul_rn(g, g);
      ssq += (double)lct::lane_of(g2, j);
    }
    if (x.e < 0) return;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float a = __fadd_rn(lct::lane_of(x.a, j), lct::lane_of(g2, j));
      lct::lane_of(x.a, j) = a;
      lct::lane_of(x.w, j) = __fsub_rn(
          lct::lane_of(x.w, j),
          __fmul_rn(__fmul_rn(lr, lct::lane_of(x.g, j)),
                    rsqrtf(__fadd_rn(a, eps))));
    }
    lct::store_vec<V>(accum + x.e, x.a);
    lct::store_vec<V>(table + x.e, x.w);
  }
};

// The sum of the n block partials in a fixed order.  With `long_runs`
// (the merge mode: a walker tile's count of long runs), each tile's
// partial is followed by its long runs' doubles in rank order, kept at
// n + tile * kTileLongRuns (segment_runs.cuh's walk_partials).
__global__ void sum_partials(const double* __restrict__ partials, int n,
                             const unsigned char* __restrict__ long_runs,
                             float* __restrict__ out) {
  double x = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x += partials[i];
    if (long_runs)
      for (int r = 0; r < long_runs[i]; ++r)
        x += partials[n + (long long)i * lct::kTileLongRuns + r];
  }
  x = block_sum(x);
  if (threadIdx.x == 0) *out = (float)x;
}

// The apply mode's walk.  Each block writes its partial of the sum of
// squares (a fixed-order block sum of its threads' doubles) at its index,
// which sum_partials adds in block order.
template <int V, int U, bool kOwn>
__global__ void __launch_bounds__(kThreads)
    apply_rows(ApplyRows<V> op, lct::TouchedRows w,
               double* __restrict__ partials) {
  lct::walk_touched_rows<V, U, kOwn>(w, op);
  const double ssq = block_sum(op.ssq);
  if (threadIdx.x == 0) partials[blockIdx.x] = ssq;
}

template <int V>
cudaError_t launch_apply(const ApplyArgs& a, long long s, double* partials,
                         float* out, cudaStream_t stream) {
  const ApplyRows<V> op{a, 0.0};
  return lct::launch_touched_rows<V, V == 4 ? kVecRows : kScalarRows,
                                  kOwnRows>(
      s, a.d, [&](auto u, auto own, const lct::TouchedRows& w) {
        constexpr int U = decltype(u)::value;
        constexpr bool kOwn = decltype(own)::value;
        const unsigned grid = lct::grid_for(apply_rows<V, U, kOwn>, kThreads,
                                            w.tiles, kMaxBlocks);
        if (grid == 0) return cudaGetLastError();
        apply_rows<V, U, kOwn><<<grid, kThreads, 0, stream>>>(op, w,
                                                              partials);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        sum_partials<<<1, kThreads, 0, stream>>>(partials, (int)grid, nullptr,
                                                out);
        return cudaGetLastError();
      });
}

// The merge mode's walker epilogue: the (segment, column) sum, divided by
// denom, is applied as apply_rows applies a merged row, with the same
// rounding, index rules and pad skip; begin() loads the uid, the table and
// the accumulator before the sum, so their loads overlap the rows'.
struct ApplySums {
  float* table;
  float* accum;
  const int32_t* uids;
  long long vocab, d;
  float lr, eps, denom;
  bool scale;
  double* partials;

  struct Ctx {
    long long e;  // the element of table/accum, -1: none (dropped uid)
    bool pad;
    float a, w;
  };

  // pad slots carry no gradient
  __device__ bool skip(long long seg) const {
    return seg > 0 && uids[seg] == 0;
  }

  __device__ Ctx begin(long long seg, int c) const {
    Ctx x{-1, false, 0.0f, 0.0f};
    const long long uid = uids[seg];
    x.pad = uid == 0 && seg > 0;
    const long long row = uid < 0 ? uid + vocab : uid;
    if (!x.pad && row >= 0 && row < vocab) {
      x.e = row * d + c;
      x.a = accum[x.e];
      x.w = table[x.e];
    }
    return x;
  }

  __device__ double put(const Ctx& x, float sum) const {
    if (x.pad) return 0.0;  // pad slots carry no gradient
    float g = sum;
    if (scale) g = __fdiv_rn(g, denom);
    const float g2 = __fmul_rn(g, g);
    if (x.e >= 0) {
      const float a = __fadd_rn(x.a, g2);
      accum[x.e] = a;
      table[x.e] = __fsub_rn(
          x.w, __fmul_rn(__fmul_rn(lr, g), rsqrtf(__fadd_rn(a, eps))));
    }
    return (double)g2;
  }

  // the partial of a walk_runs tile or of a long run at `at`
  // (segment_runs.cuh's walk_partials), which sum_partials adds in a fixed
  // order
  __device__ void finish(double ssq, long long at) const {
    ssq = block_sum(ssq);
    if (threadIdx.x == 0) partials[at] = ssq;
  }
};

}  // namespace

// Bytes of device scratch merge_apply_f32 needs: one double per block.
extern "C" long long merge_apply_workspace_bytes(void) {
  return (long long)kMaxBlocks * sizeof(double);
}

extern "C" int merge_apply_f32(void* table, void* accum, const void* uids,
                               const void* rows, long long vocab, long long d,
                               long long s, float lr, float eps, float denom,
                               void* sumsq, void* workspace,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  double* partials = static_cast<double*>(workspace);
  float* out = static_cast<float*>(sumsq);
  const ApplyArgs a{static_cast<float*>(table),
                    static_cast<float*>(accum),
                    static_cast<const int32_t*>(uids),
                    static_cast<const float*>(rows),
                    vocab,
                    d,
                    lr,
                    eps,
                    denom,
                    denom != 1.0f};
  if (lct::rows_take_float4(d, {table, accum, rows}))
    return (int)launch_apply<4>(a, s, partials, out, stream);
  return (int)launch_apply<1>(a, s, partials, out, stream);
}

// Bytes of device scratch merge_apply_merge_f32 needs for m gathered rows
// of width d onto s slots: the sort's keys, slots and notes, the segment
// flags, the long runs' list and the walkers' doubles.
extern "C" long long merge_apply_merge_workspace_bytes(long long m,
                                                       long long s,
                                                       long long d) {
  return (long long)lct::SegRunsWorkspace(nullptr, m, s, d, true).bytes;
}

extern "C" int merge_apply_merge_f32(void* table, void* accum,
                                     const void* uids, const void* rows,
                                     const void* inv, long long vocab,
                                     long long d, long long s, long long m,
                                     float lr, float eps, float denom,
                                     void* sumsq, void* workspace,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const lct::SegRunsWorkspace ws(workspace, m, s, d, true);
  const ApplySums epi{static_cast<float*>(table), static_cast<float*>(accum),
                      static_cast<const int32_t*>(uids), vocab, d, lr, eps,
                      denom, denom != 1.0f, ws.partials};
  cudaError_t err = lct::segment_runs(static_cast<const float*>(rows),
                                      static_cast<const int32_t*>(inv), m, d,
                                      s, ws, epi, stream);
  if (err != cudaSuccess) return (int)err;
  // a partial a walk_runs tile and one a long run: a wider block to add
  // them
  sum_partials<<<1, 1024, 0, stream>>>(
      ws.partials, (int)lct::walk_blocks(m, s, d), ws.long_runs,
      static_cast<float*>(sumsq));
  return (int)cudaGetLastError();
}
