// quantize_pack_ef: the EF-folded payload encode
//
//   for every payload row s of d values and column c (m = mask[s] when the
//   mask is one value a row, mask[s, c] when it is one a value):
//     val         = rows[s, c] + carried[s, c] * m
//     code        = searchsorted(boundaries, val, side='left')
//     codes[s, c] = code
//     delta[s, c] = ((val - values[code]) - carried[s, c]) * m
//
// which is the JAX reference _qp_ef_reference: compensate with last step's
// carry, encode, decode, fresh error.  The caller scatters delta back at the
// rows' table slots itself (quantize_pack_ef_update.cu folds that scatter
// in as well).
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _qp_ef_pallas/_qp_ef_kernel: [1024, 1] payload blocks on a sequential
// grid, a compare-count encode over every boundary and a chunked one-hot
// decode over every table value, both of which suit the TPU's wide vector
// unit.  JAX sends 16-bit tables to its XLA reference (the one-hot decode
// over 2^16 values wastes vector time); this kernel takes them as B8 does.
// NaN takes the top code, as in the JAX reference (the TPU's compare-count
// gives it code 0).
//
// Layout: touched_rows.cuh's walk, as quantize_pack_ef_update.cu (B8)
// without the uid: a payload row is a slot, and its key is the row's mask
// value (a per-value mask is read beside the row in load()), so no
// division appears in an index.  A persistent grid (SMs x resident blocks)
// stages the table once a block: up to 8 bits the Eytzinger tree and the
// values in shared memory (quantile_search.cuh's shared_code, B8's search);
// above 8 bits the top tree of the two-stage search (split_code), decoded
// by one read of values through the read-only path.  Lanes run over a
// row's columns, float4 where d % 4 == 0 and rows, carried, delta (and a
// per-value mask) start on 16 bytes and the codes on a word (8 lanes a row
// at d = 32), one float otherwise; at d = 1 a lane takes whole slots.
// Codes are stored four at once.  The flat loop this replaced ran one
// value a thread behind a barrier (a block of 256 values staged the
// table), searched the sorted array and divided by d in 64 bits for the
// mask's row.
//
// Rounding: carried * m is a product, not a select, so inf and NaN in the
// carry propagate as in the reference; __fadd_rn, __fsub_rn and __fmul_rn
// in the reference's order keep nvcc from contracting them into FMAs, so
// codes and delta are bit-identical to the plain version
// (quantize_pack_ef_plain in lightctr_tpu_torch/ops/sparse_kernels.py).
//
// Bound: bytes.  Per value the function reads the row and the carry (8
// bytes), writes the code (1 or 2) and delta (4), and reads the mask once
// per row or per value: at the exchange payload (79,872 x 32, 8 bits, a
// [P, 1] mask) about 33.5 MB, 0.010 ms at 3.35 TB/s.
//
// Plain C interface for ctypes; each entry returns the launch's CUDA error,
// which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

#include "quantile_search.cuh"
#include "touched_rows.cuh"

namespace {

constexpr int kTreeThreads = 256;  // the split's: lct::kSplitThreads
constexpr long long kMaxBlocks = 8192;
// rows a lane has in flight, by lane kind (touched_rows.cuh): float4
// lanes, one-float lanes (d % 4 != 0), lanes that take whole slots (d 1)
constexpr int kVecRows = 1;
constexpr int kScalarRows = 4;
constexpr int kOwnRows = 1;

// The entry's arguments: t is the boundaries (t.bnd, t.nb), as the split
// search reads them above 8 bits.
struct EfArgs {
  lct::SplitTable t;
  const float* values;
  const float* rows;
  const float* carried;
  const float* mask;
  long long d;
  void* codes;
  float* delta;
};

// The epilogue on touched_rows.cuh's walk: V columns of one payload row.
// kRowMask: the mask is one value a row (the slot's key), else one a value.
template <int V, typename Code, bool kTree, bool kRowMask>
struct EfPack : EfArgs {
  using F = typename lct::FloatVec<V>::T;

  struct Slot {
    float m;
  };
  struct Ctx {
    F x, car, m;
  };

  __device__ Slot slot(long long i) const {
    return {kRowMask ? __ldg(mask + i) : 0.0f};
  }

  __device__ bool skip(long long, const Slot&) const { return false; }

  __device__ Ctx load(long long i, const Slot& k, long long c) const {
    Ctx x;
    const long long e = i * d + c;
    x.x = lct::stream_vec<V>(rows + e);
    x.car = lct::stream_vec<V>(carried + e);
    if constexpr (kRowMask)
      x.m = lct::fill_vec<V>(k.m);
    else
      x.m = lct::stream_vec<V>(mask + e);
    return x;
  }

  __device__ void put(Ctx& x, long long i, const Slot&, long long c) const {
    lct::CodeVec<Code, V> code;
    F out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float car = lct::lane_of(x.car, j);
      const float m = lct::lane_of(x.m, j);
      const float val = __fadd_rn(lct::lane_of(x.x, j), __fmul_rn(car, m));
      int q;
      float dec;
      if constexpr (kTree) {
        q = lct::shared_code(val, t.nb);
        dec = lct::s_val[q];
      } else {
        q = lct::split_code(t, val);
        dec = __ldg(values + q);
      }
      code.c[j] = (Code)q;
      lct::lane_of(out, j) =
          __fmul_rn(__fsub_rn(__fsub_rn(val, dec), car), m);
    }
    const long long e = i * d + c;
    *reinterpret_cast<lct::CodeVec<Code, V>*>(static_cast<Code*>(codes) + e) =
        code;
    lct::store_vec<V>(delta + e, out);
  }
};

template <int V, int U, bool kOwn, typename Code, bool kTree, bool kRowMask>
__global__ void __launch_bounds__(kTree ? kTreeThreads : lct::kSplitThreads)
    ef_pack(EfPack<V, Code, kTree, kRowMask> op, lct::TouchedRows w) {
  if constexpr (kTree)
    lct::stage_tree(op.t.bnd, op.t.nb, op.values);
  else
    lct::stage_split(op.t);
  lct::walk_touched_rows<V, U, kOwn>(w, op);
}

template <int V, typename Code, bool kTree, bool kRowMask>
cudaError_t launch_kind(const EfArgs& a, long long p, cudaStream_t stream) {
  const EfPack<V, Code, kTree, kRowMask> op{a};
  return lct::launch_touched_rows<V, V == 4 ? kVecRows : kScalarRows,
                                  kOwnRows>(
      p, a.d, [&](auto u, auto own, const lct::TouchedRows& w) {
        constexpr int U = decltype(u)::value;
        constexpr bool kOwn = decltype(own)::value;
        const auto kernel = ef_pack<V, U, kOwn, Code, kTree, kRowMask>;
        const int threads = kTree ? kTreeThreads : lct::kSplitThreads;
        const size_t smem = kTree ? 0 : lct::kSplitSmem;
        if (!kTree && lct::split_smem_attr(kernel) != cudaSuccess)
          return cudaGetLastError();
        const unsigned grid =
            lct::grid_for(kernel, threads, w.tiles, kMaxBlocks,
                          kTree ? 0 : lct::kSplitBlocksPerSm, smem);
        if (grid == 0) return cudaGetLastError();
        kernel<<<grid, threads, smem, stream>>>(op, w);
        return cudaGetLastError();
      });
}

template <int V, typename Code>
cudaError_t launch_width(const EfArgs& a, long long p, bool row_mask,
                         cudaStream_t stream) {
  const bool tree = a.t.nb < lct::kTreeNodes;
  if (row_mask)
    return tree ? launch_kind<V, Code, true, true>(a, p, stream)
                : launch_kind<V, Code, false, true>(a, p, stream);
  return tree ? launch_kind<V, Code, true, false>(a, p, stream)
              : launch_kind<V, Code, false, false>(a, p, stream);
}

template <typename Code>
int launch(const void* bnd, long long nb, const void* values,
           const void* rows, const void* carried, const void* mask,
           long long p, long long d, int mask_per_value, void* codes,
           void* delta, void* stream_ptr) {
  if (p <= 0 || d <= 0) return (int)cudaSuccess;
  if (nb < 1 || nb > 65535 || reinterpret_cast<uintptr_t>(bnd) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const EfArgs a{lct::split_table(static_cast<const float*>(bnd), (int)nb),
                 static_cast<const float*>(values),
                 static_cast<const float*>(rows),
                 static_cast<const float*>(carried),
                 static_cast<const float*>(mask),
                 d,
                 codes,
                 static_cast<float*>(delta)};
  const bool row_mask = mask_per_value == 0;
  // float4 lanes also need the codes on a whole word (4 codes at once)
  const bool vec =
      lct::rows_take_float4(d, {rows, carried, delta,
                                row_mask ? nullptr : mask}) &&
      reinterpret_cast<uintptr_t>(codes) % (4 * sizeof(Code)) == 0;
  return (int)(vec ? launch_width<4, Code>(a, p, row_mask, stream)
                   : launch_width<1, Code>(a, p, row_mask, stream));
}

}  // namespace

extern "C" int quantize_pack_ef_u8(const void* bnd, long long nb,
                                   const void* values, const void* rows,
                                   const void* carried, const void* mask,
                                   long long p, long long d,
                                   int mask_per_value, void* codes,
                                   void* delta, void* stream) {
  return launch<uint8_t>(bnd, nb, values, rows, carried, mask, p, d,
                         mask_per_value, codes, delta, stream);
}

extern "C" int quantize_pack_ef_u16(const void* bnd, long long nb,
                                    const void* values, const void* rows,
                                    const void* carried, const void* mask,
                                    long long p, long long d,
                                    int mask_per_value, void* codes,
                                    void* delta, void* stream) {
  return launch<uint16_t>(bnd, nb, values, rows, carried, mask, p, d,
                          mask_per_value, codes, delta, stream);
}
