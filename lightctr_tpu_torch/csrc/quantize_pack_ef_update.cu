// quantize_pack_ef_update: the fixed-range sparse exchange's error-feedback
// encode, with the carry written back in place
//
//   for every slot s (uid = uids[s], m = mask[s]) and column c:
//     row   = uid < 0 ? uid + vocab : uid    (a uid in [-vocab, 0) wraps)
//     car   = residual[row, c], or NaN for a row outside the table
//     val   = rows[s, c] + car * m
//     code  = searchsorted(boundaries, val, side='left')
//     dec   = values[code]
//     codes[s, c] = code;  dec_out[s, c] = dec
//     if m != 0 and the row is in the table:
//       residual[row, c] = car + ((val - dec) - car) * m
//
// which is the JAX reference _qp_ef_update_reference (gather the carry,
// compensate, encode, decode, residual.at[uids].add(((val - dec) - carried)
// * mask)) for the dedup convention: at most one unmasked slot per uid.
//
// Replaces the TPU kernel lightctr_tpu/ops/sparse_kernels.py
// _qp_ef_update_pallas/_qp_ef_update_kernel: one payload row per grid step,
// the scalar-prefetched uid steering the residual window, a compare-count
// encode and a one-hot decode; a grid that runs in order lets masked slots
// write their window back unchanged, slot 0 rotated to run last.  Blocks run
// in parallel here, so masked slots SKIP the write instead (adding
// ((val - dec) - car) * 0 changes nothing), and the one unmasked slot of a
// uid is its only writer: no atomics.  A masked slot still reads the carry
// for its own code (car * 0), a read that may race the real slot's write;
// only the sign of that zero can depend on it, and it vanishes in
// rows + (+-0) unless the pad's row is -0, which a zero-gradient pad is not.
// The decode is one table read (dec = values[code]), so 16-bit tables run
// here too: the TPU sent them to its reference because a one-hot decode
// over 2^16 values wastes vector time.
//
// Layout: touched_rows.cuh's walk, as merge_apply's apply mode.  A
// persistent grid (SMs x resident blocks), so each block stages the 8-bit
// table once, not once for every 256 values; warps take tiles of slots
// whose uids and masks are loaded once, coalesced, a tile ahead, and reach
// the lanes by shuffle.  Lanes run over a row's columns, float4 where
// d % 4 == 0 and rows, residual, dec and codes are aligned (8 lanes a row
// at d = 32), one float otherwise; at d = 1 a lane takes whole slots.  A
// lane starts the payload and carry loads of kVecRows rows (kScalarRows,
// kOwnRows) before the first search, with the next tile's uids and masks
// in flight.  The searches are quantile_search.cuh's, which B6 and B7
// share.  Up to 8 bits (shared_code) the boundaries are an Eytzinger tree
// in shared memory, its 8 levels written out, so a lane's V searches are
// independent chains of shared-memory reads that interleave and a warp's
// reads of one level spread over the banks, and the values sit beside it;
// a loop of the table's runtime depth over the sorted array kept the
// searches one after another, and its probes of one level shared a bank.
// Above 8 bits the two-stage search (split_code): a top tree in dynamic
// shared memory, staged once a block, then one float4 load of a segment,
// in 1024-thread blocks, one an SM, decoded by one read of values through
// the read-only path; the sorted-array lower bound it replaced made 17
// dependent reads of a table that misses L1.  The searches,
// not the bytes, set the pace here: one row a float4 lane (4 searches)
// keeps the registers low enough for 32 warps an SM, and more rows a lane
// measured slower on the H100.  Codes are stored V at once: 4 one-byte
// codes a word, 4 two-byte codes in two words.  The flat loop this
// replaced ran one value a thread behind a barrier, with a 64-bit
// division by d for its slot.
//
// Rounding: __fadd_rn, __fsub_rn and __fmul_rn in the reference's order, so
// nvcc cannot contract them into FMAs: codes, dec and the residual are
// bit-identical to the plain version (quantize_pack_ef_update_plain in
// lightctr_tpu_torch/ops/sparse_kernels.py).
//
// Bound: bytes.  Per value the function reads the row, the carry and
// (once per slot) the uid and mask, writes the code, dec and (for an
// unmasked slot) the carry: at the exchange's shape (79,872 slots x 32)
// about 43 MB at 8 bits, 0.013 ms at 3.35 TB/s.
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
  const int32_t* uids;
  float* residual;
  const float* mask;
  long long d, vocab;
  void* codes;
  float* dec_out;
};

// The epilogue on touched_rows.cuh's walk: V columns of one slot's row.
// load() reads the payload and, through the uid, the carry; put() encodes,
// decodes and writes the code, dec and (an unmasked slot in the table)
// the carry.
template <int V, typename Code, bool kTree>
struct EfUpdate : EfArgs {
  using F = typename lct::FloatVec<V>::T;

  struct Slot {
    int32_t uid;
    float m;
  };
  struct Ctx {
    long long e;  // the element of residual, -1: outside the table
    F x, car;
  };

  __device__ Slot slot(long long i) const {
    return {__ldg(uids + i), __ldg(mask + i)};
  }

  __device__ bool skip(long long, const Slot&) const { return false; }

  __device__ Ctx load(long long i, const Slot& k, long long c) const {
    Ctx x;
    x.x = lct::stream_vec<V>(rows + i * d + c);
    const long long row = k.uid < 0 ? (long long)k.uid + vocab : k.uid;
    x.e = row >= 0 && row < vocab ? row * d + c : -1;
    x.car = x.e >= 0 ? lct::load_vec<V>(residual + x.e)
                     : lct::fill_vec<V>(__int_as_float(0x7fc00000));
    return x;
  }

  __device__ void put(Ctx& x, long long i, const Slot& k, long long c) const {
    lct::CodeVec<Code, V> code;
    F dec;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float car = lct::lane_of(x.car, j);
      const float val = __fadd_rn(lct::lane_of(x.x, j), __fmul_rn(car, k.m));
      int q;
      float dv;
      if constexpr (kTree) {
        q = lct::shared_code(val, t.nb);
        dv = lct::s_val[q];
      } else {
        q = lct::split_code(t, val);
        dv = __ldg(values + q);
      }
      code.c[j] = (Code)q;
      lct::lane_of(dec, j) = dv;
      lct::lane_of(x.car, j) =
          __fadd_rn(car, __fmul_rn(__fsub_rn(__fsub_rn(val, dv), car), k.m));
    }
    const long long e = i * d + c;
    *reinterpret_cast<lct::CodeVec<Code, V>*>(static_cast<Code*>(codes) + e) =
        code;
    lct::store_vec<V>(dec_out + e, dec);
    if (x.e >= 0 && k.m != 0.0f) lct::store_vec<V>(residual + x.e, x.car);
  }
};

template <int V, int U, bool kOwn, typename Code, bool kTree>
__global__ void __launch_bounds__(kTree ? kTreeThreads : lct::kSplitThreads)
    ef_update(EfUpdate<V, Code, kTree> op, lct::TouchedRows w) {
  if constexpr (kTree)
    lct::stage_tree(op.t.bnd, op.t.nb, op.values);
  else
    lct::stage_split(op.t);
  lct::walk_touched_rows<V, U, kOwn>(w, op);
}

template <int V, typename Code, bool kTree>
cudaError_t launch_width(const EfArgs& a, long long s, cudaStream_t stream) {
  const EfUpdate<V, Code, kTree> op{a};
  return lct::launch_touched_rows<V, V == 4 ? kVecRows : kScalarRows,
                                  kOwnRows>(
      s, a.d, [&](auto u, auto own, const lct::TouchedRows& w) {
        constexpr int U = decltype(u)::value;
        constexpr bool kOwn = decltype(own)::value;
        const auto kernel = ef_update<V, U, kOwn, Code, kTree>;
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

template <typename Code>
int launch(const void* bnd, long long nb, const void* values,
           const void* rows, const void* uids, void* residual,
           const void* mask, long long s, long long d, long long vocab,
           void* codes, void* dec, void* stream_ptr) {
  if (s <= 0 || d <= 0) return (int)cudaSuccess;
  if (nb < 1 || nb > 65535 || reinterpret_cast<uintptr_t>(bnd) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const EfArgs a{lct::split_table(static_cast<const float*>(bnd), (int)nb),
                 static_cast<const float*>(values),
                 static_cast<const float*>(rows),
                 static_cast<const int32_t*>(uids),
                 static_cast<float*>(residual),
                 static_cast<const float*>(mask),
                 d,
                 vocab,
                 codes,
                 static_cast<float*>(dec)};
  const bool tree = nb < lct::kTreeNodes;
  // float4 lanes also need the codes on a whole word (4 codes at once)
  if (lct::rows_take_float4(d, {rows, residual, dec}) &&
      reinterpret_cast<uintptr_t>(codes) % (4 * sizeof(Code)) == 0)
    return (int)(tree ? launch_width<4, Code, true>(a, s, stream)
                      : launch_width<4, Code, false>(a, s, stream));
  return (int)(tree ? launch_width<1, Code, true>(a, s, stream)
                    : launch_width<1, Code, false>(a, s, stream));
}

}  // namespace

extern "C" int quantize_pack_ef_update_u8(
    const void* bnd, long long nb, const void* values, const void* rows,
    const void* uids, void* residual, const void* mask, long long s,
    long long d, long long vocab, void* codes, void* dec, void* stream) {
  return launch<uint8_t>(bnd, nb, values, rows, uids, residual, mask, s, d,
                         vocab, codes, dec, stream);
}

extern "C" int quantize_pack_ef_update_u16(
    const void* bnd, long long nb, const void* values, const void* rows,
    const void* uids, void* residual, const void* mask, long long s,
    long long d, long long vocab, void* codes, void* dec, void* stream) {
  return launch<uint16_t>(bnd, nb, values, rows, uids, residual, mask, s, d,
                          vocab, codes, dec, stream);
}
