// quantize_pack: codes[i] = searchsorted(boundaries, x[i], side='left')
//
// The encode of every coded collective (dist/collectives.py): float32 values
// to uint8 codes (tables of up to 8 bits) or uint16 codes (up to 16 bits),
// bit-identical to ops/quantize.py `compress` (the plain version,
// quantize_pack_plain in lightctr_tpu_torch/ops/sparse_kernels.py) and to
// the JAX package's `quantize.compress`, NaN and +-inf included: NaN and
// +inf take the top code nb, -inf code 0.
//
// Replaces the TPU kernels lightctr_tpu/ops/sparse_kernels.py _qp_pallas:
// _qp_kernel (up to 8 bits, a compare-count sweep of every boundary per
// value, which suits the TPU's wide vector unit) and _qp_search_kernel
// (16 bits, a binary search over the boundary table in VMEM).
//
// Layout: the payload is flat.  A persistent grid (SMs x resident blocks)
// of lanes streams it as float4 vectors (__ldcs: read once), vector v of
// the body to lane v mod lanes, kVecs vectors a lane at a time, the next
// kVecs in flight while these are searched; the first kVecs are in flight
// before the block stages its table.  Each block stages the table once:
// up to 8 bits the boundaries as an Eytzinger tree in shared memory
// (quantile_search.cuh's shared_code, B8's search); above 8 bits the top
// tree of the two-stage search (split_code), in few wide blocks, since
// every block reads the top tree's keys from the L2.  A lane's 4 kVecs
// searches are independent chains that interleave.  Four codes are stored
// at once: one 32-bit store at 8 bits, one 64-bit store at 16.  A payload
// that does not start on 16 bytes (the coded ring encodes segment views,
// dist/collectives.py) takes its first 0-3 values and its last 0-3 as
// scalars; codes that do not share the payload's alignment are stored one
// at a time.  The flat loop this replaced ran one value a thread on up to
// 8192 blocks, each staging the table behind a barrier, searched the
// sorted array (a warp's probes of one level sharing a bank) and, at 16
// bits, made 17 dependent reads of a table that misses L1.
//
// Bound: bytes.  The function reads 4 bytes and writes 1 (or 2) per value:
// at the sparse exchange's payload (79,872 x 32 values) 12.8 MB at 8 bits,
// 0.004 ms at 3.35 TB/s.  The search's compares are a few dozen operations
// per value, far under the card's rate; its shared-memory reads (8 a value
// at 8 bits, 12 above) are what the warm L2 leaves to pace it.
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
constexpr int kVecs = 1;  // float4 vectors a lane searches at a time

// The entry's arguments: t is the boundaries (t.bnd, t.nb), as the split
// search reads them above 8 bits.
struct PackArgs {
  lct::SplitTable t;
  const float* x;
  long long n;
  int head;         // values before x's first 16-byte boundary
  long long nvec;   // float4 vectors after the head
  void* codes;
};

template <bool kTree>
__device__ __forceinline__ int code_of(const lct::SplitTable& t, float v) {
  if constexpr (kTree)
    return lct::shared_code(v, t.nb);
  else
    return lct::split_code(t, v);
}

template <int U>
__device__ __forceinline__ void fetch(const float4* xv, long long nvec,
                                      long long v0, long long lanes,
                                      float4 (&buf)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long v = v0 + u * lanes;
    buf[u] = v < nvec ? __ldcs(xv + v) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// kVecCodes: the codes of the body start on 4 codes (a word at 8 bits).
template <typename Code, bool kTree, bool kVecCodes>
__global__ void __launch_bounds__(kTree ? kTreeThreads : lct::kSplitThreads)
    encode(PackArgs a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lanes = (long long)gridDim.x * blockDim.x;
  const float4* xv = reinterpret_cast<const float4*>(a.x + a.head);
  Code* codes = static_cast<Code*>(a.codes);
  float4 next[kVecs];
  fetch<kVecs>(xv, a.nvec, lane, lanes, next);
  if constexpr (kTree)
    lct::stage_tree(a.t.bnd, a.t.nb, nullptr);
  else
    lct::stage_split(a.t);

  // the scalar head and tail, at most 3 values each
  const long long tail = a.head + 4 * a.nvec;
  if (lane < a.head) codes[lane] = (Code)code_of<kTree>(a.t, a.x[lane]);
  if (lane < a.n - tail)
    codes[tail + lane] = (Code)code_of<kTree>(a.t, a.x[tail + lane]);

  for (long long v0 = lane; v0 < a.nvec; v0 += kVecs * lanes) {
    float4 cur[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) cur[u] = next[u];
    fetch<kVecs>(xv, a.nvec, v0 + kVecs * lanes, lanes, next);
    lct::CodeVec<Code, 4> c[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      c[u].c[0] = (Code)code_of<kTree>(a.t, cur[u].x);
      c[u].c[1] = (Code)code_of<kTree>(a.t, cur[u].y);
      c[u].c[2] = (Code)code_of<kTree>(a.t, cur[u].z);
      c[u].c[3] = (Code)code_of<kTree>(a.t, cur[u].w);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const long long v = v0 + u * lanes;
      if (v >= a.nvec) break;
      Code* out = codes + a.head + 4 * v;
      if constexpr (kVecCodes) {
        *reinterpret_cast<lct::CodeVec<Code, 4>*>(out) = c[u];
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = c[u].c[k];
      }
    }
  }
}

template <typename Code, bool kTree, bool kVecCodes>
cudaError_t launch_kind(const PackArgs& a, cudaStream_t stream) {
  const auto kernel = encode<Code, kTree, kVecCodes>;
  const int threads = kTree ? kTreeThreads : lct::kSplitThreads;
  // one warp's tile: 32 lanes of kVecs vectors
  const long long tiles = (a.nvec + 32 * kVecs - 1) / (32 * kVecs);
  const size_t smem = kTree ? 0 : lct::kSplitSmem;
  if (!kTree && lct::split_smem_attr(kernel) != cudaSuccess)
    return cudaGetLastError();
  const unsigned grid = lct::grid_for(kernel, threads, tiles, kMaxBlocks,
                                      kTree ? 0 : lct::kSplitBlocksPerSm,
                                      smem);
  if (grid == 0) return cudaGetLastError();
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename Code>
int launch(const void* bnd, long long nb, const void* x, long long n,
           void* codes, void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  if (nb < 1 || nb > 65535 || reinterpret_cast<uintptr_t>(bnd) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  PackArgs a;
  a.t = lct::split_table(static_cast<const float*>(bnd), (int)nb);
  a.x = static_cast<const float*>(x);
  a.n = n;
  a.head = (int)((4 - reinterpret_cast<uintptr_t>(x) % 16 / 4) % 4);
  if (a.head > n) a.head = (int)n;
  a.nvec = (n - a.head) / 4;
  a.codes = codes;
  const bool vec_codes =
      reinterpret_cast<uintptr_t>(static_cast<Code*>(codes) + a.head) %
          (4 * sizeof(Code)) ==
      0;
  const bool tree = nb < lct::kTreeNodes;
  cudaError_t err;
  if (tree)
    err = vec_codes ? launch_kind<Code, true, true>(a, stream)
                    : launch_kind<Code, true, false>(a, stream);
  else
    err = vec_codes ? launch_kind<Code, false, true>(a, stream)
                    : launch_kind<Code, false, false>(a, stream);
  return (int)err;
}

}  // namespace

extern "C" int quantize_pack_u8(const void* bnd, long long nb, const void* x,
                                long long n, void* codes, void* stream) {
  return launch<uint8_t>(bnd, nb, x, n, codes, stream);
}

extern "C" int quantize_pack_u16(const void* bnd, long long nb, const void* x,
                                 long long n, void* codes, void* stream) {
  return launch<uint16_t>(bnd, nb, x, n, codes, stream);
}
