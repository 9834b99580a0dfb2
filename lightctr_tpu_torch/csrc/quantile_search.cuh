// The quantile codec's encode for one value, shared by quantize_pack.cu
// (B6), quantize_pack_ef.cu (B7) and quantize_pack_ef_update.cu (B8):
// searchsorted(boundaries, x, side='left'), the number of boundaries
// strictly below x, as ops/quantize.py `compress` computes it.  NaN takes
// code nb, as the JAX reference's searchsorted gives it (a compare-count,
// like the TPU kernel _qp_kernel, would give 0); +inf takes nb and -inf 0.
//
// Two searches:
//
//   - Up to 8 bits (nb <= 255): the boundaries as an Eytzinger tree in
//     shared memory (s_tree, staged by stage_tree, searched by
//     shared_code), 8 levels written out.  A level's nodes sit side by
//     side, so a warp's reads at the first six levels hit distinct banks (a
//     sorted array's probes of one level share a bank, up to 8-way), and
//     with no loop of a runtime length a thread's searches interleave.
//   - Above 8 bits (up to 65,535 boundaries, 256 KB, more than a block's
//     shared memory): two stages (SplitTable, stage_split, split_code).
//     The top kTopLevels levels are an Eytzinger tree in shared memory over
//     segments of kSegWidth boundaries (a segment's key is its last
//     boundary); the search then counts, without a branch, the boundaries
//     below x inside the one segment it lands in, read as kSegWidth / 4
//     independent float4 loads through the read-only path (the table stays
//     in the L2).  That replaces a chain of 17 dependent reads with
//     kTopLevels shared-memory reads and one batch of loads.  Segments
//     start on 16 bytes: the head, the 0-3 boundaries before the first
//     aligned one, is counted apart (a table's boundaries are often a view
//     one float into its edges).
//
// Every search counts only the nb real boundaries: the tree's padding nodes
// are +inf, which never count, and a segment's positions past nb are
// masked.  So every table of 1 to 16 bits gives the plain version's codes.
// tests/test_torch_quantize_kernels.py models this index arithmetic in
// numpy and holds it to np.searchsorted and to the JAX package's compress.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace lct {

// Node i (1 <= i < 2^L) of a perfect search tree of L levels in Eytzinger
// order (node i's children at 2i and 2i + 1, index 0 unused) holds the key
// whose sorted index is its in-order rank.
template <int L>
__device__ __forceinline__ int tree_rank(int i) {
  const int level = 31 - __clz(i);
  return ((2 * (i - (1 << level)) + 1) << (L - 1 - level)) - 1;
}

// The node of an L-level tree that holds the key of sorted index r
// (tree_rank's inverse).
template <int L>
__device__ __forceinline__ int tree_node(int r) {
  const int z = __ffs(r + 1) - 1;  // the node's height above the last level
  return (1 << (L - 1 - z)) + ((r + 1) >> (z + 1));
}

// Descend an L-level tree: right past every node below x.  Returns the
// number of keys below x (NaN descends left to 0).
template <int L>
__device__ __forceinline__ int tree_descend(const float* tree, float x) {
  int i = 1;
#pragma unroll
  for (int level = 0; level < L; ++level)
    i = 2 * i + (tree[i] < x ? 1 : 0);
  return i - (1 << L);
}

// -- up to 8 bits: the whole table in shared memory ---------------------------

constexpr int kTreeLevels = 8;
constexpr int kTreeNodes = 1 << kTreeLevels;  // 256: tables up to 8 bits

// The table's boundaries as the tree (+inf past the last boundary) and its
// values (B7, B8's decode), staged once a block.
__shared__ float s_tree[kTreeNodes];
__shared__ float s_val[kTreeNodes];

// Every thread of the block: stage nb <= 255 boundaries as the tree and,
// where values is not null, the nb + 1 values; then a barrier.
__device__ __forceinline__ void stage_tree(const float* bnd, int nb,
                                           const float* values) {
  for (int i = threadIdx.x + 1; i < kTreeNodes; i += blockDim.x) {
    const int r = tree_rank<kTreeLevels>(i);
    s_tree[i] = r < nb ? bnd[r] : INFINITY;
  }
  if (values != nullptr)
    for (int i = threadIdx.x; i <= nb; i += blockDim.x) s_val[i] = values[i];
  __syncthreads();
}

// The code of x on the staged tree: the +inf nodes never count, so every
// table up to 8 bits gives the sorted search's code.
__device__ __forceinline__ int shared_code(float x, int nb) {
  const int code = tree_descend<kTreeLevels>(s_tree, x);
  return isnan(x) ? nb : code;
}

// -- above 8 bits: a top tree in shared memory, then one segment --------------

// The split, set by a sweep on the H100 (PERF.md §6): 14 levels (64 KB of
// shared memory) over segments of 4 boundaries (one float4 load).  Each
// float4 load of a warp whose lanes read scattered segments costs the L1
// about as much as a level of the tree costs the shared memory, so one
// load and two more levels beat four loads (12 levels, 16 a segment) and
// two (13 levels, 8).
constexpr int kTopLevels = 14;
constexpr int kSegWidth = 4;
static_assert(kSegWidth % 4 == 0, "segments are whole float4 loads");
static_assert((1LL << kTopLevels) * kSegWidth >= 65535,
              "the top tree covers a 16-bit table");

// The top tree, in the block's dynamic shared memory: a split kernel
// launches with kSplitSmem bytes of it (split_smem_attr lifts the 48 KB
// default where the tree needs more).
extern __shared__ float s_top[];
constexpr size_t kSplitSmem = sizeof(float) << kTopLevels;

template <typename Kernel>
cudaError_t split_smem_attr(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSplitSmem);
}

// Every block stages the top tree from the L2 (its 2^kTopLevels - 1 keys
// are a quarter of a 16-bit table), so the split's kernels launch few,
// wide blocks: kSplitThreads a block, at most kSplitBlocksPerSm on an SM.
constexpr int kSplitThreads = 1024;
constexpr int kSplitBlocksPerSm = 1;

// A table above 8 bits as the split search reads it.
struct SplitTable {
  const float* bnd;
  int nb;
  int head;  // boundaries before the first 16-byte aligned one (0-3)
  int nseg;  // segments of kSegWidth boundaries after the head
};

// Host: the split of nb boundaries at bnd (a float pointer: 4-byte
// aligned).  nb <= 65,535.
inline SplitTable split_table(const float* bnd, int nb) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(bnd) % 16) / 4;
  int head = (4 - mis) % 4;
  if (head > nb) head = nb;
  return {bnd, nb, head, (nb - head + kSegWidth - 1) / kSegWidth};
}

// Every thread of the block: stage the top tree, segment r's key its last
// boundary (+inf from the last segment on: a search lands in it past every
// key), then a barrier.  A warp reads the keys of consecutive segments, so
// its reads share the L2's sectors where segments are narrower than one.
__device__ __forceinline__ void stage_split(const SplitTable& t) {
  for (int r = threadIdx.x; r < (1 << kTopLevels) - 1; r += blockDim.x)
    s_top[tree_node<kTopLevels>(r)] =
        r < t.nseg - 1
            ? __ldg(t.bnd + t.head + r * kSegWidth + kSegWidth - 1)
            : INFINITY;
  __syncthreads();
}

// The code of x on the staged top tree: segment j holds the first key not
// below x, so the head and segments 0 .. j-1 all count (for j = 0 the
// head is compared); then the boundaries below x among segment j's, its
// positions past nb masked.  Loads of a float4 past nb start before nb:
// they stay in the table's last 16 bytes.
__device__ __forceinline__ int split_code(const SplitTable& t, float x) {
  const int j = tree_descend<kTopLevels>(s_top, x);
  const int first = t.head + j * kSegWidth;
  const float4* seg = reinterpret_cast<const float4*>(t.bnd + first);
  float4 b[kSegWidth / 4];
#pragma unroll
  for (int c = 0; c < kSegWidth / 4; ++c)
    b[c] = first + 4 * c < t.nb
               ? __ldg(seg + c)
               : make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
  int code = j * kSegWidth;
  if (j == 0) {
    for (int k = 0; k < t.head; ++k) code += __ldg(t.bnd + k) < x ? 1 : 0;
  } else {
    code += t.head;
  }
  const int room = t.nb - first;  // positions of segment j below nb
#pragma unroll
  for (int c = 0; c < kSegWidth / 4; ++c) {
    const int p = 4 * c;
    code += (p < room && b[c].x < x ? 1 : 0) +
            (p + 1 < room && b[c].y < x ? 1 : 0) +
            (p + 2 < room && b[c].z < x ? 1 : 0) +
            (p + 3 < room && b[c].w < x ? 1 : 0);
  }
  return isnan(x) ? t.nb : code;
}

// -- codes stored four at a time ----------------------------------------------

// V codes stored at once: 4 one-byte codes are one word, 4 two-byte codes
// two words.
template <typename Code, int V>
struct CodeVec {
  Code c[V];
};
template <>
struct alignas(4) CodeVec<uint8_t, 4> {
  uint8_t c[4];
};
template <>
struct alignas(8) CodeVec<uint16_t, 4> {
  uint16_t c[4];
};

}  // namespace lct
