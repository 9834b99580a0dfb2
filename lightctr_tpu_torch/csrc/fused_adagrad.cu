// fused_adagrad: dense Adagrad in place over flat fp32 w, accum, grad [N]
//
//   accum' = accum + g*g
//   w'     = w - lr * g * rsqrt(accum' + eps)
//
// Replaces the TPU kernel lightctr_tpu/optim/fused_adagrad.py
// _adagrad_pallas/_kernel: a grid of 65536-element blocks, the outputs
// aliased to w and accum.  Here one grid-stride elementwise pass, in place:
// 16-byte float4 loads and stores where all three pointers are 16-byte
// aligned and N % 4 == 0, scalar ones otherwise.  No shared memory: each
// element is read once and written once.
//
// Rounding: each operation is written with an _rn intrinsic in the plain
// version's order (g*g, a + g*g, a' + eps, lr*g, (lr*g)*r, w - ...) so nvcc
// cannot contract them into FMAs; rsqrtf matches torch.rsqrt on the card.
//
// Bound: bytes.  Three floats read and two written per element, 20*N bytes:
// 671 MB for FM's v table at N = 2^25, 0.20 ms at 3.35 TB/s.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError() after
// the launch, which the Python wrapper turns into an exception.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;  // H100 SMs x resident blocks

__device__ __forceinline__ void adagrad(float& w, float& a, float g, float lr,
                                        float eps) {
  a = __fadd_rn(a, __fmul_rn(g, g));
  w = __fsub_rn(w, __fmul_rn(__fmul_rn(lr, g), rsqrtf(__fadd_rn(a, eps))));
}

__global__ void adagrad_vec4(float4* __restrict__ w, float4* __restrict__ a,
                             const float4* __restrict__ g, long long n4,
                             float lr, float eps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 wv = w[i], av = a[i];
    const float4 gv = g[i];
    adagrad(wv.x, av.x, gv.x, lr, eps);
    adagrad(wv.y, av.y, gv.y, lr, eps);
    adagrad(wv.z, av.z, gv.z, lr, eps);
    adagrad(wv.w, av.w, gv.w, lr, eps);
    a[i] = av;
    w[i] = wv;
  }
}

__global__ void adagrad_scalar(float* __restrict__ w, float* __restrict__ a,
                               const float* __restrict__ g, long long n,
                               float lr, float eps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float wv = w[i], av = a[i];
    adagrad(wv, av, g[i], lr, eps);
    a[i] = av;
    w[i] = wv;
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" int fused_adagrad_f32(void* w, void* accum, const void* grad,
                                 long long n, float lr, float eps,
                                 void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = n % 4 == 0 &&
                   (((uintptr_t)w | (uintptr_t)accum | (uintptr_t)grad) &
                    15) == 0;
  if (vec) {
    adagrad_vec4<<<grid_for(n / 4), kThreads, 0, stream>>>(
        static_cast<float4*>(w), static_cast<float4*>(accum),
        static_cast<const float4*>(grad), n / 4, lr, eps);
  } else {
    adagrad_scalar<<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<float*>(w), static_cast<float*>(accum),
        static_cast<const float*>(grad), n, lr, eps);
  }
  return (int)cudaGetLastError();
}
