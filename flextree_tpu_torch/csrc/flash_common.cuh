// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu), for Hopper (sm_90a).
//
// Layout: q, k, v, o, do are contiguous (B, T, H, D) tensors, read in place
// by stride (no (B*H, T, D) copy); lse and its cotangent are (B, H, Tq)
// float32.  Every kernel runs 256 threads on 64-row tiles: the "owner" rows
// of a CTA (q rows for the forward and dq, k rows for dk/dv) and the 64 rows
// of the other operand it walks over.  Thread (ty, tx) = (tid / 16, tid %
// 16) owns owner rows ty*4 .. ty*4+3, score columns tx + 16*c (c < 4) and
// head dims tx + 16*j (j < DM/16).  The 16 threads of a row group are 16
// consecutive lanes of one warp, so row reductions are four xor shuffles.
//
// Shared-memory tiles are float32, row stride DM + 1 (odd), so that the
// column walks of the score products hit 16 distinct banks; head dims past
// D and rows past T load as zero.  DM is the head dim rounded up to 32, 64
// or 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ftflash {

constexpr float kNegInf = -1e30f;      // masked score
constexpr float kSentinel = 1e30f;     // lse of a row that sees no key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kRows = 64;              // rows of every tile
constexpr int kThreads = 256;
constexpr int kRpt = 4;                // owner rows per thread
constexpr int kCpt = 4;                // score columns per thread
constexpr int kLP = kRows + 1;         // row stride of a (64 x 64) tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to E (the cast the TPU kernels make before a product)
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<E>(x));
}

// floor(a / b) for b > 0 and any a (C++ division truncates)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Sum / max over the 16 lanes of a row group.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows [row0, row0 + 64) of one (b, h) slice into a (64 x DM) float tile
// of row stride DM + 1.  `src` points at element (b, 0, h, 0); rows are H*D
// elements apart.  With `prescale` each value is multiplied by `mul` and
// rounded to E (the log2-domain pre-scale, in the input's own dtype).
template <typename E, int DM>
__device__ __forceinline__ void load_tile(float* dst, const E* __restrict__ src,
                                          int row0, int t_len, int H, int D,
                                          bool prescale = false,
                                          float mul = 1.f) {
  const size_t row_stride = static_cast<size_t>(H) * D;
  for (int idx = threadIdx.x; idx < kRows * DM; idx += kThreads) {
    const int r = idx / DM;
    const int d = idx - r * DM;
    const int row = row0 + r;
    float x = 0.f;
    if (row < t_len && d < D) {
      x = to_f32(src[static_cast<size_t>(row) * row_stride + d]);
      if (prescale) x = round_to<E>(x * mul);
    }
    dst[r * (DM + 1) + d] = x;
  }
}

// Dynamic shared memory above 48 KB needs this attribute on the kernel
// (set before every launch; it is cheap and keeps the entry points
// stateless).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ftflash
