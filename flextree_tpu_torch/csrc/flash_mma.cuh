// Tensor-core building blocks of the bfloat16 flash kernels
// (flash_fwd.cu, flash_bwd_dkv.cu), for Hopper (sm_90a).
//
// The kernels run 4 warps (128 threads) on 64-row tiles; each warp owns 16
// rows of the tile the CTA keeps (q rows in the forward, k rows in dk/dv)
// and multiplies them with mma.sync.m16n8k16 (bf16 inputs, float32
// accumulation).  Operands reach the registers through ldmatrix from
// shared memory, where tiles are bf16 with a row stride of DM + 8 elements:
// 16 bytes of padding, so the eight row addresses of each ldmatrix phase
// fall in eight distinct 16-byte bank groups (no conflicts).  Tiles arrive
// by cp.async, 16 bytes a thread; rows past T and head dims past D are
// zero-filled by the copy's src-size operand, never by padding the tensor.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * g + t.
// - A (16 x 16, row-major): a0 = (row g, cols 2t, 2t+1), a1 = row g + 8,
//   a2 = row g, cols + 8, a3 = row g + 8, cols + 8.
// - B (16 x 8, "col"): b0 = (k 2t, 2t+1; col g), b1 = k + 8.
// - C (16 x 8, float): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = row g + 8.
// So a C tile pair (cols 0..15) repacks as an A fragment with no trip
// through shared memory: that is how p and ds enter their second product.

#pragma once

#include "flash_common.cuh"

namespace ftflash {

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows = one 64-row tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; only the first `bytes` (0 or
// 16) are read and the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b on the tensor cores (16 x 16 by 16 x 8, float32 accumulate)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz, ~2 ulp, as exp2f:
// exp2f's extra instructions only keep results below 2^-126 from flushing
// to 0, and a p that small is lost in any float32 sum it joins)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, the first in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The A fragment of the 16 x 16 chunk held by the C tiles c0 (cols 0..7)
// and c1 (cols 8..15), as kTerms bf16 terms: term 0 is each value rounded
// to bf16, each later term the remainder of the terms before it, rounded
// again.  One term rounds the operand, as the TPU kernels' casts do; three
// carry it to ~2^-26 relative, a float32 operand's precision (p in dv).
template <int kTerms>
__device__ __forceinline__ void c_to_a(const float c0[4], const float c1[4],
                                       uint32_t a[kTerms][4]) {
  float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[t][i] = pack_bf16(x[2 * i], x[2 * i + 1]);
      if (t + 1 < kTerms) {
        x[2 * i] -= round_bf16(x[2 * i]);
        x[2 * i + 1] -= round_bf16(x[2 * i + 1]);
      }
    }
  }
}

// Quad reductions: the 4 lanes (t = 0..3) that hold one C row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + 64) of one (b, h) slice into a (64 x DM) bf16 tile
// of row stride DM + 8, by cp.async (the caller commits and waits).
// `src` points at element (b, 0, h, 0) and must be 16-byte aligned; rows
// are `row_stride` elements apart (H * D, a multiple of 8).  Thread i
// copies chunk i % (DM / 8) of rows i / (DM / 8) + k * (128 / (DM / 8)): a
// fixed trip count, so the addresses are a few adds a chunk.
template <int DM>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int row0, int t_len,
                                                int row_stride, int D) {
  constexpr int kChunks = DM / 8;                  // 16-byte chunks a row
  constexpr int kPass = kMmaThreads / kChunks;     // rows a pass
  const int c = threadIdx.x % kChunks;
  const int r = threadIdx.x / kChunks;
  const bool col_ok = c * 8 < D;
  const bf16* from = src + static_cast<size_t>(row0 + r) * row_stride + c * 8;
  bf16* to = dst + r * (DM + 8) + c * 8;
  const size_t step = static_cast<size_t>(kPass) * row_stride;
#pragma unroll
  for (int k = 0; k < kRows / kPass; ++k) {
    const bool ok = col_ok && row0 + r + k * kPass < t_len;
    cp_async16(to + k * kPass * (DM + 8), ok ? from + k * step : src,
               ok ? 16 : 0);
  }
}

// two bf16 (one 32-bit word) times `mul`, each rounded back to bf16
__device__ __forceinline__ uint32_t prescale_pair(uint32_t w, float mul) {
  return pack_bf16(__uint_as_float(w << 16) * mul,
                   __uint_as_float(w & 0xffff0000u) * mul);
}

// Every element of a landed (64 x DM) tile multiplied by `mul` and rounded
// to bf16: the log2-domain pre-scale in the input's own dtype (zeros stay
// zero).
template <int DM>
__device__ __forceinline__ void prescale_tile(bf16* tile, float mul) {
  constexpr int kChunks = DM / 8;
  constexpr int kPass = kMmaThreads / kChunks;
  const int c = threadIdx.x % kChunks;
  const int r = threadIdx.x / kChunks;
#pragma unroll
  for (int k = 0; k < kRows / kPass; ++k) {
    uint4* at =
        reinterpret_cast<uint4*>(tile + (r + k * kPass) * (DM + 8) + c * 8);
    uint4 w = *at;
    w.x = prescale_pair(w.x, mul);
    w.y = prescale_pair(w.y, mul);
    w.z = prescale_pair(w.z, mul);
    w.w = prescale_pair(w.w, mul);
    *at = w;
  }
}

// One warp's 16 rows of a (64 x DM) shared tile out to global memory, 16
// bytes a lane: rows >= t_len and head dims >= D are not written.
template <int DM>
__device__ __forceinline__ void store_rows(const bf16* tile, int warp,
                                           bf16* __restrict__ dst, int row0,
                                           int t_len, int row_stride, int D) {
  constexpr int kChunks = DM / 8;
  constexpr int kPass = 32 / kChunks;  // rows a pass of the warp
  const int lane = threadIdx.x & 31;
  const int c = lane % kChunks;
#pragma unroll
  for (int k = 0; k < 16 / kPass; ++k) {
    const int r = warp * 16 + k * kPass + lane / kChunks;
    const int row = row0 + r;
    if (row < t_len && c * 8 < D)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * row_stride +
                                c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * (DM + 8) + c * 8);
  }
}

// ldmatrix row addresses.  Lane l feeds row (l & 7) of matrix l >> 3.
// A fragment of rows [r0, r0 + 16), cols [c0, c0 + 16) of a row-major tile
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int ld,
                                              int r0, int c0, int lane) {
  return tile + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + c0 +
         (lane >> 4) * 8;
}
// B fragments (non-trans) of two n-blocks: rows [n0, n0 + 16) of a tile
// whose rows are the product's n and whose cols are its k, at k0; regs 0-1
// are n-block n0, regs 2-3 n-block n0 + 8
__device__ __forceinline__ const bf16* bn_addr(const bf16* tile, int ld,
                                               int n0, int k0, int lane) {
  return tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
// B fragments (trans) of two n-blocks: rows [k0, k0 + 16) of a tile whose
// rows are the product's k and whose cols are its n, at n0; regs 0-1 are
// n-block n0, regs 2-3 n-block n0 + 8
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int ld,
                                               int k0, int n0, int lane) {
  return tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 +
         (lane >> 4) * 8;
}

}  // namespace ftflash
