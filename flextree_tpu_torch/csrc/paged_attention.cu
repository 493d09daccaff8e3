// Paged decode attention for one new token per slot, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_paged_kernel` of
// flextree_tpu/ops/paged_attention.py (launched by `_stream_pallas`).  Per
// slot s and head h it computes
//
//     out[s, h] = softmax over positions 0..length[s] of (q . k) * scale, times v
//
// where positions < length[s] live in the K/V pools at
// pool[tables[s, pos / bs], pos % bs] and position length[s] is the new
// token (k_new, v_new).  Scores are taken in the storage dtype, then
// float32, times scale; the softmax is float32 and the new token is folded
// last.  The plain version of this kernel's partition and merge is
// flextree_tpu_torch/ops/paged_attention.py::paged_attention_split_plain;
// it differs from the one-block-at-a-time stream (`paged_attention_stream`)
// and the gather oracle only in float32 summation order.
//
// Bound: bytes.  Each (slot, head) reads length * D elements of K and of V
// once, about one multiply-add per element read, far below the card's
// ~295 operations per byte.  At the flagship decode (8 slots x 8 heads,
// D = 64, a few hundred positions a slot) that is ~3.6 MB, ~1 us at the
// memory rate: under one launch's latency, so what the design fights is
// latency, not bandwidth.
//
// Design: split-K over the sequence (flash-decoding), two kernels behind
// one entry point, on the caller's stream.
// - paged_split_kernel: one CTA of 128 threads per (chunk of
//   kBlocksPerSplit table blocks, head, slot); the grid is sized from the
//   table width P alone (the host never reads lengths), and a CTA whose
//   chunk starts at or past ceil(length / bs) exits at once.  It reads only
//   its own table entries and starts cp.async copies of every block's K
//   and V rows below length (16 bytes a thread, one commit group a block),
//   so block i + 1 and later load while block i's scores are computed.  A
//   score is one reduction over the D / 8 lanes that each hold 8 dims of q;
//   the chunk's max, exp and sum are split over the threads (each score
//   exponentiated once), and p . v is split over (position, 8 dims) and
//   summed over positions in a fixed order.  The CTA writes a float32
//   partial (m, l, acc[D]) to the workspace: a bf16 partial would add a
//   rounding point that the plain version does not have.
// - paged_combine_kernel: one CTA per (head, slot) merges that row's
//   partials in split order, never in arrival order, then folds the new
//   token, so two calls give the same bits.
// - Only positions < length are ever loaded: no table entry past
//   ceil(length / bs) and no row past length in the last block, so what an
//   unwritten or null block holds cannot reach the output, not even
//   through 0 * inf.  An inactive slot (length 0) reads no pool block and
//   returns v_new exactly (p_new = 1, l = 1).
//
// The C entry point allocates nothing: the wrapper passes the float32
// workspace, S * H * ceil(P / kBlocksPerSplit) * (D + 2) floats.  It
// returns the first launch error (cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// Table blocks per split: the plain version's KERNEL_BLOCKS_PER_SPLIT
// (ops/paged_attention.py) must equal it.
constexpr int kBlocksPerSplit = 4;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A score rounded to the storage dtype, as the plain version's einsum in
// the compute dtype rounds it before the float32 scale.
template <typename T>
__device__ __forceinline__ float round_to_storage(float x) {
  return to_f32(from_f32<T>(x));
}

// 8 consecutive elements (16-byte aligned) as float32
__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float x[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// positions of slot s below its length, clamped to the table's P * bs
__device__ __forceinline__ int slot_length(const int32_t* lengths, int s,
                                           int bs, int P) {
  const int length = lengths[s];
  return length < 0 ? 0 : (length > P * bs ? P * bs : length);
}

// Thread t holds dims [8 * (t % G), + 8) of positions t / G, + PP, ...:
// G = D / 8 lanes a position (a power of two, <= 32, inside one warp).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lengths,
                       float* __restrict__ ws, int n_blocks, int bs, int H,
                       int P, int n_split, float scale) {
  constexpr int G = D / 8;
  constexpr int PP = kThreads / G;               // positions a pass
  constexpr int CPR = D * sizeof(T) / 16;        // 16-byte chunks a row
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  // the combine kernel may start now: it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int length = slot_length(lengths, s, bs, P);
  const int blk0 = c * kBlocksPerSplit;
  if (blk0 * bs >= length) return;  // past the slot's last block
  const int n_pos = min(kBlocksPerSplit * bs, length - blk0 * bs);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int span = kBlocksPerSplit * bs;  // rows of the chunk
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + static_cast<size_t>(span) * D;
  float* sc = reinterpret_cast<float*>(sv + static_cast<size_t>(span) * D);
  float* red_acc = sc + span;        // (PP x D) p.v partials
  float* red = red_acc + PP * D;     // one value a warp

  const int tid = threadIdx.x;
  const size_t tok_stride = static_cast<size_t>(H) * D;
  const size_t blk_stride = static_cast<size_t>(bs) * tok_stride;
  const int32_t* row_tab = tables + static_cast<size_t>(s) * P + blk0;

  // every block's K and V rows below length, one commit group a block
#pragma unroll
  for (int i = 0; i < kBlocksPerSplit; ++i) {
    const int valid = min(bs, n_pos - i * bs);  // <= 0 past the chunk
    if (valid > 0) {
      int b = row_tab[i];
      b = b < 0 ? 0 : (b >= n_blocks ? n_blocks - 1 : b);
      const size_t base = b * blk_stride + static_cast<size_t>(h) * D;
      for (int idx = tid; idx < valid * CPR; idx += kThreads) {
        const int r = idx / CPR;
        const int col = (idx - r * CPR) * (16 / sizeof(T));
        const size_t from = base + r * tok_stride + col;
        const int to = (i * bs + r) * D + col;
        cp_async16(sk + to, k_pool + from);
        cp_async16(sv + to, v_pool + from);
      }
    }
    cp_async_commit();
  }

  const int pg = tid / G;
  const int c8 = tid - pg * G;
  float qr[8];
  load8(q + (static_cast<size_t>(s) * H + h) * D + c8 * 8, qr);

  // scores, block by block as each lands: one reduction over G lanes a
  // position
#pragma unroll
  for (int i = 0; i < kBlocksPerSplit; ++i) {
    switch (kBlocksPerSplit - 1 - i) {  // wait for block i's group
      case 0: cp_async_wait<0>(); break;
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncthreads();
    const int valid = min(bs, n_pos - i * bs);
    for (int j0 = 0; j0 < valid; j0 += PP) {  // same trip count everywhere
      const int j = j0 + pg;
      float part = 0.f;
      if (j < valid) {
        float kx[8];
        load8(sk + (i * bs + j) * D + c8 * 8, kx);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(qr[e], kx[e], part);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (j < valid && c8 == 0)
        sc[i * bs + j] = round_to_storage<T>(part) * scale;
    }
  }
  __syncthreads();

  // the chunk's max, then each p once and its sum, split over the threads
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float m = kNegInf;
  for (int j = tid; j < n_pos; j += kThreads) m = fmaxf(m, sc[j]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  float l = 0.f;
  for (int j = tid; j < n_pos; j += kThreads) {
    const float p = expf(sc[j] - m);
    sc[j] = p;
    l += p;
  }
  l = warp_sum(l);
  __syncthreads();  // every thread has read red[] for the max
  if (lane == 0) red[warp] = l;
  __syncthreads();  // sc[] holds p; red[] the warps' sums

  // p . v: thread (pg, c8) sums positions pg, pg + PP, ... in order
  float acc[8] = {};
  for (int j = pg; j < n_pos; j += PP) {
    const float p = sc[j];
    float vx[8];
    load8(sv + j * D + c8 * 8, vx);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vx[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red_acc[pg * D + c8 * 8 + e] = acc[e];
  __syncthreads();

  const size_t part_at = (static_cast<size_t>(s) * H + h) * n_split + c;
  for (int d = tid; d < D; d += kThreads) {
    float a = red_acc[d];
#pragma unroll
    for (int r = 1; r < PP; ++r) a += red_acc[r * D + d];
    ws[part_at * D + d] = a;
  }
  if (tid == 0) {
    float lsum = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) lsum += red[w];
    float* ml = ws + static_cast<size_t>(gridDim.z) * H * n_split * D;
    ml[2 * part_at] = m;
    ml[2 * part_at + 1] = lsum;
  }
}

// One CTA per (head, slot): the row's partials merged in split order
// against their common max, then the new token at position `length`,
// always visible to itself.  The partials are read through L2 (__ldcg):
// this grid starts before the split kernel ends.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new,
                         const int32_t* __restrict__ lengths,
                         const float* ws, T* __restrict__ out,
                         int bs, int H, int P, int n_split, float scale) {
  __shared__ float w_s[1024];  // each split's weight exp(m_c - M)
  __shared__ float red[kWarps];
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int length = slot_length(lengths, s, bs, P);
  const int span = kBlocksPerSplit * bs;
  const int n_valid = (length + span - 1) / span;  // splits with a partial
  const size_t row = (static_cast<size_t>(s) * H + h) * D;
  const size_t part0 = (static_cast<size_t>(s) * H + h) * n_split;
  const float* ml = ws + static_cast<size_t>(gridDim.y) * H * n_split * D;

  float part = 0.f;  // q . k_new
  for (int d = tid; d < D; d += kThreads)
    part = fmaf(to_f32(q[row + d]), to_f32(k_new[row + d]), part);
  part = warp_sum(part);
  if ((tid & 31) == 0) red[tid >> 5] = part;
  // launched early (programmatic dependent launch): the partials are
  // read only once the split kernel has finished and its writes are seen
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  float big = kNegInf;
  for (int c = 0; c < n_valid; ++c)
    big = fmaxf(big, __ldcg(ml + 2 * (part0 + c)));
  for (int c = tid; c < n_valid; c += kThreads)
    w_s[c] = expf(__ldcg(ml + 2 * (part0 + c)) - big);

  __syncthreads();
  float dot = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) dot += red[w];
  const float s_new = round_to_storage<T>(dot) * scale;

  float l = 0.f;
  for (int c = 0; c < n_valid; ++c)
    l = fmaf(__ldcg(ml + 2 * (part0 + c) + 1), w_s[c], l);
  const float m_fin = fmaxf(big, s_new);
  const float p_new = expf(s_new - m_fin);
  const float corr = expf(big - m_fin);
  l = l * corr + p_new;
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    for (int c = 0; c < n_valid; ++c)
      a = fmaf(__ldcg(ws + (part0 + c) * D + d), w_s[c], a);
    a = a * corr + p_new * to_f32(v_new[row + d]);
    out[row + d] = from_f32<T>(a / l);
  }
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k_new, const T* v_new,
                     const T* k_pool, const T* v_pool, const int32_t* tables,
                     const int32_t* lengths, float* ws, T* out, int S, int H,
                     int N, int bs, int P, float scale, cudaStream_t stream) {
  const int n_split = (P + kBlocksPerSplit - 1) / kBlocksPerSplit;
  if (n_split > 1024) return cudaErrorInvalidValue;  // w_s in the combine
  const int span = kBlocksPerSplit * bs;
  const size_t smem = 2 * static_cast<size_t>(span) * D * sizeof(T) +
                      (span + (kThreads / (D / 8)) * D + kWarps) *
                          sizeof(float);
  auto split = paged_split_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  split<<<dim3(n_split, H, S), kThreads, smem, stream>>>(
      q, k_pool, v_pool, tables, lengths, ws, N, bs, H, P, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the combine launches while the split kernel runs, and waits for it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_combine_kernel<T, D>, q, k_new, v_new,
                           lengths, static_cast<const float*>(ws), out, bs,
                           H, P, n_split, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pool, const void* v_pool,
                   const int32_t* tables, const int32_t* lengths, float* ws,
                   void* out, int S, int H, int D, int N, int bs, int P,
                   float scale, cudaStream_t stream) {
#define FT_PAGED_LAUNCH(DIM)                                                 \
  return launch_d<T, DIM>(                                                   \
      static_cast<const T*>(q), static_cast<const T*>(k_new),                \
      static_cast<const T*>(v_new), static_cast<const T*>(k_pool),           \
      static_cast<const T*>(v_pool), tables, lengths, ws,                    \
      static_cast<T*>(out), S, H, N, bs, P, scale, stream)
  switch (D) {
    case 32: FT_PAGED_LAUNCH(32);
    case 64: FT_PAGED_LAUNCH(64);
    case 128: FT_PAGED_LAUNCH(128);
    case 256: FT_PAGED_LAUNCH(256);
  }
#undef FT_PAGED_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `workspace` holds S * H *
// ceil(P / kBlocksPerSplit) * (D + 2) floats.  Returns a cudaError_t (0 =
// launched).
extern "C" int ft_paged_attention_decode(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* tables, const void* lengths, void* out,
    void* workspace, int S, int H, int D, int N, int bs, int P, float scale,
    int dtype, void* stream) {
  if (S <= 0 || H <= 0 || N <= 0 || bs <= 0 || P <= 0 || S > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const int32_t*>(tables);
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* ws = static_cast<float*>(workspace);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k_new, v_new, k_pool, v_pool, tab, len, ws, out,
                        S, H, D, N, bs, P, scale, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k_new, v_new, k_pool, v_pool, tab, len,
                                ws, out, S, H, D, N, bs, P, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
