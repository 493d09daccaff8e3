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
// token (k_new, v_new).  Same order of operations as the plain version
// (flextree_tpu_torch/ops/paged_attention.py::paged_attention_stream): one
// table block at a time, an online softmax in float32 with the -1e30
// sentinel, scores taken in the storage dtype then float32, and the new
// token folded last.
//
// Bound: bytes.  Each (slot, head) reads length * D elements of K and of V
// once, about one multiply-add per element read, far below the card's
// ~295 operations per byte.  So the least time is the K/V bytes over the
// memory rate.
//
// Design (simple first; split-K, cp.async/TMA pipelining and CUDA graphs
// are later work):
// - one CTA per (slot, head), D threads (one warp per 32 head dims);
// - each CTA walks its own table row for ceil(length / bs) blocks and never
//   loads a position >= length, so what an unwritten or null block holds
//   cannot reach the output — not even through 0 * inf;
// - the table row's first ceil(length / bs) entries are read once into
//   shared memory up front, so no block of the walk waits on a table load;
// - scores: each warp takes positions of the block in turn, each lane a
//   strided slice of D, a shuffle reduction; the block's scores go through
//   shared memory to all threads, which keep identical copies of m and l;
// - accumulation: thread t owns output dim t and keeps its accumulator in a
//   register; V loads are coalesced across the CTA;
// - an inactive slot (length 0) reads no pool block and returns v_new
//   exactly (p_new = 1, l = 1).
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPL = head dims per lane = D / 32; blockDim.x == D.
template <typename T, int DPL>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_new,
                                    const T* __restrict__ v_new,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int32_t* __restrict__ tables,
                                    const int32_t* __restrict__ lengths,
                                    T* __restrict__ out, int n_blocks, int bs,
                                    int H, int P, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ float smem[];
  float* scores = smem;                                   // bs floats
  int* blk_ids = reinterpret_cast<int*>(smem + bs);      // P ints

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int n_warps = DPL;

  const size_t row = (static_cast<size_t>(s) * H + h) * D;
  const size_t tok_stride = static_cast<size_t>(H) * D;
  const size_t blk_stride = static_cast<size_t>(bs) * tok_stride;

  float qr[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) qr[i] = to_f32(q[row + lane + 32 * i]);

  int length = lengths[s];
  if (length < 0) length = 0;
  int nb = (length + bs - 1) / bs;
  if (nb > P) nb = P;

  for (int p = tid; p < nb; p += D) {
    const int b = tables[static_cast<size_t>(s) * P + p];
    blk_ids[p] = b < 0 ? 0 : (b >= n_blocks ? n_blocks - 1 : b);
  }
  __syncthreads();

  float m = kNegInf;
  float l = 0.f;
  float acc = 0.f;

  for (int p = 0; p < nb; ++p) {
    const size_t blk = blk_ids[p];
    const T* kb = k_pool + blk * blk_stride + static_cast<size_t>(h) * D;
    const T* vb = v_pool + blk * blk_stride + static_cast<size_t>(h) * D;
    const int rest = length - p * bs;
    const int valid = rest < bs ? rest : bs;  // positions < length, >= 1

#pragma unroll 4
    for (int j = warp; j < valid; j += n_warps) {
      const T* kj = kb + j * tok_stride;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part += qr[i] * to_f32(kj[lane + 32 * i]);
      part = warp_sum(part);
      if (lane == 0) scores[j] = round_to_storage<T>(part) * scale;
    }
    __syncthreads();

    float m_blk = kNegInf;
    for (int j = 0; j < valid; ++j) m_blk = fmaxf(m_blk, scores[j]);
    const float m_new = fmaxf(m, m_blk);
    float p_sum = 0.f;
    float pv = 0.f;
#pragma unroll 4
    for (int j = 0; j < valid; ++j) {
      const float pj = expf(scores[j] - m_new);
      p_sum += pj;
      pv += pj * to_f32(vb[j * tok_stride + tid]);
    }
    const float corr = expf(m - m_new);
    l = l * corr + p_sum;
    acc = acc * corr + pv;
    m = m_new;
    __syncthreads();  // scores[] is rewritten by the next block
  }

  // The new token at position `length`, always visible to itself.  Every
  // warp reduces the same values in the same order, so all threads agree.
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) part += qr[i] * to_f32(k_new[row + lane + 32 * i]);
  part = warp_sum(part);
  const float s_new = round_to_storage<T>(part) * scale;
  const float m_fin = fmaxf(m, s_new);
  const float p_new = expf(s_new - m_fin);
  const float corr = expf(m - m_fin);
  l = l * corr + p_new;
  acc = acc * corr + p_new * to_f32(v_new[row + tid]);
  out[row + tid] = from_f32<T>(acc / l);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pool, const void* v_pool,
                   const int32_t* tables, const int32_t* lengths, void* out,
                   int S, int H, int D, int N, int bs, int P, float scale,
                   cudaStream_t stream) {
  const dim3 grid(H, S);
  const dim3 block(D);
  const size_t smem = static_cast<size_t>(bs) * sizeof(float) +
                      static_cast<size_t>(P) * sizeof(int);
#define FT_PAGED_LAUNCH(DPL)                                                  \
  paged_decode_kernel<T, DPL><<<grid, block, smem, stream>>>(                 \
      static_cast<const T*>(q), static_cast<const T*>(k_new),                 \
      static_cast<const T*>(v_new), static_cast<const T*>(k_pool),            \
      static_cast<const T*>(v_pool), tables, lengths, static_cast<T*>(out),   \
      N, bs, H, P, scale)
  switch (D) {
    case 32: FT_PAGED_LAUNCH(1); break;
    case 64: FT_PAGED_LAUNCH(2); break;
    case 128: FT_PAGED_LAUNCH(4); break;
    case 256: FT_PAGED_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef FT_PAGED_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int ft_paged_attention_decode(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* tables, const void* lengths, void* out,
    int S, int H, int D, int N, int bs, int P, float scale, int dtype,
    void* stream) {
  if (S <= 0 || H <= 0 || N <= 0 || bs <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const int32_t*>(tables);
  const auto* len = static_cast<const int32_t*>(lengths);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k_new, v_new, k_pool, v_pool, tab, len, out, S, H,
                        D, N, bs, P, scale, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k_new, v_new, k_pool, v_pool, tab, len,
                                out, S, H, D, N, bs, P, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
