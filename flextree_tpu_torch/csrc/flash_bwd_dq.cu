// Flash-attention backward for dq, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_bwd_dq_kernel` of
// flextree_tpu/ops/pallas_attention.py.  Per (b, h) and query row i, from
// the forward's out o and lse, the output cotangent do and the lse
// cotangent glse (0 when absent), recomputing p tile by tile:
//
//     p_ij   = exp2((q_i * scale*log2e) . k_j - lse_i * log2e)   (0 if masked)
//     delta_i = do_i . o_i
//     ds_ij  = p_ij * (do_i . v_j - delta_i + glse_i)
//     dq_i   = scale * sum_j ds_ij k_j
//
// Numerics of the TPU kernel: q pre-scaled in its own dtype, do and o read
// as float32, ds rounded to k's dtype before ds.k, float32 accumulation; a
// row with the +1e30 lse sentinel gets p = 0, so dq = 0 exactly.  The plain
// version is flextree_tpu_torch/ops/flash_attention.py::flash_bwd_dq_plain.
//
// Bound: at the training shape (B=8, T=1024, H=8, D=64, bf16, causal) the
// work is ~12.9 GFLOP (q.k, do.v and ds.k per visible pair) over ~50 MB of
// q, k, v, o, do, lse and dq: ~255 operations per byte, so the bytes bound
// it (~0.015 ms), the bf16 tensor cores nearly as close.  This kernel runs
// its products on the float32 cores (SIMT), so the float32 pipes and
// shared-memory bandwidth bound it.
//
// Design (simple and right first): one CTA per (64 query rows, b*h), 256
// threads (flash_common.cuh).  The CTA loads its pre-scaled q and float32 do
// once, reduces delta, lse and glse per row into registers, then walks the
// k/v tiles up to its causal bound with the TPU kernel's full/masked split;
// ds goes through shared memory for ds.k; dq stays in registers.

#include "flash_common.cuh"

namespace ftflash {
namespace {

template <typename E, int DM>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ o,
                        const E* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ glse, E* __restrict__ dq,
                        int H, int Tq, int Tk, int D, float qmul, float scale,
                        int causal, int q_offset, int k_offset) {
  constexpr int LD = DM + 1;
  constexpr int DPT = DM / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // (64 x DM) pre-scaled q
  float* dos = qs + kRows * LD;   // (64 x DM) do, float32
  float* ks = dos + kRows * LD;   // (64 x DM) k tile
  float* vs = ks + kRows * LD;    // (64 x DM) v tile
  float* dss = vs + kRows * LD;   // (64 x 64) ds tile, rounded to E

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t q_base = (static_cast<size_t>(b) * Tq * H + h) * D;
  const size_t k_base = (static_cast<size_t>(b) * Tk * H + h) * D;
  const size_t row_stride = static_cast<size_t>(H) * D;

  load_tile<E, DM>(qs, q + q_base, q0, Tq, H, D, true, round_to<E>(qmul));
  load_tile<E, DM>(dos, dout + q_base, q0, Tq, H, D);
  __syncthreads();

  // per owned row: lse in the log2 domain, delta = do . o, glse
  float lse2[kRpt], delta[kRpt], gl[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = ty * kRpt + i;
    const int row = q0 + r;
    float part = 0.f;
    if (row < Tq) {
      const E* o_row = o + q_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < D) part = fmaf(dos[r * LD + d], to_f32(o_row[d]), part);
      }
    }
    delta[i] = group_sum(part);
    const size_t at = static_cast<size_t>(bh) * Tq + row;
    lse2[i] = (row < Tq ? lse[at] : kSentinel) * kLog2e;
    gl[i] = (row < Tq && glse != nullptr) ? glse[at] : 0.f;
  }

  const int n_kb = (Tk + kRows - 1) / kRows;
  int kb_hi = n_kb;
  int kb_full = n_kb;
  if (causal) {
    const int hi = q_offset + q0 + kRows - k_offset;
    kb_hi = clampi(floor_div(hi + kRows - 1, kRows), 0, n_kb);
    const int lo_vis = q_offset + q0 - k_offset + 1;
    kb_full = clampi(floor_div(lo_vis, kRows), 0, n_kb);
  }
  if (Tk % kRows) kb_full = min(kb_full, Tk / kRows);

  float acc[kRpt][DPT];
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < kb_hi; ++kb) {
    __syncthreads();
    load_tile<E, DM>(ks, k + k_base, kb * kRows, Tk, H, D);
    load_tile<E, DM>(vs, v + k_base, kb * kRows, Tk, H, D);
    __syncthreads();

    float s[kRpt][kCpt], dp[kRpt][kCpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int c = 0; c < kCpt; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      float a[kRpt], g[kRpt], bk[kCpt], bv[kCpt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        a[i] = qs[(ty * kRpt + i) * LD + d];
        g[i] = dos[(ty * kRpt + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        bk[c] = ks[(tx + 16 * c) * LD + d];
        bv[c] = vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int c = 0; c < kCpt; ++c) {
          s[i][c] = fmaf(a[i], bk[c], s[i][c]);
          dp[i][c] = fmaf(g[i], bv[c], dp[i][c]);
        }
    }

    const bool masked = kb >= kb_full;
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        const int kj = kb * kRows + tx + 16 * c;
        bool ok = true;
        if (masked) {
          ok = kj < Tk;
          if (causal) ok = ok && (q_offset + q0 + ty * kRpt + i >= k_offset + kj);
        }
        const float p = ok ? exp2f(s[i][c] - lse2[i]) : 0.f;
        const float ds = p * ((dp[i][c] - delta[i]) + gl[i]);
        dss[(ty * kRpt + i) * kLP + tx + 16 * c] = round_to<E>(ds);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kRows; ++kk) {
      float w[kRpt], kv[DPT];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) w[i] = dss[(ty * kRpt + i) * kLP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(w[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = q0 + ty * kRpt + i;
    if (row >= Tq) continue;
    E* dq_row = dq + q_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq_row[d] = from_f32<E>(acc[i][j] * scale);
    }
  }
}

template <typename E, int DM>
cudaError_t run(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, const float* glse,
                void* dq, int B, int H, int Tq, int Tk, int D, float qmul,
                float scale, int causal, int q_offset, int k_offset,
                cudaStream_t stream) {
  constexpr int LD = DM + 1;
  const size_t smem = (4 * kRows * LD + kRows * kLP) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<E, DM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(o),
      static_cast<const E*>(dout), lse, glse, static_cast<E*>(dq), H, Tq, Tk,
      D, qmul, scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     const float* glse, void* dq, int B, int H, int Tq, int Tk,
                     int D, float qmul, float scale, int causal, int q_offset,
                     int k_offset, cudaStream_t st) {
  if (D <= 32)
    return run<E, 32>(q, k, v, o, dout, lse, glse, dq, B, H, Tq, Tk, D, qmul,
                      scale, causal, q_offset, k_offset, st);
  if (D <= 64)
    return run<E, 64>(q, k, v, o, dout, lse, glse, dq, B, H, Tq, Tk, D, qmul,
                      scale, causal, q_offset, k_offset, st);
  return run<E, 128>(q, k, v, o, dout, lse, glse, dq, B, H, Tq, Tk, D, qmul,
                     scale, causal, q_offset, k_offset, st);
}

}  // namespace
}  // namespace ftflash

// dtype: 0 = float32, 1 = bfloat16.  glse may be null (taken as 0).
// Returns a cudaError_t (0 = launched).
extern "C" int ft_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, const void* glse, void* dq,
                               int B, int H, int Tq, int Tk, int D, float qmul,
                               float scale, int causal, int q_offset,
                               int k_offset, int dtype, void* stream) {
  using namespace ftflash;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || D <= 0 || D > 128 || D % 8 ||
      lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lse);
  const auto* g = static_cast<const float*>(glse);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, dout, l, g, dq, B, H, Tq, Tk, D, qmul,
                          scale, causal, q_offset, k_offset, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, dout, l, g, dq, B, H, Tq, Tk, D,
                                  qmul, scale, causal, q_offset, k_offset, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
