// Flash-attention forward for Hopper (sm_90a): out and, when asked, the
// per-row logsumexp.
//
// Replaces the Pallas kernels `_flash_kernel` ("loop"/"pipelined") and
// `_flash_kernel_kvgrid` ("kvgrid") of flextree_tpu/ops/pallas_attention.py.
// Per (b, h) and query row i it computes, with scores in the log2 domain,
//
//     s_ij = (q_i * scale*log2e) . k_j      over keys j visible to i
//     out_i = sum_j exp2(s_ij - m_i) v_j / l_i,   l_i = sum_j exp2(s_ij - m_i)
//     lse_i = (m_i + log2 l_i) * ln 2        (+1e30 when l_i == 0)
//
// where j is visible when j < Tk and, causal, q_offset + i >= k_offset + j.
// Numerics of the TPU kernel: q pre-scaled in its own dtype, an online
// softmax in float32, p rounded to v's dtype before p.v, a row that sees no
// key gives exactly 0 and the +1e30 sentinel.  The plain version is
// flextree_tpu_torch/ops/flash_attention.py::flash_fwd_plain.
//
// Bound: at the training shape (B=8, T=1024, H=8, D=64, bf16, causal) the
// work is ~8.6 GFLOP of products over ~34 MB of q, k, v, out and lse: ~250
// operations per byte, just under the card's ~295, so the least time is
// the bytes over the memory rate (~0.010 ms), with the bf16 tensor cores
// nearly as close.  This kernel runs its products on the float32 cores
// (SIMT), ~15x below the bf16 tensor-core rate, so the float32 pipes and
// shared-memory bandwidth bound it.
//
// Design (simple and right first; mma/wgmma, TMA and warp specialisation are
// later work):
// - one CTA per (64 query rows, b*h), 256 threads (flash_common.cuh);
// - the q tile is loaded once, pre-scaled; the CTA walks the k/v tiles up
//   to its causal bound kb_hi, and tiles below kb_full (every row sees every
//   key) skip the mask, as the TPU kernel's full/masked loops do;
// - m, l and the (4 rows x DM/16 dims) accumulators stay in registers
//   across the walk; p goes through shared memory for p.v;
// - the ragged edge is masked by position, never padded.

#include "flash_common.cuh"

namespace ftflash {
namespace {

template <typename E, int DM>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, E* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk, int D,
                     float qmul, int causal, int q_offset, int k_offset) {
  constexpr int LD = DM + 1;
  constexpr int DPT = DM / 16;  // head dims per thread
  extern __shared__ float smem[];
  float* qs = smem;               // (64 x DM) pre-scaled q
  float* ks = qs + kRows * LD;    // (64 x DM) k tile
  float* vs = ks + kRows * LD;    // (64 x DM) v tile
  float* ps = vs + kRows * LD;    // (64 x 64) p tile, rounded to E

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t q_base = (static_cast<size_t>(b) * Tq * H + h) * D;
  const size_t k_base = (static_cast<size_t>(b) * Tk * H + h) * D;

  load_tile<E, DM>(qs, q + q_base, q0, Tq, H, D, true, round_to<E>(qmul));

  const int n_kb = (Tk + kRows - 1) / kRows;
  int kb_hi = n_kb;
  int kb_full = n_kb;
  if (causal) {
    const int hi = q_offset + q0 + kRows - k_offset;  // exclusive
    kb_hi = clampi(floor_div(hi + kRows - 1, kRows), 0, n_kb);
    const int lo_vis = q_offset + q0 - k_offset + 1;  // seen by the 1st row
    kb_full = clampi(floor_div(lo_vis, kRows), 0, n_kb);
  }
  if (Tk % kRows) kb_full = min(kb_full, Tk / kRows);

  float m[kRpt], l[kRpt], acc[kRpt][DPT];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb < kb_hi; ++kb) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<E, DM>(ks, k + k_base, kb * kRows, Tk, H, D);
    load_tile<E, DM>(vs, v + k_base, kb * kRows, Tk, H, D);
    __syncthreads();

    float s[kRpt][kCpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int c = 0; c < kCpt; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      float a[kRpt], bk[kCpt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) a[i] = qs[(ty * kRpt + i) * LD + d];
#pragma unroll
      for (int c = 0; c < kCpt; ++c) bk[c] = ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int c = 0; c < kCpt; ++c) s[i][c] = fmaf(a[i], bk[c], s[i][c]);
    }

    const bool masked = kb >= kb_full;
    bool valid[kRpt][kCpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        const int kj = kb * kRows + tx + 16 * c;
        bool ok = true;
        if (masked) {
          ok = kj < Tk;
          if (causal) ok = ok && (q_offset + q0 + ty * kRpt + i >= k_offset + kj);
          if (!ok) s[i][c] = kNegInf;
        }
        valid[i][c] = ok;
      }

#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int c = 1; c < kCpt; ++c) mx = fmaxf(mx, s[i][c]);
      const float m_new = fmaxf(m[i], group_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        const float p = valid[i][c] ? exp2f(s[i][c] - m_new) : 0.f;
        psum += p;
        ps[(ty * kRpt + i) * kLP + tx + 16 * c] = round_to<E>(p);
      }
      const float corr = exp2f(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(psum);
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kRows; ++kk) {
      float p[kRpt], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) p[i] = ps[(ty * kRpt + i) * kLP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  const size_t row_stride = static_cast<size_t>(H) * D;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = q0 + ty * kRpt + i;
    if (row >= Tq) continue;
    E* o_row = out + q_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o_row[d] = from_f32<E>(l[i] > 0.f ? acc[i][j] / l[i] : 0.f);
    }
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * Tq + row] =
          l[i] > 0.f ? (m[i] + log2f(fmaxf(l[i], 1e-38f))) * kLn2 : kSentinel;
  }
}

template <typename E, int DM>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int H, int Tq, int Tk, int D, float qmul,
                int causal, int q_offset, int k_offset, cudaStream_t stream) {
  constexpr int LD = DM + 1;
  const size_t smem = (3 * kRows * LD + kRows * kLP) * sizeof(float);
  auto kernel = flash_fwd_kernel<E, DM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(out), lse, H, Tq, Tk, D,
      qmul, causal, q_offset, k_offset);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int H, int Tq, int Tk, int D,
                     float qmul, int causal, int q_offset, int k_offset,
                     cudaStream_t st) {
  if (D <= 32)
    return run<E, 32>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
                      q_offset, k_offset, st);
  if (D <= 64)
    return run<E, 64>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
                      q_offset, k_offset, st);
  return run<E, 128>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
                     q_offset, k_offset, st);
}

}  // namespace
}  // namespace ftflash

// dtype: 0 = float32, 1 = bfloat16.  lse may be null (not written).
// Returns a cudaError_t (0 = launched).
extern "C" int ft_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int H, int Tq, int Tk,
                            int D, float qmul, int causal, int q_offset,
                            int k_offset, int dtype, void* stream) {
  using namespace ftflash;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || D <= 0 || D > 128 || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* l = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, l, B, H, Tq, Tk, D, qmul, causal,
                          q_offset, k_offset, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, l, B, H, Tq, Tk, D, qmul,
                                  causal, q_offset, k_offset, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
