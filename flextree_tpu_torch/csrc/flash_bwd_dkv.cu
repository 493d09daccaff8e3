// Flash-attention backward for dk and dv, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_bwd_dkv_kernel` of
// flextree_tpu/ops/pallas_attention.py.  Per (b, h) and key row j, from the
// forward's out o and lse, the output cotangent do and the lse cotangent
// glse (0 when absent), recomputing p tile by tile:
//
//     p_ij  = exp2(q_i . (k_j * scale*log2e) - lse_i * log2e)   (0 if masked)
//     dv_j  = sum_i p_ij do_i
//     ds_ij = p_ij * (do_i . v_j - do_i . o_i + glse_i)
//     dk_j  = scale * sum_i ds_ij q_i
//
// Numerics of the TPU kernel: the log2-domain pre-scale on k (q enters
// ds^T q raw) in k's own dtype; do and o read as float32; p enters dv in
// float32 (the TPU kernel casts p to do's float32); ds rounded to q's dtype
// before ds^T q; float32 accumulation.  The plain version is
// flextree_tpu_torch/ops/flash_attention.py::flash_bwd_dkv_plain.
//
// Bound: at the training shape (B=8, T=1024, H=8, D=64, bf16, causal) the
// work is ~17.2 GFLOP (q.k, do.v, p^T do and ds^T q per visible pair) over
// ~59 MB of q, k, v, o, do, lse, dk and dv: ~290 operations per byte, so
// the bytes bound it (~0.018 ms), the bf16 tensor cores almost as close.
// This kernel runs its products on the float32 cores (SIMT), so the
// float32 pipes and shared-memory bandwidth bound it.
//
// Design (simple and right first): one CTA per (64 key rows, b*h), 256
// threads (flash_common.cuh).  The CTA keeps its pre-scaled k tile and its
// v tile in shared memory and dk/dv in registers, and walks the q tiles from
// the causal bound qb_lo, with the mask dropped from qb_full_lo on (unless
// its own key rows are ragged).  Per q tile it reduces delta = do.o for the
// tile's rows; p and ds go through shared memory for the two products.

#include "flash_common.cuh"

namespace ftflash {
namespace {

template <typename E, int DM>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ o,
                         const E* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ glse, E* __restrict__ dk,
                         E* __restrict__ dv, int H, int Tq, int Tk, int D,
                         float kmul, float scale, int causal, int q_offset,
                         int k_offset) {
  constexpr int LD = DM + 1;
  constexpr int DPT = DM / 16;
  extern __shared__ float smem[];
  float* kss = smem;              // (64 x DM) pre-scaled k tile
  float* vs = kss + kRows * LD;   // (64 x DM) v tile
  float* qs = vs + kRows * LD;    // (64 x DM) q tile, raw
  float* dos = qs + kRows * LD;   // (64 x DM) do tile, float32
  float* ps = dos + kRows * LD;   // (64 k x 64 q) p, float32
  float* dss = ps + kRows * kLP;  // (64 k x 64 q) ds, rounded to E
  float* lse2_s = dss + kRows * kLP;  // per q row of the tile
  float* delta_s = lse2_s + kRows;
  float* gl_s = delta_s + kRows;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t q_base = (static_cast<size_t>(b) * Tq * H + h) * D;
  const size_t k_base = (static_cast<size_t>(b) * Tk * H + h) * D;
  const size_t row_stride = static_cast<size_t>(H) * D;

  load_tile<E, DM>(kss, k + k_base, k0, Tk, H, D, true, round_to<E>(kmul));
  load_tile<E, DM>(vs, v + k_base, k0, Tk, H, D);

  const int n_qb = (Tq + kRows - 1) / kRows;
  int qb_lo = 0;
  int qb_full_lo = 0;
  if (causal) {
    // first q tile whose last row sees this k tile, and the first whose
    // first row sees all of it
    qb_lo = clampi(floor_div(k_offset + k0 - q_offset, kRows), 0, n_qb);
    qb_full_lo = clampi(-floor_div(-(k_offset + k0 + kRows - 1 - q_offset),
                                   kRows),
                        0, n_qb);
  }
  const bool ragged = k0 + kRows > Tk;  // this tile holds rows >= Tk

  float dk_acc[kRpt][DPT], dv_acc[kRpt][DPT];
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = qb_lo; qb < n_qb; ++qb) {
    const int q0 = qb * kRows;
    __syncthreads();  // the previous q tile's readers are done
    load_tile<E, DM>(qs, q + q_base, q0, Tq, H, D);
    load_tile<E, DM>(dos, dout + q_base, q0, Tq, H, D);
    if (threadIdx.x < kRows) {
      const int row = q0 + threadIdx.x;
      const size_t at = static_cast<size_t>(bh) * Tq + row;
      lse2_s[threadIdx.x] = (row < Tq ? lse[at] : kSentinel) * kLog2e;
      gl_s[threadIdx.x] = (row < Tq && glse != nullptr) ? glse[at] : 0.f;
    }
    __syncthreads();
    // delta for the tile's q rows, by the row-group layout over q rows
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
      part = group_sum(part);
      if (tx == 0) delta_s[r] = part;
    }
    __syncthreads();

    // s[i][c]: k row ty*4+i against q row tx+16c
    float s[kRpt][kCpt], dp[kRpt][kCpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int c = 0; c < kCpt; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      float a[kRpt], bv[kRpt], bq[kCpt], bg[kCpt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        a[i] = kss[(ty * kRpt + i) * LD + d];
        bv[i] = vs[(ty * kRpt + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        bq[c] = qs[(tx + 16 * c) * LD + d];
        bg[c] = dos[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int c = 0; c < kCpt; ++c) {
          s[i][c] = fmaf(a[i], bq[c], s[i][c]);
          dp[i][c] = fmaf(bv[i], bg[c], dp[i][c]);
        }
    }

    const bool masked = ragged || qb < qb_full_lo;
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        const int r = tx + 16 * c;  // q row within the tile
        const int kj = k0 + ty * kRpt + i;
        bool ok = true;
        if (masked) {
          ok = kj < Tk;
          if (causal) ok = ok && (q_offset + q0 + r >= k_offset + kj);
        }
        const float p = ok ? exp2f(s[i][c] - lse2_s[r]) : 0.f;
        const float ds = p * ((dp[i][c] - delta_s[r]) + gl_s[r]);
        ps[(ty * kRpt + i) * kLP + r] = p;
        dss[(ty * kRpt + i) * kLP + r] = round_to<E>(ds);
      }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kRows; ++qq) {
      float wp[kRpt], wd[kRpt], gq[DPT], qv[DPT];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        wp[i] = ps[(ty * kRpt + i) * kLP + qq];
        wd[i] = dss[(ty * kRpt + i) * kLP + qq];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        gq[j] = dos[qq * LD + tx + 16 * j];
        qv[j] = qs[qq * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv_acc[i][j] = fmaf(wp[i], gq[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(wd[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = k0 + ty * kRpt + i;
    if (row >= Tk) continue;
    const size_t at = k_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk[at + d] = from_f32<E>(dk_acc[i][j] * scale);
        dv[at + d] = from_f32<E>(dv_acc[i][j]);
      }
    }
  }
}

template <typename E, int DM>
cudaError_t run(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, const float* glse,
                void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                float kmul, float scale, int causal, int q_offset,
                int k_offset, cudaStream_t stream) {
  constexpr int LD = DM + 1;
  const size_t smem =
      (4 * kRows * LD + 2 * kRows * kLP + 3 * kRows) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<E, DM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(o),
      static_cast<const E*>(dout), lse, glse, static_cast<E*>(dk),
      static_cast<E*>(dv), H, Tq, Tk, D, kmul, scale, causal, q_offset,
      k_offset);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     const float* glse, void* dk, void* dv, int B, int H,
                     int Tq, int Tk, int D, float kmul, float scale,
                     int causal, int q_offset, int k_offset, cudaStream_t st) {
  if (D <= 32)
    return run<E, 32>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
                      kmul, scale, causal, q_offset, k_offset, st);
  if (D <= 64)
    return run<E, 64>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
                      kmul, scale, causal, q_offset, k_offset, st);
  return run<E, 128>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
                     kmul, scale, causal, q_offset, k_offset, st);
}

}  // namespace
}  // namespace ftflash

// dtype: 0 = float32, 1 = bfloat16.  glse may be null (taken as 0).
// Returns a cudaError_t (0 = launched).
extern "C" int ft_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, const void* glse, void* dk,
                                void* dv, int B, int H, int Tq, int Tk, int D,
                                float kmul, float scale, int causal,
                                int q_offset, int k_offset, int dtype,
                                void* stream) {
  using namespace ftflash;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      D % 8 || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lse);
  const auto* g = static_cast<const float*>(glse);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, dout, l, g, dk, dv, B, H, Tq, Tk, D,
                          kmul, scale, causal, q_offset, k_offset, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, dout, l, g, dk, dv, B, H, Tq,
                                  Tk, D, kmul, scale, causal, q_offset,
                                  k_offset, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
