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
// it (~0.015 ms), the bf16 tensor cores nearly as close.
//
// Two kernels behind one entry point, chosen by dtype alone:
//
// - bfloat16 (flash_bwd_dq_mma_kernel): the products on the tensor cores
//   (flash_mma.cuh), the forward's shape.  One CTA per (64 query rows,
//   b*h), 4 warps of 16 q rows; the causal triangle's longest q tiles
//   launch first.  The q tile is pre-scaled in shared memory, and q and do
//   are held as A fragments; delta = rowsum(do * o) is reduced once from
//   the do and o tiles.  k/v tiles of 64 keys stream through a two-stage
//   cp.async ring.  Per tile a warp forms s = q^.k^T and dp = do.v^T (mma,
//   k and v through ldmatrix), p and ds in registers, then dq += ds.k with
//   ds repacked as one bf16 term (the single rounding of ds) and k as the
//   B operand through ldmatrix.trans, the same tile with no second copy.
//   dq stays in registers, the round-to-nearest float32 sum of 16-key mma
//   steps that each start from zero (the tensor cores' own float32 sums
//   truncate, and a chain of them as long as the sequence drifts).  dq
//   leaves through shared memory in 16-byte stores; no atomics.
// - float32 (flash_bwd_dq_kernel, SIMT, the TPU kernel's float32 bars):
//   256 threads (flash_common.cuh), the products on the float32 cores, ds
//   through shared memory.
//
// Both walk the k/v tiles up to the causal bound kb_hi, and tiles below
// kb_full (every row sees every key) skip the mask, as the TPU kernel's
// full/masked loops do; the ragged edge is masked by position.

#include "flash_mma.cuh"

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
cudaError_t dispatch_simt(const void* q, const void* k, const void* v,
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

// ---------------------------------------------------------------- bfloat16
//
// ds enters ds.k as one bf16 term, rounded: the TPU kernel's cast of ds to
// k's dtype (c_to_a).
constexpr int kDsTerms = 1;

// The register budget asks for 2 CTAs an SM (1 at DM = 128): q and do as A
// fragments, s, dp and dq as float32 C tiles are ~130 registers a thread
// at DM = 64 before addresses, more than 3 CTAs (168 a thread) leave room
// for.
template <int DM>
__global__ void __launch_bounds__(kMmaThreads, DM == 128 ? 1 : 2)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ o,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ glse,
                            bf16* __restrict__ dq, int H, int Tq, int Tk,
                            int D, float qmul, float scale, int causal,
                            int q_offset, int k_offset) {
  constexpr int LD = DM + 8;     // bf16 row stride (flash_mma.cuh)
  constexpr int TILE = kRows * LD;
  constexpr int KC = DM / 16;    // 16-deep chunks of q.k and do.v
  constexpr int NS = kRows / 8;  // 8-key blocks of a k tile
  constexpr int NO = DM / 8;     // 8-dim blocks of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // q, pre-scaled; then dq
  bf16* sdo = sq + TILE;                         // do tile
  bf16* so = sdo + TILE;                         // o tile
  bf16* sk = so + TILE;                          // k tiles, 2 stages
  bf16* sv = sk + 2 * TILE;                      // v tiles, 2 stages
  float* delta_s = reinterpret_cast<float*>(sv + 2 * TILE);  // 64

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // the causal triangle's longest rows first, so they do not make the tail
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row_stride = H * D;
  const size_t q_base = (static_cast<size_t>(b) * Tq * H + h) * D;
  const bf16* k_bh = k + (static_cast<size_t>(b) * Tk * H + h) * D;
  const bf16* v_bh = v + (static_cast<size_t>(b) * Tk * H + h) * D;

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

  load_tile_async<DM>(sq, q + q_base, q0, Tq, row_stride, D);
  load_tile_async<DM>(sdo, dout + q_base, q0, Tq, row_stride, D);
  load_tile_async<DM>(so, o + q_base, q0, Tq, row_stride, D);
  cp_async_commit();
  if (kb_hi > 0) {
    load_tile_async<DM>(sk, k_bh, 0, Tk, row_stride, D);
    load_tile_async<DM>(sv, v_bh, 0, Tk, row_stride, D);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q, do and o have landed
  __syncthreads();
  const float qmul_b = round_bf16(qmul);
  prescale_tile<DM>(sq, qmul_b);
  {  // delta = rowsum(do * o) in float32, two threads a row
    const int r = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    const bf16* a = sdo + r * LD + half * (DM / 2);
    const bf16* c = so + r * LD + half * (DM / 2);
    float part = 0.f;
#pragma unroll
    for (int d = 0; d < DM / 2; d += 2) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a + d));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(c + d));
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) delta_s[r] = part;
  }
  __syncthreads();
  uint32_t qa[KC][4], da[KC][4];  // this warp's 16 q and do rows
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    ldsm_x4(qa[kc], a_addr(sq, LD, warp * 16, kc * 16, lane));
    ldsm_x4(da[kc], a_addr(sdo, LD, warp * 16, kc * 16, lane));
  }
  // rows g and g + 8 of the warp's 16: lse in log2 units (+1e30 past Tq),
  // delta and glse (0 when absent)
  float lse2[2], delta[2], gl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const size_t at = static_cast<size_t>(bh) * Tq + row;
    lse2[r] = (row < Tq ? lse[at] : kSentinel) * kLog2e;
    gl[r] = (row < Tq && glse != nullptr) ? glse[at] : 0.f;
    delta[r] = delta_s[warp * 16 + g + 8 * r];
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int qi0 = q_offset + q0 + warp * 16 + g;  // global position, row g

  for (int kb = 0; kb < kb_hi; ++kb) {
    const int stage = kb & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kb is in; every warp is done with tile kb - 1
    if (kb + 1 < kb_hi) {  // the next tile loads while this one computes
      load_tile_async<DM>(sk + (stage ^ 1) * TILE, k_bh, (kb + 1) * kRows,
                          Tk, row_stride, D);
      load_tile_async<DM>(sv + (stage ^ 1) * TILE, v_bh, (kb + 1) * kRows,
                          Tk, row_stride, D);
    }
    cp_async_commit();
    const bf16* ks = sk + stage * TILE;
    const bf16* vs = sv + stage * TILE;

    // s = q^ . k^T and dp = do . v^T: 16 rows x 64 keys each
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, bn_addr(ks, LD, n2 * 16, kc * 16, lane));
        ldsm_x4(vf, bn_addr(vs, LD, n2 * 16, kc * 16, lane));
        mma_bf16(s[2 * n2], qa[kc], kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], qa[kc], kf[2], kf[3]);
        mma_bf16(dp[2 * n2], da[kc], vf[0], vf[1]);
        mma_bf16(dp[2 * n2 + 1], da[kc], vf[2], vf[3]);
      }

    // p = exp2(s - lse2), exactly 0 where masked (the full tiles below
    // kb_full skip the mask); ds = p (dp - delta + glse)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = fast_exp2(s[n][e] - lse2[e >> 1]);
    if (kb >= kb_full) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kb * kRows + n * 8 + 2 * t4 + (e & 1);
          if (kj >= Tk || (causal && qi0 + (e >> 1) * 8 < k_offset + kj))
            s[n][e] = 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * ((dp[n][e] - delta[e >> 1]) + gl[e >> 1]);

    // dq += ds . k: ds as A fragments, one 16-key chunk at a time, k by
    // ldmatrix.trans.  Each 16-key step starts from zero and joins dq by
    // an ordinary, round-to-nearest float32 add.
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t dsa[kDsTerms][4];
      c_to_a<kDsTerms>(dp[2 * kk], dp[2 * kk + 1], dsa);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, bt_addr(ks, LD, kk * 16, j2 * 16, lane));
        float tq[2][4] = {};
#pragma unroll
        for (int t = kDsTerms - 1; t >= 0; --t) {
          mma_bf16(tq[0], dsa[t], kf[0], kf[1]);
          mma_bf16(tq[1], dsa[t], kf[2], kf[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * j2 + i][e] += tq[i][e];
      }
    }
  }

  // dq (times scale) through this warp's own rows of the q tile (only this
  // warp read them), then 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(sq + row * LD + j * 8 + 2 * t4) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
  __syncwarp();
  store_rows<DM>(sq, warp, dq + q_base, q0, Tq, row_stride, D);
}

template <int DM>
cudaError_t run_mma(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    const float* glse, void* dq, int B, int H, int Tq, int Tk,
                    int D, float qmul, float scale, int causal, int q_offset,
                    int k_offset, cudaStream_t stream) {
  const size_t smem =
      7 * kRows * (DM + 8) * sizeof(bf16) + kRows * sizeof(float);
  auto kernel = flash_bwd_dq_mma_kernel<DM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, glse, static_cast<bf16*>(dq), H,
      Tq, Tk, D, qmul, scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         const float* glse, void* dq, int B, int H, int Tq,
                         int Tk, int D, float qmul, float scale, int causal,
                         int q_offset, int k_offset, cudaStream_t st) {
  if (D <= 32)
    return run_mma<32>(q, k, v, o, dout, lse, glse, dq, B, H, Tq, Tk, D,
                       qmul, scale, causal, q_offset, k_offset, st);
  if (D <= 64)
    return run_mma<64>(q, k, v, o, dout, lse, glse, dq, B, H, Tq, Tk, D,
                       qmul, scale, causal, q_offset, k_offset, st);
  return run_mma<128>(q, k, v, o, dout, lse, glse, dq, B, H, Tq, Tk, D, qmul,
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
    err = dispatch_simt<float>(q, k, v, o, dout, l, g, dq, B, H, Tq, Tk, D,
                               qmul, scale, causal, q_offset, k_offset, st);
  else if (dtype == 1)
    err = dispatch_mma(q, k, v, o, dout, l, g, dq, B, H, Tq, Tk, D, qmul,
                       scale, causal, q_offset, k_offset, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
