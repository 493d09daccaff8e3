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
//
// Two kernels behind one entry point, chosen by dtype alone:
//
// - bfloat16 (flash_bwd_dkv_mma_kernel): the products on the tensor cores
//   (flash_mma.cuh).  One CTA per (64 key rows, b*h), 4 warps of 16 key
//   rows; low key tiles, which see the most q rows, launch first.  The
//   pre-scaled k tile and the v tile stay in shared memory as bf16; q, do,
//   o (for delta = rowsum(do * o)) and the row vectors lse and glse come
//   through a two-stage cp.async ring, so the next q tile loads while this
//   one computes.  Per q tile a warp forms s^T = k^.q^T and dp^T = v.do^T
//   (mma), p^T and ds^T in registers, then dv += p^T.do and dk += ds^T.q
//   from those registers repacked as A fragments, do and q through
//   ldmatrix.trans.  p enters dv as three bf16 terms (exact to ~2^-26 p,
//   so dv keeps float32 p); ds as one, rounded.  dk and dv stay in
//   registers across the walk, each the round-to-nearest float32 sum of
//   16-deep mma steps that start from zero and take their terms smallest
//   first (the tensor cores' own float32 sums truncate, and a chain of them
//   as long as the sequence drifts past the bf16 bar at T = 4096); no
//   atomics (dq has its own kernel).
// - float32 (flash_bwd_dkv_kernel, SIMT, the TPU kernel's float32 bars):
//   the same walk on 256 threads, products on the float32 cores, p and ds
//   through shared memory (flash_common.cuh).
//
// Both walk the q tiles from the causal bound qb_lo and drop the mask from
// qb_full_lo on (unless the key tile is ragged); masking is by position.

#include "flash_mma.cuh"

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
cudaError_t dispatch_simt(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          const float* glse, void* dk, void* dv, int B,
                          int H, int Tq, int Tk, int D, float kmul,
                          float scale, int causal, int q_offset,
                          int k_offset, cudaStream_t st) {
  if (D <= 32)
    return run<E, 32>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
                      kmul, scale, causal, q_offset, k_offset, st);
  if (D <= 64)
    return run<E, 64>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
                      kmul, scale, causal, q_offset, k_offset, st);
  return run<E, 128>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
                     kmul, scale, causal, q_offset, k_offset, st);
}

// ---------------------------------------------------------------- bfloat16
//
// dv takes p in float32, as the TPU kernel does: three bf16 terms (c_to_a),
// ~2^-26 relative (two leave ~2^-18, some 60 float32 ulps of p, and move
// ~20x more of dv's bf16 roundings than float32 summation order does).  ds
// enters ds^T q as one term, rounded to q's dtype.
constexpr int kPTerms = 3;
constexpr int kDsTerms = 1;

// The register budget asks for 2 CTAs an SM (1 at DM = 128, all 255
// registers a thread may have): shared memory would allow 3 at DM = 64, but
// 3 cap a thread at 168 registers, and dk, dv, s and dp then spill.
template <int DM>
__global__ void __launch_bounds__(kMmaThreads, DM == 128 ? 1 : 2)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ o,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ glse,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int H, int Tq, int Tk, int D, float kmul,
                             float scale, int causal, int q_offset,
                             int k_offset) {
  constexpr int LD = DM + 8;  // bf16 row stride (flash_mma.cuh)
  constexpr int TILE = kRows * LD;
  constexpr int KC = DM / 16;    // 16-deep chunks of k.q and v.do
  constexpr int NS = kRows / 8;  // 8-row blocks of a q tile
  constexpr int NO = DM / 8;     // 8-dim blocks of dk and dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // k tile, pre-scaled
  bf16* sv = sk + TILE;                          // v tile
  bf16* sq = sv + TILE;                          // q tiles, 2 stages
  bf16* sdo = sq + 2 * TILE;                     // do tiles, 2 stages
  bf16* so = sdo + 2 * TILE;                     // o tiles, 2 stages
  float* lse2_s = reinterpret_cast<float*>(so + 2 * TILE);  // 2 x 64
  float* gl_s = lse2_s + 2 * kRows;                         // 2 x 64
  float* delta_s = gl_s + 2 * kRows;                        // 64

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kRows;  // low key tiles see the most q rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row_stride = H * D;
  const size_t q_base = (static_cast<size_t>(b) * Tq * H + h) * D;
  const size_t k_base = (static_cast<size_t>(b) * Tk * H + h) * D;

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

  // q tile qb's rows: lse in log2 units (+1e30 past Tq) and glse (0 when
  // absent), by plain loads: a (b, h) row of lse need not be 16-byte aligned
  auto row_vectors = [&](int qb, float& l2, float& gl) {
    const int row = qb * kRows + (threadIdx.x & (kRows - 1));
    const size_t at = static_cast<size_t>(bh) * Tq + row;
    l2 = (row < Tq ? lse[at] : kSentinel) * kLog2e;
    gl = (row < Tq && glse != nullptr) ? glse[at] : 0.f;
  };
  auto load_q_tile = [&](int qb, int stage) {
    load_tile_async<DM>(sq + stage * TILE, q + q_base, qb * kRows, Tq,
                        row_stride, D);
    load_tile_async<DM>(sdo + stage * TILE, dout + q_base, qb * kRows, Tq,
                        row_stride, D);
    load_tile_async<DM>(so + stage * TILE, o + q_base, qb * kRows, Tq,
                        row_stride, D);
  };

  load_tile_async<DM>(sk, k + k_base, k0, Tk, row_stride, D);
  load_tile_async<DM>(sv, v + k_base, k0, Tk, row_stride, D);
  cp_async_commit();
  if (qb_lo < n_qb) {
    load_q_tile(qb_lo, 0);
    if (threadIdx.x < kRows) {
      float l2, gl;
      row_vectors(qb_lo, l2, gl);
      lse2_s[threadIdx.x] = l2;
      gl_s[threadIdx.x] = gl;
    }
  }
  cp_async_commit();
  cp_async_wait<1>();  // k and v have landed
  __syncthreads();
  const float kmul_b = round_bf16(kmul);
  prescale_tile<DM>(sk, kmul_b);
  __syncthreads();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int kj0 = k0 + warp * 16 + g;  // key row g of this warp

  for (int qb = qb_lo; qb < n_qb; ++qb) {
    const int stage = (qb - qb_lo) & 1;
    const int q0 = qb * kRows;
    cp_async_wait<0>();
    __syncthreads();  // tile qb is in; every warp is done with tile qb - 1
    const bool more = qb + 1 < n_qb;
    float next_l2 = 0.f, next_gl = 0.f;
    if (more) {  // the next tile loads while this one computes
      load_q_tile(qb + 1, stage ^ 1);
      if (threadIdx.x < kRows) row_vectors(qb + 1, next_l2, next_gl);
    }
    cp_async_commit();
    const bf16* qs = sq + stage * TILE;
    const bf16* dos = sdo + stage * TILE;
    const float* lse2 = lse2_s + stage * kRows;
    const float* gl = gl_s + stage * kRows;

    {  // delta = rowsum(do * o) in float32, two threads a row
      const int r = threadIdx.x >> 1;
      const int half = threadIdx.x & 1;
      const bf16* a = dos + r * LD + half * (DM / 2);
      const bf16* c = so + stage * TILE + r * LD + half * (DM / 2);
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

    // s^T = k^ . q^T and dp^T = v . do^T: 16 key rows x 64 q rows each
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr(sk, LD, warp * 16, kc * 16, lane));
      ldsm_x4(va, a_addr(sv, LD, warp * 16, kc * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t qf[4], df[4];
        ldsm_x4(qf, bn_addr(qs, LD, n2 * 16, kc * 16, lane));
        ldsm_x4(df, bn_addr(dos, LD, n2 * 16, kc * 16, lane));
        mma_bf16(st[2 * n2], ka, qf[0], qf[1]);
        mma_bf16(st[2 * n2 + 1], ka, qf[2], qf[3]);
        mma_bf16(dpt[2 * n2], va, df[0], df[1]);
        mma_bf16(dpt[2 * n2 + 1], va, df[2], df[3]);
      }
    }

    // p^T = exp2(s^T - lse2), exactly 0 where masked (the full q tiles
    // from qb_full_lo on skip the mask); ds^T = p^T (dp^T - delta + glse)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[n][e] = fast_exp2(st[n][e] - lse2[n * 8 + 2 * t4 + (e & 1)]);
    if (ragged || qb < qb_full_lo) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n * 8 + 2 * t4 + (e & 1);  // q row within the tile
          const int kj = kj0 + (e >> 1) * 8;
          if (kj >= Tk || (causal && q_offset + q0 + r < k_offset + kj))
            st[n][e] = 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = n * 8 + 2 * t4 + (e & 1);
        dpt[n][e] = st[n][e] * ((dpt[n][e] - delta_s[r]) + gl[r]);
      }

    // dv += p^T . do, then dk += ds^T . q: p^T and ds^T as A fragments, one
    // 16-row chunk at a time (so that few are live), do and q by
    // ldmatrix.trans.  The tensor cores' float32 sums truncate toward zero,
    // and a chain of them drifts one way: each 16-deep step starts from
    // zero, takes its terms smallest first (one truncation that matters),
    // and joins dk or dv by an ordinary, round-to-nearest float32 add.
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t pa[kPTerms][4];
      c_to_a<kPTerms>(st[2 * kk], st[2 * kk + 1], pa);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        uint32_t df[4];
        ldsm_x4_trans(df, bt_addr(dos, LD, kk * 16, j2 * 16, lane));
        float tv[2][4] = {};
#pragma unroll
        for (int t = kPTerms - 1; t >= 0; --t) {
          mma_bf16(tv[0], pa[t], df[0], df[1]);
          mma_bf16(tv[1], pa[t], df[2], df[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv_acc[2 * j2 + i][e] += tv[i][e];
      }
    }
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t da[kDsTerms][4];
      c_to_a<kDsTerms>(dpt[2 * kk], dpt[2 * kk + 1], da);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        uint32_t qf[4];
        ldsm_x4_trans(qf, bt_addr(qs, LD, kk * 16, j2 * 16, lane));
        float tk[2][4] = {};
#pragma unroll
        for (int t = kDsTerms - 1; t >= 0; --t) {
          mma_bf16(tk[0], da[t], qf[0], qf[1]);
          mma_bf16(tk[1], da[t], qf[2], qf[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dk_acc[2 * j2 + i][e] += tk[i][e];
      }
    }

    if (more && threadIdx.x < kRows) {  // tile qb + 1's row vectors
      lse2_s[(stage ^ 1) * kRows + threadIdx.x] = next_l2;
      gl_s[(stage ^ 1) * kRows + threadIdx.x] = next_gl;
    }
  }

  // dk (times scale) and dv through this warp's own rows of the k and v
  // tiles (only this warp read them), then 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(sk + row * LD + j * 8 + 2 * t4) =
          pack_bf16(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(sv + row * LD + j * 8 + 2 * t4) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
  __syncwarp();
  store_rows<DM>(sk, warp, dk + k_base, k0, Tk, row_stride, D);
  store_rows<DM>(sv, warp, dv + k_base, k0, Tk, row_stride, D);
}

template <int DM>
cudaError_t run_mma(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    const float* glse, void* dk, void* dv, int B, int H,
                    int Tq, int Tk, int D, float kmul, float scale,
                    int causal, int q_offset, int k_offset,
                    cudaStream_t stream) {
  const size_t smem = 8 * kRows * (DM + 8) * sizeof(bf16) +
                      5 * kRows * sizeof(float);
  auto kernel = flash_bwd_dkv_mma_kernel<DM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tk + kRows - 1) / kRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, glse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Tq, Tk, D, kmul, scale, causal, q_offset,
      k_offset);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         const float* glse, void* dk, void* dv, int B, int H,
                         int Tq, int Tk, int D, float kmul, float scale,
                         int causal, int q_offset, int k_offset,
                         cudaStream_t st) {
  if (D <= 32)
    return run_mma<32>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
                       kmul, scale, causal, q_offset, k_offset, st);
  if (D <= 64)
    return run_mma<64>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
                       kmul, scale, causal, q_offset, k_offset, st);
  return run_mma<128>(q, k, v, o, dout, lse, glse, dk, dv, B, H, Tq, Tk, D,
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
    err = dispatch_simt<float>(q, k, v, o, dout, l, g, dk, dv, B, H, Tq, Tk,
                               D, kmul, scale, causal, q_offset, k_offset,
                               st);
  else if (dtype == 1)
    err = dispatch_mma(q, k, v, o, dout, l, g, dk, dv, B, H, Tq, Tk, D, kmul,
                       scale, causal, q_offset, k_offset, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
