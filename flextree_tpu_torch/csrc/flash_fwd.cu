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
// softmax in float32 over 64-key tiles (KERNEL_TILE_K in
// ops/flash_attention.py), p rounded to v's dtype against the running max
// after its tile before p.v while l sums the unrounded p, a row that sees no
// key gives exactly 0 and the +1e30 sentinel.  The plain version is
// flextree_tpu_torch/ops/flash_attention.py::flash_fwd_plain.
//
// Bound: at the training shape (B=8, T=1024, H=8, D=64, bf16, causal) the
// work is ~8.6 GFLOP of products over ~34 MB of q, k, v, out and lse: ~250
// operations per byte, just under the card's ~295, so the least time is
// the bytes over the memory rate (~0.010 ms), with the bf16 tensor cores
// (~0.009 ms) nearly as close.
//
// Two kernels behind one entry point, chosen by dtype alone:
//
// - bfloat16 (flash_fwd_mma_kernel), FlashAttention-2's shape on the
//   tensor cores (flash_mma.cuh): one CTA per (64 query rows, b*h), 4 warps
//   of 16 rows; the causal triangle's long rows launch first.  q arrives by
//   cp.async, is pre-scaled in shared memory and held as A fragments; k/v
//   tiles of 64 keys stream through a two-stage cp.async ring, so the next
//   tile loads while this one computes.  s = q^.k^T by mma with k through
//   ldmatrix; m, l and the output stay in registers; p goes from the score
//   accumulators straight into the A fragments of p.v, v through
//   ldmatrix.trans.  Each tile's p.v is summed by the tensor cores and
//   added to the output by ordinary float32 arithmetic: the tensor cores'
//   float32 sums truncate, and a chain of them as long as the sequence
//   drifts past the bf16 bar at T = 4096.  Out leaves through shared
//   memory in 16-byte stores.
// - float32 (flash_fwd_kernel, SIMT, the TPU kernel's float32 bars that
//   TF32 cannot meet): 256 threads, products on the float32 cores, p
//   through shared memory (flash_common.cuh).
//
// Both walk the k/v tiles up to the causal bound kb_hi, and tiles below
// kb_full (every row sees every key) skip the mask, as the TPU kernel's
// full/masked loops do; the ragged edge is masked by position, never
// padded.

#include "flash_mma.cuh"

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
cudaError_t dispatch_simt(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int H, int Tq,
                          int Tk, int D, float qmul, int causal,
                          int q_offset, int k_offset, cudaStream_t st) {
  if (D <= 32)
    return run<E, 32>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
                      q_offset, k_offset, st);
  if (D <= 64)
    return run<E, 64>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
                      q_offset, k_offset, st);
  return run<E, 128>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
                     q_offset, k_offset, st);
}

// ---------------------------------------------------------------- bfloat16
//
// p enters p.v as one bf16 term, rounded: the TPU kernel's cast of p to
// v's dtype (c_to_a; the dk/dv kernel's dv takes three, for float32 p).
constexpr int kPTerms = 1;
// Keys per k/v tile: where the online softmax rounds p, so the plain
// version's KERNEL_TILE_K (ops/flash_attention.py) must equal it.
constexpr int kTileK = 64;
static_assert(kTileK == kRows, "k/v tiles are 64-row tiles, as q's");

// The register budget asks for 3 CTAs an SM (2 at DM = 128): shared memory
// allows 4 at DM = 64, but 4 would cap a thread at 128 registers and spill.
template <int DM>
__global__ void __launch_bounds__(kMmaThreads, DM == 128 ? 2 : 3)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int H, int Tq, int Tk,
                         int D, float qmul, int causal, int q_offset,
                         int k_offset) {
  constexpr int LD = DM + 8;          // bf16 row stride (flash_mma.cuh)
  constexpr int TILE = kRows * LD;    // a q, k or v tile
  constexpr int KC = DM / 16;         // 16-deep chunks of q.k
  constexpr int NS = kTileK / 8;      // 8-key blocks of a score tile
  constexpr int NO = DM / 8;          // 8-dim blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // q tile, pre-scaled
  bf16* sk = sq + TILE;                          // k tiles, 2 stages
  bf16* sv = sk + 2 * TILE;                      // v tiles, 2 stages

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
  const bf16* q_bh = q + (static_cast<size_t>(b) * Tq * H + h) * D;
  const bf16* k_bh = k + (static_cast<size_t>(b) * Tk * H + h) * D;
  const bf16* v_bh = v + (static_cast<size_t>(b) * Tk * H + h) * D;

  const int n_kb = (Tk + kTileK - 1) / kTileK;
  int kb_hi = n_kb;
  int kb_full = n_kb;
  if (causal) {
    const int hi = q_offset + q0 + kRows - k_offset;  // exclusive
    kb_hi = clampi(floor_div(hi + kTileK - 1, kTileK), 0, n_kb);
    const int lo_vis = q_offset + q0 - k_offset + 1;  // seen by the 1st row
    kb_full = clampi(floor_div(lo_vis, kTileK), 0, n_kb);
  }
  if (Tk % kTileK) kb_full = min(kb_full, Tk / kTileK);

  load_tile_async<DM>(sq, q_bh, q0, Tq, row_stride, D);
  cp_async_commit();
  if (kb_hi > 0) {
    load_tile_async<DM>(sk, k_bh, 0, Tk, row_stride, D);
    load_tile_async<DM>(sv, v_bh, 0, Tk, row_stride, D);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q has landed
  __syncthreads();
  const float qmul_b = round_bf16(qmul);
  prescale_tile<DM>(sq, qmul_b);
  __syncthreads();
  uint32_t qa[KC][4];  // this warp's 16 q rows as A fragments
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(qa[kc], a_addr(sq, LD, warp * 16, kc * 16, lane));

  // rows g and g + 8 of the warp's 16: running max, sum and output
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
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
      load_tile_async<DM>(sk + (stage ^ 1) * TILE, k_bh, (kb + 1) * kTileK,
                          Tk, row_stride, D);
      load_tile_async<DM>(sv + (stage ^ 1) * TILE, v_bh, (kb + 1) * kTileK,
                          Tk, row_stride, D);
    }
    cp_async_commit();
    const bf16* ks = sk + stage * TILE;
    const bf16* vs = sv + stage * TILE;

    // s = q^ . k^T: 16 rows x 64 keys, 8 C tiles
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t kf[4];
        ldsm_x4(kf, bn_addr(ks, LD, n2 * 16, kc * 16, lane));
        mma_bf16(sc[2 * n2], qa[kc], kf[0], kf[1]);
        mma_bf16(sc[2 * n2 + 1], qa[kc], kf[2], kf[3]);
      }

    // mask by position (the full tiles below kb_full skip it)
    if (kb >= kb_full) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kb * kTileK + n * 8 + 2 * t4 + (e & 1);
          if (kj >= Tk || (causal && qi0 + (e >> 1) * 8 < k_offset + kj))
            sc[n][e] = kNegInf;
        }
    }

    // online softmax: p against the running max after this tile; l adds
    // the unrounded p.  A row that has seen no key yet keeps m == kNegInf
    // and takes its p against 0 instead, so that every p of it is 0.
    float m_new[2], m_use[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_r[r];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      m_new[r] = quad_max(mx);
      m_use[r] = m_new[r] == kNegInf ? 0.f : m_new[r];
      corr[r] = fast_exp2(m_r[r] - m_new[r]);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(sc[n][e] - m_use[e >> 1]);
        sc[n][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] = l_r[r] * corr[r] + quad_sum(psum[r]);
      m_r[r] = m_new[r];
    }
    // acc = acc * corr + p . v: p straight from the score tiles into A
    // fragments, v by ldmatrix.trans.  The tensor cores' float32 sums
    // truncate, so each tile's p . v is summed by mma (4 steps) and the
    // running sum by ordinary float32 arithmetic: the error stays that of
    // one tile, whatever the number of tiles.
    uint32_t pa[NS / 2][kPTerms][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      c_to_a<kPTerms>(sc[2 * kk], sc[2 * kk + 1], pa[kk]);
#pragma unroll
    for (int j2 = 0; j2 < NO / 2; ++j2) {
      float pv[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, bt_addr(vs, LD, kk * 16, j2 * 16, lane));
#pragma unroll
        for (int t = 0; t < kPTerms; ++t) {
          mma_bf16(pv[0], pa[kk][t], vf[0], vf[1]);
          mma_bf16(pv[1], pa[kk][t], vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[2 * j2 + i][e] = fmaf(acc[2 * j2 + i][e], corr[e >> 1],
                                    pv[i][e]);
    }
  }

  // out = acc / l through this warp's own rows of the q tile (only this
  // warp read them), then 16-byte stores; the lse from the quad's lane 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const float l = l_r[r];
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(sq + row * LD + j * 8 + 2 * t4) =
          pack_bf16(l > 0.f ? acc[j][2 * r] / l : 0.f,
                    l > 0.f ? acc[j][2 * r + 1] / l : 0.f);
    if (lse != nullptr && t4 == 0 && q0 + row < Tq)
      lse[static_cast<size_t>(bh) * Tq + q0 + row] =
          l > 0.f ? (m_r[r] + log2f(fmaxf(l, 1e-38f))) * kLn2 : kSentinel;
  }
  __syncwarp();
  store_rows<DM>(sq, warp, out + (static_cast<size_t>(b) * Tq * H + h) * D,
                 q0, Tq, row_stride, D);
}

template <int DM>
cudaError_t run_mma(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int H, int Tq, int Tk, int D,
                    float qmul, int causal, int q_offset, int k_offset,
                    cudaStream_t stream) {
  const size_t smem = 5 * kRows * (DM + 8) * sizeof(bf16);
  auto kernel = flash_fwd_mma_kernel<DM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, H, Tq, Tk,
      D, qmul, causal, q_offset, k_offset);
  return cudaGetLastError();
}


cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int H, int Tq, int Tk,
                         int D, float qmul, int causal, int q_offset,
                         int k_offset, cudaStream_t st) {
  if (D <= 32)
    return run_mma<32>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
                       q_offset, k_offset, st);
  if (D <= 64)
    return run_mma<64>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
                       q_offset, k_offset, st);
  return run_mma<128>(q, k, v, out, lse, B, H, Tq, Tk, D, qmul, causal,
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
    err = dispatch_simt<float>(q, k, v, out, l, B, H, Tq, Tk, D, qmul,
                               causal, q_offset, k_offset, st);
  else if (dtype == 1)
    err = dispatch_mma(q, k, v, out, l, B, H, Tq, Tk, D, qmul, causal,
                       q_offset, k_offset, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
