// Fold W source buffers into one, elementwise, for Hopper (sm_90a): a
// batch of R such folds in one launch, each reading its sources where they
// lie.
//
// Replaces the Pallas kernel `_kernel` of flextree_tpu/ops/pallas_reduce.py
// (launched by `reduce_stacked`).  For each fold f of a launch, with W
// sources src[f][0..W-1] of L elements and an output out[f], it computes,
// per element i,
//
//     out[f][i] = fold over j of src[f][j][i]
//
// with sum, prod, max, min, band, bor or bxor over the registry's dtypes.
// Two entry points share the kernel:
// - ft_reduce_sources: R folds, each over W pointers (the collectives'
//   stage: one launch folds every local rank's group tiles in place, so no
//   staging stack is ever written);
// - ft_reduce_stacked: one fold over the rows of a contiguous (W, L) stack
//   (row j at x + j·L), the JAX kernel's own interface.
// The fold order is the TPU kernel's: the sources go in groups of `st`
// (`sources_tile`); each group is folded pairwise (adjacent pairs, an odd
// last one carried up, level by level), then folded into the running
// accumulator, group after group.  At st = 1 that is the plain left fold
// acc = src[0]; acc = f(acc, src[j]) for j = 1..W-1.  Every step rounds to
// the storage type: float16 and bfloat16 are widened to float32 for one
// operation and rounded back (nearest even) before the next — exact, since
// the sum or product of two such values is exact in float32 before that
// one rounding — so nothing accumulates in float32.  Integer sums and
// products wrap (they are done in the unsigned type of the width), max and
// min take `a` where a > b (a < b) or a is NaN, else b — NaN propagates, as
// numpy's maximum and jnp.maximum do (fmaxf would drop it).
//
// Bound: bytes.  A fold reads W·L elements and writes L, with W−1
// operations per element written, far below the card's ~20 operations per
// byte for float32 outside the tensor cores.  The least time of a launch
// is Σ_f (W+1)·L·itemsize over the memory rate (3.35 TB/s on an H100 SXM).
//
// Design:
// - one launch spans every fold of a batch: the allreduce's stage of 8
//   ranks is one launch of ~200 MB instead of eight of ~25 MB, each of
//   which is paced by its ramp and tail rather than by the memory system;
// - the argument block (pointers, L, W, st) is one __grid_constant__
//   struct of at most 4 KB: the kernel indexes the pointer table in the
//   parameter space, never through a copy in local memory.  A batch that
//   does not fit takes further launches (the wrapper's job);
// - a persistent grid that walks chunks across the folds.  One producer
//   warp streams each chunk's W sources into a ring of kTmaStages
//   shared-memory stages with 1-D bulk copies (`cp.async.bulk`,
//   completion on an mbarrier), so each SM keeps up to 96 KB in flight
//   (Little's law asks ~18 KB at 3.35 TB/s and ~0.7 µs of latency);
//   eight consumer warps fold from shared memory and store.  On an H100
//   it beat a body of 16-byte register loads (each thread starting four
//   packs of a source before folding them) at every stage shape of the
//   allreduce, by 0.8-10.9%;
// - sources are read once and outputs written once: stores, and the
//   element body's loads, use the streaming hint (`st.global.cs` /
//   `ld.global.cs`);
// - in place: an output may be its fold's source 0 (the ring folds a step
//   into its own block), so no pointer is __restrict__.  Each element's
//   sources are read before it is written: into shared memory before any
//   consumer writes the chunk (fold_kernel_tma), or by the thread that
//   writes it (fold_kernel).  Any other overlap is refused by the wrapper;
// - the bulk copies need every pointer and L·itemsize 16-byte aligned, and
//   a stage must hold 16 bytes of each source; a launch that misses
//   either runs fold_kernel, one element a thread step.  Either way the
//   ragged edge is masked: nothing is padded (the TPU kernel padded L to
//   rows_tile·128 with the op's identity);
// - st > 1 keeps the group's partials in a small local array (at most
//   kMaxSourcesTile of them): a tuning knob on the TPU, kept so the bits
//   match the JAX kernel for every st.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); they allocate nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kCtasPerSm = 4;
constexpr int kMaxSourcesTile = 32;
// pointers one launch carries: R·W sources plus R outputs
constexpr int kMaxPointers = 496;

constexpr int kTmaConsumers = 256;
constexpr int kTmaStages = 4;
constexpr int kTmaStageBytes = 24 * 1024;
constexpr int kTmaCtasPerSm = 2;

enum Op { kSum = 0, kProd = 1, kMax = 2, kMin = 3, kBand = 4, kBor = 5,
          kBxor = 6 };
enum DType { kF16 = 0, kBF16 = 1, kF32 = 2, kF64 = 3, kI8 = 4, kI16 = 5,
             kI32 = 6, kI64 = 7, kU8 = 8, kU16 = 9, kU32 = 10, kU64 = 11,
             kBool = 12 };

// The launch's arguments, passed by value.  Source j of fold f lies at
// ptr[f·fold_stride + j·source_stride] + j·pitch bytes: a pointer table
// (fold_stride W, source_stride 1, pitch 0) or one stack (0, 0, the row's
// bytes).  Fold f's output is ptr[out_base + f].
struct Args {
  long long L;       // elements of every source and output
  long long chunks;  // chunks per fold (set by the launcher)
  long long pitch;
  int R, W, st;
  int fold_stride, source_stride, out_base;
  int chunk_bytes;   // bytes of one source in a chunk (fold_kernel_tma)
  const void* ptr[kMaxPointers];
};
static_assert(sizeof(Args) <= 4096, "kernel parameters are limited to 4 KB");

// 16-bit floats are stored as their bits.
struct F16 { uint16_t bits; };
struct BF16 { uint16_t bits; };

__device__ __forceinline__ float widen(F16 h) {
  return __half2float(__ushort_as_half(h.bits));
}
__device__ __forceinline__ float widen(BF16 h) {
  return __uint_as_float(static_cast<uint32_t>(h.bits) << 16);
}
__device__ __forceinline__ void narrow(float f, F16* h) {
  h->bits = __half_as_ushort(__float2half_rn(f));
}
__device__ __forceinline__ void narrow(float f, BF16* h) {
  h->bits = __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <typename T>
__device__ __forceinline__ bool take_first(T a, T b, bool greater) {
  return greater ? a > b : a < b;
}

template <typename T>
__device__ __forceinline__ bool is_nan(T a) { return a != a; }

// One fold step on float32 / float64: round-to-nearest intrinsics, so the
// compiler cannot contract anything.
template <int OP>
__device__ __forceinline__ float fold_float(float a, float b) {
  if (OP == kSum) return __fadd_rn(a, b);
  if (OP == kProd) return __fmul_rn(a, b);
  return (take_first(a, b, OP == kMax) || is_nan(a)) ? a : b;
}
template <int OP>
__device__ __forceinline__ double fold_float(double a, double b) {
  if (OP == kSum) return __dadd_rn(a, b);
  if (OP == kProd) return __dmul_rn(a, b);
  return (take_first(a, b, OP == kMax) || is_nan(a)) ? a : b;
}

template <typename T, int OP>
struct Fold {  // integers
  // sums and products wrap: done in the unsigned type of at least 32 bits
  using Wide = std::conditional_t<(sizeof(T) > 4), uint64_t, uint32_t>;
  static __device__ __forceinline__ T apply(T a, T b) {
    if (OP == kSum) return static_cast<T>(static_cast<Wide>(a) +
                                          static_cast<Wide>(b));
    if (OP == kProd) return static_cast<T>(static_cast<Wide>(a) *
                                           static_cast<Wide>(b));
    if (OP == kMax) return a > b ? a : b;
    if (OP == kMin) return a < b ? a : b;
    if (OP == kBand) return static_cast<T>(a & b);
    if (OP == kBor) return static_cast<T>(a | b);
    return static_cast<T>(a ^ b);
  }
};
template <int OP>
struct Fold<float, OP> {
  static __device__ __forceinline__ float apply(float a, float b) {
    return fold_float<OP>(a, b);
  }
};
template <int OP>
struct Fold<double, OP> {
  static __device__ __forceinline__ double apply(double a, double b) {
    return fold_float<OP>(a, b);
  }
};
template <typename H, int OP>
struct FoldHalf {  // float16, bfloat16: widen, one step, round back
  static __device__ __forceinline__ H apply(H a, H b) {
    const float fa = widen(a), fb = widen(b);
    if (OP == kMax || OP == kMin)  // select: the operand's own bits
      return (take_first(fa, fb, OP == kMax) || is_nan(fa)) ? a : b;
    H out;
    narrow(fold_float<OP>(fa, fb), &out);
    return out;
  }
};
template <int OP>
struct Fold<F16, OP> : FoldHalf<F16, OP> {};
template <int OP>
struct Fold<BF16, OP> : FoldHalf<BF16, OP> {};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int OP, int VEC>
__device__ __forceinline__ Pack<T, VEC> fold(Pack<T, VEC> a,
                                             Pack<T, VEC> b) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) a.v[k] = Fold<T, OP>::apply(a.v[k], b.v[k]);
  return a;
}

// The unsigned word of each pack size, for the streaming intrinsics.
template <int N> struct Word;
template <> struct Word<1> { using type = unsigned char; };
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = unsigned long long; };
template <> struct Word<16> { using type = uint4; };

template <typename P>
__device__ __forceinline__ P load_stream(const P* p) {  // ld.global.cs
  using W = typename Word<sizeof(P)>::type;
  const W w = __ldcs(reinterpret_cast<const W*>(p));
  P v;
  memcpy(&v, &w, sizeof(P));
  return v;
}

template <typename P>
__device__ __forceinline__ void store_stream(P* p, P v) {  // st.global.cs
  using W = typename Word<sizeof(P)>::type;
  W w;
  memcpy(&w, &v, sizeof(P));
  __stcs(reinterpret_cast<W*>(p), w);
}

template <typename P>
__device__ __forceinline__ const P* source(const Args& a, int f, int j) {
  const char* base = static_cast<const char*>(
      a.ptr[f * a.fold_stride + j * a.source_stride]);
  return reinterpret_cast<const P*>(base + j * a.pitch);
}

// One element pack's fold over its W sources in the kernel's order;
// get(j) gives source j's pack.
template <typename T, int OP, int VEC, typename Get>
__device__ __forceinline__ Pack<T, VEC> fold_sources(Get get, int W, int st) {
  using P = Pack<T, VEC>;
  if (st == 1) {
    P acc = get(0);
    for (int j = 1; j < W; ++j) acc = fold<T, OP, VEC>(acc, get(j));
    return acc;
  }
  P acc;
  P vals[kMaxSourcesTile];
  for (int g = 0; g < W; g += st) {
    for (int t = 0; t < st; ++t) vals[t] = get(g + t);
    // pairwise, level by level: (0,1), (2,3), ... then (0,2), (4,6), ...
    for (int s = 1; s < st; s *= 2)
      for (int t = 0; t + s < st; t += 2 * s)
        vals[t] = fold<T, OP, VEC>(vals[t], vals[t + s]);
    acc = g == 0 ? vals[0] : fold<T, OP, VEC>(acc, vals[0]);
  }
  return acc;
}

// Any alignment: one element a thread step, kUnroll of them a block's
// width apart (a warp's loads coalesce), every load of a source started
// before any of them is folded.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const __grid_constant__ Args a) {
  constexpr int VEC = 1;
  using P = Pack<T, VEC>;
  const long long n = a.L;
  const long long total = static_cast<long long>(a.R) * a.chunks;
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    const int f = static_cast<int>(c / a.chunks);
    const long long i0 = (c - f * a.chunks) * (kThreads * kUnroll) +
                         threadIdx.x;
    P* dst = static_cast<P*>(const_cast<void*>(a.ptr[a.out_base + f]));
    if (a.st == 1) {
      P acc[kUnroll];
      const P* s0 = source<P>(a, f, 0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * kThreads < n) acc[u] = load_stream(s0 + i0 + u * kThreads);
      for (int j = 1; j < a.W; ++j) {
        const P* sj = source<P>(a, f, j);
        P v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + u * kThreads < n) v[u] = load_stream(sj + i0 + u * kThreads);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + u * kThreads < n) acc[u] = fold<T, OP, VEC>(acc[u], v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * kThreads < n) store_stream(dst + i0 + u * kThreads, acc[u]);
    } else {
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kThreads;
        if (i >= n) break;
        store_stream(dst + i, fold_sources<T, OP, VEC>(
            [&](int j) { return load_stream(source<P>(a, f, j) + i); },
            a.W, a.st));
      }
    }
  }
}

// ---------------------------------------------------------------- TMA body

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kTmaConsumers + 32)
fold_kernel_tma(const __grid_constant__ Args a) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  extern __shared__ __align__(128) unsigned char stage_mem[];
  __shared__ __align__(8) uint64_t full[kTmaStages], empty[kTmaStages];
  const long long total = static_cast<long long>(a.R) * a.chunks;
  const long long nbytes = a.L * static_cast<long long>(sizeof(T));
  const int cb = a.chunk_bytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&full[s])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_addr(&empty[s])), "r"(kTmaConsumers)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int it = 0;
  if (threadIdx.x >= kTmaConsumers) {  // the producer warp: one thread
    if (threadIdx.x != kTmaConsumers) return;
    for (long long c = blockIdx.x; c < total; c += gridDim.x, ++it) {
      const int s = it % kTmaStages;
      mbar_wait(&empty[s], ((it / kTmaStages) & 1) ^ 1);
      const int f = static_cast<int>(c / a.chunks);
      const long long off = (c - f * a.chunks) * cb;
      const uint32_t bytes =
          static_cast<uint32_t>(nbytes - off < cb ? nbytes - off : cb);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(&full[s])), "r"(bytes * a.W) : "memory");
      for (int j = 0; j < a.W; ++j) {
        const char* src = reinterpret_cast<const char*>(source<T>(a, f, j));
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(smem_addr(stage_mem + s * kTmaStageBytes + j * cb)),
               "l"(src + off), "r"(bytes), "r"(smem_addr(&full[s]))
            : "memory");
      }
    }
    return;
  }
  for (long long c = blockIdx.x; c < total; c += gridDim.x, ++it) {
    const int s = it % kTmaStages;
    mbar_wait(&full[s], (it / kTmaStages) & 1);
    const int f = static_cast<int>(c / a.chunks);
    const long long off = (c - f * a.chunks) * cb;
    const int packs = static_cast<int>(
        (nbytes - off < cb ? nbytes - off : cb) / 16);
    const unsigned char* stage = stage_mem + s * kTmaStageBytes;
    P* dst = reinterpret_cast<P*>(
        static_cast<char*>(const_cast<void*>(a.ptr[a.out_base + f])) + off);
    for (int k = threadIdx.x; k < packs; k += kTmaConsumers)
      store_stream(dst + k, fold_sources<T, OP, VEC>(
          [&](int j) {
            return reinterpret_cast<const P*>(stage + j * cb)[k];
          },
          a.W, a.st));
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(&empty[s])) : "memory");
  }
}

// ------------------------------------------------------------ launching

int sm_count() {
  static int counts[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

int grid_for(long long chunks, int per_sm) {
  const long long cap = static_cast<long long>(sm_count()) * per_sm;
  return static_cast<int>(chunks < cap ? chunks : cap);
}

// The bulk-copy body when every pointer and L·itemsize are 16-byte aligned
// and a stage holds 16 bytes of each of the W sources, else the element
// body.
template <typename T, int OP>
cudaError_t launch(Args& a, cudaStream_t stream) {
  bool bulk = (a.L * static_cast<long long>(sizeof(T))) % 16 == 0 &&
              kTmaStageBytes / a.W >= 16;
  for (int k = 0; k < a.out_base + a.R; ++k)
    bulk = bulk && reinterpret_cast<uintptr_t>(a.ptr[k]) % 16 == 0;
  if (bulk) {
    a.chunk_bytes = kTmaStageBytes / a.W / 16 * 16;
    const long long nbytes = a.L * static_cast<long long>(sizeof(T));
    a.chunks = (nbytes + a.chunk_bytes - 1) / a.chunk_bytes;
    constexpr int smem = kTmaStages * kTmaStageBytes;
    cudaError_t err = cudaFuncSetAttribute(
        fold_kernel_tma<T, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    fold_kernel_tma<T, OP>
        <<<grid_for(a.R * a.chunks, kTmaCtasPerSm), kTmaConsumers + 32, smem,
           stream>>>(a);
    return cudaGetLastError();
  }
  a.chunks = (a.L + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  fold_kernel<T, OP><<<grid_for(a.R * a.chunks, kCtasPerSm), kThreads, 0,
                       stream>>>(a);
  return cudaGetLastError();
}

// Integers: sums, products and the bitwise ops depend only on the width, so
// they run on the unsigned type of that width; max and min on the type.
template <typename S, typename U>
cudaError_t launch_int(int op, Args& a, cudaStream_t s) {
  switch (op) {
    case kSum: return launch<U, kSum>(a, s);
    case kProd: return launch<U, kProd>(a, s);
    case kMax: return launch<S, kMax>(a, s);
    case kMin: return launch<S, kMin>(a, s);
    case kBand: return launch<U, kBand>(a, s);
    case kBor: return launch<U, kBor>(a, s);
    case kBxor: return launch<U, kBxor>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_float(int op, Args& a, cudaStream_t s) {
  switch (op) {
    case kSum: return launch<T, kSum>(a, s);
    case kProd: return launch<T, kProd>(a, s);
    case kMax: return launch<T, kMax>(a, s);
    case kMin: return launch<T, kMin>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(Args& a, int dtype, int op, void* stream) {
  if (a.R < 1 || a.W < 1 || a.L < 1 || a.st < 1 || a.st > kMaxSourcesTile ||
      a.W % a.st != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF16: err = launch_float<F16>(op, a, s); break;
    case kBF16: err = launch_float<BF16>(op, a, s); break;
    case kF32: err = launch_float<float>(op, a, s); break;
    case kF64: err = launch_float<double>(op, a, s); break;
    case kI8: err = launch_int<int8_t, uint8_t>(op, a, s); break;
    case kI16: err = launch_int<int16_t, uint16_t>(op, a, s); break;
    case kI32: err = launch_int<int32_t, uint32_t>(op, a, s); break;
    case kI64: err = launch_int<int64_t, uint64_t>(op, a, s); break;
    case kU8: err = launch_int<uint8_t, uint8_t>(op, a, s); break;
    case kU16: err = launch_int<uint16_t, uint16_t>(op, a, s); break;
    case kU32: err = launch_int<uint32_t, uint32_t>(op, a, s); break;
    case kU64: err = launch_int<uint64_t, uint64_t>(op, a, s); break;
    case kBool:  // 0/1 bytes: only the bitwise ops, which keep them 0/1
      err = (op == kBand || op == kBor || op == kBxor)
                ? launch_int<uint8_t, uint8_t>(op, a, s)
                : cudaErrorInvalidValue;
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int element_bytes(int dtype) {
  switch (dtype) {
    case kF16: case kBF16: case kI16: case kU16: return 2;
    case kF32: case kI32: case kU32: return 4;
    case kF64: case kI64: case kU64: return 8;
    default: return 1;
  }
}

}  // namespace

// One fold of a contiguous (W, L) stack over its rows, into out.
extern "C" int ft_reduce_stacked(const void* x, void* out, int W,
                                 long long L, int st, int dtype, int op,
                                 void* stream) {
  Args a = {};
  a.L = L;
  a.pitch = L * element_bytes(dtype);
  a.R = 1;
  a.W = W;
  a.st = st;
  a.out_base = 1;
  a.ptr[0] = x;
  a.ptr[1] = out;
  return dispatch(a, dtype, op, stream);
}

// R folds of W sources each: fold f reads sources[f·W + j] (j in fold
// order) and writes outs[f].  R·(W + 1) must not exceed kMaxPointers.
extern "C" int ft_reduce_sources(const void* const* sources,
                                 void* const* outs, int R, int W,
                                 long long L, int st, int dtype, int op,
                                 void* stream) {
  if (R < 1 || W < 1 || static_cast<long long>(R) * (W + 1) > kMaxPointers)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.L = L;
  a.R = R;
  a.W = W;
  a.st = st;
  a.fold_stride = W;
  a.source_stride = 1;
  a.out_base = R * W;
  for (int k = 0; k < R * W; ++k) a.ptr[k] = sources[k];
  for (int f = 0; f < R; ++f) a.ptr[R * W + f] = outs[f];
  return dispatch(a, dtype, op, stream);
}
