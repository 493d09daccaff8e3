// Fold W source buffers into one, elementwise, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of flextree_tpu/ops/pallas_reduce.py
// (launched by `reduce_stacked`).  For a contiguous (W, L) stack x it
// computes, per element i,
//
//     out[i] = fold over the W sources of x[j, i]
//
// with sum, prod, max, min, band, bor or bxor over the registry's dtypes.
// The fold order is the TPU kernel's: the sources go in groups of `st`
// (`sources_tile`); each group is folded pairwise (adjacent pairs, an odd
// last one carried up, level by level), then folded into the running
// accumulator, group after group.  At st = 1 that is the plain left fold
// acc = x[0]; acc = f(acc, x[j]) for j = 1..W-1.  Every step rounds to the
// storage type: float16 and bfloat16 are widened to float32 for one
// operation and rounded back (nearest even) before the next — exact, since
// the sum or product of two such values is exact in float32 before that
// one rounding — so nothing accumulates in float32.  Integer sums and
// products wrap (they are done in the unsigned type of the width), max and
// min take `a` where a > b (a < b) or a is NaN, else b — NaN propagates, as
// numpy's maximum and jnp.maximum do (fmaxf would drop it).
//
// Bound: bytes.  The fold reads W·L elements and writes L, with W−1
// operations per element written, far below the card's ~20 operations per
// byte for float32 outside the tensor cores.  The least time is
// (W+1)·L·itemsize over the memory rate (3.35 TB/s on an H100 SXM).
//
// Design (simple first; a later PR may add a persistent grid or TMA):
// - one thread owns VEC consecutive elements (16 bytes) of the output at a
//   time, walking the grid-stride loop; for each it loads 16 bytes of each
//   of the W sources, folds them in registers and stores once.  Threads of
//   a warp touch neighbouring 16-byte words, so every load is coalesced;
// - the vector path needs 16-byte-aligned rows (x, out and the row pitch
//   L·itemsize); otherwise the same kernel runs with VEC = 1.  Either way
//   the ragged edge is masked by the loop bound: nothing is padded and no
//   padding is copied (the TPU kernel padded L to rows_tile·128 with the
//   op's identity);
// - st > 1 keeps the group's partials in a small local array (at most
//   kMaxSourcesTile of them): a tuning knob on the TPU, kept here only so
//   the bits match the JAX kernel for every st.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSourcesTile = 32;

enum Op { kSum = 0, kProd = 1, kMax = 2, kMin = 3, kBand = 4, kBor = 5,
          kBxor = 6 };
enum DType { kF16 = 0, kBF16 = 1, kF32 = 2, kF64 = 3, kI8 = 4, kI16 = 5,
             kI32 = 6, kI64 = 7, kU8 = 8, kU16 = 9, kU32 = 10, kU64 = 11,
             kBool = 12 };

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

template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const T* __restrict__ x, T* __restrict__ out, int W, long long L,
            int st) {
  using P = Pack<T, VEC>;
  const P* src = reinterpret_cast<const P*>(x);
  P* dst = reinterpret_cast<P*>(out);
  const long long n = L / VEC;       // packs per row (L % VEC == 0)
  const long long pitch = L / VEC;   // row stride in packs
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    P acc;
    if (st == 1) {
      acc = src[i];
#pragma unroll 8
      for (int j = 1; j < W; ++j) acc = fold<T, OP, VEC>(acc, src[j * pitch + i]);
    } else {
      P vals[kMaxSourcesTile];
      for (int g = 0; g < W; g += st) {
        for (int t = 0; t < st; ++t) vals[t] = src[(g + t) * pitch + i];
        // pairwise, level by level: (0,1), (2,3), ... then (0,2), (4,6), ...
        for (int s = 1; s < st; s *= 2)
          for (int t = 0; t + s < st; t += 2 * s)
            vals[t] = fold<T, OP, VEC>(vals[t], vals[t + s]);
        acc = g == 0 ? vals[0] : fold<T, OP, VEC>(acc, vals[0]);
      }
    }
    dst[i] = acc;
  }
}

template <typename T, int OP>
cudaError_t launch(const void* x, void* out, int W, long long L, int st,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (L * static_cast<long long>(sizeof(T))) % 16 == 0;
  const long long n = vec ? L / kVec : L;
  const long long blocks_needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      blocks_needed < 132 * 32 ? blocks_needed : 132 * 32);
  const auto* xs = static_cast<const T*>(x);
  auto* os = static_cast<T*>(out);
  if (vec)
    fold_kernel<T, OP, kVec><<<blocks, kThreads, 0, stream>>>(xs, os, W, L,
                                                              st);
  else
    fold_kernel<T, OP, 1><<<blocks, kThreads, 0, stream>>>(xs, os, W, L, st);
  return cudaGetLastError();
}

// Integers: sums, products and the bitwise ops depend only on the width, so
// they run on the unsigned type of that width; max and min on the type.
template <typename S, typename U>
cudaError_t launch_int(int op, const void* x, void* out, int W, long long L,
                       int st, cudaStream_t s) {
  switch (op) {
    case kSum: return launch<U, kSum>(x, out, W, L, st, s);
    case kProd: return launch<U, kProd>(x, out, W, L, st, s);
    case kMax: return launch<S, kMax>(x, out, W, L, st, s);
    case kMin: return launch<S, kMin>(x, out, W, L, st, s);
    case kBand: return launch<U, kBand>(x, out, W, L, st, s);
    case kBor: return launch<U, kBor>(x, out, W, L, st, s);
    case kBxor: return launch<U, kBxor>(x, out, W, L, st, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_float(int op, const void* x, void* out, int W, long long L,
                         int st, cudaStream_t s) {
  switch (op) {
    case kSum: return launch<T, kSum>(x, out, W, L, st, s);
    case kProd: return launch<T, kProd>(x, out, W, L, st, s);
    case kMax: return launch<T, kMax>(x, out, W, L, st, s);
    case kMin: return launch<T, kMin>(x, out, W, L, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ft_reduce_stacked(const void* x, void* out, int W,
                                 long long L, int st, int dtype, int op,
                                 void* stream) {
  if (W < 1 || L < 1 || st < 1 || st > kMaxSourcesTile || W % st != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF16: err = launch_float<F16>(op, x, out, W, L, st, s); break;
    case kBF16: err = launch_float<BF16>(op, x, out, W, L, st, s); break;
    case kF32: err = launch_float<float>(op, x, out, W, L, st, s); break;
    case kF64: err = launch_float<double>(op, x, out, W, L, st, s); break;
    case kI8: err = launch_int<int8_t, uint8_t>(op, x, out, W, L, st, s); break;
    case kI16: err = launch_int<int16_t, uint16_t>(op, x, out, W, L, st, s); break;
    case kI32: err = launch_int<int32_t, uint32_t>(op, x, out, W, L, st, s); break;
    case kI64: err = launch_int<int64_t, uint64_t>(op, x, out, W, L, st, s); break;
    case kU8: err = launch_int<uint8_t, uint8_t>(op, x, out, W, L, st, s); break;
    case kU16: err = launch_int<uint16_t, uint16_t>(op, x, out, W, L, st, s); break;
    case kU32: err = launch_int<uint32_t, uint32_t>(op, x, out, W, L, st, s); break;
    case kU64: err = launch_int<uint64_t, uint64_t>(op, x, out, W, L, st, s); break;
    case kBool:  // 0/1 bytes: only the bitwise ops, which keep them 0/1
      err = (op == kBand || op == kBor || op == kBxor)
                ? launch_int<uint8_t, uint8_t>(op, x, out, W, L, st, s)
                : cudaErrorInvalidValue;
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
