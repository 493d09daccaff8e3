// Device-memory copy for Hopper (sm_90a): the streaming ceiling that the
// fold kernel (reduce_stacked.cu) is judged against.
//
// Replaces the Pallas kernel `copy_kernel` of tools/roofline_reduce.py
// (`measure_copy_ceiling`), which copies a (rows, 128) float32 array in
// (1024, 128) tiles.  Here it copies any `nbytes` bytes: threads walk a
// grid-stride loop over 16-byte words (each thread loads one and stores
// it; neighbouring threads touch neighbouring words, so every access is
// coalesced), and the bytes past the last whole word, or every byte when
// either pointer is not 16-byte aligned, go one byte per thread.
//
// Bound: bytes — it reads nbytes and writes nbytes with no arithmetic, so
// the least time is 2·nbytes over the memory rate (3.35 TB/s on an H100
// SXM).  What it reaches is the practical ceiling for any kernel that
// streams device memory once.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
            long long words, const uint8_t* __restrict__ src_tail,
            uint8_t* __restrict__ dst_tail, long long tail) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < words; i += step) dst[i] = src[i];
  for (long long i = first; i < tail; i += step) dst_tail[i] = src_tail[i];
}

}  // namespace

extern "C" int ft_copy(const void* src, void* dst, long long nbytes,
                       void* stream) {
  if (nbytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const long long words = aligned ? nbytes / 16 : 0;
  const long long tail = nbytes - words * 16;
  const long long work = words > tail ? words : tail;
  const long long needed = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < 132 * 32 ? needed : 132 * 32);
  const auto* s8 = static_cast<const uint8_t*>(src);
  auto* d8 = static_cast<uint8_t*>(dst);
  copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), words,
      s8 + words * 16, d8 + words * 16, tail);
  return static_cast<int>(cudaGetLastError());
}
