// Key-plane lookup kernel of pilosa_tpu_torch, hand-written for Hopper
// (sm_90a).
//
// One entry point with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates the output, checks
// shapes, types and contiguity, and passes PyTorch's current stream:
//
//   pilosa_plane_lookup  for each probe hash (hi, lo), the id of the
//     leftmost plane slot whose hash equals it, or MISS (0).
//     Replaces pilosa_tpu/exec/keyplane.py _search + plane_lookup
//     (:149-171), which the JAX package left to XLA (log2(H) unrolled
//     gathers over the probe batch).
//
// The plane is [3, H] int32: rows 0 and 1 the high and low 32 bits of each
// key's 64-bit hash, row 2 its id, sorted by the hash as an unsigned
// 64-bit number (pilosa_tpu_torch/exec/keyplane.py build_plane). The lanes
// hold uint32 bit patterns in int32 tensors, so every compare here is
// unsigned: about half of the hashes have bit 31 of the high word set, and
// a signed compare would misplace them all. Padding slots hash to
// 2^64 - 1 with id MISS; a real key with that hash sorts left of them and
// the leftmost match finds it.
//
// Bound on the H100: memory latency, not bandwidth. A probe reads 8 bytes
// and writes 4; its search touches log2(H) + 1 slots of the two hash
// lanes, dependent loads one after another. At H = 2^20 the hash lanes
// take 8 MiB, which stays in the 50 MB L2 across a batch, so each step is
// an L2 round trip. The bytes the function must move (the plane once,
// each probe and id once) set the bound the smoke run states.
//
// What the design does about it: one thread a probe, 256 a block, so a
// batch of 65,536 probes keeps 256 blocks' worth of independent searches
// in flight to cover the dependent steps; the first steps of every search
// hit the same few slots, which the L1 and L2 serve.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool less_than(uint32_t ahi, uint32_t alo, uint32_t bhi,
                                          uint32_t blo) {
  return ahi < bhi || (ahi == bhi && alo < blo);
}

__global__ void __launch_bounds__(kThreads)
    plane_lookup_kernel(const uint32_t* __restrict__ hash_hi,
                        const uint32_t* __restrict__ hash_lo,
                        const int32_t* __restrict__ ids,
                        const uint32_t* __restrict__ probe_hi,
                        const uint32_t* __restrict__ probe_lo, int32_t* __restrict__ out,
                        int64_t h, int64_t q) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const uint32_t phi = __ldg(probe_hi + i);
  const uint32_t plo = __ldg(probe_lo + i);
  int64_t lo = 0, hi = h;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (less_than(__ldg(hash_hi + mid), __ldg(hash_lo + mid), phi, plo))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int64_t pos = lo < h ? lo : h - 1;
  const bool hit = __ldg(hash_hi + pos) == phi && __ldg(hash_lo + pos) == plo;
  out[i] = hit ? __ldg(ids + pos) : 0;
}

}  // namespace

// plane [3, h] int32 contiguous (hash hi, hash lo, id), sorted by the
// unsigned (hi, lo) pair; probe_hi, probe_lo [q] int32; out [q] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int pilosa_plane_lookup(const void* plane, int64_t h, const void* probe_hi,
                                   const void* probe_lo, void* out, int64_t q,
                                   void* stream) {
  if (h <= 0 || q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (q + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pl = static_cast<const uint32_t*>(plane);
  plane_lookup_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pl, pl + h, reinterpret_cast<const int32_t*>(pl + 2 * h),
      static_cast<const uint32_t*>(probe_hi), static_cast<const uint32_t*>(probe_lo),
      static_cast<int32_t*>(out), h, q);
  return static_cast<int>(cudaGetLastError());
}
