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
// and writes 4; a binary search touches log2(H) + 1 slots of the hash
// lanes, dependent loads one after another. At H = 2^20 the hash lanes
// take 8 MiB, which stays in the 50 MB L2 across a batch, so each step is
// an L2 round trip. The bytes the function must move (each probe's
// deciding sectors, each probe and id once) set the bound the smoke run
// states.
//
// What the design does about it. Its first form ran one thread a probe
// over the whole plane: 21 dependent steps at H = 2^20, each loading both
// hash lanes (two sectors), 0.0157 ms for 65,536 probes. A second form
// (a 16-CTA cluster sharing 8,192 fences through distributed shared
// memory, then a binary search of the high lane in a 127-slot window) lost
// to it (0.0205 ms): its fence build and cluster barriers, and seven
// dependent L2 steps a probe, cost more than the top levels the L1 had
// been serving. Now:
//  * The top of the search runs in shared memory: each CTA loads a fence
//    table of F <= kFences high words, hash_hi[k << sh] for the least sh
//    that keeps F = ceil(H / 2^sh) within kFences (one load a thread: 256
//    sectors a CTA, 2 MiB of L2 reads at 65,536 probes, against the 20-odd
//    sectors each probe no longer reads), and a probe counts the fences
//    whose high word is below its own: log2(F) + 1 steps. That puts the
//    leftmost slot whose high word is not below it in a window between two
//    fences whose high words it now knows.
//  * The hashes are uniform 64-bit values (keyplane.py: splitmix64), so the
//    slot is where the probe's high word falls between the window's end
//    values. Each step reads the whole 32-byte sector (8 slots) at that
//    interpolated slot with two 16-byte loads: a sector that holds the
//    boundary answers at once (its count of words below the probe); one
//    wholly below or above it becomes the window's new end, with its value.
//    On uniform hashes the window of 4,096 slots (H = 2^20) ends in two or
//    three sector reads a probe, against 21 dependent steps. After
//    kInterpSteps the search halves the window instead, so any order of
//    hashes (repeated hashes, the padding, a run across a fence) ends in
//    at most log2 of the window more steps.
//  * The slot's high word is known when the window closes. Only where it
//    equals the probe's is one more round trip made, for the slot's low
//    word and id together; an absent hash (a different high word) costs
//    none. Where the low word is below the probe's, the run of equal high
//    words is searched again on the full (hi, lo) pair for the leftmost
//    slot not below it: repeated hashes and a real key at 2^64 - 1 beside
//    the padding stay exact.
//  * One thread a probe, kThreads a CTA: every CTA's fence table is its
//    own, with no cluster barrier, so a batch of 300 probes is two CTAs.
//    Sizes, timed on the card against 64 and 1,024 fences, 512 threads, 3
//    interpolated steps and none (scripts/sketch_probe.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Fences a CTA loads (1 KiB of shared memory).
constexpr int kFences = 256;
// Interpolated steps before the search halves its window instead.
constexpr int kInterpSteps = 8;

__device__ __forceinline__ bool less_than(uint32_t ahi, uint32_t alo, uint32_t bhi,
                                          uint32_t blo) {
  return ahi < bhi || (ahi == bhi && alo < blo);
}

// The id of the leftmost slot holding (phi, plo), or 0, from the CTA's
// fence table (fence k is slot k << shift, `count` of them) and the
// plane's lanes.
__device__ __forceinline__ int32_t search(const uint32_t* __restrict__ hash_hi,
                                          const uint32_t* __restrict__ hash_lo,
                                          const int32_t* __restrict__ ids,
                                          const uint32_t* fence, int64_t h, int shift,
                                          int count, uint32_t phi, uint32_t plo) {
  // c = the fences whose high word is below the probe's.
  int c = 0;
  for (int n = count; n > 0;) {
    const int half = n >> 1;
    if (fence[c + half] < phi) {
      c += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  // The leftmost slot whose high word is not below phi, lb, lies in [a, b]:
  // the slot before a holds va < phi, slot b (where b < h) holds vb >= phi.
  int64_t a = c == 0 ? 0 : ((static_cast<int64_t>(c) - 1) << shift) + 1;
  int64_t b = c == count ? h : static_cast<int64_t>(c) << shift;
  uint32_t va = c == 0 ? 0u : fence[c - 1];
  uint32_t vb = c == count ? 0u : fence[c];
  for (int step = 0; a < b; ++step) {
    int64_t pos = (a + b) >> 1;
    if (step < kInterpSteps) {
      const float top = b == h ? 4294967296.0f : static_cast<float>(vb);
      // In [0, 1] (fmaxf drops the NaN of ends that round together).
      const float f = fminf(fmaxf(__fdividef(static_cast<float>(phi) - static_cast<float>(va),
                                             top - static_cast<float>(va)),
                                  0.0f),
                            1.0f);
      pos = a + static_cast<int64_t>(f * static_cast<float>(b - a));
      pos = pos < a ? a : pos > b - 1 ? b - 1 : pos;
    }
    const int64_t s0 = pos & ~int64_t{7};
    uint32_t w[8];
    if (s0 + 8 <= h) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(hash_hi + s0));
      const uint4 y = __ldg(reinterpret_cast<const uint4*>(hash_hi + s0 + 4));
      w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
      w[4] = y.x, w[5] = y.y, w[6] = y.z, w[7] = y.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = s0 + j < h ? __ldg(hash_hi + s0 + j) : 0xffffffffu;
    }
    int below = 0;  // the sector's slots (within the plane) below phi
#pragma unroll
    for (int j = 0; j < 8; ++j) below += (s0 + j < h && w[j] < phi) ? 1 : 0;
    if (below == 0) {
      b = s0;
      vb = w[0];
    } else if (below == 8) {
      a = s0 + 8;
      va = w[7];
    } else {
      a = b = s0 + below;
#pragma unroll
      for (int j = 1; j < 8; ++j)
        if (j == below) vb = w[j];
    }
  }
  if (a >= h || vb != phi) return 0;
  uint32_t slo = __ldg(hash_lo + a);
  int32_t sid = __ldg(ids + a);
  if (slo < plo) {
    // The run of equal high words: the leftmost slot not below (phi, plo).
    int64_t lo = a + 1, hi = h;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (less_than(__ldg(hash_hi + mid), __ldg(hash_lo + mid), phi, plo))
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo >= h || __ldg(hash_hi + lo) != phi) return 0;
    slo = __ldg(hash_lo + lo);
    sid = __ldg(ids + lo);
  }
  return slo == plo ? sid : 0;
}

__global__ void __launch_bounds__(kThreads)
    plane_lookup_kernel(const uint32_t* __restrict__ hash_hi,
                        const uint32_t* __restrict__ hash_lo,
                        const int32_t* __restrict__ ids,
                        const uint32_t* __restrict__ probe_hi,
                        const uint32_t* __restrict__ probe_lo, int32_t* __restrict__ out,
                        int64_t h, int64_t q, int shift, int count) {
  __shared__ uint32_t fence[kFences];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = i < q;
  const uint32_t phi = active ? __ldg(probe_hi + i) : 0u;
  const uint32_t plo = active ? __ldg(probe_lo + i) : 0u;
  for (int k = threadIdx.x; k < count; k += kThreads)
    fence[k] = __ldg(hash_hi + (static_cast<int64_t>(k) << shift));
  __syncthreads();
  if (active) out[i] = search(hash_hi, hash_lo, ids, fence, h, shift, count, phi, plo);
}

}  // namespace

// plane [3, h] int32 contiguous and 16-byte aligned (hash hi, hash lo,
// id), sorted by the unsigned (hi, lo) pair; probe_hi, probe_lo [q] int32;
// out [q] int32. Returns cudaGetLastError() after the launch.
extern "C" int pilosa_plane_lookup(const void* plane, int64_t h, const void* probe_hi,
                                   const void* probe_lo, void* out, int64_t q,
                                   void* stream) {
  if (h <= 0 || q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (q + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int shift = 0;
  while (((h + (int64_t{1} << shift) - 1) >> shift) > kFences) ++shift;
  const int count = static_cast<int>((h + (int64_t{1} << shift) - 1) >> shift);
  const auto* pl = static_cast<const uint32_t*>(plane);
  plane_lookup_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pl, pl + h, reinterpret_cast<const int32_t*>(pl + 2 * h),
      static_cast<const uint32_t*>(probe_hi), static_cast<const uint32_t*>(probe_lo),
      static_cast<int32_t*>(out), h, q, shift, count);
  return static_cast<int>(cudaGetLastError());
}
