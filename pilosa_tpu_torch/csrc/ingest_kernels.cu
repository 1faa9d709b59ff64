// Ingest kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// One entry point with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which zeroes the output on PyTorch's
// current stream, checks shapes, and passes that stream:
//
//   pilosa_plane_scatter  a batch of M (position, value) entries of one
//     shard into its [2 + depth, W] BSI plane image: row 0 the exists
//     plane (every entry), row 1 the sign plane (negative values), row
//     2 + i magnitude bit i of |value|, for i < depth; bit pos & 31 of
//     word pos >> 5 in each plane where the entry belongs. Positions
//     outside [0, 32 W) are dropped.
//     Replaces pilosa_tpu/exec/ingest_transpose.py _plane_scatter
//     (:115-142), which the JAX package leaves to XLA (a .at[].add
//     scatter over uint32 halves of the magnitude, no pallas_call).
//
// The JAX version adds where this kernel ORs: the two agree because a
// batch's positions are distinct (Fragment.import_values dedupes them
// with np.unique), so no word gets the same bit twice. Nothing here
// depends on the order of the entries.
//
// Positions are int32 and values int64 as the fragment holds them: the
// word, the bit, the sign and the magnitude are worked out here. The
// magnitude is the unsigned 64-bit negation of a negative value, so
// INT64_MIN gives 2^63 (as numpy's abs(...).astype(uint64) does) and
// magnitude bits 32-62 need no second half. Words are 32-bit bit patterns
// (int32 tensors on the torch side), written as uint32, so bit 31 of a
// word is a bit like any other.
//
// Bound on the H100: memory bandwidth. The kernel reads 12 bytes an entry
// and the output, (2 + depth) x W words, is written once (its zero fill
// is a memset ahead of the kernel): at bench config 3's shard, about
// 21,000 values at depth 17, 0.25 MB in and 2.5 MB out, under a
// microsecond at 3.35 TB/s -- far under the few microseconds any launch
// takes, so the kernel is simple. A thread takes one entry in one plane
// (blockIdx.y is the plane), so a sparse shard's batch of a few hundred
// blocks of entries still spreads over every SM, and no thread waits on a
// chain of atomics (one thread an entry for all planes took 0.040 ms at
// the bench shard, its zero fill included; H100 80GB HBM3, 700 W). Lanes of a warp whose entries fall
// in one word (a full shard puts 32 sorted positions in every word) first
// OR their bits together with __match_any_sync and __reduce_or_sync, and
// the group's lowest lane makes the group's one atomicOr, so a dense batch
// makes a thirty-second of the atomics a sparse one would.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The deepest magnitude a BSI field holds (pilosa_tpu_torch/ops/kernels.py
// MAX_DEPTH).
constexpr int kMaxDepth = 63;

__global__ void plane_scatter_kernel(const int32_t* __restrict__ pos,
                                     const int64_t* __restrict__ vals, int64_t m,
                                     int64_t words, uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int plane = blockIdx.y;  // 0 exists, 1 sign, 2 + b magnitude bit b
  const unsigned live = __ballot_sync(0xffffffffu, i < m);
  if (i >= m) return;
  const int32_t p = pos[i];
  const bool keep = p >= 0 && static_cast<int64_t>(p >> 5) < words;
  // Dropped entries stay in the warp's collectives with an empty bit.
  const int64_t word = keep ? static_cast<int64_t>(p >> 5) : -1;
  const int64_t v = vals[i];
  const uint64_t mag = v < 0 ? 0ull - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
  const bool member = plane == 0   ? true
                      : plane == 1 ? v < 0
                                   : ((mag >> (plane - 2)) & 1ull) != 0;
  const uint32_t bit = keep && member ? (1u << (p & 31)) : 0u;

  const unsigned group = __match_any_sync(live, static_cast<unsigned long long>(word));
  const unsigned acc = __reduce_or_sync(group, bit);
  if ((__ffs(group) - 1) == static_cast<int>(threadIdx.x & 31) && acc)
    atomicOr(out + plane * words + word, acc);
}

}  // namespace

// out: a zeroed [2 + depth, words] uint32 image on the card; pos [m] int32,
// vals [m] int64, both contiguous on the same card.
extern "C" int pilosa_plane_scatter(const void* pos, const void* vals, int64_t m,
                                    int depth, int64_t words, void* out, void* stream) {
  if (m < 0 || depth < 0 || depth > kMaxDepth || words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(depth + 2));
  plane_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), static_cast<const int64_t*>(vals), m, words,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
