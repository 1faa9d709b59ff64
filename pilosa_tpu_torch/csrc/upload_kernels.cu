// Upload kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// One entry point with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates the output, checks
// shapes, and passes PyTorch's current stream:
//
//   pilosa_assemble_stack  an [s_pad, W] stack from a few dense rows and
//     COO words: dense row k at row didx[k], word cv[i] at (ci[i], cw[i]),
//     zeros elsewhere. The COO words come grouped by row, rows ascending
//     (ci non-decreasing); within a row they may come in any order.
//     Entries aimed at a row outside [0, s_pad) (the pow2 padding aims at
//     row s_pad) or a word outside [0, W) are dropped.
//     Replaces pilosa_tpu/parallel/planner.py _assemble_stack
//     (:2046-2057), jitted per planner for the sparse-upload half of
//     _build_stack (:1336-1426), which the JAX package left to XLA.
//
// Words are 32-bit bit patterns (int32 tensors on the torch side).
//
// Bound on the H100: memory bandwidth. The planner's stack of 954 shards
// padded to 1024 is [1024, 32768] x 4 B = 134 MB, written once: about 40 us
// at 3.35 TB/s; the inputs are what crossed PCIe, a few dense rows and 12 B
// per COO word, read once.
//
// What the design does about that bound: every output word is written
// once, in whole sectors, with no fill ahead of the kernel and no pass
// over the stack after it. One block builds one tile, kTileWords words of
// one row (32 KiB of shared memory: six blocks fit on an SM), and finds
// its inputs itself, while its threads zero the tile in shared memory:
//  * its dense row, by a scan of didx (a few entries) across the block;
//  * its row's COO range, by two warp-wide searches of ci (32 probes a
//    round, 4 rounds for 2^20 words) for the first entry at the row and
//    the first past it.
// Then the tile goes one of two ways:
//  * no COO words: the dense row's tile, or zeros, stored straight to the
//    stack with 16-byte stores (neighbouring threads on neighbouring
//    words), no shared-memory round trip;
//  * COO words: the tile is finished in shared memory (the dense row's
//    words copied over the zeros if the row has one, so a row both dense
//    and COO takes its COO words on top, as in the reference; then each of
//    the row's COO words that falls in the tile) and written out whole:
//    one bulk copy (cp.async.bulk.global.shared::cta) when W % 4 == 0,
//    coalesced stores otherwise.
// What is left above the bound is the COO tiles': each of a row's blocks
// reads the row's COO words (the four blocks of a 32768-word row read them
// four times, from L2 after the first) and holds its tile until the bulk
// copy has read it.
// A block stores only entries whose ci is its row and whose cw lies in
// its tile, so an entry out of bounds, or ci that is not grouped, can
// drop words but never write past the stack or into another row. Real
// (row, word) pairs must be distinct: two stores of different values to
// one word would race (the planner's OR-reduce guarantees it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTileWords = 8192;

// First j in [0, n) with a[j] >= key (n when none), when a is
// non-decreasing; a warp-wide search: each round the 32 lanes probe 32
// evenly spaced entries of [lo, hi), and the range shrinks to the gap
// between the last probe below key and the first at or above it. On
// unsorted input it still returns some j in [0, n].
__device__ __forceinline__ int64_t warp_lower_bound(const int32_t* __restrict__ a,
                                                    int64_t n, int64_t key) {
  const int64_t lane = threadIdx.x % 32;
  int64_t lo = 0, hi = n;
  while (hi - lo > 32) {
    const int64_t len = hi - lo;
    // Probes strictly increase: len >= 33, so consecutive ones differ by
    // at least len / 33 >= 1.
    const int64_t p = lo + (lane + 1) * len / 33;
    const int c = __popc(__ballot_sync(0xffffffffu, a[p] < key));
    const int64_t next_lo = c ? lo + c * len / 33 + 1 : lo;
    hi = c < 32 ? lo + (c + 1) * len / 33 : hi;
    lo = next_lo;
  }
  const int64_t p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, p < hi && a[p] < key));
}

// dst[i] = src[i] (or 0 when src is null) for i in [0, n), the block's
// threads on neighbouring elements.
template <typename V>
__device__ __forceinline__ void copy_or_zero(V* dst, const V* __restrict__ src, int64_t n) {
  if (src) {
#pragma unroll 4
    for (int64_t i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  } else {
    const V zero{};
#pragma unroll 4
    for (int64_t i = threadIdx.x; i < n; i += kThreads) dst[i] = zero;
  }
}

// grid = s_pad * tiles_per_row (1-D); block b builds words
// [t * kTileWords, (t + 1) * kTileWords) of row b / tiles_per_row, t =
// b % tiles_per_row. V is uint4 when words % 4 == 0 (every tile then
// starts and ends on 16 bytes), else uint32_t.
template <typename V>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(const int32_t* __restrict__ didx, const uint32_t* __restrict__ dmat,
                int64_t d_pad, const int32_t* __restrict__ ci,
                const int32_t* __restrict__ cw, const uint32_t* __restrict__ cv,
                int64_t n_pad, uint32_t* __restrict__ out, int64_t words,
                int64_t tiles_per_row) {
  constexpr int64_t kPer = sizeof(V) / 4;
  extern __shared__ __align__(16) uint32_t tile[];
  __shared__ int dense_k;
  __shared__ int64_t coo_range[2];
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x - row * tiles_per_row) * kTileWords;
  const int64_t n = words - start < kTileWords ? words - start : kTileWords;

  // Most tiles of a sparse upload are COO tiles of rows with no dense
  // row: zero the tile while the row's inputs are looked up.
  if (threadIdx.x == 0) dense_k = -1;
  copy_or_zero(reinterpret_cast<V*>(tile), static_cast<const V*>(nullptr), n / kPer);
  __syncthreads();
  // The last of equal didx entries wins, as in a store after a store.
  for (int64_t k = threadIdx.x; k < d_pad; k += kThreads)
    if (didx[k] == row) atomicMax(&dense_k, static_cast<int>(k));
  const int warp = threadIdx.x / 32;
  if (warp < 2) {
    const int64_t at = warp_lower_bound(ci, n_pad, row + warp);
    if (threadIdx.x % 32 == 0) coo_range[warp] = at;
  }
  __syncthreads();

  const int64_t lo = coo_range[0], hi = coo_range[1];
  uint32_t* dst = out + row * words + start;
  const uint32_t* src =
      dense_k >= 0 ? dmat + static_cast<int64_t>(dense_k) * words + start : nullptr;
  if (lo >= hi) {
    copy_or_zero(reinterpret_cast<V*>(dst), reinterpret_cast<const V*>(src), n / kPer);
    return;
  }
  if (src) {
    copy_or_zero(reinterpret_cast<V*>(tile), reinterpret_cast<const V*>(src), n / kPer);
    __syncthreads();
  }
  for (int64_t j = lo + threadIdx.x; j < hi; j += kThreads) {
    const int64_t w = static_cast<int64_t>(cw[j]) - start;
    if (ci[j] == row && w >= 0 && w < n) tile[w] = cv[j];
  }
  if constexpr (kPer == 4) {
    // The tile was written through the generic proxy; the bulk copy reads
    // it through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t src_smem = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   :: "l"(dst), "r"(src_smem), "r"(static_cast<uint32_t>(n * 4))
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // The tile must stay until the copy has read it: the block's shared
      // memory goes to another block when this one exits.
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n; i += kThreads) dst[i] = tile[i];
  }
}

}  // namespace

// out ([s_pad, words] int32, contiguous): row r is dmat[k] where didx[k]
// == r (dmat [d_pad, words], contiguous), else zeros, with cv[i] stored at
// word cw[i] for every i in [0, n_pad) with ci[i] == r. ci is
// non-decreasing. Every pointer is on the device, 16-byte aligned.
// Returns the launch's CUDA error.
extern "C" int pilosa_assemble_stack(const void* didx, const void* dmat, int64_t d_pad,
                                     const void* ci, const void* cw, const void* cv,
                                     int64_t n_pad, void* out, int64_t s_pad,
                                     int64_t words, void* stream) {
  if (s_pad < 0 || words <= 0 || d_pad < 0 || d_pad > 0x7fffffffLL || n_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_per_row = (words + kTileWords - 1) / kTileWords;
  const int64_t blocks = s_pad * tiles_per_row;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(words < kTileWords ? words : kTileWords) *
                      sizeof(uint32_t);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pd = static_cast<const int32_t*>(didx);
  const auto* pm = static_cast<const uint32_t*>(dmat);
  const auto* pi = static_cast<const int32_t*>(ci);
  const auto* pw = static_cast<const int32_t*>(cw);
  const auto* pv = static_cast<const uint32_t*>(cv);
  auto* po = static_cast<uint32_t*>(out);
  if (words % 4 == 0)
    assemble_kernel<uint4><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        pd, pm, d_pad, pi, pw, pv, n_pad, po, words, tiles_per_row);
  else
    assemble_kernel<uint32_t><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        pd, pm, d_pad, pi, pw, pv, n_pad, po, words, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}
