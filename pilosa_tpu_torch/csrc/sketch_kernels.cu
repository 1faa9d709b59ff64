// Sketch kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// Three entry points with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates every output, checks
// shapes, types and contiguity, and passes PyTorch's current stream:
//
//   pilosa_hll_expand  the masked register gather of a filtered
//     Count(Distinct): for shard s and column c whose filter bit is set,
//     regs[s, packed[s, c] & 0x3FFFF] = max(., packed[s, c] >> 18).
//     Replaces pilosa_tpu/sketch/kernels.py hll_expand (:32-49), which the
//     JAX package left to XLA (one segment-max scatter), traced into the
//     planner's distinct program (pilosa_tpu/parallel/planner.py:749).
//   pilosa_hll_reduce  the register max over the shard axis of an
//     [S, 2^p] uint8 stack: pilosa_tpu/sketch/kernels.py hll_reduce (:52-54)
//     and the planner's jnp.max(..., axis=0) (planner.py:744, :749).
//   pilosa_similar_count  per candidate row of an [R, S, W] cube, the
//     popcount of (row AND filter) and of the row, each summed over the
//     shards, and the popcount of the filter: the three totals of
//     pilosa_tpu/sketch/kernels.py similar_program (:85-108). Its top_k
//     stays with the wrapper's caller (a stable torch.sort on the host
//     side of the planner).
//
// Bound on the H100: memory bandwidth for all three. hll_expand reads the
// [S, 32768] filter once, of the [S, 2^20] int32 plane (4 MiB a shard) the
// 32-byte sectors that hold a filtered column, and writes 2^p bytes a
// shard; a column costs a shift, a mask and at most one shared-memory
// atomic. hll_reduce reads S * 2^p bytes once. similar_count
// reads each cube word once and the filter once: (R + 1) * S * W * 4 bytes,
// two popcounts and an AND a word.
//
// What the designs do about it:
//  * hll_expand: one block a shard. A warp takes 32 filter words (1024
//    columns) at a time: lane l loads filter word l, a ballot skips the
//    whole group when no bit is set, and otherwise lane l takes the filter
//    bits of columns j * 128 + 4 l .. +3 for j < 8 from the owning lane by
//    shuffle and loads those four packed entries (16 bytes) only where one
//    of the four bits is set, so the plane's 32-byte sectors that hold no
//    filtered column are never read. Zero entries (absent columns) are
//    skipped. Where 2^p 32-bit registers fit in shared memory (p <= 14,
//    64 KiB), the block keeps its shard's register file there, maxes with
//    shared atomicMax and narrows it to bytes at the end, every output
//    byte written once. For p = 15..18 (128 KiB to 1 MiB of 32-bit
//    registers, past the 227 KiB a block may hold) the block zeroes its
//    own output row and maxes bytes in place with a compare-and-swap on
//    the aligned 32-bit word holding the byte: exact, and no other block
//    touches the row, so no grid-wide ordering is needed.
//  * hll_reduce: a block owns 32 words (128 registers) of the row; its 32
//    warps split the shard rows (warp w takes rows w, w + 32, ...), lane l
//    word l, and fold them with __vmaxu4 (4 byte maxes an instruction),
//    eight independent loads in flight a thread; the warps' partial maxima
//    meet in shared memory and warp 0 writes each output word once. One
//    launch, no zero fill, no atomics.
//  * similar_count: a block owns one span of the flattened [S * W] words,
//    holds the filter's span in registers (16 words a thread), and walks
//    every candidate row's span against it: every cube word and every
//    filter word is read once. Both popcounts come from the same load;
//    the filter's own popcount is taken once. Counts are int32, summed per
//    block and added with one atomicAdd each into the zeroed output, as
//    the JAX program sums in int32 (the host fold widens to int64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRhoShift = 18;
constexpr uint32_t kBucketMask = (1u << kRhoShift) - 1u;
constexpr int kExpandThreads = 512;
constexpr int kSharedMaxP = 14;

// Byte-wise max of `v` into the byte at `p`, exact under concurrency: a
// compare-and-swap on the aligned 32-bit word that holds it.
__device__ __forceinline__ void byte_max(uint8_t* p, uint32_t v) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  auto* word = reinterpret_cast<unsigned int*>(addr & ~uintptr_t(3));
  const unsigned int shift = static_cast<unsigned int>(addr & 3) * 8u;
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
  while (((old >> shift) & 0xffu) < v) {
    const unsigned int next = (old & ~(0xffu << shift)) | (v << shift);
    const unsigned int seen = atomicCAS(word, old, next);
    if (seen == old) break;
    old = seen;
  }
}

// One packed entry whose filter bit is `bit`: its register update, unless
// the column is absent (entry <= 0) or its bucket lies past the file.
template <bool SHARED>
__device__ __forceinline__ void observe(int32_t entry, uint32_t bit, uint32_t m,
                                        unsigned int* sregs, uint8_t* row) {
  if (!bit || entry <= 0) return;
  const uint32_t bucket = static_cast<uint32_t>(entry) & kBucketMask;
  if (bucket >= m) return;
  const uint32_t rho = static_cast<uint32_t>(entry) >> kRhoShift;
  if (SHARED)
    atomicMax(sregs + bucket, rho);
  else
    byte_max(row + bucket, rho & 0xffu);
}

template <bool SHARED>
__global__ void __launch_bounds__(kExpandThreads)
    hll_expand_kernel(const int32_t* __restrict__ packed,
                      const uint32_t* __restrict__ filt, uint8_t* __restrict__ out,
                      int64_t words, int p) {
  extern __shared__ unsigned int sregs[];
  const int64_t s = blockIdx.x;
  const uint32_t m = 1u << p;
  uint8_t* row = out + s * static_cast<int64_t>(m);
  if (SHARED) {
    for (uint32_t i = threadIdx.x; i < m; i += blockDim.x) sregs[i] = 0u;
  } else {
    // m >= 2^15 here: the row is whole 16-byte words.
    for (uint32_t i = threadIdx.x; i < m / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(row)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int32_t* prow = packed + s * words * 32;
  const uint32_t* frow = filt + s * words;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t groups = words / 32;
  for (int64_t g = warp; g < groups; g += n_warps) {
    const int64_t w0 = g * 32;
    const uint32_t fw = __ldg(frow + w0 + lane);
    if (__ballot_sync(0xffffffffu, fw != 0u) == 0u) continue;
    // Column j * 128 + 4 * lane + k of the group sits in filter word
    // j * 4 + lane / 8, bit (4 * lane + k) & 31.
    const int4* base = reinterpret_cast<const int4*>(prow + w0 * 32);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t word = __shfl_sync(0xffffffffu, fw, j * 4 + (lane >> 3));
      const uint32_t bits = (word >> ((4 * lane) & 31)) & 0xfu;
      if (!bits) continue;
      const int4 e = __ldg(base + j * 32 + lane);
      observe<SHARED>(e.x, bits & 1u, m, sregs, row);
      observe<SHARED>(e.y, (bits >> 1) & 1u, m, sregs, row);
      observe<SHARED>(e.z, (bits >> 2) & 1u, m, sregs, row);
      observe<SHARED>(e.w, (bits >> 3) & 1u, m, sregs, row);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < m; i += blockDim.x)
      row[i] = static_cast<uint8_t>(sregs[i]);
  }
}

constexpr int kReduceWarps = 32;

__global__ void __launch_bounds__(kReduceWarps * 32)
    hll_reduce_kernel(const uint32_t* __restrict__ regs, unsigned int* __restrict__ out,
                      int64_t rows, int64_t row_words) {
  __shared__ unsigned int part[kReduceWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  unsigned int acc = 0u;
  if (col < row_words) {
#pragma unroll 8
    for (int64_t r = warp; r < rows; r += kReduceWarps)
      acc = __vmaxu4(acc, __ldg(regs + r * row_words + col));
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < row_words) {
    unsigned int m = 0u;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) m = __vmaxu4(m, part[w][lane]);
    out[col] = m;
  }
}

constexpr int kSimThreads = 256;
constexpr int kSimVecs = 4;  // uint4 loads a thread: 16 words
constexpr int64_t kSimChunk = static_cast<int64_t>(kSimThreads) * kSimVecs * 4;

// Sum of `acc` over the block, valid in thread 0; callable repeatedly.
__device__ __forceinline__ int block_sum(int acc, int* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kSimThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __syncthreads();
  return acc;
}

// out[0:R] = inter, out[R:2R] = selfc, out[2R] = filtc, all accumulated.
__global__ void __launch_bounds__(kSimThreads)
    similar_count_kernel(const uint32_t* __restrict__ cube,
                         const uint32_t* __restrict__ filt, int* __restrict__ out,
                         int64_t n_rows, int64_t n) {
  __shared__ int warp_sums[kSimThreads / 32];
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kSimChunk;
  const int64_t hi = min(n, lo + kSimChunk);
  uint4 f[kSimVecs];
  int fc = 0;
#pragma unroll
  for (int k = 0; k < kSimVecs; ++k) {
    const int64_t i = lo + (static_cast<int64_t>(k) * kSimThreads + threadIdx.x) * 4;
    f[k] = i < hi ? __ldg(reinterpret_cast<const uint4*>(filt + i)) : make_uint4(0, 0, 0, 0);
    fc += __popc(f[k].x) + __popc(f[k].y) + __popc(f[k].z) + __popc(f[k].w);
  }
  fc = block_sum(fc, warp_sums);
  if (threadIdx.x == 0 && fc) atomicAdd(out + 2 * n_rows, fc);
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint32_t* crow = cube + r * n;
    int inter = 0, self = 0;
#pragma unroll
    for (int k = 0; k < kSimVecs; ++k) {
      const int64_t i = lo + (static_cast<int64_t>(k) * kSimThreads + threadIdx.x) * 4;
      if (i < hi) {
        const uint4 c = __ldg(reinterpret_cast<const uint4*>(crow + i));
        self += __popc(c.x) + __popc(c.y) + __popc(c.z) + __popc(c.w);
        inter += __popc(c.x & f[k].x) + __popc(c.y & f[k].y) + __popc(c.z & f[k].z) +
                 __popc(c.w & f[k].w);
      }
    }
    inter = block_sum(inter, warp_sums);
    self = block_sum(self, warp_sums);
    if (threadIdx.x == 0) {
      if (inter) atomicAdd(out + r, inter);
      if (self) atomicAdd(out + n_rows + r, self);
    }
  }
}

}  // namespace

// out[s, :] = the 2^p uint8 registers of shard s's columns whose bit is set
// in filt[s]: packed is [S, 32 * words] int32 (bucket | rho << 18, 0 for
// an absent column), filt [S, words] int32 bit patterns, both contiguous,
// packed 16-byte aligned, words a positive multiple of 32; out [S, 2^p]
// uint8, contiguous, written whole (no zeroing needed). 4 <= p <= 18.
// Returns cudaGetLastError() after the launch.
extern "C" int pilosa_hll_expand(const void* packed, const void* filt, void* out,
                                 int64_t rows, int64_t words, int p, void* stream) {
  if (p < 4 || p > 18 || rows <= 0 || rows > 0x7fffffffLL || words <= 0 || words % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const int32_t*>(packed);
  const auto* pf = static_cast<const uint32_t*>(filt);
  auto* po = static_cast<uint8_t*>(out);
  const dim3 grid(static_cast<unsigned int>(rows));
  if (p <= kSharedMaxP) {
    const size_t smem = sizeof(unsigned int) << p;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(hll_expand_kernel<true>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    hll_expand_kernel<true><<<grid, kExpandThreads, smem, s>>>(pk, pf, po, words, p);
  } else {
    hll_expand_kernel<false><<<grid, kExpandThreads, 0, s>>>(pk, pf, po, words, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[j] = max over r of regs[r, j]: regs [rows, m] uint8 contiguous and
// 4-byte aligned, m a multiple of 4 (m = 2^p, p >= 4); out [m] uint8,
// 4-byte aligned, written whole.
extern "C" int pilosa_hll_reduce(const void* regs, void* out, int64_t rows, int64_t m,
                                 void* stream) {
  if (rows <= 0 || m <= 0 || m % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_words = m / 4;
  const dim3 grid(static_cast<unsigned int>((row_words + 31) / 32));
  hll_reduce_kernel<<<grid, kReduceWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(regs), static_cast<unsigned int*>(out), rows, row_words);
  return static_cast<int>(cudaGetLastError());
}

// cube [n_rows, n] and filt [n] int32 bit patterns, contiguous and 16-byte
// aligned, n = S * W a multiple of 4; out [2 * n_rows + 1] int32 holding
// zeros receives inter, selfc, filtc.
extern "C" int pilosa_similar_count(const void* cube, const void* filt, void* out,
                                    int64_t n_rows, int64_t n, void* stream) {
  if (n_rows <= 0 || n <= 0 || n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kSimChunk - 1) / kSimChunk;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  similar_count_kernel<<<static_cast<unsigned int>(blocks), kSimThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cube), static_cast<const uint32_t*>(filt),
      static_cast<int*>(out), n_rows, n);
  return static_cast<int>(cudaGetLastError());
}
