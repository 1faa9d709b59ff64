// Count kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// Two entry points with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates every output, checks
// shapes, strides and alignment, and passes PyTorch's current stream:
//
//   pilosa_pair_count  per-row popcount(op(a, b)), op in {and, or, xor, andnot}
//     Replaces the TPU kernel pilosa_tpu/ops/pallas_kernels.py
//     _pallas_pair_count (body _count_kernel -> _accumulate_rowsum).
//   pilosa_row_counts  per-row popcount(a)
//     Replaces pilosa_tpu/ops/pallas_kernels.py _pallas_row_counts
//     (body _popcount_kernel -> _accumulate_rowsum).
//   pilosa_count_batched  either of the two over B slots in one launch,
//     each slot with its own operands (pair_count_batched and
//     row_counts_batched in ops/kernels.py)
//     Replaces jax.vmap of the count program over a wave of same-plan
//     queries (pilosa_tpu/parallel/coalesce.py:312-348 _flush_batched,
//     pilosa_tpu/parallel/planner.py:387-396 vmapped), which the JAX
//     coalescer cannot apply to its Pallas programs (coalesce.py:331-333).
//
// Words are 32-bit bit patterns (int32 tensors on the torch side; the
// kernel reads them as uint32). Counts are int32 per row: a shard row holds
// at most 2^30 bits.
//
// Bound on the H100: memory bandwidth. The 2-leaf Count over 954 shards
// padded to 1024 reads [1024, 32768] x 2 operands x 4 B = 268 MB once, about
// 80 us at 3.35 TB/s; popcount, the bitwise op and the adds are a few
// integer instructions per 4 bytes loaded, far below the integer rate.
//
// What the design does about that bound:
//  * Every word is read from device memory once, 16 bytes per thread per
//    load (uint4 through the read-only path) with neighbouring threads on
//    neighbouring addresses, so each warp issues full 512-byte requests.
//  * A block reduces one row x W-chunk. Blocks run in any order on the
//    132 SMs, so the TPU's sequential W grid axis (which accumulated into
//    o_ref) becomes a loop over the chunk inside the block plus one
//    atomicAdd per block into an output the wrapper zeroes. The chunk
//    (8192 words) gives [1024, 32768] 4096 blocks: enough to fill the card.
//  * Each operand has its own row stride and row count: row r of the
//    broadcast reads row r mod rows of an operand. A [W] filter counted
//    against an [M, W] stack has one row: the broadcast is never
//    materialised, and the filter's 128 KiB stays in L2 while every row
//    streams past it.
//  * An operand whose leading shape is a proper suffix of the other's (BSI
//    Sum's [S, W] class row against the [depth, S, W] magnitude cube) is
//    too large for L2 (128 MB at S = 1024), so re-reading it for every
//    plane would move 2 x depth planes. The repeat kernel gives each block
//    one (row, chunk) of the small operand, keeps that chunk in registers
//    (8 x 16 bytes a thread), and loops over the planes inside the block:
//    every word of both operands is read once, depth + 1 planes in all.
//  * Warp-shuffle reduction, then one shared-memory step across the
//    block's 8 warps: one atomic per block.
//  * Rows whose start is not 16-byte aligned (or row strides that are not
//    a multiple of 4 words) take the scalar loop; a ragged W tail is
//    counted by the scalar loop after the vector body.
//  * The batched entry adds a third grid axis over the slots. A slot's
//    operand bases, strides and row counts sit in a small table in device
//    memory (48 bytes a slot, copied on the launch's stream just before
//    it), so a wave of any width fits where a parameter block of 32 slots
//    would crowd the 4 KiB kernel-parameter limit. Every block reads its
//    slot's record once and then runs the same body as the single launch:
//    B slots move exactly the bytes of B single launches, in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { OP_AND = 0, OP_OR = 1, OP_XOR = 2, OP_ANDNOT = 3, OP_NONE = 4 };

constexpr int kThreads = 256;
constexpr int64_t kChunkWords = 8192;
constexpr int64_t kMaxGridY = 65535;

template <int OP>
__device__ __forceinline__ uint32_t apply_op(uint32_t a, uint32_t b) {
  if (OP == OP_AND) return a & b;
  if (OP == OP_OR) return a | b;
  if (OP == OP_XOR) return a ^ b;
  if (OP == OP_ANDNOT) return a & ~b;
  return a;
}

template <int OP>
__device__ __forceinline__ int popc4(const uint4& a, const uint4& b) {
  return __popc(apply_op<OP>(a.x, b.x)) + __popc(apply_op<OP>(a.y, b.y)) +
         __popc(apply_op<OP>(a.z, b.z)) + __popc(apply_op<OP>(a.w, b.w));
}

// Sum of `acc` over the block, valid in thread 0. The trailing barrier
// lets a block call it again (warp_sums is reused).
__device__ __forceinline__ int block_sum(int acc, int* warp_sums) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __syncthreads();
  return acc;
}

__device__ __forceinline__ void store_count(int* out, int64_t row, int acc,
                                            int accumulate) {
  if (threadIdx.x != 0) return;
  if (accumulate)
    atomicAdd(out + row, acc);
  else
    out[row] = acc;
}

// This thread's share of popcount(op(pa[lo:hi], pb[lo:hi])).
template <int OP, bool VEC>
__device__ __forceinline__ int count_chunk(const uint32_t* pa, const uint32_t* pb,
                                           int64_t lo, int64_t hi) {
  int acc = 0;
  int64_t tail = lo;
  if (VEC) {
    // lo is a multiple of 4 words (chunk is), and the wrapper only picks
    // VEC when both row starts are 16-byte aligned.
    const int64_t n4 = (hi - lo) >> 2;
    const uint4* va = reinterpret_cast<const uint4*>(pa + lo);
    const uint4* vb = reinterpret_cast<const uint4*>(pb + lo);
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      const uint4 x = __ldg(va + i);
      const uint4 y = (OP == OP_NONE) ? x : __ldg(vb + i);
      acc += popc4<OP>(x, y);
    }
    tail = lo + (n4 << 2);
  }
  for (int64_t i = tail + threadIdx.x; i < hi; i += kThreads) {
    const uint32_t x = __ldg(pa + i);
    const uint32_t y = (OP == OP_NONE) ? x : __ldg(pb + i);
    acc += __popc(apply_op<OP>(x, y));
  }
  return acc;
}

// grid = (rows, chunks). out[row] += popcount(op(a[row % a_rows, lo:hi],
// b[row % b_rows, lo:hi])).
template <int OP, bool VEC>
__global__ void __launch_bounds__(kThreads)
count_rows_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  int* __restrict__ out, int64_t words, int64_t a_stride,
                  int64_t b_stride, int64_t a_rows, int64_t b_rows,
                  int64_t chunk, int accumulate) {
  const int64_t row = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t hi = lo + chunk < words ? lo + chunk : words;
  const uint32_t* pa = a + (row % a_rows) * a_stride;
  const uint32_t* pb = (OP == OP_NONE) ? pa : b + (row % b_rows) * b_stride;
  __shared__ int warp_sums[kThreads / 32];
  store_count(out, row, block_sum(count_chunk<OP, VEC>(pa, pb, lo, hi), warp_sums),
              accumulate);
}

// One slot of a batched launch: its operands' bases, row strides (words)
// and row counts. Six int64 per slot, as the wrapper lays them out.
struct Slot {
  const uint32_t* a;
  const uint32_t* b;
  int64_t a_stride, b_stride, a_rows, b_rows;
};
static_assert(sizeof(Slot) == 6 * sizeof(int64_t), "Slot is six int64");

// grid = (rows, chunks, slots). Slot z's rows land in out[z * rows, ...):
// the body of count_rows_kernel with the operands read from the slot table.
template <int OP, bool VEC>
__global__ void __launch_bounds__(kThreads)
count_batched_kernel(const Slot* __restrict__ slots, int* __restrict__ out,
                     int64_t rows, int64_t words, int64_t chunk, int accumulate) {
  const Slot s = slots[blockIdx.z];
  const int64_t row = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t hi = lo + chunk < words ? lo + chunk : words;
  const uint32_t* pa = s.a + (row % s.a_rows) * s.a_stride;
  const uint32_t* pb = (OP == OP_NONE) ? pa : s.b + (row % s.b_rows) * s.b_stride;
  __shared__ int warp_sums[kThreads / 32];
  store_count(out + static_cast<int64_t>(blockIdx.z) * rows, row,
              block_sum(count_chunk<OP, VEC>(pa, pb, lo, hi), warp_sums),
              accumulate);
}

// uint4 loads a thread keeps in registers: one kChunkWords chunk per block.
constexpr int kRegVecs = static_cast<int>(kChunkWords / 4 / kThreads);

// The repeat kernel: rows = outer x inner, and the repeated operand (a when
// REP_A, else b) has `inner` rows, one for each row of every outer slice.
// grid = (inner, chunks). The block loads its chunk of the repeated row
// once, then for o in [0, outer) counts it against row o * inner + r of
// the other operand. VEC only: both operands 16-byte aligned row by row,
// and the chunk is kChunkWords.
template <int OP, bool REP_A>
__global__ void __launch_bounds__(kThreads)
count_repeat_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    int* __restrict__ out, int64_t words, int64_t a_stride,
                    int64_t b_stride, int64_t inner, int64_t outer,
                    int accumulate) {
  const int64_t r = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * kChunkWords;
  const int64_t hi = lo + kChunkWords < words ? lo + kChunkWords : words;
  const int64_t n4 = (hi - lo) >> 2;
  const int64_t tail = lo + (n4 << 2);
  const uint32_t* rep = REP_A ? a + r * a_stride : b + r * b_stride;
  const uint4* rep4 = reinterpret_cast<const uint4*>(rep + lo);
  uint4 keep[kRegVecs];
#pragma unroll
  for (int k = 0; k < kRegVecs; ++k) {
    const int64_t i = threadIdx.x + static_cast<int64_t>(k) * kThreads;
    keep[k] = i < n4 ? __ldg(rep4 + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  __shared__ int warp_sums[kThreads / 32];
  for (int64_t o = 0; o < outer; ++o) {
    const int64_t row = o * inner + r;
    const uint32_t* var = REP_A ? b + row * b_stride : a + row * a_stride;
    const uint4* var4 = reinterpret_cast<const uint4*>(var + lo);
    int acc = 0;
#pragma unroll
    for (int k = 0; k < kRegVecs; ++k) {
      const int64_t i = threadIdx.x + static_cast<int64_t>(k) * kThreads;
      if (i < n4) {
        const uint4 x = __ldg(var4 + i);
        acc += REP_A ? popc4<OP>(keep[k], x) : popc4<OP>(x, keep[k]);
      }
    }
    for (int64_t i = tail + threadIdx.x; i < hi; i += kThreads) {
      const uint32_t x = __ldg(var + i);
      const uint32_t y = __ldg(rep + i);
      acc += __popc(REP_A ? apply_op<OP>(y, x) : apply_op<OP>(x, y));
    }
    store_count(out, row, block_sum(acc, warp_sums), accumulate);
  }
}

// W chunking shared by every launch: (chunk, chunks), at most kMaxGridY
// chunks per row.
inline void chunking(int64_t words, int64_t* chunk, int64_t* chunks) {
  *chunk = kChunkWords;
  *chunks = (words + *chunk - 1) / *chunk;
  if (*chunks > kMaxGridY) {
    *chunk = ((words + kMaxGridY - 1) / kMaxGridY + 3) & ~int64_t(3);
    *chunks = (words + *chunk - 1) / *chunk;
  }
}

template <int OP>
int launch(const uint32_t* a, const uint32_t* b, int* out, int64_t rows,
           int64_t words, int64_t a_stride, int64_t b_stride, int64_t a_rows,
           int64_t b_rows, int vec, cudaStream_t stream) {
  if (rows <= 0 || words <= 0 || a_rows <= 0 || b_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0x7fffffffLL || rows % a_rows || rows % b_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t chunk, chunks;
  chunking(words, &chunk, &chunks);
  const int accumulate = chunks > 1;
  // One operand repeats across an outer axis with more than one row per
  // repeat (never a single broadcast row: that one stays in L2).
  const bool rep_a = a_rows > 1 && a_rows < rows && b_rows == rows;
  const bool rep_b = b_rows > 1 && b_rows < rows && a_rows == rows;
  if (vec && chunk == kChunkWords && (rep_a || rep_b)) {
    const int64_t inner = rep_a ? a_rows : b_rows;
    const dim3 grid(static_cast<unsigned>(inner), static_cast<unsigned>(chunks));
    if (rep_a)
      count_repeat_kernel<OP, true><<<grid, kThreads, 0, stream>>>(
          a, b, out, words, a_stride, b_stride, inner, rows / inner, accumulate);
    else
      count_repeat_kernel<OP, false><<<grid, kThreads, 0, stream>>>(
          a, b, out, words, a_stride, b_stride, inner, rows / inner, accumulate);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  if (vec)
    count_rows_kernel<OP, true><<<grid, kThreads, 0, stream>>>(
        a, b, out, words, a_stride, b_stride, a_rows, b_rows, chunk, accumulate);
  else
    count_rows_kernel<OP, false><<<grid, kThreads, 0, stream>>>(
        a, b, out, words, a_stride, b_stride, a_rows, b_rows, chunk, accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <int OP>
int launch_batched(const Slot* slots, int n_slots, int* out, int64_t rows,
                   int64_t words, int vec, cudaStream_t stream) {
  int64_t chunk, chunks;
  chunking(words, &chunk, &chunks);
  const int accumulate = chunks > 1;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks),
                  static_cast<unsigned>(n_slots));
  if (vec)
    count_batched_kernel<OP, true><<<grid, kThreads, 0, stream>>>(
        slots, out, rows, words, chunk, accumulate);
  else
    count_batched_kernel<OP, false><<<grid, kThreads, 0, stream>>>(
        slots, out, rows, words, chunk, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[r] = popcount(op(a[r % a_rows], b[r % b_rows])) for r in [0, rows);
// row i of a starts at a + i * a_stride words (b likewise). rows must be a
// multiple of a_rows and of b_rows. out must hold `rows` int32 zeros.
// Returns cudaGetLastError() after the launch.
extern "C" int pilosa_pair_count(const void* a, const void* b, void* out,
                                 int64_t rows, int64_t words, int64_t a_stride,
                                 int64_t b_stride, int64_t a_rows,
                                 int64_t b_rows, int op, int vec, void* stream) {
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_AND:
      return launch<OP_AND>(pa, pb, po, rows, words, a_stride, b_stride,
                            a_rows, b_rows, vec, s);
    case OP_OR:
      return launch<OP_OR>(pa, pb, po, rows, words, a_stride, b_stride,
                           a_rows, b_rows, vec, s);
    case OP_XOR:
      return launch<OP_XOR>(pa, pb, po, rows, words, a_stride, b_stride,
                            a_rows, b_rows, vec, s);
    case OP_ANDNOT:
      return launch<OP_ANDNOT>(pa, pb, po, rows, words, a_stride, b_stride,
                               a_rows, b_rows, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[r] = popcount(a[r]) for r in [0, rows). Same contract as above.
extern "C" int pilosa_row_counts(const void* a, void* out, int64_t rows,
                                 int64_t words, int64_t a_stride, int vec,
                                 void* stream) {
  const auto* pa = static_cast<const uint32_t*>(a);
  return launch<OP_NONE>(pa, pa, static_cast<int*>(out), rows, words, a_stride,
                         0, rows, rows, vec, static_cast<cudaStream_t>(stream));
}

// B slots in one launch: out[z * rows + r] = popcount(op(a_z[r % a_rows_z],
// b_z[r % b_rows_z])) for z in [0, n_slots), r in [0, rows). host_table
// holds n_slots Slot records (six int64 each: a, b, a_stride, b_stride,
// a_rows, b_rows); it is copied on `stream` into dev_table (room for the
// same bytes, allocated by the wrapper) before the kernel reads it. op 4
// counts a alone (row_counts). out must hold n_slots * rows int32 zeros.
// vec: every slot's rows are 16-byte aligned with strides a multiple of 4.
// Returns the first CUDA error of the copy or the launch.
extern "C" int pilosa_count_batched(const int64_t* host_table, void* dev_table,
                                    int n_slots, void* out, int64_t rows,
                                    int64_t words, int op, int vec, void* stream) {
  if (n_slots <= 0 || n_slots > kMaxGridY || rows <= 0 || words <= 0 ||
      rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* host = reinterpret_cast<const Slot*>(host_table);
  for (int z = 0; z < n_slots; ++z) {
    const Slot& t = host[z];
    if (t.a_rows <= 0 || rows % t.a_rows || (op != OP_NONE &&
                                             (t.b_rows <= 0 || rows % t.b_rows)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  // A pageable source: the copy returns once the table is staged, so the
  // caller may free it; the kernel after it on `s` sees the whole table.
  cudaError_t err = cudaMemcpyAsync(dev_table, host_table, n_slots * sizeof(Slot),
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* slots = static_cast<const Slot*>(dev_table);
  auto* po = static_cast<int*>(out);
  switch (op) {
    case OP_AND: return launch_batched<OP_AND>(slots, n_slots, po, rows, words, vec, s);
    case OP_OR: return launch_batched<OP_OR>(slots, n_slots, po, rows, words, vec, s);
    case OP_XOR: return launch_batched<OP_XOR>(slots, n_slots, po, rows, words, vec, s);
    case OP_ANDNOT:
      return launch_batched<OP_ANDNOT>(slots, n_slots, po, rows, words, vec, s);
    case OP_NONE: return launch_batched<OP_NONE>(slots, n_slots, po, rows, words, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
