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
//  * Each operand has its own row stride. A [W] filter counted against an
//    [M, W] stack has stride 0: the broadcast is never materialised, and
//    the filter's 128 KiB stays in L2 while every row streams past it.
//  * Warp-shuffle reduction, then one shared-memory step across the
//    block's 8 warps: one atomic per block.
//  * Rows whose start is not 16-byte aligned (or row strides that are not
//    a multiple of 4 words) take the scalar loop; a ragged W tail is
//    counted by the scalar loop after the vector body.

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

// grid = (rows, chunks). out[row] += popcount(op(a[row, lo:hi], b[row, lo:hi])).
template <int OP, bool VEC>
__global__ void __launch_bounds__(kThreads)
count_rows_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  int* __restrict__ out, int64_t words, int64_t a_stride,
                  int64_t b_stride, int64_t chunk, int accumulate) {
  const int64_t row = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t hi = lo + chunk < words ? lo + chunk : words;
  const uint32_t* pa = a + row * a_stride;
  const uint32_t* pb = (OP == OP_NONE) ? pa : b + row * b_stride;

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

  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      if (accumulate)
        atomicAdd(out + row, acc);
      else
        out[row] = acc;
    }
  }
}

template <int OP>
int launch(const uint32_t* a, const uint32_t* b, int* out, int64_t rows,
           int64_t words, int64_t a_stride, int64_t b_stride, int vec,
           cudaStream_t stream) {
  if (rows <= 0 || words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int64_t chunk = kChunkWords;
  int64_t chunks = (words + chunk - 1) / chunk;
  if (chunks > kMaxGridY) {
    chunk = ((words + kMaxGridY - 1) / kMaxGridY + 3) & ~int64_t(3);
    chunks = (words + chunk - 1) / chunk;
  }
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  const int accumulate = chunks > 1;
  if (vec)
    count_rows_kernel<OP, true><<<grid, kThreads, 0, stream>>>(
        a, b, out, words, a_stride, b_stride, chunk, accumulate);
  else
    count_rows_kernel<OP, false><<<grid, kThreads, 0, stream>>>(
        a, b, out, words, a_stride, b_stride, chunk, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[r] = popcount(op(a[r], b[r])) for r in [0, rows); a[r] starts at
// a + r * a_stride words (b likewise; stride 0 broadcasts one row). out must
// hold `rows` int32 zeros. Returns cudaGetLastError() after the launch.
extern "C" int pilosa_pair_count(const void* a, const void* b, void* out,
                                 int64_t rows, int64_t words, int64_t a_stride,
                                 int64_t b_stride, int op, int vec,
                                 void* stream) {
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_AND:
      return launch<OP_AND>(pa, pb, po, rows, words, a_stride, b_stride, vec, s);
    case OP_OR:
      return launch<OP_OR>(pa, pb, po, rows, words, a_stride, b_stride, vec, s);
    case OP_XOR:
      return launch<OP_XOR>(pa, pb, po, rows, words, a_stride, b_stride, vec, s);
    case OP_ANDNOT:
      return launch<OP_ANDNOT>(pa, pb, po, rows, words, a_stride, b_stride, vec, s);
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
                         0, vec, static_cast<cudaStream_t>(stream));
}
