// BSI kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// Two entry points with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates every output, checks
// shapes, strides and alignment, and passes PyTorch's current stream. Both
// read the magnitude planes of a bit-sliced integer field as a cube
// bits[depth, n] (plane i holds weight 2^i of every column; a plane is one
// [S, W] shard stack, n = S * W words) and a filter of n words.
//
//   pilosa_bsi_compare  bit-serial unsigned compare against a predicate
//     Replaces pilosa_tpu/ops/bsi.py compare_unsigned + _compare_select
//     (:50-79), which the JAX package left to XLA to fuse; reached from
//     pilosa_tpu/parallel/planner.py _eval_node (:1976-2029).
//   pilosa_bsi_minmax   greedy bit-serial descent to a row's min or max
//     Replaces pilosa_tpu/ops/bsi.py _min_unsigned / _max_unsigned
//     (:208-257), also XLA-fused; reached from planner.py _agg_min_max
//     (:2085-2104).
//
// Words are 32-bit bit patterns (int32 tensors on the torch side, uint32
// here). The predicate travels as (lo, hi) 32-bit halves, so depths up to
// 63 work.
//
// Bound on the H100: memory bandwidth. At 1B columns (S = 1024 padded
// shards, depth 17) one plane is 128 MiB. bsi_compare reads 17 planes and
// the filter and writes one plane (2.55 GB, about 0.76 ms at 3.35 TB/s);
// bsi_minmax reads 17 planes and the filter (2.42 GB, about 0.72 ms). Each
// does a handful of integer operations per word loaded, far under the
// integer rate.
//
// What the designs do about that bound:
//  * bsi_compare: each thread owns 4 words (one 16-byte load per plane) of
//    the output, walks the planes from the top bit down with lt/eq/gt in
//    registers and the predicate bit taken from its scalar arguments, and
//    writes (lt | gt | eq as selected) & filter once. Each plane is read
//    once; no intermediate plane is written (XLA fused the same chain on
//    the TPU).
//  * bsi_minmax: one block of 1024 threads per row (one shard). A row of
//    32768 words is 8 x 16 bytes a thread, so the candidate set stays in
//    registers for the whole descent. Each step loads the thread's words
//    of plane i, counts cand & ~plane (min) or cand & plane (max), sums the
//    count over the block, and, when the count is not zero, narrows the
//    candidate set by reading the same words again (from L1: the block just
//    read them). HBM sees each plane row once. 1024 rows fill the 132 SMs
//    about eight times over. Rows of another width, or not 16-byte
//    aligned, take a scalar variant that keeps the candidate set in a
//    scratch row the wrapper allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum CompareOp { CMP_LT = 0, CMP_GT = 1, CMP_EQ = 2 };

constexpr int kCmpThreads = 256;
constexpr int kMMThreads = 1024;
constexpr int kMMVecs = 8;  // uint4 a thread: 1024 x 8 x 4 = 32768 words

__device__ __forceinline__ uint32_t pred_mask(uint32_t lo, uint32_t hi, int i) {
  const uint32_t bit = i < 32 ? (lo >> i) & 1u : (hi >> (i - 32)) & 1u;
  return 0u - bit;
}

struct Lanes {
  uint32_t lt, eq, gt;
};

__device__ __forceinline__ void compare_step(Lanes& s, uint32_t row, uint32_t pm) {
  s.lt |= s.eq & ~row & pm;
  s.gt |= s.eq & row & ~pm;
  s.eq &= ~(row ^ pm);
}

__device__ __forceinline__ uint32_t pick(const Lanes& s, int op, int allow_eq) {
  if (op == CMP_LT) return allow_eq ? (s.lt | s.eq) : s.lt;
  if (op == CMP_GT) return allow_eq ? (s.gt | s.eq) : s.gt;
  return s.eq;
}

// out[j] = select(compare(bits[:, j], pred)) & filt[j]. VEC: each thread
// takes 4 consecutive words (n, plane_stride multiples of 4, pointers
// 16-byte aligned); otherwise one word.
template <bool VEC>
__global__ void __launch_bounds__(kCmpThreads)
bsi_compare_kernel(const uint32_t* __restrict__ bits,
                   const uint32_t* __restrict__ filt, uint32_t* __restrict__ out,
                   int64_t n, int64_t plane_stride, int depth, uint32_t lo,
                   uint32_t hi, int op, int allow_eq) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kCmpThreads + threadIdx.x;
  if (VEC) {
    if (t >= (n >> 2)) return;
    Lanes s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = Lanes{0u, 0xffffffffu, 0u};
#pragma unroll 4
    for (int i = depth - 1; i >= 0; --i) {
      const uint4 r =
          __ldg(reinterpret_cast<const uint4*>(bits + i * plane_stride) + t);
      const uint32_t pm = pred_mask(lo, hi, i);
      compare_step(s[0], r.x, pm);
      compare_step(s[1], r.y, pm);
      compare_step(s[2], r.z, pm);
      compare_step(s[3], r.w, pm);
    }
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(filt) + t);
    uint4 o;
    o.x = pick(s[0], op, allow_eq) & f.x;
    o.y = pick(s[1], op, allow_eq) & f.y;
    o.z = pick(s[2], op, allow_eq) & f.z;
    o.w = pick(s[3], op, allow_eq) & f.w;
    reinterpret_cast<uint4*>(out)[t] = o;
  } else {
    if (t >= n) return;
    Lanes s{0u, 0xffffffffu, 0u};
    for (int i = depth - 1; i >= 0; --i)
      compare_step(s, __ldg(bits + i * plane_stride + t), pred_mask(lo, hi, i));
    out[t] = pick(s, op, allow_eq) & __ldg(filt + t);
  }
}

// Sum of v over a block of kMMThreads threads, returned to every thread.
// The trailing barrier lets the block call it again.
__device__ __forceinline__ int block_sum_all(int v, int* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < kMMThreads / 32 ? warp_sums[lane] : 0;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  return v;
}

template <bool IS_MAX>
__device__ __forceinline__ uint32_t narrow(uint32_t cand, uint32_t plane) {
  return IS_MAX ? (cand & plane) : (cand & ~plane);
}

template <bool IS_MAX>
__device__ __forceinline__ uint4 narrow4(const uint4& c, const uint4& p) {
  return make_uint4(narrow<IS_MAX>(c.x, p.x), narrow<IS_MAX>(c.y, p.y),
                    narrow<IS_MAX>(c.z, p.z), narrow<IS_MAX>(c.w, p.w));
}

__device__ __forceinline__ int popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// grid = rows, block = kMMThreads. Row r: cand = filt[r]; for i = depth-1
// down to 0, c = popcount(narrow(cand, bits[i][r])); if c > 0 the
// candidates narrow and bit i of the answer is 1 for max (0 for min),
// else it is 0 for max (1 for min). count = popcount of the final
// candidates (0 when depth is 0), which is the reference's count rule
// (bsi.py:229-232). REG: words <= kMMThreads * kMMVecs * 4, a multiple of
// 4, rows 16-byte aligned; the candidates live in registers. Otherwise
// `scratch` (rows x words, the filter copied in by the wrapper) holds them.
template <bool IS_MAX, bool REG>
__global__ void __launch_bounds__(kMMThreads, 1)
bsi_minmax_kernel(const uint32_t* __restrict__ bits,
                  const uint32_t* __restrict__ filt, uint32_t* __restrict__ scratch,
                  int* __restrict__ out_lo, int* __restrict__ out_hi,
                  int* __restrict__ out_count, int64_t words,
                  int64_t plane_stride, int depth) {
  __shared__ int warp_sums[kMMThreads / 32];
  const int64_t r = blockIdx.x;
  uint32_t lo = 0u, hi = 0u;
  int count = 0;
  if (REG) {
    const int64_t n4 = words >> 2;
    const uint4* f4 = reinterpret_cast<const uint4*>(filt + r * words);
    uint4 cand[kMMVecs];
#pragma unroll
    for (int k = 0; k < kMMVecs; ++k) {
      const int64_t j = threadIdx.x + static_cast<int64_t>(k) * kMMThreads;
      cand[k] = j < n4 ? __ldg(f4 + j) : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = depth - 1; i >= 0; --i) {
      const uint4* p4 =
          reinterpret_cast<const uint4*>(bits + i * plane_stride + r * words);
      int c = 0;
#pragma unroll
      for (int k = 0; k < kMMVecs; ++k) {
        const int64_t j = threadIdx.x + static_cast<int64_t>(k) * kMMThreads;
        if (j < n4) c += popc4(narrow4<IS_MAX>(cand[k], __ldg(p4 + j)));
      }
      const bool has = block_sum_all(c, warp_sums) > 0;
      if (has) {
#pragma unroll
        for (int k = 0; k < kMMVecs; ++k) {
          const int64_t j = threadIdx.x + static_cast<int64_t>(k) * kMMThreads;
          if (j < n4) cand[k] = narrow4<IS_MAX>(cand[k], __ldg(p4 + j));
        }
      }
      const uint32_t bit = (has == IS_MAX) ? 1u : 0u;
      if (i < 32) lo |= bit << i; else hi |= bit << (i - 32);
    }
    if (depth > 0) {
      int c = 0;
#pragma unroll
      for (int k = 0; k < kMMVecs; ++k) c += popc4(cand[k]);
      count = block_sum_all(c, warp_sums);
    }
  } else {
    uint32_t* cand = scratch + r * words;
    for (int i = depth - 1; i >= 0; --i) {
      const uint32_t* p = bits + i * plane_stride + r * words;
      int c = 0;
      for (int64_t j = threadIdx.x; j < words; j += kMMThreads)
        c += __popc(narrow<IS_MAX>(cand[j], __ldg(p + j)));
      const bool has = block_sum_all(c, warp_sums) > 0;
      if (has)
        for (int64_t j = threadIdx.x; j < words; j += kMMThreads)
          cand[j] = narrow<IS_MAX>(cand[j], __ldg(p + j));
      const uint32_t bit = (has == IS_MAX) ? 1u : 0u;
      if (i < 32) lo |= bit << i; else hi |= bit << (i - 32);
    }
    if (depth > 0) {
      int c = 0;
      for (int64_t j = threadIdx.x; j < words; j += kMMThreads) c += __popc(cand[j]);
      count = block_sum_all(c, warp_sums);
    }
  }
  if (threadIdx.x == 0) {
    out_lo[r] = static_cast<int>(lo);
    out_hi[r] = static_cast<int>(hi);
    out_count[r] = count;
  }
}

template <bool IS_MAX>
int launch_minmax(const uint32_t* bits, const uint32_t* filt, uint32_t* scratch,
                  int* lo, int* hi, int* count, int64_t rows, int64_t words,
                  int64_t plane_stride, int depth, int reg, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(rows));
  if (reg)
    bsi_minmax_kernel<IS_MAX, true><<<grid, kMMThreads, 0, s>>>(
        bits, filt, scratch, lo, hi, count, words, plane_stride, depth);
  else
    bsi_minmax_kernel<IS_MAX, false><<<grid, kMMThreads, 0, s>>>(
        bits, filt, scratch, lo, hi, count, words, plane_stride, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[j] = select(op, allow_eq) of the bit-serial compare of bits[:, j]
// (plane i at bits + i * plane_stride words) against the predicate
// (hi << 32 | lo), AND filt[j], for j in [0, n). op: 0 lt, 1 gt, 2 eq.
// vec: n and plane_stride multiples of 4 and all pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int pilosa_bsi_compare(const void* bits, const void* filt, void* out,
                                  int64_t n, int64_t plane_stride, int depth,
                                  uint32_t lo, uint32_t hi, int op, int allow_eq,
                                  int vec, void* stream) {
  if (n <= 0 || depth < 0 || depth > 63 || op < CMP_LT || op > CMP_EQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = vec ? n >> 2 : n;
  const int64_t blocks = (threads + kCmpThreads - 1) / kCmpThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pb = static_cast<const uint32_t*>(bits);
  const auto* pf = static_cast<const uint32_t*>(filt);
  auto* po = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    bsi_compare_kernel<true><<<static_cast<unsigned>(blocks), kCmpThreads, 0, s>>>(
        pb, pf, po, n, plane_stride, depth, lo, hi, op, allow_eq);
  else
    bsi_compare_kernel<false><<<static_cast<unsigned>(blocks), kCmpThreads, 0, s>>>(
        pb, pf, po, n, plane_stride, depth, lo, hi, op, allow_eq);
  return static_cast<int>(cudaGetLastError());
}

// Per row r in [0, rows): the min (is_max 0) or max (is_max 1) magnitude of
// the columns of filt[r] over bits[:, r] (plane i of row r at bits +
// i * plane_stride + r * words), as 32-bit halves lo[r], hi[r], and the
// reference's count[r]. reg: words <= 32768, a multiple of 4, and every row
// 16-byte aligned; otherwise scratch must hold rows x words words with the
// filter copied in (it is overwritten). Returns cudaGetLastError().
extern "C" int pilosa_bsi_minmax(const void* bits, const void* filt,
                                 void* scratch, void* lo, void* hi, void* count,
                                 int64_t rows, int64_t words,
                                 int64_t plane_stride, int depth, int is_max,
                                 int reg, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || words <= 0 || depth < 0 || depth > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reg && ((words & 3) != 0 || words > int64_t(kMMThreads) * kMMVecs * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pb = static_cast<const uint32_t*>(bits);
  const auto* pf = static_cast<const uint32_t*>(filt);
  auto* ps = static_cast<uint32_t*>(scratch);
  auto* plo = static_cast<int*>(lo);
  auto* phi = static_cast<int*>(hi);
  auto* pc = static_cast<int*>(count);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_max)
    return launch_minmax<true>(pb, pf, ps, plo, phi, pc, rows, words,
                               plane_stride, depth, reg, s);
  return launch_minmax<false>(pb, pf, ps, plo, phi, pc, rows, words,
                              plane_stride, depth, reg, s);
}
