// Upload kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// One entry point with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates the output, checks
// shapes, and passes PyTorch's current stream:
//
//   pilosa_assemble_stack  a [s_pad + 1, W] stack from a few dense rows and
//     COO words: zero everything, copy dense row k to row didx[k], store
//     word cv[i] at (ci[i], cw[i]). Row s_pad is the trash row that the
//     pow2 padding of both inputs targets; the wrapper hands back rows
//     [0, s_pad).
//     Replaces pilosa_tpu/parallel/planner.py _assemble_stack
//     (:2046-2057), jitted per planner for the sparse-upload half of
//     _build_stack (:1336-1426), which the JAX package left to XLA.
//
// Words are 32-bit bit patterns (int32 tensors on the torch side).
//
// Bound on the H100: memory bandwidth. The planner's stack of 954 shards
// padded to 1024 writes [1024, 32768] x 4 B = 134 MB once, about 40 us at
// 3.35 TB/s; the inputs are what crossed PCIe, a few dense rows and 12 B
// per COO word, read once.
//
// What the design does about that bound:
//  * The zero fill is one cudaMemsetAsync over the whole stack, ahead of
//    the kernel on the same stream: the copy engine's fill runs at the
//    write bandwidth.
//  * One kernel does both stores. Its first blocks copy the dense rows,
//    16 bytes a thread with neighbouring threads on neighbouring words;
//    the rest store one COO word a thread. The planner sends a shard
//    either as a dense row or as COO words, never both, and the COO words
//    come from an OR-reduce over sorted positions, so every real (ci, cw)
//    pair is distinct: no two stores of different values meet, and plain
//    stores need no atomics. Pad entries all target the trash row, with
//    zero values.
//  * An entry whose row lies outside [0, s_pad] or whose word lies
//    outside [0, W) is skipped, so bad input cannot write past the stack
//    (the plain version in ops/kernels.py skips the same entries).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// grid = dense_blocks + coo_blocks (1-D). Blocks below dense_blocks copy
// the dense rows (V is uint4 when words % 4 == 0, else uint32_t); the rest
// store the COO words.
template <typename V>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(const int32_t* __restrict__ didx, const uint32_t* __restrict__ dmat,
                int64_t d_pad, const int32_t* __restrict__ ci,
                const int32_t* __restrict__ cw, const uint32_t* __restrict__ cv,
                int64_t n_pad, uint32_t* __restrict__ out, int64_t s_pad,
                int64_t words, int64_t dense_blocks) {
  constexpr int64_t kPer = sizeof(V) / 4;
  if (blockIdx.x < dense_blocks) {
    const int64_t per_row = words / kPer;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t k = i / per_row;
    if (k >= d_pad) return;
    const int64_t row = didx[k];
    if (row < 0 || row > s_pad) return;
    const int64_t w = i - k * per_row;
    reinterpret_cast<V*>(out + row * words)[w] =
        reinterpret_cast<const V*>(dmat + k * words)[w];
    return;
  }
  const int64_t j = (static_cast<int64_t>(blockIdx.x) - dense_blocks) * kThreads +
                    threadIdx.x;
  if (j >= n_pad) return;
  const int64_t row = ci[j];
  const int64_t w = cw[j];
  if (row < 0 || row > s_pad || w < 0 || w >= words) return;
  out[row * words + w] = cv[j];
}

}  // namespace

// out ([s_pad + 1, words] int32, contiguous) = zeros; then out[didx[k]] =
// dmat[k] for k in [0, d_pad) (dmat [d_pad, words], contiguous) and
// out[ci[i], cw[i]] = cv[i] for i in [0, n_pad). Every pointer is on the
// device, 16-byte aligned. Returns the first CUDA error of the fill or the
// launch.
extern "C" int pilosa_assemble_stack(const void* didx, const void* dmat, int64_t d_pad,
                                     const void* ci, const void* cw, const void* cv,
                                     int64_t n_pad, void* out, int64_t s_pad,
                                     int64_t words, void* stream) {
  if (s_pad < 0 || words <= 0 || d_pad < 0 || n_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(s_pad + 1) * words * sizeof(uint32_t);
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = words % 4 == 0;
  const int64_t per_row = vec ? words / 4 : words;
  const int64_t dense_blocks = (d_pad * per_row + kThreads - 1) / kThreads;
  const int64_t coo_blocks = (n_pad + kThreads - 1) / kThreads;
  const int64_t blocks = dense_blocks + coo_blocks;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pd = static_cast<const int32_t*>(didx);
  const auto* pm = static_cast<const uint32_t*>(dmat);
  const auto* pi = static_cast<const int32_t*>(ci);
  const auto* pw = static_cast<const int32_t*>(cw);
  const auto* pv = static_cast<const uint32_t*>(cv);
  auto* po = static_cast<uint32_t*>(out);
  if (vec)
    assemble_kernel<uint4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pd, pm, d_pad, pi, pw, pv, n_pad, po, s_pad, words, dense_blocks);
  else
    assemble_kernel<uint32_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pd, pm, d_pad, pi, pw, pv, n_pad, po, s_pad, words, dense_blocks);
  return static_cast<int>(cudaGetLastError());
}
