// Coordinator reduce kernels of pilosa_tpu_torch, hand-written for Hopper
// (sm_90a).
//
// Two entry points with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates the outputs, checks
// shapes, and passes PyTorch's current stream:
//
//   pilosa_scatter_bits  a remote Row leg's unique column positions, as
//     segment index seg[i] and in-shard offset local[i] (both int32), into
//     an [n_segs + 1, W] word image: bit local & 31 of word local >> 5 of
//     row seg. Row n_segs is the padding sink; an entry whose segment is
//     outside [0, n_segs] or whose offset is outside [0, 32 W) is dropped.
//     Replaces pilosa_tpu/exec/device_reduce.py _scatter_bits (:111-118),
//     an XLA-fused scatter-add of 1 << (local & 31) (no pallas_call). The
//     positions of a leg are unique, so the JAX add and this kernel's OR
//     agree.
//   pilosa_or_fold  [B, K, W] words -> [B, W], the OR over K: the contested
//     shards of a distributed bitmap union. Replaces device_reduce.py
//     _or_fold (:120-124), an XLA-fused lax.reduce with bitwise_or.
//
// Words are 32-bit bit patterns (int32 tensors on the torch side), handled
// as uint32 here, so bit 31 of a word is a bit like any other.
//
// Bounds on the H100: memory bandwidth. scatter_bits reads 8 bytes a
// position and writes the image: the image is zeroed on the stream first
// (cudaMemsetAsync, a second pass over it), then each position is one
// global atomicOr into its word. A leg's positions arrive in column order,
// so a warp's 32 atomics mostly hit a few neighbouring words; this is the
// simple form, and its time against its bound is in PERF.md. or_fold reads
// every input word once and writes every output word once with 16-byte
// loads and stores, one thread per 4 words of an output row, the K loads
// of a thread issued back to back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_bits_kernel(const int32_t* __restrict__ seg,
                                    const int32_t* __restrict__ local, int64_t n,
                                    int64_t n_segs, int64_t words,
                                    uint32_t* __restrict__ out) {
  const int64_t bits = words * 32;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t s = seg[i];
    const int64_t p = local[i];
    if (s < 0 || s > n_segs || p < 0 || p >= bits) continue;
    atomicOr(out + s * words + (p >> 5), 1u << (p & 31));
  }
}

__global__ void or_fold_kernel(const uint4* __restrict__ in, int64_t b, int64_t k,
                               int64_t quads, uint4* __restrict__ out) {
  const int64_t total = b * quads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = t / quads;
    const int64_t q = t - row * quads;
    const uint4* src = in + row * k * quads + q;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (int64_t j = 0; j < k; ++j) {
      const uint4 v = __ldg(src + j * quads);
      acc.x |= v.x;
      acc.y |= v.y;
      acc.z |= v.z;
      acc.w |= v.w;
    }
    out[t] = acc;
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  // Grid-stride loops: a few waves of the 132 SMs are enough.
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

}  // namespace

// out: an [n_segs + 1, words] uint32 image on the card (zeroed here, on the
// stream); seg, local: [n] int32, contiguous, on the same card.
extern "C" int pilosa_scatter_bits(const void* seg, const void* local, int64_t n,
                                   int64_t n_segs, int64_t words, void* out,
                                   void* stream) {
  if (n < 0 || n_segs < 0 || words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>((n_segs + 1) * words) * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    scatter_bits_kernel<<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const int32_t*>(seg), static_cast<const int32_t*>(local), n, n_segs,
        words, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// in: [b, k, words] uint32, contiguous; out: [b, words] uint32, on the same
// card; both 16-byte aligned, words a multiple of 4.
extern "C" int pilosa_or_fold(const void* in, int64_t b, int64_t k, int64_t words,
                              void* out, void* stream) {
  if (b < 0 || k < 0 || words <= 0 || words % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0) return 0;
  const int64_t quads = words / 4;
  or_fold_kernel<<<grid_for(b * quads), kThreads, 0, st>>>(
      static_cast<const uint4*>(in), b, k, quads, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
