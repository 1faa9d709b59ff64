// Coordinator reduce kernels of pilosa_tpu_torch, hand-written for Hopper
// (sm_90a).
//
// Three entry points with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates the outputs, checks
// shapes, and passes PyTorch's current stream:
//
//   pilosa_scatter_bits_grouped  a remote Row leg's unique column
//     positions, grouped by segment: row r's in-shard offsets are
//     local[starts[r], starts[r + 1]) (int32), into an [n_segs + 1, W]
//     word image: bit local & 31 of word local >> 5 of row r. Row n_segs
//     is the padding sink; an offset outside [0, 32 W) is dropped. The
//     coordinator's decode of every remote Row leg
//     (exec/device_reduce.row_from_columns) calls it.
//   pilosa_scatter_bits  the same image from positions in any order, as
//     segment index seg[i] and offset local[i] (both int32); an entry
//     whose segment is outside [0, n_segs] is dropped too. No serving
//     path calls it: the grouped form took its place.
//     Both replace pilosa_tpu/exec/device_reduce.py _scatter_bits
//     (:111-118), an XLA-fused scatter-add of 1 << (local & 31) (no
//     pallas_call). The positions of a leg are unique, so the JAX add and
//     these kernels' OR agree.
//   pilosa_or_fold  [B, K, W] words -> [B, W], the OR over K: the contested
//     shards of a distributed bitmap union. Replaces device_reduce.py
//     _or_fold (:120-124), an XLA-fused lax.reduce with bitwise_or.
//
// Words are 32-bit bit patterns (int32 tensors on the torch side), handled
// as uint32 here, so bit 31 of a word is a bit like any other.
//
// Bounds on the H100: memory bandwidth. The grouped form needs 4 bytes a
// position and the row starts in, and the image out once: at a 32-shard
// leg (1.6M positions, [33, 32768]) about 11 MB, 3.2 us at 3.35 TB/s, under
// the few microseconds any launch takes. So its design spends no second
// pass over the image and no global atomics, as plane_scatter's
// (ingest_kernels.cu) does:
//
// - One thread-block cluster of kCluster CTAs a row. CTA k holds words
//   [k S, (k + 1) S) of the row (its slab, S = W / kCluster: 8 KiB at 16
//   CTAs and W = 32,768) in shared memory, zeroed on chip.
// - The cluster's CTAs split the row's positions in contiguous chunks. A
//   CTA streams the 16-byte-aligned body of its chunk through a ring of
//   kStages shared-memory stages by 1-D bulk copies (cp.async.bulk,
//   bulk_ring.cuh); the at most 3 positions before and after the body are
//   read directly. A leg's positions are sorted, so a chunk's positions
//   mostly land in the CTA's own slab.
// - A warp takes kBatch x 32 consecutive positions at a time; each sets
//   its bit by a shared-memory atomicOr into the owning slab (another
//   CTA's through cluster.map_shared_rank). A batch that is one run of
//   consecutive positions (a dense row) instead fills whole words, an
//   atomic a word. Any order of the positions gives the same image.
// - After a cluster barrier each CTA stores its slab with 16-byte stores,
//   so every word of the image is written exactly once, the zero words and
//   the sink row included, with no fill ahead of the kernel. An empty leg
//   launches too and writes the zero image.
//
// Measured on the H100 (PERF.md, scripts/reduce_probe.py): at a 32-shard
// leg the kernel takes about 12 us, of which the launch and its two
// cluster barriers alone take 7 (a plain launch 5) and the zeroing,
// copies and stores 2.3 more. A first form that ORed each warp's bits
// together by shuffles before its atomics took 16 us. Clusters of 8 CTAs
// lost (the leg 1.1x, a full shard 1.6x slower), and so did CTAs of 512
// threads (21 clusters fit at once, fewer than a 32-shard leg's 33 rows);
// 2 ring stages are as fast as 4 and fit 42 clusters at once, not 35.
//
// The general form zeroes the image on the stream first (cudaMemsetAsync, a
// second pass over it), then each position is one global atomicOr. or_fold
// reads every input word once and writes every output word once with
// 16-byte loads and stores, one thread per 4 words of an output row, the K
// loads of a thread issued back to back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// The grouped form: CTAs a cluster (16, past the portable 8, which Hopper
// allows with cudaFuncAttributeNonPortableClusterSizeAllowed), threads a
// CTA, the ring's stages and positions a stage (8 KiB), and the loads of 32
// positions a warp issues before it works on any.
constexpr int kCluster = 16;
constexpr int kGroupedThreads = 256;
constexpr int kStages = 2;
constexpr int kStageInts = 2048;
constexpr int kBatch = 8;
// Dynamic shared memory a block may take on the H100, less room for the
// ring's static barriers.
constexpr int kMaxDynSmemBytes = 232448 - 1024;

// Bits b of word w of the row: an atomicOr into the slab of the CTA that
// owns w, this one's or another's of the cluster.
__device__ __forceinline__ void put(cg::cluster_group& cluster, uint32_t* slab, unsigned rank,
                                    int slab_shift, int w, uint32_t b) {
  const unsigned owner = static_cast<unsigned>(w) >> slab_shift;
  const int at = w & ((1 << slab_shift) - 1);
  if (owner == rank)
    atomicOr(slab + at, b);
  else
    atomicOr(cluster.map_shared_rank(slab, owner) + at, b);
}

// Bit p & 31 of word p >> 5 of the row, where 0 <= p < 32 W: an atomicOr
// into the slab of the CTA that owns the word, this one's or another's of
// the cluster.
__device__ __forceinline__ void set_bit(cg::cluster_group& cluster, uint32_t* slab,
                                        unsigned rank, int slab_shift, int64_t bits, int32_t p) {
  if (p < 0 || p >= bits) return;
  put(cluster, slab, rank, slab_shift, p >> 5, 1u << (p & 31));
}

// A warp's kBatch x 32 positions, p[u] in lane order (-1 where a lane has
// none). A batch that is one run of consecutive positions (a dense row's
// sorted run) fills whole words: kBatch + 1 lanes OR them in, an atomic a
// word. Any other batch takes an atomic a position: a sparse row's sorted
// positions mostly fall in distinct words, so the lanes seldom meet on one.
__device__ __forceinline__ void scatter_warp(cg::cluster_group& cluster, uint32_t* slab,
                                             unsigned rank, int slab_shift, int64_t bits,
                                             const int32_t (&p)[kBatch]) {
  const unsigned lane = threadIdx.x & 31;
  const uint32_t p0 = static_cast<uint32_t>(__shfl_sync(0xffffffffu, p[0], 0));
  bool run = true;
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    run = run && p[u] >= 0 && p[u] < bits && static_cast<uint32_t>(p[u]) == p0 + 32 * u + lane;
  if (__all_sync(0xffffffffu, run)) {
    // Bits [p0, p0 + 32 kBatch): words w0 + 1 .. w0 + kBatch - 1 whole, the
    // top of word w0 and the bottom of word w0 + kBatch.
    const unsigned s = p0 & 31;
    const uint32_t m = lane == 0 ? ~0u << s : lane < kBatch ? ~0u : s ? ~0u >> (32 - s) : 0u;
    if (lane <= kBatch && m) put(cluster, slab, rank, slab_shift, (p0 >> 5) + lane, m);
    return;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) set_bit(cluster, slab, rank, slab_shift, bits, p[u]);
}

__global__ void __launch_bounds__(kGroupedThreads)
    scatter_bits_grouped_kernel(const int32_t* __restrict__ starts,
                                const int32_t* __restrict__ local, int64_t n,
                                int slab_shift, int64_t words, uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint4 smem4[];
  __shared__ uint64_t full[kStages];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t row = blockIdx.x / kCluster;
  const int slab_words = 1 << slab_shift;
  uint32_t* slab = reinterpret_cast<uint32_t*>(smem4);
  int32_t* ring = reinterpret_cast<int32_t*>(smem4 + slab_words / 4);
  const int64_t bits = words * 32;

  // The row's positions, clamped to the buffer; this CTA's chunk [lo, hi),
  // its 16-byte-aligned body [a, b) (local is 16-byte aligned).
  int64_t s0 = starts[row], s1 = starts[row + 1];
  s0 = s0 < 0 ? 0 : (s0 > n ? n : s0);
  s1 = s1 < s0 ? s0 : (s1 > n ? n : s1);
  const int64_t lo = s0 + (s1 - s0) * rank / kCluster;
  const int64_t hi = s0 + (s1 - s0) * (rank + 1) / kCluster;
  const int64_t up = (lo + 3) & ~int64_t{3}, down = hi & ~int64_t{3};
  const int64_t a = up < hi ? up : hi;
  const int64_t b = down > a ? down : a;
  const int tiles = static_cast<int>((b - a + kStageInts - 1) / kStageInts);

  auto issue = [&](int t) {  // tile t of the body into its stage
    const int64_t off = a + static_cast<int64_t>(t) * kStageInts;
    const uint32_t cnt = static_cast<uint32_t>(b - off < kStageInts ? b - off : kStageInts);
    uint64_t* bar = &full[t % kStages];
    mbar_expect_tx(bar, cnt * 4u);
    bulk_load(ring + (t % kStages) * kStageInts, local + off, cnt * 4u, bar);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < kStages && t < tiles; ++t) issue(t);
  }
  for (int k = threadIdx.x; k < slab_words / 4; k += kGroupedThreads)
    smem4[k] = make_uint4(0u, 0u, 0u, 0u);
  cluster.sync();  // every slab of the cluster zeroed, the barriers seen

  const unsigned lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {  // the chunk's head [lo, a) and tail [b, hi)
    const int64_t i = lane < 3 ? lo + lane : b + lane - 3;
    const bool valid = lane < 3 ? i < a : (lane < 6 && i < hi);
    if (valid) set_bit(cluster, slab, rank, slab_shift, bits, local[i]);
  }
  for (int t = 0; t < tiles; ++t) {
    const int32_t* stage = ring + (t % kStages) * kStageInts;
    const int64_t off = a + static_cast<int64_t>(t) * kStageInts;
    const int cnt = static_cast<int>(b - off < kStageInts ? b - off : kStageInts);
    mbar_wait(&full[t % kStages], static_cast<uint32_t>((t / kStages) & 1));
    for (int base = (threadIdx.x >> 5) * (32 * kBatch); base < cnt;
         base += kGroupedThreads * kBatch) {
      int32_t p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + 32 * u + static_cast<int>(lane);
        p[u] = i < cnt ? stage[i] : -1;
      }
      scatter_warp(cluster, slab, rank, slab_shift, bits, p);
    }
    __syncthreads();  // the stage read by every warp
    if (threadIdx.x == 0 && t + kStages < tiles) issue(t + kStages);
  }
  cluster.sync();  // every bit of the cluster's slabs landed

  // Every word of this CTA's slab, stored once.
  uint4* dst = reinterpret_cast<uint4*>(out + row * words) + rank * (slab_words / 4);
  for (int k = threadIdx.x; k < slab_words / 4; k += kGroupedThreads) dst[k] = smem4[k];
}

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

// out: an uninitialised [n_segs + 1, words] uint32 image on the card, 16-byte
// aligned; starts: [n_segs + 2] int32, non-decreasing, the last n; local:
// [n] int32, contiguous and 16-byte aligned, on the same card. words must be
// a power of two, at least 4 x kCluster, and a slab and the ring must fit in
// shared memory (up to 2^19 words).
extern "C" int pilosa_scatter_bits_grouped(const void* starts, const void* local, int64_t n,
                                           int64_t n_segs, int64_t words, void* out,
                                           void* stream) {
  if (n < 0 || n_segs < 0 || words < 4 * kCluster || (words & (words - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t slab_words = words / kCluster;
  const int64_t smem = slab_words * 4 + static_cast<int64_t>(kStages) * kStageInts * 4;
  const int64_t blocks = (n_segs + 1) * kCluster;
  if (smem > kMaxDynSmemBytes || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  // Once a device (a benign race: every caller sets the same): the
  // kernel's attributes.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(scatter_bits_grouped_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scatter_bits_grouped_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) ready[dev] = true;
  }

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.x = kCluster;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kGroupedThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, scatter_bits_grouped_kernel, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(local), n, __builtin_ctzll(static_cast<unsigned long long>(
          slab_words)), words, static_cast<uint32_t*>(out));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

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
