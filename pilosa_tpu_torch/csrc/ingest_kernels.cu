// Ingest kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// One entry point with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates the output (uninitialised:
// the kernel writes every word of it), checks shapes, and passes PyTorch's
// current stream:
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
// word, the bit, the sign and the magnitude are worked out here, once an
// entry and plane group. The magnitude is the unsigned 64-bit negation of
// a negative value, so INT64_MIN gives 2^63 (as numpy's
// abs(...).astype(uint64) does) and magnitude bits 32-62 need no second
// half. Words are 32-bit bit patterns (int32 tensors on the torch side),
// written as uint32, so bit 31 of a word is a bit like any other.
//
// Bound on the H100: memory bandwidth. The entries are read (12 bytes
// each) and the image, (2 + depth) x W words, is written once: at bench
// config 3's shard, about 21,000 values at depth 17, 0.25 MB in and 2.5 MB
// out, under a microsecond at 3.35 TB/s -- far under the few microseconds
// any launch takes. So the design spends no second pass over the image
// and no global atomics:
//
// - A thread-block cluster of kCluster CTAs builds the image of a group of
//   planes in distributed shared memory: CTA r holds words [r S, (r + 1) S)
//   of each plane of the group (its slab, S = W / 16: 8 KiB a plane at
//   W = 32,768), zeroed on chip. One cluster a plane group (and a word
//   tile, where a slab would not fit in shared memory: only past
//   2^24-column shards) covers the image. The planes split in as many
//   groups as clusters run at once (7 on an H100: depth 17's 19 planes in
//   groups of 3), so the image is built in one wave on 112 SMs.
// - The cluster's CTAs split the M entries in contiguous chunks; sorted
//   entries then mostly land in the CTA's own slab. A warp loads kBatch x
//   32 entries before it works on any, and works out each one's word,
//   bit, sign and magnitude once a plane group. Each set plane bit is a
//   shared-memory atomicOr into the owning CTA's slab (another CTA's
//   through cluster.map_shared_rank). A batch that is one dense run of
//   consecutive positions in lane order (a full shard's sorted entries)
//   instead takes each plane's 32 bits an item by one ballot and ORs each
//   word once, with no two lanes on one address.
// - After a cluster barrier each CTA stores its slabs to the image with
//   16-byte stores, so every word of the image is written exactly once,
//   the zero words included, with no fill ahead of the kernel. An empty
//   batch launches too and writes the zero image.
//
// More groups spread the entries' scatter and the image's stores over
// more SMs; each group reads the entries once more. One wave of clusters
// was the fastest split at bench config 3's shard, a full shard and depth
// 40, and 16 CTAs a cluster rather than 8 halve the entries each SM takes
// (a full shard 1.6x faster, the bench shard the same; PERF.md,
// scripts/plane_scatter_probe.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// CTAs of a cluster: 16, past the portable 8, which Hopper allows with
// cudaFuncAttributeNonPortableClusterSizeAllowed.
constexpr int kCluster = 16;
constexpr int kThreads = 1024;
// Loads of 32 entries a warp issues before it works on any of them.
constexpr int kBatch = 4;
// The deepest magnitude a BSI field holds (pilosa_tpu_torch/ops/kernels.py
// MAX_DEPTH).
constexpr int kMaxDepth = 63;
// A group's plane mask is one 32-bit word.
constexpr int kMaxGroupPlanes = 32;
// A CTA's slab of one plane: at most 32,768 words (128 KiB); and the
// dynamic shared memory a block may take on the H100.
constexpr int64_t kMaxSlabWords = 32768;
constexpr int kMaxSmemBytes = 232448;

// Bit j of the result: the entry belongs to plane first + j (j < 32).
__device__ __forceinline__ uint32_t group_mask(uint64_t mag, bool neg, int first) {
  const uint64_t n = neg ? 1ull : 0ull;
  const uint64_t all = first >= 2  ? mag >> (first - 2)
                       : first == 1 ? (mag << 1) | n
                                    : (mag << 2) | (n << 1) | 1ull;
  return static_cast<uint32_t>(all);
}

__global__ void __launch_bounds__(kThreads, 1)
    plane_scatter_kernel(const int32_t* __restrict__ pos, const int64_t* __restrict__ vals,
                         int64_t m, int planes, int group_planes, int tiles, int slab_shift,
                         int64_t words, uint32_t* __restrict__ out) {
  extern __shared__ uint4 slab4[];
  uint32_t* slab = reinterpret_cast<uint32_t*>(slab4);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int cl = blockIdx.x / kCluster;
  const int first = (cl / tiles) * group_planes;  // the group's first plane
  const int np = min(group_planes, planes - first);
  const uint32_t plane_bits = np == 32 ? ~0u : (1u << np) - 1u;
  // Word indices below are tile-relative; a tile is at most kCluster x
  // kMaxSlabWords words.
  const int slab_words = 1 << slab_shift;
  const int tile_words = slab_words * kCluster;
  const int tile_base = (cl % tiles) * tile_words;
  const int vec = slab_words / 4;

  for (int k = threadIdx.x; k < np * vec; k += blockDim.x)
    slab4[k] = make_uint4(0u, 0u, 0u, 0u);
  cluster.sync();

  // Set bits of the group's plane j in word w of the tile's slabs.
  auto put = [&](int w, int j, uint32_t bits) {
    const unsigned owner = static_cast<unsigned>(w) >> slab_shift;
    const int at = (j << slab_shift) + (w & (slab_words - 1));
    if (owner == rank)
      atomicOr(slab + at, bits);
    else
      atomicOr(cluster.map_shared_rank(slab, owner) + at, bits);
  };

  // The CTA's contiguous chunk of the entries. A warp loads kBatch x 32 of
  // them at a time, every lane (so the trip count is warp-uniform and
  // every lane stays in the collectives), and works out each one's word
  // and plane mask once. A batch that is one dense run (32 kBatch
  // consecutive positions in lane order, as a full shard's sorted entries
  // are) takes each plane's 32 bits of an item by one ballot, carries the
  // bits that spill into the next word, and ORs each word of each plane
  // once; any other batch ORs each lane's bits, an atomic a set plane.
  const unsigned lane = threadIdx.x & 31;
  const int64_t lo = m * rank / kCluster, hi = m * (rank + 1) / kCluster;
  const int64_t step = static_cast<int64_t>(blockDim.x) * kBatch;
  for (int64_t base = lo + (threadIdx.x >> 5) * (32 * kBatch); base < hi; base += step) {
    int32_t p[kBatch];
    int64_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t i = base + 32 * u + lane;
      p[u] = i < hi ? pos[i] : -1;
      v[u] = i < hi ? vals[i] : 0;
    }
    const uint32_t p0 = static_cast<uint32_t>(__shfl_sync(0xffffffffu, p[0], 0));
    uint32_t gm[kBatch];
    bool run = true;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int w = (p[u] >> 5) - tile_base;
      const bool keep = p[u] >= 0 && w >= 0 && w < tile_words;
      const uint64_t mag =
          v[u] < 0 ? 0ull - static_cast<uint64_t>(v[u]) : static_cast<uint64_t>(v[u]);
      gm[u] = keep ? group_mask(mag, v[u] < 0, first) & plane_bits : 0u;
      run = run && keep && static_cast<uint32_t>(p[u]) == p0 + 32 * u + lane;
    }
    if (__all_sync(0xffffffffu, run)) {
      const int w0 = static_cast<int>(p0 >> 5) - tile_base;
      const unsigned s = p0 & 31u;
      uint32_t carry = 0;  // lane j: plane j's bits past the last word
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        uint32_t mine = 0;  // lane j: plane j's 32 bits of item u
        for (int j = 0; j < np; ++j) {
          const uint32_t b = __ballot_sync(0xffffffffu, (gm[u] >> j) & 1u);
          if (static_cast<int>(lane) == j) mine = b;
        }
        if (static_cast<int>(lane) < np && ((mine << s) | carry))
          put(w0 + u, lane, (mine << s) | carry);
        carry = s ? mine >> (32 - s) : 0u;
      }
      if (static_cast<int>(lane) < np && carry) put(w0 + kBatch, lane, carry);
      continue;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int w = (p[u] >> 5) - tile_base;
      const uint32_t bit = 1u << (p[u] & 31);
      for (uint32_t g = gm[u]; g; g &= g - 1) put(w, __ffs(g) - 1, bit);
    }
  }
  cluster.sync();

  // Every word of the group's rows in this CTA's slab, stored once.
  uint4* dst = reinterpret_cast<uint4*>(out + first * words + tile_base) + rank * vec;
  for (int j = 0; j < np; ++j)
    for (int k = threadIdx.x; k < vec; k += blockDim.x)
      dst[j * (words / 4) + k] = slab4[j * vec + k];
}

struct Plan {
  int planes, per, groups, tiles, slab_shift;
  int64_t slab_words;
};

// The launch of one image: shared-memory slabs, word tiles and plane
// groups, with the cluster dimension attached to cfg. Returns a CUDA error.
int plan_launch(int depth, int64_t words, cudaLaunchConfig_t* cfg,
                cudaLaunchAttribute* cluster_dim, Plan* plan) {
  if (depth < 0 || depth > kMaxDepth || words < 4 * kCluster || (words & (words - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan& pl = *plan;
  pl.planes = depth + 2;
  const int64_t per_cta = words / kCluster;
  pl.slab_words = per_cta < kMaxSlabWords ? per_cta : kMaxSlabWords;
  pl.slab_shift = __builtin_ctzll(static_cast<unsigned long long>(pl.slab_words));
  pl.tiles = static_cast<int>(per_cta / pl.slab_words);
  int fit = static_cast<int>(kMaxSmemBytes / (pl.slab_words * 4));
  fit = fit < kMaxGroupPlanes ? fit : kMaxGroupPlanes;

  cfg->blockDim = dim3(kThreads);
  cluster_dim->id = cudaLaunchAttributeClusterDimension;
  cluster_dim->val.clusterDim.x = kCluster;
  cluster_dim->val.clusterDim.y = 1;
  cluster_dim->val.clusterDim.z = 1;
  cfg->attrs = cluster_dim;
  cfg->numAttrs = 1;

  // Once a device (a benign race: every caller computes the same): the
  // kernel's attributes, and how many of its clusters run at once.
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = dev < 64 ? resident[dev] : 0;
  if (clusters == 0) {
    err = cudaFuncSetAttribute(plane_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(plane_scatter_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg->gridDim = dim3(kCluster);
    cfg->dynamicSmemBytes = kMaxSmemBytes;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, plane_scatter_kernel, cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < 64) resident[dev] = clusters;
  }

  // The planes split in as many groups as clusters run at once (one wave),
  // as evenly as they go; never more planes a group than shared memory
  // holds.
  int groups = clusters / pl.tiles;
  groups = groups < pl.planes ? groups : pl.planes;
  groups = groups > (pl.planes + fit - 1) / fit ? groups : (pl.planes + fit - 1) / fit;
  pl.per = (pl.planes + groups - 1) / groups;
  pl.groups = (pl.planes + pl.per - 1) / pl.per;
  const int64_t blocks = static_cast<int64_t>(pl.groups) * pl.tiles * kCluster;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cfg->gridDim = dim3(static_cast<unsigned>(blocks));
  cfg->dynamicSmemBytes = static_cast<size_t>(pl.per) * pl.slab_words * 4;
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// out: an uninitialised [2 + depth, words] uint32 image on the card, 16-byte
// aligned; pos [m] int32, vals [m] int64, both contiguous on the same card.
// words must be a power of two, at least 4 x kCluster (a shard's words are).
extern "C" int pilosa_plane_scatter(const void* pos, const void* vals, int64_t m,
                                    int depth, int64_t words, void* out, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster_dim[1];
  Plan pl;
  const int err = plan_launch(depth, words, &cfg, cluster_dim, &pl);
  if (err) return err;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, plane_scatter_kernel, static_cast<const int32_t*>(pos),
      static_cast<const int64_t*>(vals), m, pl.planes, pl.per, pl.tiles, pl.slab_shift,
      words, static_cast<uint32_t*>(out));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// The plane groups pilosa_plane_scatter launches at this depth and width
// on the current device: *groups clusters of *per planes (the last group
// may hold fewer). Returns a CUDA error.
extern "C" int pilosa_plane_scatter_groups(int depth, int64_t words, int* groups, int* per) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster_dim[1];
  Plan pl;
  const int err = plan_launch(depth, words, &cfg, cluster_dim, &pl);
  if (err) return err;
  *groups = pl.groups;
  *per = pl.per;
  return 0;
}
