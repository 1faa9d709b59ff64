// GroupBy lattice kernel of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// One entry point with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py (group_count), which allocates every
// output, checks shapes, strides and alignment, and passes PyTorch's
// current stream:
//
//   pilosa_group_count  for each group g of a GroupBy lattice,
//     sum over shard rows s of popcount(AND over levels l of
//     plane[table[g][l]][s] AND filt[s]), as int64
//     Replaces the planner's lattice, pilosa_tpu/parallel/planner.py:919-978
//     execute_group_by, which the JAX package runs as one XLA-fused chained
//     AND plus one count program per group (no pallas_call), and whose
//     per-shard int32 counts the host widens and sums.
//
// Words are 32-bit bit patterns (int32 tensors on the torch side). A shard
// row holds at most 2^30 bits, so a per-row count fits int32; the totals
// across rows are int64, as the JAX planner widens before its sum
// (planner.py:325-328).
//
// Bound on the H100: the bytes of the distinct planes, read once. At bench
// config 5's shape (levels of 4 and 8 rows and a filter, 954 shards) that is
// 13 planes x 954 x 128 KiB = 1.64 GB, about 0.49 ms at 3.35 TB/s; the JAX
// program reads each group's planes per group (32 x 3 planes). At many
// groups (thousands, over few shards) the ANDs and popcounts govern.
//
// What the design does about that bound:
//  * The host passes the distinct planes once (a pointer and a row stride
//    each) and a [G, L] table of plane indices, so a plane that many groups
//    share is one operand.
//  * A block owns one word tile of the rows it walks (blockIdx.x the tile,
//    blockIdx.y the first row, gridDim.y the row step). For each row it
//    copies that tile of every distinct plane, and of the filter, into
//    shared memory once (16-byte loads when every row is aligned), then
//    evaluates every group from shared memory: device memory sees each
//    plane word once.
//  * Warp w owns groups w, w + 8, ...: its 32 lanes sweep the tile for a
//    group, one warp-wide __reduce_add_sync gives the tile's count, and
//    lane 0 adds it to the block's int64 accumulator for that group in
//    shared memory (no contention: one warp per group). At the end each
//    block adds its nonzero accumulators into the output with one 64-bit
//    atomicAdd each.
//  * The kernel is specialised on the filter and on 1-4 levels: a group's
//    plane bases sit in registers, its ANDs unrolled, and an aligned
//    lattice reads its staged words 16 bytes a lane. More levels (up to
//    kMaxLevels) take a predicated loop.
//  * The tile shrinks (1024 down to 128 words) so the staged planes and the
//    accumulators fit the shared-memory budget; a lattice with too many
//    distinct planes for even the smallest tile reads its planes straight
//    from device memory (through L1/L2) with the same loop.
//
// Not done here (later work): reuse of the AND of a group prefix across the
// groups that share it, bulk copies into a ring of stages, and a
// persistent grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 16;
// Dynamic shared memory a block may ask for, and the share aimed at so
// that two blocks fit on an SM.
constexpr int kSmemMax = 200 * 1024;
constexpr int kSmemTarget = 96 * 1024;
constexpr int kMaxGridY = 65535;
// Blocks aimed at: 8 per SM of the H100's 132.
constexpr int kTargetBlocks = 132 * 8;

struct Args {
  const uint32_t* const* planes;  // [n_planes] row bases
  const int64_t* strides;         // [n_planes] words between rows
  const int64_t* table;           // [groups, levels] plane indices
  const uint32_t* filt;           // [rows] x filt_stride, or null
  int64_t filt_stride;
  int n_planes;
  int groups;
  int levels;
  unsigned long long* out;        // [groups], zeroed by the caller
  int64_t rows;
  int64_t words;
  int tile;                       // words per tile (a multiple of 128)
  int vec;                        // 16-byte staging
};

__device__ __forceinline__ unsigned long long* accumulators(unsigned char* smem) {
  return reinterpret_cast<unsigned long long*>(smem);
}

// The popcount of one group's AND (its plane at every level, and the
// filter with FILT) over one tile of row s, summed over the warp. LEVELS
// > 0: that many levels, unrolled; 0: a.levels of them (up to
// kMaxLevels), predicated. Staged tiles of an aligned lattice are read 16
// bytes a lane.
template <bool STAGED, int LEVELS, bool FILT>
__device__ __forceinline__ unsigned int group_tile(const Args& a, const uint32_t* stage,
                                                   const int64_t* row, int64_t s,
                                                   int64_t w0, int tw, int lane) {
  constexpr int N = LEVELS > 0 ? LEVELS : kMaxLevels;
  const int levels = LEVELS > 0 ? LEVELS : a.levels;
  const uint32_t* base[N];
#pragma unroll
  for (int l = 0; l < N; ++l) {
    if (l < levels) {
      const int p = (int)row[l];
      base[l] = STAGED ? stage + (size_t)p * a.tile : a.planes[p] + s * a.strides[p] + w0;
    }
  }
  const uint32_t* fbase = nullptr;
  if (FILT) {
    fbase = STAGED ? stage + (size_t)a.n_planes * a.tile : a.filt + s * a.filt_stride + w0;
  }
  unsigned int part = 0;
  if (STAGED && a.vec) {
    const int n4 = tw / 4;  // tw is a multiple of 4 when the lattice is aligned
    for (int i = lane; i < n4; i += 32) {
      uint4 v = FILT ? reinterpret_cast<const uint4*>(fbase)[i]
                     : make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
#pragma unroll
      for (int l = 0; l < N; ++l) {
        if (l < levels) {
          const uint4 x = reinterpret_cast<const uint4*>(base[l])[i];
          v.x &= x.x;
          v.y &= x.y;
          v.z &= x.z;
          v.w &= x.w;
        }
      }
      part += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
  } else {
    for (int i = lane; i < tw; i += 32) {
      uint32_t v = FILT ? (STAGED ? fbase[i] : __ldg(fbase + i)) : 0xffffffffu;
#pragma unroll
      for (int l = 0; l < N; ++l) {
        if (l < levels) v &= STAGED ? base[l][i] : __ldg(base[l] + i);
      }
      part += __popc(v);
    }
  }
  return __reduce_add_sync(0xffffffffu, part);
}

template <bool STAGED, int LEVELS, bool FILT>
__global__ void __launch_bounds__(kThreads)
group_count_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* acc = accumulators(smem);
  // The staged tiles start after the accumulators, on a 16-byte boundary.
  const size_t acc_bytes = ((size_t)a.groups * 8 + 15) & ~(size_t)15;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + acc_bytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t w0 = (int64_t)blockIdx.x * a.tile;
  const int tw = (int)min((int64_t)a.tile, a.words - w0);
  const int n_staged = a.n_planes + (FILT ? 1 : 0);

  for (int g = threadIdx.x; g < a.groups; g += kThreads) acc[g] = 0;
  // Group g is zeroed by thread g % kThreads but counted by warp g %
  // kWarps: every zero lands before the first add, staged or not.
  __syncthreads();

  for (int64_t s = blockIdx.y; s < a.rows; s += gridDim.y) {
    if (STAGED) {
      __syncthreads();  // the previous row's reads of the stage are done
      for (int p = 0; p < n_staged; ++p) {
        const uint32_t* src = p < a.n_planes ? a.planes[p] + s * a.strides[p]
                                             : a.filt + s * a.filt_stride;
        src += w0;
        uint32_t* dst = stage + (size_t)p * a.tile;
        if (a.vec) {
          const int n4 = tw / 4;
          const uint4* s4 = reinterpret_cast<const uint4*>(src);
          uint4* d4 = reinterpret_cast<uint4*>(dst);
          for (int i = threadIdx.x; i < n4; i += kThreads) d4[i] = __ldg(s4 + i);
          for (int i = n4 * 4 + threadIdx.x; i < tw; i += kThreads) dst[i] = __ldg(src + i);
        } else {
          for (int i = threadIdx.x; i < tw; i += kThreads) dst[i] = __ldg(src + i);
        }
      }
      __syncthreads();
    }
    for (int g = warp; g < a.groups; g += kWarps) {
      const unsigned int part = group_tile<STAGED, LEVELS, FILT>(
          a, stage, a.table + (int64_t)g * a.levels, s, w0, tw, lane);
      if (lane == 0) acc[g] += part;
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < a.groups; g += kThreads) {
    if (acc[g]) atomicAdd(a.out + g, acc[g]);
  }
}

template <bool STAGED, int LEVELS, bool FILT>
int launch(Args a, size_t smem, cudaStream_t s) {
  auto kernel = group_count_kernel<STAGED, LEVELS, FILT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t tiles = (a.words + a.tile - 1) / a.tile;
  int64_t gy = (kTargetBlocks + tiles - 1) / tiles;
  if (gy > a.rows) gy = a.rows;
  if (gy > kMaxGridY) gy = kMaxGridY;
  if (gy < 1) gy = 1;
  dim3 grid((unsigned)tiles, (unsigned)gy);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel specialised on its level count (1-4 unrolled, more at run
// time) and on the filter.
template <bool STAGED>
int launch_levels(Args a, size_t smem, cudaStream_t s) {
  const bool f = a.filt != nullptr;
  switch (a.levels) {
    case 1: return f ? launch<STAGED, 1, true>(a, smem, s) : launch<STAGED, 1, false>(a, smem, s);
    case 2: return f ? launch<STAGED, 2, true>(a, smem, s) : launch<STAGED, 2, false>(a, smem, s);
    case 3: return f ? launch<STAGED, 3, true>(a, smem, s) : launch<STAGED, 3, false>(a, smem, s);
    case 4: return f ? launch<STAGED, 4, true>(a, smem, s) : launch<STAGED, 4, false>(a, smem, s);
    default: return f ? launch<STAGED, 0, true>(a, smem, s) : launch<STAGED, 0, false>(a, smem, s);
  }
}

}  // namespace

// host_table: int64 [n_planes row bases, n_planes row strides (words),
// groups * levels plane indices], copied to dev_table (same length) on the
// stream before the launch. filt: [rows] rows of filt_stride words, or
// null for no filter. out: groups uint64 zeros. vec: every plane row and
// the filter's are 16-byte aligned and words is a multiple of 4.
// Returns the first CUDA error of the copy or the launch.
extern "C" int pilosa_group_count(const int64_t* host_table, void* dev_table,
                                  int n_planes, int groups, int levels,
                                  const void* filt, int64_t filt_stride, void* out,
                                  int64_t rows, int64_t words, int vec,
                                  void* stream) {
  if (n_planes <= 0 || groups <= 0 || levels <= 0 || levels > kMaxLevels ||
      rows <= 0 || words <= 0 || words > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_table = 2 * (int64_t)n_planes + (int64_t)groups * levels;
  for (int64_t i = 2 * (int64_t)n_planes; i < n_table; ++i) {
    if (host_table[i] < 0 || host_table[i] >= n_planes)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  // A pageable source: the copy returns once the table is staged, so the
  // caller may free it; the kernel after it on `s` sees the whole table.
  cudaError_t err = cudaMemcpyAsync(dev_table, host_table, n_table * sizeof(int64_t),
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* dev = static_cast<const int64_t*>(dev_table);
  Args a;
  a.planes = reinterpret_cast<const uint32_t* const*>(dev);
  a.strides = dev + n_planes;
  a.table = dev + 2 * n_planes;
  a.filt = static_cast<const uint32_t*>(filt);
  a.filt_stride = filt_stride;
  a.n_planes = n_planes;
  a.groups = groups;
  a.levels = levels;
  a.out = static_cast<unsigned long long*>(out);
  a.rows = rows;
  a.words = words;
  a.vec = vec;
  const size_t acc_bytes = ((size_t)groups * 8 + 15) & ~(size_t)15;
  const size_t staged = (size_t)n_planes + (filt ? 1 : 0);
  // The largest tile within the target, else within the maximum; none fits:
  // read the planes from device memory.
  const size_t budgets[2] = {(size_t)kSmemTarget, (size_t)kSmemMax};
  for (size_t budget : budgets) {
    for (int tile = 1024; tile >= 128; tile /= 2) {
      const size_t smem = acc_bytes + staged * tile * 4;
      if (smem <= budget) {
        a.tile = tile;
        return launch_levels<true>(a, smem, s);
      }
    }
  }
  a.tile = 1024;
  return launch_levels<false>(a, acc_bytes, s);
}
