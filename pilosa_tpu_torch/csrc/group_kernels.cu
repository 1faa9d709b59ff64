// GroupBy lattice kernel of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// One entry point with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py (group_count), which allocates every
// output, checks shapes, strides and alignment, and passes PyTorch's
// current stream:
//
//   pilosa_group_count  for each group of a GroupBy lattice -- the
//     lexicographic product of L levels, level l holding sizes[l]
//     consecutive planes -- the sum over shard rows s of popcount(AND over
//     levels of the group's plane at each level, AND filt), as int64 in
//     lexicographic group order
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
// What bounds it on the H100 (chip_smoke.py's bound: bytes over 3.35 TB/s;
// 32-bit logic ops and adds over 64, population counts over 16, per clock
// per SM, x 132 SMs x the maximum SM clock, from the CUDA C++ Programming
// Guide's throughput table for compute capability 9.0):
//  * (4, 8) + filter, bench config 5 at 954 shards: the 13 planes' 1.63 GB,
//    about 0.49 ms; its 32 groups' counts are a third of that.
//  * (4, 8, 3), 96 groups: one popcount per group and word would be 3.0e9
//    popcounts, 0.72 ms, past the 15 planes' 0.56 ms of bytes. Counted as
//    below (two popcounts and four logic ops per group and three words,
//    with the tree's ANDs) each unit needs about 0.48 ms: the bytes bound.
//    On the card the kernel's time tracks the popcounts' and the logic
//    ops' times added, not the larger of the two (PERF.md §6).
//  * Thousands of groups over few shard rows ((32, 256) over 4 rows): the
//    popcounts, by far.
// So the kernel streams each plane from HBM once, hides that stream under
// the evaluation, and spends as little as it can besides the counting.
// What the design does about it:
//  * The lattice is a product, passed as its level sizes, and the kernel
//    walks it as a prefix tree, as the reference's rec does
//    (pilosa_tpu/parallel/planner.py:958-971): the AND of a prefix is made
//    once and carried to the next level, the filter folded into the first.
//    Three levels are the tree's register levels (O, A and K: the last
//    three levels of more than one row); the others are fixed per unit.
//  * A unit is a box of the lattice: one row of every fixed level, and a
//    window of at most OM x kAM x KM rows of O, A and K (KM a template
//    parameter, 1-8; OM as many as kAccBudget counters allow). A thread
//    holds a counter per group of its unit in registers for the whole
//    kernel; (4, 8) + filter and (4, 8, 3) are one unit each. For every
//    word it reads each of the unit's planes once from shared memory (15
//    reads at (4, 8, 3), not 96 x 3), keeps the A and K words in
//    registers, and makes one AND per tree node (4 + 32 + 96 at (4, 8, 3)).
//  * Counting: a thread takes kWordsPerThread = 3 words of each tile and
//    sums a group's three words with a full adder (two 3-input logic ops)
//    into a ones and a twos word, so a group costs two popcounts for three
//    words instead of three. Against one popcount per word this measured
//    8% faster at (4, 8, 3) and 6% at (32, 256) on an H100 (PERF.md §6).
//  * A block owns one unit and a run of (row, tile) items of kTile words.
//    One producer thread copies each item's tile of every plane of the unit
//    (and the filter) with 1-D cp.async.bulk into a ring of kStages stages,
//    each guarded by a "full" and an "empty" mbarrier (bulk_ring.cuh, as in
//    tree_kernels.cu); eight consumer warps evaluate stage k while the next
//    stages load, so HBM streams under the evaluation inside every block.
//    Planes whose rows are contiguous are walked as one long row.
//  * Counters are reduced once, at the end: a warp-wide __reduce_add_sync
//    per group, a 64-bit shared atomicAdd per warp, one global atomicAdd
//    per group per block. The blocks of one item run are the units side by
//    side, so a plane several units share comes from L2.
//  * A unit holds at most kMaxUnitPlanes planes (the host narrows its
//    windows to fit), so every lattice is staged. Planes that are not
//    16-byte aligned, or a width that is not a multiple of 4 words, take
//    the same walk over plain 4-byte loads from device memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_ring.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // the consumers and one producer warp
// Words of each tile a consumer thread evaluates: one full adder's inputs.
constexpr int kWordsPerThread = 3;
// Words of each plane per ring stage: a thread's words lie kConsumers apart,
// so a warp reads 128 contiguous bytes of a plane.
constexpr int kTile = kConsumers * kWordsPerThread;
constexpr int kStages = 3;
constexpr int kRingBytes = 192 * 1024;
// The most planes a unit stages (the filter and fixed levels included).
constexpr int kMaxUnitPlanes = kRingBytes / (kStages * kTile * 4);
static_assert(kMaxUnitPlanes >= 1 + kMaxLevels, "a unit of one row a level must fit the ring");
// Counters a thread holds, the widest A window and the widest K window.
constexpr int kAccBudget = 96;
constexpr int kAM = 8;
constexpr int kMaxKM = 8;
static_assert(kAccBudget >= kAM * kMaxKM, "one O row of the widest A and K windows");
// Items one block walks at most: keeps a lane's and a warp's 32-bit counts
// far from overflow (3 words x 32 bits x 2^16 items x 32 lanes < 2^32).
constexpr int64_t kMaxItemsPerBlock = 1 << 16;

// O rows of a unit whose K window is km rows wide: as many as the counters
// allow.
__host__ __device__ constexpr int om_for(int km) { return kAccBudget / (kAM * km); }

// The launch's plan, built on the host (pilosa_group_count). Roles: 0 = O, 1 = A,
// 2 = K; a virtual role (fewer than three levels of more than one row) has
// one row, no plane and output stride 0.
struct Plan {
  const int64_t* table;  // device: [n_planes] row bases, then [n_planes] strides
  int64_t n_planes;
  const uint32_t* filt;  // [rows] x filt_stride, or null
  int64_t filt_stride;
  unsigned long long* out;  // [groups], zeroed by the caller
  int64_t rows, words;      // after contiguous planes are joined into one row
  int64_t tiles_per_row, items, slices;
  int64_t units;
  int n_fixed;
  int64_t fixed_first[kMaxLevels];  // first plane of the level
  int64_t fixed_n[kMaxLevels];
  int64_t fixed_st[kMaxLevels];  // the level's stride in the group index
  int real[3];
  int64_t first[3], n[3], w[3], wins[3], st[3];
};

// The unit's planes in shared memory, in stage order: filter, fixed levels,
// then the O, A and K windows.
struct Unit {
  const uint32_t* base[kMaxUnitPlanes];
  int64_t stride[kMaxUnitPlanes];
  int n_planes, n_fix;  // n_fix: the filter and the fixed levels
  int cnt[3];           // rows of each role's window (1 for a virtual role)
  int64_t g0;           // the group index of the unit's first group
};

// Thread 0 decodes unit u (K window fastest, then A, O, the fixed levels
// last-first).
__device__ void decode_unit(const Plan& p, int64_t u, Unit* unit) {
  int64_t idx[3];
  for (int r = 2; r >= 0; --r) {
    idx[r] = u % p.wins[r];
    u /= p.wins[r];
  }
  int np = 0;
  int64_t g0 = 0;
  if (p.filt != nullptr) {
    unit->base[np] = p.filt;
    unit->stride[np] = p.filt_stride;
    ++np;
  }
  const int fix0 = np;
  np += p.n_fixed;
  for (int f = p.n_fixed - 1; f >= 0; --f) {
    const int64_t d = u % p.fixed_n[f];
    u /= p.fixed_n[f];
    g0 += d * p.fixed_st[f];
    unit->base[fix0 + f] = nullptr;
    unit->stride[fix0 + f] = p.fixed_first[f] + d;  // a plane index until below
  }
  unit->n_fix = np;
  for (int r = 0; r < 3; ++r) {
    const int64_t lo = idx[r] * p.w[r];
    const int c = static_cast<int>(p.n[r] - lo < p.w[r] ? p.n[r] - lo : p.w[r]);
    unit->cnt[r] = c;
    g0 += lo * p.st[r];
    if (p.real[r]) {
      for (int i = 0; i < c; ++i) {
        unit->base[np] = nullptr;
        unit->stride[np] = p.first[r] + lo + i;
        ++np;
      }
    }
  }
  // Plane indices to row bases and strides.
  for (int i = fix0; i < np; ++i) {
    const int64_t k = unit->stride[i];
    unit->base[i] = reinterpret_cast<const uint32_t*>(p.table[k]);
    unit->stride[i] = p.table[p.n_planes + k];
  }
  unit->n_planes = np;
  unit->g0 = g0;
}

// One thread's share of an item: its kWordsPerThread words of the tile
// (word j of each plane from ld(plane, j); words at or past tw count 0),
// every group of the unit, counts into acc.
template <int KM, typename Load>
__device__ __forceinline__ void evaluate(const Unit& unit, bool o_real, bool a_real, int tw,
                                         Load ld, uint32_t (&acc)[om_for(KM)][kAM][KM]) {
  constexpr int OM = om_for(KM);
  constexpr int WPT = kWordsPerThread;
  int j[WPT];
  uint32_t base[WPT];
#pragma unroll
  for (int m = 0; m < WPT; ++m) {
    j[m] = threadIdx.x + m * kConsumers;
    base[m] = j[m] < tw ? ~0u : 0u;
  }
  for (int p = 0; p < unit.n_fix; ++p) {
#pragma unroll
    for (int m = 0; m < WPT; ++m) base[m] &= ld(p, j[m]);
  }
  const int n_o = unit.cnt[0], n_a = unit.cnt[1], n_k = unit.cnt[2];
  const int pa = unit.n_fix + (o_real ? n_o : 0);
  const int pk = pa + (a_real ? n_a : 0);
  uint32_t kv[WPT][KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
#pragma unroll
    for (int m = 0; m < WPT; ++m) kv[m][k] = k < n_k ? ld(pk + k, j[m]) : 0u;
  }
  uint32_t av[WPT][kAM];
#pragma unroll
  for (int a = 0; a < kAM; ++a) {
#pragma unroll
    for (int m = 0; m < WPT; ++m) av[m][a] = a_real && a < n_a ? ld(pa + a, j[m]) : ~0u;
  }
#pragma unroll
  for (int o = 0; o < OM; ++o) {
    if (o < n_o) {
      uint32_t ov[WPT];
#pragma unroll
      for (int m = 0; m < WPT; ++m) ov[m] = o_real ? base[m] & ld(unit.n_fix + o, j[m]) : base[m];
#pragma unroll
      for (int a = 0; a < kAM; ++a) {
        if (a < n_a) {
          uint32_t x[WPT];
#pragma unroll
          for (int m = 0; m < WPT; ++m) x[m] = ov[m] & av[m][a];
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            // The group's three words through a full adder: two popcounts.
            const uint32_t y0 = x[0] & kv[0][k], y1 = x[1] & kv[1][k], y2 = x[2] & kv[2][k];
            const uint32_t ones = y0 ^ y1 ^ y2;
            const uint32_t twos = (y0 & y1) | (y2 & (y0 ^ y1));
            acc[o][a][k] += __popc(ones) + 2 * __popc(twos);
          }
        }
      }
    }
  }
}

// grid = units x slices (unit fastest), kThreads threads. Block (unit u,
// slice z) walks items [z * items / slices, (z + 1) * items / slices);
// item i is tile i % tiles_per_row of row i / tiles_per_row. STAGED: the
// ring in dynamic shared memory (kStages stages of n_planes x kTile words;
// every plane row 16-byte aligned, words a multiple of 4); else plain
// loads from device memory.
template <bool STAGED, int KM>
__global__ void __launch_bounds__(kThreads, 1)
group_count_kernel(const __grid_constant__ Plan p) {
  extern __shared__ __align__(128) uint32_t ring[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ Unit unit;
  __shared__ unsigned long long sacc[kAccBudget];
  constexpr int OM = om_for(KM);
  const int64_t u = blockIdx.x % p.units;
  const int64_t z = blockIdx.x / p.units;
  const int64_t i0 = z * p.items / p.slices;
  const int64_t n_items = (z + 1) * p.items / p.slices - i0;
  if (threadIdx.x == 0) {
    decode_unit(p, u, &unit);
    if (STAGED) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  for (int g = threadIdx.x; g < kAccBudget; g += kThreads) sacc[g] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_planes = unit.n_planes;
  const size_t stage_words = static_cast<size_t>(n_planes) * kTile;

  if (warp == kConsumerWarps) {  // the producer
    if (STAGED && lane == 0) {
      for (int64_t t = 0; t < n_items; ++t) {
        const int s = static_cast<int>(t % kStages);
        if (t >= kStages) mbar_wait(&empty[s], static_cast<uint32_t>((t / kStages - 1) & 1));
        const int64_t i = i0 + t;
        const int64_t row = i / p.tiles_per_row;
        const int64_t off = (i % p.tiles_per_row) * kTile;
        const uint32_t bytes =
            static_cast<uint32_t>((p.words - off < kTile ? p.words - off : kTile) * 4);
        mbar_expect_tx(&full[s], bytes * n_planes);
        uint32_t* dst = ring + s * stage_words;
        for (int q = 0; q < n_planes; ++q)
          bulk_load(dst + q * kTile, unit.base[q] + row * unit.stride[q] + off, bytes, &full[s]);
      }
    }
    return;
  }

  uint32_t acc[OM][kAM][KM];
#pragma unroll
  for (int o = 0; o < OM; ++o)
#pragma unroll
    for (int a = 0; a < kAM; ++a)
#pragma unroll
      for (int k = 0; k < KM; ++k) acc[o][a][k] = 0;
  const bool o_real = p.real[0], a_real = p.real[1];
  for (int64_t t = 0; t < n_items; ++t) {
    const int64_t i = i0 + t;
    const int64_t row = i / p.tiles_per_row;
    const int64_t off = (i % p.tiles_per_row) * kTile;
    const int tw = static_cast<int>(p.words - off < kTile ? p.words - off : kTile);
    if (STAGED) {
      const int s = static_cast<int>(t % kStages);
      const uint32_t* st = ring + s * stage_words;
      mbar_wait(&full[s], static_cast<uint32_t>((t / kStages) & 1));
      evaluate<KM>(unit, o_real, a_real, tw,
                   [&](int q, int jw) { return st[q * kTile + jw]; }, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    } else {
      evaluate<KM>(unit, o_real, a_real, tw, [&](int q, int jw) {
        return jw < tw ? __ldg(unit.base[q] + row * unit.stride[q] + off + jw) : 0u;
      }, acc);
    }
  }
  // One reduction per group: the warp's sum, then the block's in shared
  // memory, then one global atomicAdd per nonzero group.
  const int n_o = unit.cnt[0], n_a = unit.cnt[1], n_k = unit.cnt[2];
#pragma unroll
  for (int o = 0; o < OM; ++o) {
#pragma unroll
    for (int a = 0; a < kAM; ++a) {
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (o < n_o && a < n_a && k < n_k) {
          const unsigned v = __reduce_add_sync(0xffffffffu, acc[o][a][k]);
          if (lane == 0 && v) atomicAdd(&sacc[(o * n_a + a) * n_k + k], (unsigned long long)v);
        }
      }
    }
  }
  // Every consumer warp's sums are in: a barrier of the consumers alone
  // (the producer warp has left).
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  const int n_groups = n_o * n_a * n_k;
  for (int g = threadIdx.x; g < n_groups; g += kConsumers) {
    if (sacc[g]) {
      const int k = g % n_k, a = (g / n_k) % n_a, o = g / (n_k * n_a);
      atomicAdd(p.out + unit.g0 + o * p.st[0] + a * p.st[1] + k * p.st[2], sacc[g]);
    }
  }
}

template <bool STAGED, int KM>
int launch(Plan p, int sms, size_t smem, cudaStream_t s) {
  auto kernel = group_count_kernel<STAGED, KM>;
  cudaError_t err = cudaSuccess;
  // The ring's most, always the same value: launches from other host
  // threads never see a smaller limit than their own.
  if (STAGED)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Slices of the item run: enough blocks to fill the card once, each run
  // at most kMaxItemsPerBlock items, none empty.
  const int64_t target = static_cast<int64_t>(sms) * per_sm;
  int64_t slices = (target + p.units - 1) / p.units;
  const int64_t min_slices = (p.items + kMaxItemsPerBlock - 1) / kMaxItemsPerBlock;
  if (slices < min_slices) slices = min_slices;
  if (slices > p.items) slices = p.items;
  if (p.units * slices > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  p.slices = slices;
  kernel<<<static_cast<unsigned>(p.units * slices), kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool STAGED>
int launch_km(int km, const Plan& p, int sms, size_t smem, cudaStream_t s) {
  switch (km) {
    case 1: return launch<STAGED, 1>(p, sms, smem, s);
    case 2: return launch<STAGED, 2>(p, sms, smem, s);
    case 3: return launch<STAGED, 3>(p, sms, smem, s);
    case 4: return launch<STAGED, 4>(p, sms, smem, s);
    case 5: return launch<STAGED, 5>(p, sms, smem, s);
    case 6: return launch<STAGED, 6>(p, sms, smem, s);
    case 7: return launch<STAGED, 7>(p, sms, smem, s);
    default: return launch<STAGED, 8>(p, sms, smem, s);
  }
}

}  // namespace

// host_table: int64 [n_planes row bases, n_planes row strides (words)],
// copied to dev_table (same length) on the stream before the launch.
// sizes: the rows of each of `levels` levels (1 to 16), each at least 1,
// summing to n_planes; level l's rows are the planes following level
// l - 1's. filt: [rows] rows of filt_stride words, or null
// for no filter. out: prod(sizes) uint64 zeros. vec: every plane row and
// the filter's are 16-byte aligned and words is a multiple of 4. Returns
// the first CUDA error of the copy or the launch.
extern "C" int pilosa_group_count(const int64_t* host_table, void* dev_table, int n_planes,
                                  const int64_t* sizes, int levels, const void* filt,
                                  int64_t filt_stride, void* out, int64_t rows, int64_t words,
                                  int vec, void* stream) {
  if (n_planes <= 0 || levels <= 0 || levels > kMaxLevels || rows <= 0 || words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t total = 0;
  for (int l = 0; l < levels; ++l) {
    if (sizes[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    total += sizes[l];
  }
  if (total != n_planes) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  // A pageable source: the copy returns once the table is staged, so the
  // caller may free it; the kernel after it on `s` sees the whole table.
  cudaError_t err = cudaMemcpyAsync(dev_table, host_table, 2 * sizeof(int64_t) * n_planes,
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  Plan p = {};
  p.table = static_cast<const int64_t*>(dev_table);
  p.n_planes = n_planes;
  p.filt = static_cast<const uint32_t*>(filt);
  p.filt_stride = filt_stride;
  p.out = static_cast<unsigned long long*>(out);
  // Rows that follow each other in memory in every plane and the filter:
  // one long row, so tiles run across the shard rows.
  bool joined = true;
  for (int i = 0; i < n_planes; ++i) joined = joined && host_table[n_planes + i] == words;
  if (filt != nullptr) joined = joined && filt_stride == words;
  p.rows = joined ? 1 : rows;
  p.words = joined ? rows * words : words;
  p.tiles_per_row = (p.words + kTile - 1) / kTile;
  p.items = p.rows * p.tiles_per_row;

  // Roles: K, A and O are the last three levels of more than one row
  // (K the last level when none has more); the rest are fixed.
  int role_level[3] = {-1, -1, -1};
  int r = 2;
  for (int l = levels - 1; l >= 0 && r >= 0; --l)
    if (sizes[l] > 1) role_level[r--] = l;
  if (role_level[2] < 0) role_level[2] = levels - 1;
  int64_t first[kMaxLevels], st[kMaxLevels];
  for (int l = 0, f = 0; l < levels; ++l) {
    first[l] = f;
    f += static_cast<int>(sizes[l]);
  }
  st[levels - 1] = 1;
  for (int l = levels - 2; l >= 0; --l) st[l] = st[l + 1] * sizes[l + 1];
  for (int l = 0; l < levels; ++l) {
    if (l == role_level[0] || l == role_level[1] || l == role_level[2]) continue;
    p.fixed_first[p.n_fixed] = first[l];
    p.fixed_n[p.n_fixed] = sizes[l];
    p.fixed_st[p.n_fixed] = st[l];
    ++p.n_fixed;
  }
  for (int q = 0; q < 3; ++q) {
    const int l = role_level[q];
    p.real[q] = l >= 0;
    p.first[q] = l >= 0 ? first[l] : 0;
    p.n[q] = l >= 0 ? sizes[l] : 1;
    p.st[q] = l >= 0 ? st[l] : 0;
  }
  // Windows: K's, as wide an A window as kAM allows, as many O rows as the
  // counters allow; then narrowed until the unit's planes fit the ring.
  int64_t kw = p.n[2] < kMaxKM ? p.n[2] : kMaxKM;
  int64_t aw = p.n[1] < kAM ? p.n[1] : kAM;
  int64_t ow = p.n[0] < om_for(static_cast<int>(kw)) ? p.n[0] : om_for(static_cast<int>(kw));
  const int fixed_planes = (filt != nullptr ? 1 : 0) + p.n_fixed;
  auto unit_planes = [&] {
    return fixed_planes + (p.real[0] ? ow : 0) + (p.real[1] ? aw : 0) + kw;
  };
  while (unit_planes() > kMaxUnitPlanes) {
    if (ow > 1) --ow;
    else if (aw > 1) --aw;
    else --kw;  // never past 1: one row a level fits (static_assert)
  }
  p.w[0] = ow;
  p.w[1] = aw;
  p.w[2] = kw;
  p.units = 1;
  for (int q = 0; q < 3; ++q) {
    p.wins[q] = (p.n[q] + p.w[q] - 1) / p.w[q];
    p.units *= p.wins[q];
  }
  for (int f = 0; f < p.n_fixed; ++f) p.units *= p.fixed_n[f];

  int dev_id = 0, sms = 0;
  err = cudaGetDevice(&dev_id);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev_id);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int km = static_cast<int>(kw);
  if (vec) {
    const size_t smem = static_cast<size_t>(kStages) * unit_planes() * kTile * 4;
    return launch_km<true>(km, p, sms, smem, s);
  }
  return launch_km<false>(km, p, sms, 0, s);
}
