// Packed-residency kernels of pilosa_tpu_torch, hand-written for Hopper
// (sm_90a).
//
// A packed leaf stack is an [S, K] int32 matrix: row s holds the sorted,
// distinct in-shard positions of one row's set bits in shard s, padded at
// the tail with the SENTINEL (the shard width, 2^20 by default), so a row
// of n bits costs 4 * K bytes a shard instead of the 128 KiB dense block.
// Four entry points with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates every output, checks
// shapes, strides and alignment, and passes PyTorch's current stream. The
// three count entry points take a wave of B slots of one shape and give
// [B, S] counts, one launch for up to kWaveSlots slots; a single call is
// a wave of one. A wave is jax.vmap of the planner's packed count program
// in the JAX coalescer (pilosa_tpu/parallel/coalesce.py _flush_batched
// over planner.py _packed_count_program, :1906-1929).
//
//   pilosa_packed_count_batched  per row, the entries < SENTINEL
//     Replaces pilosa_tpu/exec/residency.py packed_count (:175-177).
//   pilosa_packed_and_dense_count_batched  per row, the entries <
//     SENTINEL whose bit is set in the row's dense plane
//     Replaces residency.py packed_and_dense_count (:180-188).
//   pilosa_packed_pair_count_batched  per row, a's entries < SENTINEL
//     found in b
//     Replaces residency.py packed_pair_count (:191-203).
//   pilosa_packed_expand  the [S, W] dense planes of a packed stack
//     Replaces residency.py packed_expand (:158-172).
// The JAX package leaves all of them to XLA's fusion inside the planner's
// jitted programs (no pallas_call).
//
// Every count kernel reads its operands through a slot table (Slots<N>):
// each slot's base addresses and row strides, passed by value as a
// __grid_constant__ kernel parameter, so a wave is one operation on the
// stream with no table copied to the card ahead of it. A single call is
// the one-slot table; a wave takes tables of kWaveSlots (the coalescer's
// largest wave), and a longer wave is split into the fewest launches that
// hold it. blockIdx.y is the slot (blockIdx.x in and_count's gather); the
// slots of a wave share their shapes (S rows, K entries), not their
// tensors or strides.
//
// Words of a dense plane are 32-bit bit patterns (int32 tensors on the
// torch side), read and written as uint32, so bit 31 is a bit like any
// other. Counts are int32 per row.
//
// Bounds on the H100: memory bandwidth, and at the planner's shapes
// (S = 1024, K <= 4096) a few microseconds a slot, under the 5 us that one
// launch of any kernel takes between two CUDA events (torch.zeros of 1024
// int32 on an H100 80GB HBM3 at 700 W; the times below are from that card:
// and_count's and pair_count's from an earlier form of
// scripts/packed_probe.py that took their gathers and searches out). A
// wave's bound is the sum of its slots'.
//  * count reads S * K * 4 bytes: 4 MiB at K = 1024, 1.3 us at 3.35 TB/s.
//  * and_count reads the entries and, for each entry, one 32-byte sector
//    of the plane (entries share a sector where their bits lie in one
//    256-bit stretch, and the slots of a wave where they gather one plane
//    row's sector). Those sectors are random reads of
//    HBM, which it serves well below its streaming rate: at [1024, 1024]
//    against a [1024, 32768] plane (488,207 distinct sectors) the gathers take 7.5
//    us more from HBM than from L2, under any L2 fetch granularity; the
//    kernel takes 7.8 us with them removed and 17.1 us with them. A wave
//    whose slots all read one plane re-read its sectors once a slot from
//    HBM in its first form (slot z's blocks ran after every row of slot z -
//    1, long after the 128 MiB plane had left the 50 MB L2): 0.0968 ms at
//    8 slots of [1024, 1024] and 0.3639 at 32 (36.3% and 21.8% of the
//    distinct-sector bound). Two routes now, either one launch
//    (kernels.and_wave_route picks, from the times below):
//    - where the slots share one plane the gather's grid takes the slot
//      fastest, so a row block's slots run back to back and meet each
//      other's sectors in L2: 0.0622 ms at 8 slots, 0.1388 at 32, 0.1033
//      at 8 slots of K = 4096 (a wave on planes of their own keeps the
//      row blocks fastest: 0.1049 ms at 8 slots, 0.1056 the other way);
//    - the staged route (packed_and_staged_kernel, a launch whose slots
//      share one plane) copies each plane row into shared memory once and
//      counts every slot's entries against it: the plane streamed whole
//      (128 MiB, 0.0401 ms at 3.35 TB/s) and each entry read once. 0.1032
//      ms at 32 slots (the streaming bound of plane and entries 0.0802),
//      0.0774 at 8 (there the sectors the slots touch are 2.6M of the
//      plane's 4.2M, so the gather reads less), 0.0578 at one slot of K =
//      8: a row pass is a bulk copy of 128 KiB, one block an SM.
//    Taken where slots x K reach the plane row's words (32 slots of K =
//    1024, 8 of K = 4096; 0.2424 against the gather's 0.3074 at 32 of K =
//    4096), from 2 slots. H100 80GB HBM3, 700 W, scripts/packed_probe.py,
//    one call; also timed there: a row in 64 KiB tiles (3 blocks an SM,
//    entries re-read a tile) 0.1360 at 32 slots, 512 threads 0.1145, 2 or
//    8 entry loads a lane 0.1089 and 0.1227, a persistent block an SM
//    0.1075.
//  * pair_count reads both stacks once; its binary searches run in shared
//    memory, log2(Kb) probes per entry of a. At [1024, 1024] x [1024,
//    2048] it takes 8.6 us with the searches removed and 10.9 us with
//    them: shared-memory probes, after the row has landed.
//  * expand writes the [S, W] planes once: 128 MiB at S = 1024, 40 us.
//
// What each design does about its bound is written above its kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;
// Words of one expand tile: 32 KiB of shared memory, 4 tiles to a
// 32768-word row.
constexpr int64_t kTileWords = 8192;
// The most entries of b that pair_count stages: 128 KiB of shared memory.
constexpr int64_t kMaxPairEntries = 32768;
// Entries of a row one packed_count thread loads at a time: 8 on a
// single launch (a one-slot table; 128 lanes a row at K = 1024), 32 on a
// wave's (a warp a row). At [1024, 1024] on the H100
// (scripts/packed_probe.py) 32 took a single launch 0.11 us longer, and 8
// a wave of 8 slots 0.9 us longer.
constexpr int kSingleCountBatch = 8;
constexpr int kWaveCountBatch = 32;
template <int N>
__host__ __device__ constexpr int count_batch() {
  return N == 1 ? kSingleCountBatch : kWaveCountBatch;
}
// Entries of a row one and_count thread holds at a time, their plane
// gathers all in flight together (8 took 17.3 us against 17.1 at K = 1024).
constexpr int kAndBatch = 16;
// The staged and_count route: threads a block, the most plane words a
// block stages at once (128 KiB of shared memory: a whole 32768-word shard
// row), and the entry loads a lane issues before it counts any (16-byte
// loads where the slots' rows allow, 4 entries each; else 4-byte).
constexpr int kStagedThreads = 1024;
constexpr int64_t kStageWords = 32768;
constexpr int kStagedBatch = 4;
// Entries of a one pair_count thread searches at a time, interleaved.
constexpr int kPairBatch = 4;
// Slots of one wave launch: the coalescer's largest wave
// (pilosa_tpu_torch/parallel/coalesce.py MAX_BATCH), 1 KiB of parameters.
constexpr int kWaveSlots = 32;

// The operands of a launch's slots: slot z reads row r of a at a[z] + r *
// a_stride[z] and of b (the plane, or the second stack) at b[z] + r *
// b_stride[z]. Passed by value as a __grid_constant__ parameter and read
// in place from the parameter bank.
template <int N>
struct Slots {
  const int32_t* a[N];
  const int32_t* b[N];
  int64_t a_stride[N];
  int64_t b_stride[N];
};

// Sum of v over the block's threads, valid in thread 0. Every thread of
// the block must call it.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) total += scratch[w];
  return total;
}

// Entries of a row loaded into registers ahead of their use: positions
// base + lane + u * lanes for u < E, so the lanes of a warp hold
// neighbouring entries at each u. Every position at or past k reads as the
// sentinel. All the loads are issued before any is used: one round trip to
// device memory, not E.
template <int E>
__device__ __forceinline__ void load_entries(const int32_t* __restrict__ p, int64_t k,
                                             int64_t base, int lane, int lanes,
                                             int32_t sentinel, int32_t (&e)[E]) {
#pragma unroll
  for (int u = 0; u < E; ++u) {
    const int64_t q = base + lane + static_cast<int64_t>(u) * lanes;
    e[u] = q < k ? __ldg(p + q) : sentinel;
  }
}

// The sum of c over each row's 2^n lanes (neighbouring threads, at most
// a block), stored to *dst by the row's lane 0 where valid: by shuffles
// within a warp, across warps in shared memory. Every thread of the block
// must call it.
__device__ __forceinline__ void store_row_sum(int c, int lanes, int lane, bool valid,
                                              int32_t* dst, int* scratch) {
  if (lanes <= 32) {  // the row's lanes lie in one warp
    for (int o = lanes >> 1; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (lane == 0 && valid) *dst = c;
    return;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = c;
  __syncthreads();
  if (lane == 0 && valid) {
    int total = 0;
    for (int j = 0; j < lanes / 32; ++j) total += scratch[threadIdx.x / 32 + j];
    *dst = total;
  }
}

// ---------------------------------------------------------------------------
// packed_count: 2^lanes_log2 threads a row (the fewest that take the row
// in one batch of E = count_batch<N>() entries each, at most a block),
// blockDim / that many rows a block, blockIdx.y the slot. A thread's batch
// is loaded whole before any entry is counted -- E / 4 16-byte loads
// where every row is aligned, E 4-byte loads (load_entries) otherwise -- so the row's bytes are all in flight at once, one round
// trip to device memory a batch; the lanes of a warp take neighbouring
// 16-byte words (or entries) at each load. The launcher halves the block
// while the grid would leave SMs without two blocks. The count is a
// compare and an add an entry. It counts every entry <
// sentinel and does not stop at the first sentinel, so it agrees with
// the function on any input, sorted or not.
// ---------------------------------------------------------------------------
template <bool VEC, int N>
__global__ void __launch_bounds__(kThreads)
packed_count_kernel(const __grid_constant__ Slots<N> slots, int32_t* __restrict__ out,
                    int64_t rows, int64_t k, int32_t sentinel, int lanes_log2) {
  __shared__ int scratch[kThreads / 32];
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> lanes_log2) +
                      (threadIdx.x >> lanes_log2);
  const int slot = N == 1 ? 0 : blockIdx.y;
  constexpr int E = count_batch<N>();
  constexpr int kVecs = E / 4;
  int c = 0;
  if (row < rows) {
    const int32_t* p = slots.a[slot] + row * slots.a_stride[slot];
    if (VEC) {
      const int4* p4 = reinterpret_cast<const int4*>(p);
      const int64_t k4 = k / 4;
      for (int64_t base = 0; base < k4; base += static_cast<int64_t>(kVecs) * lanes) {
        int4 v[kVecs];
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          const int64_t q = base + lane + static_cast<int64_t>(u) * lanes;
          v[u] = q < k4 ? __ldg(p4 + q) : make_int4(sentinel, sentinel, sentinel, sentinel);
        }
#pragma unroll
        for (int u = 0; u < kVecs; ++u)
          c += (v[u].x < sentinel) + (v[u].y < sentinel) + (v[u].z < sentinel) +
               (v[u].w < sentinel);
      }
    } else {
      for (int64_t base = 0; base < k; base += static_cast<int64_t>(E) * lanes) {
        int32_t e[E];
        load_entries<E>(p, k, base, lane, lanes, sentinel, e);
#pragma unroll
        for (int u = 0; u < E; ++u) c += e[u] < sentinel;
      }
    }
  }
  store_row_sum(c, lanes, lane, row < rows, out + slot * rows + row, scratch);
}

// ---------------------------------------------------------------------------
// packed_and_dense_count: 2^lanes_log2 threads a row (the fewest that
// cover the row in one batch of kAndBatch entries each, at most a block),
// blockDim / that many rows a block, blockIdx.y the slot and blockIdx.x
// the row block; where a launch's slots all read one plane (slot_x) the
// other way round, so a row block's slots run back to back and meet each
// other's plane sectors in L2. A thread's
// batch is loaded whole (load_entries), then every plane gather of the
// batch is issued before the first is consumed, and the next batch's entries load while those
// gathers are in flight: about one round trip to device memory a batch
// on a thread's path, not two an entry. The lanes of a warp take
// neighbouring entries, so one gather instruction reads 32 neighbouring
// positions of a sorted row: with 16-byte index loads, which put a lane's
// four entries side by side and a warp's 32 gathers four entries apart,
// the kernel took 18.2 us against 17.1 at [1024, 1024] x [1024, 32768];
// with each row's entries shuffled it takes 18.9. In the SASS
// (cuobjdump -sass) a batch is 16 predicated index loads of the next
// batch, then the 16 gathers, each behind a branch over the lanes whose
// entry is a sentinel, then the shifts and adds: no gather waits on
// another. Each valid entry i (i < sentinel) reads plane word
// clamp(i >> 5, 0, W - 1) through the read-only path and adds bit
// (i & 31) of it, an unsigned shift; sentinels and the positions past the
// row read nothing. The clamp and the arithmetic shift are the JAX
// function's, so the kernel agrees with it on any input; only sector
// sharing between neighbouring lanes relies on sortedness. The row's
// lanes sum by store_row_sum. A slot's plane is its b.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(kThreads)
packed_and_dense_kernel(const __grid_constant__ Slots<N> slots, int32_t* __restrict__ out,
                        int64_t rows, int64_t k, int64_t words, int32_t sentinel,
                        int lanes_log2, bool slot_x) {
  __shared__ int scratch[kThreads / 32];
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t row = static_cast<int64_t>(slot_x ? blockIdx.y : blockIdx.x) *
                          (blockDim.x >> lanes_log2) +
                      (threadIdx.x >> lanes_log2);
  const int slot = N == 1 ? 0 : (slot_x ? blockIdx.x : blockIdx.y);
  const int64_t step = static_cast<int64_t>(kAndBatch) * lanes;
  int c = 0;
  if (row < rows) {
    const int32_t* p = slots.a[slot] + row * slots.a_stride[slot];
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(slots.b[slot]) + row * slots.b_stride[slot];
    int32_t e[kAndBatch];
    load_entries<kAndBatch>(p, k, 0, lane, lanes, sentinel, e);
    for (int64_t base = 0; base < k; base += step) {
      uint32_t v[kAndBatch];
#pragma unroll
      for (int u = 0; u < kAndBatch; ++u) {
        int64_t wi = e[u] >> 5;
        wi = wi < 0 ? 0 : (wi >= words ? words - 1 : wi);
        v[u] = 0;
        if (e[u] < sentinel) v[u] = __ldg(w + wi);
      }
      int32_t next[kAndBatch];
      load_entries<kAndBatch>(p, k, base + step, lane, lanes, sentinel, next);
#pragma unroll
      for (int u = 0; u < kAndBatch; ++u) {
        c += (v[u] >> (e[u] & 31)) & 1u;
        e[u] = next[u];
      }
    }
  }
  store_row_sum(c, lanes, lane, row < rows, out + slot * rows + row, scratch);
}

// ---------------------------------------------------------------------------
// packed_and_dense_count, staged (a launch whose slots all read one plane:
// one base address, one row stride). A block owns a plane row (blockIdx.x,
// then every gridDim.x-th): thread 0 brings the row's words into dynamic
// shared memory with one bulk copy on an mbarrier (BULK: the row 16-byte
// aligned and W a multiple of 4; otherwise the block stages it with
// coalesced loads), at most kStageWords at a time (a wider row is walked
// in tiles, each thread testing its entries against each tile). While the
// row lands the warps load their first entries: the block's warps split
// the launch's slots, kStagedThreads / 32 / m warps a slot where the slots
// are fewer than the warps (a unit: a slot and a part of its row), and
// the lanes of a warp take neighbouring 16-byte words of entries (VEC) or
// neighbouring entries, kStagedBatch loads in flight a lane. Each entry i
// (i < sentinel) whose word clamp(i >> 5, 0, W - 1) lies in the tile adds
// bit (i & 31) of it from shared memory, an unsigned shift; the JAX
// function's meaning on any input, with no reliance on order. A unit's
// lanes sum by shuffles and add into the slot's shared counter; the first
// m threads store the row's counts. So the launch reads the plane once,
// not once a slot, and each entry once.
// ---------------------------------------------------------------------------
template <bool BULK, bool VEC, int N>
__global__ void __launch_bounds__(kStagedThreads)
packed_and_staged_kernel(const __grid_constant__ Slots<N> slots, int m,
                         int32_t* __restrict__ out, int64_t rows, int64_t k, int64_t words,
                         int32_t sentinel) {
  extern __shared__ __align__(16) uint32_t stage[];
  __shared__ int cnt[N];
  __shared__ uint64_t bar;
  constexpr int kWarps = kStagedThreads / 32;
  constexpr int kPer = VEC ? 4 : 1;  // entries a load
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int parts = m >= kWarps ? 1 : kWarps / m;
  const int units = m * parts;
  const int64_t loads = k / kPer;  // a row's loads
  if (BULK && threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t phase = 0;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const uint32_t* prow =
        reinterpret_cast<const uint32_t*>(slots.b[0]) + r * slots.b_stride[0];
    if (threadIdx.x < N) cnt[threadIdx.x] = 0;  // this thread stored it last row
    for (int64_t t0 = 0; t0 < words; t0 += kStageWords) {
      const int64_t tw = words - t0 < kStageWords ? words - t0 : kStageWords;
      __syncthreads();  // the stage free, the counters zeroed, the barrier seen
      if (BULK) {
        if (threadIdx.x == 0) {
          const uint32_t bytes = static_cast<uint32_t>(tw * sizeof(uint32_t));
          mbar_expect_tx(&bar, bytes);
          bulk_load(stage, prow + t0, bytes, &bar);
        }
      } else {
        for (int64_t j = threadIdx.x; j < tw; j += kStagedThreads) stage[j] = __ldg(prow + t0 + j);
        __syncthreads();
      }
      bool ready = !BULK;
      for (int u = warp; u < units; u += kWarps) {
        const int z = u / parts;
        const int32_t* p = slots.a[z] + r * slots.a_stride[z];
        int c = 0;
        for (int64_t base = static_cast<int64_t>(u % parts) * 32 + lane; base < loads;
             base += static_cast<int64_t>(32) * parts * kStagedBatch) {
          int32_t e[kStagedBatch * kPer];
#pragma unroll
          for (int b = 0; b < kStagedBatch; ++b) {
            const int64_t q = base + static_cast<int64_t>(b) * 32 * parts;
            if (VEC) {
              const int4 v = q < loads ? __ldg(reinterpret_cast<const int4*>(p) + q)
                                       : make_int4(sentinel, sentinel, sentinel, sentinel);
              e[4 * b] = v.x;
              e[4 * b + 1] = v.y;
              e[4 * b + 2] = v.z;
              e[4 * b + 3] = v.w;
            } else {
              e[b] = q < loads ? __ldg(p + q) : sentinel;
            }
          }
          if (!ready) {
            mbar_wait(&bar, phase);
            ready = true;
          }
#pragma unroll
          for (int j = 0; j < kStagedBatch * kPer; ++j) {
            int64_t wi = e[j] >> 5;
            wi = (wi < 0 ? 0 : (wi >= words ? words - 1 : wi)) - t0;
            if (e[j] < sentinel && wi >= 0 && wi < tw) c += (stage[wi] >> (e[j] & 31)) & 1u;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
        if (lane == 0 && c) atomicAdd(&cnt[z], c);
      }
      if (!ready) mbar_wait(&bar, phase);  // no unit here: the copy has still landed
      phase ^= 1u;
    }
    __syncthreads();  // every unit's count added
    if (threadIdx.x < m) out[static_cast<int64_t>(threadIdx.x) * rows + r] = cnt[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// packed_pair_count: a block a row (blockIdx.x the row, blockIdx.y the
// slot). Thread 0 starts one bulk copy of b's row (kb entries, at most
// kMaxPairEntries) into dynamic shared memory on an mbarrier (BULK: the
// row 16-byte aligned and kb a multiple of 4; otherwise the block stages
// it with coalesced loads), and while it lands every thread loads its
// first kPairBatch entries of a (load_entries; the SASS issues them before
// the wait on the barrier). Then each thread runs the searches of its
// batch interleaved, step by step, so their shared-memory probes overlap,
// while the next batch of a loads. The lanes of a warp hold neighbouring
// entries of a: for a sorted a their probes fall on few addresses a step,
// where a lane's four neighbouring entries put a warp's probes four
// entries apart and into more bank conflicts (12.3 against 10.9 us at
// [1024, 1024] x [1024, 2048]). A search is branchless, ceil(log2 kb)
// halvings of a window that holds the leftmost position whose entry is >=
// a's, the same number for every thread; that position, clipped to kb - 1,
// is a hit where b holds a's entry and a's entry is < sentinel, so a's
// sentinels never match b's padding. This is jnp.searchsorted's leftmost
// position, and it relies on b's row being sorted (non-decreasing;
// duplicates allowed); a needs no order.
// ---------------------------------------------------------------------------
template <bool BULK, int N>
__global__ void __launch_bounds__(kThreads)
packed_pair_kernel(const __grid_constant__ Slots<N> slots, int32_t* __restrict__ out,
                   int64_t ka, int64_t kb, int32_t sentinel) {
  extern __shared__ __align__(16) int32_t sb[];
  __shared__ int scratch[kThreads / 32];
  __shared__ uint64_t bar;
  const int64_t row = blockIdx.x;
  const int slot = N == 1 ? 0 : blockIdx.y;
  const int32_t* pa = slots.a[slot] + row * slots.a_stride[slot];
  const int32_t* pb = slots.b[slot] + row * slots.b_stride[slot];
  if (BULK && threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t bytes = static_cast<uint32_t>(kb * sizeof(int32_t));
    mbar_expect_tx(&bar, bytes);
    bulk_load(sb, pb, bytes, &bar);
  }
  const int lanes = blockDim.x;
  const int64_t step = static_cast<int64_t>(kPairBatch) * lanes;
  int32_t e[kPairBatch];
  load_entries<kPairBatch>(pa, ka, 0, threadIdx.x, lanes, sentinel, e);
  if (!BULK)
    for (int64_t j = threadIdx.x; j < kb; j += lanes) sb[j] = __ldg(pb + j);
  __syncthreads();  // the barrier's init, or the staged row, seen by all
  if (BULK) mbar_wait(&bar, 0);
  const int n = static_cast<int>(kb);
  int c = 0;
  for (int64_t base = 0; base < ka; base += step) {
    int32_t next[kPairBatch];
    load_entries<kPairBatch>(pa, ka, base + step, threadIdx.x, lanes, sentinel, next);
    int lo[kPairBatch];
#pragma unroll
    for (int u = 0; u < kPairBatch; ++u) lo[u] = 0;
    // The leftmost position >= e[u] lies in [lo, lo + len]; each halving
    // keeps that true.
    for (int len = n; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int u = 0; u < kPairBatch; ++u) lo[u] = sb[lo[u] + half] < e[u] ? lo[u] + half : lo[u];
      len -= half;
    }
#pragma unroll
    for (int u = 0; u < kPairBatch; ++u) {
      int pos = lo[u] + (sb[lo[u]] < e[u]);
      if (pos > n - 1) pos = n - 1;
      c += (sb[pos] == e[u]) & (e[u] < sentinel);
      e[u] = next[u];
    }
  }
  const int total = block_sum(c, scratch);
  if (threadIdx.x == 0) out[static_cast<int64_t>(slot) * gridDim.x + row] = total;
}

// ---------------------------------------------------------------------------
// packed_expand: a block a tile of kTileWords words of one row. The block
// zeroes its tile in shared memory, reads every entry of its row (each
// row's entries are read once a tile: 4 KiB at K = 1024, from L2 after the
// row's first tile) and ORs the bit of each entry that falls in the tile
// into it with a shared-memory atomic, then writes the tile out once with
// 16-byte stores, neighbouring threads on neighbouring words. No fill
// ahead of the kernel and no second pass over device memory: every output
// word is written once. Entries outside [0, 32 * words) -- the SENTINEL
// padding among them -- are dropped. OR equals the JAX function's
// scatter-ADD only because a row's entries are distinct: the bits they set
// in a word are then distinct powers of two. The kernel needs no order.
// ---------------------------------------------------------------------------
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
packed_expand_kernel(const int32_t* __restrict__ idx, uint32_t* __restrict__ out, int64_t k,
                     int64_t idx_stride, int64_t words, int64_t tiles_per_row) {
  extern __shared__ __align__(16) uint32_t tile[];
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x - row * tiles_per_row) * kTileWords;
  const int64_t n = words - start < kTileWords ? words - start : kTileWords;
  for (int64_t j = threadIdx.x; j < n; j += kThreads) tile[j] = 0;
  __syncthreads();
  const int32_t* p = idx + row * idx_stride;
  const int64_t lo_bit = start * 32, hi_bit = (start + n) * 32;
  for (int64_t j = threadIdx.x; j < k; j += kThreads) {
    const int64_t i = __ldg(p + j);
    if (i >= lo_bit && i < hi_bit)
      atomicOr(&tile[(i >> 5) - start], 1u << (i & 31));
  }
  __syncthreads();
  uint32_t* dst = out + row * words + start;
  if (VEC) {
    const uint4* src4 = reinterpret_cast<const uint4*>(tile);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int64_t j = threadIdx.x; j < n / 4; j += kThreads) dst4[j] = src4[j];
  } else {
    for (int64_t j = threadIdx.x; j < n; j += kThreads) dst[j] = tile[j];
  }
}

int block_threads(int64_t k) {
  int t = 32;
  while (t < kThreads && t < k) t <<= 1;
  return t;
}

bool aligned16(const void* p, int64_t stride, int64_t k) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride % 4 == 0 && k % 4 == 0;
}

// The current device's SMs, read once a process.
int device_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      sms = n;
    else
      sms = 132;
  }
  return sms;
}

// log2 of the fewest lanes a row, a power of two up to a block, that take
// a row of k entries in one batch of per_lane entries each.
int row_lanes_log2(int64_t k, int64_t per_lane) {
  int l = 0;
  while ((1 << l) < kThreads && (per_lane << l) < k) ++l;
  return l;
}

// Blocks of a grid of `slots` x rows rows at `lanes` threads a row and
// `threads` a block.
int64_t row_blocks(int64_t rows, int lanes, int threads) {
  const int64_t per_block = threads / lanes;
  return (rows + per_block - 1) / per_block;
}

// A block of kThreads, halved (not below a warp or a row's lanes) while
// the grid would leave SMs without two blocks.
int spread_threads(int64_t rows, int slots, int lanes) {
  int threads = kThreads;
  while (threads > 32 && threads > lanes &&
         slots * row_blocks(rows, lanes, threads) < 2 * device_sms())
    threads >>= 1;
  return threads;
}

// Slots [first, first + m) of a wave's operand arrays as a table of N
// (b and b_strides may be null).
template <int N>
Slots<N> slot_table(const void* const* a, const int64_t* a_strides, const void* const* b,
                    const int64_t* b_strides, int first, int m) {
  Slots<N> t{};
  for (int z = 0; z < m; ++z) {
    t.a[z] = static_cast<const int32_t*>(a[first + z]);
    t.a_stride[z] = a_strides[first + z];
    t.b[z] = b ? static_cast<const int32_t*>(b[first + z]) : nullptr;
    t.b_stride[z] = b_strides ? b_strides[first + z] : 0;
  }
  return t;
}

// Runs launch(table, m, out) over a wave of n slots in the fewest launches
// of at most kWaveSlots slots (a launch of one slot takes the one-slot
// table), out advancing by `rows` counts a slot. Returns the first CUDA
// error.
template <class Launch>
int each_launch(int n, const void* const* a, const int64_t* a_strides, const void* const* b,
                const int64_t* b_strides, int64_t rows, void* out, Launch launch) {
  for (int first = 0; first < n; first += kWaveSlots) {
    const int m = n - first < kWaveSlots ? n - first : kWaveSlots;
    int32_t* o = static_cast<int32_t*>(out) + static_cast<int64_t>(first) * rows;
    const cudaError_t err =
        m == 1 ? launch(slot_table<1>(a, a_strides, b, b_strides, first, 1), 1, o)
               : launch(slot_table<kWaveSlots>(a, a_strides, b, b_strides, first, m), m, o);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <int N>
cudaError_t launch_count(const Slots<N>& t, int m, int32_t* out, int64_t rows, int64_t k,
                         int32_t sentinel, bool vec, cudaStream_t s) {
  const int lanes_log2 = row_lanes_log2(k, count_batch<N>());
  const int threads = spread_threads(rows, m, 1 << lanes_log2);
  const int64_t bx = row_blocks(rows, 1 << lanes_log2, threads);
  if (bx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(m));
  if (vec)
    packed_count_kernel<true, N><<<grid, threads, 0, s>>>(t, out, rows, k, sentinel,
                                                          lanes_log2);
  else
    packed_count_kernel<false, N><<<grid, threads, 0, s>>>(t, out, rows, k, sentinel,
                                                           lanes_log2);
  return cudaGetLastError();
}

// Above 48 KiB a block's dynamic shared memory must be asked for, for
// each form of a kernel; asked once a process (*opted), for `most` bytes.
cudaError_t smem_opt_in(const void* const* forms, int n, int most, bool* opted) {
  if (*opted) return cudaSuccess;
  for (int i = 0; i < n; ++i) {
    const cudaError_t err =
        cudaFuncSetAttribute(forms[i], cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
  }
  *opted = true;
  return cudaSuccess;
}

cudaError_t pair_smem_opt_in(size_t smem) {
  static bool opted = false;
  if (smem <= (48 << 10)) return cudaSuccess;
  const void* forms[] = {reinterpret_cast<const void*>(packed_pair_kernel<true, 1>),
                         reinterpret_cast<const void*>(packed_pair_kernel<false, 1>),
                         reinterpret_cast<const void*>(packed_pair_kernel<true, kWaveSlots>),
                         reinterpret_cast<const void*>(packed_pair_kernel<false, kWaveSlots>)};
  return smem_opt_in(forms, 4, static_cast<int>(kMaxPairEntries * sizeof(int32_t)), &opted);
}

template <int N>
void staged_forms(const void** forms) {
  forms[0] = reinterpret_cast<const void*>(packed_and_staged_kernel<true, true, N>);
  forms[1] = reinterpret_cast<const void*>(packed_and_staged_kernel<true, false, N>);
  forms[2] = reinterpret_cast<const void*>(packed_and_staged_kernel<false, true, N>);
  forms[3] = reinterpret_cast<const void*>(packed_and_staged_kernel<false, false, N>);
}

cudaError_t staged_smem_opt_in(size_t smem) {
  static bool opted = false;
  if (smem <= (48 << 10)) return cudaSuccess;
  const void* forms[8];
  staged_forms<1>(forms);
  staged_forms<kWaveSlots>(forms + 4);
  return smem_opt_in(forms, 8, static_cast<int>(kStageWords * sizeof(uint32_t)), &opted);
}

// The gather route: the slot fastest where the launch's slots share one
// plane (slot_x), the row blocks fastest otherwise.
template <int N>
cudaError_t launch_and(const Slots<N>& t, int m, int32_t* out, int64_t rows, int64_t k,
                       int64_t words, int32_t sentinel, bool shared, cudaStream_t s) {
  const int lanes_log2 = row_lanes_log2(k, kAndBatch);
  const int threads = spread_threads(rows, m, 1 << lanes_log2);
  const int64_t bx = row_blocks(rows, 1 << lanes_log2, threads);
  const bool slot_x = shared && m > 1;
  if (bx > (slot_x ? 65535LL : 0x7fffffffLL)) return cudaErrorInvalidValue;
  const dim3 grid = slot_x ? dim3(static_cast<unsigned>(m), static_cast<unsigned>(bx))
                           : dim3(static_cast<unsigned>(bx), static_cast<unsigned>(m));
  packed_and_dense_kernel<N><<<grid, threads, 0, s>>>(t, out, rows, k, words, sentinel,
                                                      lanes_log2, slot_x);
  return cudaGetLastError();
}

// The staged route: a block a plane row, the row's words in shared
// memory. bulk: the plane's rows 16-byte aligned and W a multiple of 4;
// vec: every slot's entry rows too, and K a multiple of 4.
template <int N>
cudaError_t launch_staged(const Slots<N>& t, int m, int32_t* out, int64_t rows, int64_t k,
                          int64_t words, int32_t sentinel, bool bulk, bool vec,
                          cudaStream_t s) {
  const size_t smem = static_cast<size_t>(words < kStageWords ? words : kStageWords) *
                      sizeof(uint32_t);
  const cudaError_t err = staged_smem_opt_in(smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(rows);
  if (bulk && vec)
    packed_and_staged_kernel<true, true, N><<<grid, kStagedThreads, smem, s>>>(
        t, m, out, rows, k, words, sentinel);
  else if (bulk)
    packed_and_staged_kernel<true, false, N><<<grid, kStagedThreads, smem, s>>>(
        t, m, out, rows, k, words, sentinel);
  else if (vec)
    packed_and_staged_kernel<false, true, N><<<grid, kStagedThreads, smem, s>>>(
        t, m, out, rows, k, words, sentinel);
  else
    packed_and_staged_kernel<false, false, N><<<grid, kStagedThreads, smem, s>>>(
        t, m, out, rows, k, words, sentinel);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_pair(const Slots<N>& t, int m, int32_t* out, int64_t rows, int64_t ka,
                        int64_t kb, int32_t sentinel, bool bulk, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kb) * sizeof(int32_t);
  const cudaError_t err = pair_smem_opt_in(smem);
  if (err != cudaSuccess) return err;
  // Threads enough for a batch of a's entries each (and, staging b
  // without the bulk copy, kPairBatch of b's each).
  const int64_t per_thread = (ka + kPairBatch - 1) / kPairBatch;
  const int64_t stage = bulk ? 0 : (kb + kPairBatch - 1) / kPairBatch;
  const int threads = block_threads(per_thread > stage ? per_thread : stage);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(m));
  if (bulk)
    packed_pair_kernel<true, N><<<grid, threads, smem, s>>>(t, out, ka, kb, sentinel);
  else
    packed_pair_kernel<false, N><<<grid, threads, smem, s>>>(t, out, ka, kb, sentinel);
  return cudaGetLastError();
}

}  // namespace

// out[z * rows + r] = #{j < k : idx[z][r * strides[z] + j] < sentinel}
// for the n slots idx[z] of one [rows, k] shape, in ceil(n / kWaveSlots)
// launches, by 16-byte loads where every slot is 16-byte aligned and k
// and every stride are multiples of 4. Returns the first CUDA error.
extern "C" int pilosa_packed_count_batched(const void* const* idx, const int64_t* strides,
                                           int n, void* out, int64_t rows, int64_t k,
                                           int sentinel, void* stream) {
  if (n <= 0 || rows < 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  bool vec = true;
  for (int z = 0; z < n; ++z) vec = vec && aligned16(idx[z], strides[z], k);
  auto s = static_cast<cudaStream_t>(stream);
  return each_launch(n, idx, strides, nullptr, nullptr, rows, out,
                     [&](const auto& t, int m, int32_t* o) {
                       return launch_count(t, m, o, rows, k, sentinel, vec, s);
                     });
}

// out[z * rows + r] = sum over j < k with i = idx_r[j] < sentinel of bit
// (i & 31) of plane_r[clamp(i >> 5, 0, words - 1)], idx_r = idx[z] + r *
// idx_strides[z] and plane_r = planes[z] + r * plane_strides[z], for the n
// slots of one [rows, k] x [rows, words] shape, in ceil(n / kWaveSlots)
// launches. staged (the caller's route, kernels.and_wave_route): every
// slot's plane has slot 0's base and row stride, and each launch stages
// the plane's rows once for all its slots; otherwise each entry gathers
// its word. Returns the first CUDA error.
extern "C" int pilosa_packed_and_dense_count_batched(
    const void* const* idx, const int64_t* idx_strides, const void* const* planes,
    const int64_t* plane_strides, int n, void* out, int64_t rows, int64_t k, int64_t words,
    int staged, int sentinel, void* stream) {
  if (n <= 0 || rows < 0 || k <= 0 || words <= 0 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  bool shared = true, vec = true;
  for (int z = 0; z < n; ++z) {
    shared = shared && planes[z] == planes[0] && plane_strides[z] == plane_strides[0];
    vec = vec && aligned16(idx[z], idx_strides[z], k);
  }
  if (!staged)
    return each_launch(n, idx, idx_strides, planes, plane_strides, rows, out,
                       [&](const auto& t, int m, int32_t* o) {
                         return launch_and(t, m, o, rows, k, words, sentinel, shared, s);
                       });
  if (!shared) return static_cast<int>(cudaErrorInvalidValue);
  const bool bulk = aligned16(planes[0], plane_strides[0], words);
  return each_launch(n, idx, idx_strides, planes, plane_strides, rows, out,
                     [&](const auto& t, int m, int32_t* o) {
                       return launch_staged(t, m, o, rows, k, words, sentinel, bulk, vec, s);
                     });
}

// out[z * rows + r] = #{j < ka : a_r[j] < sentinel and a_r[j] == b_r[p]},
// p the leftmost position in b_r (sorted) whose entry is >= a_r[j],
// clipped to kb - 1; a_r = a[z] + r * a_strides[z], b_r = b[z] + r *
// b_strides[z], for the n slots of one [rows, ka] x [rows, kb] shape, in
// ceil(n / kWaveSlots) launches; kb <= kMaxPairEntries; b staged by the
// bulk copy only where every slot's b allows it. Returns the first CUDA
// error.
extern "C" int pilosa_packed_pair_count_batched(const void* const* a, const int64_t* a_strides,
                                                const void* const* b, const int64_t* b_strides,
                                                int n, void* out, int64_t rows, int64_t ka,
                                                int64_t kb, int sentinel, void* stream) {
  if (n <= 0 || rows < 0 || ka <= 0 || kb <= 0 || kb > kMaxPairEntries || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  bool bulk = true;
  for (int z = 0; z < n; ++z) bulk = bulk && aligned16(b[z], b_strides[z], kb);
  auto s = static_cast<cudaStream_t>(stream);
  return each_launch(n, a, a_strides, b, b_strides, rows, out,
                     [&](const auto& t, int m, int32_t* o) {
                       return launch_pair(t, m, o, rows, ka, kb, sentinel, bulk, s);
                     });
}

// out ([rows, words], contiguous) = the dense planes of idx: bit (i & 31)
// of word i >> 5 of row r set for every entry i of idx's row r (at
// r * idx_stride) with 0 <= i < 32 * words, every other bit clear. A row's
// entries are distinct. out is 16-byte aligned when words % 4 == 0.
// Returns the launch's CUDA error.
extern "C" int pilosa_packed_expand(const void* idx, void* out, int64_t rows, int64_t k,
                                    int64_t idx_stride, int64_t words, void* stream) {
  if (rows < 0 || k <= 0 || words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_per_row = (words + kTileWords - 1) / kTileWords;
  const int64_t blocks = rows * tiles_per_row;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(words < kTileWords ? words : kTileWords) *
                      sizeof(uint32_t);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pi = static_cast<const int32_t*>(idx);
  auto* po = static_cast<uint32_t*>(out);
  if (words % 4 == 0)
    packed_expand_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        pi, po, k, idx_stride, words, tiles_per_row);
  else
    packed_expand_kernel<false><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        pi, po, k, idx_stride, words, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}
