// Sketch kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// Three entry points with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates every output, checks
// shapes, types and contiguity, and passes PyTorch's current stream:
//
//   pilosa_hll_expand  the masked register gather of a filtered
//     Count(Distinct): for shard s and column c whose filter bit is set,
//     regs[s, packed[s, c] & 0x3FFFF] = max(., packed[s, c] >> 18).
//     Replaces pilosa_tpu/sketch/kernels.py hll_expand (:32-49), which the
//     JAX package left to XLA (one segment-max scatter), traced into the
//     planner's distinct program (pilosa_tpu/parallel/planner.py:749).
//   pilosa_hll_reduce  the register max over the shard axis of an
//     [S, 2^p] uint8 stack: pilosa_tpu/sketch/kernels.py hll_reduce (:52-54)
//     and the planner's jnp.max(..., axis=0) (planner.py:744, :749).
//   pilosa_similar_count  per candidate row of an [R, S, W] cube, the
//     popcount of (row AND filter) and of the row, each summed over the
//     shards, and the popcount of the filter: the three totals of
//     pilosa_tpu/sketch/kernels.py similar_program (:85-108). Its top_k
//     stays with the wrapper's caller (a stable torch.sort on the host
//     side of the planner).
//
// Bound on the H100: memory bandwidth for all three. hll_expand reads the
// [S, 32768] filter once, of the [S, 2^20] int32 plane (4 MiB a shard) the
// 32-byte sectors that hold a filtered column, and writes 2^p bytes a
// shard; a column costs a shift, a mask and at most one shared-memory
// atomic. hll_reduce reads S * 2^p bytes once. similar_count
// reads each cube word once and the filter once: (R + 1) * S * W * 4 bytes,
// two popcounts and an AND a word.
//
// What the designs do about it:
//  * hll_expand: one block a shard, 512 threads. Its first form walked
//    1,024-column groups a warp at a time, each gather waiting on the
//    group's filter load and each register update before the next gather,
//    so a warp kept about one load in flight (0.358 ms at the keys phase's
//    shape, a quarter of its bound). Now the filter streams and the
//    gathers are issued in rounds:
//    - Thread 0 keeps the shard's filter flowing through a ring of
//      kStages shared-memory stages of kChunkWords words (8 KiB, 65,536
//      columns), one bulk copy (cp.async.bulk, bulk_ring.cuh) a stage on
//      its own mbarrier, the next chunk landing while one is in work; a
//      stage is refilled after the block's barrier at the end of its
//      round, so no "empty" barrier is needed.
//    - A round takes one chunk. Each thread counts the non-zero nibbles
//      (4 columns: 16 bytes of the plane) of its four filter words, a
//      warp scan and the warps' totals give each its offset, and it writes
//      its nibbles' indices, in address order, to a shared list.
//    - Every thread then takes list entries kThreads apart and issues up
//      to kBatch independent 16-byte plane loads (ld.global.nc with
//      L1::no_allocate: each sector is read once) before it updates any
//      register, so a round's gathers are all in flight at once, while
//      the next chunk's filter copy lands.
//    - A chunk whose set nibbles pass kListCap (a quarter of them) is
//      dense: the block skips the list and reads the chunk's plane span
//      in order, 16 bytes a thread and kBatch loads a thread in flight,
//      so an all-ones filter streams the plane near HBM's streaming rate.
//      The choice is made per chunk from the count the scan already has.
//    - An all-zero filter row (pad shards) costs its filter read and the
//      scans, no gather.
//    Registers: where 2^p 32-bit registers fit beside the ring (p <= 14,
//    64 KiB) the block keeps its shard's register file in shared memory,
//    maxes with shared atomicMax and narrows it to bytes at the end, each
//    output word written once. For p = 15..18 (128 KiB to 1 MiB of 32-bit
//    registers, past the 227 KiB a block may hold) the block zeroes its
//    own output row and maxes bytes in place with a compare-and-swap on
//    the aligned 32-bit word holding the byte: exact, and no other block
//    touches the row, so no grid-wide ordering is needed. Sizes, timed on
//    the card against 256 and 1,024 threads (chunks of 1,024 and 4,096
//    words), 3 stages, 8 loads a thread and a list cap of half a chunk
//    (scripts/sketch_probe.py): 8 KiB stages keep a round's list (about
//    320 nibbles at the keys phase's 5M-bit filter) near a thread's worth
//    of loads a block, and at p = 12 a block takes 40 KiB of shared memory
//    and 32 registers a thread, so four blocks share an SM.
//  * hll_reduce: its first form gave a block 32 words of the row and 32
//    warps, so at p = 12 (a 1,024-word row) 32 blocks on the H100's 132
//    SMs streamed the 4 MiB stack, 2.9 us above the 5.0 us one-launch
//    floor against a 1.3 us bound. Now reduce_shape picks the geometry from
//    m, S and the SM count: a block owns the widest band of 32, 16 or 8
//    words (whole 32-byte sectors of each row) that still gives every SM a
//    block, else 8 words (128 blocks at p = 12, 512 at p = 16; 32 words
//    for a few rows), and takes its rows with 16-byte loads, kReduceLoads
//    in flight a thread, so the block's rows are one round trip at S =
//    1024; a block of one warp where the rows fit it. One launch, no zero
//    fill, no atomics, each output vector written once. On an H100 80GB
//    HBM3 at 700 W (scripts/sketch_probe.py, one call): 0.0073 ms at [1024,
//    2^12] against the first form's 0.0079 (2.3 us above the 5.0 us floor:
//    the stack's one round trip; bands of 4 words, half sectors, took
//    0.0084 in another call), 0.0285 against 0.0292 at [1024, 2^16] (512
//    threads a block), 0.0057 against 0.0057 at [1, 2^12] (0.0058 with
//    8-word bands). The shard axis split over 2 to 8 blocks a band, folded
//    in the same launch by the last block to take a ticket, took
//    0.0089-0.0105; the same split as a thread-block cluster folding in
//    distributed shared memory 0.0089-0.0092: each second step costs more
//    than the blocks it adds save.
//  * similar_count: a block owns one span of the flattened [S * W] words,
//    holds the filter's span in registers (16 words a thread), and walks
//    every candidate row's span against it: every cube word and every
//    filter word is read once. Both popcounts come from the same load;
//    the filter's own popcount is taken once. Counts are int32, summed per
//    block and added with one atomicAdd each into the zeroed output, as
//    the JAX program sums in int32 (the host fold widens to int64).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kRhoShift = 18;
constexpr uint32_t kBucketMask = (1u << kRhoShift) - 1u;
constexpr int kExpandThreads = 512;
constexpr int kSharedMaxP = 14;
// The filter ring: kStages stages of kChunkWords words; a thread scans
// kChunkWords / kExpandThreads = 4 words of a chunk.
constexpr int kChunkWords = 2048;
constexpr int kStages = 2;
// The list holds at most a quarter of a chunk's nibbles; past that the
// chunk is read whole.
constexpr int kListCap = kChunkWords * 8 / 4;
// Plane loads a thread issues before it updates any register.
constexpr int kBatch = 4;
constexpr size_t kRingBytes = sizeof(uint32_t) * kStages * kChunkWords;
constexpr size_t kListBytes = sizeof(uint16_t) * kListCap;
static_assert(kChunkWords == 4 * kExpandThreads, "a thread scans one uint4 of a chunk");
static_assert(kChunkWords * 8 <= 65536, "nibble indices are uint16");

// Byte-wise max of `v` into the byte at `p`, exact under concurrency: a
// compare-and-swap on the aligned 32-bit word that holds it.
__device__ __forceinline__ void byte_max(uint8_t* p, uint32_t v) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  auto* word = reinterpret_cast<unsigned int*>(addr & ~uintptr_t(3));
  const unsigned int shift = static_cast<unsigned int>(addr & 3) * 8u;
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
  while (((old >> shift) & 0xffu) < v) {
    const unsigned int next = (old & ~(0xffu << shift)) | (v << shift);
    const unsigned int seen = atomicCAS(word, old, next);
    if (seen == old) break;
    old = seen;
  }
}

// One packed entry whose filter bit is `bit`: its register update, unless
// the column is absent (entry <= 0) or its bucket lies past the file.
template <bool SHARED>
__device__ __forceinline__ void observe(int32_t entry, uint32_t bit, uint32_t m,
                                        unsigned int* sregs, uint8_t* row) {
  if (!bit || entry <= 0) return;
  const uint32_t bucket = static_cast<uint32_t>(entry) & kBucketMask;
  if (bucket >= m) return;
  const uint32_t rho = static_cast<uint32_t>(entry) >> kRhoShift;
  if (SHARED)
    atomicMax(sregs + bucket, rho);
  else
    byte_max(row + bucket, rho & 0xffu);
}

// Bit 4 j of the result is set where nibble j of `w` is not zero.
__device__ __forceinline__ uint32_t nibble_mask(uint32_t w) {
  w |= w >> 1;
  w |= w >> 2;
  return w & 0x11111111u;
}

// 16 plane bytes read once: no L1 line kept for them.
__device__ __forceinline__ int4 load_once(const int32_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

template <bool SHARED>
__global__ void __launch_bounds__(kExpandThreads)
    hll_expand_kernel(const int32_t* __restrict__ packed,
                      const uint32_t* __restrict__ filt, uint8_t* __restrict__ out,
                      int64_t words, int p) {
  extern __shared__ __align__(128) uint32_t ring[];
  auto* list = reinterpret_cast<uint16_t*>(ring + kStages * kChunkWords);
  auto* sregs = reinterpret_cast<unsigned int*>(list + kListCap);
  __shared__ uint64_t full[kStages];
  __shared__ int warp_total[kExpandThreads / 32];
  const int64_t s = blockIdx.x;
  const uint32_t m = 1u << p;
  uint8_t* row = out + s * static_cast<int64_t>(m);
  const int32_t* prow = packed + s * words * 32;
  const uint32_t* frow = filt + s * words;
  const int chunks = static_cast<int>((words + kChunkWords - 1) / kChunkWords);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  auto issue = [&](int c) {  // chunk c of the filter into its stage
    const int64_t w0 = static_cast<int64_t>(c) * kChunkWords;
    const uint32_t bytes = static_cast<uint32_t>(
        (words - w0 < kChunkWords ? words - w0 : kChunkWords) * sizeof(uint32_t));
    uint64_t* bar = &full[c % kStages];
    mbar_expect_tx(bar, bytes);
    bulk_load(ring + (c % kStages) * kChunkWords, frow + w0, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < kStages && c < chunks; ++c) issue(c);
  }
  if (SHARED) {
    for (uint32_t i = threadIdx.x; i < m; i += kExpandThreads) sregs[i] = 0u;
  } else {
    // m >= 2^15 here: the row is whole 16-byte words.
    for (uint32_t i = threadIdx.x; i < m / 16; i += kExpandThreads)
      reinterpret_cast<uint4*>(row)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();  // the barriers' init and the zeroed registers seen by all

  for (int c = 0; c < chunks; ++c) {
    const uint32_t* fw = ring + (c % kStages) * kChunkWords;
    const int64_t w0c = static_cast<int64_t>(c) * kChunkWords;
    const int cw = static_cast<int>(words - w0c < kChunkWords ? words - w0c : kChunkWords);
    mbar_wait(&full[c % kStages], static_cast<uint32_t>((c / kStages) & 1));

    // The chunk's non-zero nibbles: this thread's four words, its offset.
    const int t0 = threadIdx.x * 4;
    const uint4 v = t0 < cw ? *reinterpret_cast<const uint4*>(fw + t0) : make_uint4(0, 0, 0, 0);
    const uint32_t nz[4] = {nibble_mask(v.x), nibble_mask(v.y), nibble_mask(v.z),
                            nibble_mask(v.w)};
    const int n = __popc(nz[0]) + __popc(nz[1]) + __popc(nz[2]) + __popc(nz[3]);
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int total = 0, off = incl - n;
#pragma unroll
    for (int k = 0; k < kExpandThreads / 32; ++k) {
      const int wt = warp_total[k];
      total += wt;
      if (k < warp) off += wt;
    }
    const bool dense = total > kListCap;  // the same for every thread
    if (total == 0) {
      __syncthreads();  // warp_total and the stage free
      if (threadIdx.x == 0 && c + kStages < chunks) issue(c + kStages);
      continue;
    }
    if (!dense) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        for (uint32_t b = nz[k]; b; b &= b - 1)
          list[off++] = static_cast<uint16_t>((t0 + k) * 8 + ((__ffs(b) - 1) >> 2));
      __syncthreads();
    }

    // The round's gathers: kBatch loads in flight a thread, then the
    // register updates.
    const int items = dense ? cw * 8 : total;
    const int32_t* pc = prow + w0c * 32;
    for (int base = threadIdx.x; base < items; base += kExpandThreads * kBatch) {
      int4 e[kBatch];
      uint32_t bits[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kExpandThreads;
        bits[u] = 0u;
        e[u] = make_int4(0, 0, 0, 0);
        if (i < items) {
          const int nib = dense ? i : list[i];
          bits[u] = (fw[nib >> 3] >> ((nib & 7) * 4)) & 0xfu;
          if (bits[u]) e[u] = load_once(pc + nib * 4);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        observe<SHARED>(e[u].x, bits[u] & 1u, m, sregs, row);
        observe<SHARED>(e[u].y, (bits[u] >> 1) & 1u, m, sregs, row);
        observe<SHARED>(e[u].z, (bits[u] >> 2) & 1u, m, sregs, row);
        observe<SHARED>(e[u].w, (bits[u] >> 3) & 1u, m, sregs, row);
      }
    }
    __syncthreads();  // the stage, the list and warp_total free
    if (threadIdx.x == 0 && c + kStages < chunks) issue(c + kStages);
  }
  if (SHARED) {
    // m >= 16: the row is whole 32-bit words, each written once.
    for (uint32_t i = threadIdx.x; i < m / 4; i += kExpandThreads) {
      const uint4 r = *reinterpret_cast<const uint4*>(sregs + 4 * i);
      reinterpret_cast<uint32_t*>(row)[i] = r.x | (r.y << 8) | (r.z << 16) | (r.w << 24);
    }
  }
}

// hll_reduce: a block owns a band of kVecs 16-byte vectors (4 * kVecs
// words) of the register row; thread t takes vector t % kVecs of rows
// t / kVecs, + kThreads / kVecs, ..., kReduceLoads of them in flight before
// it folds any (__vmaxu4: four byte maxes an instruction). The lanes of a
// warp that share a vector fold by shuffles, the warps in shared memory,
// and the block's first kVecs threads write each output vector once.
constexpr int kReduceLoads = 8;

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y), __vmaxu4(a.z, b.z),
                    __vmaxu4(a.w, b.w));
}

// The max of rows [0, rows) of the band's vector `col` (the block's
// vectors blockIdx-wise), valid in the block's first kVecs threads. Every
// thread of the block must call it.
template <int kVecs, int kThreads>
__device__ __forceinline__ uint4 band_max(const uint4* __restrict__ regs, int64_t rows,
                                          int64_t row_vecs, int64_t col) {
  constexpr int kRowsPerPass = kThreads / kVecs;
  __shared__ uint4 part[kThreads / 32][kVecs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (col < row_vecs) {
    const uint4* p = regs + col;
    for (int64_t r0 = threadIdx.x / kVecs; r0 < rows;
         r0 += static_cast<int64_t>(kRowsPerPass) * kReduceLoads) {
      uint4 x[kReduceLoads];
#pragma unroll
      for (int u = 0; u < kReduceLoads; ++u) {
        const int64_t r = r0 + static_cast<int64_t>(u) * kRowsPerPass;
        x[u] = r < rows ? __ldg(p + r * row_vecs) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kReduceLoads; ++u) acc = vmax4(acc, x[u]);
    }
  }
#pragma unroll
  for (int o = 16; o >= kVecs; o >>= 1) {
    acc.x = __vmaxu4(acc.x, __shfl_xor_sync(0xffffffffu, acc.x, o));
    acc.y = __vmaxu4(acc.y, __shfl_xor_sync(0xffffffffu, acc.y, o));
    acc.z = __vmaxu4(acc.z, __shfl_xor_sync(0xffffffffu, acc.z, o));
    acc.w = __vmaxu4(acc.w, __shfl_xor_sync(0xffffffffu, acc.w, o));
  }
  if (lane < kVecs) part[warp][lane] = acc;
  __syncthreads();
  uint4 m = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x < kVecs) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = vmax4(m, part[w][threadIdx.x]);
  }
  return m;
}

template <int kVecs, int kThreads>
__global__ void __launch_bounds__(kThreads)
    hll_reduce_kernel(const uint4* __restrict__ regs, uint4* __restrict__ out, int64_t rows,
                      int64_t row_vecs) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kVecs + threadIdx.x % kVecs;
  const uint4 m = band_max<kVecs, kThreads>(regs, rows, row_vecs, col);
  if (threadIdx.x < kVecs && col < row_vecs) out[col] = m;
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

// The launch geometry of hll_reduce: the band, in 16-byte vectors, and the
// block. The band is the widest of 32, 16 and 8 words (whole 32-byte
// sectors a row) that still gives every SM a block, else 8 words; 32 words
// for kFewRows rows or fewer, where each block has one short pass (and the
// whole row where it is narrower). The block is one warp where the rows
// fit it, 512 threads for a 32-word band of many rows, else 256.
constexpr int64_t kFewRows = 16;

struct ReduceShape {
  int vecs;
  int threads;
};

ReduceShape reduce_shape(int64_t rows, int64_t row_vecs) {
  int vecs = 8;
  while (rows > kFewRows && vecs > 2 && row_vecs / vecs < device_sms()) vecs >>= 1;
  if (vecs > row_vecs) vecs = static_cast<int>(row_vecs);
  const int threads = rows * vecs <= 32 ? 32 : (vecs == 8 && rows * vecs > 256 ? 512 : 256);
  return {vecs, threads};
}

template <int kVecs>
void launch_reduce(int threads, unsigned grid, const uint4* r, uint4* o, int64_t rows,
                   int64_t row_vecs, cudaStream_t s) {
  if (threads == 32)
    hll_reduce_kernel<kVecs, 32><<<grid, 32, 0, s>>>(r, o, rows, row_vecs);
  else if (threads == 256)
    hll_reduce_kernel<kVecs, 256><<<grid, 256, 0, s>>>(r, o, rows, row_vecs);
  else
    hll_reduce_kernel<kVecs, 512><<<grid, 512, 0, s>>>(r, o, rows, row_vecs);
}

constexpr int kSimThreads = 256;
constexpr int kSimVecs = 4;  // uint4 loads a thread: 16 words
constexpr int64_t kSimChunk = static_cast<int64_t>(kSimThreads) * kSimVecs * 4;

// Sum of `acc` over the block, valid in thread 0; callable repeatedly.
__device__ __forceinline__ int block_sum(int acc, int* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kSimThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __syncthreads();
  return acc;
}

// out[0:R] = inter, out[R:2R] = selfc, out[2R] = filtc, all accumulated.
__global__ void __launch_bounds__(kSimThreads)
    similar_count_kernel(const uint32_t* __restrict__ cube,
                         const uint32_t* __restrict__ filt, int* __restrict__ out,
                         int64_t n_rows, int64_t n) {
  __shared__ int warp_sums[kSimThreads / 32];
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kSimChunk;
  const int64_t hi = min(n, lo + kSimChunk);
  uint4 f[kSimVecs];
  int fc = 0;
#pragma unroll
  for (int k = 0; k < kSimVecs; ++k) {
    const int64_t i = lo + (static_cast<int64_t>(k) * kSimThreads + threadIdx.x) * 4;
    f[k] = i < hi ? __ldg(reinterpret_cast<const uint4*>(filt + i)) : make_uint4(0, 0, 0, 0);
    fc += __popc(f[k].x) + __popc(f[k].y) + __popc(f[k].z) + __popc(f[k].w);
  }
  fc = block_sum(fc, warp_sums);
  if (threadIdx.x == 0 && fc) atomicAdd(out + 2 * n_rows, fc);
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint32_t* crow = cube + r * n;
    int inter = 0, self = 0;
#pragma unroll
    for (int k = 0; k < kSimVecs; ++k) {
      const int64_t i = lo + (static_cast<int64_t>(k) * kSimThreads + threadIdx.x) * 4;
      if (i < hi) {
        const uint4 c = __ldg(reinterpret_cast<const uint4*>(crow + i));
        self += __popc(c.x) + __popc(c.y) + __popc(c.z) + __popc(c.w);
        inter += __popc(c.x & f[k].x) + __popc(c.y & f[k].y) + __popc(c.z & f[k].z) +
                 __popc(c.w & f[k].w);
      }
    }
    inter = block_sum(inter, warp_sums);
    self = block_sum(self, warp_sums);
    if (threadIdx.x == 0) {
      if (inter) atomicAdd(out + r, inter);
      if (self) atomicAdd(out + n_rows + r, self);
    }
  }
}

}  // namespace

// out[s, :] = the 2^p uint8 registers of shard s's columns whose bit is set
// in filt[s]: packed is [S, 32 * words] int32 (bucket | rho << 18, 0 for
// an absent column), filt [S, words] int32 bit patterns, both contiguous
// and 16-byte aligned, words a positive multiple of 32; out [S, 2^p]
// uint8, contiguous, written whole (no zeroing needed). 4 <= p <= 18.
// Returns cudaGetLastError() after the launch.
extern "C" int pilosa_hll_expand(const void* packed, const void* filt, void* out,
                                 int64_t rows, int64_t words, int p, void* stream) {
  if (p < 4 || p > 18 || rows <= 0 || rows > 0x7fffffffLL || words <= 0 || words % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const int32_t*>(packed);
  const auto* pf = static_cast<const uint32_t*>(filt);
  auto* po = static_cast<uint8_t*>(out);
  const dim3 grid(static_cast<unsigned int>(rows));
  const bool shared = p <= kSharedMaxP;
  const size_t smem = kRingBytes + kListBytes + (shared ? sizeof(unsigned int) << p : 0);
  if (shared) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(hll_expand_kernel<true>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    hll_expand_kernel<true><<<grid, kExpandThreads, smem, s>>>(pk, pf, po, words, p);
  } else {
    hll_expand_kernel<false><<<grid, kExpandThreads, smem, s>>>(pk, pf, po, words, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[j] = max over r of regs[r, j]: regs [rows, m] uint8 contiguous and
// 16-byte aligned, m a multiple of 16 (m = 2^p, p >= 4); out [m] uint8,
// 16-byte aligned, written whole.
extern "C" int pilosa_hll_reduce(const void* regs, void* out, int64_t rows, int64_t m,
                                 void* stream) {
  if (rows <= 0 || m <= 0 || m % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_vecs = m / 16;
  const ReduceShape shape = reduce_shape(rows, row_vecs);
  const int64_t blocks = (row_vecs + shape.vecs - 1) / shape.vecs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const uint4*>(regs);
  auto* o = static_cast<uint4*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (shape.vecs) {
    case 8: launch_reduce<8>(shape.threads, grid, r, o, rows, row_vecs, s); break;
    case 4: launch_reduce<4>(shape.threads, grid, r, o, rows, row_vecs, s); break;
    case 2: launch_reduce<2>(shape.threads, grid, r, o, rows, row_vecs, s); break;
    default: launch_reduce<1>(shape.threads, grid, r, o, rows, row_vecs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// cube [n_rows, n] and filt [n] int32 bit patterns, contiguous and 16-byte
// aligned, n = S * W a multiple of 4; out [2 * n_rows + 1] int32 holding
// zeros receives inter, selfc, filtc.
extern "C" int pilosa_similar_count(const void* cube, const void* filt, void* out,
                                    int64_t n_rows, int64_t n, void* stream) {
  if (n_rows <= 0 || n <= 0 || n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kSimChunk - 1) / kSimChunk;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  similar_count_kernel<<<static_cast<unsigned int>(blocks), kSimThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cube), static_cast<const uint32_t*>(filt),
      static_cast<int*>(out), n_rows, n);
  return static_cast<int>(cudaGetLastError());
}
