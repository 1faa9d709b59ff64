// Bitmap-tree kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// Three entry points with a plain C interface, loaded with ctypes by
// pilosa_tpu_torch/ops/kernels.py, which allocates every output, checks
// shapes, strides and alignment, compiles and splits the op tape, and
// passes PyTorch's current stream:
//
//   pilosa_tree_count  per-row popcount of a bitmap tree over leaf stacks,
//     given as a postfix op tape, with the tree's result plane written out
//     when asked
//     Replaces the general tree evaluator pilosa_tpu/parallel/planner.py
//     _eval_node (:1932-1957) + bitops.count under _compiled(reduce=
//     "per_shard") (:1814-1819), which the JAX package left to XLA to fuse.
//   pilosa_tree_count_batched  one tape over B slots' leaf tables in one
//     launch (counts only), each distinct leaf of the wave read once
//     Replaces jax.vmap of the count program over a wave of same-plan
//     queries (pilosa_tpu/parallel/coalesce.py:312-348 _flush_batched,
//     pilosa_tpu/parallel/planner.py:387-396 vmapped).
//   pilosa_shift_left  every row shifted toward higher columns by n bits,
//     bits past the row's end falling off
//     Replaces pilosa_tpu/ops/bitops.py shift_left (:167-195), also
//     XLA-fused on the TPU.
//
// Words are 32-bit bit patterns (int32 tensors on the torch side, uint32
// here). Counts are int32 per row: a shard row holds at most 2^30 bits.
//
// Bound on the H100: memory bandwidth. A 3-leaf Count over 954 shards
// padded to 1024 reads 3 x [1024, 32768] x 4 B = 403 MB once, about 120 us
// at 3.35 TB/s; the tape's bitwise ops, one popcount and one add are a few
// dozen integer instructions per 16 bytes loaded, far below the integer
// rate. shift_left reads and writes one [1024, 32768] plane, 268 MB.
//
// What the designs do about that bound:
//  * tree_count reads each leaf word once and writes no intermediate
//    plane: a thread owns 4 words (one 16-byte load per leaf push) and
//    evaluates the whole tape on them in registers. The tape is a short
//    register program the wrapper compiles from postfix form: PUSH leaf l
//    into stack slot d, or OP slot d with slot d + 1 into slot d. The slot
//    of every instruction is known on the host, so the kernel's stack is
//    kMaxStack named registers picked by a switch on a block-uniform
//    value, never an array in local memory. The tape and the leaf
//    pointers travel in one __grid_constant__ parameter block.
//  * As in count_kernels.cu, a block reduces one row x W-chunk (8192 words)
//    with a warp-shuffle popcount reduction and one atomicAdd; the TPU's
//    sequential W grid axis is a loop inside the block. Each leaf has its
//    own row stride and row count (row r reads row r mod rows), so a [W]
//    leaf is counted against every row of an [S, W] stack without being
//    materialised. The block computes its leaves' row addresses once.
//  * The result plane, when asked for, is written with 16-byte stores
//    from the registers that hold it: the one extra write a bitmap result
//    needs, and no more.
//  * shift_left: a thread per output word reads the two source words it
//    needs (the second is its neighbour's first, so the pair comes from
//    the same cache lines and HBM sees each word once) and writes one
//    word. Whole-word moves past the row's end give zeros.
//  * Rows whose start is not 16-byte aligned, or row strides that are not
//    a multiple of 4 words, take a scalar variant of tree_count.
//  * tree_count_batched is bound by the distinct leaf bytes of its wave,
//    not by the slots' leaf lists: slots of one wave share leaves (clients
//    that segment against a common row all push it). The first design, a
//    grid axis over slots with each block loading its own slot's leaves,
//    read a plane two slots share twice, a whole slot's pass apart, long
//    after the 50 MB L2 had let it go (8 slots x 3 leaves over 15 distinct
//    planes read 24); and it evaluated the tape on tree_count's register
//    stack, whose slot switches cost more instructions per 16 bytes than
//    the card can issue while HBM streams, so it ran at half its bound.
//    Now the wrapper reduces the wave's leaf records to a table of
//    distinct leaves (keyed on base, row stride and rows), splits the
//    slots into groups whose distinct leaves fit a block's shared-memory
//    ring, and sends per slot a map from its tape's leaves to its group's.
//    A block owns one (row, W chunk, group): one producer thread copies,
//    tile by tile, each distinct leaf's words of the tile into a
//    shared-memory stage with a 1-D cp.async.bulk (a leaf row is
//    contiguous: no tensor map), signalled on the stage's "full" mbarrier;
//    eight consumer warps run every slot of the group from shared memory
//    (16 bytes a thread, conflict-free) and release the stage on its
//    "empty" mbarrier, which the producer waits for before it refills the
//    stage. A ring of stages keeps the next tiles' copies in flight while
//    one is evaluated. So HBM sees each distinct leaf plane of a group
//    once by construction, and the groups of one row are neighbours in
//    the grid, so a leaf two groups share comes from L2. The consumers run
//    the tape as an accumulator program compiled on the host (AccProgram):
//    the top of the stack in one register, the values below it in the
//    warp's shared scratch, each op branch-free on masks (OpMasks); the
//    planner's chains (Intersect / Union of leaves) need no scratch at
//    all. Each warp sums its slot's popcounts by shuffle only when its
//    slot changes, and each (row, slot) gets one atomicAdd per block. The
//    program stays in the parameter block (it is the same for every
//    slot); the tables travel in device memory, copied on the launch's
//    stream just before it: 32 slots x 16 leaves would not fit the 4 KiB
//    parameter limit.
//  * Waves whose leaves are not all 16-byte aligned, or whose width is not
//    a multiple of 4 words, take a body with plain 4-byte loads over the
//    same tables: a block runs its group's slots one after another, and a
//    word two of them share is read again from L1 or L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunkWords = 8192;
constexpr int64_t kMaxGridY = 65535;

// Kernel limits; ops/kernels.py cuts longer or deeper tapes into sub-tapes.
constexpr int kMaxLeaves = 16;
constexpr int kMaxOps = 64;
constexpr int kMaxStack = 8;

// Instruction codes (low 4 bits); bits 4-7 hold the stack slot, bits 8+ the
// leaf of a push.
enum Code { PUSH = 0, AND = 1, OR = 2, XOR = 3, ANDNOT = 4 };

struct TreeArgs {
  const uint32_t* leaf[kMaxLeaves];
  int64_t stride[kMaxLeaves];
  int64_t rows[kMaxLeaves];
  int32_t tape[kMaxOps];
  int32_t n_ops;
  int32_t n_leaves;
};

__device__ __forceinline__ uint32_t apply(int code, uint32_t a, uint32_t b) {
  switch (code) {
    case AND: return a & b;
    case OR: return a | b;
    case XOR: return a ^ b;
    default: return a & ~b;  // ANDNOT
  }
}

__device__ __forceinline__ uint4 apply(int code, const uint4& a, const uint4& b) {
  return make_uint4(apply(code, a.x, b.x), apply(code, a.y, b.y),
                    apply(code, a.z, b.z), apply(code, a.w, b.w));
}

__device__ __forceinline__ int popc(uint32_t v) { return __popc(v); }
__device__ __forceinline__ int popc(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

template <typename V>
__device__ __forceinline__ V load(const uint32_t* row, int64_t i) {
  if constexpr (sizeof(V) == 16)
    return __ldg(reinterpret_cast<const uint4*>(row) + i);
  else
    return __ldg(row + i);
}

template <typename V>
__device__ __forceinline__ void store(uint32_t* row, int64_t i, const V& v) {
  if constexpr (sizeof(V) == 16)
    reinterpret_cast<uint4*>(row)[i] = v;
  else
    row[i] = v;
}

// Slot D of the stack, by name: every index below is a constant, so the
// stack stays in registers.
#define SLOT_CASES(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

template <typename V>
struct Stack {
  V s0, s1, s2, s3, s4, s5, s6, s7;

  __device__ __forceinline__ void set(int d, const V& v) {
    switch (d) {
#define SET_CASE(k) case k: s##k = v; break;
      SLOT_CASES(SET_CASE)
#undef SET_CASE
    }
  }

  // slot d = op(slot d, slot d + 1)
  __device__ __forceinline__ void combine(int d, int code) {
    switch (d) {
      case 0: s0 = apply(code, s0, s1); break;
      case 1: s1 = apply(code, s1, s2); break;
      case 2: s2 = apply(code, s2, s3); break;
      case 3: s3 = apply(code, s3, s4); break;
      case 4: s4 = apply(code, s4, s5); break;
      case 5: s5 = apply(code, s5, s6); break;
      default: s6 = apply(code, s6, s7); break;
    }
  }
};

// Sum of `acc` over the block, valid in thread 0.
__device__ __forceinline__ int block_sum(int acc, int* warp_sums) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// grid = (rows, chunks). out[row] += popcount(tree(leaves at row)) over the
// block's chunk; with WRITE, plane[row, chunk] = tree(leaves at row).
// V is uint4 (16-byte loads; every leaf row 16-byte aligned, chunk a
// multiple of 4 words, words a multiple of 4) or uint32_t.
template <typename V, bool WRITE>
__global__ void __launch_bounds__(kThreads)
tree_count_kernel(const __grid_constant__ TreeArgs args, int* __restrict__ out,
                  uint32_t* __restrict__ plane, int64_t words, int64_t chunk,
                  int accumulate) {
  constexpr int64_t kPer = sizeof(V) / 4;  // words per element
  const int64_t row = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t hi = lo + chunk < words ? lo + chunk : words;
  __shared__ const uint32_t* base[kMaxLeaves];
  __shared__ int warp_sums[kThreads / 32];
  if (threadIdx.x < args.n_leaves) {
    const int l = threadIdx.x;
    base[l] = args.leaf[l] + (row % args.rows[l]) * args.stride[l] + lo;
  }
  __syncthreads();
  uint32_t* dst = WRITE ? plane + row * words + lo : nullptr;
  const int64_t n = (hi - lo) / kPer;
  const int n_ops = args.n_ops;
  int acc = 0;
  Stack<V> st;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    for (int t = 0; t < n_ops; ++t) {
      const int ins = args.tape[t];
      const int code = ins & 15;
      const int d = (ins >> 4) & 15;
      if (code == PUSH)
        st.set(d, load<V>(base[ins >> 8], i));
      else
        st.combine(d, code);
    }
    acc += popc(st.s0);
    if (WRITE) store<V>(dst, i, st.s0);
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    if (accumulate)
      atomicAdd(out + row, acc);
    else
      out[row] = acc;
  }
}

template <typename V>
int launch_tree(const TreeArgs& args, int* out, uint32_t* plane, int64_t rows,
                int64_t words, cudaStream_t stream) {
  int64_t chunk = kChunkWords;
  int64_t chunks = (words + chunk - 1) / chunk;
  if (chunks > kMaxGridY) {
    chunk = ((words + kMaxGridY - 1) / kMaxGridY + 3) & ~int64_t(3);
    chunks = (words + chunk - 1) / chunk;
  }
  const int accumulate = chunks > 1;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  if (plane != nullptr)
    tree_count_kernel<V, true><<<grid, kThreads, 0, stream>>>(
        args, out, plane, words, chunk, accumulate);
  else
    tree_count_kernel<V, false><<<grid, kThreads, 0, stream>>>(
        args, out, plane, words, chunk, accumulate);
  return static_cast<int>(cudaGetLastError());
}

// -- tree_count_batched ------------------------------------------------------

// The staged body's ring: kStages stages in kStageBytes of shared memory
// (three such blocks fit an SM), each holding a tile of kMinTile to
// kMaxTile words (multiples of 128) of every leaf of the block's group,
// over kBatchChunkWords words of a row per block; chosen by a sweep on an
// H100 (PERF.md). A group stages at most kMaxGroupLeaves distinct leaves,
// as many as the ring holds at the narrowest tile, and holds at most
// kMaxGroupSlots slots; ops/kernels.py groups a wave's slots within both
// (TREE_BATCH_GROUP_LEAVES, TREE_BATCH_GROUP_SLOTS) and the launch checks.
constexpr int kStages = 2;
constexpr int64_t kStageBytes = 64 * 1024;
constexpr int kMinTile = 256;
constexpr int kMaxTile = 2048;
constexpr int64_t kBatchChunkWords = 4096;
constexpr int kMaxGroupLeaves = static_cast<int>(kStageBytes / (kStages * 4 * kMinTile));
static_assert(kMaxGroupLeaves == 32, "ops/kernels.py TREE_BATCH_GROUP_LEAVES");
constexpr int kMaxGroupSlots = 32;
constexpr int kMaxDevices = 64;
constexpr int kConsumerWarps = kThreads / 32;
constexpr int kBulkThreads = kThreads + 32;  // the consumers and one producer warp
// The most dynamic shared memory a staged launch asks for: the ring, and
// the consumer warps' scratch (32 lanes x 16 bytes a slot) at the deepest
// stack.
constexpr int64_t kMaxBulkSmem = kStageBytes + kMaxStack * kConsumerWarps * 32 * 16;

// The wave's tables in device memory, all int64, and the grid's shape:
//   recs[d * 3 + {0, 1, 2}]  distinct leaf d: base, row stride (words), rows
//   groups[g * 4 + {0..3}]   group g: slots [lo, hi), its leaves gleaves[lo, hi)
//   gleaves[i]               a group's leaf, as an index into recs
//   lmap[z * n_leaves + k]   tape leaf k of slot z, as an index into its
//                            group's leaves
struct BatchTables {
  const int64_t* recs;
  const int64_t* groups;
  const int64_t* gleaves;
  const int64_t* lmap;
  int64_t chunk;  // words of a row a block covers
  int64_t n_chunks;
  int n_groups;
};

// Block x of the grid is (row, group, chunk), the chunk fastest: the blocks
// of one row's chunks run side by side and stream its words in order, and
// the groups of one row are neighbours. Returns the block's row, its
// chunk's first word and width, its group's slot range and leaf count, and
// puts the group's leaf row bases at the chunk and its slots' maps into
// shared memory. No barrier: the caller syncs.
__device__ __forceinline__ void load_group(const BatchTables& tab, int n_leaves,
                                           int64_t words, int64_t* row, int64_t* lo,
                                           int64_t* span, int* slot_lo, int* n_slots,
                                           int* n_gl, const uint32_t** base,
                                           uint8_t* lmap) {
  const int64_t rest = blockIdx.x / tab.n_chunks;
  const int64_t g = rest % tab.n_groups;
  *row = rest / tab.n_groups;
  *lo = (blockIdx.x % tab.n_chunks) * tab.chunk;
  *span = (*lo + tab.chunk < words ? *lo + tab.chunk : words) - *lo;
  const int64_t* grp = tab.groups + g * 4;
  *slot_lo = static_cast<int>(grp[0]);
  *n_slots = static_cast<int>(grp[1] - grp[0]);
  *n_gl = static_cast<int>(grp[3] - grp[2]);
  for (int i = threadIdx.x; i < *n_gl; i += blockDim.x) {
    const int64_t* rec = tab.recs + tab.gleaves[grp[2] + i] * 3;
    base[i] = reinterpret_cast<const uint32_t*>(rec[0]) + (*row % rec[2]) * rec[1] + *lo;
  }
  const int n_map = *n_slots * n_leaves;
  for (int i = threadIdx.x; i < n_map; i += blockDim.x)
    lmap[i] = static_cast<uint8_t>(tab.lmap[static_cast<int64_t>(*slot_lo) * n_leaves + i]);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The slot's count over the block's chunk into out[(slot_lo + z) * rows + row].
__device__ __forceinline__ void put_count(int* out, int64_t rows, int64_t row,
                                          int slot, int count, int accumulate) {
  int* dst = out + static_cast<int64_t>(slot) * rows + row;
  if (accumulate)
    atomicAdd(dst, count);
  else
    *dst = count;
}

// op(a, b) for the four tape ops without a branch or a select: with
// (p, q, r) all-ones or zero per op, (a & b & p) ^ (a & q) ^ (b & r) is
// a & b (1, 0, 0), a | b (1, 1, 1), a ^ b (0, 1, 1) or a & ~b (1, 1, 0).
struct OpMasks {
  uint32_t p, q, r;
  __device__ __forceinline__ explicit OpMasks(int code)
      : p(code == XOR ? 0u : ~0u), q(code == AND ? 0u : ~0u),
        r(code == OR || code == XOR ? ~0u : 0u) {}
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return (a & b & p) ^ (a & q) ^ (b & r);
  }
  __device__ __forceinline__ uint4 operator()(const uint4& a, const uint4& b) const {
    return make_uint4((*this)(a.x, b.x), (*this)(a.y, b.y), (*this)(a.z, b.z),
                      (*this)(a.w, b.w));
  }
};

// The staged body runs a tape as an accumulator program: one register
// holds the top of the stack, and the values below it, when there are any,
// lie in the warp's scratch slots in shared memory (32 lanes x 16 bytes
// each). Steps (kind in bits 0-1, op in 2-4, leaf in 8-15, slot in 16-19):
//   LOAD leaf            acc = leaf                   (the first step)
//   APPLY op leaf        acc = op(acc, leaf)          (a push and its op)
//   SPILL_LOAD k leaf    slot k = acc; acc = leaf     (a push onto a value)
//   APPLY_S op k         acc = op(slot k, acc)        (an op of two values)
// A linear tape (the planner's Intersect / Union / Xor / Difference chains
// over leaves) is LOAD and APPLYs only, and needs no slot.
enum Step { LOAD = 0, APPLY = 1, SPILL_LOAD = 2, APPLY_S = 3 };

struct AccProgram {
  int32_t step[kMaxOps];
  int32_t n_steps;
  int32_t n_leaves;
  int32_t n_slots;  // scratch slots a warp needs
};

// The program of a tape load_tape accepted.
AccProgram compile_program(const TreeArgs& args) {
  AccProgram prog = {};
  prog.n_leaves = args.n_leaves;
  int depth = 0;
  for (int t = 0; t < args.n_ops; ++t) {
    const int ins = args.tape[t];
    int step;
    if ((ins & 15) != PUSH) {  // an op of the two values on top
      step = APPLY_S | ((ins & 15) << 2) | ((depth - 2) << 16);
      --depth;
    } else if (depth == 0) {
      step = LOAD | ((ins >> 8) << 8);
      ++depth;
    } else if (t + 1 < args.n_ops && (args.tape[t + 1] & 15) != PUSH) {
      step = APPLY | ((args.tape[t + 1] & 15) << 2) | ((ins >> 8) << 8);
      ++t;  // the op is done
    } else {
      step = SPILL_LOAD | ((ins >> 8) << 8) | ((depth - 1) << 16);
      if (depth > prog.n_slots) prog.n_slots = depth;
      ++depth;
    }
    prog.step[prog.n_steps++] = step;
  }
  return prog;
}

// grid = rows * n_groups * chunks (load_group), kBulkThreads threads; dynamic shared
// memory: kStages stages of max_gl x tile words, then the consumer warps'
// scratch slots. Block (row, g) stages tile after tile of its chunk: stage
// s holds the group's leaf l at words [l * tile, (l + 1) * tile). tile is a
// multiple of 128 words, so a warp's 32 16-byte loads lie in one slot's
// tile; every leaf row 16-byte aligned, words a multiple of 4. SPILLS: the
// program has SPILL_LOAD and APPLY_S steps; else it is LOAD, then APPLYs.
template <bool SPILLS>
__global__ void __launch_bounds__(kBulkThreads)
tree_batched_bulk_kernel(const __grid_constant__ AccProgram prog, const BatchTables tab,
                         int* __restrict__ out, int64_t rows, int64_t words, int tile,
                         int max_gl, int accumulate) {
  extern __shared__ __align__(128) uint4 stage_mem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ const uint32_t* base[kMaxGroupLeaves];
  __shared__ uint8_t lmap[kMaxGroupSlots * kMaxLeaves];
  __shared__ int slot_count[kMaxGroupSlots];
  int64_t row, lo, span;
  int slot_lo, n_slots, n_gl;
  load_group(tab, prog.n_leaves, words, &row, &lo, &span, &slot_lo, &n_slots, &n_gl, base,
             lmap);
  if (threadIdx.x < n_slots) slot_count[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = static_cast<int>((span + tile - 1) / tile);
  const int64_t stage_vecs = static_cast<int64_t>(max_gl) * tile / 4;
  const int tile_vecs = tile / 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        const int64_t off = static_cast<int64_t>(t) * tile;
        const uint32_t bytes =
            static_cast<uint32_t>((span - off < tile ? span - off : tile) * 4);
        mbar_expect_tx(&full[s], bytes * n_gl);
        uint4* dst = stage_mem + s * stage_vecs;
        for (int l = 0; l < n_gl; ++l)
          bulk_load(dst + l * tile_vecs, base[l] + off, bytes, &full[s]);
      }
    }
    return;
  }

  // The consumers. A tile's tasks are (slot, 32 16-byte elements of each
  // leaf), slot-major, per_slot to a slot; warp w takes a contiguous run of
  // them, so its slot changes at most a few times a tile, and it carries
  // its lanes' count of the current slot in a register, summing it by warp
  // shuffle into slot_count only when the slot changes.
  uint4* scratch = stage_mem + kStages * stage_vecs + warp * prog.n_slots * 32 + lane;
  int cur = -1, pop = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int64_t off = static_cast<int64_t>(t) * tile;
    const int n4 = static_cast<int>((span - off < tile ? span - off : tile) / 4);
    const int per_slot = (n4 + 31) / 32;
    const int n_tasks = n_slots * per_slot;
    const int run = (n_tasks + kConsumerWarps - 1) / kConsumerWarps;
    const int k_end = (warp + 1) * run < n_tasks ? (warp + 1) * run : n_tasks;
    const uint4* st = stage_mem + s * stage_vecs;
    mbar_wait(&full[s], (t / kStages) & 1);
    for (int k = warp * run; k < k_end; ++k) {
      const int z = k / per_slot;
      if (z != cur) {
        if (cur >= 0) {
          pop = warp_sum(pop);
          if (lane == 0) atomicAdd(&slot_count[cur], pop);
        }
        cur = z;
        pop = 0;
      }
      const int j = (k - z * per_slot) * 32 + lane;
      if (j >= n4) continue;
      const uint8_t* zmap = lmap + z * prog.n_leaves;
      // leaf (from the step's bits 8-15) of this slot at this element
      auto leaf = [&](int step) { return st[zmap[(step >> 8) & 255] * tile_vecs + j]; };
      uint4 acc = leaf(prog.step[0]);
      for (int i = 1; i < prog.n_steps; ++i) {
        const int step = prog.step[i];
        const OpMasks op((step >> 2) & 7);
        if (!SPILLS || (step & 3) == APPLY) {
          acc = op(acc, leaf(step));
        } else {
          uint4* slot = scratch + ((step >> 16) & 15) * 32;
          if ((step & 3) == APPLY_S) {
            acc = op(*slot, acc);
          } else {  // SPILL_LOAD
            *slot = acc;
            acc = leaf(step);
          }
        }
      }
      pop += popc(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (cur >= 0) {
    pop = warp_sum(pop);
    if (lane == 0) atomicAdd(&slot_count[cur], pop);
  }
  // Every consumer warp's counts are in: a barrier of the consumers alone
  // (the producer warp has left).
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  if (threadIdx.x < n_slots)
    put_count(out, rows, row, slot_lo + threadIdx.x, slot_count[threadIdx.x], accumulate);
}

// grid = rows * n_groups * chunks, kThreads threads: the same tables with
// plain 4-byte loads from global memory, the group's slots one after
// another; for rows that are not 16-byte aligned or widths that are not a
// multiple of 4 words.
__global__ void __launch_bounds__(kThreads)
tree_batched_scalar_kernel(const __grid_constant__ TreeArgs args, const BatchTables tab,
                           int* __restrict__ out, int64_t rows, int64_t words,
                           int accumulate) {
  __shared__ const uint32_t* base[kMaxGroupLeaves];
  __shared__ uint8_t lmap[kMaxGroupSlots * kMaxLeaves];
  __shared__ int warp_sums[kThreads / 32];
  int64_t row, lo, n;
  int slot_lo, n_slots, n_gl;
  load_group(tab, args.n_leaves, words, &row, &lo, &n, &slot_lo, &n_slots, &n_gl, base,
             lmap);
  __syncthreads();
  const int n_ops = args.n_ops;
  for (int z = 0; z < n_slots; ++z) {
    const uint8_t* zmap = lmap + z * args.n_leaves;
    int acc = 0;
    Stack<uint32_t> st;
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      for (int t = 0; t < n_ops; ++t) {
        const int ins = args.tape[t];
        const int code = ins & 15;
        const int d = (ins >> 4) & 15;
        if (code == PUSH)
          st.set(d, __ldg(base[zmap[ins >> 8]] + i));
        else
          st.combine(d, code);
      }
      acc += popc(st.s0);
    }
    acc = block_sum(acc, warp_sums);
    if (threadIdx.x == 0) put_count(out, rows, row, slot_lo + z, acc, accumulate);
    __syncthreads();  // warp_sums is reused by the next slot
  }
}

// The tape checks of both tree entries: instructions in range, the stack
// discipline the wrapper compiles to, one value left. Copies the tape
// into args.
bool load_tape(TreeArgs* args, const int32_t* tape, int n_ops, int n_leaves) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_ops < 1 || n_ops > kMaxOps)
    return false;
  int depth = 0;
  for (int t = 0; t < n_ops; ++t) {
    const int code = tape[t] & 15;
    const int d = (tape[t] >> 4) & 15;
    if (code == PUSH) {
      if ((tape[t] >> 8) >= n_leaves || d != depth || d >= kMaxStack) return false;
      ++depth;
    } else {
      if (code > ANDNOT || d != depth - 2) return false;
      --depth;
    }
    args->tape[t] = tape[t];
  }
  args->n_ops = n_ops;
  args->n_leaves = n_leaves;
  return depth == 1;
}

// grid = (ceil(words / (kThreads * kShiftPer)), min(rows, kMaxGridY)).
// out[r, w] = (in[r, w - q] << b) | (in[r, w - q - 1] >> (32 - b)), each
// term 0 where its source word lies before the row's start.
constexpr int kShiftPer = 4;

__global__ void __launch_bounds__(kThreads)
shift_left_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int64_t rows, int64_t words, int64_t in_stride, int64_t q,
                  int b) {
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t* src = in + row * in_stride;
    uint32_t* dst = out + row * words;
    const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kThreads * kShiftPer;
#pragma unroll
    for (int k = 0; k < kShiftPer; ++k) {
      const int64_t w = w0 + k * kThreads + threadIdx.x;
      if (w >= words) break;
      const int64_t s = w - q;
      uint32_t v = 0;
      if (s >= 0) {
        v = __ldg(src + s) << b;
        if (b != 0 && s >= 1) v |= __ldg(src + s - 1) >> (32 - b);
      }
      dst[w] = v;
    }
  }
}

}  // namespace

// counts[r] = popcount(tree(r)) for r in [0, rows), and plane[r] = tree(r)
// when plane is not null (rows x words, contiguous). Leaf i row j starts at
// leaves[i] + (j % leaf_rows[i]) * strides[i] words. tape holds n_ops
// compiled instructions (see the Code enum); the tree's result is stack
// slot 0. counts must hold `rows` int32 zeros. vec: every leaf row start is
// 16-byte aligned and words is a multiple of 4. Returns cudaGetLastError()
// after the launch.
extern "C" int pilosa_tree_count(const void* const* leaves, const int64_t* strides,
                                 const int64_t* leaf_rows, int n_leaves,
                                 const int32_t* tape, int n_ops, void* counts,
                                 void* plane, int64_t rows, int64_t words,
                                 int vec, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TreeArgs args = {};
  if (!load_tape(&args, tape, n_ops, n_leaves))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_leaves; ++i) {
    if (leaf_rows[i] <= 0 || rows % leaf_rows[i])
      return static_cast<int>(cudaErrorInvalidValue);
    args.leaf[i] = static_cast<const uint32_t*>(leaves[i]);
    args.stride[i] = strides[i];
    args.rows[i] = leaf_rows[i];
  }
  auto* out = static_cast<int*>(counts);
  auto* dst = static_cast<uint32_t*>(plane);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_tree<uint4>(args, out, dst, rows, words, s);
  return launch_tree<uint32_t>(args, out, dst, rows, words, s);
}

// One tape over n_slots slots' leaves in one launch: counts[z * rows + r] =
// popcount(tree(slot z's leaves at row r)). host_table holds the wave's
// tables (see BatchTables), in this order: n_recs distinct leaf records,
// n_groups groups, n_gleaves group leaves, n_slots * n_leaves map entries;
// the groups cover the slots in order. It is copied on `stream` into
// dev_table (room for the same bytes, allocated by the wrapper) before the
// kernel reads it. The tape is uniform across slots and travels in the
// parameter block as for pilosa_tree_count. counts must hold n_slots *
// rows int32 zeros. vec (every leaf row 16-byte aligned, words a multiple
// of 4) takes the bulk-copy body, its tile the widest at which kStages
// stages of the largest group's leaves fit kStageBytes (plus 4 KB of
// scratch per slot the tape's accumulator program spills to); else the
// body with plain loads. Returns the first CUDA error of the copy or the
// launch.
extern "C" int pilosa_tree_count_batched(const int64_t* host_table, void* dev_table,
                                         int n_recs, int n_groups, int n_gleaves,
                                         int n_slots, int n_leaves,
                                         const int32_t* tape, int n_ops,
                                         void* counts, int64_t rows, int64_t words,
                                         int vec, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (n_recs <= 0 || n_groups <= 0 || n_slots <= 0 || rows <= 0 || words <= 0 ||
      (vec && words % 4))
    return static_cast<int>(bad);
  TreeArgs args = {};
  if (!load_tape(&args, tape, n_ops, n_leaves)) return static_cast<int>(bad);
  const int64_t* recs = host_table;
  const int64_t* groups = recs + static_cast<int64_t>(n_recs) * 3;
  const int64_t* gleaves = groups + static_cast<int64_t>(n_groups) * 4;
  const int64_t* lmap = gleaves + n_gleaves;
  for (int d = 0; d < n_recs; ++d) {
    const int64_t leaf_rows = recs[d * 3 + 2];
    if (leaf_rows <= 0 || rows % leaf_rows) return static_cast<int>(bad);
  }
  // The groups cover the slots in order; each group's leaves and maps stay
  // in its own range and within the kernels' shared arrays.
  int max_gl = 0;
  for (int g = 0, next = 0; g < n_groups; ++g) {
    const int64_t* grp = groups + g * 4;
    const int64_t gs = grp[1] - grp[0], gl = grp[3] - grp[2];
    if (grp[0] != next || gs <= 0 || gs > kMaxGroupSlots || gl <= 0 ||
        gl > kMaxGroupLeaves || grp[2] < 0 || grp[3] > n_gleaves)
      return static_cast<int>(bad);
    next = static_cast<int>(grp[1]);
    if (g == n_groups - 1 && next != n_slots) return static_cast<int>(bad);
    for (int64_t i = grp[2]; i < grp[3]; ++i)
      if (gleaves[i] < 0 || gleaves[i] >= n_recs) return static_cast<int>(bad);
    for (int64_t i = grp[0] * n_leaves; i < grp[1] * n_leaves; ++i)
      if (lmap[i] < 0 || lmap[i] >= gl) return static_cast<int>(bad);
    if (gl > max_gl) max_gl = static_cast<int>(gl);
  }
  int tile = 0;
  if (vec) {
    tile = static_cast<int>(kStageBytes / (kStages * 4 * max_gl) / 128 * 128);
    if (tile > kMaxTile) tile = kMaxTile;
  }
  // A block's chunk: whole tiles (or 16-byte elements).
  const int64_t unit = tile > 0 ? tile : 4;
  const int64_t chunk = (kBatchChunkWords + unit - 1) / unit * unit;
  const int64_t n_chunks = (words + chunk - 1) / chunk;
  if (rows * n_groups > 0x7fffffffLL / n_chunks) return static_cast<int>(bad);
  const AccProgram prog = compile_program(args);
  const int64_t dyn_smem = static_cast<int64_t>(kStages) * max_gl * tile * 4 +
                           static_cast<int64_t>(prog.n_slots) * kConsumerWarps * 32 * 16;
  if (dyn_smem > kMaxBulkSmem) return static_cast<int>(bad);
  auto s = static_cast<cudaStream_t>(stream);
  // A pageable source: the copy returns once the table is staged.
  const int64_t n_table = static_cast<int64_t>(n_recs) * 3 + n_groups * 4 + n_gleaves +
                          static_cast<int64_t>(n_slots) * n_leaves;
  cudaError_t err = cudaMemcpyAsync(dev_table, host_table, n_table * sizeof(int64_t),
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* dev = static_cast<const int64_t*>(dev_table);
  BatchTables tab;
  tab.recs = dev;
  tab.groups = dev + (groups - host_table);
  tab.gleaves = dev + (gleaves - host_table);
  tab.lmap = dev + (lmap - host_table);
  tab.chunk = chunk;
  tab.n_chunks = n_chunks;
  tab.n_groups = n_groups;
  auto* out = static_cast<int*>(counts);
  const int accumulate = n_chunks > 1;
  const dim3 grid(static_cast<unsigned>(rows * n_groups * n_chunks));
  if (tile == 0) {
    tree_batched_scalar_kernel<<<grid, kThreads, 0, s>>>(args, tab, out, rows, words,
                                                        accumulate);
    return static_cast<int>(cudaGetLastError());
  }
  const bool spills = prog.n_slots > 0;
  auto* kernel = spills ? &tree_batched_bulk_kernel<true> : &tree_batched_bulk_kernel<false>;
  // Once per device and variant: allow the largest dynamic shared memory
  // any launch may ask for (past 48 KB it must be allowed first; a value
  // set once is never lowered under another thread's launch), and ask for
  // the largest shared-memory carveout, so how many blocks share an SM
  // depends on their request alone, not on the kernels around it.
  {
    static std::mutex mu;
    static bool ready[kMaxDevices][2] = {};
    int dev_id = 0;
    err = cudaGetDevice(&dev_id);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev_id < 0 || dev_id >= kMaxDevices) return static_cast<int>(bad);
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev_id][spills]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxBulkSmem));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready[dev_id][spills] = true;
    }
  }
  kernel<<<grid, kBulkThreads, dyn_smem, s>>>(prog, tab, out, rows, words, tile, max_gl,
                                               accumulate);
  return static_cast<int>(cudaGetLastError());
}

// out[r] = in[r] shifted left by n = 32 q + b bits (0 <= b < 32), for r in
// [0, rows); row r of in starts at in + r * in_stride words, out is rows x
// words contiguous. Returns cudaGetLastError() after the launch.
extern "C" int pilosa_shift_left(const void* in, void* out, int64_t rows,
                                 int64_t words, int64_t in_stride, int64_t q,
                                 int b, void* stream) {
  if (rows <= 0 || words <= 0 || q < 0 || b < 0 || b > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = kThreads * kShiftPer;
  const int64_t bx = (words + per_block - 1) / per_block;
  if (bx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bx),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  shift_left_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows, words,
      in_stride, q, b);
  return static_cast<int>(cudaGetLastError());
}
