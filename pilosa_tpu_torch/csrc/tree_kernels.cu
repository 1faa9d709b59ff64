// Bitmap-tree kernels of pilosa_tpu_torch, hand-written for Hopper (sm_90a).
//
// Two entry points with a plain C interface, loaded with ctypes by
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
//     launch (counts only)
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
//  * The batched tree entry keeps the tape in the parameter block (it is
//    the same for every slot) and reads each slot's leaf bases, strides
//    and row counts from a table in device memory, copied on the launch's
//    stream just before it: 16 leaves x 32 slots of records would not fit
//    the 4 KiB parameter limit. Each block reads its slot's records once,
//    then runs the single launch's body; the third grid axis runs over the
//    slots.

#include <cuda_runtime.h>
#include <stdint.h>

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
// BATCHED: grid.z runs over slots, and leaf l of slot z is the record
// table[(z * n_leaves + l) * 3 + {0, 1, 2}] = (base, row stride, rows)
// instead of args.leaf/stride/rows; slot z's counts land at out[z * rows].
template <typename V, bool WRITE, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
tree_count_kernel(const __grid_constant__ TreeArgs args,
                  const int64_t* __restrict__ table, int* __restrict__ out,
                  uint32_t* __restrict__ plane, int64_t rows, int64_t words,
                  int64_t chunk, int accumulate) {
  constexpr int64_t kPer = sizeof(V) / 4;  // words per element
  const int64_t row = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t hi = lo + chunk < words ? lo + chunk : words;
  __shared__ const uint32_t* base[kMaxLeaves];
  __shared__ int warp_sums[kThreads / 32];
  if (threadIdx.x < args.n_leaves) {
    const int l = threadIdx.x;
    if (BATCHED) {
      const int64_t* rec =
          table + (static_cast<int64_t>(blockIdx.z) * args.n_leaves + l) * 3;
      base[l] = reinterpret_cast<const uint32_t*>(rec[0]) + (row % rec[2]) * rec[1] + lo;
    } else {
      base[l] = args.leaf[l] + (row % args.rows[l]) * args.stride[l] + lo;
    }
  }
  if (BATCHED) out += static_cast<int64_t>(blockIdx.z) * rows;
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

// n_slots > 0 launches the batched kernel over `table` (no plane).
template <typename V>
int launch_tree(const TreeArgs& args, const int64_t* table, int n_slots, int* out,
                uint32_t* plane, int64_t rows, int64_t words, cudaStream_t stream) {
  int64_t chunk = kChunkWords;
  int64_t chunks = (words + chunk - 1) / chunk;
  if (chunks > kMaxGridY) {
    chunk = ((words + kMaxGridY - 1) / kMaxGridY + 3) & ~int64_t(3);
    chunks = (words + chunk - 1) / chunk;
  }
  const int accumulate = chunks > 1;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks),
                  static_cast<unsigned>(n_slots > 0 ? n_slots : 1));
  if (n_slots > 0)
    tree_count_kernel<V, false, true><<<grid, kThreads, 0, stream>>>(
        args, table, out, nullptr, rows, words, chunk, accumulate);
  else if (plane != nullptr)
    tree_count_kernel<V, true, false><<<grid, kThreads, 0, stream>>>(
        args, nullptr, out, plane, rows, words, chunk, accumulate);
  else
    tree_count_kernel<V, false, false><<<grid, kThreads, 0, stream>>>(
        args, nullptr, out, plane, rows, words, chunk, accumulate);
  return static_cast<int>(cudaGetLastError());
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
  if (vec) return launch_tree<uint4>(args, nullptr, 0, out, dst, rows, words, s);
  return launch_tree<uint32_t>(args, nullptr, 0, out, dst, rows, words, s);
}

// One tape over n_slots leaf tables in one launch: counts[z * rows + r] =
// popcount(tree(slot z's leaves at row r)). host_table holds n_slots *
// n_leaves records of three int64 (leaf base, row stride in words, rows),
// slot-major; it is copied on `stream` into dev_table (room for the same
// bytes, allocated by the wrapper) before the kernel reads it. The tape
// is uniform across slots and travels in the parameter block as for
// pilosa_tree_count. counts must hold n_slots * rows int32 zeros. vec:
// every leaf row start of every slot 16-byte aligned, words a multiple of
// 4. Returns the first CUDA error of the copy or the launch.
extern "C" int pilosa_tree_count_batched(const int64_t* host_table, void* dev_table,
                                         int n_slots, int n_leaves,
                                         const int32_t* tape, int n_ops,
                                         void* counts, int64_t rows,
                                         int64_t words, int vec, void* stream) {
  if (n_slots <= 0 || n_slots > kMaxGridY || rows <= 0 || rows > 0x7fffffffLL ||
      words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TreeArgs args = {};
  if (!load_tape(&args, tape, n_ops, n_leaves))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t records = static_cast<int64_t>(n_slots) * n_leaves;
  for (int64_t i = 0; i < records; ++i) {
    const int64_t leaf_rows = host_table[i * 3 + 2];
    if (leaf_rows <= 0 || rows % leaf_rows)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  // A pageable source: the copy returns once the table is staged.
  cudaError_t err = cudaMemcpyAsync(dev_table, host_table,
                                    records * 3 * sizeof(int64_t),
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* table = static_cast<const int64_t*>(dev_table);
  auto* out = static_cast<int*>(counts);
  if (vec) return launch_tree<uint4>(args, table, n_slots, out, nullptr, rows, words, s);
  return launch_tree<uint32_t>(args, table, n_slots, out, nullptr, rows, words, s);
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
