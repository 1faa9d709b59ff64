#!/usr/bin/env python3
"""Timed forms of the port's hll_reduce kernel.

    python3 scripts/sketch_probe.py [FORM ...]

Run on a machine with one NVIDIA GPU and nvcc, from the root of a
checkout (about a minute of command). It compiles forms of
``pilosa_tpu_torch/csrc/sketch_kernels.cu`` (text edits of a copy, under
``build/sketch_probe/``), loads each in place of the package's library,
holds ``kernels.hll_reduce`` exactly to its plain version, and times it at
``[1024, 2^12]`` (the keys phase's register stack), ``[1024, 2^16]`` and
``[1, 2^12]`` with ``chip_smoke.py``'s timer (CUDA events after a device
spin), in alternating rounds. The forms:

- ``kernel``: the source as it is (``reduce_shape``: the band and the
  block from m, S and the SMs);
- ``first``: the first form, for reference (a 32-word band and 32 warps a
  block, 4-byte loads);
- ``band8``, ``band16``, ``band32``: the band a block owns fixed at 8,
  16 or 32 words (128, 64 and 32 blocks at 2^12);
- ``t256``, ``t512``: 256 or 512 threads a block for every band;
  ``no_warp``: no one-warp block for few rows; ``no_few``: no 32-word
  band for ``kFewRows`` rows or fewer; ``loads4``, ``loads16``:
  other loads a thread in flight than ``kReduceLoads``;
- ``split{J}_band{B}``: the shard axis cut into J bands of rows, one block
  each per band of B words, folded in one launch: each block stores its
  partial maxima, takes a ticket, and the last block of a column band
  folds the J partials and writes the output (tickets and partials in
  static device memory, reset by the last block: right on one stream,
  which is all this script runs);
- ``cluster{J}_band{B}``: the same cut, the J blocks of a column band one
  thread-block cluster, the partials folded by the cluster's first block
  from the others' shared memory after a cluster barrier.

Besides: ``torch.zeros`` of 1024 int32, the least time one launch takes
under the same timer. Prints one JSON object per case and form, then the
card's name and power limit.

Its forms are text edits of lines of the kernel source, and it raises
where such a line is gone: when ``sketch_kernels.cu`` changes, rewrite the
forms for the new source or delete this script, rather than grow it into
a general harness.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROUNDS = 4
CSRC = ROOT / "pilosa_tpu_torch" / "csrc"
OUT_DIR = ROOT / "build" / "sketch_probe"
#: (rows, log2 m) of the timed register stacks.
CASES = ((1024, 12), (1024, 16), (1, 12))

BAND = ("  int vecs = 8;\n"
        "  while (rows > kFewRows && vecs > 2 && row_vecs / vecs < device_sms()) vecs >>= 1;")
THREADS = ("  const int threads = rows * vecs <= 32 ? 32 : (vecs == 8 && rows * vecs > 256 ? 512 "
           ": 256);")
LAUNCH_START = "  switch (shape.vecs) {"
LAUNCH_END = "  return static_cast<int>(cudaGetLastError());\n}\n\n// cube"

#: the split and cluster forms: kernels appended to the source, launched in
#: place of the source's switch. PARTS and VECS are filled in per form.
SPLIT = r'''
__device__ unsigned int g_tickets[1 << 14];
__device__ uint4 g_parts[PARTS << 14];

template <int kVecs, int kParts>
__global__ void __launch_bounds__(256)
    hll_reduce_split(const uint4* __restrict__ regs, uint4* __restrict__ out, int64_t rows,
                     int64_t row_vecs) {
  __shared__ bool last;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kVecs + threadIdx.x % kVecs;
  const int64_t chunk = (rows + kParts - 1) / kParts;
  const int64_t lo = blockIdx.y * chunk;
  const int64_t n = rows - lo < chunk ? rows - lo : chunk;
  const uint4 m = band_max<kVecs, 256>(regs + (n > 0 ? lo : 0) * row_vecs, n > 0 ? n : 0,
                                  row_vecs, col);
  if (threadIdx.x < kVecs && col < row_vecs) g_parts[blockIdx.y * row_vecs + col] = m;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&g_tickets[blockIdx.x], 1u) == kParts - 1;
    if (last) g_tickets[blockIdx.x] = 0u;
  }
  __syncthreads();
  if (last && threadIdx.x < kVecs && col < row_vecs) {
    __threadfence();
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < kParts; ++j) acc = vmax4(acc, __ldcg(&g_parts[j * row_vecs + col]));
    out[col] = acc;
  }
}
'''
SPLIT_LAUNCH = '''  {
    const dim3 g(static_cast<unsigned>((row_vecs + VECS - 1) / VECS), PARTS);
    hll_reduce_split<VECS, PARTS><<<g, 256, 0, s>>>(r, o, rows, row_vecs);
  }
'''
CLUSTER = r'''
template <int kVecs, int kParts>
__global__ void __cluster_dims__(1, kParts, 1) __launch_bounds__(256)
    hll_reduce_cluster(const uint4* __restrict__ regs, uint4* __restrict__ out, int64_t rows,
                       int64_t row_vecs) {
  namespace cg = cooperative_groups;
  __shared__ uint4 mine[kVecs];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kVecs + threadIdx.x % kVecs;
  const int64_t chunk = (rows + kParts - 1) / kParts;
  const int64_t lo = rank * chunk;
  const int64_t n = rows - lo < chunk ? rows - lo : chunk;
  const uint4 m = band_max<kVecs, 256>(regs + (n > 0 ? lo : 0) * row_vecs, n > 0 ? n : 0,
                                  row_vecs, col);
  if (threadIdx.x < kVecs) mine[threadIdx.x] = m;
  cluster.sync();
  if (rank == 0 && threadIdx.x < kVecs && col < row_vecs) {
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < kParts; ++j) acc = vmax4(acc, *cluster.map_shared_rank(mine + threadIdx.x, j));
    out[col] = acc;
  }
  cluster.sync();  // the first block's reads done before the others leave
}
'''
CLUSTER_LAUNCH = SPLIT_LAUNCH.replace("hll_reduce_split", "hll_reduce_cluster")
#: the first form, for reference: a block of 32 warps a 32-word band, lane
#: l word l, warp w rows w, w + 32, ..., 4-byte loads.
FIRST = r'''
__global__ void __launch_bounds__(1024)
    hll_reduce_first(const uint32_t* __restrict__ regs, unsigned int* __restrict__ out,
                    int64_t rows, int64_t row_words) {
  __shared__ unsigned int part[32][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  unsigned int acc = 0u;
  if (col < row_words) {
#pragma unroll 8
    for (int64_t r = warp; r < rows; r += 32)
      acc = __vmaxu4(acc, __ldg(regs + r * row_words + col));
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < row_words) {
    unsigned int m = 0u;
#pragma unroll
    for (int w = 0; w < 32; ++w) m = __vmaxu4(m, part[w][lane]);
    out[col] = m;
  }
}
'''
FIRST_LAUNCH = '''  hll_reduce_first<<<static_cast<unsigned>((row_vecs * 4 + 31) / 32), 1024, 0, s>>>(
      reinterpret_cast<const uint32_t*>(r), reinterpret_cast<unsigned int*>(o), rows,
      row_vecs * 4);
'''

def edit(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"sketch_kernels.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def relaunch(src: str, kernel: str, launch: str, vecs: int, parts: int) -> str:
    """The source with ``kernel`` appended before the entry points and
    ``launch`` in place of the band switch."""
    start, end = src.index(LAUNCH_START), src.index(LAUNCH_END)
    fill = {"VECS": str(vecs), "PARTS": str(parts)}
    for key, val in fill.items():
        kernel, launch = kernel.replace(key, val), launch.replace(key, val)
    src = src[:start] + launch + src[end:]
    anchor = "}  // namespace\n"
    return edit(src, (anchor, kernel + anchor))


def variants() -> dict:
    src = (CSRC / "sketch_kernels.cu").read_text()
    out = {"kernel": src, "first": relaunch(src, FIRST, FIRST_LAUNCH, 0, 0)}
    for vecs in (2, 4, 8):
        out[f"band{4 * vecs}"] = edit(src, (BAND, f"  int vecs = {vecs};"))
    out["t256"] = edit(src, (THREADS, "  const int threads = rows * vecs <= 32 ? 32 : 256;"))
    out["t512"] = edit(src, (THREADS, "  const int threads = rows * vecs <= 32 ? 32 : 512;"))
    out["no_warp"] = edit(src, (THREADS, "  const int threads = vecs == 8 ? 512 : 256;"))
    out["no_few"] = edit(src, ("constexpr int64_t kFewRows = 16;",
                               "constexpr int64_t kFewRows = 0;"))
    for n in (4, 16):
        out[f"loads{n}"] = edit(src, ("constexpr int kReduceLoads = 8;",
                                      f"constexpr int kReduceLoads = {n};"))
    for parts, band in ((4, 32), (8, 32), (2, 8), (4, 8)):
        out[f"split{parts}_band{band}"] = relaunch(src, SPLIT, SPLIT_LAUNCH, band // 4, parts)
    for parts, band in ((4, 32), (8, 32)):
        out[f"cluster{parts}_band{band}"] = "#include <cooperative_groups.h>\n" + relaunch(
            src, CLUSTER, CLUSTER_LAUNCH, band // 4, parts)
    return out


def build_all(srcs: dict) -> dict:
    from pilosa_tpu_torch.ops import build, kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(text)
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o",
                            str(so), str(cu)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
        return name, so

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(pool.map(one, srcs.items()))
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES["sketch_kernels.cu"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int32
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sketch_probe: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import kernels

    card = cs.card_line()
    forms = variants()
    libs = build_all({k: v for k, v in forms.items() if k in sys.argv[1:] or len(sys.argv) < 2})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cases = {}
    for rows, p in CASES:
        regs = torch.randint(0, 34, (rows, 1 << p), dtype=torch.uint8, device=dev,
                             generator=gen)
        cases[f"hll_reduce [{rows}, 2^{p}]"] = (lambda regs=regs: kernels.hll_reduce(regs),
                                                kernels.hll_reduce_plain(regs))
    for name, lib in libs.items():
        kernels._libs["sketch_kernels.cu"] = lib
        for case, (fn, want) in cases.items():
            for _ in range(2):  # twice: the split forms' tickets reset
                if not torch.equal(fn(), want):
                    raise AssertionError(f"{name}: {case} differs from the plain version")
    times: dict = {}
    order = list(libs)
    for r in range(ROUNDS):
        for name in order if r % 2 == 0 else order[::-1]:
            kernels._libs["sketch_kernels.cu"] = libs[name]
            for case, (fn, _) in cases.items():
                times.setdefault((case, name), []).append(
                    cs.time_cuda_ms(torch, fn, cs.KERNEL_RUNS))
    times[("floor", "torch.zeros(1024, int32)")] = [
        cs.time_cuda_ms(torch, lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
                        cs.KERNEL_RUNS) for _ in range(ROUNDS)]
    for (case, name), ms in times.items():
        print(json.dumps({"case": case, "variant": name, "ms": statistics.median(ms),
                          "runs": ms}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
