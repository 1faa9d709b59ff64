#!/usr/bin/env python3
"""Timed variants of the port's scatter_bits_grouped kernel.

    python3 scripts/reduce_probe.py

Run on a machine with one NVIDIA GPU and nvcc, from the root of a
checkout. It compiles variants of ``pilosa_tpu_torch/csrc/reduce_kernels.cu``
(text edits of a copy, under ``build/reduce_probe/``), loads each in place
of the package's library and times ``kernels.scatter_bits_grouped`` on
``chip_smoke.REDUCE_TIMED``'s legs (the 32-shard Row leg, a full shard, a
300-position leg), each uploaded as ``row_from_columns`` lays it out, with
chip_smoke's timer (CUDA events after a device spin), in alternating
rounds. The variants change one constant, or take one cost out, at a time:

- ``kernel``: the source as it is;
- ``cluster8``: clusters of 8 CTAs, the portable size, not 16;
- ``stages4``: a ring of 4 stages, not 2;
- ``threads128``, ``threads512``: CTAs of that many threads, not 256;
- ``batch4``: 4 loads of 32 positions a warp before any work, not 8;
- ``no_scatter``: the positions loaded but not scattered: the launch, the
  zeroed slabs, the bulk copies, both cluster barriers and the stores;
- ``bare``: the launch and the two cluster barriers alone.

Then the general ``scatter_bits`` on the same legs (its own layout) and
``torch.zeros`` of 1024 int32, the least time one launch takes under the
same timer. Every variant but ``no_scatter`` and ``bare`` is first held
exactly to the plain version. Prints one JSON object per leg and variant
(with the clusters of the variant the card runs at once), then the card's
name and power limit.

Its variants are text edits of lines of the kernel source, and it raises
where such a line is gone: when ``reduce_kernels.cu`` changes, rewrite the
variants for the new source or delete this script, rather than grow it
into a general harness.
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
OUT_DIR = ROOT / "build" / "reduce_probe"
#: variants that compute another function and are not checked.
UNCHECKED = ("no_scatter", "bare")
#: appended to each variant: the clusters of its kernel that run at once.
ACTIVE = """
extern "C" int probe_active_clusters(int64_t words, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute dim[1];
  dim[0].id = cudaLaunchAttributeClusterDimension;
  dim[0].val.clusterDim.x = kCluster;
  dim[0].val.clusterDim.y = 1;
  dim[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kGroupedThreads);
  cfg.dynamicSmemBytes = (words / kCluster) * 4 + kStages * kStageInts * 4;
  cfg.attrs = dim;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, scatter_bits_grouped_kernel, &cfg));
}
"""


def edit(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"reduce_kernels.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    scatter = "      scatter_warp(cluster, slab, rank, slab_shift, bits, p);"
    edge = "    if (valid) set_bit(cluster, slab, rank, slab_shift, bits, local[i]);"
    skip_scatter = ((scatter, "      if (n < 0) " + scatter.lstrip()),
                    (edge, edge.replace("valid", "valid && n < 0")))
    tiles = "  const int tiles = static_cast<int>((b - a + kStageInts - 1) / kStageInts);"
    zero = "    smem4[k] = make_uint4(0u, 0u, 0u, 0u);"
    store = ("for (int k = threadIdx.x; k < slab_words / 4; k += kGroupedThreads) "
             "dst[k] = smem4[k];")
    bare = (*skip_scatter, (tiles, tiles.replace("static_cast", "n >= 0 ? 0 : static_cast")),
            (zero, "    if (n < 0) " + zero.lstrip()), (store, "if (n < 0) " + store))
    return {
        "kernel": src,
        "cluster8": edit(src, ("constexpr int kCluster = 16;", "constexpr int kCluster = 8;")),
        "stages4": edit(src, ("constexpr int kStages = 2;", "constexpr int kStages = 4;")),
        "threads128": edit(src, ("constexpr int kGroupedThreads = 256;",
                                 "constexpr int kGroupedThreads = 128;")),
        "threads512": edit(src, ("constexpr int kGroupedThreads = 256;",
                                 "constexpr int kGroupedThreads = 512;")),
        "batch4": edit(src, ("constexpr int kBatch = 8;", "constexpr int kBatch = 4;")),
        "no_scatter": edit(src, *skip_scatter),
        "bare": edit(src, *bare),
    }


def build_all(srcs: dict) -> dict:
    from pilosa_tpu_torch.ops import build, kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(text + ACTIVE)
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
                            "-o", str(so), str(cu)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
        return name, so

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(pool.map(one, srcs.items()))
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES["reduce_kernels.cu"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int32
        lib.probe_active_clusters.argtypes = [ctypes.c_int64, ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("reduce_probe: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.exec import device_reduce
    from pilosa_tpu_torch.ops import kernels

    card = cs.card_line()
    libs = build_all(variants((ROOT / "pilosa_tpu_torch/csrc/reduce_kernels.cu").read_text()))
    dev = torch.device("cuda")
    legs, general = {}, {}
    for name in cs.REDUCE_TIMED[:-1]:
        cols = cs.reduce_leg(name)
        shards, buf, head = device_reduce.leg_buffer(cols)
        up = torch.from_numpy(buf).to(dev)
        st, loc = up[:len(shards) + 2], up[head:]
        legs[name] = (lambda st=st, loc=loc: kernels.scatter_bits_grouped(st, loc),
                      kernels.scatter_bits_grouped_plain(st, loc))
        seg = np.repeat(np.arange(len(shards), dtype=np.int32), np.diff(np.r_[buf[:len(shards)],
                                                                              len(cols)]))
        s, l, k = torch.from_numpy(seg).to(dev), loc.clone(), len(shards)
        general[name] = lambda s=s, l=l, k=k: kernels.scatter_bits(s, l, k)
        if not torch.equal(general[name](), legs[name][1]):
            raise AssertionError(f"scatter_bits: {name}: the image differs")
    for name in (n for n in libs if n not in UNCHECKED):
        kernels._libs["reduce_kernels.cu"] = libs[name]
        for leg, (fn, want) in legs.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: {leg}: the image differs from the plain version")
    times: dict = {}
    order = list(libs)
    for r in range(ROUNDS):
        for name in order if r % 2 == 0 else order[::-1]:
            kernels._libs["reduce_kernels.cu"] = libs[name]
            for leg, (fn, _) in legs.items():
                times.setdefault((leg, name), []).append(
                    cs.time_cuda_ms(torch, fn, cs.KERNEL_RUNS))
        for leg, fn in general.items():
            times.setdefault((leg, "general scatter_bits"), []).append(
                cs.time_cuda_ms(torch, fn, cs.KERNEL_RUNS))
        times.setdefault(("torch.zeros(1024, int32)", "-"), []).append(cs.time_cuda_ms(
            torch, lambda: torch.zeros(1024, dtype=torch.int32, device=dev), cs.KERNEL_RUNS))
    active = {}
    for name, lib in libs.items():
        n = ctypes.c_int()
        err = lib.probe_active_clusters(cs.SHARD_WORDS, ctypes.byref(n))
        active[name] = n.value if err == 0 else f"CUDA error {err}"
    for (leg, name), ms in times.items():
        print(json.dumps({"case": leg, "variant": name, "active_clusters": active.get(name),
                          "ms": statistics.median(ms), "runs": ms}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
