#!/usr/bin/env python3
"""Timed variants and plane-group sizes of the port's plane_scatter kernel.

    python3 scripts/plane_scatter_probe.py

Run on a machine with one NVIDIA GPU and nvcc, from the root of a
checkout. It compiles variants of ``pilosa_tpu_torch/csrc/ingest_kernels.cu``
(text edits of a copy, under ``build/plane_scatter_probe/``), loads each in
place of the package's library and times ``kernels.plane_scatter`` on
``chip_smoke.PLANE_SCATTER_TIMED`` (bench config 3's shard, a full shard,
depth 40) with its timer (CUDA events after a device spin), in alternating
rounds. The variants put one design back, or take one cost out, at a time:

- ``kernel``: the source as it is;
- ``cluster8``: clusters of 8 CTAs, the portable size, not 16;
- ``batch8``: 8 loads of 32 entries a warp before any work, not 4;
- ``no_scatter``: the entries neither read nor scattered: the launch, the
  zeroed slabs, both cluster barriers and the image's stores;
- ``no_stores``: that without the image's stores;
- ``bare``: that without the zeroing: the launch and the barriers;
- ``planes_1`` ... ``planes_28``: groups of that many planes, not as many
  groups as clusters run at once (each named with its clusters x planes
  at the case's depth).

Then each case's plain version and library call
(``chip_smoke.plane_scatter_library``), and ``torch.zeros`` of 1024 int32,
the least time one launch takes under the same timer. Every variant but
the three ``no_``/``bare`` ones, and the library call, is first held
exactly to the plain version. Prints one JSON object per case and
variant, then the card's name and power limit.

Its variants are text edits of lines of the kernel source, and it raises
where such a line is gone: when ``ingest_kernels.cu`` changes, rewrite the
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
OUT_DIR = ROOT / "build" / "plane_scatter_probe"
GROUP_PLANES = (1, 2, 3, 4, 6, 10, 14, 28)
#: variants that compute another function and are not checked.
UNCHECKED = ("no_scatter", "no_stores", "bare")


def edit(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"ingest_kernels.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    loop = "base < hi; base += step) {"
    stores = "      dst[j * (words / 4) + k] = slab4[j * vec + k];"
    zero = "    slab4[k] = make_uint4(0u, 0u, 0u, 0u);"
    skip_loop = (loop, "base < hi && m < 0; base += step) {")
    skip_stores = (stores, "      if (m < 0) " + stores.lstrip())
    skip_zero = (zero, "    if (m < 0) " + zero.lstrip())
    groups = "  int groups = clusters / pl.tiles;"
    return {
        "kernel": src,
        "cluster8": edit(src, ("constexpr int kCluster = 16;", "constexpr int kCluster = 8;")),
        "batch8": edit(src, ("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")),
        "no_scatter": edit(src, skip_loop),
        "no_stores": edit(src, skip_loop, skip_stores),
        "bare": edit(src, skip_loop, skip_stores, skip_zero),
        **{f"planes_{n}": edit(src, (groups, f"  int groups = (pl.planes + {n - 1}) / {n};"))
           for n in GROUP_PLANES},
    }


def build_all(srcs: dict) -> dict:
    from pilosa_tpu_torch.ops import build, kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(text)
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
        return name, so

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(pool.map(one, srcs.items()))
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES["ingest_kernels.cu"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int32
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("plane_scatter_probe: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import kernels

    card = cs.card_line()
    libs = build_all(variants((ROOT / "pilosa_tpu_torch/csrc/ingest_kernels.cu").read_text()))
    dev = torch.device("cuda")
    cases = {}
    for name in cs.PLANE_SCATTER_TIMED:
        pos, vals, depth = cs.plane_scatter_case(name)
        p, v = torch.from_numpy(pos).to(dev), torch.from_numpy(vals).to(dev)
        cases[name] = (depth, lambda p=p, v=v, d=depth: kernels.plane_scatter(p, v, d),
                       kernels.plane_scatter_plain(p, v, depth))
    for name in (n for n in libs if n not in UNCHECKED):
        kernels._libs["ingest_kernels.cu"] = libs[name]
        for case, (_, fn, want) in cases.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: {case}: the image differs from the plain version")
    times: dict = {}
    order = list(libs)
    for r in range(ROUNDS):
        for name in order if r % 2 == 0 else order[::-1]:
            kernels._libs["ingest_kernels.cu"] = libs[name]
            for case, (_, fn, _) in cases.items():
                times.setdefault((case, name), []).append(
                    cs.time_cuda_ms(torch, fn, cs.KERNEL_RUNS))
    kernels._libs["ingest_kernels.cu"] = libs["kernel"]
    for case, (depth, _, want) in cases.items():
        pos, vals = (torch.from_numpy(x).to(dev) for x in cs.plane_scatter_case(case)[:2])
        library = cs.plane_scatter_library(torch, pos, vals, depth)
        if not torch.equal(library(), want):
            raise AssertionError(f"the library call: {case}: the image differs")
        times[(case, "plain")] = [cs.time_cuda_ms(
            torch, lambda: kernels.plane_scatter_plain(pos, vals, depth), 5)
            for _ in range(ROUNDS)]
        times[(case, "library")] = [cs.time_cuda_ms(torch, library, cs.KERNEL_RUNS)
                                    for _ in range(ROUNDS)]
    times[("torch.zeros(1024, int32)", "-")] = [
        cs.time_cuda_ms(torch, lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
                        cs.KERNEL_RUNS) for _ in range(ROUNDS)]
    splits = {}
    for name in libs:
        kernels._libs["ingest_kernels.cu"] = libs[name]
        for case, (depth, *_) in cases.items():
            splits[(case, name)] = "%d x %d" % kernels.plane_scatter_groups(depth, dev)
    for (case, name), ms in times.items():
        print(json.dumps({"case": case, "variant": name, "clusters": splits.get((case, name)),
                          "ms": statistics.median(ms), "runs": ms}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
