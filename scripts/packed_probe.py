#!/usr/bin/env python3
"""Timed variants of the port's packed_count kernel, its wave and the slot table.

    python3 scripts/packed_probe.py

Run on a machine with one NVIDIA GPU and nvcc, from the root of a
checkout. It compiles variants of ``pilosa_tpu_torch/csrc/packed_kernels.cu``
(text edits of a copy, under ``build/packed_probe/``), loads each in place
of the package's library and times ``packed_count`` at ``chip_smoke.py``'s
timed shapes ([1024, 1024] and [1024, 2048]), ``packed_count_batched``
at 8 and 32 slots of [1024, 1024] (``chip_smoke.packed_wave_cases``) and
``packed_and_dense_count`` at [1024, 1024] x [1024, 32768] with its timer
(CUDA events after a device spin), in alternating rounds. The variants
take one cost out, or put one design back, at a time:

- ``kernel``: the source as it is;
- ``no_loads``: the count's 16-byte loads gone (each lane counts its
  positions as if they were entries): what is left is the launch, the
  grid's ramp and the row sums;
- ``single_e4``, ``single_e16``, ``single_e32``: other entries a thread
  than the source's 8 on a single launch (``kSingleCountBatch``; a block
  a row at 4 and K = 1024, a warp a row at 32); ``wave_e8``,
  ``wave_e16``: fewer than its 32 on a wave's (``kWaveCountBatch``);
- ``slot_indexed``: a one-slot table's slot read by blockIdx.y, as a
  wave's is, where the kernels take slot 0 as a constant.

Besides: ``torch.zeros`` of 1024 int32, the least time one launch takes
under the same timer. ``no_loads`` computes another function and is not
checked. Prints one JSON object per case and variant, then the card's
name and power limit.

Its variants are text edits of lines of the kernel source, and it raises
where such a line is gone: when ``packed_kernels.cu`` changes, rewrite the
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

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROUNDS = 4
OUT_DIR = ROOT / "build" / "packed_probe"


def edit(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"packed_kernels.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    single, wave = "constexpr int kSingleCountBatch = 8;", "constexpr int kWaveCountBatch = 32;"
    fixed = {**{f"single_e{e}": edit(src, (single, f"constexpr int kSingleCountBatch = {e};"))
                for e in (4, 16, 32)},
             **{f"wave_e{e}": edit(src, (wave, f"constexpr int kWaveCountBatch = {e};"))
                for e in (8, 16)}}
    return {
        "kernel": src,
        "no_loads": edit(src, (
            "v[u] = q < k4 ? __ldg(p4 + q) : make_int4(sentinel, sentinel, sentinel, sentinel);",
            "v[u] = make_int4(q, q + 1, q + 2, q < k4 ? q + 3 : sentinel);")),
        **fixed,
        "slot_indexed": edit(src, ("const int slot = N == 1 ? 0 : blockIdx.y;",
                                   "const int slot = blockIdx.y;")),
    }


def build_all(srcs: dict) -> dict:
    from pilosa_tpu_torch.ops import build, kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    inc = str(build.CSRC_DIR)

    def one(item):
        name, text = item
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(text)
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", inc, "-o", str(so),
                            str(cu)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
        return name, so

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(pool.map(one, srcs.items()))
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES["packed_kernels.cu"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int32
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("packed_probe: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import kernels

    card = cs.card_line()
    libs = build_all(variants((ROOT / "pilosa_tpu_torch/csrc/packed_kernels.cu").read_text()))
    dev = torch.device("cuda")
    packed = {case: tuple(torch.from_numpy(x.view(np.int32)).to(dev)
                          for x in cs.packed_case(case, 1024)) for case in ("k1024", "k2048")}
    a, _, pl = packed["k1024"]
    a2 = packed["k2048"][0]
    cases = {"packed_count [1024, 1024]": (lambda: kernels.packed_count(a),
                                           lambda: kernels.packed_count_plain(a)),
             "packed_count [1024, 2048]": (lambda: kernels.packed_count(a2),
                                           lambda: kernels.packed_count_plain(a2)),
             "packed_and_dense_count [1024, 1024] x [1024, 32768]": (
                 lambda: kernels.packed_and_dense_count(a, pl),
                 lambda: kernels.packed_and_dense_count_plain(a, pl))}
    for n in cs.PACKED_WAVE_TIMED:
        name, shape, fn, plain, *_ = cs.packed_wave_cases(torch, kernels, packed, n)[0]
        cases[f"{name} {shape}"] = (fn, plain)
    for name in (n for n in libs if n != "no_loads"):
        kernels._libs["packed_kernels.cu"] = libs[name]
        for case, (fn, plain) in cases.items():
            if not torch.equal(fn(), plain()):
                raise AssertionError(f"{name}: {case}: counts differ from the plain version")
    times: dict = {}
    order = list(libs)
    for r in range(ROUNDS):
        for name in order if r % 2 == 0 else order[::-1]:
            kernels._libs["packed_kernels.cu"] = libs[name]
            for case, (fn, _) in cases.items():
                times.setdefault((case, name), []).append(
                    cs.time_cuda_ms(torch, fn, cs.KERNEL_RUNS))
    kernels._libs["packed_kernels.cu"] = libs["kernel"]
    times[("torch.zeros(1024, int32)", "-")] = [
        cs.time_cuda_ms(torch, lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
                        cs.KERNEL_RUNS) for _ in range(ROUNDS)]
    for (case, name), ms in times.items():
        print(json.dumps({"case": case, "variant": name, "ms": statistics.median(ms),
                          "runs": ms}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
