#!/usr/bin/env python3
"""Timed variants of the port's hll_expand and plane_lookup kernels.

    python3 scripts/sketch_probe.py

Run on a machine with one NVIDIA GPU and nvcc, from the root of a
checkout (about a minute of command). It compiles variants of
``pilosa_tpu_torch/csrc/sketch_kernels.cu`` and ``keyplane_kernels.cu``
(text edits of a copy, under ``build/sketch_probe/``), loads each in
place of the package's library, holds it exactly to the plain version, and
times ``kernels.hll_expand`` (``[1024, 2^20]``, p = 12, under the keys
phase's 5M-bit filter, an all-ones filter and a filter with each shard's
bits in one chunk: ``chip_smoke.SKETCH_TIMED``'s first three) and
``kernels.plane_lookup`` (a 2^20-slot plane, 65,536 and 300 probes) with
``chip_smoke.py``'s timer (CUDA events after a device spin), in alternating
rounds. The variants change one constant of the design at a time:

- ``hll_expand``: ``kernel``; ``threads256`` and ``threads1024`` (blocks of
  256 and 1,024 threads, chunks of 1,024 and 4,096 filter words);
  ``stages3`` (three ring stages, not two); ``batch8`` (8 plane loads a
  thread in flight, not 4); ``cap_half`` (a chunk is read whole past half
  its nibbles, not a quarter);
- ``plane_lookup``: ``kernel``; ``fences64`` and ``fences1024`` (the fence
  table's size, not 256); ``threads512``; ``interp3`` (3 interpolated
  steps, then halving, not 8); ``bisect`` (halving from the first step).

Then ``torch.zeros`` of 1024 int32, the least time one launch takes under
the same timer. Prints one JSON object per case and variant, then the
card's name and power limit.

Its variants are text edits of lines of the kernel sources, and it raises
where such a line is gone: when either source changes, rewrite the
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
CSRC = ROOT / "pilosa_tpu_torch" / "csrc"
OUT_DIR = ROOT / "build" / "sketch_probe"


def edit(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"the kernel source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants() -> dict:
    """{(source, variant): text}."""
    hll = (CSRC / "sketch_kernels.cu").read_text()
    look = (CSRC / "keyplane_kernels.cu").read_text()
    threads = "constexpr int kExpandThreads = 512;"
    chunk = "constexpr int kChunkWords = 2048;"
    out = {("sketch_kernels.cu", "kernel"): hll,
           ("sketch_kernels.cu", "threads256"): edit(
               hll, (threads, "constexpr int kExpandThreads = 256;"),
               (chunk, "constexpr int kChunkWords = 1024;")),
           ("sketch_kernels.cu", "threads1024"): edit(
               hll, (threads, "constexpr int kExpandThreads = 1024;"),
               (chunk, "constexpr int kChunkWords = 4096;")),
           ("sketch_kernels.cu", "stages3"): edit(
               hll, ("constexpr int kStages = 2;", "constexpr int kStages = 3;")),
           ("sketch_kernels.cu", "batch8"): edit(
               hll, ("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")),
           ("sketch_kernels.cu", "cap_half"): edit(
               hll, ("constexpr int kListCap = kChunkWords * 8 / 4;",
                     "constexpr int kListCap = kChunkWords * 8 / 2;"))}
    fences = "constexpr int kFences = 256;"
    interp = "constexpr int kInterpSteps = 8;"
    out.update({("keyplane_kernels.cu", "kernel"): look,
                ("keyplane_kernels.cu", "fences64"): edit(
                    look, (fences, "constexpr int kFences = 64;")),
                ("keyplane_kernels.cu", "fences1024"): edit(
                    look, (fences, "constexpr int kFences = 1024;")),
                ("keyplane_kernels.cu", "threads512"): edit(
                    look, ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")),
                ("keyplane_kernels.cu", "interp3"): edit(
                    look, (interp, "constexpr int kInterpSteps = 3;")),
                ("keyplane_kernels.cu", "bisect"): edit(
                    look, (interp, "constexpr int kInterpSteps = 0;"))})
    return out


def build_all(srcs: dict) -> dict:
    from pilosa_tpu_torch.ops import build, kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        (source, name), text = item
        stem = f"{Path(source).stem}-{name}"
        cu, so = OUT_DIR / f"{stem}.cu", OUT_DIR / f"{stem}.so"
        cu.write_text(text)
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o",
                            str(so), str(cu)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {stem}:\n{r.stderr}")
        return (source, name), so

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(pool.map(one, srcs.items()))
    libs = {}
    for (source, name), so in built.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int32
        libs[(source, name)] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sketch_probe: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import kernels

    card = cs.card_line()
    libs = build_all(variants())
    dev = torch.device("cuda")

    def t(words):
        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)

    rows, p = cs.HLL_TIMED_ROWS, cs.HLL_TIMED_P
    packed = cs.hll_planes(torch, rows, p, cs.BSI_DENSITY, dev, cs.SEED)
    filters = {"hll_timed": t(cs.filter_words(rows, cs.BSI_FILTER_BITS, cs.SEED)),
               "hll_ones": t(cs.hll_filter("ones", rows, cs.SEED)),
               "hll_one_chunk": t(cs.chunk_words(rows, cs.BSI_FILTER_BITS // rows, cs.SEED))}
    cases = {name: ("sketch_kernels.cu",
                    lambda f=f: kernels.hll_expand(packed, f, p),
                    kernels.hll_expand_plain(packed, f, p))
             for name, f in filters.items()}
    torch.cuda.empty_cache()  # the plain versions' scratch
    for q in (65536, 300):
        mat, phi, plo = cs.key_plane(1 << 20, q, cs.SEED)
        plane, ph, pl = t(mat), t(phi), t(plo)
        cases[f"lookup_{q}"] = ("keyplane_kernels.cu",
                                lambda plane=plane, ph=ph, pl=pl:
                                kernels.plane_lookup(plane, ph, pl),
                                kernels.plane_lookup_plain(plane, ph, pl))
    for (source, name), lib in libs.items():
        kernels._libs[source] = lib
        for case, (src, fn, want) in cases.items():
            if src == source and not torch.equal(fn(), want):
                raise AssertionError(f"{source} {name}: {case} differs from the plain version")
    times: dict = {}
    order = list(libs)
    for r in range(ROUNDS):
        for source, name in order if r % 2 == 0 else order[::-1]:
            kernels._libs[source] = libs[(source, name)]
            for case, (src, fn, _) in cases.items():
                if src == source:
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
