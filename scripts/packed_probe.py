#!/usr/bin/env python3
"""Timed routes and forms of the port's packed AND dense wave.

    python3 scripts/packed_probe.py [FORM ...]

Run on a machine with one NVIDIA GPU and nvcc, from the root of a
checkout (a few minutes of command). It compiles forms of
``pilosa_tpu_torch/csrc/packed_kernels.cu`` (text edits of a copy, under
``build/packed_probe/``), loads each in place of the package's library,
holds ``kernels.packed_and_dense_count_batched`` exactly to its plain
version, and times it with ``chip_smoke.py``'s timer (CUDA events after a
device spin), in alternating rounds, on waves whose slots all read row
1's ``[1024, 32768]`` plane (``chip_smoke.packed_case("k1024")``), each
slot a row permutation of a ``[1024, K]`` case stack in memory of its own.

- ``route``: the source as it is, both routes forced in turn
  (``kernels.and_wave_route``), at 1, 2, 8 and 32 slots and K = 8, 1024
  and 4096: the times the route's crossover is set from;
- staged forms, at 8 and 32 slots of K = 1024, 8 of K = 8 and 8 of
  K = 4096, the staged route forced: ``tile16384`` (a row staged in 2
  tiles of 64 KiB, so 3 blocks share an SM; each tile re-reads the row's
  entries), ``threads512`` (``kStagedThreads`` 512, not 1024),
  ``threads512_batch2``, ``batch2`` and ``batch8`` (``kStagedBatch``, not
  4), ``persistent`` (as many blocks as fit the card at once, each walking
  rows, not a block a row);
- ``row_major``: the gather route forced, its grid in the first form's
  order (row blocks fastest, a slot's rows all before the next slot's)
  where the source takes the slot fastest for a launch whose slots share
  one plane (a row block's slots back to back, their plane sectors meeting
  in L2); ``slot_fastest``: the slot fastest for every launch.

Both gather orders are also timed on a wave of 8 slots of K = 1024 whose
slots read planes of their own (row permutations of the plane).

Besides: ``torch.zeros`` of 1024 int32, the least time one launch takes
under the same timer. Prints one JSON object per case and form, then the
card's name and power limit.

Its forms are text edits of lines of the kernel source, and it raises
where such a line is gone: when ``packed_kernels.cu`` changes, rewrite the
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

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROUNDS = 4
OUT_DIR = ROOT / "build" / "packed_probe"
SLOTS = (1, 2, 8, 32)
#: K -> (PACKED_CASES case, side: 0 a, 1 b) of the slots' stacks.
WIDTHS = {8: ("k8", 0), 1024: ("k1024", 0), 4096: ("ka8_kb4096", 1)}
#: the (K, slots) cases the forms are timed at.
FORM_CASES = ((1024, 8), (1024, 32), (8, 8), (4096, 8))
#: the case of a wave of OWN_SLOTS slots of K = 1024 on planes of their own.
OWN = "own planes"
OWN_SLOTS = 8


def edit(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"packed_kernels.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    """{form: (text, forced route)}."""
    threads = ("constexpr int kStagedThreads = 1024;", "constexpr int kStagedThreads = 512;")
    staged = {
        "tile16384": edit(src, ("constexpr int64_t kStageWords = 32768;",
                                "constexpr int64_t kStageWords = 16384;")),
        "threads512": edit(src, threads),
        "threads512_batch2": edit(src, threads, ("constexpr int kStagedBatch = 4;",
                                                 "constexpr int kStagedBatch = 2;")),
        **{f"batch{n}": edit(src, ("constexpr int kStagedBatch = 4;",
                                   f"constexpr int kStagedBatch = {n};")) for n in (2, 8)},
        "persistent": edit(src, ("  const unsigned grid = static_cast<unsigned>(rows);", '''  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, packed_and_staged_kernel<true, true, N>, kStagedThreads, smem);
  const int64_t most = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) * device_sms();
  const unsigned grid = static_cast<unsigned>(rows < most ? rows : most);''')),
    }
    row_major = edit(src, ("  const bool slot_x = shared && m > 1;",
                           "  const bool slot_x = false;"))
    slot_fastest = edit(src, ("  const bool slot_x = shared && m > 1;",
                              "  const bool slot_x = m > 1;"))
    return {"route": (src, None), **{k: (v, 1) for k, v in staged.items()},
            "row_major": (row_major, 0), "slot_fastest": (slot_fastest, 0)}


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
    forms = variants((ROOT / "pilosa_tpu_torch/csrc/packed_kernels.cu").read_text())
    forms = {k: v for k, v in forms.items() if k in sys.argv[1:] or len(sys.argv) < 2}
    libs = build_all({name: text for name, (text, _) in forms.items()})
    dev = torch.device("cuda")
    stacks = {case: tuple(torch.from_numpy(x.view(np.int32)).to(dev)
                          for x in cs.packed_case(case, 1024))
              for case in {c for c, _ in WIDTHS.values()}}
    plane = stacks["k1024"][2]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    def case(slots, planes):
        return (lambda: kernels.packed_and_dense_count_batched(slots, planes),
                kernels.packed_and_dense_count_batched_plain(slots, planes))

    cases, waves = {}, {}
    for k, (name, side) in WIDTHS.items():
        for n in SLOTS:
            x = stacks[name][side]
            waves[(k, n)] = [x[torch.randperm(x.shape[0], generator=gen, device=dev)]
                             for _ in range(n)]
            cases[(k, n)] = case(waves[(k, n)], [plane] * n)
    # a wave whose slots read planes of their own (row permutations of the
    # plane): the gather route only
    cases[OWN] = case(waves[(1024, OWN_SLOTS)],
                      [plane[torch.randperm(plane.shape[0], generator=gen, device=dev)]
                       for _ in range(OWN_SLOTS)])
    route_rule = kernels.and_wave_route
    runs = [(form, route, case) for form, (_, forced) in forms.items()
            for case in (cases if forced is None else FORM_CASES + ((OWN,) if forced == 0 else ()))
            for route in ((0,) if case == OWN else (0, 1) if forced is None else (forced,))]
    for form, route, case in runs:
        kernels._libs["packed_kernels.cu"] = libs[form]
        kernels.and_wave_route = lambda *_, route=route: route
        fn, want = cases[case]
        if not torch.equal(fn(), want):
            raise AssertionError(f"{form} route {route}: K, slots {case}: counts differ from "
                                 "the plain version")
    times: dict = {}
    for r in range(ROUNDS):
        for form, route, case in runs if r % 2 == 0 else runs[::-1]:
            kernels._libs["packed_kernels.cu"] = libs[form]
            kernels.and_wave_route = lambda *_, route=route: route
            times.setdefault((form, route, case), []).append(
                cs.time_cuda_ms(torch, cases[case][0], cs.KERNEL_RUNS))
    kernels.and_wave_route = route_rule
    floor = [cs.time_cuda_ms(torch, lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
                             cs.KERNEL_RUNS) for _ in range(ROUNDS)]
    for (form, route, case), ms in times.items():
        k, n, planes = (1024, OWN_SLOTS, "own") if case == OWN else (*case, "one")
        print(json.dumps({"form": form, "route": ["gather", "staged"][route], "k": k,
                          "slots": n, "planes": planes,
                          "rule": route_rule(planes == "one", n, k, plane.shape[1]),
                          "ms": statistics.median(ms), "runs": ms}), flush=True)
    print(json.dumps({"form": "floor", "ms": statistics.median(floor), "runs": floor}))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
