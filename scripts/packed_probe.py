#!/usr/bin/env python3
"""Timed variants of the port's packed and_count and pair_count kernels.

    python3 scripts/packed_probe.py

Run on a machine with one NVIDIA GPU and nvcc, from the root of a
checkout. It compiles variants of ``pilosa_tpu_torch/csrc/packed_kernels.cu``
(text edits of a copy, under ``build/packed_probe/``), loads each in place
of the package's library and times ``packed_and_dense_count`` and
``packed_pair_count`` at ``chip_smoke.py``'s timed shapes with its timer
(CUDA events after a device spin), in alternating rounds. The variants
take one cost out of a kernel at a time, so the difference says what that
cost is:

- ``kernel``: the source as it is;
- ``no_gathers``: and_count adds the word index in place of the plane word
  (its plane reads gone);
- ``no_searches``: pair_count skips its halving steps (the row still lands
  and one probe an entry is made);
- ``vector_lanes``: both kernels read their entries four to a lane by
  16-byte loads (every row timed here is aligned), so a warp's gathers
  and probes lie four entries apart;
- ``batch8``: and_count holds 8 entries a thread, not 16.

Besides: and_count against one 128 KiB plane row shared by every row (its
gathers served from L2), with each row's entries shuffled, and under each
L2 fetch granularity (``cudaLimitMaxL2FetchGranularity``); and
``torch.zeros`` of 1024 int32, the least time one launch takes under the
same timer. Variants other than ``kernel`` and ``batch8`` compute other
functions and are not checked. Prints one JSON object per case and
variant, then the card's name and power limit.

It records the diagnosis, written in PERF.md, of the and_count and
pair_count designs in that file. Its variants are text edits of lines of
the kernel source, and it raises where such a line is gone: when
``packed_kernels.cu`` changes, rewrite the variants for the new source or
delete this script, rather than grow it into a general harness.
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
#: a C function appended to every variant: sets the L2 fetch granularity
#: (bytes; < 0 leaves it) and returns the granularity in force.
L2_FETCH = '''
extern "C" int probe_l2_fetch(int bytes) {
  size_t v = 0;
  if (bytes >= 0) cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, bytes);
  cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  return static_cast<int>(v);
}
'''


#: load_entries' loop, and the same loop by 16-byte loads: a lane's four
#: entries side by side, at base + 4 * (lane + u * lanes) + {0..3}.
VECTOR_LOADS = ('''  for (int u = 0; u < E; ++u) {
    const int64_t q = base + lane + static_cast<int64_t>(u) * lanes;
    e[u] = q < k ? __ldg(p + q) : sentinel;
  }''', '''  for (int u = 0; u < E / 4; ++u) {
    const int64_t q = base + 4 * (lane + static_cast<int64_t>(u) * lanes);
    int4 v = make_int4(sentinel, sentinel, sentinel, sentinel);
    if (q < k) v = __ldg(reinterpret_cast<const int4*>(p + q));
    e[4 * u] = v.x;
    e[4 * u + 1] = v.y;
    e[4 * u + 2] = v.z;
    e[4 * u + 3] = v.w;
  }''')


def edit(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"packed_kernels.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    return {
        "kernel": src,
        "no_gathers": edit(src, ("if (e[u] < sentinel) v[u] = __ldg(w + wi);",
                                 "if (e[u] < sentinel) v[u] = static_cast<uint32_t>(wi);")),
        "no_searches": edit(src, ("for (int len = n; len > 1;) {",
                                  "for (int len = 1; len > 1;) {")),
        "vector_lanes": edit(src, VECTOR_LOADS),
        "batch8": edit(src, ("constexpr int kAndBatch = 16;", "constexpr int kAndBatch = 8;")),
    }


def build_all(srcs: dict) -> dict:
    from pilosa_tpu_torch.ops import build, kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    inc = str(build.CSRC_DIR)

    def one(item):
        name, text = item
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(text + L2_FETCH)
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
        lib.probe_l2_fetch.argtypes = [ctypes.c_int]
        lib.probe_l2_fetch.restype = ctypes.c_int
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
    a, _, pl = (torch.from_numpy(x.view(np.int32)).to(dev) for x in cs.packed_case("k1024", 1024))
    a2 = torch.from_numpy(cs.packed_case("k2048", 1024)[0]).to(dev)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    shuffled = a[:, torch.randperm(a.shape[1], device=dev, generator=gen)].contiguous()
    one_row = pl[:1].expand_as(pl)
    cases = {
        "and_count": (lambda: kernels.packed_and_dense_count(a, pl),
                      lambda: kernels.packed_and_dense_count_plain(a, pl)),
        "and_count, plane from L2": (lambda: kernels.packed_and_dense_count(a, one_row),
                                     lambda: kernels.packed_and_dense_count_plain(a, one_row)),
        "and_count, entries shuffled": (
            lambda: kernels.packed_and_dense_count(shuffled, pl),
            lambda: kernels.packed_and_dense_count_plain(shuffled, pl)),
        "pair_count": (lambda: kernels.packed_pair_count(a, a2),
                       lambda: kernels.packed_pair_count_plain(a, a2)),
    }
    for name in ("kernel", "batch8"):
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
    lib = libs["kernel"]
    default = lib.probe_l2_fetch(-1)
    kernels._libs["packed_kernels.cu"] = lib
    for r in range(ROUNDS):
        for g in (32, 64, 128):
            got = lib.probe_l2_fetch(g)
            times.setdefault((f"and_count, L2 fetch {got} B", "kernel"), []).append(
                cs.time_cuda_ms(torch, cases["and_count"][0], cs.KERNEL_RUNS))
    lib.probe_l2_fetch(default)
    times[("torch.zeros(1024, int32)", "-")] = [
        cs.time_cuda_ms(torch, lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
                        cs.KERNEL_RUNS) for _ in range(ROUNDS)]
    for (case, name), ms in times.items():
        print(json.dumps({"case": case, "variant": name, "ms": statistics.median(ms),
                          "runs": ms, "l2_fetch_default": default}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
