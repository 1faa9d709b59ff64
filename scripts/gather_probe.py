#!/usr/bin/env python3
"""Random-read rate and load latency of the card's memory.

    python3 scripts/gather_probe.py

Run on a machine with one NVIDIA GPU and nvcc, from the root of a
checkout (about a minute). It compiles a small CUDA source of its own
(under ``build/gather_probe/``, plain C interface, ctypes) and times, by
CUDA events (median of ROUNDS launches after a warm-up):

- ``seq``: every 16-byte word of a 4 GiB buffer read once, in order: the
  streaming rate the bounds' 3.35 TB/s stands for;
- ``rand32`` and ``rand64``: independent reads of whole 32-byte sectors
  and 64-byte pairs of sectors at random over the 4 GiB buffer, each
  thread keeping ``BATCH`` of them in flight (``ld.global.nc`` with
  ``L1::no_allocate``, as ``hll_expand`` gathers its plane);
  ``rand32_4mib`` the same sectors with each block's reads inside a 4 MiB
  window of its own (a shard's plane, as ``hll_expand`` reads it);
- ``chase``: one thread following a random cycle through the first word of
  each 32-byte sector, each load's address taken from the one before, over
  a 1 MiB footprint (held in the 50 MB L2 after a first pass), 256 MiB and
  4 GiB (from HBM; each launch goes on along the cycle, so no sector is
  read twice): the latency of one dependent load.

Then the ceilings those rates give the two kernels whose loads are
scattered, at ``chip_smoke.py``'s timed shapes: ``hll_expand`` (the
filter at the ``seq`` rate, the plane sectors that hold a filtered column
at the ``rand32`` rate, and at ``rand32_4mib``'s) and ``plane_lookup`` (its deciding sectors at the
``rand32`` rate, the probes and ids at ``seq``), each beside its bound
(``chip_smoke.bound_ms``), and the card's name and power limit. One JSON
object a line.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT_DIR = ROOT / "build" / "gather_probe"
BUFFER_BYTES = 4 << 30
ROUNDS = 5
BATCH = 8
READS_PER_THREAD = 64
CHASE_STEPS = 20000
CHASE_FOOTPRINTS = (1 << 20, 256 << 20, BUFFER_BYTES)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = BATCH_;

__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ int4 load_once(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ int fold(int4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

// Units of VECS 16-byte words (2: a sector, 4: two) at random among a
// block's window of `window` units (a power of two; block b's window
// starts at unit b * window, modulo the `units` of the buffer), `reads` a
// thread, kBatch units' loads in flight before any is used.
template <int VECS>
__global__ void random_read(const int4* __restrict__ buf, uint64_t units, uint64_t window,
                            int reads, uint64_t seed, int* __restrict__ sink) {
  const uint64_t tid = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint64_t base = (blockIdx.x * window) & (units - 1);
  int acc = 0;
  for (int r = 0; r < reads; r += kBatch) {
    int4 v[kBatch][VECS];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const uint64_t unit = base + (mix(seed ^ (tid * 1024 + r + u)) & (window - 1));
#pragma unroll
      for (int k = 0; k < VECS; ++k) v[u][k] = load_once(buf + unit * VECS + k);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int k = 0; k < VECS; ++k) acc ^= fold(v[u][k]);
  }
  if (acc == 0x7fffffff) sink[0] = acc;
}

__global__ void seq_read(const int4* __restrict__ buf, uint64_t n, int* __restrict__ sink) {
  int acc = 0;
  const uint64_t step = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step * 4) {
    int4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k * step < n ? load_once(buf + i + k * step)
                                                       : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc ^= fold(v[k]);
  }
  if (acc == 0x7fffffff) sink[0] = acc;
}

// next[8 i] holds the sector after sector i on the cycle; each launch
// goes on from where the last one stopped (*at).
__global__ void chase(const uint32_t* __restrict__ next, int steps, uint32_t* __restrict__ at) {
  uint32_t i = *at;
  for (int s = 0; s < steps; ++s) i = next[static_cast<uint64_t>(i) * 8];
  *at = i;
}

}  // namespace

extern "C" int probe_random(const void* buf, uint64_t units, uint64_t window, int vecs,
                            int reads, uint64_t seed, int blocks, void* sink) {
  const auto* b = static_cast<const int4*>(buf);
  if ((units & (units - 1)) || (window & (window - 1)) || window > units)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* k = static_cast<int*>(sink);
  if (vecs == 2)
    random_read<2><<<blocks, 256>>>(b, units, window, reads, seed, k);
  else if (vecs == 4)
    random_read<4><<<blocks, 256>>>(b, units, window, reads, seed, k);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_seq(const void* buf, uint64_t n, int blocks, void* sink) {
  seq_read<<<blocks, 512>>>(static_cast<const int4*>(buf), n, static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_chase(const void* next, int steps, void* at) {
  chase<<<1, 1>>>(static_cast<const uint32_t*>(next), steps, static_cast<uint32_t*>(at));
  return static_cast<int>(cudaGetLastError());
}
"""


def build() -> ctypes.CDLL:
    from pilosa_tpu_torch.ops import build as pbuild

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "gather_probe.cu"
    src.write_text(SOURCE.replace("BATCH_", str(BATCH)))
    lib = OUT_DIR / "gather_probe.so"
    proc = subprocess.run([pbuild.nvcc_path(), *pbuild.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    vp, u64, i32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    so.probe_random.argtypes = [vp, u64, u64, i32, i32, u64, i32, vp]
    so.probe_seq.argtypes = [vp, u64, i32, vp]
    so.probe_chase.argtypes = [vp, i32, vp]
    for fn in (so.probe_random, so.probe_seq, so.probe_chase):
        fn.restype = i32
    return so


def timed_ms(torch, launch) -> float:
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def checked(err: int) -> None:
    if err:
        raise RuntimeError(f"probe launch failed: CUDA error {err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 2
    lib, dev = build(), torch.device("cuda")
    card = cs.card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.randint(-2**31, 2**31 - 1, (BUFFER_BYTES // 4,), dtype=torch.int32, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    rates = {}

    ms = timed_ms(torch, lambda: checked(lib.probe_seq(buf.data_ptr(), BUFFER_BYTES // 16,
                                                       sms * 4, sink.data_ptr())))
    rates["seq"] = BUFFER_BYTES / ms * 1e3
    print(json.dumps({"probe": "seq", "bytes": BUFFER_BYTES, "ms": ms,
                      "bytes_per_s": rates["seq"], "card": card}), flush=True)
    blocks = sms * 64
    for name, unit, window in (("rand32", 32, BUFFER_BYTES), ("rand64", 64, BUFFER_BYTES),
                               ("rand32_4mib", 32, 4 << 20)):
        reads = blocks * 256 * READS_PER_THREAD
        ms = timed_ms(torch, lambda unit=unit, window=window: checked(lib.probe_random(
            buf.data_ptr(), BUFFER_BYTES // unit, window // unit, unit // 16, READS_PER_THREAD,
            cs.SEED, blocks, sink.data_ptr())))
        rates[name] = reads * unit / ms * 1e3
        print(json.dumps({"probe": name, "reads": reads, "unit_bytes": unit,
                          "window_bytes": window, "ms": ms,
                          "bytes_per_s": rates[name], "share_of_seq": rates[name] / rates["seq"],
                          "card": card}), flush=True)

    at = torch.zeros(1, dtype=torch.int32, device=dev)
    nxt = buf.view(-1, 8)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for footprint in CHASE_FOOTPRINTS:
        n = footprint // 32
        perm = torch.randperm(n, device=dev, generator=gen)
        nxt[perm, 0] = torch.roll(perm, -1).to(torch.int32)
        del perm
        at.zero_()
        if footprint <= 1 << 20:  # a first pass: the whole cycle in L2
            checked(lib.probe_chase(buf.data_ptr(), n, at.data_ptr()))
        # Each timed launch goes on along the cycle: past the L2's sectors,
        # every load of the larger cycles is one not read before.
        ms = timed_ms(torch, lambda: checked(lib.probe_chase(buf.data_ptr(), CHASE_STEPS,
                                                             at.data_ptr())))
        print(json.dumps({"probe": "chase", "footprint_bytes": footprint, "steps": CHASE_STEPS,
                          "ms": ms, "ns_per_load": ms * 1e6 / CHASE_STEPS, "card": card}),
              flush=True)
    del buf, nxt
    torch.cuda.empty_cache()

    # The ceilings of the two scattered kernels at chip_smoke's timed shapes.
    def t(words):
        import numpy as np

        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)

    filt = t(cs.filter_words(cs.HLL_TIMED_ROWS, cs.BSI_FILTER_BITS, cs.SEED))
    nbytes, logic, sectors = cs.hll_expand_work(torch, filt, cs.HLL_TIMED_P)
    fbytes = filt.numel() * 4
    ceiling = {name: (fbytes / rates["seq"] + sectors * 32 / rates[name]
                      + (nbytes - fbytes - sectors * 32) / rates["seq"]) * 1e3
               for name in ("rand32", "rand32_4mib")}
    print(json.dumps({"ceiling": "hll_expand", "filter_bytes": fbytes, "sectors": sectors,
                      "ceiling_ms": ceiling["rand32"], "ceiling_4mib_ms": ceiling["rand32_4mib"],
                      "bound_ms": cs.bound_ms(torch, nbytes, logic, 0)[0], "card": card}),
          flush=True)
    h, q, pad, runs = cs.KEYPLANE_CHECKS[-1]
    mat, phi, plo = cs.key_plane(h, q, cs.SEED, pad, runs)
    plane, ph, pl = t(mat), t(phi), t(plo)
    lbytes = cs.plane_lookup_bytes(torch, plane, ph, pl)
    lceiling = ((lbytes - 12 * q) / rates["rand32"] + 12 * q / rates["seq"]) * 1e3
    print(json.dumps({"ceiling": "plane_lookup", "probes": q, "ceiling_ms": lceiling,
                      "bound_ms": cs.bound_ms(torch, lbytes, 0, 0)[0], "card": card}),
          flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
