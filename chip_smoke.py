#!/usr/bin/env python3
"""Smoke run of pilosa_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA count kernels from ``pilosa_tpu_torch/csrc`` into
``build/kernels/``, checks each kernel against its plain PyTorch version
on the card (exact), then drives the port's main path through its public
entry points, ``Holder(device="cuda")`` -> ``Executor(planner=Planner)``:

- ``Count`` over a set field of 954 shards (1,000,341,504 columns) with two
  rows at 5% density, imported from seeded random positions;
- filtered ``TopN`` over a 10M-column field of 1,536 dense rows, which
  streams through three 512-row tiles per shard.

Every answer is held against a numpy oracle, and the kernels' launch
counters must rise while the main path runs. The script prints the
toolchain, per-kernel times beside their bounds, the query latencies, the
card's name and power limit, a ``{"kernels": [...]}`` JSON line, and as its
last line ``{"ok": true, "device": {...}}``. It exits non-zero, without
that line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

# -- the configuration ------------------------------------------------------

#: bench.py's headline index: 1B columns -> 954 shards of 2^20, 5% density.
COUNT_SHARDS = 954
COUNT_DENSITY = 0.05
#: BASELINE.json's TopN field: 10M columns; 1,536 rows (three ROW_TILE
#: tiles), each about 1/32 dense per shard, past DENSE_CUTOFF (1/64).
TOPN_COLS = 10_000_000
TOPN_ROWS = 1536
TOPN_AND_DEPTH = 5
SEED = 7
QUERY_RUNS = 20
KERNEL_RUNS = 30
PROFILE_RUNS = 5
#: device clock cycles spun before each timed kernel call (about 0.5 ms).
SPIN_CYCLES = 1_000_000

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and 32-bit operations
#: outside the tensor cores (the float32 rate; popcount and bitwise ops
#: issue on the same integer/float pipes at no higher rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: per word: one bitwise op, one popcount, one add.
OPS_PER_WORD = 3

COUNT_QUERIES = {
    "count_intersect": "Count(Intersect(Row(f=1), Row(g=2)))",
    "count_row": "Count(Row(f=1))",
    "count_3leaf": "Count(Union(Intersect(Row(f=1), Row(g=2)), Row(g=2)))",
}
TOPN_QUERY = "TopN(f2, Row(g=0), n=10)"


def log(msg: str) -> None:
    print(msg, flush=True)


# -- helpers ----------------------------------------------------------------


def popcount_rows(words: np.ndarray) -> np.ndarray:
    """numpy oracle: per-row popcount of uint32 words, int64."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words).sum(axis=-1, dtype=np.int64)
    lut = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)
    b = words.view(np.uint8).reshape(words.shape[:-1] + (-1,))
    return lut[b].sum(axis=-1, dtype=np.int64)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_cuda_ms(torch, fn, runs: int) -> float:
    """Median device ms per call of ``fn``, by CUDA events around each
    call after a warm-up. A device-side spin queued before each start
    event lets the host enqueue the call before the device gets there, so
    the host's per-call overhead stays out of the time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seeded_words(rng, shape) -> np.ndarray:
    """Random uint32 words with the edge cases mixed in: all-ones words,
    sign-bit-only words (int32 -1 and INT_MIN), zero words, and whole rows
    of each in the first three rows."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = w.reshape(-1)
    flat[::97] = 0xFFFFFFFF
    flat[5::89] = 0x80000000
    flat[11::83] = 0
    if len(shape) > 1 and shape[0] >= 3:
        w[0], w[1], w[2] = 0xFFFFFFFF, 0x80000000, 0
    return w


# -- phase 1: toolchain and build -------------------------------------------


def phase_toolchain(torch, card: str) -> dict:
    from pilosa_tpu_torch.ops import build

    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}, numpy {np.__version__}")
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log(f"nvcc: {nvcc}: {ver[-1] if ver else 'unknown'}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: none")
    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.3f} s for {sorted(libs)} -> {build.BUILD_DIR}")
    return {"build_s": secs}


# -- phase 2: each kernel against its plain version --------------------------


def phase_kernels(torch, card: str, device: str = "cuda") -> dict:
    from pilosa_tpu_torch.ops import kernels

    dev = torch.device(device)
    rng = np.random.default_rng(SEED)

    def t(words):
        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)

    errs = {"pair_count": 0, "row_counts": 0}

    def check_pair(a, b, op, what):
        got = kernels.pair_count(a, b, op)
        want = kernels.pair_count_plain(a, b, op)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != torch.int32:
            raise AssertionError(f"pair_count {what}: shape/dtype {got.shape} "
                                 f"{got.dtype} vs {want.shape}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errs["pair_count"] = max(errs["pair_count"], err)
        if err:
            raise AssertionError(f"pair_count {what} op={op}: max |err| {err}")

    def check_rows(a, what):
        got = kernels.row_counts(a)
        want = kernels.row_counts_plain(a)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errs["row_counts"] = max(errs["row_counts"], err)
        if got.shape != want.shape or err:
            raise AssertionError(f"row_counts {what}: max |err| {err}")

    w = 32768
    big_a, big_b = t(seeded_words(rng, (1024, w))), t(seeded_words(rng, (1024, w)))
    stack = t(seeded_words(rng, (512, w)))
    filt_stack = t(seeded_words(rng, (16, w)))
    filt = filt_stack[3]  # a filter row sliced out of a stack, as TopN's
    for op in ("and", "or", "xor", "andnot"):
        check_pair(big_a, big_b, op, "[1024, 32768] x [1024, 32768]")
        check_pair(stack, filt, op, "[512, 32768] x [32768]")
    check_rows(big_a, "[1024, 32768]")
    # Ragged shapes: a word count that is not a multiple of 4 (scalar
    # loop), rows starting off 16-byte alignment, a single row with a
    # vector body and a tail, several W chunks (atomics), 3-D leading dims.
    ragged = [
        (seeded_words(rng, (7, 6243)), seeded_words(rng, (7, 6243))),
        (seeded_words(rng, (6243,)), seeded_words(rng, (6243,))),
        (seeded_words(rng, (3, 70001)), seeded_words(rng, (70001,))),
        (seeded_words(rng, (2, 3, 8200)), seeded_words(rng, (2, 3, 8200))),
    ]
    for a_np, b_np in ragged:
        a, b = t(a_np), t(b_np)
        for op in ("and", "or", "xor", "andnot"):
            check_pair(a, b, op, f"{tuple(a.shape)} x {tuple(b.shape)}")
        check_rows(a, f"{tuple(a.shape)}")
    off_a, off_b = t(seeded_words(rng, (5, 4101))), t(seeded_words(rng, (5, 4101)))
    for op in ("and", "andnot"):
        check_pair(off_a[:, 1:], off_b[:, 1:], op, "unaligned [5, 4100]")
        check_pair(off_a[:, 1:], off_b[2, 1:], op, "unaligned broadcast")
    check_rows(off_a[:, 1:], "unaligned [5, 4100]")
    check_rows(t(seeded_words(rng, (70003,))), "[70003]")
    log(f"kernel checks: exact on all four ops; max |err| {errs}")

    # Times at the shapes of the main path: the 2-leaf and bare-leaf Count
    # over 954 shards padded to 1024, and a TopN tile against its filter.
    # "ms" is the wrapper's device time per call (the kernel and its
    # zero-filled output), median of KERNEL_RUNS.
    rows = 1024
    cases = [
        ("pair_count", "[1024, 32768] x [1024, 32768]",
         lambda: kernels.pair_count(big_a, big_b, "and"),
         lambda: kernels.pair_count_plain(big_a, big_b, "and"),
         2 * rows * w * 4 + rows * 4, OPS_PER_WORD * rows * w),
        ("row_counts", "[1024, 32768]",
         lambda: kernels.row_counts(big_a),
         lambda: kernels.row_counts_plain(big_a),
         rows * w * 4 + rows * 4, 2 * rows * w),
        ("pair_count", "[512, 32768] x [32768]",
         lambda: kernels.pair_count(stack, filt, "and"),
         lambda: kernels.pair_count_plain(stack, filt, "and"),
         512 * w * 4 + w * 4 + 512 * 4, OPS_PER_WORD * 512 * w),
    ]
    timings = {}
    for name, shape, fn, plain_fn, nbytes, ops in cases:
        ms = time_cuda_ms(torch, fn, KERNEL_RUNS)
        plain = time_cuda_ms(torch, plain_fn, 5)
        bound, by = bound_ms(nbytes, ops)
        log(f"kernel {name} {shape}: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{bound / ms:.1%} of bound; plain {plain:.4f} ms  [{card}]")
        timings.setdefault(name, (ms, plain, bound, by))
    log("kernels: [\"pair_count\", \"row_counts\"]")
    return {"timings": timings, "errs": errs}


# -- phase 3: the main path at full size -------------------------------------


def build_count_index(h, n_shards: int, density: float, seed: int):
    """bench.py's star-trace data: f row 1 and g row 2 at ``density`` over
    ``n_shards`` shards, from seeded random positions through
    ``Field.import_bits``. Position generation is set-up and is freed right
    after each import."""
    from pilosa_tpu_torch.config import SHARD_WIDTH

    idx = h.create_index("bench")
    n_cols = n_shards * SHARD_WIDTH
    n_bits = int(n_cols * density)
    rng = np.random.default_rng(seed)
    import_s = 0.0
    for field, row in (("f", 1), ("g", 2)):
        fld = idx.create_field(field)
        pos = rng.integers(0, n_cols, n_bits, dtype=np.uint64)
        t0 = time.perf_counter()
        fld.import_bits(np.broadcast_to(np.uint64(row), n_bits), pos)
        import_s += time.perf_counter() - t0
        del pos
    return n_cols, n_bits, import_s


def build_topn_index(torch, h, n_cols: int, n_rows: int, seed: int):
    """f2: ``n_rows`` rows per shard, each word the AND of TOPN_AND_DEPTH
    random words (about 1/32 of the bits set), g row 0 at about 1/2; made on
    the device from a seeded generator and loaded through
    ``interop.load_fragment_words``. Bits past ``n_cols`` stay clear.
    Returns the host words {shard: (f2 [n_rows, W], g [W])}."""
    from pilosa_tpu_torch import interop
    from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD
    from pilosa_tpu_torch.ops import bitops

    h.create_index("topn")
    gen = torch.Generator(device=h.device)
    gen.manual_seed(seed)
    n_shards = (n_cols + SHARD_WIDTH - 1) // SHARD_WIDTH
    data = {}

    def rand(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=h.device, generator=gen)

    for shard in range(n_shards):
        f2 = rand((n_rows, WORDS_PER_SHARD))
        for _ in range(TOPN_AND_DEPTH - 1):
            f2 &= rand((n_rows, WORDS_PER_SHARD))
        g = rand((WORDS_PER_SHARD,))
        live = n_cols - shard * SHARD_WIDTH
        if live < SHARD_WIDTH:  # the last shard ends at n_cols
            mask = torch.from_numpy(bitops.np_range_mask(0, live).view(np.int32))
            f2 &= mask.to(h.device)
            g &= mask.to(h.device)
        f2_h = f2.cpu().numpy().view(np.uint32)
        g_h = g.cpu().numpy().view(np.uint32)
        interop.load_fragment_words(h, "topn", "f2", shard, range(n_rows), f2_h)
        interop.load_fragment_words(h, "topn", "g", shard, [0], g_h[None])
        data[shard] = (f2_h, g_h)
    return data


def topn_oracle(data: dict, n: int) -> list[tuple[int, int]]:
    """The executor's two-pass TopN (reference executor.go:857) in numpy:
    pass 1 takes each shard's top ``n`` rows with count >= 1 (count desc,
    id asc) as candidates; pass 2 sums every candidate's exact count over
    all shards and keeps the top ``n``."""
    per_shard = {s: popcount_rows(f2 & g[None, :]) for s, (f2, g) in data.items()}
    cands: set[int] = set()
    for counts in per_shard.values():
        ids = np.arange(len(counts))
        order = np.lexsort((ids, -counts))
        cands.update(int(i) for i in order[:n] if counts[i] > 0)
    totals = {i: int(sum(c[i] for c in per_shard.values())) for i in cands}
    ranked = sorted(((i, c) for i, c in totals.items() if c > 0),
                    key=lambda p: (-p[1], p[0]))
    return ranked[:n]


def p50_ms(fn, runs: int) -> tuple[float, list[float]]:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def device_busy_ms(torch, fn, runs: int) -> tuple[float, float]:
    """(device ms, wall ms) per call of ``fn`` under torch.profiler: the
    device time is the sum of every kernel's and copy's own time on the
    card; the wall time, host clock around the traced calls, includes the
    profiler's own overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    # Only the device-side events: a CPU op's device total repeats the
    # time of the kernels it launched.
    busy_us = sum(e.device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / runs, wall


def phase_main_path(torch, card: str, device: str = "cuda",
                    count_shards: int = COUNT_SHARDS,
                    topn_cols: int = TOPN_COLS, topn_rows: int = TOPN_ROWS,
                    runs: int = QUERY_RUNS) -> dict:
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import Planner

    h = Holder(device=device)
    n_cols, n_bits, import_s = build_count_index(h, count_shards, COUNT_DENSITY, SEED)
    log(f"count index: {count_shards} shards, {n_cols} columns, 2 rows x "
        f"{n_bits} random positions; import_bits {import_s:.3f} s (host)")
    t0 = time.perf_counter()
    data = build_topn_index(torch, h, topn_cols, topn_rows, SEED + 1)
    log(f"topn index: {len(data)} shards, {topn_cols} columns, {topn_rows} "
        f"rows; made and loaded in {time.perf_counter() - t0:.3f} s")

    # numpy oracles over the fragments' host words.
    fw = np.stack([h.fragment("bench", "f", "standard", s).row_words(1)
                   for s in range(count_shards)])
    gw = np.stack([h.fragment("bench", "g", "standard", s).row_words(2)
                   for s in range(count_shards)])
    want = {
        "count_intersect": int(popcount_rows(fw & gw).sum()),
        "count_row": int(popcount_rows(fw).sum()),
        "count_3leaf": int(popcount_rows((fw & gw) | gw).sum()),
    }
    del fw, gw
    want_topn = topn_oracle(data, 10)
    assert all(h.fragment("topn", "f2", "standard", 0).rows[r].is_dense
               for r in range(topn_rows)), "TopN rows must be dense"

    ex = Executor(h, planner=Planner(h))
    launches = {}
    first_ms = {}
    # The main path's run: counters at 0 just before, read just after.
    kernels.reset_launches()
    for name, q in COUNT_QUERIES.items():
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        (got,) = ex.execute("bench", q)
        first_ms[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if got != want[name]:
            raise AssertionError(f"{q}: got {got}, numpy oracle {want[name]}")
        log(f"{q} = {got} (numpy oracle {want[name]}), launches {launches[name]}")
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    (pairs,) = ex.execute("topn", TOPN_QUERY)
    first_ms["topn"] = (time.perf_counter() - t0) * 1e3
    launches["topn"] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    got_topn = [(p.id, p.count) for p in pairs]
    if got_topn != want_topn:
        raise AssertionError(f"{TOPN_QUERY}: got {got_topn}, oracle {want_topn}")
    log(f"{TOPN_QUERY} = {got_topn} (numpy oracle equal), launches {launches['topn']}")
    main_launches = dict(kernels.LAUNCHES)
    log(f"main path launches: {main_launches}")
    if device == "cuda":
        for k, v in main_launches.items():
            if v < 1:
                raise AssertionError(f"kernel {k} was not launched on the main path")
    log(f"first-run ms (stacks built and uploaded): "
        f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")

    lat = {}
    for name, q in COUNT_QUERIES.items():
        lat[name], _ = p50_ms(lambda q=q: ex.execute("bench", q), runs)
    lat["topn"], _ = p50_ms(lambda: ex.execute("topn", TOPN_QUERY), runs)
    for name, ms in lat.items():
        q = COUNT_QUERIES.get(name, TOPN_QUERY)
        log(f"p50 {q}: {ms:.4f} ms over {runs} runs, warm stacks, host clock "
            f"to the answer on the host  [{card}]")
    if device == "cuda":
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for index, q in (("bench", COUNT_QUERIES["count_intersect"]), ("topn", TOPN_QUERY)):
            busy, wall = device_busy_ms(torch, lambda index=index, q=q: ex.execute(index, q),
                                        PROFILE_RUNS)
            share = f"{busy / wall:.1%} busy" if busy else "device time not measured"
            log(f"profile {q}: device {busy:.4f} ms of {wall:.4f} ms wall per query "
                f"({share}), torch.profiler over {PROFILE_RUNS} runs  [{card}]")
    return {"launches": main_launches}


# -- main ---------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pilosa_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    results: dict = {}
    failed: list[str] = []
    for name, phase in (("toolchain", phase_toolchain), ("kernels", phase_kernels),
                        ("main_path", phase_main_path)):
        log(f"== phase {name}")
        try:
            results[name] = phase(torch, card)
        except Exception:  # report every phase, then fail as a whole
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
            if name == "toolchain":
                break
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1

    timings = results["kernels"]["timings"]
    errs = results["kernels"]["errs"]
    launches = results["main_path"]["launches"]
    source = "pilosa_tpu_torch/csrc/count_kernels.cu"
    replaces = {"pair_count": "pilosa_tpu/ops/pallas_kernels.py:104",
                "row_counts": "pilosa_tpu/ops/pallas_kernels.py:124"}
    entries = []
    for name in ("pair_count", "row_counts"):
        ms, plain, bound, by = timings[name]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces[name], "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                        "bound_ms": bound, "bound_by": by, "library_ms": None})
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
