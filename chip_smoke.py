#!/usr/bin/env python3
"""Smoke run of pilosa_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --tree-batched-vs DIR
    python3 chip_smoke.py --import-rule

``--tree-batched-vs DIR`` times only ``tree_count_batched`` on its two timed
waves, the package in DIR (e.g. the parent commit unpacked with ``git
archive``) against this checkout's, in 10 pairs of processes
(``tree_batched_vs``). ``--import-rule`` times the set-field import under
the port's and the JAX package's scatter rules on one host
(``import_rule_vs``). With no arguments the script builds the CUDA
kernels from ``pilosa_tpu_torch/csrc`` into ``build/kernels/`` (one nvcc
per source, all at once), checks each kernel
against its plain PyTorch version on the card (exact), then boots a
standalone ``ServerNode(device="cuda")`` on loopback, creates its schema
over HTTP, loads three datasets into ``node.holder`` once, and drives the
port's paths:

- main path, in process (``Executor(holder, planner=Planner(holder))``):
  ``Count`` over a set field of 954 shards (1,000,341,504 columns) with two
  rows at 5% density, imported from seeded random positions; filtered
  ``TopN`` over a 10M-column field of 1,536 dense rows, which streams
  through three 512-row tiles per shard (all shards' tiles counted in one
  ``pair_count_batched`` launch per pass);
- BSI path, in process: bench.py's config 3 at the same 1B columns: an int
  field in [-100000, 100000) on 2% of the columns and a filter row of 5M
  bits, asked ``Sum``/``Min``/``Max`` (with and without filters, one of
  them a BSI condition) and ``Count`` of range conditions;
- HTTP path: every query of both through ``POST /index/{i}/query`` on a
  keep-alive connection, each body held to the oracle and byte for byte
  to the in-process JSON with the same launches; warm latencies beside the
  in-process ones; a JSON import of 200k bits and 200k values; 8
  concurrent clients; the 404/400/504/501 statuses; ``/metrics``;
- persist path: a second node with ``data_dir`` under
  ``build/chip_smoke_data/`` takes the 1B-column ``bench`` and ``bsi``
  indexes the way Pilosa's clients bulk-load (one ``import-roaring`` per
  field and shard, bodies from the first node's ``Fragment.to_roaring``;
  the BSI planes in process through ``interop.load_bsi_planes``), is
  closed (schema, snapshots, WAL truncate), and a third node reopens the
  dir: every Count and BSI query over HTTP equals the oracle and the first
  node's body byte for byte, with the same launches; then a CLI node with
  ``--data-dir`` is SIGKILLed after acknowledged writes and must read them
  back from its WAL, and a bit-flipped snapshot must be quarantined with a
  503 on its shard;
- pql path: on the 1B-column ``bench`` index (with its existence row and a
  third row ``h=3`` at 5% written first) ``Not``, ``Shift``, 3- and 4-leaf
  Counts (each ONE ``tree_count`` launch), ``Rows``, ``Options``,
  ``Store`` then ``ClearRow``, and on the TopN index ``SetRowAttrs`` and
  TopN with ``attrName`` and with ``tanimotoThreshold``, in process and
  over HTTP; then a repeated Count that the result cache answers with no
  launch, and that misses after a ``Set``;
- async path: on the same index (16 more rows of random words, and a row
  of 1,000 bits in each shard) ``Executor.execute_async`` keeps 200
  futures in flight from one thread (2- and 3-leaf Counts, ``Sum(Row(f=1))``
  and ``Min`` on the BSI index); with the coalescer held, 8 threads asking
  one Count make ONE ``pair_count`` launch, 8 different 2-leaf Counts ONE
  ``pair_count_batched``, 8 bare Counts ONE ``row_counts_batched`` and 8
  3-leaf Counts ONE ``tree_count_batched``; a planner whose budget holds 3
  of 6 stacks cycles Counts with the prefetcher on and no synchronous
  upload; the sparse row's cold Count is ONE ``assemble_stack`` launch,
  beside a cold dense row's bytes and time, each the median of 5 cold
  samples split into host gather, pinned buffer, fill, copy,
  ``assemble_stack`` and count;
- fields path: on ``bench``, fields created over HTTP and loaded from
  seeded data: a YMDH time field (10M bits in rows 0-2 over 90 days of
  hours: bench config 4's spread at 1B columns), set fields a, b, c (4, 8
  and 3 rows, 15M bits each: bench config 5's), a mutex field (50M
  columns, then 10M moved) and a bool field (20M columns); time windows of
  32 and 67 views (``tree_count`` over the view leaves), ``Rows`` over a
  window, ``MinRow``/``MaxRow``, GroupBy of two and three levels, with a
  filter and paged (ONE ``group_count`` each) and with a cursor (the
  per-shard walk), in process and over HTTP against numpy oracles; then,
  on an index of 4 shards, GroupBy over 450 rows and over a (32, 256)
  lattice of 8192 groups (ONE ``group_count`` each, its planes read from
  device memory).

The HTTP phase runs its 1 and 8 concurrent clients with dispatch
coalescing off (launches equal to the serial sum) and on ``auto`` (at most
that), profiles the 8 clients under ``auto`` (device busy share, top host
ops), and reads ``GET /debug/device``.

Every answer is held against a numpy oracle, and each path's kernel launch
counters are zeroed before it and must show its kernels launched. Timed
requests bypass the result cache (``?noCache=true``, ``cache=False``). The
script prints the toolchain, per-kernel times beside their bounds, the
query latencies, the card's name and power limit, a ``{"kernels": [...]}``
JSON line, and as its last line ``{"ok": true, "device": {...}}``. It
exits non-zero, without that line, when there is no CUDA device or any
phase fails.

CPU rehearsal at a small size (plain kernel versions, no launch counts)::

    import torch, chip_smoke as c
    d = {}
    c.phase_data(torch, "cpu", d, device="cpu", count_shards=5,
                 topn_cols=3 * 2**20, topn_rows=1100, bsi_shards=5)
    for p in (c.phase_main_path, c.phase_bsi, c.phase_http, c.phase_persist,
              c.phase_pql):
        p(torch, "cpu", d, runs=2)
    c.phase_async(torch, "cpu", d, n_futures=40)
    c.FIELDS_TIME_BITS, c.FIELDS_SET_BITS = 200_000, 60_000
    c.FIELDS_MUTEX_COLS, c.FIELDS_MUTEX_MOVED, c.FIELDS_BOOL_COLS = 200_000, 40_000, 80_000
    c.phase_fields(torch, "cpu", d, runs=2, slow_runs=2)
    d["node"].close()
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

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
#: device clock cycles spun before each timed kernel call (about 4.5 ms):
#: longer than any wrapper's host work before its launch (tree_count_batched
#: over 8 slots: up to 1.3 ms on an H100 machine's host, --tree-batched-vs),
#: so that no host time lands between the start event and the kernel.
SPIN_CYCLES = 8_000_000

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and 32-bit operations
#: outside the tensor cores (the float32 rate; popcount and bitwise ops
#: issue on the same integer/float pipes at no higher rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: per word: one bitwise op, one popcount, one add.
OPS_PER_WORD = 3
#: words of a shard's row, and the tape of the timed tree_count_batched waves.
SHARD_WORDS = 32768
TREE_BATCHED_TAPE = [0, 1, "and", 2, "and"]

#: bench.py's config 3 (bench.py:870-949) at the Count path's column space:
#: 2M values over 100M columns and a 500K-bit filter there, scaled x10.
BSI_SHARDS = COUNT_SHARDS
BSI_DENSITY = 0.02
BSI_MIN, BSI_MAX = -100000, 100000
BSI_FILTER_BITS = 5_000_000
#: shards whose values also go through Field.import_values as a check.
BSI_IMPORT_SHARDS = 8
#: import every value through Field.import_values when 8 shards' import
#: projects under this many seconds for the whole field.
BSI_FULL_IMPORT_S = 60.0
BSI_QUERIES = {
    "sum": "Sum(field=v)",
    "min": "Min(field=v)",
    "max": "Max(field=v)",
    "sum_filtered": "Sum(Row(f=1), field=v)",
    "count_gt": "Count(Row(v > 50000))",
    "count_between": "Count(Row(-1000 <= v <= 1000))",
    "max_of_negatives": "Max(Row(v < 0), field=v)",
}
BSI_PROFILED = ("sum_filtered", "count_gt")

COUNT_QUERIES = {
    "count_intersect": "Count(Intersect(Row(f=1), Row(g=2)))",
    "count_row": "Count(Row(f=1))",
    "count_3leaf": "Count(Union(Intersect(Row(f=1), Row(g=2)), Row(g=2)))",
}
TOPN_QUERY = "TopN(f2, Row(g=0), n=10)"
#: the kernels the BSI queries run, and those behind the HTTP edge.
BSI_KERNELS = ("pair_count", "row_counts", "bsi_compare", "bsi_minmax", "tree_count")
HTTP_KERNELS = BSI_KERNELS
#: measured requests bypass the result cache, so each one runs its kernels
#: (the pql phase checks the cache on its own).
QUERY_PATH = "/index/{}/query?noCache=true"

#: the schema the node gets over HTTP before build_*_index load its data:
#: (path, field options or None), one index per dataset.
SCHEMA = [
    ("/index/bench", None), ("/index/bench/field/f", None),
    ("/index/bench/field/g", None),
    ("/index/topn", None), ("/index/topn/field/f2", None),
    ("/index/topn/field/g", None),
    ("/index/bsi", None), ("/index/bsi/field/f", None),
    ("/index/bsi/field/v", {"type": "int", "min": BSI_MIN, "max": BSI_MAX}),
]
#: bits, and about as many values, in the JSON import through HTTP.
HTTP_IMPORT_N = 200_000
#: concurrent clients and requests per client behind the HTTP edge.
HTTP_THREADS = 8
HTTP_PER_THREAD = 25
#: admission gates (``--qos-max-concurrent``; 0: no gate) the concurrent
#: mix runs under, 1 and 8 clients each.
QOS_GATES = (0, 1, 2, 4)
#: client socket timeout: the first BSI request builds the cube.
HTTP_TIMEOUT_S = 300
#: where the persist phase keeps its data dirs (removed at its end).
PERSIST_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_data"
#: free space the persist phase needs under build/: the 1B-column WAL and
#: snapshots, plus the TopN shard's.
PERSIST_MIN_FREE_GIB = 12
#: the crash check's shard count: its semantics do not depend on size.
CRASH_SHARDS = 3


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


def host_enqueue_times(torch, fn, runs: int) -> list[float]:
    """Host ms of each of ``runs`` calls of ``fn``, each after a
    synchronize: the wrapper's checks, tables and launch, not the device's
    work."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return times


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


def batched_slots(plane, first=()) -> tuple[list, list]:
    """8 slots' [1024, 32768] operands of the batched kernels: ``a``
    (``first``, then new planes from ``plane()``) and ``b`` (7 new planes,
    slot 5 pushing slot 3's)."""
    a = list(first) + [plane() for _ in range(8 - len(first))]
    b = [plane() for _ in range(7)]
    return a, b[:5] + [b[3]] + b[5:]


def tree_batched_waves(plane, a, b) -> tuple[list, list]:
    """The timed tree_count_batched waves over ``batched_slots``: slot z
    pushes a[z], b[z], a[z + 1] (15 distinct planes), and the same wave
    with no leaf shared (24 distinct planes, 9 of them new)."""
    shared = [[a[z], b[z], a[(z + 1) % 8]] for z in range(8)]
    planes = a + b[:5] + b[6:] + [plane() for _ in range(9)]
    return shared, [planes[3 * z:3 * z + 3] for z in range(8)]


def tree_batched_times(repo: str) -> int:
    """``--tree-batched REPO``: time ``tree_count_batched`` of the package
    in REPO on the two timed waves (``tree_batched_waves``, random planes
    made on the card from SEED) with this script's timer, its counts first
    held to the plain version. One JSON object per wave: the kernel's ms by
    CUDA events (``time_cuda_ms``), the host's median and longest enqueue
    of one call (each after a synchronize)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(repo))
    from pilosa_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def plane():
        return torch.randint(-2**31, 2**31, (1024, SHARD_WORDS), dtype=torch.int32,
                             device="cuda", generator=gen)

    waves = tree_batched_waves(plane, *batched_slots(plane))
    for distinct, tables in zip((15, 24), waves):
        def fn(tables=tables):
            return kernels.tree_count_batched(tables, TREE_BATCHED_TAPE)

        if not torch.equal(fn(), kernels.tree_count_batched_plain(tables, TREE_BATCHED_TAPE)):
            raise AssertionError(f"{repo}: {distinct} planes: counts differ from the plain")
        host = host_enqueue_times(torch, fn, KERNEL_RUNS)
        print(json.dumps({"distinct_planes": distinct, "ms": time_cuda_ms(torch, fn, KERNEL_RUNS),
                          "host_ms": statistics.median(host), "host_ms_max": max(host)}),
              flush=True)
    return 0


def tree_batched_vs(parent: str, pairs: int = 10) -> int:
    """``--tree-batched-vs DIR``: ``--tree-batched`` of DIR (e.g. the parent
    commit unpacked with ``git archive``) and of this checkout, each in a
    process of its own, in ``pairs`` pairs, the side that runs first
    alternating. Prints every run, then per wave the medians of both
    sides, the pairs this checkout won, the spread of the parent's runs
    (between its quartiles), the bound and the card."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs: dict = {}
    for k in range(pairs):
        sides = (("parent", parent), ("this", here))
        for label, repo in sides if k % 2 == 0 else sides[::-1]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree-batched",
                                  repo], capture_output=True, text=True, check=False)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                return out.returncode
            for line in out.stdout.splitlines():
                rec = json.loads(line)
                runs.setdefault((rec["distinct_planes"], label), []).append(rec)
                print(json.dumps({"pair": k, "repo": label, **rec}), flush=True)
    card, plane = card_line(), 1024 * SHARD_WORDS * 4
    for distinct in (15, 24):
        ms = {lb: [r["ms"] for r in runs[(distinct, lb)]] for lb in ("parent", "this")}
        q1, _, q3 = statistics.quantiles(ms["parent"], n=4)
        bound = bound_ms(distinct * plane + 8 * 1024 * 4, 4 * 8 * 1024 * SHARD_WORDS)[0]
        print(json.dumps({
            "distinct_planes": distinct, "pairs": pairs,
            "parent_ms": statistics.median(ms["parent"]),
            "this_ms": statistics.median(ms["this"]),
            "this_won": sum(t < p for p, t in zip(ms["parent"], ms["this"])),
            "parent_spread_ms": q3 - q1, "bound_ms": bound,
            "host_ms": {lb: statistics.median(r["host_ms"] for r in runs[(distinct, lb)])
                        for lb in ("parent", "this")},
            "card": card}), flush=True)
    return 0


def import_rule_side(min_bits: int) -> int:
    """``--import-rule-side N``: the set-field import with
    ``Field._SCATTER_MIN_BITS_PER_SHARD`` at N (0: the JAX package's rule,
    the native scatter for any batch of 65,536 bits or more of at most 8
    rows) on a fresh holder on the card: the fields phase's time import
    (the same seeded 10M bits over 90 days of hours, YMDH), then three
    imports of the async phase's sparse-row shape (ASYNC_SPARSE_BITS bits
    in each of COUNT_SHARDS shards, one row) and COLD_SAMPLES cold
    ``Count(Row)`` of the first, each on a new planner. One JSON object."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD
    from pilosa_tpu_torch.core import FieldOptions, Holder
    from pilosa_tpu_torch.core.field import Field
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import Planner

    Field._SCATTER_MIN_BITS_PER_SHARD = min_bits
    h = Holder(device="cuda")
    idx = h.create_index("bench")
    n_cols = COUNT_SHARDS * SHARD_WIDTH
    rng = np.random.default_rng(SEED + 6)  # the fields phase's first draws
    t_cols = rng.integers(0, n_cols, FIELDS_TIME_BITS, dtype=np.uint64)
    t_rows = rng.integers(0, FIELDS_TIME_ROWS, FIELDS_TIME_BITS).astype(np.uint64)
    t_hours = rng.integers(0, FIELDS_TIME_HOURS, FIELDS_TIME_BITS)
    stamps = (np.datetime64("2019-01-01T00", "h") + t_hours).astype("datetime64[s]")
    tf = idx.create_field("t", FieldOptions(type="time", time_quantum="YMDH"))
    t0 = time.perf_counter()
    tf.import_bits(t_rows, t_cols, stamps)
    time_s = time.perf_counter() - t0
    n_frags = sum(len(v.fragments) for v in tf.views.values())
    del t_cols, t_rows, t_hours, stamps

    rng = np.random.default_rng(SEED + 5)
    sparse_s = []
    for k in range(3):
        pos = np.concatenate([
            np.sort(rng.choice(WORDS_PER_SHARD * 32, ASYNC_SPARSE_BITS, replace=False))
            + s * WORDS_PER_SHARD * 32 for s in range(COUNT_SHARDS)]).astype(np.uint64)
        fld = idx.create_field(f"s{k}")
        t0 = time.perf_counter()
        fld.import_bits(np.full(len(pos), ASYNC_SPARSE_ROW, dtype=np.uint64), pos)
        sparse_s.append(time.perf_counter() - t0)
    q, want = f"Count(Row(s0={ASYNC_SPARSE_ROW}))", COUNT_SHARDS * ASYNC_SPARSE_BITS
    cold_ms = []
    for _ in range(COLD_SAMPLES):
        planner = Planner(h)
        try:
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            (got,) = Executor(h, planner=planner, result_cache=False).execute(
                "bench", q, cache=False)
            cold_ms.append((time.perf_counter() - t0) * 1e3)
            delta = {k: kernels.LAUNCHES[k] - before[k] for k in before
                     if kernels.LAUNCHES[k] != before[k]}
            if got != want or delta != {"assemble_stack": 1, "row_counts": 1}:
                raise AssertionError(f"cold {q}: {got} (want {want}), launches {delta}")
        finally:
            planner.close()
    print(json.dumps({"min_bits_per_shard": min_bits, "time_import_s": time_s,
                      "time_views": len(tf.views), "time_fragments": n_frags,
                      "sparse_import_s": sparse_s, "cold_count_ms": cold_ms}), flush=True)
    return 0


def import_rule_vs(rule: int = 1024) -> int:
    """``--import-rule``: ``--import-rule-side`` at 0 (the JAX package's
    rule) and at ``rule`` (the port's), each in a process of its own, in
    the order JAX, port, port, JAX. Prints every run, then per side the
    medians of the time import, the sparse imports and the cold counts,
    and the card."""
    runs: dict = {}
    for label, n in (("jax", 0), ("port", rule), ("port", rule), ("jax", 0)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--import-rule-side", str(n)],
                             capture_output=True, text=True, check=False)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        runs.setdefault(label, []).append(rec)
        print(json.dumps({"side": label, **rec}), flush=True)
    print(json.dumps({side: {
        "time_import_s": [r["time_import_s"] for r in recs],
        "sparse_import_s_median": statistics.median(
            x for r in recs for x in r["sparse_import_s"]),
        "cold_count_ms_median": statistics.median(
            x for r in recs for x in r["cold_count_ms"])}
        for side, recs in runs.items()} | {"card": card_line()}), flush=True)
    return 0


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


def coo_words(pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted bit positions as the planner's OR-reduced COO words: (word
    indices int32, words uint32), one per distinct word."""
    w, b = pos >> 5, np.uint32(1) << (pos & 31).astype(np.uint32)
    starts = np.flatnonzero(np.diff(w, prepend=-1) != 0)
    return w[starts].astype(np.int32), np.bitwise_or.reduceat(b, starts)


def pack_assemble(s_pad: int, words: int, dense: dict, coo: dict):
    """(didx, dmat, ci, cw, cv, s_pad) as the planner packs a sparse upload:
    ``dense`` (row -> words) in row order, then ``coo`` (row -> (word
    indices, words)) grouped by row, rows ascending, each row's words in
    the order given; both padded to pow2 buckets (at least 8) aimed at row
    s_pad, one past the stack."""
    def bucket(n):
        return 0 if n == 0 else max(8, 1 << (n - 1).bit_length())

    d_pad = bucket(len(dense))
    dmat = np.zeros((d_pad, words), dtype=np.uint32)
    didx = np.full(d_pad, s_pad, dtype=np.int32)
    for k, row in enumerate(sorted(dense)):
        didx[k], dmat[k] = row, dense[row]
    rows = sorted(coo)
    nnz = sum(len(coo[r][0]) for r in rows)
    n_pad = bucket(nnz)
    ci = np.full(n_pad, s_pad, dtype=np.int32)
    cw, cv = np.zeros(n_pad, dtype=np.int32), np.zeros(n_pad, dtype=np.uint32)
    if nnz:
        ci[:nnz] = np.concatenate([np.full(len(coo[r][0]), r, dtype=np.int32) for r in rows])
        cw[:nnz] = np.concatenate([coo[r][0] for r in rows])
        cv[:nnz] = np.concatenate([coo[r][1] for r in rows])
    return didx, dmat, ci, cw, cv, s_pad


def assemble_inputs(rng, s_pad: int, n_dense: int, words: int):
    """The planner's sparse upload at scale: rows [0, n_dense) dense, every
    other row at most 2048 random bits as COO words (row 20 two all-ones
    words, row 21 only bit-31 words)."""
    dense = dict(enumerate(seeded_words(rng, (n_dense, words))))
    coo = {}
    for row in range(n_dense, s_pad):
        if row == 20:
            pos = np.concatenate([np.arange(0, 32), np.arange(64, 96)])
        elif row == 21:
            pos = np.arange(31, words * 32, 32 * 7)[:2048]
        else:
            k = int(rng.integers(1, min(2048, words * 32) + 1))
            pos = np.sort(rng.choice(words * 32, k, replace=False))
        coo[row] = coo_words(pos)
    return pack_assemble(s_pad, words, dense, coo)


#: assemble_stack's edge cases: held to its plain version on the card here,
#: and to the JAX package's _assemble_stack on the CPU by
#: tests/test_torch_upload.py.
ASSEMBLE_CASES = ("s_pad_1", "no_dense", "no_coo", "empty_row", "word_edges",
                  "ones_bit31", "unsorted_words", "odd_width", "dense_and_coo")


def assemble_case(name: str, seed: int = SEED):
    """One edge case's (didx, dmat, ci, cw, cv, s_pad), packed as the planner
    packs them. The base: 8 rows of 32768 words, rows 1 and 4 dense, every
    other row 1-300 random bits as COO words. Each case changes one thing:
    ``s_pad_1`` one COO row; ``no_dense``; ``no_coo``; ``empty_row`` row 3
    neither dense nor COO; ``word_edges`` words 0 and W - 1 in every COO
    row; ``ones_bit31`` all-ones words in even rows, bit-31-only words in
    odd ones; ``unsorted_words`` each row's words shuffled;
    ``odd_width`` W = 6243 (the scalar path); ``dense_and_coo`` rows 1 and
    4 COO words too, on top of their dense rows."""
    if name not in ASSEMBLE_CASES:
        raise ValueError(f"unknown assemble case {name!r}")
    rng = np.random.default_rng(seed)
    s_pad = 1 if name == "s_pad_1" else 8
    words = 6243 if name == "odd_width" else 32768
    dense_rows = [] if name in ("s_pad_1", "no_dense") else [1, 4]
    dense = dict(zip(dense_rows, seeded_words(rng, (len(dense_rows), words))))
    coo = {}
    for row in range(s_pad):
        if (name == "no_coo" or (row in dense and name != "dense_and_coo")
                or (name == "empty_row" and row == 3)):
            continue
        pos = np.sort(rng.choice(words * 32, int(rng.integers(1, 301)), replace=False))
        if name == "word_edges":
            pos = np.union1d(pos, [0, 31, words * 32 - 32, words * 32 - 1])
        w, v = coo_words(pos)
        if name == "ones_bit31":
            v[:] = 0xFFFFFFFF if row % 2 == 0 else 0x80000000
        if name == "unsorted_words":
            order = rng.permutation(len(w))
            w, v = w[order], v[order]
        coo[row] = (w, v)
    return pack_assemble(s_pad, words, dense, coo)


# -- phase 2: each kernel against its plain version --------------------------


def phase_kernels(torch, card: str, device: str = "cuda") -> dict:
    from pilosa_tpu_torch.ops import kernels

    dev = torch.device(device)
    rng = np.random.default_rng(SEED)

    def t(words):
        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)

    errs = dict.fromkeys(kernels.LAUNCHES, 0)

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

    def check_compare(bits, filt, lo, hi, depth, op, allow_eq, what):
        got = kernels.bsi_compare(bits, filt, lo, hi, depth, op, allow_eq)
        want = kernels.bsi_compare_plain(bits, filt, lo, hi, depth, op, allow_eq)
        torch.cuda.synchronize()
        # Words are bit patterns: count the differing bits.
        err = int(kernels.row_counts_plain(got ^ want).long().sum())
        errs["bsi_compare"] = max(errs["bsi_compare"], err)
        if got.shape != want.shape or err:
            raise AssertionError(f"bsi_compare {what} {op} allow_eq={allow_eq} "
                                 f"pred=({lo}, {hi}): {err} bits differ")

    def check_minmax(bits, filt, depth, is_max, what):
        got = kernels.bsi_minmax(bits, filt, depth, is_max)
        want = kernels.bsi_minmax_plain(bits, filt, depth, is_max)
        torch.cuda.synchronize()
        err = max(int((g.long() - v.long()).abs().max()) if g.numel() else 0
                  for g, v in zip(got, want))
        errs["bsi_minmax"] = max(errs["bsi_minmax"], err)
        if any(g.shape != v.shape for g, v in zip(got, want)) or err:
            raise AssertionError(f"bsi_minmax {what} is_max={is_max}: max |err| {err}")

    def check_tree(leaves, tape, what):
        for plane in (False, True):
            got = kernels.tree_count(leaves, tape, plane)
            want = kernels.tree_count_plain(leaves, tape, plane)
            torch.cuda.synchronize()
            got, want = (got, want) if plane else ((got,), (want,))
            err = int((got[0].long() - want[0].long()).abs().max())
            if plane:  # words are bit patterns: count the differing bits
                err = max(err, int(kernels.row_counts_plain(got[1] ^ want[1])
                                   .long().sum()))
            errs["tree_count"] = max(errs["tree_count"], err)
            if any(g.shape != v.shape for g, v in zip(got, want)) or err:
                raise AssertionError(f"tree_count {what} plane={plane} "
                                     f"tape={tape}: max |err| {err}")

    def check_shift(a, n, what):
        got = kernels.shift_left(a, n)
        want = kernels.shift_left_plain(a, n)
        torch.cuda.synchronize()
        err = int(kernels.row_counts_plain(got ^ want).long().sum())
        errs["shift_left"] = max(errs["shift_left"], err)
        if got.shape != want.shape or err:
            raise AssertionError(f"shift_left {what} n={n}: {err} bits differ")

    def check_batched(name, got, want, what):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errs[name] = max(errs[name], err)
        if got.shape != want.shape or got.dtype != torch.int32 or err:
            raise AssertionError(f"{name} {what}: {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}, max |err| {err}")

    def check_assemble(args, what):
        got = kernels.assemble_stack(*args)
        want = kernels.assemble_stack_plain(*args)
        torch.cuda.synchronize()
        err = int(kernels.row_counts_plain(got ^ want).long().sum())
        errs["assemble_stack"] = max(errs["assemble_stack"], err)
        if got.shape != want.shape or err:
            raise AssertionError(f"assemble_stack {what}: {err} bits differ")

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
    for op in ("and", "or", "xor", "andnot"):
        check_pair(big_a, big_b, op, "[1024, 32768] x [1024, 32768]")
        # a filter row sliced out of a stack, as TopN's
        check_pair(stack, filt_stack[3], op, "[512, 32768] x [32768]")
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

    # pair_count on BSI Sum's shape: the [17, 1024, W] cube against one
    # [1024, W] class row per shard (the repeat kernel), either side, and
    # suffix broadcasts that take the general kernel (ragged W, unaligned).
    cube = t(seeded_words(rng, (17, 1024, w)))
    cls = big_a
    for op in ("and", "andnot"):
        check_pair(cube, cls, op, "[17, 1024, 32768] x [1024, 32768]")
        check_pair(cls, cube, op, "[1024, 32768] x [17, 1024, 32768]")
    small_cube, small_rows = t(seeded_words(rng, (3, 5, 6243))), t(seeded_words(rng, (5, 6243)))
    check_pair(small_cube, small_rows, "xor", "[3, 5, 6243] x [5, 6243]")
    check_pair(t(seeded_words(rng, (2, 3, 4100))), off_a[:3, 1:], "or",
               "[2, 3, 4100] x unaligned [3, 4100]")
    check_pair(t(seeded_words(rng, (4, 3, 8200))), t(seeded_words(rng, (3, 8200))),
               "and", "[4, 3, 8200] x [3, 8200]")

    # bsi_compare and bsi_minmax against their plain versions: every op
    # and allow_eq at depth 17 on the 1B-column cube, depth 40 (predicate
    # bits in both halves) on a 64-shard cube, a ragged word count (scalar
    # path), and the descent with empty (pad) rows and a non-register row.
    filt = big_b
    top17 = (1 << 17) - 1
    for upred in (0, 1, 50000, top17):
        lo, hi = upred & 0xFFFFFFFF, upred >> 32
        for op in ("lt", "gt", "eq"):
            for allow_eq in (False, True):
                check_compare(cube, filt, lo, hi, 17, op, allow_eq, "[17, 1024, 32768]")
    cube40 = t(seeded_words(rng, (40, 64, w)))
    for upred in (0, (1 << 31) | 3, (1 << 33) + 5, (1 << 40) - 1):
        lo, hi = upred & 0xFFFFFFFF, upred >> 32
        for op in ("lt", "gt", "eq"):
            check_compare(cube40, cube40[0], lo, hi, 40, op, op != "eq", "[40, 64, 32768]")
    check_compare(small_cube, small_rows, 5, 0, 3, "lt", True, "[3, 5, 6243]")
    check_compare(cube, filt, 7, 0, 0, "gt", True, "depth 0")
    mm_filt = filt.clone()
    mm_filt[1000:] = 0  # pad rows: an empty candidate set
    mm_filt[999] = 0
    mm_filt[999, 5] = -2**31  # one column, bit 31
    for is_max in (False, True):
        check_minmax(cube, mm_filt, 17, is_max, "[17, 1024, 32768]")
        check_minmax(cube40, cube40[1], 40, is_max, "[40, 64, 32768]")
        check_minmax(small_cube, small_rows, 3, is_max, "[3, 5, 6243] (scratch)")
        check_minmax(t(seeded_words(rng, (2, 3, 40000))), t(seeded_words(rng, (3, 40000))),
                     2, is_max, "[2, 3, 40000] (scratch)")
        check_minmax(cube, mm_filt, 0, is_max, "depth 0")
    # tree_count: tapes of 3, 4 and 9 leaves with andnot and a duplicate
    # leaf, a tape past the kernel's stack limit (cut into sub-tapes), a
    # [W] leaf against [1024, W] stacks, and ragged and unaligned leaves;
    # shift_left at the word and shard edges, on a stack and a [W] leaf.
    from pilosa_tpu_torch.config import SHARD_WIDTH
    leaves9 = [big_a, big_b, filt_stack[3]] + [
        t(seeded_words(rng, (1024, w))) for _ in range(6)]
    tapes = {
        "3 leaves": [0, 1, "and", 2, "and"],
        "4 leaves, andnot": [0, 1, "or", 3, "andnot", 2, "xor"],
        "9 leaves, a duplicate": [0, 1, "and", 2, "or", 0, "andnot", 3, "xor",
                                  4, "and", 5, "or", 6, "and", 7, "or", 8,
                                  "andnot"],
        "9 deep (cut)": list(range(9)) + ["xor", "and", "or", "andnot"] * 2,
    }
    for what, tape in tapes.items():
        check_tree(leaves9, tape, f"[1024, 32768] x 9 ({what})")
    vec = [t(seeded_words(rng, (32768,))) for _ in range(3)]
    check_tree(vec, [0, 1, "and", 2, "andnot"], "[32768] x 3")
    ragged_a, ragged_b = t(seeded_words(rng, (7, 6243))), t(seeded_words(rng, (6243,)))
    check_tree([ragged_a, ragged_b], [0, 1, "xor", 0, "and"], "[7, 6243] x [6243]")
    check_tree([off_a[:, 1:], off_b[2, 1:], off_b[:, 1:]], [0, 1, "andnot", 2, "or"],
               "unaligned [5, 4100]")
    for n in (0, 1, 31, 32, 33, 1000, SHARD_WIDTH - 1, SHARD_WIDTH):
        check_shift(big_a, n, "[1024, 32768]")
        check_shift(vec[0], n, "[32768]")
        check_shift(off_a[:, 1:], n, "unaligned [5, 4100]")
    # The batched kernels, B = 8 slots of [1024, 32768] operands (slot 5
    # shares slot 3's b), every op; row counts over the same slots; one tape
    # over 8 slots' leaf tables: 3 leaves, and the 9-deep tape (cut: its
    # deep subtrees are written slot by slot by tree_count first); ragged
    # and unaligned slots take the scalar bodies.
    def new_plane():
        return t(seeded_words(rng, (1024, w)))

    batch_a, batch_b = batched_slots(new_plane, [big_a, big_b])
    for op in ("and", "or", "xor", "andnot"):
        check_batched("pair_count_batched", kernels.pair_count_batched(batch_a, batch_b, op),
                      kernels.pair_count_batched_plain(batch_a, batch_b, op),
                      f"8 x [1024, 32768] op={op}")
    check_batched("row_counts_batched", kernels.row_counts_batched(batch_a),
                  kernels.row_counts_batched_plain(batch_a), "8 x [1024, 32768]")
    tables3, tables24 = tree_batched_waves(new_plane, batch_a, batch_b)
    tables9 = [[batch_a[z]] + batch_b[:8] for z in range(8)]
    tape3, tape9 = TREE_BATCHED_TAPE, tapes["9 deep (cut)"]
    for tables, tape, what in ((tables3, tape3, "3 leaves"), (tables24, tape3, "24 planes"),
                               (tables9, tape9, "9 deep (cut)")):
        check_batched("tree_count_batched", kernels.tree_count_batched(tables, tape),
                      kernels.tree_count_batched_plain(tables, tape),
                      f"8 x [1024, 32768] ({what})")
    for tables in (tables3, tables24):
        plan = kernels.group_leaves([kernels.leaf_keys(ls) for ls in tables])
        log(f"tree_count_batched 8 x 3 x [1024, 32768]: {len(plan.leaves)} distinct "
            f"leaves in {len(plan.groups)} group(s)")
    rag = [t(seeded_words(rng, (7, 6243))) for _ in range(3)]
    check_batched("pair_count_batched", kernels.pair_count_batched(rag, rag[::-1], "xor"),
                  kernels.pair_count_batched_plain(rag, rag[::-1], "xor"), "3 x [7, 6243]")
    check_batched("row_counts_batched", kernels.row_counts_batched([off_a[:, 1:]] * 2),
                  kernels.row_counts_batched_plain([off_a[:, 1:]] * 2), "unaligned")
    check_batched("tree_count_batched",
                  kernels.tree_count_batched([rag, rag[::-1]], [0, 1, "andnot", 2, "or"]),
                  kernels.tree_count_batched_plain([rag, rag[::-1]], [0, 1, "andnot", 2, "or"]),
                  "2 x 3 x [7, 6243]")
    # tree_count_batched reads each distinct leaf of a slot group once
    # (kernels.group_leaves). 32 slots of a 16-leaf tape whose leaves are
    # 512 row windows of one pool -- views of one storage at 512 offsets, so
    # 512 distinct leaves -- need more than one slot group and still make
    # ONE launch, in the staged body and (a width that is not a multiple of
    # 4) in the body with plain loads; then two slots pushing views of one
    # storage at other offsets, and a view both push; then an unaligned
    # wave with a leaf two slots share and a [W] leaf.
    ops4 = ("and", "or", "xor", "andnot")

    def balanced(lo, hi):  # a tree over leaves [lo, hi): its stack reaches depth 5
        if hi - lo == 1:
            return [lo]
        mid = (lo + hi) // 2
        return balanced(lo, mid) + balanced(mid, hi) + [ops4[(lo + hi) % 4]]

    tapes16 = {"linear": [0] + [x for k in range(1, 16) for x in (k, ops4[k % 4])],
               "balanced": balanced(0, 16)}
    for pool_w in (w, 6243):
        pool = t(seeded_words(rng, (600, pool_w)))
        tables = [[pool[16 * z + k:16 * z + k + 64] for k in range(16)] for z in range(32)]
        keys = [kernels.leaf_keys(ls) for ls in tables]
        plan = kernels.group_leaves(keys)
        if len(plan.leaves) != 512 or len(plan.groups) < 2:
            raise AssertionError(f"32 x 16 wave: {len(plan.leaves)} leaves in "
                                 f"{len(plan.groups)} groups")
        for what, tape in tapes16.items():
            before = dict(kernels.LAUNCHES)
            got = kernels.tree_count_batched(tables, tape)
            delta = {k: kernels.LAUNCHES[k] - before[k] for k in before
                     if kernels.LAUNCHES[k] != before[k]}
            check_batched("tree_count_batched", got,
                          kernels.tree_count_batched_plain(tables, tape),
                          f"32 x 16 x [64, {pool_w}] {what}, {len(plan.groups)} groups")
            if delta != {"tree_count_batched": 1}:
                raise AssertionError(f"32 x 16 x [64, {pool_w}] {what} wave launched {delta}")
        log(f"tree_count_batched 32 x 16 x [64, {pool_w}]: 512 distinct leaves in "
            f"{len(plan.groups)} groups, one launch per tape "
            f"({', '.join(tapes16)}), exact")
    alias = t(seeded_words(rng, (1100, w)))
    for tables in ([[alias[0:1024], big_a, alias[8:1032]], [alias[8:1032], big_a, alias[0:1024]],
                    [alias[4:1028], big_b, alias[4:1028]]],
                   [[off_a[:, 1:], off_b[:, 1:], off_b[2, 1:]],
                    [off_b[:, 1:], off_a[:, 1:], off_b[2, 1:]]]):
        for tape in ([0, 1, "and", 2, "and"], [0, 1, "andnot", 2, "or"],
                     [0, 1, "or", 2, 0, "andnot", "xor"]):
            check_batched("tree_count_batched", kernels.tree_count_batched(tables, tape),
                          kernels.tree_count_batched_plain(tables, tape),
                          f"{len(tables)} x 3 x {tuple(tables[0][0].shape)} views {tape}")
    del pool, tables, alias
    # assemble_stack at 1024 shards: 16 dense rows, every other shard at
    # most 2048 bits as COO words (all-ones words in shard 20, bit-31-only
    # words in shard 21), pow2 padding aimed at row 1024, one past the
    # stack; then the edge cases of tests/test_torch_upload.py.
    def asm_tensors(inputs):
        return tuple(t(x) if x.dtype == np.uint32 else torch.from_numpy(x).to(dev)
                     for x in inputs[:5]) + (inputs[5],)

    asm = assemble_inputs(rng, 1024, 16, w)
    asm_args = asm_tensors(asm)
    check_assemble(asm_args, f"[1024, 32768], {asm[2].shape[0]} COO words")
    check_assemble(asm_tensors(assemble_inputs(rng, 5, 2, 6243)), "[5, 6243] (scalar)")
    for case in ASSEMBLE_CASES:
        check_assemble(asm_tensors(assemble_case(case)), case)
    # group_count, exact: bench config 5's lattice (levels of 4 and 8 rows
    # and a filter, the planner's 954 real rows of 1024-row stacks), three
    # levels (4, 8, 3) with no filter, unaligned views and a ragged width
    # (scalar staging), a lattice whose 450 planes overflow the staged
    # tiles (the body reading device memory), one of 8192 groups (64 KB of
    # accumulators), and 4 and 5 levels (the unrolled and the predicated
    # bodies).
    def lattice_table(sizes):
        starts = np.cumsum([0] + list(sizes[:-1]))
        return np.asarray(list(itertools.product(
            *[range(int(a), int(a) + n) for a, n in zip(starts, sizes)])), dtype=np.int64)

    def check_group(planes, sizes, filt, what):
        table = lattice_table(sizes)
        got = kernels.group_count(planes, table, filt)
        want = kernels.group_count_plain(planes, torch.from_numpy(table), filt)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        errs["group_count"] = max(errs["group_count"], err)
        if got.shape != want.shape or got.dtype != torch.int64 or err:
            raise AssertionError(f"group_count {what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)}, max |err| {err}")

    gb_planes = [t(seeded_words(rng, (1024, w)))[:954] for _ in range(15)]
    gb_filt = big_b[:954]
    check_group(gb_planes[:12], (4, 8), gb_filt, "(4, 8) + filter, 954 x 32768")
    check_group(gb_planes, (4, 8, 3), None, "(4, 8, 3), 954 x 32768")
    offs = [t(seeded_words(rng, (5, 4101)))[:, 1:] for _ in range(6)]
    check_group(offs, (3, 3), off_a[:, 1:], "(3, 3) + filter, unaligned [5, 4100]")
    rag_p = [t(seeded_words(rng, (7, 6243))) for _ in range(7)]
    check_group(rag_p, (2, 5), rag_p[0], "(2, 5) + filter, [7, 6243]")
    many = t(seeded_words(rng, (450, 3, 300)))
    check_group(list(many), (450,), None, "450 planes of [3, 300]")
    wide = t(seeded_words(rng, (192, 4, 1000)))
    check_group(list(wide), (64, 128), wide[0], "(64, 128) + filter: 8192 groups")
    wide2 = t(seeded_words(rng, (289, 3, 300)))
    check_group(list(wide2[:288]), (32, 256), wide2[288],
                "(32, 256) + filter: 8192 groups over 288 planes (unstaged)")
    deep = [t(seeded_words(rng, (6, 2000))) for _ in range(11)]
    check_group(deep[:10], (2, 2, 2, 2, 2), deep[10], "5 levels + filter (predicated)")
    check_group(deep[:8], (2, 2, 2, 2), None, "4 levels")
    del offs, rag_p, many, wide, wide2, deep
    del leaves9, tables9
    log(f"kernel checks: exact on every op and shape; max |err| {errs}")

    # Times at the shapes of the paths: the 2-leaf and bare-leaf Count
    # over 954 shards padded to 1024, a TopN tile against its filter, and
    # the BSI path's depth-17 cube against its filter or class row. "ms" is
    # the wrapper's device time per call (the kernel and its output
    # allocation), median of KERNEL_RUNS.
    rows = 1024
    plane = rows * w * 4
    bsi_pred = 50000
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
         lambda: kernels.pair_count(stack, filt_stack[3], "and"),
         lambda: kernels.pair_count_plain(stack, filt_stack[3], "and"),
         512 * w * 4 + w * 4 + 512 * 4, OPS_PER_WORD * 512 * w),
        ("pair_count", "[17, 1024, 32768] x [1024, 32768]",
         lambda: kernels.pair_count(cube, cls, "and"),
         lambda: kernels.pair_count_plain(cube, cls, "and"),
         18 * plane + 17 * rows * 4, OPS_PER_WORD * 17 * rows * w),
        # per word and plane: 2 ops for the predicate mask, 7 for lt/gt/eq
        ("bsi_compare", "[17, 1024, 32768] x [1024, 32768]",
         lambda: kernels.bsi_compare(cube, filt, bsi_pred, 0, 17, "gt", False),
         lambda: kernels.bsi_compare_plain(cube, filt, bsi_pred, 0, 17, "gt", False),
         19 * plane, 9 * 17 * rows * w),
        # per word and plane: narrow, popcount, add
        ("bsi_minmax", "[17, 1024, 32768] x [1024, 32768]",
         lambda: kernels.bsi_minmax(cube, filt, 17, True),
         lambda: kernels.bsi_minmax_plain(cube, filt, 17, True),
         18 * plane + 3 * rows * 4, OPS_PER_WORD * 17 * rows * w),
        # per word: two ands, a popcount, an add
        ("tree_count", "3 x [1024, 32768] (and, and)",
         lambda: kernels.tree_count(tree3, [0, 1, "and", 2, "and"]),
         lambda: kernels.tree_count_plain(tree3, [0, 1, "and", 2, "and"]),
         3 * plane + rows * 4, 4 * rows * w),
        ("tree_count", "3 x [1024, 32768] (and, and), plane written",
         lambda: kernels.tree_count(tree3, [0, 1, "and", 2, "and"], True),
         lambda: kernels.tree_count_plain(tree3, [0, 1, "and", 2, "and"], True),
         4 * plane + rows * 4, 4 * rows * w),
        # per word: two shifts, an or
        ("shift_left", "[1024, 32768], n = 33",
         lambda: kernels.shift_left(big_a, 33),
         lambda: kernels.shift_left_plain(big_a, 33),
         2 * plane, 3 * rows * w),
        # each distinct operand read once: 8 a's and 7 b's (one shared)
        ("pair_count_batched", "8 x [1024, 32768] x [1024, 32768], one b shared",
         lambda: kernels.pair_count_batched(batch_a, batch_b, "and"),
         lambda: kernels.pair_count_batched_plain(batch_a, batch_b, "and"),
         15 * plane + 8 * rows * 4, OPS_PER_WORD * 8 * rows * w),
        # a TopN pass at 10M columns: 10 shards' 3 tiles of 512 rows, each
        # against its shard's filter row, in one launch
        ("pair_count_batched", "30 x [512, 32768] x [32768] (a TopN pass's tiles)",
         lambda: kernels.pair_count_batched(topn_tiles, topn_filts, "and"),
         lambda: kernels.pair_count_batched_plain(topn_tiles, topn_filts, "and"),
         30 * 512 * w * 4 + 10 * w * 4 + 30 * 512 * 4, OPS_PER_WORD * 30 * 512 * w),
        ("row_counts_batched", "8 x [1024, 32768]",
         lambda: kernels.row_counts_batched(batch_a),
         lambda: kernels.row_counts_batched_plain(batch_a),
         8 * plane + 8 * rows * 4, 2 * 8 * rows * w),
        # 8 slots x 3 leaves over 15 distinct planes (a[z], b[z], a[z+1];
        # slot 5 pushes slot 3's b), each read once
        ("tree_count_batched", "8 x 3 x [1024, 32768] (and, and), 15 distinct planes",
         lambda: kernels.tree_count_batched(tables3, tape3),
         lambda: kernels.tree_count_batched_plain(tables3, tape3),
         15 * plane + 8 * rows * 4, 4 * 8 * rows * w),
        # the same wave with no leaf shared
        ("tree_count_batched", "8 x 3 x [1024, 32768] (and, and), 24 distinct planes",
         lambda: kernels.tree_count_batched(tables24, tape3),
         lambda: kernels.tree_count_batched_plain(tables24, tape3),
         24 * plane + 8 * rows * 4, 4 * 8 * rows * w),
        # the stack written once, the dense rows and COO words read once
        ("assemble_stack", f"[1024, 32768], 16 dense rows, {asm[2].shape[0]} COO words",
         lambda: kernels.assemble_stack(*asm_args),
         lambda: kernels.assemble_stack_plain(*asm_args),
         plane + asm[1].nbytes + 12 * asm[2].shape[0] + asm[0].nbytes, 0),
        # each distinct plane and the filter read once; per group and word:
        # the ANDs (one per level, the filter's included), popcount, add
        ("group_count", "(4, 8) + filter: 32 groups, 12 planes + filter of [954, 32768]",
         lambda: kernels.group_count(gb_planes[:12], gb_table, gb_filt),
         lambda: kernels.group_count_plain(gb_planes[:12], gb_table_t, gb_filt),
         13 * 954 * w * 4 + 32 * 8, (2 + 2) * 32 * 954 * w),
        ("group_count", "(4, 8, 3): 96 groups, 15 planes of [954, 32768]",
         lambda: kernels.group_count(gb_planes, gb_table3, None),
         lambda: kernels.group_count_plain(gb_planes, gb_table3_t, None),
         15 * 954 * w * 4 + 96 * 8, (2 + 2) * 96 * 954 * w),
    ]
    gb_table = lattice_table((4, 8))
    gb_table_t = torch.from_numpy(gb_table)
    gb_table3 = lattice_table((4, 8, 3))
    gb_table3_t = torch.from_numpy(gb_table3)
    topn_tiles = [t(seeded_words(rng, (512, w))) for _ in range(30)]
    topn_filts = [filt_stack[i // 3] for i in range(30)]
    check_batched("pair_count_batched", kernels.pair_count_batched(topn_tiles, topn_filts, "and"),
                  kernels.pair_count_batched_plain(topn_tiles, topn_filts, "and"),
                  "30 x [512, 32768] x [32768]")
    # The library calls beside assemble_stack: the same function from
    # PyTorch calls (a zeroed stack with the trash row the padding aims
    # at, index_put_ of the dense rows, index_put_ of the COO words, the
    # trash row cut off), and index_put_ of the COO words alone into a
    # stack already zeroed.
    lib_out = torch.zeros((1025, w), dtype=torch.int32, device=dev)
    lib_didx = (asm_args[0].long(),)
    lib_idx = (asm_args[2].long(), asm_args[3].long())

    def assemble_library():
        out = torch.zeros((1025, w), dtype=torch.int32, device=dev)
        out.index_put_(lib_didx, asm_args[1])
        return out.index_put_(lib_idx, asm_args[4])[:1024]

    if not torch.equal(assemble_library(), kernels.assemble_stack(*asm_args)):
        raise AssertionError("assemble_stack: the library calls compute another stack")
    library = {"assemble_stack": assemble_library}
    tree3 = [big_a, big_b, t(seeded_words(rng, (1024, w)))]
    # The path the 3-leaf Count took before tree_count: two elementwise
    # torch ops writing 128 MiB planes, then row_counts.
    torch_ms = time_cuda_ms(torch, lambda: kernels.row_counts(
        (tree3[0] & tree3[1]) & tree3[2]), KERNEL_RUNS)
    log(f"3-leaf Count on the torch-ops path (and, and, row_counts): "
        f"{torch_ms:.4f} ms, 7 planes moved  [{card}]")
    timings = {}
    for name, shape, fn, plain_fn, nbytes, ops in cases:
        ms = time_cuda_ms(torch, fn, KERNEL_RUNS)
        plain = time_cuda_ms(torch, plain_fn, 5)
        bound, by = bound_ms(nbytes, ops)
        lib = time_cuda_ms(torch, library[name], KERNEL_RUNS) if name in library else None
        lib_text = f"; library {lib:.4f} ms" if lib is not None else ""
        if name == "assemble_stack":
            alone = time_cuda_ms(torch, lambda: lib_out.index_put_(lib_idx, asm_args[4]),
                                 KERNEL_RUNS)
            lib_text += f" (same function), index_put_ of the COO words alone {alone:.4f} ms"
        if name == "group_count":
            host = statistics.median(host_enqueue_times(torch, fn, KERNEL_RUNS))
            lib_text += (f"; host enqueue {host:.4f} ms (median); library none "
                         "(torch has no popcount)")
        log(f"kernel {name} {shape}: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{bound / ms:.1%} of bound; plain {plain:.4f} ms{lib_text}  [{card}]")
        timings.setdefault(name, (ms, plain, bound, by, lib))
    # Two floors beside assemble_stack at the same shape: the kernel on the
    # same dense rows with no COO words (every tile stored straight, no
    # shared-memory tile), and torch.zeros of the stack (the card's write
    # rate for these bytes).
    no_coo = asm_args[:2] + tuple(x[:0] for x in asm_args[2:5]) + (asm_args[5],)
    floor_ms = time_cuda_ms(torch, lambda: kernels.assemble_stack(*no_coo), KERNEL_RUNS)
    zeros_ms = time_cuda_ms(torch, lambda: torch.zeros((1024, w), dtype=torch.int32,
                                                       device=dev), KERNEL_RUNS)
    log(f"assemble_stack floors at [1024, 32768]: no COO words {floor_ms:.4f} ms; "
        f"torch.zeros of the stack {zeros_ms:.4f} ms  [{card}]")
    del cube, cube40, tree3, batch_a, batch_b, tables3, tables24, lib_out, topn_tiles
    del gb_planes
    log(f"kernels: {json.dumps(sorted(errs))}")
    # Hand the cached blocks back: the persist phase's CLI node is a
    # process of its own on the same card.
    torch.cuda.empty_cache()
    return {"timings": timings, "errs": errs, "torch_3leaf_ms": torch_ms}


# -- phase 3: the node and its data, built once -------------------------------


def http_client(port: int):
    """One keep-alive HTTP/1.1 connection to the node on loopback."""
    import http.client
    return http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)


def request(conn, method: str, path: str, body=None, headers=None) -> tuple[int, bytes]:
    if isinstance(body, (dict, list)):
        body = json.dumps(body)
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    return r.status, r.read()


def expect_ok(conn, method: str, path: str, body=None) -> bytes:
    status, out = request(conn, method, path, body)
    if status != 200:
        raise AssertionError(f"{method} {path}: HTTP {status} {out[:300]!r}")
    return out


def build_count_index(h, n_shards: int, density: float, seed: int):
    """bench.py's star-trace data: f row 1 and g row 2 at ``density`` over
    ``n_shards`` shards, from seeded random positions through
    ``Field.import_bits``. Position generation is set-up and is freed right
    after each import."""
    from pilosa_tpu_torch.config import SHARD_WIDTH

    idx = h.create_index_if_not_exists("bench")
    n_cols = n_shards * SHARD_WIDTH
    n_bits = int(n_cols * density)
    rng = np.random.default_rng(seed)
    import_s = 0.0
    for field, row in (("f", 1), ("g", 2)):
        fld = idx.create_field_if_not_exists(field)
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

    h.create_index_if_not_exists("topn")
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


def topn_counts(data: dict) -> dict:
    """shard -> (popcount(f2 row & g) per row, popcount(f2 row) per row,
    popcount(g)), int64, from the host words of build_topn_index."""
    return {s: (popcount_rows(f2 & g[None, :]), popcount_rows(f2),
                int(popcount_rows(g)))
            for s, (f2, g) in data.items()}


def topn_oracle(counts: dict, n: int, keep=None) -> list[tuple[int, int]]:
    """The executor's two-pass TopN (reference executor.go:857) in numpy,
    over ``topn_counts``: pass 1 takes each shard's top ``n`` rows with a
    count >= 1 that ``keep(shard, ids, counts)`` admits (count desc, id
    asc) as candidates; pass 2 sums every candidate's admitted counts over
    all shards and keeps the top ``n``."""
    def admitted(s, ids):
        c = counts[s][0][ids]
        m = c > 0
        if keep is not None:
            m &= keep(s, ids, c)
        return ids[m], c[m]

    cands: set[int] = set()
    for s, (inter, _, _) in counts.items():
        ids, c = admitted(s, np.arange(len(inter)))
        order = np.lexsort((ids, -c))
        cands.update(int(i) for i in ids[order][:n])
    if not cands:
        return []
    cand = np.array(sorted(cands))
    totals: dict[int, int] = {}
    for s in counts:
        for i, c in zip(*admitted(s, cand)):
            totals[int(i)] = totals.get(int(i), 0) + int(c)
    ranked = sorted(totals.items(), key=lambda p: (-p[1], p[0]))
    return ranked[:n]


def bsi_data(n_shards: int, seed: int):
    """bench.py's config 3 at ``n_shards`` shards: sorted distinct columns
    on BSI_DENSITY of the column space with values uniform in [BSI_MIN,
    BSI_MAX), and BSI_FILTER_BITS (scaled to the shards) random filter
    positions."""
    from pilosa_tpu_torch.config import SHARD_WIDTH

    n_cols = n_shards * SHARD_WIDTH
    k = int(n_cols * BSI_DENSITY)
    rng = np.random.default_rng(seed)
    # distinct columns without a 1B-entry permutation: oversample, dedupe,
    # keep k of them at random
    u = np.unique(rng.integers(0, n_cols, int(k * 1.05) + 16, dtype=np.int64))
    cols = np.sort(u[rng.permutation(len(u))[:k]])
    vals = rng.integers(BSI_MIN, BSI_MAX, k, dtype=np.int64)
    n_filt = max(1, BSI_FILTER_BITS * n_shards // COUNT_SHARDS)
    fpos = rng.integers(0, n_cols, n_filt, dtype=np.int64)
    return n_cols, cols, vals, fpos


def bsi_planes(cols: np.ndarray, vals: np.ndarray, n_shards: int, depth: int):
    """[2 + depth, n_shards, W] uint32 planes (exists, sign, magnitude
    bits) of distinct columns, built with one bincount per plane: the bits
    of a word are distinct, so their sum is their OR."""
    from pilosa_tpu_torch.config import WORDS_PER_SHARD

    gword = cols >> 5  # column // 32 is (shard, word) in row-major order
    bit = np.left_shift(np.uint64(1), (cols & 31).astype(np.uint64)).astype(np.float64)
    mag = np.abs(vals)
    masks = [None, vals < 0] + [((mag >> i) & 1) == 1 for i in range(depth)]
    out = np.empty((2 + depth, n_shards, WORDS_PER_SHARD), dtype=np.uint32)
    for j, m in enumerate(masks):
        w = np.bincount(gword if m is None else gword[m],
                        weights=bit if m is None else bit[m],
                        minlength=n_shards * WORDS_PER_SHARD)
        out[j] = w.astype(np.uint32).reshape(n_shards, WORDS_PER_SHARD)
    return out


def extreme_oracle(shards: np.ndarray, vals: np.ndarray, is_min: bool):
    """The executor's Min/Max over values grouped by (ascending) shard:
    each shard's extreme and how many of its values equal it; the global
    extreme takes the count of the FIRST shard holding it (counts do not
    add across shards, reference ValCount.smaller/larger)."""
    if len(vals) == 0:
        return {"value": 0, "count": 0}
    starts = np.flatnonzero(np.r_[True, shards[1:] != shards[:-1]])
    ext = (np.minimum if is_min else np.maximum).reduceat(vals, starts)
    per_val = np.repeat(ext, np.diff(np.r_[starts, len(vals)]))
    counts = np.add.reduceat((vals == per_val).astype(np.int64), starts)
    best = ext.min() if is_min else ext.max()
    first = int(np.flatnonzero(ext == best)[0])
    return {"value": int(best), "count": int(counts[first])}


def phase_data(torch, card: str, data: dict, device: str = "cuda",
               count_shards: int = COUNT_SHARDS, topn_cols: int = TOPN_COLS,
               topn_rows: int = TOPN_ROWS, bsi_shards: int = BSI_SHARDS) -> dict:
    """Boot the node, create the schema over HTTP, load the three datasets
    into ``node.holder`` with ``build_*_index`` and compute the numpy oracles.
    Every later phase reads ``data``: the in-process phases through their
    own ``Executor``, the HTTP phase through the node."""
    from pilosa_tpu_torch.config import SHARD_WIDTH
    from pilosa_tpu_torch.server import ServerNode

    t0 = time.perf_counter()
    from pilosa_tpu_torch.ops import build

    # build/kernels/ as the node's kernel build cache, before any node with
    # a data dir could move it into its own dir.
    node = data["node"] = ServerNode(bind="127.0.0.1:0", device=device,
                                     compile_cache_dir=str(build.BUILD_DIR))
    node.open()
    data["device"] = device
    h = data["holder"] = node.holder
    log(f"node: {node.address} on {h.device}, booted in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    conn = http_client(node.port)
    for path, opts in SCHEMA:
        expect_ok(conn, "POST", path, {"options": opts} if opts else None)
    schema = json.loads(expect_ok(conn, "GET", "/schema"))
    fields = {i["name"]: [f["name"] for f in i["fields"]] for i in schema["indexes"]}
    if fields != {"bench": ["f", "g"], "bsi": ["f", "v"], "topn": ["f2", "g"]}:
        raise AssertionError(f"schema over HTTP: {fields}")
    conn.close()
    log(f"schema over HTTP: {fields}")

    n_cols, n_bits, import_s = build_count_index(h, count_shards, COUNT_DENSITY, SEED)
    log(f"count index: {count_shards} shards, {n_cols} columns, 2 rows x "
        f"{n_bits} random positions; import_bits {import_s:.3f} s (host)")
    fw = np.stack([h.fragment("bench", "f", "standard", s).row_words(1)
                   for s in range(count_shards)])
    gw = np.stack([h.fragment("bench", "g", "standard", s).row_words(2)
                   for s in range(count_shards)])
    data["want_count"] = {
        "count_intersect": int(popcount_rows(fw & gw).sum()),
        "count_row": int(popcount_rows(fw).sum()),
        "count_3leaf": int(popcount_rows((fw & gw) | gw).sum()),
    }
    data["count_cols"], data["count_shards"] = n_cols, count_shards
    del fw, gw

    t0 = time.perf_counter()
    words = build_topn_index(torch, h, topn_cols, topn_rows, SEED + 1)
    log(f"topn index: {len(words)} shards, {topn_cols} columns, {topn_rows} "
        f"rows; made and loaded in {time.perf_counter() - t0:.3f} s")
    data["topn_counts"] = topn_counts(words)
    data["want_topn"] = topn_oracle(data["topn_counts"], 10)
    del words
    if not all(h.fragment("topn", "f2", "standard", 0).rows[r].is_dense
               for r in range(topn_rows)):
        raise AssertionError("TopN rows must be dense")

    t0 = time.perf_counter()
    n_cols, cols, vals, fpos = bsi_data(bsi_shards, SEED + 2)
    idx = h.index_or_raise("bsi")
    opts = idx.field("v").options
    planes = bsi_planes(cols, vals, bsi_shards, idx.field("v").bsi_group.bit_depth)
    from pilosa_tpu_torch import interop
    for shard in range(bsi_shards):
        interop.load_bsi_planes(h, "bsi", "v", shard, planes[:, shard], opts)
    del planes
    idx.field("f").import_bits(np.ones(len(fpos), dtype=np.uint64),
                               fpos.astype(np.uint64))
    log(f"bsi index: {bsi_shards} shards, {n_cols} columns, {len(vals)} values in "
        f"[{BSI_MIN}, {BSI_MAX}) at depth {idx.field('v').bsi_group.bit_depth}, "
        f"filter of {len(fpos)} positions; made and loaded through interop in "
        f"{time.perf_counter() - t0:.3f} s (host)")
    shards = cols >> SHARD_WIDTH.bit_length() - 1
    in_f = np.isin(cols, fpos)
    neg = vals < 0
    data["want_bsi"] = {
        "sum": {"value": int(vals.sum()), "count": len(vals)},
        "min": extreme_oracle(shards, vals, True),
        "max": extreme_oracle(shards, vals, False),
        "sum_filtered": {"value": int(vals[in_f].sum()), "count": int(in_f.sum())},
        "count_gt": int((vals > 50000).sum()),
        "count_between": int(((vals >= -1000) & (vals <= 1000)).sum()),
        "max_of_negatives": extreme_oracle(shards[neg], vals[neg], False),
    }
    data["bsi_values"] = (cols, vals)  # for the import_values check; freed there
    data["bsi_shards"], data["bsi_cols"] = bsi_shards, n_cols
    return {}


# -- phase 4: the main path in process ----------------------------------------


def p50_ms(fn, runs: int) -> tuple[float, str]:
    """(median ms, "p25 x, p75 y" spread) of ``runs`` host-clock calls."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    q1, _, q3 = statistics.quantiles(times, n=4)
    return statistics.median(times), f"p25 {q1:.4f}, p75 {q3:.4f}"


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


def phase_main_path(torch, card: str, data: dict, runs: int = QUERY_RUNS) -> dict:
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import Planner

    device, h = data["device"], data["holder"]
    want, want_topn = data["want_count"], data["want_topn"]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ex = Executor(h, planner=Planner(h), result_cache=False)
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
        for k in ("pair_count", "row_counts", "tree_count"):
            if main_launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the main path")
        three = launches["count_3leaf"]
        if three["tree_count"] != 1 or three["row_counts"] or three["pair_count"]:
            raise AssertionError(f"the 3-leaf Count launched {three}, not one "
                                 "tree_count")
    log(f"first-run ms (stacks built and uploaded): "
        f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")

    lat = {}
    for name, q in COUNT_QUERIES.items():
        lat[name] = p50_ms(lambda q=q: ex.execute("bench", q), runs)
    lat["topn"] = p50_ms(lambda: ex.execute("topn", TOPN_QUERY), runs)
    for name, (ms, spread) in lat.items():
        q = COUNT_QUERIES.get(name, TOPN_QUERY)
        log(f"p50 {q}: {ms:.4f} ms ({spread}) over {runs} runs, warm stacks, "
            f"host clock to the answer on the host  [{card}]")
    if device == "cuda":
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for index, q in (("bench", COUNT_QUERIES["count_intersect"]), ("topn", TOPN_QUERY)):
            busy, wall = device_busy_ms(torch, lambda index=index, q=q: ex.execute(index, q),
                                        PROFILE_RUNS)
            share = f"{busy / wall:.1%} busy" if busy else "device time not measured"
            log(f"profile {q}: device {busy:.4f} ms of {wall:.4f} ms wall per query "
                f"({share}), torch.profiler over {PROFILE_RUNS} runs  [{card}]")
    return {"launches": main_launches}


# -- phase 5: the BSI path in process -----------------------------------------


def phase_bsi(torch, card: str, data: dict, runs: int = QUERY_RUNS) -> dict:
    from pilosa_tpu_torch.config import SHARD_WIDTH
    from pilosa_tpu_torch.core import FieldOptions
    from pilosa_tpu_torch.exec import Executor, result_to_json
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import Planner

    device, h, want = data["device"], data["holder"], data["want_bsi"]
    n_shards = data["bsi_shards"]
    cols, vals = data.pop("bsi_values")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    idx = h.index_or_raise("bsi")
    depth = idx.field("v").bsi_group.bit_depth

    # Field.import_values writes the same planes as the interop load:
    # BSI_IMPORT_SHARDS shards, or every shard when that projects under
    # BSI_FULL_IMPORT_S.
    shard_of = cols >> SHARD_WIDTH.bit_length() - 1
    vi = idx.create_field("vi", FieldOptions(type="int", min=BSI_MIN, max=BSI_MAX))
    cut = int(np.searchsorted(shard_of, BSI_IMPORT_SHARDS))
    t0 = time.perf_counter()
    vi.import_values(cols[:cut], vals[:cut])
    part_s = time.perf_counter() - t0
    projected = part_s * n_shards / BSI_IMPORT_SHARDS
    checked = min(BSI_IMPORT_SHARDS, n_shards)
    if projected < BSI_FULL_IMPORT_S and n_shards > BSI_IMPORT_SHARDS:
        t0 = time.perf_counter()
        vi.import_values(cols[cut:], vals[cut:])
        part_s += time.perf_counter() - t0
        checked = n_shards
    for shard in range(checked):
        a = h.fragment("bsi", "v", "bsig_v", shard)
        b = h.fragment("bsi", "vi", "bsig_vi", shard)
        for r in range(2 + depth):
            if not np.array_equal(a.row_words(r), b.row_words(r)):
                raise AssertionError(f"import_values plane {r} of shard {shard} "
                                     "differs from the interop planes")
    scope = "all" if checked == n_shards else f"projected {projected:.3f} s for all"
    log(f"Field.import_values: {checked} of {n_shards} shards ({scope}) "
        f"in {part_s:.3f} s (host); planes equal to the interop planes")
    del cols, vals, shard_of
    idx.delete_field("vi")

    ex = Executor(h, planner=Planner(h), result_cache=False)
    launches, first_ms = {}, {}
    # The BSI path's run: counters at 0 just before, read just after.
    kernels.reset_launches()
    for name, q in BSI_QUERIES.items():
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        (got,) = ex.execute("bsi", q)
        first_ms[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        got = result_to_json(got)
        if got != want[name]:
            raise AssertionError(f"{q}: got {got}, numpy oracle {want[name]}")
        log(f"{q} = {got} (numpy oracle equal), launches {launches[name]}")
    path_launches = dict(kernels.LAUNCHES)
    log(f"bsi path launches: {path_launches}")
    if device == "cuda":
        for k in BSI_KERNELS:
            if path_launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the BSI path")
        # Sum's per-plane counts are the only pair_count calls of a Sum:
        # the cube against a class row, the broadcast shape.
        if launches["sum"]["pair_count"] < 2:
            raise AssertionError("Sum did not count its cube with pair_count")
    log(f"bsi first-run ms (stacks and cube built and uploaded): "
        f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")
    for name, q in BSI_QUERIES.items():
        ms, spread = p50_ms(lambda q=q: ex.execute("bsi", q), runs)
        log(f"p50 {q}: {ms:.4f} ms ({spread}) over {runs} runs, warm stacks, "
            f"host clock to the answer on the host  [{card}]")
    if device == "cuda":
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for name in BSI_PROFILED:
            q = BSI_QUERIES[name]
            busy, wall = device_busy_ms(torch, lambda q=q: ex.execute("bsi", q),
                                        PROFILE_RUNS)
            share = f"{busy / wall:.1%} busy" if busy else "device time not measured"
            log(f"profile {q}: device {busy:.4f} ms of {wall:.4f} ms wall per query "
                f"({share}), torch.profiler over {PROFILE_RUNS} runs  [{card}]")
    return {"launches": path_launches}


# -- phase 6: every query through the HTTP edge -------------------------------


def http_queries(data: dict) -> list[tuple[str, str, str, object]]:
    """(index, name, PQL, oracle result) of every query the paths ask."""
    out = [("bench", name, q, data["want_count"][name]) for name, q in COUNT_QUERIES.items()]
    out.append(("topn", "topn", TOPN_QUERY,
                [{"id": i, "count": c} for i, c in data["want_topn"]]))
    out += [("bsi", name, q, data["want_bsi"][name]) for name, q in BSI_QUERIES.items()]
    return out


def spread_ms(times: list[float]) -> str:
    q1, q2, q3 = statistics.quantiles(times, n=4)
    return f"p50 {q2:.4f} (p25 {q1:.4f}, p75 {q3:.4f})"




def http_import_check(conn, data: dict, card: str) -> None:
    """One JSON import of HTTP_IMPORT_N bits into a new set field and one
    of about HTTP_IMPORT_N values into a new int field, each checked by
    Count over HTTP against numpy."""
    rng = np.random.default_rng(SEED + 3)
    n_cols = data["count_cols"]
    rows = rng.integers(0, 4, HTTP_IMPORT_N, dtype=np.int64)
    cols = rng.integers(0, n_cols, HTTP_IMPORT_N, dtype=np.int64)
    expect_ok(conn, "POST", "/index/bench/field/j")
    body = json.dumps({"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    t0 = time.perf_counter()
    expect_ok(conn, "POST", "/index/bench/field/j/import", body)
    bits_ms = (time.perf_counter() - t0) * 1e3
    pairs = np.unique(rows * n_cols + cols)
    checks = [("bench", f"Count(Row(j={r}))", int((pairs // n_cols == r).sum()))
              for r in range(4)]

    vcols = np.unique(rng.integers(0, data["bsi_cols"], HTTP_IMPORT_N, dtype=np.int64))
    vals = rng.integers(BSI_MIN, BSI_MAX, len(vcols), dtype=np.int64)
    expect_ok(conn, "POST", "/index/bsi/field/w",
              {"options": {"type": "int", "min": BSI_MIN, "max": BSI_MAX}})
    body = json.dumps({"columnIDs": vcols.tolist(), "values": vals.tolist()})
    t0 = time.perf_counter()
    expect_ok(conn, "POST", "/index/bsi/field/w/import", body)
    vals_ms = (time.perf_counter() - t0) * 1e3
    checks += [("bsi", "Count(Row(w != null))", len(vcols)),
               ("bsi", "Count(Row(w > 50000))", int((vals > 50000).sum())),
               ("bsi", "Sum(field=w)", {"value": int(vals.sum()), "count": len(vcols)})]
    for index, q, want in checks:
        got = json.loads(expect_ok(conn, "POST", QUERY_PATH.format(index), q))["results"][0]
        if got != want:
            raise AssertionError(f"{q} after the HTTP import: {got}, numpy {want}")
    log(f"HTTP JSON import: {HTTP_IMPORT_N} bits in {bits_ms:.3f} ms, {len(vcols)} "
        f"values in {vals_ms:.3f} ms (client clock); {len(checks)} Counts over HTTP "
        f"equal to numpy  [{card}]")


def client_load(port: int, mix: list, clients: int, per_client: int):
    """``clients`` threads, each sending ``per_client`` requests of ``mix``
    ((index, PQL, expected body bytes)) in turn on its own keep-alive
    connection: (latencies ms, wall s, wrong answers)."""
    lat, errors = [], []
    lock = threading.Lock()

    def client(k):
        c = http_client(port)
        try:
            for i in range(per_client):
                index, q, want_body = mix[(k + i) % len(mix)]
                t0 = time.perf_counter()
                status, body = request(c, "POST", QUERY_PATH.format(index), q)
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    lat.append(ms)
                    if status != 200 or body != want_body:
                        errors.append((q, status, body[:200].decode(errors="replace")))
        except Exception as e:  # reported by the caller, as a failed answer
            with lock:
                errors.append(("client", k, repr(e)))
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lat, time.perf_counter() - t0, errors


def clients_main() -> int:
    """``chip_smoke.py --clients``: the client load of ``run_clients`` in a
    process of its own (a JSON spec on stdin, one JSON line of results on
    stdout), so the clients' HTTP work does not take the server's
    interpreter lock."""
    spec = json.loads(sys.stdin.read())
    mix = [(i, q, body.encode()) for i, q, body in spec["mix"]]
    lat, wall, errors = client_load(spec["port"], mix, spec["clients"],
                                    spec["per_client"])
    print(json.dumps({"lat": lat, "wall": wall, "errors": errors[:3],
                      "n_errors": len(errors)}))
    return 0


def run_clients(port: int, mix: list, launches_of: dict, clients: int,
                per_client: int, in_process: bool = False):
    """``clients`` clients, each sending ``per_client`` requests of ``mix``
    ((index, PQL, expected body)) in turn on its own connection, from a
    process of their own (``clients_main``) or, with ``in_process``, from
    threads of this one, which share the server's interpreter lock. Returns
    (latencies ms, wall s, launches counted, launches expected); raises if
    any answer differs from its expected body."""
    from pilosa_tpu_torch.ops import kernels

    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for k in range(clients):
        for i in range(per_client):
            for kern, v in launches_of[mix[(k + i) % len(mix)][1]].items():
                want[kern] += v
    kernels.reset_launches()
    if in_process:
        lat, wall, errors = client_load(port, mix, clients, per_client)
        n_errors = len(errors)
    else:
        spec = {"port": port, "clients": clients, "per_client": per_client,
                "mix": [(i, q, body.decode()) for i, q, body in mix]}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--clients"],
                              input=json.dumps(spec), capture_output=True, text=True,
                              timeout=HTTP_TIMEOUT_S * 2)
        if proc.returncode != 0:
            raise AssertionError(f"client process failed: {proc.stderr[-2000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        lat, wall, errors, n_errors = out["lat"], out["wall"], out["errors"], out["n_errors"]
    if n_errors:
        raise AssertionError(f"{n_errors} answers of {clients} clients wrong: "
                             f"{errors[:3]}")
    return lat, wall, dict(kernels.LAUNCHES), want


#: the request-thread stack sampler's period.
STACK_SAMPLE_S = 0.002


def sample_stacks(stop: threading.Event, counts: dict) -> None:
    """Until ``stop``: every STACK_SAMPLE_S, for each thread serving an HTTP
    request (its stack holds the port's ``server/httpd.py``), count the
    innermost frame in the port's package as ``file:function`` -- where
    the request threads are, running or waiting for the interpreter lock
    at that line."""
    me = threading.get_ident()
    while not stop.wait(STACK_SAMPLE_S):
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            inner, serving, f = None, False, frame
            while f is not None:
                name = f.f_code.co_filename
                if "pilosa_tpu_torch" in name:
                    if inner is None:
                        inner = f"{Path(name).parent.name}/{Path(name).name}:{f.f_code.co_name}"
                    if name.endswith("httpd.py"):
                        serving = True
                f = f.f_back
            if serving:
                counts[inner] = counts.get(inner, 0) + 1


def phase_http(torch, card: str, data: dict, runs: int = QUERY_RUNS,
               n_threads: int = HTTP_THREADS, per_thread: int = HTTP_PER_THREAD) -> dict:
    """Every query of the paths through ``POST /index/{i}/query`` on the
    node: each body equal to the numpy oracle and byte-equal to the JSON of
    ``node.executor.execute`` on the same holder, with the same launches per
    request; warm latencies beside the in-process ones; /metrics; 8
    concurrent clients; a JSON import; the error statuses."""
    from pilosa_tpu_torch.exec import result_to_json
    from pilosa_tpu_torch.ops import kernels

    device, node = data["device"], data["node"]
    ex = node.executor
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    conn = http_client(node.port)
    queries = http_queries(data)

    def inproc_body(index, q) -> bytes:
        results = ex.execute(index, q, cache=False)
        return (json.dumps({"results": [result_to_json(r) for r in results]})
                + "\n").encode()

    # The serial run: counters at 0 just before, read just after; each
    # request's launches beside the same query's in process.
    per_query = {}
    first_ms = {}
    http_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    kernels.reset_launches()
    for index, name, q, want in queries:
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        status, body = request(conn, "POST", QUERY_PATH.format(index), q)
        first_ms[name] = (time.perf_counter() - t0) * 1e3
        over_http = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        before = dict(kernels.LAUNCHES)
        direct = inproc_body(index, q)
        in_process = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if status != 200:
            raise AssertionError(f"{q}: HTTP {status} {body[:300]!r}")
        got = json.loads(body)["results"]
        if got != [want]:
            raise AssertionError(f"{q} over HTTP: {got}, numpy oracle {[want]}")
        if body != direct:
            raise AssertionError(f"{q}: HTTP body {body[:200]!r} is not the "
                                 f"in-process JSON {direct[:200]!r}")
        if over_http != in_process:
            raise AssertionError(f"{q}: launches over HTTP {over_http}, "
                                 f"in process {in_process}")
        per_query[name] = over_http
        for k, v in over_http.items():
            http_launches[k] += v
        log(f"HTTP {q} = oracle, body byte-equal to in-process, launches {over_http}")
    if device == "cuda":
        for k in HTTP_KERNELS:
            if http_launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched behind the HTTP edge")
        if per_query["count_intersect"] != dict(dict.fromkeys(kernels.LAUNCHES, 0),
                                                pair_count=1):
            raise AssertionError(f"Count(Intersect) over HTTP launched "
                                 f"{per_query['count_intersect']}")
    log(f"http path launches: {http_launches}")
    log(f"first request on the node's cold planner: "
        f"{first_ms['count_intersect']:.3f} ms ({COUNT_QUERIES['count_intersect']}, "
        f"stacks built from the holder's host rows and uploaded)")
    log(f"first-request ms per query: "
        f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")

    # Warm latencies on the client's clock beside in-process Executor.execute.
    for index, name, q, _ in queries:
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            status, _body = request(conn, "POST", QUERY_PATH.format(index), q)
            times.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"{q}: HTTP {status}")
        direct, spread = p50_ms(
            lambda index=index, q=q: ex.execute(index, q, cache=False), runs)
        edge = statistics.median(times) - direct
        log(f"HTTP {q}: {spread_ms(times)} ms over {runs} requests, keep-alive "
            f"loopback, client clock; in process p50 {direct:.4f} ms ({spread}); "
            f"edge {edge:.4f} ms  [{card}]")

    metrics = expect_ok(conn, "GET", "/metrics").decode()
    line = next((ln for ln in metrics.splitlines() if ln.startswith(
        'pilosa_qos_service_seconds_count{class="interactive"}')), None)
    if line is None:
        raise AssertionError("/metrics has no qos_serviceSeconds for class interactive")
    log(f"/metrics: {line}")

    # Clients each on their own keep-alive connection, mixing three
    # queries; every answer must be the serial one. With dispatch
    # coalescing off the launches are the serial ones summed; under
    # "auto" (the node's default) concurrent same-plan queries share a
    # launch, so at most that many. One client first, as the baseline.
    from pilosa_tpu_torch.parallel import coalesce
    mix = [(i, q, (json.dumps({"results": [w]}) + "\n").encode())
           for i, name, q, w in queries if name in ("count_intersect", "topn", "sum_filtered")]
    launches_of = {q: per_query[name] for _, name, q, _ in queries}
    concurrent = {}
    try:
        for mode in ("off", "auto"):
            coalesce.set_mode(mode)
            for clients in (1, n_threads):
                lat, wall, got_launches, want_launches = run_clients(
                    node.port, mix, launches_of, clients, per_thread)
                got_n, want_n = sum(got_launches.values()), sum(want_launches.values())
                if mode == "off" and got_launches != want_launches:
                    raise AssertionError(f"{clients} clients, coalesce off, launched "
                                         f"{got_launches}, serial sum {want_launches}")
                if got_n > want_n:
                    raise AssertionError(f"{clients} clients, coalesce {mode}, "
                                         f"launched {got_n} > serial sum {want_n}")
                p99 = statistics.quantiles(lat, n=100)[98]
                qps = len(lat) / wall
                concurrent[(mode, clients)] = qps
                log(f"concurrent: coalesce {mode}, {clients} client(s) x {per_thread} "
                    f"requests (Count(Intersect), filtered TopN, Sum(Row(f=1))), all "
                    f"{len(lat)} answers correct; {qps:.3f} queries/s, p50 "
                    f"{statistics.median(lat):.4f} ms, p99 {p99:.4f} ms; launches "
                    f"{got_n} (serial sum {want_n}): {got_launches}  [{card}]")
    finally:
        coalesce.set_mode("auto")
    ratio = concurrent[("auto", n_threads)] / concurrent[("auto", 1)]
    log(f"concurrent: {n_threads} clients / 1 client under auto = {ratio:.3f} (clients "
        f"in a process of their own)  [{card}]")
    # The same two runs with the clients as threads of this process, as
    # earlier runs measured them: their HTTP work then takes the server's
    # interpreter lock too.
    inproc = []
    for clients in (1, n_threads):
        lat, wall, _, _ = run_clients(node.port, mix, launches_of, clients, per_thread,
                                      in_process=True)
        inproc.append(len(lat) / wall)
    log(f"concurrent, clients in the server's process: 1 client {inproc[0]:.3f} "
        f"queries/s, {n_threads} clients {inproc[1]:.3f} queries/s "
        f"({inproc[1] / inproc[0]:.3f}x)  [{card}]")
    # What holds the concurrent rate: each query of the mix alone under 1
    # and 8 clients, then the mix under 8 clients with the device profiled
    # (its busy share of the wall) and the request threads' stacks sampled.
    for one in mix:
        rates = []
        for clients in (1, n_threads):
            lat, wall, _, _ = run_clients(node.port, [one], launches_of, clients, per_thread)
            rates.append(len(lat) / wall)
        log(f"alone: {one[1]}: 1 client {rates[0]:.3f} queries/s, {n_threads} clients "
            f"{rates[1]:.3f} queries/s ({rates[1] / rates[0]:.3f}x)  [{card}]")
    # The admission gate as a bound on in-flight queries: the mix under 1
    # and 8 clients at each gate, set between runs (nothing in flight).
    gate0 = node.qos.max_concurrent
    try:
        for gate in QOS_GATES:
            node.qos.max_concurrent = gate
            rates, p99s = [], []
            for clients in (1, n_threads):
                lat, wall, _, _ = run_clients(node.port, mix, launches_of, clients,
                                              per_thread)
                rates.append(len(lat) / wall)
                p99s.append(statistics.quantiles(lat, n=100)[98])
            log(f"admission gate {gate}: 1 client {rates[0]:.3f} queries/s (p99 "
                f"{p99s[0]:.4f} ms), {n_threads} clients {rates[1]:.3f} queries/s (p99 "
                f"{p99s[1]:.4f} ms), {rates[1] / rates[0]:.3f}x  [{card}]")
    finally:
        node.qos.max_concurrent = gate0
    stacks, stop = {}, threading.Event()
    sampler = threading.Thread(target=sample_stacks, args=(stop, stacks), daemon=True)
    sampler.start()
    try:
        if device == "cuda":
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                lat, wall, _, _ = run_clients(node.port, mix, launches_of, n_threads,
                                              per_thread)
            busy = sum(e.device_time_total for e in prof.events()
                       if e.device_type == DeviceType.CUDA) / 1e3
            top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:6]
            log(f"profile: {n_threads} clients under auto, {len(lat)} requests: device "
                f"busy {busy:.3f} ms of {wall * 1e3:.3f} ms wall "
                f"({busy / (wall * 1e3):.1%}); CUDA runtime calls by self time: "
                f"{[(e.key, round(e.self_cpu_time_total / 1e3, 3), e.count) for e in top]}"
                f"  [{card}]")
        else:
            run_clients(node.port, mix, launches_of, n_threads, per_thread)
    finally:
        stop.set()
        sampler.join()
    total = sum(stacks.values()) or 1
    top = sorted(stacks.items(), key=lambda kv: -kv[1])[:12]
    log(f"request threads under {n_threads} clients, by innermost port function "
        f"({total} samples every {STACK_SAMPLE_S * 1e3:g} ms): "
        f"{[(k, f'{v / total:.1%}') for k, v in top]}  [{card}]")
    status, body = request(conn, "GET", "/debug/device")
    if status != 200:
        raise AssertionError(f"GET /debug/device: HTTP {status} {body[:200]!r}")
    dev_doc = json.loads(body)
    log(f"GET /debug/device: 200, dispatches {dev_doc['dispatches']}, coalesced "
        f"{dev_doc['dispatches_coalesced']}, transfer {dev_doc['transfer']['queue_depth']} "
        f"queued / {dev_doc['transfer']['inline_resolved']} inline, prefetch "
        f"{json.dumps({k: dev_doc['prefetch'][k] for k in ('scheduled', 'hits', 'sync_misses')})}")

    conn.close()
    conn = http_client(node.port)  # the serial one may have idled out
    # After the timed runs: the new int field's cube can push the v cube
    # out of the planner's budget.
    http_import_check(conn, data, card)
    for what, path, q, headers, want in (
            ("unknown index", "/index/nope/query", "Count(Row(f=1))", None, 404),
            ("parse error", "/index/bench/query", "Count(Row(f=1)", None, 400),
            ("expired X-Deadline", "/index/bench/query", COUNT_QUERIES["count_intersect"],
             {"X-Deadline": f"{time.time() - 1:.6f}"}, 504),
            ("Distinct() (keys and sketches)", "/index/bench/query",
             "Count(Distinct(field=f))", None, 501)):
        status, body = request(conn, "POST", path, q, headers)
        if status != want:
            raise AssertionError(f"{what}: HTTP {status}, expected {want}: {body!r}")
        log(f"{what}: HTTP {status} {body.decode().strip()}")
    conn.close()
    if device == "cuda":
        log(f"peak device memory of the http phase: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return {"launches": http_launches}


# -- phase 7: persistence: bulk load, close, recover, crash ---------------------


def dir_bytes(path: Path, suffix: str = "") -> int:
    return sum(f.stat().st_size for f in path.rglob(f"*{suffix}") if f.is_file())


def launches_of(fn):
    """(result of fn(), kernel launches it made)."""
    from pilosa_tpu_torch.ops import kernels
    before = dict(kernels.LAUNCHES)
    out = fn()
    return out, {k: kernels.LAUNCHES[k] - before[k] for k in before}


def persist_load(node_a, port: int, data: dict, card: str) -> None:
    """Node B's bulk load: import-roaring for every (field, shard) of bench
    f and g and bsi f, each body node A's Fragment.to_roaring(); then bsi's
    planes through interop.load_bsi_planes, each plane row one setRow."""
    from pilosa_tpu_torch import interop

    ha = node_a.holder
    conn = http_client(port)
    for path, opts in SCHEMA:
        if path.startswith(("/index/bench", "/index/bsi")):
            expect_ok(conn, "POST", path, {"options": opts} if opts else None)
    n_req = n_body = 0
    export_s = post_s = 0.0
    for index, fields in (("bench", ("f", "g")), ("bsi", ("f",))):
        for field in fields:
            view = ha.field(index, field).view("standard")
            for shard in sorted(view.fragments):
                t0 = time.perf_counter()
                body = view.fragments[shard].to_roaring()
                t1 = time.perf_counter()
                expect_ok(conn, "POST",
                          f"/index/{index}/field/{field}/import-roaring/{shard}", body)
                post_s += time.perf_counter() - t1
                export_s += t1 - t0
                n_req += 1
                n_body += len(body)
    conn.close()
    log(f"bulk load over HTTP: {n_req} import-roaring requests, {n_body} body "
        f"bytes in {post_s:.3f} s ({n_body / post_s / 1e6:.3f} MB/s, client clock, "
        f"export by Fragment.to_roaring {export_s:.3f} s apart)  [{card}]")
    data["persist_bulk"] = (n_req, n_body, post_s)

    fv = ha.field("bsi", "v")
    depth = fv.bsi_group.bit_depth
    view = fv.bsi_view()
    t0 = time.perf_counter()
    n_planes = 0
    for shard in sorted(view.fragments):
        frag = view.fragments[shard]
        planes = np.stack([frag.row_words(r) for r in range(2 + depth)])
        interop.load_bsi_planes(data["node_b"].holder, "bsi", "v", shard, planes,
                                fv.options)
        n_planes += len(planes)
    secs = time.perf_counter() - t0
    log(f"bsi planes in process: {n_planes} plane rows of {len(view.fragments)} "
        f"shards through interop.load_bsi_planes in {secs:.3f} s "
        f"({n_planes * planes.shape[1] * 4 / secs / 1e6:.3f} MB/s of words)")


def persist_queries(node_a, node_c, data: dict, card: str, runs: int) -> dict:
    """Every Count and BSI query over HTTP on the reopened node C: equal to
    the oracle, byte-equal to node A's body, the same launches per request.
    Returns the launches of node C's serial run."""
    from pilosa_tpu_torch.ops import kernels

    ca, cc = http_client(node_a.port), http_client(node_c.port)
    queries = [q for q in http_queries(data) if q[0] in ("bench", "bsi")]
    want_bodies, want_launches = {}, {}
    for index, name, q, _ in queries:
        (status, body), l_a = launches_of(
            lambda index=index, q=q: request(ca, "POST", QUERY_PATH.format(index), q))
        if status != 200:
            raise AssertionError(f"node A {q}: HTTP {status} {body[:300]!r}")
        want_bodies[name], want_launches[name] = body, l_a
    first_ms = {}
    kernels.reset_launches()  # the persist path's run: node C's requests
    for index, name, q, want in queries:
        t0 = time.perf_counter()
        (status, body), l_c = launches_of(
            lambda index=index, q=q: request(cc, "POST", QUERY_PATH.format(index), q))
        first_ms[name] = (time.perf_counter() - t0) * 1e3
        if status != 200 or json.loads(body)["results"] != [want]:
            raise AssertionError(f"reopened {q}: HTTP {status} {body[:300]!r}, "
                                 f"oracle {want}")
        if body != want_bodies[name]:
            raise AssertionError(f"reopened {q}: body {body[:200]!r} is not node A's "
                                 f"{want_bodies[name][:200]!r}")
        if l_c != want_launches[name]:
            raise AssertionError(f"reopened {q}: launches {l_c}, node A {want_launches[name]}")
        log(f"reopened HTTP {q} = oracle, body byte-equal to node A's, launches {l_c}")
    path_launches = dict(kernels.LAUNCHES)
    log(f"persist path launches: {path_launches}")
    if data["device"] == "cuda":
        for k in HTTP_KERNELS:
            if path_launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the reloaded data")
    log(f"cold first request on the reopened node: {first_ms['count_intersect']:.3f} ms "
        f"(Count(Intersect), stacks rebuilt from reloaded host rows), "
        f"{first_ms['sum']:.3f} ms (Sum, the cube rebuilt)  [{card}]")
    log(f"reopened first-request ms per query: "
        f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")
    for index, name, q, _ in queries:
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            status, _ = request(cc, "POST", QUERY_PATH.format(index), q)
            times.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"reopened {q}: HTTP {status}")
        log(f"reopened HTTP {q}: {spread_ms(times)} ms over {runs} requests, "
            f"keep-alive loopback, client clock  [{card}]")
    ca.close()
    cc.close()
    return path_launches


def persist_topn_shard(node_a, root: Path, card: str) -> None:
    """The topn index is not persisted whole (1,536 dense rows x 10 shards
    of 8-byte snapshot positions, about 4 GB raw): one shard of it goes
    through a store of its own, WAL, snapshot and reload, rows held equal."""
    from pilosa_tpu_torch import interop
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.storage import DiskStore

    frag = node_a.holder.fragment("topn", "f2", "standard", 0)
    ids = sorted(frag.rows)
    d = root / "topn"
    h = Holder(device=node_a.holder.device)
    store = DiskStore(str(d), h)
    store.open()
    t0 = time.perf_counter()
    interop.load_fragment_words(h, "topn", "f2", 0, ids,
                                np.stack([frag.row_words(r) for r in ids]))
    load_s = time.perf_counter() - t0
    wal = dir_bytes(d, ".wal")
    t0 = time.perf_counter()
    store.close()
    close_s = time.perf_counter() - t0
    snap = dir_bytes(d, ".snap")
    t0 = time.perf_counter()
    h2 = Holder(device=node_a.holder.device)
    store2 = DiskStore(str(d), h2)
    store2.open()
    open_s = time.perf_counter() - t0
    back = h2.fragment("topn", "f2", "standard", 0)
    if sorted(back.rows) != ids or any(
            not np.array_equal(back.row_words(r), frag.row_words(r)) for r in ids):
        raise AssertionError("topn shard 0 rows differ after the reload")
    store2.close()
    log(f"topn shard 0 ({len(ids)} rows, {frag.bit_count()} bits): setRow WAL "
        f"{wal} bytes in {load_s:.3f} s, close (snapshot) {close_s:.3f} s to {snap} "
        f"bytes, reopen {open_s:.3f} s; rows equal  [{card}]")


def cli_node(data_dir: Path, device: str):
    """``python -m pilosa_tpu_torch.cli server --data-dir`` on a free port;
    returns (process, port) once it serves."""
    from pilosa_tpu_torch.ops import build

    env = {k: v for k, v in os.environ.items() if not k.startswith("PILOSA_TPU_")}
    # The kernels this script built serve as its build cache: the node's
    # warmup loads them instead of running nvcc again.
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--bind",
         "127.0.0.1:0", "--data-dir", str(data_dir), "--device", device,
         "--compile-cache-dir", str(build.BUILD_DIR)],
        cwd=Path(__file__).resolve().parent, env=env, stderr=subprocess.PIPE, text=True)
    seen = []
    for line in proc.stderr:  # boot logs (quarantine notes) come first
        seen.append(line)
        m = re.search(r"serving at http://127\.0\.0\.1:(\d+) on ", line)
        if m:
            break
    else:
        proc.wait()
        raise AssertionError(f"CLI node did not start: {''.join(seen)[-2000:]}")
    for line in seen[:-1]:
        log(f"CLI node: {line.rstrip()}")
    # Keep reading its log so a full pipe never blocks the node.
    threading.Thread(target=lambda: [None for _ in proc.stderr], daemon=True).start()
    return proc, int(m.group(1))


def persist_crash(root: Path, device: str, card: str) -> None:
    """Acknowledged writes of a SIGKILLed CLI node read back from its WAL;
    then a bit-flipped snapshot is quarantined with a 503 on its shard."""
    from pilosa_tpu_torch import native
    from pilosa_tpu_torch.config import SHARD_WIDTH
    from pilosa_tpu_torch.storage.faults import corrupt_file

    d = root / "crash"
    rng = np.random.default_rng(SEED + 4)
    n_cols = CRASH_SHARDS * SHARD_WIDTH
    bits: set[tuple[int, int]] = set()
    values: dict[int, int] = {}
    proc, port = cli_node(d, device)
    try:
        c = http_client(port)
        for path in ("/index/c", "/index/c/field/f"):
            expect_ok(c, "POST", path)
        expect_ok(c, "POST", "/index/c/field/v",
                  {"options": {"type": "int", "min": -1000, "max": 1000}})
        sets = [(1, int(x)) for x in rng.integers(0, n_cols, 20)]
        expect_ok(c, "POST", "/index/c/query",
                  " ".join(f"Set({col}, f={row})" for row, col in sets))
        bits.update(sets)
        rows = rng.integers(0, 4, 20000)
        cols = rng.integers(0, n_cols, 20000)
        expect_ok(c, "POST", "/index/c/field/f/import",
                  {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
        bits.update(zip(rows.tolist(), cols.tolist()))
        vcols = rng.integers(0, n_cols, 5000)
        vals = rng.integers(-1000, 1001, 5000)
        expect_ok(c, "POST", "/index/c/field/v/import",
                  {"columnIDs": vcols.tolist(), "values": vals.tolist()})
        values.update(zip(vcols.tolist(), vals.tolist()))
        local = np.unique(rng.integers(0, SHARD_WIDTH, 3000).astype(np.uint64))
        expect_ok(c, "POST", "/index/c/field/f/import-roaring/1",
                  native.encode_roaring(np.uint64(5 * SHARD_WIDTH) + local))
        bits.update((5, SHARD_WIDTH + int(x)) for x in local)
        c.close()
        proc.send_signal(signal.SIGKILL)  # no flush: the WAL alone
        proc.wait(timeout=60)
        wal = dir_bytes(d, ".wal")
        snaps = dir_bytes(d, ".snap")
        proc, port = cli_node(d, device)
        c = http_client(port)
        vs = list(values.values())
        checks = [(f"Count(Row(f={r}))", sum(1 for b in bits if b[0] == r)) for r in range(6)]
        checks += [("Sum(field=v)", {"value": sum(vs), "count": len(vs)}),
                   ("Count(Row(v > 500))", sum(1 for v in vs if v > 500))]
        for q, want in checks:
            got = json.loads(expect_ok(c, "POST", "/index/c/query", q))["results"][0]
            if got != want:
                raise AssertionError(f"after SIGKILL {q}: {got}, acknowledged {want}")
        c.close()
        proc.send_signal(signal.SIGTERM)  # clean: snapshots, WAL truncated
        if proc.wait(timeout=120) != 0:
            raise AssertionError("CLI node did not exit 0 on SIGTERM")
        log(f"crash: {len(bits)} bits and {len(values)} values acknowledged over HTTP "
            f"(Set, JSON import, import-roaring), SIGKILL with {wal} WAL bytes and "
            f"{snaps} snapshot bytes on disk; all {len(checks)} checks read back "
            f"after restart")

        snap = d / "c" / "f" / "standard" / "1.snap"
        corrupt_file(str(snap), "bitflip")
        proc, port = cli_node(d, device)
        c = http_client(port)
        q = json.loads(expect_ok(c, "GET", "/debug/quarantine"))
        if q["count"] != 1 or (q["entries"][0]["field"], q["entries"][0]["shard"]) != ("f", 1):
            raise AssertionError(f"/debug/quarantine after the bit flip: {q}")
        status, err = request(c, "POST", "/index/c/query", "Count(Row(f=1))")
        if status != 503 or b"quarantined" not in err:
            raise AssertionError(f"query over the quarantined shard: HTTP {status} {err!r}")
        status, body = request(c, "POST", "/index/c/query?shards=0", "Count(Row(f=1))")
        if status != 200:
            raise AssertionError(f"query avoiding the shard: HTTP {status} {body!r}")
        c.close()
        log(f"corrupt snapshot: /debug/quarantine lists c/f/standard/1 "
            f"({q['entries'][0]['state']}); Count over it HTTP 503 "
            f"{err.decode().strip()}; shard 0 alone HTTP 200")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def phase_persist(torch, card: str, data: dict, runs: int = 10) -> dict:
    """Node B with a data dir bulk-loads bench and bsi, closes; node C
    reopens the dir and answers every query as node A does; then the crash
    and corruption checks on a small dir of a CLI node. The data dirs are
    removed at the end, also when a step fails."""
    from pilosa_tpu_torch import native
    from pilosa_tpu_torch.server import ServerNode

    device, node_a = data["device"], data["node"]
    log(f"native: {native.status()}; g++ {shutil.which('g++')}, "
        f"make {shutil.which('make')}")
    shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    PERSIST_DIR.mkdir(parents=True)
    free = shutil.disk_usage(PERSIST_DIR).free
    log(f"free under {PERSIST_DIR.parent}: {free / 2**30:.3f} GiB")
    if free < PERSIST_MIN_FREE_GIB * 2**30:
        raise AssertionError(f"{free / 2**30:.3f} GiB free under build/, the persist "
                             f"phase needs {PERSIST_MIN_FREE_GIB}")
    big = PERSIST_DIR / "big"
    try:
        t0 = time.perf_counter()
        node_b = data["node_b"] = ServerNode(bind="127.0.0.1:0", device=device,
                                             data_dir=str(big))
        node_b.open()
        log(f"node B: {node_b.address}, data dir {big}, booted in "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        persist_load(node_a, node_b.port, data, card)
        log(f"WAL on disk after the load: {dir_bytes(big, '.wal')} bytes")
        t0 = time.perf_counter()
        node_b.close()
        close_s = time.perf_counter() - t0
        del data["node_b"], node_b
        log(f"node B close (schema, every fragment snapshotted, WALs truncated): "
            f"{close_s:.3f} s; {dir_bytes(big)} bytes on disk "
            f"({dir_bytes(big, '.snap')} in snapshots, {dir_bytes(big, '.wal')} in WALs)"
            f"  [{card}]")

        t0 = time.perf_counter()
        node_c = data["node_c"] = ServerNode(bind="127.0.0.1:0", device=device,
                                             data_dir=str(big))
        node_c.open()
        open_s = time.perf_counter() - t0
        q = node_c.store.quarantine
        log(f"recover: node C on the same dir serving in {open_s:.3f} s (data-dir "
            f"walk, {sum(1 for _ in node_c.store._all_keys())} fragments' snapshots "
            f"read and verified, WAL replay); quarantine entries {len(q)}  [{card}]")
        if len(q):
            raise AssertionError(f"clean reopen quarantined {q.entries()}")
        launches = persist_queries(node_a, node_c, data, card, runs)
        node_c.close()
        del data["node_c"], node_c
        persist_topn_shard(node_a, PERSIST_DIR, card)
        persist_crash(PERSIST_DIR, device, card)
    finally:
        for k in ("node_b", "node_c"):
            if k in data:
                data.pop(k).close()
        shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    return {"launches": launches}


# -- phase 8: the rest of PQL: Not, Shift, Rows, Store, ClearRow, Options,
# attrs, tanimoto, the result cache -------------------------------------------


#: the pql phase's reads on the bench index: (name, PQL). Each 3+-leaf
#: Count must be ONE tree_count launch.
PQL_READS = {
    "count_3leaf": "Count(Intersect(Row(f=1), Row(g=2), Row(h=3)))",
    "count_4leaf": "Count(Difference(Union(Row(f=1), Row(g=2)), Xor(Row(h=3), Row(f=1))))",
    "count_not": "Count(Not(Row(f=1)))",
    "count_shift1": "Count(Shift(Row(f=1), n=1))",
    "count_shift33": "Count(Intersect(Shift(Row(f=1), n=33), Row(g=2)))",
    "rows": "Rows(f)",
    "options": "Options(Count(Row(f=1)), shards=[0, 1])",
}
PQL_ONE_TREE = ("count_3leaf", "count_4leaf")
PQL_TANIMOTO = "TopN(f2, Row(g=0), n=10, tanimotoThreshold=3)"
PQL_TANIMOTO_RUNS = 5
PQL_ATTR = 'TopN(f2, Row(g=0), n=10, attrName="cat", attrValues=["x"])'
#: the kernels the pql phase's run must launch.
PQL_KERNELS = ("pair_count", "row_counts", "tree_count", "shift_left")


def shifted_and_count(a: np.ndarray, b: np.ndarray | None, n: int,
                      chunk: int = 64) -> int:
    """numpy oracle of Count(Intersect(Shift(a, n), b)) (b None: of
    Count(Shift(a, n))) over [S, W] uint32 shard rows: every set bit of a
    moves n columns up within its shard, bits past the shard's end falling
    off, on unpacked bit arrays, ``chunk`` shards at a time."""
    total = 0
    for lo in range(0, len(a), chunk):
        ab = np.unpackbits(a[lo:lo + chunk].view(np.uint8), axis=1,
                           bitorder="little")
        moved = ab[:, :ab.shape[1] - n]
        if b is None:
            total += int(moved.sum(dtype=np.int64))
        else:
            bb = np.unpackbits(b[lo:lo + chunk].view(np.uint8), axis=1,
                               bitorder="little")
            total += int((moved & bb[:, n:]).sum(dtype=np.int64))
    return total


def phase_pql(torch, card: str, data: dict, runs: int = QUERY_RUNS) -> dict:
    """Not, Shift, Rows, Store, ClearRow, Options, row attrs, TopN's
    tanimotoThreshold and attrName, and the result cache at 1B columns, in
    process (``node.executor``, cache bypassed) and over HTTP: each answer
    equal to its numpy oracle, each body byte-equal to the in-process JSON
    with the same launches. Set-up: the existence row (the data phase's
    import_bits bypasses add_existence) and a third row h=3 at 5%."""
    from pilosa_tpu_torch import interop
    from pilosa_tpu_torch.exec import result_to_json
    from pilosa_tpu_torch.ops import kernels

    device, node, h = data["device"], data["node"], data["holder"]
    ex = node.executor
    n_shards = data["count_shards"]
    conn = http_client(node.port)
    t0 = time.perf_counter()
    expect_ok(conn, "POST", "/index/bench/field/h")
    rng = np.random.default_rng(SEED + 4)
    n_cols = data["count_cols"]
    pos = rng.integers(0, n_cols, int(n_cols * COUNT_DENSITY), dtype=np.uint64)
    h.field("bench", "h").import_bits(np.full(len(pos), 3, dtype=np.uint64), pos)
    del pos

    def words(field, row):
        return np.stack([h.fragment("bench", field, "standard", s).row_words(row)
                         for s in range(n_shards)])

    fw, gw, hw = words("f", 1), words("g", 2), words("h", 3)
    exists = fw | gw | hw
    for s in range(n_shards):
        interop.load_fragment_words(h, "bench", "_exists", s, [0], exists[s][None])
    want = {
        "count_3leaf": int(popcount_rows(fw & gw & hw).sum()),
        "count_4leaf": int(popcount_rows((fw | gw) & ~(hw ^ fw)).sum()),
        "count_not": int(popcount_rows(exists & ~fw).sum()),
        "count_shift1": shifted_and_count(fw, None, 1),
        "count_shift33": shifted_and_count(fw, gw, 33),
        "rows": {"rows": [1]},
        "options": int(popcount_rows(fw[:2]).sum()),
    }
    want_store = int(popcount_rows(fw & gw).sum())
    # A column in f and g but not h: Set(col, h=3) moves count_3leaf by one.
    fgh = fw & gw & ~hw
    shard = int(np.flatnonzero(fgh.any(axis=1))[0])
    word = int(np.flatnonzero(fgh[shard])[0])
    bit = (int(fgh[shard, word]) & -int(fgh[shard, word])).bit_length() - 1
    miss_col = shard * (n_cols // n_shards) + word * 32 + bit
    del fw, gw, hw, exists, fgh
    log(f"pql set-up: field h row 3 at {COUNT_DENSITY:.0%} and the existence row "
        f"of {n_shards} shards in {time.perf_counter() - t0:.3f} s (host)")

    counts = data["topn_counts"]

    def tanimoto_keep(s, ids, c):
        base, src = counts[s][1][ids], counts[s][2]
        return -(-c * 100 // (base + src - c)) > 3

    kept = sum(int(tanimoto_keep(s, np.arange(len(c[0])), c[0]).sum())
               for s, c in counts.items())
    log(f"tanimotoThreshold=3 keeps {kept} of "
        f"{sum(len(c[0]) for c in counts.values())} (shard, row) counts")

    # SetRowAttrs over HTTP: every fifth row "x", the next one "y".
    attrs = " ".join(f'SetRowAttrs(f2, {r}, cat="{"x" if r % 5 == 0 else "y"}")'
                     for r in range(TOPN_ROWS) if r % 5 in (0, 1))
    body = expect_ok(conn, "POST", "/index/topn/query", attrs)
    if json.loads(body)["results"] != [None] * attrs.count("SetRowAttrs"):
        raise AssertionError(f"SetRowAttrs over HTTP: {body[:200]!r}")
    allowed = np.arange(TOPN_ROWS) % 5 == 0
    topn_want = {
        "tanimoto": [{"id": i, "count": c}
                     for i, c in topn_oracle(counts, 10, tanimoto_keep)],
        "attr": [{"id": i, "count": c}
                 for i, c in topn_oracle(counts, 10, lambda s, ids, c: allowed[ids])],
    }

    def inproc(index, q):
        before = dict(kernels.LAUNCHES)
        results = ex.execute(index, q, cache=False)
        body = (json.dumps({"results": [result_to_json(r) for r in results]})
                + "\n").encode()
        return body, {k: kernels.LAUNCHES[k] - before[k] for k in before}

    def over_http(index, q, path=QUERY_PATH):
        before = dict(kernels.LAUNCHES)
        status, body = request(conn, "POST", path.format(index), q)
        if status != 200:
            raise AssertionError(f"{q}: HTTP {status} {body[:300]!r}")
        return body, {k: kernels.LAUNCHES[k] - before[k] for k in before}

    def both(index, name, q, want_result, launches=None):
        """q in process, then over HTTP: the oracle, byte-equal bodies,
        equal launches (and the expected ones, on the card)."""
        body, l_in = inproc(index, q)
        got = json.loads(body)["results"]
        if got != [want_result]:
            raise AssertionError(f"{q}: {got}, numpy oracle {[want_result]}")
        hbody, l_http = over_http(index, q)
        if hbody != body:
            raise AssertionError(f"{q}: HTTP body {hbody[:200]!r} is not the "
                                 f"in-process JSON {body[:200]!r}")
        if l_http != l_in:
            raise AssertionError(f"{q}: launches over HTTP {l_http}, in process {l_in}")
        if device == "cuda" and launches is not None:
            expect = dict(dict.fromkeys(kernels.LAUNCHES, 0), **launches)
            if l_in != expect:
                raise AssertionError(f"{q}: launched {l_in}, expected {expect}")
        log(f"pql {q} = oracle, HTTP body byte-equal, launches "
            f"{ {k: v for k, v in l_in.items() if v} }  [{card}]")
        return l_in

    expected = {"count_3leaf": {"tree_count": 1}, "count_4leaf": {"tree_count": 1},
                "count_not": {"pair_count": 1},
                "count_shift1": {"shift_left": 1, "row_counts": 1},
                "count_shift33": {"shift_left": 1, "pair_count": 1},
                "rows": {}, "options": {"row_counts": 1}}
    per_query, timed = {}, []
    # The pql path's run: counters at 0 just before, read just after.
    kernels.reset_launches()
    for name, q in PQL_READS.items():
        per_query[name] = both("bench", name, q, want[name], expected[name])
        timed.append(("bench", q))

    t0 = time.perf_counter()
    body, l_store = inproc("bench", "Store(Intersect(Row(f=1), Row(g=2)), h=9)")
    store_ms = (time.perf_counter() - t0) * 1e3
    if json.loads(body)["results"] != [True]:
        raise AssertionError(f"Store: {body[:200]!r}")
    if device == "cuda" and l_store["tree_count"] != 1:
        raise AssertionError(f"Store's source row launched {l_store}")
    log(f"pql Store(Intersect(Row(f=1), Row(g=2)), h=9) in process: {store_ms:.3f} ms "
        f"over {n_shards} shards, launches { {k: v for k, v in l_store.items() if v} }"
        f"  [{card}]")
    both("bench", "stored", "Count(Row(h=9))", want_store, {"row_counts": 1})
    both("bench", "rows_h", "Rows(h)", {"rows": [3, 9]}, {})
    t0 = time.perf_counter()
    body, _ = over_http("bench", "ClearRow(h=9)")
    clear_ms = (time.perf_counter() - t0) * 1e3
    if json.loads(body)["results"] != [True]:
        raise AssertionError(f"ClearRow over HTTP: {body[:200]!r}")
    log(f"pql ClearRow(h=9) over HTTP: {clear_ms:.3f} ms over {n_shards} shards  [{card}]")
    both("bench", "cleared", "Count(Row(h=9))", 0, {"row_counts": 1})

    both("topn", "tanimoto", PQL_TANIMOTO, topn_want["tanimoto"])
    both("topn", "attr", PQL_ATTR, topn_want["attr"])
    timed += [("topn", PQL_TANIMOTO), ("topn", PQL_ATTR)]
    path_launches = dict(kernels.LAUNCHES)
    log(f"pql path launches: {path_launches}  [{card}]")
    if device == "cuda":
        for k in PQL_KERNELS:
            if path_launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the pql path")

    # The result cache over HTTP: a repeated Count is answered with no
    # launch, and misses after a Set to a shard it reads.
    q3 = PQL_READS["count_3leaf"]
    cached = "/index/{}/query"
    b1, l1 = over_http("bench", q3, cached)
    b2, l2 = over_http("bench", q3, cached)
    if b2 != b1 or json.loads(b1)["results"] != [want["count_3leaf"]] or any(l2.values()):
        raise AssertionError(f"cache hit: {b2[:100]!r} launches {l2}, first {b1[:100]!r}")
    cache_ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        over_http("bench", q3, cached)
        cache_ms.append((time.perf_counter() - t0) * 1e3)
    hit_ms, hit_spread = p50_ms(lambda: ex.execute("bench", q3), runs)
    body, _ = over_http("bench", f"Set({miss_col}, h=3)")
    if json.loads(body)["results"] != [True]:
        raise AssertionError(f"Set({miss_col}, h=3): {body[:200]!r}")
    b3, l3 = over_http("bench", q3, cached)
    if json.loads(b3)["results"] != [want["count_3leaf"] + 1] or (
            device == "cuda" and l3["tree_count"] != 1):
        raise AssertionError(f"after a Set: {b3[:100]!r}, launches {l3}; expected "
                             f"{want['count_3leaf'] + 1} and one tree_count")
    log(f"result cache: {q3} repeated over HTTP with 0 launches, p50 "
        f"{spread_ms(cache_ms)} ms; in process p50 {hit_ms:.4f} ms ({hit_spread}); "
        f"after Set({miss_col}, h=3) a miss with launches "
        f"{ {k: v for k, v in l3.items() if v} } and count + 1  [{card}]")
    snap = json.loads(expect_ok(conn, "GET", "/debug/cache"))
    log(f"/debug/cache: hits {snap['hits']}, misses {snap['misses']}, entries "
        f"{snap['entries']}, bytes {snap['bytes']}")

    for index, q in timed:
        # TopN with tanimotoThreshold takes about a second a run (ROADMAP
        # 3c): fewer runs, so the fields phase fits the script's limit.
        n = min(runs, PQL_TANIMOTO_RUNS) if q == PQL_TANIMOTO else runs
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            over_http(index, q)
            times.append((time.perf_counter() - t0) * 1e3)
        direct, spread = p50_ms(
            lambda index=index, q=q: ex.execute(index, q, cache=False), n)
        log(f"pql {q}: HTTP {spread_ms(times)} ms over {n} requests; in process "
            f"p50 {direct:.4f} ms ({spread})  [{card}]")
    conn.close()
    return {"launches": path_launches}


# -- main ---------------------------------------------------------------------


# -- phase 9: the async path: execute_async, same-plan waves, prefetch,
# the sparse upload ---------------------------------------------------------

#: rows 10.. of f and g written for the waves: one pair per thread.
ASYNC_ROWS = 8
ASYNC_FUTURES = 200
#: the sparse row: at most SPARSE_UPLOAD_MAX_BITS (2048) bits in each shard.
ASYNC_SPARSE_ROW = 30
ASYNC_SPARSE_BITS = 1000
#: cold samples of each cold Count, each on a new planner.
COLD_SAMPLES = 5
ASYNC_KERNELS = ("pair_count", "row_counts", "tree_count", "pair_count_batched",
                 "row_counts_batched", "tree_count_batched", "assemble_stack")


def leaf_sharing(kernels, since=None) -> str:
    """The leaf records tree_count_batched was given, and the distinct
    leaves it read, since the counts were zeroed or since ``since`` (a copy
    of kernels.TREE_BATCH_LEAVES)."""
    now = kernels.TREE_BATCH_LEAVES
    rec, dis = (now[k] - (since or {}).get(k, 0) for k in ("records", "distinct"))
    return (f"tree_count_batched leaf records {rec}, distinct leaves read {dis}"
            + (f" ({1 - dis / rec:.4f} of the records shared)" if rec else ""))


def wave(co, kernels, n: int, fn) -> tuple[dict, list, float]:
    """``n`` threads each run ``fn(k)`` while the coalescer is held, so all
    of them join one batch; returns (launches of the wave, answers, wall
    ms from the release to the last answer). The launches count the
    planner's program dispatches too, as ``"dispatches"``: 1 for a wave
    that ran as one program (off the card, where no kernel counts)."""
    planner = co.planner
    co.hold()
    out, errors = [None] * n, []

    def run(k):
        try:
            out[k] = fn(k)
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while co.queue_depth() < n and time.monotonic() < deadline and not errors:
            time.sleep(0.001)
        depth = co.queue_depth()
        before, d0 = dict(kernels.LAUNCHES), planner.dispatches
        t0 = time.perf_counter()
    finally:
        co.release()
    for t in threads:
        t.join()
    ms = (time.perf_counter() - t0) * 1e3
    if errors or depth != n:
        raise AssertionError(f"wave of {n}: {depth} queued, errors {errors[:3]}")
    got = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] != before[k]}
    return got, planner.dispatches - d0, out, ms


def phase_async(torch, card: str, data: dict, n_futures: int = ASYNC_FUTURES) -> dict:
    """The async serving path at 1B columns, in process: ``execute_async``
    keeping ``n_futures`` queries in flight from one thread (2- and 3-leaf
    Counts, ``Sum(Row(f=1))``, ``Min``); a held wave of 8 identical Counts
    (one ``pair_count``); same-shape waves of 8 different 2-leaf Counts
    (one ``pair_count_batched``), bare Counts (one ``row_counts_batched``)
    and 3-leaf Counts (one ``tree_count_batched``); a planner whose budget
    holds 3 of 6 stacks cycling Counts with the prefetcher on (no sync
    miss); and a cold row of at most 2048 bits per shard (one
    ``assemble_stack``) beside a cold dense row, COLD_SAMPLES each, split
    into the upload's phases and the count. Set-up: rows 10..17 of f
    and g (random words) and the sparse row f=30."""
    from pilosa_tpu_torch.config import WORDS_PER_SHARD
    from pilosa_tpu_torch.exec import Executor, residency
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import Planner, coalesce, prefetch

    device, h = data["device"], data["holder"]
    n_shards, n_cols = data["count_shards"], data["count_cols"]
    rng = np.random.default_rng(SEED + 5)
    t0 = time.perf_counter()
    words = {}
    for field in ("f", "g"):
        for r in range(10, 10 + ASYNC_ROWS):
            w = rng.integers(0, 2**32, size=(n_shards, WORDS_PER_SHARD), dtype=np.uint32)
            w &= rng.integers(0, 2**32, size=w.shape, dtype=np.uint32)  # ~25% set
            for s in range(n_shards):
                h.fragment("bench", field, "standard", s).set_row_words(r, w[s])
            words[(field, r)] = w
    sparse_pos = np.concatenate([
        np.sort(rng.choice(WORDS_PER_SHARD * 32, ASYNC_SPARSE_BITS, replace=False))
        + s * WORDS_PER_SHARD * 32 for s in range(n_shards)]).astype(np.uint64)
    h.field("bench", "f").import_bits(np.full(len(sparse_pos), ASYNC_SPARSE_ROW,
                                              dtype=np.uint64), sparse_pos)
    del sparse_pos
    log(f"async set-up: {2 * ASYNC_ROWS} rows of random words and a sparse row of "
        f"{ASYNC_SPARSE_BITS} bits per shard over {n_shards} shards in "
        f"{time.perf_counter() - t0:.3f} s (host)")

    def f(r):
        return 10 + r % ASYNC_ROWS

    two = {f"Count(Intersect(Row(f={f(i)}), Row(g={f(i)})))":
           int(popcount_rows(words[("f", f(i))] & words[("g", f(i))]).sum())
           for i in range(ASYNC_ROWS)}
    three = {f"Count(Union(Intersect(Row(f={f(i)}), Row(g={f(i)})), Row(f={f(i + 1)})))":
             int(popcount_rows((words[("f", f(i))] & words[("g", f(i))])
                               | words[("f", f(i + 1))]).sum())
             for i in range(ASYNC_ROWS)}
    bare = {f"Count(Row(f={f(i)}))": int(popcount_rows(words[("f", f(i))]).sum())
            for i in range(ASYNC_ROWS)}
    #: the 2-leaf Counts over shards 0 and 1 only.
    two_sub = {q: int(popcount_rows(words[("f", f(i))][:2] & words[("g", f(i))][:2]).sum())
               for i, q in enumerate(two)}
    del words
    want_bsi = data["want_bsi"]
    mix = ([("bench", q, [v]) for q, v in list(two.items()) + list(three.items())[:4]]
           + [("bsi", BSI_QUERIES["sum_filtered"], want_bsi["sum_filtered"]),
              ("bsi", BSI_QUERIES["min"], want_bsi["min"])])

    def check(q, got, want):
        if isinstance(want, dict):
            got = {"value": got[0].val, "count": got[0].count}
        if got != want:
            raise AssertionError(f"{q}: got {got}, numpy oracle {want}")

    ex = Executor(h, planner=Planner(h, max_cache_bytes=12 << 30), result_cache=False)
    co = ex.planner.coalescer
    # The async path's run: counters at 0 just before, read just after.
    kernels.reset_launches()
    try:
        for index, q, want in mix:  # warm: stacks built, answers held
            check(q, ex.execute(index, q, cache=False), want)
        t0 = time.perf_counter()
        futs = [(mix[i % len(mix)], ex.execute_async(mix[i % len(mix)][0],
                                                     mix[i % len(mix)][1], cache=False))
                for i in range(n_futures)]
        submit_ms = (time.perf_counter() - t0) * 1e3
        for (index, q, want), fut in futs:
            check(q, fut.result(), want)
        wall = time.perf_counter() - t0
        log(f"execute_async: {n_futures} futures from one thread ({len(mix)} queries: "
            f"2- and 3-leaf Counts, Sum(Row(f=1)), Min), all equal to numpy; "
            f"submitted in {submit_ms:.3f} ms, all resolved in {wall * 1e3:.3f} ms, "
            f"{n_futures / wall:.3f} queries/s; planner dispatches "
            f"{ex.planner.dispatches}, coalesced {ex.planner.dispatches_coalesced}; "
            f"{leaf_sharing(kernels)}  [{card}]")

        waves = (("2-leaf", two, "pair_count_batched"), ("bare", bare, "row_counts_batched"),
                 ("3-leaf", three, "tree_count_batched"))
        serial_ms = {name: p50_ms(lambda qs=list(table): [ex.execute("bench", q, cache=False)
                                                          for q in qs], 3)[0]
                     for name, table, _ in waves}
        coalesce.set_mode("on")
        q2 = next(iter(two))
        card_launches = {} if device != "cuda" else None
        got, dispatched, answers, ms = wave(
            co, kernels, 8, lambda k: ex.execute("bench", q2, cache=False))
        if (answers != [[two[q2]]] * 8 or dispatched != 1
                or got != (card_launches if card_launches is not None else {"pair_count": 1})):
            raise AssertionError(f"identical wave: launches {got}, {dispatched} "
                                 f"dispatches, answers {answers}")
        log(f"identical-argument wave: 8 x {q2} -> launches {got} (one pair_count), "
            f"{ms:.3f} ms, every answer exact  [{card}]")
        for name, table, kern in waves:
            qs = list(table)
            leaves0 = dict(kernels.TREE_BATCH_LEAVES)
            got, dispatched, answers, ms = wave(
                co, kernels, 8, lambda k, qs=qs: ex.execute("bench", qs[k], cache=False))
            if (answers != [[table[q]] for q in qs] or dispatched != 1
                    or got != (card_launches if card_launches is not None else {kern: 1})):
                raise AssertionError(f"same-shape {name} wave: launches {got}, "
                                     f"{dispatched} dispatches, answers {answers}")
            log(f"same-shape {name} wave: 8 different Counts -> launches {got} (one "
                f"{kern}), {ms:.3f} ms from release to the last answer; the 8 one after "
                f"another {serial_ms[name]:.3f} ms; every answer exact; "
                f"{leaf_sharing(kernels, leaves0)}  [{card}]")
        # One plan over two shard sets in one held wave: its leaves have two
        # shapes, so it runs as one batched launch per shape.
        qs = list(two)[:4]
        mixed = qs + [f"Options({q}, shards=[0, 1])" for q in qs]
        want_mixed = [[two[q]] for q in qs] + [[two_sub[q]] for q in qs]
        got, dispatched, answers, ms = wave(
            co, kernels, 8, lambda k: ex.execute("bench", mixed[k], cache=False))
        if (answers != want_mixed or dispatched != 2 or got != (
                card_launches if card_launches is not None else {"pair_count_batched": 2})):
            raise AssertionError(f"mixed shard-set wave: launches {got}, {dispatched} "
                                 f"dispatches, answers {answers}, numpy {want_mixed}")
        log(f"mixed shard-set wave: 4 2-leaf Counts over {n_shards} shards and 4 over "
            f"shards 0-1 -> launches {got} (one pair_count_batched per shape), "
            f"{ms:.3f} ms; every answer exact  [{card}]")
    finally:
        coalesce.set_mode("auto")
        ex.planner.close()
    del ex

    # Prefetch: the budget holds 3 of the 6 stacks the queries cycle through.
    prefetch.set_mode("on")
    planner = Planner(h)
    planner.max_cache_bytes = 3 * residency.dense_nbytes(planner._pad(n_shards))
    pex = Executor(h, planner=planner, result_cache=False)
    try:
        t0 = time.perf_counter()
        for _ in range(2):
            for i in range(6):
                q = f"Count(Row(f={f(i)}))"
                (got,) = pex.execute("bench", q, cache=False)
                if got != bare[q]:
                    raise AssertionError(f"prefetch drill {q}: {got}, numpy {bare[q]}")
        dbg = planner.prefetcher.debug()
        ev = planner.cache_stats()["evictions"]
        if dbg["sync_misses"] != 0 or not ev or not dbg["hits"]:
            raise AssertionError(f"prefetch drill: {dbg}, evictions {ev}")
        log(f"prefetch drill: 12 Counts over 6 stacks through a 3-stack budget, all exact; "
            f"evictions {ev}, scheduled {dbg['scheduled']}, hits {dbg['hits']}, sync "
            f"misses {dbg['sync_misses']}, upload {dbg['upload_ms']:.3f} ms, overlap "
            f"{dbg['overlap_ms']:.3f} ms, {time.perf_counter() - t0:.3f} s  [{card}]")
    finally:
        planner.close()
    del pex, planner

    # The sparse upload, cold, beside a cold dense row: COLD_SAMPLES cold
    # Counts each, every one on a new planner, split into the upload's
    # phases (Planner.upload_split_ms) and the count (the same Count again,
    # its stack resident).
    cold = {}
    for row, want in ((ASYNC_SPARSE_ROW, n_shards * ASYNC_SPARSE_BITS),
                      (1, data["want_count"]["count_row"])):
        q = f"Count(Row(f={row}))"
        samples = []
        for _ in range(COLD_SAMPLES):
            planner = Planner(h)
            cex = Executor(h, planner=planner, result_cache=False)
            try:
                before = dict(kernels.LAUNCHES)
                t0 = time.perf_counter()
                (got,) = cex.execute("bench", q, cache=False)
                ms = (time.perf_counter() - t0) * 1e3
                delta = {k: kernels.LAUNCHES[k] - before[k] for k in before if
                         kernels.LAUNCHES[k] != before[k]}
                if got != want:
                    raise AssertionError(f"cold {q}: {got}, numpy {want}")
                if row == ASYNC_SPARSE_ROW and device == "cuda" and delta != {
                        "assemble_stack": 1, "row_counts": 1}:
                    raise AssertionError(f"cold sparse row launched {delta}")
                split = planner.upload_split_ms()
                t0 = time.perf_counter()
                (got,) = cex.execute("bench", q, cache=False)
                split["count"] = (time.perf_counter() - t0) * 1e3
                if got != want:
                    raise AssertionError(f"warm {q}: {got}, numpy {want}")
                # The host's part of the assemble_stack call lies within
                # the device span from the copy's end to the kernel's.
                split["other"] = ms - sum(v for k, v in split.items() if k != "assemble_host")
                samples.append((ms, planner.h2d_bytes, delta, split))
            finally:
                planner.close()
        totals = [x[0] for x in samples]
        median = {k: statistics.median(x[3][k] for x in samples) for k in samples[0][3]}
        cold[row] = (statistics.median(totals), samples[0][1], samples[0][2], median)
        parts = ", ".join(f"{k} {v:.3f}" for k, v in median.items())
        log(f"cold {q}: median {cold[row][0]:.3f} ms of {COLD_SAMPLES} cold samples "
            f"({', '.join(f'{x:.3f}' for x in totals)}), {samples[0][1]} bytes host to "
            f"device, launches {samples[0][2]}; median split (ms): {parts}  [{card}]")
    ms, nbytes, delta, _ = cold[ASYNC_SPARSE_ROW]
    log(f"sparse upload: cold Count(Row(f={ASYNC_SPARSE_ROW})) ({ASYNC_SPARSE_BITS} bits "
        f"per shard) {ms:.3f} ms, {nbytes} bytes host to device, launches {delta}; "
        f"cold dense Count(Row(f=1)) {cold[1][0]:.3f} ms, {cold[1][1]} bytes  [{card}]")
    launches = dict(kernels.LAUNCHES)
    log(f"async path launches: {launches}; {leaf_sharing(kernels)}")
    if device == "cuda":
        for k in ASYNC_KERNELS:
            if launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the async path")
    return {"launches": launches}


# -- phase 10: time, mutex and bool fields, MinRow/MaxRow, GroupBy ------------

#: bench config 4's time field, scaled from 8M to 1B columns: 10M bits in
#: rows 0-2, stamped on the hour, uniform over 90 days from 2019-01-01.
FIELDS_TIME_BITS = 10_000_000
FIELDS_TIME_ROWS = 3
FIELDS_TIME_HOURS = 24 * 90
#: bench config 5's GroupBy fields at its density (1.5%), at 1B columns.
FIELDS_SET_BITS = 15_000_000
FIELDS_SET_ROWS = {"a": 4, "b": 8, "c": 3}
#: the mutex field: 16 rows over 50M columns, then 10M of them moved.
FIELDS_MUTEX_ROWS = 16
FIELDS_MUTEX_COLS = 50_000_000
FIELDS_MUTEX_MOVED = 10_000_000
#: the bool field: 20M columns, true or false.
FIELDS_BOOL_COLS = 20_000_000
#: bits of t's row 7 imported over HTTP with epoch-second timestamps.
FIELDS_HTTP_BITS = 2000
#: the wide lattices: 450 rows in one level, and levels of 32 and 256
#: rows, over a few shards, bits of each field random.
WIDE_SHARDS = 4
WIDE_ROWS = {"w": 450, "x": 32, "y": 256}
WIDE_BITS = 1_000_000
WIDE_SCHEMA = ["/index/wide", "/index/wide/field/w", "/index/wide/field/x",
               "/index/wide/field/y"]
FIELDS_SCHEMA = [
    ("/index/bench/field/t", {"type": "time", "timeQuantum": "YMDH"}),
    ("/index/bench/field/a", None), ("/index/bench/field/b", None),
    ("/index/bench/field/c", None),
    ("/index/bench/field/m", {"type": "mutex"}),
    ("/index/bench/field/flag", {"type": "bool"}),
]
#: bench config 4's window (32 views at YMDH) and one cut to the hour at
#: both ends (67 views); hours from 2019-01-01T00:00.
WINDOWS = {"32": ("2019-01-15T00:00", "2019-03-15T00:00", 14 * 24, 73 * 24),
           "67": ("2019-01-15T06:00", "2019-03-15T18:00", 14 * 24 + 6, 73 * 24 + 18)}
#: runs of the queries that upload stacks on every run (the windows churn
#: the 4 GiB stack budget; the cursor GroupBy walks every shard).
FIELDS_SLOW_RUNS = 2
#: runs of the other queries of the fields phase.
FIELDS_RUNS = 5
FIELDS_KERNELS = ("row_counts", "tree_count", "group_count")


def unique_pairs(cols: np.ndarray, rows: np.ndarray, n_rows: int):
    """The distinct (column, row) bits of a batch, sorted by column then
    row: what a set field holds after importing it."""
    key = np.unique(cols.astype(np.int64) * n_rows + rows.astype(np.int64))
    return key // n_rows, key % n_rows


def join_on_column(left_cols: np.ndarray, right_cols: np.ndarray):
    """Index pairs (i, j) with left_cols[i] == right_cols[j]; right_cols
    ascending."""
    lo = np.searchsorted(right_cols, left_cols, "left")
    cnt = np.searchsorted(right_cols, left_cols, "right") - lo
    li = np.repeat(np.arange(len(left_cols)), cnt)
    start = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    ri = np.arange(int(cnt.sum())) + np.repeat(lo - start, cnt)
    return li, ri


def group_json(fields: list[str], groups: list[tuple]) -> list[dict]:
    return [{"group": [{"field": f, "rowID": int(r)} for f, r in zip(fields, grp)],
             "count": int(c)} for grp, c in groups]


def fold_extreme_row(per_shard: np.ndarray, is_min: bool) -> dict:
    """MinRow/MaxRow over per-shard row counts [S, R]: each shard's
    smallest (largest) row with bits and its count there; across shards the
    smallest (largest) id, and on equal ids the first shard's count."""
    best = None
    for counts in per_shard:
        live = np.flatnonzero(counts)
        if not len(live):
            continue
        rid = int(live[0] if is_min else live[-1])
        if best is None or (rid < best[0] if is_min else rid > best[0]):
            best = (rid, int(counts[rid]))
    return {"id": best[0], "count": best[1]} if best else {"id": 0, "count": 0}


def cursor_oracle(shard_counts: np.ndarray, has_a: np.ndarray, has_b: np.ndarray,
                  prev: tuple, limit: int) -> list[tuple]:
    """GroupBy of two Rows levels with a ``previous`` cursor on each, over
    per-shard group counts [S, A, B] and the rows each shard holds
    ([S, A], [S, B]), as the per-shard walk runs it: in each shard level 0
    from its cursor row, level 1 strictly after its cursor while level 0
    sits on its cursor row and from the start after (the reference's
    ignorePrev), nonzero groups, at most ``limit`` per shard; then the
    shards' groups summed and the first ``limit`` kept."""
    total: dict[tuple, int] = {}
    for counts, ha, hb in zip(shard_counts, has_a, has_b):
        rows_a = np.flatnonzero(ha).tolist()
        rows_b = np.flatnonzero(hb).tolist()
        found = []
        for j, ra in enumerate(r for r in rows_a if r >= prev[0]):
            if len(found) >= limit:
                break
            at_cursor = j == 0 and ra == prev[0]
            for rb in (r for r in rows_b if not at_cursor or r > prev[1]):
                if len(found) >= limit:
                    break
                if counts[ra, rb]:
                    found.append(((ra, rb), int(counts[ra, rb])))
        for grp, c in found:
            total[grp] = total.get(grp, 0) + c
    return sorted(total.items())[:limit]


def phase_fields(torch, card: str, data: dict, runs: int = FIELDS_RUNS,
                 slow_runs: int = FIELDS_SLOW_RUNS) -> dict:
    """Time, mutex and bool fields, MinRow/MaxRow and GroupBy at 1B columns
    on the ``bench`` index: the fields created over HTTP, their data
    imported in process from SEED (time bits through ``Field.import_bits``
    with datetime64 stamps, a small batch over HTTP with epoch seconds),
    every query in process (``node.executor``, cache bypassed) and over
    HTTP, each answer equal to its numpy oracle and each body byte-equal to
    the in-process JSON. A planner GroupBy is ONE ``group_count`` launch;
    the time windows are ``tree_count`` launches over their view leaves.
    Prints each query's p50 both ways, its launches, the stack cache's hits
    and uploads, and the peak device memory."""
    from pilosa_tpu_torch.config import SHARD_WIDTH
    from pilosa_tpu_torch.exec import result_to_json
    from pilosa_tpu_torch.ops import kernels

    device, node, h = data["device"], data["node"], data["holder"]
    ex = node.executor
    planner = ex.planner
    n_shards, n_cols = data["count_shards"], data["count_cols"]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    conn = http_client(node.port)
    for path, opts in FIELDS_SCHEMA:
        expect_ok(conn, "POST", path, {"options": opts} if opts else None)
    conn.close()  # the imports below outlast a keep-alive connection's idle limit
    rng = np.random.default_rng(SEED + 6)
    exp = SHARD_WIDTH.bit_length() - 1

    # The time field: 10M bits, rows 0-2, hourly stamps over 90 days.
    t0 = time.perf_counter()
    t_cols = rng.integers(0, n_cols, FIELDS_TIME_BITS, dtype=np.uint64)
    t_rows = rng.integers(0, FIELDS_TIME_ROWS, FIELDS_TIME_BITS).astype(np.uint64)
    t_hours = rng.integers(0, FIELDS_TIME_HOURS, FIELDS_TIME_BITS)
    stamps = (np.datetime64("2019-01-01T00", "h") + t_hours).astype("datetime64[s]")
    h.field("bench", "t").import_bits(t_rows, t_cols, stamps)
    tf = h.field("bench", "t")
    n_frags = sum(len(v.fragments) for v in tf.views.values())
    log(f"fields: time field t, {FIELDS_TIME_BITS} bits in rows 0-{FIELDS_TIME_ROWS - 1} "
        f"over {FIELDS_TIME_HOURS} hours: {len(tf.views)} views, {n_frags} fragments, "
        f"import {time.perf_counter() - t0:.3f} s (host)")
    del stamps

    # The set fields of the GroupBy lattice.
    pairs, import_s = {}, {}
    for name, n_rows in FIELDS_SET_ROWS.items():
        cols = rng.integers(0, n_cols, FIELDS_SET_BITS, dtype=np.uint64)
        rows = rng.integers(0, n_rows, FIELDS_SET_BITS).astype(np.uint64)
        t0 = time.perf_counter()
        h.field("bench", name).import_bits(rows, cols)
        import_s[name] = round(time.perf_counter() - t0, 3)
        pairs[name] = unique_pairs(cols, rows, n_rows)
    log(f"fields: set fields {dict(FIELDS_SET_ROWS)}, {FIELDS_SET_BITS} bits each, "
        f"import_bits s (host) {import_s}")

    # The mutex field, first import; the bool field: distinct columns in
    # a shuffled order (tests/test_torch_fields.py holds repeated columns
    # in one batch to the JAX package).
    def distinct_cols(n):
        step = n_cols // n
        cols = (np.arange(n, dtype=np.uint64) * np.uint64(step)
                + rng.integers(0, step, n, dtype=np.uint64))
        return cols[rng.permutation(n)]

    m_cols = distinct_cols(FIELDS_MUTEX_COLS)
    m_rows = rng.integers(0, FIELDS_MUTEX_ROWS, FIELDS_MUTEX_COLS).astype(np.uint64)
    t0 = time.perf_counter()
    h.field("bench", "m").import_bits(m_rows, m_cols)
    m_import_s = time.perf_counter() - t0
    b_cols = distinct_cols(FIELDS_BOOL_COLS)
    b_rows = rng.integers(0, 2, FIELDS_BOOL_COLS).astype(np.uint64)
    t0 = time.perf_counter()
    h.field("bench", "flag").import_bits(b_rows, b_cols)
    b_import_s = time.perf_counter() - t0
    want_m3_before = int((m_rows == 3).sum())
    want_flag = int((b_rows == 1).sum())
    log(f"fields: mutex m {FIELDS_MUTEX_COLS} columns over {FIELDS_MUTEX_ROWS} rows "
        f"(import {m_import_s:.3f} s), bool flag {FIELDS_BOOL_COLS} columns (import "
        f"{b_import_s:.3f} s) (host)")

    # 2,000 bits of t's row 7 over HTTP, epoch-second stamps in Jan-Feb.
    conn = http_client(node.port)
    http_cols = rng.integers(0, n_cols, FIELDS_HTTP_BITS, dtype=np.uint64)
    http_hours = rng.integers(0, 59 * 24, FIELDS_HTTP_BITS)
    http_secs = 1546300800 + 3600 * http_hours  # 2019-01-01T00:00 UTC
    expect_ok(conn, "POST", "/index/bench/field/t/import",
              {"rowIDs": [7] * FIELDS_HTTP_BITS, "columnIDs": http_cols.tolist(),
               "timestamps": http_secs.tolist()})
    want_http = len(np.unique(http_cols[http_hours >= 31 * 24]))

    # numpy oracles.
    t_oracle = time.perf_counter()
    g_words = np.stack([h.fragment("bench", "g", "standard", s).row_words(2)
                        for s in range(n_shards)])

    def in_g2(cols):
        cols = cols.astype(np.int64)
        local = cols & (SHARD_WIDTH - 1)
        return ((g_words[cols >> exp, local >> 5] >> (local & 31).astype(np.uint32)) & 1) == 1

    want = {}
    for key, (lo_t, hi_t, lo_h, hi_h) in WINDOWS.items():
        sel = (t_rows == 1) & (t_hours >= lo_h) & (t_hours < hi_h)
        in_window = np.unique(t_cols[sel])
        want[f"time{key}"] = len(in_window)
        if key == "32":
            want["time_and"] = int(in_g2(in_window).sum())
            rows = set(np.unique(t_rows[(t_hours >= lo_h) & (t_hours < hi_h)]).tolist())
            if ((http_hours >= lo_h) & (http_hours < hi_h)).any():
                rows.add(7)
            want["time_rows"] = {"rows": sorted(int(r) for r in rows)}
    a_cols, a_rows = pairs["a"]
    b_cols, b_rows_ = pairs["b"]
    c_cols, c_rows = pairs["c"]
    n_a, n_b, n_c = (FIELDS_SET_ROWS[k] for k in "abc")
    per_shard_a = np.bincount((a_cols >> exp) * n_a + a_rows,
                              minlength=n_shards * n_a).reshape(n_shards, n_a)
    b_g2 = in_g2(b_cols)
    per_shard_b_g2 = np.bincount((b_cols[b_g2] >> exp) * n_b + b_rows_[b_g2],
                                 minlength=n_shards * n_b).reshape(n_shards, n_b)
    want["minrow"] = fold_extreme_row(per_shard_a, True)
    want["maxrow"] = fold_extreme_row(per_shard_b_g2, False)
    ai, bi = join_on_column(a_cols, b_cols)
    ab_cols, ab_a, ab_b = a_cols[ai], a_rows[ai], b_rows_[bi]
    ab = np.bincount(ab_a * n_b + ab_b, minlength=n_a * n_b)
    keep = in_g2(ab_cols)
    ab_f = np.bincount(ab_a[keep] * n_b + ab_b[keep], minlength=n_a * n_b)
    li, ci = join_on_column(ab_cols, c_cols)
    abc = np.bincount((ab_a[li] * n_b + ab_b[li]) * n_c + c_rows[ci],
                      minlength=n_a * n_b * n_c)
    shard_ab = np.bincount(((ab_cols >> exp) * n_a + ab_a) * n_b + ab_b,
                           minlength=n_shards * n_a * n_b).reshape(n_shards, n_a, n_b)

    def lattice(counts, dims):
        return [(tuple(int(x) for x in np.unravel_index(k, dims)), int(c))
                for k, c in enumerate(counts) if c]

    full_ab = lattice(ab, (n_a, n_b))
    want["gb_ab"] = group_json(["a", "b"], full_ab)
    want["gb_ab_filter"] = group_json(["a", "b"], lattice(ab_f, (n_a, n_b)))
    want["gb_abc"] = group_json(["a", "b", "c"], lattice(abc, (n_a, n_b, n_c)))
    want["gb_page"] = group_json(["a", "b"], full_ab[10:15])
    per_shard_b = np.bincount((b_cols >> exp) * n_b + b_rows_,
                              minlength=n_shards * n_b).reshape(n_shards, n_b)
    want["gb_cursor"] = group_json(["a", "b"], cursor_oracle(
        shard_ab, per_shard_a > 0, per_shard_b > 0, (1, 3), 5))
    want["mutex"] = want_m3_before
    want["flag"] = want_flag
    want["http_time"] = want_http
    del g_words, pairs, ai, bi, li, ci, ab_cols, ab_a, ab_b, keep
    log(f"fields: numpy oracles in {time.perf_counter() - t_oracle:.3f} s (host)")
    queries = {
        "time32": "Count(Row(t=1, from='{}', to='{}'))".format(*WINDOWS["32"][:2]),
        "time67": "Count(Row(t=1, from='{}', to='{}'))".format(*WINDOWS["67"][:2]),
        "time_and": "Count(Intersect(Row(t=1, from='{}', to='{}'), Row(g=2)))".format(
            *WINDOWS["32"][:2]),
        "time_rows": "Rows(t, from='{}', to='{}')".format(*WINDOWS["32"][:2]),
        "minrow": "MinRow(field=a)",
        "maxrow": "MaxRow(Row(g=2), field=b)",
        "gb_ab": "GroupBy(Rows(a), Rows(b))",
        "gb_ab_filter": "GroupBy(Rows(a), Rows(b), filter=Row(g=2))",
        "gb_abc": "GroupBy(Rows(a), Rows(b), Rows(c))",
        "gb_page": "GroupBy(Rows(a), Rows(b), limit=5, offset=10)",
        "gb_cursor": "GroupBy(Rows(a, previous=1), Rows(b, previous=3), limit=5)",
        "mutex": "Count(Row(m=3))",
        "flag": "Count(Row(flag=true))",
        "http_time": "Count(Row(t=7, from='2019-02-01T00:00', to='2019-03-01T00:00'))",
    }
    slow = {"time32", "time67", "time_and", "time_rows", "gb_cursor"}
    planner_gb = {"gb_ab", "gb_ab_filter", "gb_abc", "gb_page"}

    def inproc(q):
        before = dict(kernels.LAUNCHES)
        results = ex.execute("bench", q, cache=False)
        body = (json.dumps({"results": [result_to_json(r) for r in results]})
                + "\n").encode()
        return body, {k: kernels.LAUNCHES[k] - before[k] for k in before}

    def over_http(q):
        before = dict(kernels.LAUNCHES)
        status, body = request(conn, "POST", QUERY_PATH.format("bench"), q)
        if status != 200:
            raise AssertionError(f"{q}: HTTP {status} {body[:300]!r}")
        return body, {k: kernels.LAUNCHES[k] - before[k] for k in before}

    def count_kernels(launches):  # the uploads' assemble_stack aside
        return {k: v for k, v in launches.items() if v and k != "assemble_stack"}

    # The fields path's run: counters at 0 just before, read just after.
    kernels.reset_launches()
    hits0, uploads0 = planner.stack_hits, planner.uploads
    report = {}
    for name, q in queries.items():
        t0 = time.perf_counter()
        body, l_first = inproc(q)
        first_ms = (time.perf_counter() - t0) * 1e3
        got = json.loads(body)["results"]
        if got != [want[name]]:
            raise AssertionError(f"{q}: {str(got)[:300]}, numpy oracle "
                                 f"{str([want[name]])[:300]}")
        hbody, l_http = over_http(q)
        if hbody != body:
            raise AssertionError(f"{q}: HTTP body {hbody[:200]!r} is not the "
                                 f"in-process JSON {body[:200]!r}")
        body2, l_in = inproc(q)
        if body2 != body or count_kernels(l_http) != count_kernels(l_in):
            raise AssertionError(f"{q}: warm in process {body2[:100]!r} launches "
                                 f"{l_in}, over HTTP {l_http}")
        if device == "cuda":
            if name in planner_gb and (l_in["group_count"] != 1 or l_first["group_count"] != 1):
                raise AssertionError(f"{q}: launched {l_in} (first {l_first}), not ONE "
                                     "group_count")
            if name not in planner_gb and l_in["group_count"]:
                raise AssertionError(f"{q}: launched group_count {l_in}")
            if name.startswith("time") and name != "time_rows" and l_in["tree_count"] < 1:
                raise AssertionError(f"{q}: no tree_count launch {l_in}")
        n = slow_runs if name in slow else runs
        direct, spread = p50_ms(lambda q=q: ex.execute("bench", q, cache=False), n)
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            over_http(q)
            times.append((time.perf_counter() - t0) * 1e3)
        report[name] = (direct, statistics.median(times))
        log(f"fields {q} = oracle, HTTP body byte-equal; first {first_ms:.3f} ms, "
            f"launches {count_kernels(l_first)} first, {count_kernels(l_in)} warm; "
            f"p50 in process {direct:.4f} ms ({spread}), HTTP {spread_ms(times)} ms "
            f"over {n} runs  [{card}]")

    # The mutex field's moving import: 10M of its columns to new rows.
    moved = rng.choice(FIELDS_MUTEX_COLS, FIELDS_MUTEX_MOVED, replace=False)
    mv_cols = m_cols[moved]
    mv_rows = rng.integers(0, FIELDS_MUTEX_ROWS, FIELDS_MUTEX_MOVED).astype(np.uint64)
    t0 = time.perf_counter()
    h.field("bench", "m").import_bits(mv_rows, mv_cols)
    mv_s = time.perf_counter() - t0
    m_rows[moved] = mv_rows
    want_after = int((m_rows == 3).sum())
    body, l_in = inproc(queries["mutex"])
    hbody, _ = over_http(queries["mutex"])
    if json.loads(body)["results"] != [want_after] or hbody != body:
        raise AssertionError(f"Count(Row(m=3)) after the move: {body!r} HTTP {hbody!r}, "
                             f"numpy {want_after}")
    log(f"fields Count(Row(m=3)): {want_m3_before} before, {want_after} after moving "
        f"{FIELDS_MUTEX_MOVED} columns (import {mv_s:.3f} s), oracle and HTTP equal, "
        f"launches {count_kernels(l_in)}  [{card}]")
    del m_cols, m_rows, mv_cols, mv_rows, moved, b_cols, b_rows, t_cols, t_rows, t_hours

    # Wide lattices at a few shards, where the stack cap admits hundreds of
    # planes and group_count reads them from device memory, unstaged:
    # GroupBy(Rows(w)) over 450 rows, and a (32, 256) lattice of 8192
    # groups over 288 planes.
    conn.close()
    conn = http_client(node.port)
    for path in WIDE_SCHEMA:
        expect_ok(conn, "POST", path)
    wide_cols = WIDE_SHARDS * SHARD_WIDTH
    wide_pairs = {}
    for name, n_rows in WIDE_ROWS.items():
        cols = rng.integers(0, wide_cols, WIDE_BITS, dtype=np.uint64)
        rows = rng.integers(0, n_rows, WIDE_BITS).astype(np.uint64)
        h.field("wide", name).import_bits(rows, cols)
        wide_pairs[name] = unique_pairs(cols, rows, n_rows)
    w_cols, w_rows = wide_pairs["w"]
    x_cols, x_rows = wide_pairs["x"]
    y_cols, y_rows = wide_pairs["y"]
    xi, yi = join_on_column(x_cols, y_cols)
    n_y = WIDE_ROWS["y"]
    want_wide = {
        "GroupBy(Rows(w))": group_json(["w"], lattice(
            np.bincount(w_rows, minlength=WIDE_ROWS["w"]), (WIDE_ROWS["w"],))),
        "GroupBy(Rows(x), Rows(y))": group_json(["x", "y"], lattice(
            np.bincount(x_rows[xi] * n_y + y_rows[yi], minlength=WIDE_ROWS["x"] * n_y),
            (WIDE_ROWS["x"], n_y))),
    }
    for q, want_q in want_wide.items():
        before = dict(kernels.LAUNCHES)
        results = ex.execute("wide", q, cache=False)
        l_in = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        body = (json.dumps({"results": [result_to_json(r) for r in results]})
                + "\n").encode()
        status, hbody = request(conn, "POST", QUERY_PATH.format("wide"), q)
        if json.loads(body)["results"] != [want_q] or status != 200 or hbody != body:
            raise AssertionError(f"wide {q}: {body[:300]!r}, HTTP {status} {hbody[:200]!r}, "
                                 f"numpy oracle {str(want_q)[:300]}")
        if device == "cuda" and l_in["group_count"] != 1:
            raise AssertionError(f"wide {q}: launched {count_kernels(l_in)}, not ONE "
                                 "group_count")
        log(f"fields {q} over {WIDE_SHARDS} shards: {len(want_q)} groups = oracle, HTTP "
            f"body byte-equal, launches {count_kernels(l_in)}  [{card}]")
    del wide_pairs, w_cols, w_rows, x_cols, x_rows, y_cols, y_rows, xi, yi

    launches = dict(kernels.LAUNCHES)
    log(f"fields path launches: {launches}  [{card}]")
    log(f"fields stack cache: {planner.stack_hits - hits0} hits, "
        f"{planner.uploads - uploads0} uploads, {planner.evictions} evictions in all, "
        f"budget {planner.max_cache_bytes / 2**30:.3f} GiB")
    if device == "cuda":
        log(f"fields peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
        for k in FIELDS_KERNELS:
            if launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the fields path")
    conn.close()
    return {"launches": launches, "p50": report}


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
    data: dict = {}
    phases = (("toolchain", lambda: phase_toolchain(torch, card)),
              ("kernels", lambda: phase_kernels(torch, card)),
              ("data", lambda: phase_data(torch, card, data)),
              ("main_path", lambda: phase_main_path(torch, card, data)),
              ("bsi", lambda: phase_bsi(torch, card, data)),
              ("http", lambda: phase_http(torch, card, data)),
              ("persist", lambda: phase_persist(torch, card, data)),
              ("pql", lambda: phase_pql(torch, card, data)),
              ("async", lambda: phase_async(torch, card, data)),
              ("fields", lambda: phase_fields(torch, card, data)))
    try:
        for name, phase in phases:
            log(f"== phase {name}")
            t0 = time.perf_counter()
            try:
                results[name] = phase()
            except Exception:  # report every phase, then fail as a whole
                traceback.print_exc()
                sys.stdout.flush()
                failed.append(name)
                torch.cuda.empty_cache()  # what the failed phase held
                if name in ("toolchain", "data"):
                    break
            log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    finally:
        if "node" in data:
            data["node"].close()
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1

    timings = results["kernels"]["timings"]
    errs = results["kernels"]["errs"]
    launches = {k: sum(results[p]["launches"][k]
                       for p in ("main_path", "bsi", "http", "persist", "pql", "async",
                                 "fields"))
                for k in errs}
    sources = {"pair_count": "pilosa_tpu_torch/csrc/count_kernels.cu",
               "row_counts": "pilosa_tpu_torch/csrc/count_kernels.cu",
               "bsi_compare": "pilosa_tpu_torch/csrc/bsi_kernels.cu",
               "bsi_minmax": "pilosa_tpu_torch/csrc/bsi_kernels.cu",
               "tree_count": "pilosa_tpu_torch/csrc/tree_kernels.cu",
               "shift_left": "pilosa_tpu_torch/csrc/tree_kernels.cu",
               "pair_count_batched": "pilosa_tpu_torch/csrc/count_kernels.cu",
               "row_counts_batched": "pilosa_tpu_torch/csrc/count_kernels.cu",
               "tree_count_batched": "pilosa_tpu_torch/csrc/tree_kernels.cu",
               "assemble_stack": "pilosa_tpu_torch/csrc/upload_kernels.cu",
               "group_count": "pilosa_tpu_torch/csrc/group_kernels.cu"}
    vmapped = ("pilosa_tpu/parallel/coalesce.py:312-348 _flush_batched + "
               "pilosa_tpu/parallel/planner.py:387-396 vmapped (jax.vmap of the "
               "count program; no pallas_call)")
    replaces = {"pair_count": "pilosa_tpu/ops/pallas_kernels.py:104",
                "row_counts": "pilosa_tpu/ops/pallas_kernels.py:124",
                "bsi_compare": "pilosa_tpu/ops/bsi.py:50-79 compare_unsigned + "
                               "_compare_select (XLA-fused, no pallas_call)",
                "bsi_minmax": "pilosa_tpu/ops/bsi.py:208-257 _min_unsigned / "
                              "_max_unsigned (XLA-fused, no pallas_call)",
                "tree_count": "pilosa_tpu/parallel/planner.py:1932-1957 _eval_node + "
                              "bitops.count under _compiled(reduce='per_shard') "
                              ":1814-1819 (XLA-fused, no pallas_call)",
                "shift_left": "pilosa_tpu/ops/bitops.py:167-195 shift_left "
                              "(XLA-fused, no pallas_call)",
                "pair_count_batched": vmapped + " over pair_count",
                "row_counts_batched": vmapped + " over row_counts",
                "tree_count_batched": vmapped + " over _eval_node",
                "assemble_stack": "pilosa_tpu/parallel/planner.py:2046-2057 "
                                  "_assemble_stack (XLA-fused, no pallas_call)",
                "group_count": "pilosa_tpu/parallel/planner.py:919-978 execute_group_by "
                               "(XLA-fused, no pallas_call)"}
    entries = []
    for name in sources:
        ms, plain, bound, by, lib = timings[name]
        entries.append({"name": name, "route": "cuda", "source": sources[name],
                        "replaces": replaces[name], "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                        "bound_ms": bound, "bound_by": by, "library_ms": lib})
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--clients"]:
        sys.exit(clients_main())
    if sys.argv[1:2] == ["--tree-batched"] and len(sys.argv) == 3:
        sys.exit(tree_batched_times(sys.argv[2]))
    if sys.argv[1:2] == ["--tree-batched-vs"] and len(sys.argv) == 3:
        sys.exit(tree_batched_vs(sys.argv[2]))
    if sys.argv[1:] == ["--import-rule"]:
        sys.exit(import_rule_vs())
    if sys.argv[1:2] == ["--import-rule-side"] and len(sys.argv) == 3:
        sys.exit(import_rule_side(int(sys.argv[2])))
    sys.exit(main())
