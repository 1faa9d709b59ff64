#!/usr/bin/env python3
"""Smoke run of pilosa_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --tree-batched-vs DIR
    python3 chip_smoke.py --group-count-vs DIR
    python3 chip_smoke.py --packed-vs DIR
    python3 chip_smoke.py --plane-scatter-vs DIR
    python3 chip_smoke.py --sketch-vs DIR
    python3 chip_smoke.py --reduce-vs DIR
    python3 chip_smoke.py --import-rule

``--tree-batched-vs DIR`` times only ``tree_count_batched`` on its two timed
waves, the package in DIR (e.g. the parent commit unpacked with ``git
archive``) against this checkout's, in 10 pairs of processes
(``tree_batched_vs``); ``--group-count-vs DIR`` does the same for
``group_count`` on its three timed lattices (``GROUP_TIMED``), each side
through its own interface (``group_count_vs``); ``--packed-vs DIR`` for
``packed_count``, ``packed_and_dense_count`` and ``packed_pair_count`` at
their timed shapes and for the three packed waves at 8 and 32 slots, one
launch here against DIR's slot-by-slot launches where DIR has no wave
kernels, beside the one-launch floor (``packed_vs``); ``--plane-scatter-vs DIR``
for ``plane_scatter`` at bench config 3's shard, a full shard and depth 40,
each side through its own wrapper (a zero fill inside the time where it has
one), beside the one-launch floor (``plane_scatter_vs``); ``--sketch-vs DIR`` for
``hll_expand`` (the keys phase's shape, an all-ones filter, a filter with
each shard's bits in one chunk, p = 16) and ``plane_lookup`` (65,536 and
300 probes), beside the one-launch floor (``sketch_vs``; one side alone:
``--sketch DIR``); ``--reduce-vs DIR`` for the remote Row leg's scatter
(this checkout's ``scatter_bits_grouped`` against DIR's, or DIR's
``scatter_bits`` where it has no grouped form) at the 32-shard leg, a full
shard and a 300-position leg, each through its own wrapper and upload
layout, beside the one-launch floor, with ``row_from_columns``' host time
at the 32-shard leg split into its steps on both sides (``reduce_vs``).
``--import-rule`` times
the set-field import under the port's and the JAX package's scatter rules
on one host
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
  bits, its 20M values also imported through ``Field.import_values`` (the
  first 8 shards into a fresh field by the native scatter, the other 946
  per fragment, through ``plane_scatter`` where ``auto`` picks the device;
  every plane equal to the loaded ones), asked ``Sum``/``Min``/``Max``
  (with and without filters, one of them a BSI condition) and ``Count`` of
  range conditions; then the import of the last 240 shards' values timed
  under ``PILOSA_TPU_INGEST_TRANSPOSE`` = off, on;
- HTTP path: every query of both through ``POST /index/{i}/query`` on a
  keep-alive connection, each body held to the oracle and byte for byte
  to the in-process JSON with the same launches; warm latencies beside the
  in-process ones; a JSON import of 200k bits and 200k values; 8
  concurrent clients; the 404/400/504 statuses and a resize abort with no
  job (200); ``/metrics``;
- persist path: a second node with ``data_dir`` under
  ``build/chip_smoke_data/`` takes the first 10 shards (``PERSIST_SHARDS``)
  of the 1B columns of ``bench`` and ``bsi`` the way Pilosa's
  clients bulk-load (one ``import-roaring`` per field and shard, bodies
  from the first node's ``Fragment.to_roaring``; the BSI planes in process
  through ``interop.load_bsi_planes``), is closed (schema, snapshots, WAL
  truncate), and a third node reopens the dir: every Count and BSI query
  over HTTP (``shards=`` the held ones) equals the oracle of those shards
  and the first node's body byte for byte, with the same launches; then a CLI node with
  ``--data-dir`` is SIGKILLed after acknowledged writes and must read them
  back from its WAL, and a bit-flipped snapshot must be quarantined with a
  503 on its shard; before that, the third node's dir is backed up over
  ``POST /backup``, and again as an incremental after four ``Set``
  calls, ``backup-verify`` checks the archive, and a fourth node on a
  fresh dir restores the incremental over ``POST /restore``, answers
  every query as the first node does and reads the Sets back;
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
  ``assemble_stack`` and count (residency pinned ``off`` for it: under
  ``auto`` the row is packed);
- packed path: on the same index under the default ``auto``, the sparse
  row f=30 (K = 1024) and a row f=31 of 2,000 bits a shard (K = 2048, half
  of row 30's bits among them) are packed [1024, K] index stacks:
  ``Count(Row(f=30))`` is ONE ``packed_count``, its Intersect with the
  dense row f=1 (either order) ONE ``packed_and_dense_count``, with row 31
  ONE ``packed_pair_count``, its Union with row 1 ``packed_expand`` and
  ``pair_count``, a 3-leaf Intersect ``packed_expand`` and ``tree_count``,
  and ``Row(f=30)`` a ``packed_expand``, in process and over HTTP against
  numpy; 8 rows of 1,000 bits a shard (K = 1024), and a held wave of 8
  different Counts on each packed fast path ONE ``packed_count_batched``,
  ``packed_and_dense_count_batched`` or ``packed_pair_count_batched``
  (the bare wave over HTTP too), timed beside the same wave slot by slot;
  the resident bytes by class, each Count's p50 beside the knob
  ``off``, and so ``Row(f=30)`` and a TopN filtered by it (uncached plans:
  a shard walk and a ``packed_expand`` each time), the leaf-class walk's
  host time, the cold packed upload; then row 30 grows to 5,000 bits in
  shard 0 and its Count drops its plan and runs dense (ONE
  ``row_counts``);
- fields path: on ``bench``, fields created over HTTP and loaded from
  seeded data: a YMDH time field (5M bits in rows 0-2 over 30 days of
  hours: bench config 4's bits halved, its 90 days cut to the windows'
  first 30, its columns to the first 40 shards), set fields a, b, c (4, 8
  and 3 rows, 15M bits each: bench config 5's), a mutex field (6.25M
  columns, then 1.25M moved) and a bool field (10M columns); time windows of
  32 and 67 views (``tree_count`` over the view leaves), ``Rows`` over a
  window, ``MinRow``/``MaxRow``, GroupBy of two and three levels, with a
  filter and paged (ONE ``group_count`` each) and with a cursor (the
  per-shard walk), in process and over HTTP against numpy oracles; then,
  on an index of 4 shards, GroupBy over 450 rows and over a (32, 256)
  lattice of 8192 groups (ONE ``group_count`` each, over many units of
  the lattice);
- keys path (``phase_keys``): in process, on a planner whose budget holds
  the 4 GiB hll plane stack, ``Count(Distinct)`` on bench config 3's
  ``v`` (unfiltered: ONE ``hll_reduce`` of the register stack; filtered
  by the 5M-bit row: ONE ``hll_expand`` and ONE ``hll_reduce``; at
  precision 16 and, under a threshold, the exact leg, both over the first
  96 shards) and ``SimilarTopN`` on
  the fields phase's 8-row ``b`` (ONE ``similar_count`` over a 1 GiB
  cube), both metrics, each equal to a numpy oracle (``sketch_values`` of
  the values, the rows' overlaps) and its HTTP body; then a keyed index on
  a node with a data dir, 500,000 column keys and 1,024 row keys imported over
  HTTP by keys: keyed ``Row``, ``Count`` and ``TopN`` bodies equal the
  oracle from the id map, a ``Count(Union)`` of 300 keyed rows is ONE
  ``plane_lookup`` under ``auto`` once its plane is built
  (``/debug/translate``), and the bodies stand after close and reopen and
  after a backup restored into a fresh dir;
- cluster path (``phase_cluster``): three ``cli server --peers
  --replica-n 2`` processes on loopback share the card; bench's rows f=1
  and g=2 over all 954 shards go in as one ``import-roaring`` a field and
  shard through the coordinator (which routes each body to both owners),
  a second index of 16 shards (set fields of 64 and 8 rows, an int field)
  through its JSON /import; the section 2 Counts through each member as
  coordinator (ONE ``pair_count`` a node's leg), ``Row(f=1)`` over 32
  shards (each remote leg ONE ``scatter_bits_grouped`` on the coordinator) and the
  second index's TopN, GroupBy, Sum/Min/Max, Count(Distinct), Rows and Row
  with ``shards=`` equal numpy oracles and node A's bodies byte for byte;
  then acknowledged Set and Clear; a second cluster on the CLI's
  defaults (hedged reads on, device reduce ``auto``), booted and loaded
  beside the first and given the same writes, gives every body again and
  stops; then the elastic cluster (below); then a SIGKILLed member, the
  same bodies through the live coordinators, the member DOWN in
  ``/debug/membership`` after a liveness sweep, and ``union_rows`` of two
  live owners' remote legs of the same shards (ONE ``or_fold``; no cluster
  query folds a contested shard, so the kernels line labels these
  launches ``launches_constructed_fold``). The elastic cluster
  (``cluster_elastic``): a
  fourth ``cli server --join`` with a data dir grows the ring while
  acknowledged Set/Clear pairs go through the coordinator and Counts
  through each member; bits are cleared in shards that moved off node A;
  the joiner restarts from its ``topology.json``; ``POST
  /cluster/resize/remove-node`` shrinks the ring back, node A's own
  fragments of the shards it took back holding none of the cleared bits;
  a bit posted to one owner alone reaches the other on the anti-entropy
  tick (5 s, from a config file); a keyed index of 250,000 column keys
  gets its ids through two members, one id a key everywhere, and a member's
  300-key batch launches ``plane_lookup``. Every body through every
  member equals its oracle and node A's after each step. The defaults
  cluster keeps data dirs under ``build/chip_smoke_cluster_backup/``:
  before the writes, ``POST /backup`` on one member archives the whole
  ring (every fragment once, from the first live owner); after them, one
  owner of the written shard gets a bit flipped in its copy's WAL and the
  incremental through that member captures the fragment from the other
  owner; the defaults cluster stops, and ``POST /restore`` on a fresh
  two-node cluster with data dirs (booted meanwhile, exporting spans with
  ``--trace-endpoint`` to a collector double in this process) rebuilds the
  chain, each fragment pushed to its owner: every body through both
  members equals node A's and the oracle, ``pair_count`` and
  ``row_counts`` launch on each, and one traced Count's spans reach the
  collector under one trace id from the coordinator and its peer;
- loadgen (``phase_loadgen``): ``python -m pilosa_tpu_torch.loadgen
  smoke3`` and ``dr_drill`` with managed port nodes on the card, each
  report gated by ``scripts/slo_gate.py`` against its baseline in
  ``scripts/slo_baselines/``.

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
    c.phase_packed(torch, "cpu", d, runs=2)
    c.FIELDS_TIME_BITS, c.FIELDS_SET_BITS = 200_000, 60_000
    c.FIELDS_MUTEX_COLS, c.FIELDS_MUTEX_MOVED, c.FIELDS_BOOL_COLS = 200_000, 40_000, 80_000
    c.phase_fields(torch, "cpu", d, runs=2, slow_runs=2)
    c.KEYS_COLS, c.KEYS_BATCH = 20_000, 5_000
    c.phase_keys(torch, "cpu", d, runs=2)
    c.phase_cluster(torch, "cpu", d, runs=2)
    c.phase_loadgen(torch, "cpu", d)
    d["node"].close()

(with ``c.PERSIST_SHARDS = 3`` and ``c.BACKUP_SET_COLS`` inside those
shards before ``phase_persist``).
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

#: H100 SXM HBM3 peak (NVIDIA data sheet), bytes/s.
PEAK_BYTES_PER_S = 3.35e12
#: Integer throughput of compute capability 9.0, results per clock per SM
#: (CUDA C++ Programming Guide, "Arithmetic Instructions", throughput
#: table): 32-bit bitwise AND/OR/XOR and 32-bit add, 64; 32-bit population
#: count, 16. ``integer_rates`` multiplies them by the card's SMs and its
#: maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``).
LOGIC_PER_CLOCK_SM = 64
POPC_PER_CLOCK_SM = 16
#: words of a shard's row, and the tape of the timed tree_count_batched waves.
SHARD_WORDS = 32768
TREE_BATCHED_TAPE = [0, 1, "and", 2, "and"]

#: bench.py's config 3 (bench.py:870-949) at the Count path's column space:
#: 2M values over 100M columns and a 500K-bit filter there, scaled x10.
BSI_SHARDS = COUNT_SHARDS
BSI_DENSITY = 0.02
BSI_MIN, BSI_MAX = -100000, 100000
BSI_FILTER_BITS = 5_000_000
#: every value also goes through Field.import_values as a check: the
#: shards below this into a fresh field in one batch (the native scatter),
#: then the rest (per fragment: the device transpose under ``auto``).
BSI_IMPORT_SHARDS = 8
#: the import A/B's modes, timed in this order on one host clock, and the
#: last shards whose values it imports (a quarter of the 954: the whole
#: field until the cluster phase's backup and restore came in). The last
#: ones: a batch reaching shard 953 spans past the native scatter's 1 GiB
#: guard, so each fragment takes the per-fragment path as the whole
#: field's did.
BSI_IMPORT_AB = ("off", "on")
BSI_AB_SHARDS = 240
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
#: snapshots, plus the TopN shard's (12 GiB), the backup archive of the
#: snapshots (under 1 GiB) and the restored data dir, whose WAL holds every
#: bit as a 16-byte record before its flush (about 6 GiB).
PERSIST_MIN_FREE_GIB = 19
#: the shards of bench and bsi the persist phase's nodes hold: the first
#: ten of the 954 (all of them until the keys phase joined the run, when
#: every bulk load, close, backup and restore of this phase was cut to a
#: quarter, then to an eighth, to make room for it; to a sixteenth, then a
#: thirty-second, when the cluster phase joined; to ten when the cluster
#: phase's backup and restore of all 954 came in). Their queries ask node
#: A for the same shards.
PERSIST_SHARDS = 10
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


def distinct(x: np.ndarray) -> np.ndarray:
    """The sorted distinct values of a 1-D array: ``np.unique``'s answer by
    a sort and a neighbour mask (on the card host's numpy, np.unique of a
    few million values takes seconds; ROADMAP.md item 20)."""
    x = np.sort(np.asarray(x).ravel())
    return x[np.concatenate(([True], x[1:] != x[:-1]))] if len(x) else x


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


_RATES: dict = {}


def integer_rates(torch) -> tuple[float, float]:
    """(32-bit logic ops and adds, population counts) per second of card 0:
    the per-SM rates of compute capability 9.0 x its SMs x its maximum SM
    clock as nvidia-smi reports it."""
    if not _RATES:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        hz = float(out.stdout.strip().splitlines()[0]) * 1e6
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _RATES.update(logic=LOGIC_PER_CLOCK_SM * sms * hz, popc=POPC_PER_CLOCK_SM * sms * hz,
                      sms=sms, mhz=hz / 1e6)
    return _RATES["logic"], _RATES["popc"]


def bound_ms(torch, nbytes: int, logic: int, popc: int) -> tuple[float, str, str]:
    """The least time the card could take: the largest of the bytes over
    HBM's rate, the 32-bit logic ops and adds over their rate, and the
    population counts over theirs. Returns (ms, "bytes" or "operations",
    the term: "bytes", "logic" or "popcounts")."""
    logic_rate, popc_rate = integer_rates(torch)
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "logic": logic / logic_rate * 1e3,
             "popcounts": popc / popc_rate * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def lattice_work(sizes, filtered: bool, words: int) -> tuple[int, int]:
    """(logic ops, popcounts) of a GroupBy lattice over ``words`` words of
    each plane as csrc/group_kernels.cu counts it: walked as a prefix tree,
    one AND per tree node and word below the root level (the root level's
    too with a filter), the groups' ANDs included; then for each group and
    three words a full adder (two 3-input logic ops), two popcounts and
    two adds."""
    nodes = list(itertools.accumulate(sizes, lambda a, b: a * b))
    ands = sum(nodes[1:]) + (nodes[0] if filtered else 0)
    groups = nodes[-1]
    return ands * words + 4 * groups * words // 3, 2 * groups * words // 3


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


def paired_runs(flag: str, parent: str, key: str, pairs: int = 10) -> dict:
    """``flag DIR`` of ``parent`` (e.g. the parent commit unpacked with ``git
    archive``) and of this checkout, each in a process of its own, in
    ``pairs`` pairs, the side that runs first alternating. Each run prints
    one JSON object per timed case, named by its ``key``; prints every
    record and returns {(case, "parent" or "this"): [record, ...]}."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs: dict = {}
    for k in range(pairs):
        sides = (("parent", parent), ("this", here))
        for label, repo in sides if k % 2 == 0 else sides[::-1]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), flag, repo],
                                 capture_output=True, text=True, check=False)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise RuntimeError(f"{flag} {repo} exited {out.returncode}")
            for line in out.stdout.splitlines():
                rec = json.loads(line)
                runs.setdefault((rec[key], label), []).append(rec)
                print(json.dumps({"pair": k, "repo": label, **rec}), flush=True)
    return runs


def pair_summary(runs: dict, case, key: str, bound: float, card: str) -> None:
    """One case of ``paired_runs``: the medians of both sides, the pairs
    this checkout won, the spread of the parent's runs (between its
    quartiles), each side's median host enqueue, the bound and the card."""
    ms = {lb: [r["ms"] for r in runs[(case, lb)]] for lb in ("parent", "this")}
    q1, _, q3 = statistics.quantiles(ms["parent"], n=4)
    print(json.dumps({
        key: case, "pairs": len(ms["this"]),
        "parent_ms": statistics.median(ms["parent"]), "this_ms": statistics.median(ms["this"]),
        "this_won": sum(t < p for p, t in zip(ms["parent"], ms["this"])),
        "parent_spread_ms": q3 - q1, "bound_ms": bound,
        "host_ms": {lb: statistics.median(r["host_ms"] for r in runs[(case, lb)])
                    for lb in ("parent", "this")},
        "card": card}), flush=True)


def tree_batched_vs(parent: str) -> int:
    """``--tree-batched-vs DIR``: ``--tree-batched`` of DIR against this
    checkout's, in ``paired_runs``; then ``pair_summary`` per wave."""
    import torch

    runs = paired_runs("--tree-batched", parent, "distinct_planes")
    card, plane = card_line(), 1024 * SHARD_WORDS * 4
    for distinct in (15, 24):
        bound = bound_ms(torch, distinct * plane + 8 * 1024 * 4, 3 * 8 * 1024 * SHARD_WORDS,
                         8 * 1024 * SHARD_WORDS)[0]
        pair_summary(runs, distinct, "distinct_planes", bound, card)
    return 0


#: group_count's timed lattices: (name, level sizes, filtered, shard rows
#: of 32768 words, rows of the stacks the planes are cut from). Bench
#: config 5 at 954 shards of 1024-row stacks, with a filter and with a
#: third level; 8192 groups over 4 rows (popcount-bound).
GROUP_TIMED = (
    ("(4, 8) + filter", (4, 8), True, 954, 1024),
    ("(4, 8, 3)", (4, 8, 3), False, 954, 1024),
    ("(32, 256) over 4 rows", (32, 256), False, 4, 4),
)


def lattice_table(sizes) -> np.ndarray:
    """The [G, L] plane-index table of a lattice of these level sizes (the
    interface group_count took before it took the sizes)."""
    starts = np.cumsum([0] + list(sizes[:-1]))
    return np.asarray(list(itertools.product(
        *[range(int(a), int(a) + n) for a, n in zip(starts, sizes)])), dtype=np.int64)


def group_timed_work(sizes, filtered: bool, rows: int) -> tuple[int, int, int]:
    """(bytes, logic ops, popcounts) of a timed lattice over ``rows`` shard
    rows: each plane and the filter read once, the int64 counts written
    once, and ``lattice_work``."""
    words = rows * SHARD_WORDS
    nbytes = (sum(sizes) + filtered) * words * 4 + int(np.prod(sizes)) * 8
    return (nbytes, *lattice_work(sizes, filtered, words))


def group_count_times(repo: str) -> int:
    """``--group-count REPO``: time ``group_count`` of the package in REPO
    on GROUP_TIMED (random planes made on the card from SEED) with this
    script's timer, its counts first held to the plain version. The
    package's own interface: level sizes, or (before them) a [G, L] table.
    One JSON object per lattice: the kernel's ms by CUDA events, the
    host's median and longest enqueue of one call."""
    import inspect

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(repo))
    from pilosa_tpu_torch.ops import kernels

    takes_sizes = "sizes" in inspect.signature(kernels.group_count).parameters
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, sizes, filtered, rows, stack_rows in GROUP_TIMED:
        def plane(rows=rows, stack_rows=stack_rows):
            return torch.randint(-2**31, 2**31, (stack_rows, SHARD_WORDS), dtype=torch.int32,
                                 device="cuda", generator=gen)[:rows]

        planes = [plane() for _ in range(sum(sizes))]
        filt = plane() if filtered else None
        arg = sizes if takes_sizes else lattice_table(sizes)
        plain_arg = arg if takes_sizes else torch.from_numpy(arg)

        def fn(planes=planes, arg=arg, filt=filt):
            return kernels.group_count(planes, arg, filt)

        if not torch.equal(fn(), kernels.group_count_plain(planes, plain_arg, filt)):
            raise AssertionError(f"{repo}: {name}: counts differ from the plain")
        host = host_enqueue_times(torch, fn, KERNEL_RUNS)
        print(json.dumps({"lattice": name, "ms": time_cuda_ms(torch, fn, KERNEL_RUNS),
                          "host_ms": statistics.median(host), "host_ms_max": max(host)}),
              flush=True)
        del planes, filt
    return 0


def group_count_vs(parent: str) -> int:
    """``--group-count-vs DIR``: ``--group-count`` of DIR against this
    checkout's, in ``paired_runs``; then ``pair_summary`` per lattice."""
    import torch

    runs = paired_runs("--group-count", parent, "lattice")
    card = card_line()
    for name, sizes, filtered, rows, _ in GROUP_TIMED:
        pair_summary(runs, name, "lattice",
                     bound_ms(torch, *group_timed_work(sizes, filtered, rows))[0], card)
    return 0


#: the kernels ``--packed-vs`` times, at their packed_timed_cases shapes.
PACKED_VS_KERNELS = ("packed_count", "packed_and_dense_count", "packed_pair_count")


def packed_times(repo: str) -> int:
    """``--packed REPO``: time ``packed_count``, ``packed_and_dense_count``
    and ``packed_pair_count`` of the package in REPO at their timed shapes
    (``packed_timed_cases`` on the seeded ``packed_case`` stacks, made on
    the card), and_count and pair_count at each PACKED_VS_WIDTHS width K
    (and_count of a [1024, K] stack against its case's plane, pair_count of
    it against a [1024, K] stack of the next seed), and the three packed
    waves at PACKED_WAVE_TIMED slots (``packed_wave_cases``: the wave
    kernels, or, in a package without them, the slots launched one by one
    through the single kernels); then the one-launch floor (torch.zeros of
    1024 int32). This script's timer; each case held exactly to its plain
    version first. One JSON object per case: the kernel's ms by CUDA
    events after the device spin (``time_cuda_ms``), the host's median and
    longest enqueue of one call, and the case's bytes and operations (for
    its bound)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(repo))
    from pilosa_tpu_torch.ops import kernels

    dev = torch.device("cuda")

    def stacks(case, seed=SEED):
        return tuple(torch.from_numpy(x.view(np.int32)).to(dev)
                     for x in packed_case(case, 1024, seed))

    packed = {case: stacks(case) for case in ("k1024", "k2048")}
    cases = [c for c in packed_timed_cases(kernels, packed) if c[0] in PACKED_VS_KERNELS]
    cases += [timed for timed, _ in packed_width_cases(torch, kernels, stacks)]
    for n in PACKED_WAVE_TIMED:
        cases += [c[:7] for c in packed_wave_cases(torch, kernels, packed, n)]
    cases.append(("floor", "torch.zeros(1024, int32)",
                  lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
                  lambda: torch.zeros(1024, dtype=torch.int32, device=dev), 4096, 0, 0))
    for name, shape, fn, plain_fn, nbytes, logic, popc in cases:
        got = fn()
        if not torch.equal(torch.stack(got) if isinstance(got, list) else got, plain_fn()):
            raise AssertionError(f"{repo}: {name} {shape}: counts differ from the plain")
        host = host_enqueue_times(torch, fn, KERNEL_RUNS)
        print(json.dumps({"case": f"{name} {shape}", "ms": time_cuda_ms(torch, fn, KERNEL_RUNS),
                          "host_ms": statistics.median(host), "host_ms_max": max(host),
                          "bytes": nbytes, "logic": logic, "popc": popc}), flush=True)
    return 0


def packed_vs(parent: str) -> int:
    """``--packed-vs DIR``: ``--packed`` of DIR against this checkout's, in
    ``paired_runs``; then ``pair_summary`` per case, against its bound."""
    import torch

    runs = paired_runs("--packed", parent, "case")
    card = card_line()
    for case in dict.fromkeys(c for c, _ in runs):
        rec = runs[(case, "this")][0]
        pair_summary(runs, case, "case", bound_ms(torch, rec["bytes"], rec["logic"],
                                                  rec["popc"])[0], card)
    return 0


def plane_scatter_work(pos, depth: int) -> int:
    """plane_scatter's bytes: each entry read once (int32 position, int64
    value), the ``[depth + 2, W]`` image written once."""
    return 12 * len(pos) + (depth + 2) * SHARD_WORDS * 4


def plane_scatter_times(repo: str) -> int:
    """``--plane-scatter REPO``: time ``kernels.plane_scatter`` of the
    package in REPO on PLANE_SCATTER_TIMED (each case's image first held
    exactly to the plain version), through the package's own wrapper (its
    allocation, and its zero fill where it has one, inside the time); then
    the one-launch floor (torch.zeros of 1024 int32). One JSON object per
    case: the kernel's ms by CUDA events after the device spin, the host's
    median and longest enqueue of one call, and the case's bytes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(repo))
    from pilosa_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    cases = []
    for name in PLANE_SCATTER_TIMED:
        pos_np, vals_np, depth = plane_scatter_case(name)
        pos, vals = torch.from_numpy(pos_np).to(dev), torch.from_numpy(vals_np).to(dev)
        cases.append((name, lambda pos=pos, vals=vals, depth=depth:
                      kernels.plane_scatter(pos, vals, depth),
                      lambda pos=pos, vals=vals, depth=depth:
                      kernels.plane_scatter_plain(pos, vals, depth),
                      plane_scatter_work(pos, depth)))
    cases.append(("floor", lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
                  lambda: torch.zeros(1024, dtype=torch.int32, device=dev), 4096))
    for case, fn, plain_fn, nbytes in cases:
        if not torch.equal(fn(), plain_fn()):
            raise AssertionError(f"{repo}: plane_scatter {case}: the image differs from "
                                 "the plain version")
        host = host_enqueue_times(torch, fn, KERNEL_RUNS)
        print(json.dumps({"case": case, "ms": time_cuda_ms(torch, fn, KERNEL_RUNS),
                          "host_ms": statistics.median(host), "host_ms_max": max(host),
                          "bytes": nbytes}), flush=True)
    return 0


def plane_scatter_vs(parent: str) -> int:
    """``--plane-scatter-vs DIR``: ``--plane-scatter`` of DIR against this
    checkout's, in ``paired_runs``; then ``pair_summary`` per case (the
    floor's too), against its bound."""
    import torch

    runs = paired_runs("--plane-scatter", parent, "case")
    card = card_line()
    for case in dict.fromkeys(c for c, _ in runs):
        rec = runs[(case, "this")][0]
        pair_summary(runs, case, "case", bound_ms(torch, rec["bytes"], 0, 0)[0], card)
    return 0


#: ``--sketch``'s cases: hll_expand at the keys phase's shape (a 5M-bit
#: filter, p = 12), under an all-ones filter, under a filter with a
#: shard's bits all in one chunk (as many a shard as the 5M-bit filter's),
#: and at p = 16 (the in-place byte branch); plane_lookup on a 2^20-slot
#: plane at 65,536 probes and at the keyed Union's 300; the one-launch
#: floor (torch.zeros of 1024 int32).
SKETCH_TIMED = ("hll_timed", "hll_ones", "hll_one_chunk", "hll_p16", "lookup_65536",
                "lookup_300", "floor")


def sketch_times(repo: str) -> int:
    """``--sketch REPO``: time ``kernels.hll_expand`` and
    ``kernels.plane_lookup`` of the package in REPO on SKETCH_TIMED, each
    through the package's own wrapper and first held exactly to its plain
    version, inputs made on the card from SEED. One JSON object per case:
    the kernel's ms by CUDA events after the device spin, the host's median
    and longest enqueue of one call, and the case's bytes and logic ops
    (``hll_expand_work``, ``plane_lookup_bytes``)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(repo))
    from pilosa_tpu_torch.ops import kernels

    dev = torch.device("cuda")

    def t(words):
        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)

    rows = HLL_TIMED_ROWS
    timed = t(filter_words(rows, BSI_FILTER_BITS, SEED))
    filters = {"hll_timed": timed, "hll_ones": t(hll_filter("ones", rows, SEED)),
               "hll_one_chunk": t(chunk_words(rows, BSI_FILTER_BITS // rows, SEED))}

    def emit(case, fn, plain_fn, nbytes, logic):
        if not torch.equal(fn(), plain_fn()):
            raise AssertionError(f"{repo}: {case}: the kernel differs from the plain version")
        torch.cuda.empty_cache()  # the plain version's scratch
        host = host_enqueue_times(torch, fn, KERNEL_RUNS)
        print(json.dumps({"case": case, "ms": time_cuda_ms(torch, fn, KERNEL_RUNS),
                          "host_ms": statistics.median(host), "host_ms_max": max(host),
                          "bytes": nbytes, "logic": logic}), flush=True)

    for p, cases in ((HLL_TIMED_P, ("hll_timed", "hll_ones", "hll_one_chunk")),
                     (16, ("hll_p16",))):
        packed = hll_planes(torch, rows, p, BSI_DENSITY, dev, SEED)
        for case in cases:
            filt = filters.get(case, timed)
            nbytes, logic, _ = hll_expand_work(torch, filt, p)
            emit(case, lambda packed=packed, filt=filt, p=p: kernels.hll_expand(packed, filt, p),
                 lambda packed=packed, filt=filt, p=p: kernels.hll_expand_plain(packed, filt, p),
                 nbytes, logic)
        del packed
        torch.cuda.empty_cache()
    for case, q in (("lookup_65536", 65536), ("lookup_300", 300)):
        mat, phi, plo = key_plane(1 << 20, q, SEED)
        plane, ph, pl = t(mat), t(phi), t(plo)
        emit(case, lambda plane=plane, ph=ph, pl=pl: kernels.plane_lookup(plane, ph, pl),
             lambda plane=plane, ph=ph, pl=pl: kernels.plane_lookup_plain(plane, ph, pl),
             plane_lookup_bytes(torch, plane, ph, pl), 0)
    emit("floor", lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
         lambda: torch.zeros(1024, dtype=torch.int32, device=dev), 4096, 0)
    return 0


def sketch_vs(parent: str) -> int:
    """``--sketch-vs DIR``: ``--sketch`` of DIR against this checkout's, in
    ``paired_runs``; then ``pair_summary`` per case (the floor's too),
    against its bound."""
    import torch

    runs = paired_runs("--sketch", parent, "case")
    card = card_line()
    for case in dict.fromkeys(c for c, _ in runs):
        rec = runs[(case, "this")][0]
        pair_summary(runs, case, "case", bound_ms(torch, rec["bytes"], rec["logic"], 0)[0],
                     card)
    return 0


#: ``--reduce``'s cases: the cluster phase's 32-shard Row leg, a full shard
#: (1,048,576 positions in one row), a 300-position leg over 3 shards, and
#: the one-launch floor (torch.zeros of 1024 int32).
REDUCE_TIMED = ("row_leg_32", "full_shard", "leg_300", "floor")
#: row_from_columns' host split at the 32-shard leg: calls a side.
REDUCE_HOST_RUNS = 5


def reduce_leg(name: str) -> np.ndarray:
    """Sorted unique uint64 columns of one REDUCE_TIMED leg."""
    bits = SHARD_WORDS * 32
    if name == "leg_300":
        rng = np.random.default_rng(SEED)
        return np.sort(rng.choice(3 * bits, 300, replace=False)).astype(np.uint64)
    seg, loc, _ = scatter_case(name)
    return seg.astype(np.uint64) * np.uint64(bits) + loc.astype(np.uint64)


def reduce_times(repo: str) -> int:
    """``--reduce REPO``: time the remote Row leg's scatter of the package
    in REPO on REDUCE_TIMED, each leg uploaded as its ``row_from_columns``
    lays it out: ``scatter_bits_grouped`` over one buffer of row starts and
    offsets where the package has it, else ``scatter_bits`` over a segment
    index and an offset a position; each image first held exactly to the
    plain version. One JSON object per case: the kernel's ms by CUDA events
    after the device spin, the host's median and longest enqueue of one
    call, and the case's bytes. Then ``row_from_columns``' host time at the
    32-shard leg over REDUCE_HOST_RUNS calls (mode ``on``): the whole call
    to its synchronize, and its steps as the package takes them (unique:
    ``np.unique``, or ``sorted_unique`` where the package has it; the
    layout: the row starts, or the inverse of the shards; the upload to
    its synchronize; the launch's enqueue; the device's rest), with the
    host's numpy version."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(repo))
    os.environ["PILOSA_TPU_DEVICE_REDUCE"] = "on"
    from pilosa_tpu_torch.exec import device_reduce
    from pilosa_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    grouped = hasattr(kernels, "scatter_bits_grouped")
    unique = getattr(device_reduce, "sorted_unique", np.unique)
    bits = SHARD_WORDS * 32

    def layout(cols):
        """(host arrays to upload, the launch and the plain version on the
        uploaded tensors, the function's bytes)."""
        if grouped:
            shards, buf, head = device_reduce.leg_buffer(cols)
            k = len(shards)
            return ((buf,),
                    lambda up: kernels.scatter_bits_grouped(up[0][:k + 2], up[0][head:]),
                    lambda up: kernels.scatter_bits_grouped_plain(up[0][:k + 2], up[0][head:]),
                    scatter_grouped_bytes(len(cols), k))
        shards, seg = np.unique((cols // np.uint64(bits)).astype(np.int64),
                                return_inverse=True)
        local = (cols % np.uint64(bits)).astype(np.int32)
        k = len(shards)
        return ((seg.astype(np.int32), local),
                lambda up: kernels.scatter_bits(up[0], up[1], k),
                lambda up: kernels.scatter_bits_plain(up[0], up[1], k),
                8 * len(cols) + (k + 1) * SHARD_WORDS * 4)

    def emit(case, fn, nbytes):
        host = host_enqueue_times(torch, fn, KERNEL_RUNS)
        print(json.dumps({"case": case, "ms": time_cuda_ms(torch, fn, KERNEL_RUNS),
                          "host_ms": statistics.median(host), "host_ms_max": max(host),
                          "bytes": nbytes}), flush=True)

    for name in REDUCE_TIMED[:-1]:
        arrays, launch, plain, nbytes = layout(reduce_leg(name))
        up = [torch.from_numpy(a).to(dev) for a in arrays]
        if not torch.equal(launch(up), plain(up)):
            raise AssertionError(f"{repo}: {name}: the image differs from the plain version")
        emit(name, lambda up=up, launch=launch: launch(up), nbytes)
    emit("floor", lambda: torch.zeros(1024, dtype=torch.int32, device=dev), 4096)

    cols = reduce_leg("row_leg_32")
    steps: dict = {}
    for _ in range(REDUCE_HOST_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = unique(cols)
        t1 = time.perf_counter()
        arrays, launch, _, _ = layout(u)
        t2 = time.perf_counter()
        up = [torch.from_numpy(a).to(dev) for a in arrays]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launch(up)
        t4 = time.perf_counter()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        row = device_reduce.row_from_columns(cols, dev)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        for k, v in (("unique", t1 - t0), ("layout", t2 - t1), ("upload", t3 - t2),
                     ("launch", t4 - t3), ("device", t5 - t4), ("total", t6 - t5)):
            steps.setdefault(k, []).append(v * 1e3)
    if sorted(row.segments) != sorted(int(s) for s in np.unique(cols // np.uint64(bits))):
        raise AssertionError(f"{repo}: row_from_columns gave other shards")
    print(json.dumps({"case": "row_from_columns host split", "numpy": np.__version__,
                      "unique": unique.__name__, "layout": "starts" if grouped else "inverse",
                      "uploads": len(arrays), "upload_bytes": sum(a.nbytes for a in arrays),
                      "ms": statistics.median(steps["total"]),
                      "host_ms": statistics.median(steps["total"]),
                      "split_ms": {k: statistics.median(v) for k, v in steps.items()}}),
          flush=True)
    return 0


def reduce_vs(parent: str) -> int:
    """``--reduce-vs DIR``: ``--reduce`` of DIR against this checkout's, in
    ``paired_runs``; then ``pair_summary`` per case against this side's
    bound (DIR's, where it lays a leg out otherwise, beside it), and the
    medians of ``row_from_columns``' host split on both sides."""
    import torch

    runs = paired_runs("--reduce", parent, "case")
    card = card_line()
    split = "row_from_columns host split"
    for case in REDUCE_TIMED:
        recs = {lb: runs[(case, lb)][0] for lb in ("parent", "this")}
        pair_summary(runs, case, "case", bound_ms(torch, recs["this"]["bytes"], 0, 0)[0], card)
        print(json.dumps({"case": case, "bound_ms_parent": bound_ms(
            torch, recs["parent"]["bytes"], 0, 0)[0]}), flush=True)
    pair_summary(runs, split, "case", 0.0, card)
    for lb in ("parent", "this"):
        recs = runs[(split, lb)]
        print(json.dumps({"case": split, "repo": lb, "numpy": recs[0]["numpy"],
                          "unique": recs[0]["unique"], "layout": recs[0]["layout"],
                          "uploads": recs[0]["uploads"], "upload_bytes": recs[0]["upload_bytes"],
                          "split_ms": {k: statistics.median(r["split_ms"][k] for r in recs)
                                       for k in recs[0]["split_ms"]},
                          "card": card}), flush=True)
    return 0


def import_rule_side(min_bits: int) -> int:
    """``--import-rule-side N``: the set-field import with
    ``Field._SCATTER_MIN_BITS_PER_SHARD`` at N (0: the JAX package's rule,
    the native scatter for any batch of 65,536 bits or more of at most 8
    rows) on a fresh holder on the card: the fields phase's time import
    (the same seeded FIELDS_TIME_BITS bits over FIELDS_TIME_HOURS, YMDH), then three
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
    t_cols = rng.integers(0, FIELDS_TIME_SHARDS * SHARD_WIDTH, FIELDS_TIME_BITS,
                          dtype=np.uint64)
    t_rows = rng.integers(0, FIELDS_TIME_ROWS, FIELDS_TIME_BITS).astype(np.uint64)
    t_hours = FIELDS_TIME_FIRST_HOUR + rng.integers(0, FIELDS_TIME_HOURS, FIELDS_TIME_BITS)
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


#: the packed kernels' cases: name -> (Ka, Kb), the widths of the a and b
#: index stacks. Held to the plain versions on the card here at 1024 rows
#: and a 32768-word plane, and to the JAX package's residency functions on
#: the CPU by tests/test_torch_residency.py at a few rows.
PACKED_CASES = {"k1024": (1024, 2048), "k2048": (2048, 1024), "k8": (8, 8),
                "k16384": (16384, 16384), "ka8_kb4096": (8, 4096),
                "ka16384_kb8": (16384, 8)}
#: the planner's widest packed stack under auto (W / AUTO_RATIO entries).
PACKED_AUTO_K = 4096
#: the stacks ``--packed`` times both kernels on besides: the shortest rows
#: (K = 8) and the planner's widest under auto (PACKED_AUTO_K), from these
#: PACKED_CASES cases (case, side: 0 a, 1 b).
PACKED_VS_WIDTHS = {8: ("k8", 0), PACKED_AUTO_K: ("ka8_kb4096", 1)}
#: inputs the planner never makes, held all the same, since the packed
#: kernels agree with the JAX functions on any input: name -> (Ka, Kb,
#: plane words). a's rows unsorted, with duplicates, negative entries, the
#: int32 extremes, entries at and past the sentinel, and entries past the
#: last word of a narrower plane (6243 words: the clip); b's rows sorted
#: with duplicates. Checked with b whole (the bulk copy) and from its
#: second entry on (unaligned, Kb - 1 not a multiple of 4: the staging
#: loop), at b's widest (32768, all the shared memory the kernel takes),
#: K = 8 and K = 16384. Kept apart from PACKED_CASES, whose rows are the
#: planner's: sorted, distinct, sentinel-padded.
PACKED_ANY_CASES = {"any_k8": (8, 8, 6243), "any_k1024_kb4096": (1024, 4096, 6243),
                    "any_k16384_kb32768": (16384, 32768, SHARD_WORDS)}


def sorted_sample(rng, n: int, limit: int, avoid=None) -> np.ndarray:
    """``n`` distinct integers of [0, limit) (fewer where ``limit`` or
    ``avoid`` leaves fewer), sorted, none of them in ``avoid`` (sorted)."""
    pool = distinct(rng.integers(0, limit, n + n // 4 + 16))
    if avoid is not None and len(avoid):
        pool = np.setdiff1d(pool, avoid, assume_unique=True)
    if len(pool) > n:
        pool = np.sort(rng.choice(pool, n, replace=False))
    return pool


def packed_case(name: str, rows: int, seed: int = SEED, words: int = SHARD_WORDS):
    """(a ``[rows, Ka]`` int32, b ``[rows, Kb]`` int32, plane ``[rows,
    words]`` uint32) of one packed case: each row of a and b holds sorted,
    distinct in-shard positions, SENTINEL-padded (``32 * words``), a random
    count of them up to the row's width, b holding about half of a's. Every
    case has the edge rows: row 0 all sentinels in a and b, row 1 full to
    the width (no sentinel) in both, row 2 only positions with ``i & 31 ==
    31``, row 3 a plane of all-ones words, row 4 b equal to a where the
    widths allow; and the plane's other words are ``seeded_words``."""
    ka, kb = PACKED_CASES[name]
    rng = np.random.default_rng(seed)
    limit = words * 32
    a = np.full((rows, ka), limit, dtype=np.int32)
    b = np.full((rows, kb), limit, dtype=np.int32)
    for r in range(rows):
        if r == 0:
            continue
        if r == 2:
            top = np.arange(31, limit, 32)
            pa = np.sort(rng.choice(top, min(ka, len(top)), replace=False))
            pb = np.sort(rng.choice(top, min(kb, len(top)), replace=False))
        else:
            na = ka if r == 1 else int(rng.integers(0, ka + 1))
            pa = sorted_sample(rng, na, limit)
            if r == 4:
                pb = pa[:kb]
            else:
                nb = kb if r == 1 else int(rng.integers(0, kb + 1))
                shared = pa[rng.random(len(pa)) < 0.5][:nb]
                pb = np.union1d(shared, sorted_sample(rng, nb - len(shared), limit, shared))
        a[r, :len(pa)] = pa
        b[r, :len(pb)] = pb
    plane = seeded_words(rng, (rows, words))
    if rows > 3:
        plane[3] = 0xFFFFFFFF
    return a, b, plane


def packed_any_case(name: str, rows: int, seed: int = SEED):
    """(a ``[rows, Ka]`` int32, b ``[rows, Kb]`` int32, plane ``[rows,
    words]`` uint32) of one PACKED_ANY_CASES case. a: uniform positions in
    the shard, with about an eighth each of negative int32 values, of
    positions past the plane's last word (where the plane is narrower than
    a shard), of sentinels and of values above the sentinel; INT32_MIN, a
    sentinel, the shard's last position and INT32_MAX at fixed places;
    every row unsorted. b: half its entries drawn from its row of a (with
    repeats; the shard's last position twice), the rest a's kind of
    values, a run of sentinels, then each row sorted: duplicates and all."""
    ka, kb, words = PACKED_ANY_CASES[name]
    rng = np.random.default_rng([seed, ka, kb, words])
    sent = SHARD_WORDS * 32
    i32 = np.iinfo(np.int32)

    def values(shape):
        v = rng.integers(0, sent, shape, dtype=np.int64)
        kind = rng.integers(0, 8, shape)
        v = np.where(kind == 0, rng.integers(i32.min, 0, shape), v)
        v = np.where(kind == 1, rng.integers(min(32 * words, sent - 1), sent, shape), v)
        v = np.where(kind == 2, sent, v)
        v = np.where(kind == 3, rng.integers(sent + 1, i32.max, shape, endpoint=True), v)
        return v.astype(np.int32)

    a = values((rows, ka))
    a[:, 0] = i32.min
    a[:, 1] = sent
    a[:, ka // 2] = sent - 1
    a[:, -1] = i32.max
    b = values((rows, kb))
    half = kb // 2
    b[:, :half] = np.take_along_axis(a, rng.integers(0, ka, (rows, half)), axis=1)
    b[:, 0] = b[:, half - 1] = sent - 1
    b[:, half:half + kb // 8] = sent
    b.sort(axis=1)
    plane = seeded_words(rng, (rows, words))
    return a, b, plane


#: the wave sizes the packed wave kernels are held to their plain versions
#: at: one slot, two, the timed 8, and one past a launch's slot table
#: (kernels.PACKED_WAVE_SLOTS, 32), so the wave splits into two launches.
PACKED_WAVE_CHECKS = (1, 2, 8, 33)


def wave_views(torch, x, n: int, sliced: bool) -> list:
    """``n`` slots of ``x``'s shape cut from ``x`` and its first n - 1 rows
    (cycled) again below it: slot z starts at row z. Whole rows: every third slot a
    view of that stack, the next a view of a copy 4 entries wider (another
    row stride, still 16-byte aligned), the next slot z - 2's tensor again
    (a shared slot). ``sliced``: every slot from its second entry on (an
    unaligned start: the 4-byte loads, b's staging loop)."""
    rows, k = x.shape
    tall = torch.cat([x, x[torch.arange(n - 1, device=x.device) % rows]])
    if sliced:
        return [tall[z:z + rows, 1:] for z in range(n)]
    wide = torch.full((tall.shape[0], k + 4), -1, dtype=x.dtype, device=x.device)
    wide[:, :k] = tall
    slots = []
    for z in range(n):
        if z % 3 == 2:
            slots.append(slots[z - 2])
        else:
            slots.append((tall if z % 3 == 0 else wide[:, :k])[z:z + rows])
    return slots


def check_packed_waves(torch, kernels, a, b, pl, what, sorted_b_a: bool, check) -> None:
    """The three packed wave kernels against their plain versions, exact,
    at every PACKED_WAVE_CHECKS size, on slots cut by ``wave_views`` from
    one case's (a, b, plane): count of a's and b's slots, and_count of them
    against planes (a shared plane in even slots, the plane's own views in
    odd ones), pair_count of a against b (and b against a where a is
    sorted too), whole and sliced."""
    for n in PACKED_WAVE_CHECKS:
        pv = wave_views(torch, pl, n, False)
        planes = [pl if z % 2 == 0 else pv[z] for z in range(n)]
        for sliced in (False, True):
            xa, xb = wave_views(torch, a, n, sliced), wave_views(torch, b, n, sliced)
            tag = f"{what}, B = {n}{', sliced' if sliced else ''}"
            for xs, side in ((xa, "a"), (xb, "b")):
                check("packed_count_batched", kernels.packed_count_batched(xs),
                      kernels.packed_count_batched_plain(xs), f"{tag}, {side}")
                check("packed_and_dense_count_batched",
                      kernels.packed_and_dense_count_batched(xs, planes),
                      kernels.packed_and_dense_count_batched_plain(xs, planes),
                      f"{tag}, {side}")
            for xs, ys, side in ((xa, xb, "a, b"), (xb, xa, "b, a"))[:2 if sorted_b_a else 1]:
                check("packed_pair_count_batched", kernels.packed_pair_count_batched(xs, ys),
                      kernels.packed_pair_count_batched_plain(xs, ys), f"{tag}, {side}")


def check_packed_cases(torch, kernels, t, dev, errs) -> dict:
    """The four packed kernels against their plain versions, exact, on
    every PACKED_CASES case at 1024 rows and a [1024, 32768] plane: count
    of a and of b, and_count of a and of b against the plane, pair_count
    both ways round, expand of a and of b; then a's rows from its second
    entry on (an unaligned row start: the scalar paths) and expand into a
    6243-word row (a width not a multiple of 4). Then and_count and
    pair_count on every PACKED_ANY_CASES case at 1024 rows: and_count of
    a, a from its second entry on and b against the case's plane;
    pair_count of (a, b), (a, b from its second entry on: the staging
    loop), (a from its second entry on, b) and (b, b). The three wave
    kernels on every case of both (``check_packed_waves``). Returns the
    PACKED_CASES cases' (a, b, plane) tensors by name."""
    def check(name, got, want, what):
        torch.cuda.synchronize()
        if name == "packed_expand":  # bit patterns: count the differing bits
            err = int(kernels.row_counts_plain(got ^ want).long().sum())
        else:
            err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errs[name] = max(errs[name], err)
        if got.shape != want.shape or got.dtype != torch.int32 or err:
            raise AssertionError(f"{name} {what}: {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}, max |err| {err}")

    out = {}
    for case in PACKED_CASES:
        a_np, b_np, pl_np = packed_case(case, 1024)
        a, b = (torch.from_numpy(x).to(dev) for x in (a_np, b_np))
        pl = t(pl_np)
        what = f"{case}: a {tuple(a.shape)}, b {tuple(b.shape)}"
        for x, side in ((a, "a"), (b, "b"), (a[:, 1:], "a[:, 1:]")):
            check("packed_count", kernels.packed_count(x), kernels.packed_count_plain(x),
                  f"{what}, {side}")
            check("packed_and_dense_count", kernels.packed_and_dense_count(x, pl),
                  kernels.packed_and_dense_count_plain(x, pl), f"{what}, {side}")
            check("packed_expand", kernels.packed_expand(x), kernels.packed_expand_plain(x),
                  f"{what}, {side}")
        for x, y, side in ((a, b, "a, b"), (b, a, "b, a"), (a[:, 1:], b, "a[:, 1:], b")):
            check("packed_pair_count", kernels.packed_pair_count(x, y),
                  kernels.packed_pair_count_plain(x, y), f"{what}, {side}")
        check("packed_expand", kernels.packed_expand(a, 6243),
              kernels.packed_expand_plain(a, 6243), f"{what}, 6243 words")
        check_packed_waves(torch, kernels, a, b, pl, what, True, check)
        out[case] = (a, b, pl)
    for case in PACKED_ANY_CASES:
        a_np, b_np, pl_np = packed_any_case(case, 1024)
        a, b = (torch.from_numpy(x).to(dev) for x in (a_np, b_np))
        pl = t(pl_np)
        what = f"{case}: a {tuple(a.shape)}, b {tuple(b.shape)}, plane {tuple(pl.shape)}"
        for x, side in ((a, "a"), (a[:, 1:], "a[:, 1:]"), (b, "b")):
            check("packed_and_dense_count", kernels.packed_and_dense_count(x, pl),
                  kernels.packed_and_dense_count_plain(x, pl), f"{what}, {side}")
        for x, y, side in ((a, b, "a, b"), (a, b[:, 1:], "a, b[:, 1:]"),
                           (a[:, 1:], b, "a[:, 1:], b"), (b, b, "b, b")):
            check("packed_pair_count", kernels.packed_pair_count(x, y),
                  kernels.packed_pair_count_plain(x, y), f"{what}, {side}")
        check_packed_waves(torch, kernels, a, b, pl, what, False, check)
        del a, b, pl
    log(f"packed kernels: exact on {', '.join(PACKED_CASES)} and, for and_count and "
        f"pair_count, on {', '.join(PACKED_ANY_CASES)} at 1024 rows; the wave kernels on "
        f"both at B = {', '.join(map(str, PACKED_WAVE_CHECKS))}")
    return out


def packed_timed_cases(kernels, packed) -> list:
    """The packed kernels' timed cases at the packed path's shapes (row 30
    of ``bench`` is [1024, 1024], row 31 [1024, 2048], row 1 a [1024,
    32768] plane): (name, shape, kernel, plain, bytes, logic ops,
    popcounts). Each input is read once and each output written once;
    and_count's bytes are the entries, each distinct 32-byte sector of
    the plane it gathers once (``gathered_sectors``), and its counts. The operations: a compare
    and an add an entry (count), and a shift and an and besides
    (and_count), a probe of b a level of its binary search and three more
    an entry (pair_count)."""
    a, _, pl = packed["k1024"]
    a2 = packed["k2048"][0]
    rows, k = a.shape
    k2 = a2.shape[1]
    return [
        ("packed_count", f"[{rows}, {k}]",
         lambda: kernels.packed_count(a), lambda: kernels.packed_count_plain(a),
         a.numel() * 4 + rows * 4, 2 * a.numel(), 0),
        ("packed_count", f"[{rows}, {k2}]",
         lambda: kernels.packed_count(a2), lambda: kernels.packed_count_plain(a2),
         a2.numel() * 4 + rows * 4, 2 * a2.numel(), 0),
        and_count_timed(kernels, a, pl),
        pair_count_timed(kernels, a, a2),
        ("packed_expand", f"[{rows}, {k}] -> [{rows}, {pl.shape[1]}]",
         lambda: kernels.packed_expand(a), lambda: kernels.packed_expand_plain(a),
         a.numel() * 4 + pl.numel() * 4, 3 * a.numel(), 0),
    ]


#: the wave sizes the packed wave kernels are timed at.
PACKED_WAVE_TIMED = (8, 32)


def packed_wave_slots(torch, packed, n: int) -> tuple[list, list]:
    """``n`` slots of the timed packed shapes, each in memory of its own:
    slot z of a is row 30's [1024, 1024] case stack with its rows permuted
    by a seeded permutation, slot z of b the [1024, 2048] stack permuted
    by another; both seeded by n and z."""
    a, a2 = packed["k1024"][0], packed["k2048"][0]
    gen = torch.Generator(device=a.device).manual_seed(SEED + n)
    rows = a.shape[0]
    perms = [torch.randperm(rows, generator=gen, device=a.device) for _ in range(2 * n)]
    return [a[p] for p in perms[:n]], [a2[p] for p in perms[n:]]


def packed_wave_cases(torch, kernels, packed, n: int) -> list:
    """The three packed wave kernels' timed cases at ``n`` slots
    (``packed_wave_slots``; and_count against row 1's plane shared by
    every slot, as a wave of ``Intersect(Row(f=k), Row(f=1))`` pushes it):
    (name, shape, kernel, plain, bytes, logic ops, popcounts, library), the
    bytes and operations the single cases' summed over the slots, and_count's
    plane sectors counted once for the whole wave (``gathered_sectors``). In a package with no wave kernels the kernel column launches
    the slots one by one through the single wrappers."""
    sa, sb = packed_wave_slots(torch, packed, n)
    pl = packed["k1024"][2]
    planes = [pl] * n
    rows, k = sa[0].shape
    kb = sb[0].shape[1]
    sent = kernels.PACK_SENTINEL
    distinct = gathered_sectors(torch, kernels, torch.stack(sa), pl)

    def wave(name, *operands):
        batched = getattr(kernels, f"{name}_batched", None)
        if batched is None:
            single_fn = getattr(kernels, name)
            return lambda: [single_fn(*xs) for xs in zip(*operands)]
        return lambda: batched(*operands)

    def plain(name, *operands):  # the package's batched plain, or the same stacking
        single_plain = getattr(kernels, f"{name}_plain")
        return getattr(kernels, f"{name}_batched_plain", lambda *ops: torch.stack(
            [single_plain(*xs) for xs in zip(*ops)]))(*operands)

    def library(name, *operands):  # the library calls over the stacked slots
        return lambda: packed_library_call(torch, kernels, name, *(
            torch.stack(x) if isinstance(x, list) else x for x in operands))()

    return [
        ("packed_count_batched", f"{n} x [{rows}, {k}]", wave("packed_count", sa),
         lambda: plain("packed_count", sa),
         n * (rows * k * 4 + rows * 4), 2 * n * rows * k, 0, library("packed_count", sa)),
        ("packed_and_dense_count_batched",
         f"{n} x [{rows}, {k}] x one [{rows}, {pl.shape[1]}], {distinct} distinct sectors",
         wave("packed_and_dense_count", sa, planes),
         lambda: plain("packed_and_dense_count", sa, planes),
         n * (rows * k * 4 + rows * 4) + 32 * distinct, 4 * n * rows * k, 0,
         library("packed_and_dense_count", sa, pl)),
        ("packed_pair_count_batched", f"{n} x [{rows}, {k}] x [{rows}, {kb}]",
         wave("packed_pair_count", sa, sb),
         lambda: plain("packed_pair_count", sa, sb),
         n * (rows * k + rows * kb + rows) * 4, ((kb - 1).bit_length() + 3) * n * rows * k, 0,
         library("packed_pair_count", sa, sb)),
    ]


def and_count_timed(kernels, a, pl) -> tuple:
    """``packed_and_dense_count``'s timed case on (a, pl), as in
    ``packed_timed_cases``: its bytes count each distinct 32-byte sector
    of the plane this data gathers once (``gathered_sectors``)."""
    import torch
    rows, k = a.shape
    distinct = gathered_sectors(torch, kernels, a, pl)
    return ("packed_and_dense_count",
            f"[{rows}, {k}] x [{rows}, {pl.shape[1]}], {distinct} distinct sectors",
            lambda: kernels.packed_and_dense_count(a, pl),
            lambda: kernels.packed_and_dense_count_plain(a, pl),
            a.numel() * 4 + 32 * distinct + rows * 4, 4 * a.numel(), 0)


def pair_count_timed(kernels, a, b) -> tuple:
    """``packed_pair_count``'s timed case on (a, b), as in
    ``packed_timed_cases``."""
    rows, k = a.shape
    kb = b.shape[1]
    return ("packed_pair_count", f"[{rows}, {k}] x [{rows}, {kb}]",
            lambda: kernels.packed_pair_count(a, b),
            lambda: kernels.packed_pair_count_plain(a, b),
            (a.numel() + b.numel() + rows) * 4, ((kb - 1).bit_length() + 3) * a.numel(), 0)


def gathered_sectors(torch, kernels, entries, pl) -> int:
    """The distinct 32-byte sectors (8 words, 256 bits) of the plane
    ``pl`` that ``packed_and_dense_count`` gathers for ``entries``, an
    ``[S, K]`` stack or a wave of them ``[B, S, K]`` against that one
    plane: entry i of row r reads word clamp(i >> 5, 0, W - 1) of plane
    row r, and the sentinels read nothing. At most the plane's own
    sectors."""
    words = pl.shape[1]
    per_row = -(-words // 8)
    rows = torch.arange(entries.shape[-2], device=entries.device).unsqueeze(1)
    keys = rows * per_row + ((entries >> 5).clamp(0, words - 1) >> 3)
    return int(keys[entries < kernels.PACK_SENTINEL].unique().numel())


def torch_rows(x):
    """``[S, K]`` row indices of ``x``'s entries, on its device."""
    import torch
    return torch.arange(x.shape[0], device=x.device).unsqueeze(1).expand_as(x)


def packed_library_call(torch, kernels, name: str, a, b=None):
    """The function of the packed kernel ``name`` on (a, b) from PyTorch
    calls, a's leading dims any (a wave's slots stacked): count, a compare
    and a sum; and_count (b the plane, broadcast), ``gather``, a shift and
    a sum; pair_count, ``searchsorted``, ``gather``, a compare and a sum;
    expand (b the words), ``index_put_(accumulate=True)`` of each entry's
    bit into a zeroed [S, W + 1] plane, the trash word the sentinels land
    in cut off."""
    sent = kernels.PACK_SENTINEL

    def count():
        return (a < sent).sum(-1, dtype=torch.int32)

    def and_count():
        words = b.shape[-1]
        w = torch.gather(b.expand(*a.shape[:-1], words), -1,
                         (a >> 5).clamp(0, words - 1).long())
        return (((w >> (a & 31)) & 1) * (a < sent)).sum(-1, dtype=torch.int32)

    def pair_count():
        pos = torch.searchsorted(b, a).clamp(0, b.shape[-1] - 1)
        return ((torch.gather(b, -1, pos) == a) & (a < sent)).sum(-1, dtype=torch.int32)

    def expand():
        out = torch.zeros((a.shape[0], b + 1), dtype=torch.int32, device=a.device)
        out.index_put_((torch_rows(a), (a >> 5).long()), torch.bitwise_left_shift(
            torch.ones_like(a), a & 31), accumulate=True)
        return out[:, :b]

    return {"packed_count": count, "packed_and_dense_count": and_count,
            "packed_pair_count": pair_count, "packed_expand": expand}[name]


def packed_library(torch, kernels, packed) -> dict:
    """``packed_library_call`` beside each packed kernel on its first timed
    shape (name -> {shape: fn}), each checked equal to its kernel first."""
    a, _, pl = packed["k1024"]
    operands = {"packed_count": (a,), "packed_and_dense_count": (a, pl),
                "packed_pair_count": (a, packed["k2048"][0]),
                "packed_expand": (a, pl.shape[1])}
    out = {}
    for name, shape, kern, *_ in packed_timed_cases(kernels, packed):
        if name not in out:
            fn = packed_library_call(torch, kernels, name, *operands[name])
            out[name] = {shape: fn}
            if not torch.equal(fn(), kern()):
                raise AssertionError(f"{name}: the library calls compute another function")
    return out


def packed_width_cases(torch, kernels, stacks) -> list:
    """and_count and pair_count at each PACKED_VS_WIDTHS width K, as
    ``--packed`` times them: and_count of a [1024, K] stack against its
    case's plane, pair_count of it against a [1024, K] stack of the next
    seed (``stacks(case, seed)`` makes a case's tensors). (timed case,
    library call) pairs."""
    out = []
    for case, side in PACKED_VS_WIDTHS.values():
        first, other = stacks(case), stacks(case, SEED + 1)
        for timed, ops in ((and_count_timed(kernels, first[side], first[2]),
                            (first[side], first[2])),
                           (pair_count_timed(kernels, first[side], other[side]),
                            (first[side], other[side]))):
            out.append((timed, packed_library_call(torch, kernels, timed[0], *ops)))
    return out


def check_group_lattices(torch, kernels, t, rng, gb_planes, gb_filt, errs) -> None:
    """group_count against group_count_plain, exact, given the level sizes:
    bench config 5's lattice (``gb_planes[:12]``, levels of 4 and 8 rows,
    and ``gb_filt``: the planner's 954 real rows of 1024-row stacks, one
    long row to the kernel), (4, 8, 3) with no filter, rows that are not
    contiguous (a [16, 4096] window of [16, 8192] planes: tiles per row),
    a middle level of one row, unaligned views, a ragged width and a wide
    lattice over them (plain loads), 450 planes of one level, 8192 groups
    as (64, 128) and (32, 256) (many units), 4 and 5 levels, and 16 levels
    (13 of 2 rows, 3 of 1: 8192 groups, the planner's cap). ``t`` makes a
    card tensor from uint32 words; the largest error goes to
    ``errs["group_count"]``."""
    def check(planes, sizes, filt, what):
        got = kernels.group_count(planes, sizes, filt)
        want = kernels.group_count_plain(planes, sizes, filt)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        errs["group_count"] = max(errs["group_count"], err)
        if got.shape != want.shape or got.dtype != torch.int64 or err:
            raise AssertionError(f"group_count {what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)}, max |err| {err}")

    check(gb_planes[:12], (4, 8), gb_filt, "(4, 8) + filter, 954 x 32768")
    check(gb_planes, (4, 8, 3), None, "(4, 8, 3), 954 x 32768")
    strided = t(seeded_words(rng, (13, 16, 8192)))[:, :, :4096]
    check(list(strided[:12]), (4, 8), strided[12], "(4, 8) + filter, strided rows [16, 4096]")
    mid = [t(seeded_words(rng, (16, 32768))) for _ in range(13)]
    check(mid[:12], (5, 1, 6), mid[12], "(5, 1, 6) + filter: a middle level of one row")
    offs = [t(seeded_words(rng, (5, 4101)))[:, 1:] for _ in range(7)]
    check(offs[:6], (3, 3), offs[6], "(3, 3) + filter, unaligned [5, 4100]")
    rag_p = [t(seeded_words(rng, (7, 6243))) for _ in range(7)]
    check(rag_p, (2, 5), rag_p[0], "(2, 5) + filter, [7, 6243]")
    rag_w = t(seeded_words(rng, (71, 3, 301)))
    check(list(rag_w[:70]), (40, 30), rag_w[70], "(40, 30) + filter, ragged [3, 301]")
    many = t(seeded_words(rng, (450, 3, 300)))
    check(list(many), (450,), None, "450 planes of [3, 300]")
    wide = t(seeded_words(rng, (192, 4, 1000)))
    check(list(wide), (64, 128), wide[0], "(64, 128) + filter: 8192 groups")
    wide2 = t(seeded_words(rng, (289, 3, 300)))
    check(list(wide2[:288]), (32, 256), wide2[288],
          "(32, 256) + filter: 8192 groups over 288 planes")
    deep = [t(seeded_words(rng, (6, 2000))) for _ in range(30)]
    check(deep[:10], (2, 2, 2, 2, 2), deep[10], "5 levels + filter")
    check(deep[:8], (2, 2, 2, 2), None, "4 levels")
    sizes16 = (2, 2, 1, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 1, 2, 2)
    check(deep[:29], sizes16, deep[29], "16 levels + filter: 8192 groups")


# -- phase 2: each kernel against its plain version --------------------------


#: plane_scatter's checks: (positions, values, depth) makers. bench
#: config 3's shard is BSI_DENSITY of a shard's columns with values in
#: [BSI_MIN, BSI_MAX); the first of them is the timed case. The later ones
#: hold the cluster design's edges: words at every CTA slab boundary
#: (SHARD_WORDS // 16 words a slab), the fewest and the most planes, depths
#: where the plane groups step on a card that runs 7 or 8 clusters at once
#: (a plane a group up to 8 planes, then 2, then 3), one full word, a dense
#: run at an unaligned start across a slab boundary, a shuffled full
#: shard, and out-of-range positions mixed into a real batch (dropped).
PLANE_SCATTER_GROUP_EDGES = ("depth5", "depth6", "depth7", "depth12", "depth13",
                             "depth14", "depth15")
PLANE_SCATTER_CASES = ("bench_shard", "bench_shard_shuffled", "full_shard", "depth40",
                       "bit31", "negative", "empty", "single", "slab_edges", "depth0",
                       "depth63", *PLANE_SCATTER_GROUP_EDGES, "one_word", "run_unaligned",
                       "full_shard_shuffled", "out_of_range")
#: the cases ``--plane-scatter-vs`` times.
PLANE_SCATTER_TIMED = ("bench_shard", "full_shard", "depth40")


def plane_scatter_case(name: str, seed: int = SEED):
    """(int32 distinct in-shard positions, int64 values, depth) of one
    plane_scatter check, sorted unless the case says otherwise."""
    rng = np.random.default_rng(seed)
    n_cols = SHARD_WORDS * 32
    slab = SHARD_WORDS // 16
    if name.startswith("bench_shard"):
        pos = sorted_sample(rng, int(n_cols * BSI_DENSITY), n_cols)
        vals = rng.integers(BSI_MIN, BSI_MAX, len(pos), dtype=np.int64)
        if name.endswith("shuffled"):
            order = rng.permutation(len(pos))
            pos, vals = pos[order], vals[order]
        return pos.astype(np.int32), vals, 17
    if name.startswith("full_shard"):
        pos = np.arange(n_cols, dtype=np.int32)
        vals = rng.integers(BSI_MIN, BSI_MAX, n_cols, dtype=np.int64)
        if name.endswith("shuffled"):
            order = rng.permutation(n_cols)
            pos, vals = pos[order], vals[order]
        return pos, vals, 17
    if name == "depth40":
        pos = sorted_sample(rng, 50_000, n_cols)
        vals = rng.integers(-(2**40 - 1), 2**40, len(pos), dtype=np.int64)
        vals[::3] = rng.integers(2**32, 2**40, len(vals[::3]), dtype=np.int64)
        return pos.astype(np.int32), vals, 40
    if name == "bit31":
        pos = np.arange(31, n_cols, 32, dtype=np.int32)
        return pos, rng.integers(BSI_MIN, BSI_MAX, len(pos), dtype=np.int64), 17
    if name == "negative":
        pos = sorted_sample(rng, 20_000, n_cols)
        return pos.astype(np.int32), rng.integers(BSI_MIN, 0, len(pos), dtype=np.int64), 17
    if name == "empty":
        return np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int64), 17
    if name == "single":
        return np.array([n_cols - 1], dtype=np.int32), np.array([-77], dtype=np.int64), 17
    if name == "slab_edges":
        # the last and first word of every slab, bits 0 and 31 of each
        words = np.unique(np.concatenate([np.arange(0, SHARD_WORDS + 1, slab) + d
                                          for d in (-1, 0)]).clip(0, SHARD_WORDS - 1))
        pos = np.sort(np.concatenate([words * 32, words * 32 + 31])).astype(np.int32)
        return pos, rng.integers(BSI_MIN, BSI_MAX, len(pos), dtype=np.int64), 17
    if name == "depth0":
        pos = sorted_sample(rng, int(n_cols * BSI_DENSITY), n_cols)
        return pos.astype(np.int32), rng.integers(BSI_MIN, BSI_MAX, len(pos),
                                                  dtype=np.int64), 0
    if name == "depth63":
        pos = sorted_sample(rng, 20_000, n_cols)
        info = np.iinfo(np.int64)
        vals = rng.integers(info.min, info.max, len(pos), dtype=np.int64, endpoint=True)
        vals[:6] = (info.min, info.max, 0, -1, 2**62, -(2**62) - 1)
        return pos.astype(np.int32), vals, 63
    if name in PLANE_SCATTER_GROUP_EDGES:
        depth = int(name[len("depth"):])
        pos = sorted_sample(rng, 5_000, n_cols)
        lim = 2**depth
        return pos.astype(np.int32), rng.integers(-lim, lim, len(pos), dtype=np.int64), depth
    if name == "one_word":
        pos = np.arange(32 * (slab + 5), 32 * (slab + 6), dtype=np.int32)
        return pos, rng.integers(BSI_MIN, BSI_MAX, 32, dtype=np.int64), 17
    if name == "run_unaligned":
        # 70,001 consecutive positions from an odd start, across the first
        # slab boundary
        start = 32 * slab - 50_001
        pos = np.arange(start, start + 70_001, dtype=np.int32)
        return pos, rng.integers(-(2**20), 2**20, len(pos), dtype=np.int64), 20
    if name == "out_of_range":
        pos = sorted_sample(rng, int(n_cols * BSI_DENSITY), n_cols).astype(np.int64)
        bad = np.array([-1, -2, -31, -32, -33, -(2**31), n_cols, n_cols + 1, n_cols + 31,
                        n_cols + 32, 2 * n_cols, 2**31 - 1], dtype=np.int64)
        pos = np.insert(pos, rng.integers(0, len(pos) + 1, len(bad)), bad)
        return pos.astype(np.int32), rng.integers(BSI_MIN, BSI_MAX, len(pos),
                                                  dtype=np.int64), 17
    raise KeyError(name)


def shift_left_library(torch, a, n: int):
    """shift_left's function from torch calls on the int32 words: the
    whole-word shift by a zero pad, then the in-word shift ORed with the
    carry of the word below (the arithmetic right shift masked to the
    carried bits). Returns the call."""
    words, bits = divmod(n, 32)
    w = a.shape[-1]
    pad = torch.nn.functional.pad

    def call():
        v = pad(a[..., :w - words], (words, 0))
        if not bits:
            return v
        carry = (v >> (32 - bits)) & ((1 << bits) - 1)
        return (v << bits) | pad(carry[..., :-1], (1, 0))

    return call


def bsi_compare_library(torch, bits, filt, lo: int, hi: int, depth: int, op: str,
                        allow_eq: bool):
    """bsi_compare's function from torch calls on the int32 planes: the
    descent from bit depth - 1 with each plane's predicate bit known on the
    host, so a plane costs an AND-NOT into lt or an AND into gt and one
    into eq, in place; the selected masks AND the filter. Returns the
    call."""
    pred = ((hi & 0xFFFFFFFF) << 32) | (lo & 0xFFFFFFFF)

    def call():
        lt, gt = torch.zeros_like(filt), torch.zeros_like(filt)
        eq = torch.full_like(filt, -1)
        for i in range(depth - 1, -1, -1):
            row = bits[i]
            if (pred >> i) & 1:
                lt |= eq & ~row
                eq &= row
            else:
                gt |= eq & row
                eq &= ~row
        out = eq if op == "eq" else (lt if op == "lt" else gt)
        if allow_eq and op != "eq":
            out = out | eq
        return out & filt

    return call


def plane_scatter_library(torch, pos, vals, depth: int):
    """plane_scatter's function as one PyTorch call: index_put_ with
    accumulate of each (plane, word) entry's bit into a zeroed flat
    ``[(depth + 2) * W]`` int32 image (distinct bits of a word add without
    carries, wrapping at bit 31 as the pattern does). The (flat index, bit)
    pairs are laid out ahead of the timed call; returns the call."""
    w = SHARD_WORDS
    p = pos.long()
    mag = vals.abs()
    member = torch.cat([torch.ones((1, len(p)), dtype=torch.bool, device=p.device),
                        (vals < 0).unsqueeze(0),
                        ((mag.unsqueeze(0) >> torch.arange(depth, device=p.device)
                          .unsqueeze(1)) & 1) == 1])
    idx = (torch.arange(depth + 2, device=p.device).unsqueeze(1) * w
           + (p >> 5).unsqueeze(0))[member]
    bits = (1 << (p & 31)).unsqueeze(0).expand_as(member)[member]
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)

    def call():
        return torch.zeros((depth + 2) * w, dtype=torch.int32, device=p.device).index_put_(
            (idx,), bits, accumulate=True).view(depth + 2, w)

    return call


def check_plane_scatter(torch, kernels, dev, errs) -> tuple:
    """plane_scatter against its plain version, exact, on every
    PLANE_SCATTER_CASES case; returns the timed case's (pos, vals, depth)
    on the card."""
    timed = None
    for name in PLANE_SCATTER_CASES:
        pos_np, vals_np, depth = plane_scatter_case(name)
        pos, vals = torch.from_numpy(pos_np).to(dev), torch.from_numpy(vals_np).to(dev)
        got = kernels.plane_scatter(pos, vals, depth)
        want = kernels.plane_scatter_plain(pos, vals, depth)
        torch.cuda.synchronize()
        err = int(kernels.row_counts_plain(got ^ want).long().sum())
        errs["plane_scatter"] = max(errs["plane_scatter"], err)
        if got.shape != want.shape or got.dtype != torch.int32 or err:
            raise AssertionError(f"plane_scatter {name} ({len(pos_np)} entries, depth "
                                 f"{depth}): {err} bits differ")
        if timed is None:
            timed = (pos, vals, depth)
    log(f"plane_scatter: exact on {', '.join(PLANE_SCATTER_CASES)}")
    log("plane_scatter: clusters x planes a cluster by depth: " + ", ".join(
        f"{d}: {g} x {per}" for d in (0, 5, 6, 7, 12, 13, 14, 15, 17, 40, 63)
        for g, per in [kernels.plane_scatter_groups(d, dev)]))
    return timed


#: hll_expand's checks (p, shards, share of the columns present, filter:
#: ``hll_filter``'s kind): the shared-memory branch (p <= 14) and the
#: in-place byte branch above it, at the precisions Count(Distinct) takes
#: (4 to 18); sparse filters (a short gather list a chunk), filters with
#: all-ones, sign-bit-only and zero words, an empty and an all-ones filter
#: (every chunk read whole), all bits in one chunk (its list near the cap,
#: and past it), every other shard's plane empty, and a plane of 3,104 words
#: a shard (a whole chunk and a short one).
HLL_CHECKS = ((4, 64, 0.02, "seeded"), (12, 64, 0.02, "sparse"), (14, 16, 0.5, "seeded"),
              (16, 64, 0.02, "sparse"), (18, 17, 0.3, "seeded"), (15, 16, 0.02, "sparse"),
              (12, 8, 0.3, "zero"), (12, 8, 0.3, "ones"), (18, 4, 0.3, "ones"),
              (12, 8, 0.3, "chunk_list"), (14, 8, 0.3, "chunk_dense"),
              (12, 8, 0.3, "absent"), (15, 8, 0.3, "narrow"))
#: filter kinds that ``hll_filter`` makes: bits in chunk 1 (words 2048 to
#: 4095 of a shard, the kernel's kChunkWords) only, this many a shard;
#: "chunk_list" sets about 1,900 of the chunk's 16,384 nibbles (under the
#: kernel's list cap of 4,096), "chunk_dense" about 5,200 (past it).
HLL_CHUNK_BITS = {"chunk_list": 2000, "chunk_dense": 6000}
HLL_CHUNK = (2048, 4096)
#: the "narrow" kind's words a shard.
HLL_NARROW_WORDS = 3104
#: the keys phase's precision, and its plane stack's shards (954 padded).
HLL_TIMED_P = 12
HLL_TIMED_ROWS = 1024
#: the key-plane checks: (plane slots, probes, padded to a power of two,
#: runs: ``key_plane``'s hash 0, a run of equal hashes and a run of equal
#: high words across the kernel's fences); the last is the timed one. One
#: slot and 1,000 unpadded, below the kernel's 8,192 fences; 393,221 (not a
#: power of two, 6,145 fences of 64 slots) and 2^14 with runs.
KEYPLANE_CHECKS = ((1, 7, True, False), (8, 100, True, False), (1000, 5000, True, False),
                   (1, 7, False, False), (1000, 5000, False, False),
                   (393221, 20000, False, True), (1 << 14, 5000, True, True),
                   (1 << 20, 65536, True, True), (1 << 20, 65536, True, False))
#: similar_count's checks: [R, S, W] cubes; the first is the timed one (the
#: keys phase's SimilarTopN cube, 1 GiB, SIM_CUBE_MAX_BYTES).
SIM_CHECKS = ((8, 1024, 32768), (3, 5, 96), (1, 1, 32))


def hll_planes(torch, rows: int, p: int, density: float, dev, seed: int):
    """[rows, 2^20] int32 packed planes made on the card from a seeded
    generator, 128 rows at a time: ``density`` of the columns present
    (``bucket | rho << 18``, buckets below 2^p, rho 1..33), the rest 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((rows, 1 << 20), dtype=torch.int32, device=dev)
    for lo in range(0, rows, 128):
        n = min(128, rows - lo)
        present = torch.rand((n, 1 << 20), generator=g, device=dev) < density
        bucket = torch.randint(0, 1 << p, (n, 1 << 20), generator=g, device=dev,
                               dtype=torch.int32)
        rho = torch.randint(1, 34, (n, 1 << 20), generator=g, device=dev, dtype=torch.int32)
        out[lo:lo + n] = torch.where(present, bucket | (rho << 18), 0)
    return out


def filter_words(rows: int, n_bits: int, seed: int) -> np.ndarray:
    """[rows, W] uint32 words with ``n_bits`` random column bits set (the
    BSI filter row's density at ``n_bits`` = 5M over 1024 shards)."""
    rng = np.random.default_rng(seed)
    words = np.zeros(rows * SHARD_WORDS, dtype=np.uint32)
    pos = rng.integers(0, rows * SHARD_WORDS * 32, n_bits, dtype=np.int64)
    np.bitwise_or.at(words, pos >> 5, np.left_shift(np.uint32(1), (pos & 31).astype(np.uint32)))
    return words.reshape(rows, SHARD_WORDS)


def chunk_words(rows: int, bits: int, seed: int) -> np.ndarray:
    """[rows, W] uint32 words with ``bits`` random column bits a row set,
    all inside words HLL_CHUNK of the row."""
    rng = np.random.default_rng(seed)
    words = np.zeros((rows, SHARD_WORDS), dtype=np.uint32)
    lo, hi = HLL_CHUNK
    pos = rng.integers(lo * 32, hi * 32, (rows, bits), dtype=np.int64)
    flat = words.reshape(-1)
    pos = (pos + (np.arange(rows, dtype=np.int64) * SHARD_WORDS * 32)[:, None]).reshape(-1)
    np.bitwise_or.at(flat, pos >> 5, np.left_shift(np.uint32(1), (pos & 31).astype(np.uint32)))
    return words


def hll_filter(kind: str, rows: int, seed: int) -> np.ndarray:
    """[rows, W] uint32 filter words of one HLL_CHECKS kind: "seeded"
    (``seeded_words``: random, all-ones, sign-bit-only and zero words and
    rows; "absent" and "narrow" too), "sparse" (5,000 bits a shard, the
    keys phase's density), "zero", "ones", or bits in one chunk
    (HLL_CHUNK_BITS)."""
    if kind in ("seeded", "absent", "narrow"):
        return seeded_words(np.random.default_rng(seed), (rows, SHARD_WORDS))
    if kind == "sparse":
        return filter_words(rows, rows * 5000, seed)
    if kind in ("zero", "ones"):
        return np.full((rows, SHARD_WORDS), 0xFFFFFFFF if kind == "ones" else 0, np.uint32)
    return chunk_words(rows, HLL_CHUNK_BITS[kind], seed)


def hll_case_inputs(kind: str, packed, filt):
    """The planes and filter of an HLL_CHECKS case from full-width ones:
    "absent" empties every other shard's plane, "narrow" keeps the first
    HLL_NARROW_WORDS words a shard. Works on numpy arrays and tensors."""
    if kind == "absent":
        packed = packed.copy() if isinstance(packed, np.ndarray) else packed.clone()
        packed[1::2] = 0
    elif kind == "narrow":
        w = HLL_NARROW_WORDS
        packed, filt = packed[:, :32 * w], filt[:, :w]
        if not isinstance(packed, np.ndarray):
            packed, filt = packed.contiguous(), filt.contiguous()
    return packed, filt


def key_plane(h: int, q: int, seed: int, pad: bool = True, runs: bool = False):
    """A [3, H] uint32 key plane of ``h`` random 64-bit hashes sorted as
    unsigned (three slots sharing one hash, a real slot at 2^64 - 1), padded
    to a power of two of at least 8 slots with the padding hash (id MISS)
    unless ``pad`` is false (H = h), and probe halves: q / 2 present
    hashes, absent ones, 0 and the padding hash. ``runs`` (h >= 6000) also
    makes hash 0 real, slots 1000-1299 one hash and slots 5000-5399 one
    high word (sorted low words), and probes the first, the middle of the
    second and 0 among the present ones and the second's high word with an
    absent low word among the absent ones."""
    rng = np.random.default_rng(seed)
    hashes = np.sort(rng.integers(0, 2**64 - 1, h, dtype=np.uint64, endpoint=True))
    if h > 4:
        hashes[1:4] = hashes[1]
    hashes[-1] = np.uint64(2**64 - 1)
    high = np.uint64(0xFFFFFFFF) << np.uint64(32)
    if runs:
        hashes[0] = 0
        hashes[1000:1300] = hashes[1000]
        hashes[5000:5400] = (hashes[5000] & high) | np.sort(
            rng.integers(1, 2**32, 400, dtype=np.uint64))
        hashes.sort()
    width = max(8, 1 << max(0, (h - 1).bit_length())) if pad else h
    mat = np.zeros((3, width), dtype=np.uint32)
    mat[:2, :] = 0xFFFFFFFF
    mat[0, :h] = (hashes >> np.uint64(32)).astype(np.uint32)
    mat[1, :h] = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mat[2, :h] = np.arange(1, h + 1, dtype=np.uint32)
    present = hashes[rng.integers(0, h, q // 2)]
    absent = rng.integers(0, 2**64 - 1, q - q // 2 - 2, dtype=np.uint64, endpoint=True)
    if runs:
        present[:3] = hashes[1000], hashes[5200], 0
        absent[0] = hashes[5000] & high  # low word 0: below the run's
    probes = np.concatenate([present, absent, np.array([0, 2**64 - 1], dtype=np.uint64)])
    return (mat, (probes >> np.uint64(32)).astype(np.uint32),
            (probes & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def flip_hash(hi, lo):
    """int32 (hi, lo) hash halves as sign-flipped int64, whose signed order
    is the hashes' unsigned order."""
    return (((hi.long() & 0xFFFFFFFF) - 2**31) << 32) | (lo.long() & 0xFFFFFFFF)


def plane_lookup_library(torch, plane, probe_hi, probe_lo):
    """plane_lookup's function from PyTorch calls: ``searchsorted`` over the
    hashes as sign-flipped int64 (their unsigned order), a gather and a
    compare. The flipped keys are laid out ahead of the timed call."""
    keys, probes, ids = flip_hash(plane[0], plane[1]), flip_hash(probe_hi, probe_lo), plane[2]
    last = keys.numel() - 1

    def call():
        pos = torch.searchsorted(keys, probes).clamp_(max=last)
        return torch.where(keys[pos] == probes, ids[pos], 0)

    return call


def hll_expand_work(torch, filt, p: int) -> tuple[int, int, int]:
    """(bytes, logic ops, plane sectors) of hll_expand's function on this
    filter: the filter read once, of the packed plane each 32-byte sector
    (8 columns: one byte of a filter word) that holds a filtered column,
    the registers written once; a test a filter word, and a shift, a mask
    test, a bucket mask and a compare a filtered column."""
    rows, words = filt.shape
    fbytes = filt.contiguous().view(torch.uint8)
    sectors = int(fbytes.ne(0).sum())
    popc = torch.tensor([bin(i).count("1") for i in range(256)], device=filt.device)
    cols = int(popc[fbytes.long()].sum())
    return rows * words * 4 + sectors * 32 + (rows << p), rows * words + 4 * cols, sectors


def plane_lookup_bytes(torch, plane, probe_hi, probe_lo) -> int:
    """The bytes plane_lookup's function must move on these probes: each
    probe's halves read and its id written once; of the two hash lanes,
    the 32-byte sectors of the slots that decide a probe (the first slot
    not below it and the one before); of the id lane, each hit's sector."""
    keys, probes = flip_hash(plane[0], plane[1]), flip_hash(probe_hi, probe_lo)
    pos = torch.searchsorted(keys, probes)
    at = pos.clamp(max=keys.numel() - 1)
    hit = keys[at] == probes
    hash_sectors = int((torch.cat([at, (pos - 1).clamp(min=0)]) >> 3).unique().numel())
    id_sectors = int((at[hit] >> 3).unique().numel())
    return (2 * hash_sectors + id_sectors) * 32 + 3 * probes.numel() * 4


def check_sketch_kernels(torch, kernels, t, dev, errs) -> None:
    """hll_expand, hll_reduce, similar_count and plane_lookup against their
    plain versions on the card, exact, on HLL_CHECKS, SIM_CHECKS and
    KEYPLANE_CHECKS (and hll_reduce on one and on 1024 rows)."""
    for i, (p, rows, density, kind) in enumerate(HLL_CHECKS):
        packed, filt = hll_case_inputs(kind, hll_planes(torch, rows, p, density, dev, SEED + i),
                                       t(hll_filter(kind, rows, SEED + i)))
        got = kernels.hll_expand(packed, filt, p)
        want = kernels.hll_expand_plain(packed, filt, p)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        errs["hll_expand"] = max(errs["hll_expand"], err)
        if got.shape != want.shape or got.dtype != torch.uint8 or err:
            raise AssertionError(f"hll_expand p={p} {kind} {list(packed.shape)}: "
                                 f"max |err| {err}")
        for regs in (got, got[:1]):
            r_got, r_want = kernels.hll_reduce(regs), kernels.hll_reduce_plain(regs)
            torch.cuda.synchronize()
            err = int((r_got.int() - r_want.int()).abs().max())
            errs["hll_reduce"] = max(errs["hll_reduce"], err)
            if err:
                raise AssertionError(f"hll_reduce [{regs.shape[0]}, 2^{p}]: max |err| {err}")
        del packed, filt, got, want
    wide = torch.randint(0, 34, (1024, 1 << 16), dtype=torch.uint8, device=dev)
    if not torch.equal(kernels.hll_reduce(wide), kernels.hll_reduce_plain(wide)):
        raise AssertionError("hll_reduce [1024, 2^16] differs")
    for r, s, w in SIM_CHECKS:
        rng = np.random.default_rng(SEED + r)
        cube = torch.randint(-2**31, 2**31 - 1, (r, s, w), dtype=torch.int32, device=dev)
        filt = t(seeded_words(rng, (s, w)))
        got, want = kernels.similar_count(cube, filt), kernels.similar_count_plain(cube, filt)
        torch.cuda.synchronize()
        err = max(int((g.long() - v.long()).abs().max()) for g, v in zip(got, want))
        errs["similar_count"] = max(errs["similar_count"], err)
        if err:
            raise AssertionError(f"similar_count [{r}, {s}, {w}]: max |err| {err}")
        del cube
    for h, q, pad, runs in KEYPLANE_CHECKS:
        mat, phi, plo = key_plane(h, q, SEED + h, pad, runs)
        plane, ph, pl = t(mat), t(phi), t(plo)
        got, want = kernels.plane_lookup(plane, ph, pl), kernels.plane_lookup_plain(plane, ph, pl)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        errs["plane_lookup"] = max(errs["plane_lookup"], err)
        if err or int((got[:q // 2] == 0).sum()):
            raise AssertionError(f"plane_lookup H={mat.shape[1]} Q={q} runs={runs}: "
                                 f"{err} ids differ")
    log("sketch and key-plane kernels: exact on hll_expand at "
        f"{', '.join(f'p = {c[0]} {c[3]}' for c in HLL_CHECKS)}; hll_reduce, "
        f"similar_count on {len(SIM_CHECKS)} cubes, plane_lookup on "
        f"{len(KEYPLANE_CHECKS)} planes")


def sketch_kernel_timings(torch, kernels, t, dev, card: str) -> dict:
    """The four kernels timed at the keys phase's shapes, each beside its
    bound, its plain version and its library call: name -> (ms, plain ms,
    bound ms, bound by, library ms or None). Big inputs are made one
    kernel at a time and freed after it."""
    out = {}
    w = SHARD_WORDS
    rows, p = HLL_TIMED_ROWS, HLL_TIMED_P

    def timed(name, shape, fn, plain_fn, lib_fn, nbytes, logic, popc):
        ms = time_cuda_ms(torch, fn, KERNEL_RUNS)
        plain = time_cuda_ms(torch, plain_fn, 5)
        bound, by, term = bound_ms(torch, nbytes, logic, popc)
        lib = time_cuda_ms(torch, lib_fn, KERNEL_RUNS) if lib_fn is not None else None
        lib_text = f"; library {lib:.4f} ms" if lib is not None else \
            "; library none (torch has no popcount)"
        log(f"kernel {name} {shape}: {ms:.4f} ms, bound {bound:.4f} ms ({term}), "
            f"{bound / ms:.1%} of bound; plain {plain:.4f} ms{lib_text}  [{card}]")
        out[name] = (ms, plain, bound, by, lib)

    packed = hll_planes(torch, rows, p, BSI_DENSITY, dev, SEED)
    filt = t(filter_words(rows, BSI_FILTER_BITS, SEED))
    regs = kernels.hll_expand(packed, filt, p)
    torch.cuda.empty_cache()
    if not torch.equal(regs, kernels.hll_expand_plain(packed, filt, p)):
        raise AssertionError("hll_expand at the timed shape differs from its plain version")
    # The library call: scatter_reduce "amax" of each column's masked rho
    # into its shard's register segment, the (segment, rho) pairs laid out
    # ahead of it; checked equal first.
    seg = ((packed & 0x3FFFF).long() + (torch.arange(rows, device=dev) << p).unsqueeze(1)).view(-1)
    rho = torch.where(kernels._filter_bits(filt) == 1, packed >> 18, 0).view(-1)

    def hll_library():
        return torch.zeros(rows << p, dtype=torch.int32, device=dev).scatter_reduce_(
            0, seg, rho, "amax").view(rows, 1 << p).to(torch.uint8)

    if not torch.equal(hll_library(), regs):
        raise AssertionError("hll_expand: the library call computes other registers")
    lib = time_cuda_ms(torch, hll_library, 3)  # about 0.34 s a call
    del seg, rho
    torch.cuda.empty_cache()  # the plain version's scratch is the largest
    plain_ms = time_cuda_ms(torch, lambda: kernels.hll_expand_plain(packed, filt, p), 3)
    ms = time_cuda_ms(torch, lambda: kernels.hll_expand(packed, filt, p), KERNEL_RUNS)
    nbytes, logic, sectors = hll_expand_work(torch, filt, p)
    bound, by, term = bound_ms(torch, nbytes, logic, 0)
    log(f"kernel hll_expand [{rows}, 2^20] plane, {BSI_FILTER_BITS}-bit filter, p = {p}: "
        f"{ms:.4f} ms, bound {bound:.4f} ms ({term}: {sectors} of the plane's "
        f"{rows << 17} sectors hold a filtered column), {bound / ms:.1%} of bound; plain "
        f"{plain_ms:.4f} ms; library {lib:.4f} ms (scatter_reduce amax)  [{card}]")
    out["hll_expand"] = (ms, plain_ms, bound, by, lib)
    del packed, filt
    torch.cuda.empty_cache()
    timed("hll_reduce", f"[{rows}, 2^{p}]", lambda: kernels.hll_reduce(regs),
          lambda: kernels.hll_reduce_plain(regs), lambda: regs.amax(0),
          rows * (1 << p) + (1 << p), rows * (1 << p) // 4, 0)
    del regs
    r, s, _ = SIM_CHECKS[0]
    cube = torch.randint(-2**31, 2**31 - 1, (r, s, w), dtype=torch.int32, device=dev)
    sfilt = t(seeded_words(np.random.default_rng(SEED), (s, w)))
    # per word and row: an and, two popcounts, two adds; the filter's own
    # popcount once
    timed("similar_count", f"[{r}, {s}, {w}] cube x [{s}, {w}] filter",
          lambda: kernels.similar_count(cube, sfilt),
          lambda: kernels.similar_count_plain(cube, sfilt), None,
          (r + 1) * s * w * 4 + (2 * r + 1) * 4, 3 * r * s * w, (2 * r + 1) * s * w)
    del cube, sfilt
    torch.cuda.empty_cache()
    h, q, pad, runs = KEYPLANE_CHECKS[-1]
    mat, phi, plo = key_plane(h, q, SEED, pad, runs)
    plane, ph, pl = t(mat), t(phi), t(plo)
    lib_call = plane_lookup_library(torch, plane, ph, pl)
    if not torch.equal(lib_call(), kernels.plane_lookup(plane, ph, pl)):
        raise AssertionError("plane_lookup: the library calls compute other ids")
    timed("plane_lookup", f"[3, {mat.shape[1]}] plane, {q} probes",
          lambda: kernels.plane_lookup(plane, ph, pl),
          lambda: kernels.plane_lookup_plain(plane, ph, pl), lib_call,
          plane_lookup_bytes(torch, plane, ph, pl), 0, 0)
    return out


#: the coordinator's reduce kernels' exact checks on the card: scatter_bits
#: on a leg's (segment, offset) positions, or_fold at K contributors.
SCATTER_CASES = ("empty", "one", "bit31_word32767", "sink", "unsorted_segments",
                 "out_of_range", "full_shard", "row_leg_32")
#: scatter_bits_grouped's exact checks: the SCATTER_CASES whose positions
#: are grouped by segment, plus empty rows among full ones, dense runs whose
#: CTA chunks end mid-word, and offsets out of range in grouped rows.
GROUPED_SCATTER_CASES = ("empty", "one", "bit31_word32767", "sink", "full_shard",
                         "row_leg_32", "empty_rows", "dense_unaligned",
                         "offsets_out_of_range")
OR_FOLD_CHECKS = ((64, 1), (64, 2), (8, 16), (3, 5))
#: the cluster phase's Row leg: 32 of the bench's shards at its density.
ROW_LEG_SHARDS = 32
#: or_fold's timed shapes ([B, K, W]).
OR_FOLD_TIMED = ((64, 2), (8, 16))


def scatter_case(name: str, seed: int = SEED):
    """(seg, local, n_segs) int32 numpy arrays of one scatter_bits case:
    a remote Row leg's unique positions as its decode makes them (segment
    index, in-shard offset), or an edge."""
    rng = np.random.default_rng(seed)
    bits = SHARD_WORDS * 32
    if name == "empty":
        return np.empty(0, np.int32), np.empty(0, np.int32), 3
    if name == "one":
        return np.array([0], np.int32), np.array([12345], np.int32), 1
    if name == "bit31_word32767":
        loc = np.array([31, 32 * 32767 + 31, 32 * 32767, 63], np.int32)
        return np.array([0, 0, 1, 1], np.int32), loc, 2
    if name == "sink":  # padding entries aimed at row n_segs
        loc = rng.choice(bits, 1000, replace=False).astype(np.int32)
        return np.r_[np.zeros(500, np.int32), np.full(500, 2, np.int32)], loc, 2
    if name == "unsorted_segments":
        n = 200_000
        seg = rng.integers(0, 7, n).astype(np.int32)
        flat = distinct(seg.astype(np.int64) * bits + rng.integers(0, bits, n))
        perm = rng.permutation(len(flat))
        return (flat // bits).astype(np.int32)[perm], (flat % bits).astype(np.int32)[perm], 7
    if name == "out_of_range":  # dropped, as the JAX scatter drops them
        return (np.array([-1, 4, 0, 1], np.int32),
                np.array([5, 5, bits, -7], np.int32), 3)
    if name == "full_shard":
        return np.zeros(bits, np.int32), np.arange(bits, dtype=np.int32), 1
    if name == "row_leg_32":
        n = int(ROW_LEG_SHARDS * bits * COUNT_DENSITY)
        flat = distinct(rng.integers(0, ROW_LEG_SHARDS * bits, n))
        return (flat // bits).astype(np.int32), (flat % bits).astype(np.int32), ROW_LEG_SHARDS
    if name == "empty_rows":  # rows 0, 2 and 5 of 7 empty, the sink too
        sizes = (0, 40_000, 0, 17, 3, 0, 90_001)
        seg = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
        loc = np.concatenate([np.sort(rng.choice(bits, k, replace=False)) for k in sizes])
        return seg, loc.astype(np.int32), len(sizes)
    if name == "dense_unaligned":  # runs of consecutive positions, word-unaligned
        runs = ((17, 100_003), (bits - 70_001, 70_001), (5, 33))
        seg = np.repeat(np.arange(len(runs), dtype=np.int32), [k for _, k in runs])
        loc = np.concatenate([np.arange(a, a + k) for a, k in runs]).astype(np.int32)
        return seg, loc, len(runs)
    if name == "offsets_out_of_range":  # dropped, each in its grouped row
        loc = np.array([-7, 3, bits, 2**31 - 1, -1, bits - 1, 64, -2**31], np.int32)
        return np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int32), loc, 2
    raise KeyError(name)


def grouped_case(name: str, seed: int = SEED):
    """(starts, local, n_segs) int32 numpy arrays of one GROUPED_SCATTER_CASES
    case: its positions' row starts, found by searchsorted over the
    segment indices, which are non-decreasing."""
    seg, loc, n_segs = scatter_case(name, seed)
    if np.any(np.diff(seg) < 0) or (len(seg) and (seg[0] < 0 or seg[-1] > n_segs)):
        raise ValueError(f"{name}: positions not grouped by segment")
    starts = np.searchsorted(seg, np.arange(n_segs + 2)).astype(np.int32)
    return starts, loc, n_segs


def check_reduce_kernels(torch, kernels, dev, errs) -> None:
    """scatter_bits_grouped, scatter_bits and or_fold against their plain
    versions on the card, exact (differing bits counted), on
    GROUPED_SCATTER_CASES, SCATTER_CASES and OR_FOLD_CHECKS."""
    for name in GROUPED_SCATTER_CASES:
        starts, loc, n_segs = grouped_case(name)
        st, l = torch.from_numpy(starts).to(dev), torch.from_numpy(loc).to(dev)
        got = kernels.scatter_bits_grouped(st, l)
        want = kernels.scatter_bits_grouped_plain(st, l)
        torch.cuda.synchronize()
        err = int(kernels.row_counts_plain(got ^ want).long().sum())
        errs["scatter_bits_grouped"] = max(errs["scatter_bits_grouped"], err)
        if got.shape != (n_segs + 1, SHARD_WORDS) or got.shape != want.shape or err:
            raise AssertionError(f"scatter_bits_grouped {name}: {tuple(got.shape)}, {err} "
                                 "bits differ")
        if name == "bit31_word32767" and int(got[0, 32767]) != -2**31:
            raise AssertionError("scatter_bits_grouped: bit 31 of word 32767 not set")
    for name in SCATTER_CASES:
        seg, loc, n_segs = scatter_case(name)
        s, l = torch.from_numpy(seg).to(dev), torch.from_numpy(loc).to(dev)
        got = kernels.scatter_bits(s, l, n_segs)
        want = kernels.scatter_bits_plain(s, l, n_segs)
        torch.cuda.synchronize()
        err = int(kernels.row_counts_plain(got ^ want).long().sum())
        errs["scatter_bits"] = max(errs["scatter_bits"], err)
        if got.shape != (n_segs + 1, SHARD_WORDS) or got.shape != want.shape or err:
            raise AssertionError(f"scatter_bits {name}: {tuple(got.shape)}, {err} bits differ")
        if name == "bit31_word32767" and int(got[0, 32767]) != -2**31:
            raise AssertionError("scatter_bits: bit 31 of word 32767 not set")
    for b, k in OR_FOLD_CHECKS:
        stack = torch.randint(-2**31, 2**31 - 1, (b, k, SHARD_WORDS), dtype=torch.int32,
                              device=dev)
        got, want = kernels.or_fold(stack), kernels.or_fold_plain(stack)
        torch.cuda.synchronize()
        err = int(kernels.row_counts_plain(got ^ want).long().sum())
        errs["or_fold"] = max(errs["or_fold"], err)
        if got.shape != (b, SHARD_WORDS) or err:
            raise AssertionError(f"or_fold [{b}, {k}, W]: {err} bits differ")
    log(f"reduce kernels: exact on scatter_bits_grouped {', '.join(GROUPED_SCATTER_CASES)}; "
        f"scatter_bits {', '.join(SCATTER_CASES)}; "
        f"or_fold at [B, K] {', '.join(f'[{b}, {k}]' for b, k in OR_FOLD_CHECKS)}")


def scatter_grouped_bytes(n: int, n_segs: int) -> int:
    """scatter_bits_grouped's bytes: 4 a position and the row starts in,
    the ``[n_segs + 1, W]`` image out once."""
    return 4 * n + 4 * (n_segs + 2) + (n_segs + 1) * SHARD_WORDS * 4


def reduce_kernel_timings(torch, kernels, dev, card: str) -> dict:
    """scatter_bits_grouped and scatter_bits at the cluster phase's
    32-shard Row leg and or_fold at OR_FOLD_TIMED, each beside its bound,
    its plain version and its library call: name -> (ms, plain ms, bound
    ms, bound by, library ms). or_fold's entry is its first timed shape."""
    import functools

    out = {}
    seg, loc, n_segs = scatter_case("row_leg_32")
    s, l = torch.from_numpy(seg).to(dev), torch.from_numpy(loc).to(dev)
    starts, _, _ = grouped_case("row_leg_32")
    st = torch.from_numpy(starts).to(dev)
    # The library call: index_put_ with accumulate of each position's bit
    # into a zeroed flat image (the word index and the bit laid out ahead
    # of it; distinct positions, so add is or); checked equal first.
    widx = s.long() * SHARD_WORDS + (l >> 5).long()
    wbit = torch.bitwise_left_shift(torch.ones_like(l), l & 31)
    img_words = (n_segs + 1) * SHARD_WORDS

    def scatter_library():
        return torch.zeros(img_words, dtype=torch.int32, device=dev).index_put_(
            (widx,), wbit, accumulate=True).view(n_segs + 1, SHARD_WORDS)

    got = kernels.scatter_bits(s, l, n_segs)
    if not (torch.equal(got, kernels.scatter_bits_plain(s, l, n_segs))
            and torch.equal(scatter_library(), got)
            and torch.equal(kernels.scatter_bits_grouped(st, l), got)):
        raise AssertionError("scatter_bits at the timed leg: a kernel or the library "
                             "call differs from the plain version")
    # The general form's bytes: 8 a position in (a segment index beside each
    # offset) and the image written once: the function needs no more (the
    # kernel's zero fill is a cost of its design, not counted). The grouped
    # form needs 4 a position and the row starts.
    nbytes8 = 8 * len(seg) + img_words * 4
    bound8 = bound_ms(torch, nbytes8, len(seg), 0)[0]
    ms = time_cuda_ms(torch, lambda: kernels.scatter_bits_grouped(st, l), KERNEL_RUNS)
    plain = time_cuda_ms(torch, lambda: kernels.scatter_bits_grouped_plain(st, l), 5)
    lib = time_cuda_ms(torch, scatter_library, KERNEL_RUNS)
    bound, by, term = bound_ms(torch, scatter_grouped_bytes(len(loc), n_segs), len(loc), 0)
    log(f"kernel scatter_bits_grouped {len(loc)} positions in {n_segs} rows into "
        f"[{n_segs + 1}, {SHARD_WORDS}]: {ms:.4f} ms, bound {bound:.4f} ms ({term}: 4 B a "
        f"position and the starts in, image out once), {bound / ms:.1%} of bound; "
        f"{bound8 / ms:.1%} of the 8-B-a-position bound {bound8:.4f} ms; plain {plain:.4f} "
        f"ms; library {lib:.4f} ms (zeros + index_put_ accumulate)  [{card}]")
    out["scatter_bits_grouped"] = (ms, plain, bound, by, lib)
    ms = time_cuda_ms(torch, lambda: kernels.scatter_bits(s, l, n_segs), KERNEL_RUNS)
    plain = time_cuda_ms(torch, lambda: kernels.scatter_bits_plain(s, l, n_segs), 5)
    lib = time_cuda_ms(torch, scatter_library, KERNEL_RUNS)
    bound, by, term = bound_ms(torch, nbytes8, len(seg), 0)
    log(f"kernel scatter_bits {len(seg)} positions into [{n_segs + 1}, {SHARD_WORDS}]: "
        f"{ms:.4f} ms, bound {bound:.4f} ms ({term}: positions in, image out once), "
        f"{bound / ms:.1%} of bound; plain {plain:.4f} ms; library {lib:.4f} ms "
        f"(zeros + index_put_ accumulate)  [{card}]")
    out["scatter_bits"] = (ms, plain, bound, by, lib)
    del s, l, st, widx, wbit, got
    for b, k in OR_FOLD_TIMED:
        stack = torch.randint(-2**31, 2**31 - 1, (b, k, SHARD_WORDS), dtype=torch.int32,
                              device=dev)
        fold_library = lambda st=stack: functools.reduce(torch.bitwise_or, st.unbind(1))
        if not torch.equal(fold_library(), kernels.or_fold(stack)):
            raise AssertionError(f"or_fold [{b}, {k}, W]: the library calls differ")
        ms = time_cuda_ms(torch, lambda st=stack: kernels.or_fold(st), KERNEL_RUNS)
        plain = time_cuda_ms(torch, lambda st=stack: kernels.or_fold_plain(st), 5)
        lib = time_cuda_ms(torch, fold_library, KERNEL_RUNS)
        bound, by, term = bound_ms(torch, (b * k + b) * SHARD_WORDS * 4,
                                   b * (k - 1) * SHARD_WORDS, 0)
        log(f"kernel or_fold [{b}, {k}, {SHARD_WORDS}]: {ms:.4f} ms, bound {bound:.4f} ms "
            f"({term}), {bound / ms:.1%} of bound; plain {plain:.4f} ms; library "
            f"{lib:.4f} ms ({k - 1} torch.bitwise_or)  [{card}]")
        out.setdefault("or_fold", (ms, plain, bound, by, lib))
        del stack
    return out


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
    gb_planes = [t(seeded_words(rng, (1024, w)))[:954] for _ in range(15)]
    gb_filt = big_b[:954]
    check_group_lattices(torch, kernels, t, rng, gb_planes, gb_filt, errs)
    packed = check_packed_cases(torch, kernels, t, dev, errs)
    ps_pos, ps_vals, ps_depth = check_plane_scatter(torch, kernels, dev, errs)
    check_sketch_kernels(torch, kernels, t, dev, errs)
    check_reduce_kernels(torch, kernels, dev, errs)
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
    asm_shape = f"[1024, 32768], 16 dense rows, {asm[2].shape[0]} COO words"
    ps_shape = f"bench config 3's shard: {len(ps_pos)} values, depth {ps_depth}"
    cases = [
        ("pair_count", "[1024, 32768] x [1024, 32768]",
         lambda: kernels.pair_count(big_a, big_b, "and"),
         lambda: kernels.pair_count_plain(big_a, big_b, "and"),
         2 * rows * w * 4 + rows * 4, 2 * rows * w, rows * w),
        ("row_counts", "[1024, 32768]",
         lambda: kernels.row_counts(big_a),
         lambda: kernels.row_counts_plain(big_a),
         rows * w * 4 + rows * 4, rows * w, rows * w),
        ("pair_count", "[512, 32768] x [32768]",
         lambda: kernels.pair_count(stack, filt_stack[3], "and"),
         lambda: kernels.pair_count_plain(stack, filt_stack[3], "and"),
         512 * w * 4 + w * 4 + 512 * 4, 2 * 512 * w, 512 * w),
        ("pair_count", "[17, 1024, 32768] x [1024, 32768]",
         lambda: kernels.pair_count(cube, cls, "and"),
         lambda: kernels.pair_count_plain(cube, cls, "and"),
         18 * plane + 17 * rows * 4, 2 * 17 * rows * w, 17 * rows * w),
        # per word and plane: 2 ops for the predicate mask, 7 for lt/gt/eq
        ("bsi_compare", "[17, 1024, 32768] x [1024, 32768]",
         lambda: kernels.bsi_compare(cube, filt, bsi_pred, 0, 17, "gt", False),
         lambda: kernels.bsi_compare_plain(cube, filt, bsi_pred, 0, 17, "gt", False),
         19 * plane, 9 * 17 * rows * w, 0),
        # per word and plane: narrow, add; a popcount
        ("bsi_minmax", "[17, 1024, 32768] x [1024, 32768]",
         lambda: kernels.bsi_minmax(cube, filt, 17, True),
         lambda: kernels.bsi_minmax_plain(cube, filt, 17, True),
         18 * plane + 3 * rows * 4, 2 * 17 * rows * w, 17 * rows * w),
        # per word: two ands, an add; a popcount
        ("tree_count", "3 x [1024, 32768] (and, and)",
         lambda: kernels.tree_count(tree3, [0, 1, "and", 2, "and"]),
         lambda: kernels.tree_count_plain(tree3, [0, 1, "and", 2, "and"]),
         3 * plane + rows * 4, 3 * rows * w, rows * w),
        ("tree_count", "3 x [1024, 32768] (and, and), plane written",
         lambda: kernels.tree_count(tree3, [0, 1, "and", 2, "and"], True),
         lambda: kernels.tree_count_plain(tree3, [0, 1, "and", 2, "and"], True),
         4 * plane + rows * 4, 3 * rows * w, rows * w),
        # per word: two shifts, an or
        ("shift_left", "[1024, 32768], n = 33",
         lambda: kernels.shift_left(big_a, 33),
         lambda: kernels.shift_left_plain(big_a, 33),
         2 * plane, 3 * rows * w, 0),
        # each distinct operand read once: 8 a's and 7 b's (one shared)
        ("pair_count_batched", "8 x [1024, 32768] x [1024, 32768], one b shared",
         lambda: kernels.pair_count_batched(batch_a, batch_b, "and"),
         lambda: kernels.pair_count_batched_plain(batch_a, batch_b, "and"),
         15 * plane + 8 * rows * 4, 2 * 8 * rows * w, 8 * rows * w),
        # a TopN pass at 10M columns: 10 shards' 3 tiles of 512 rows, each
        # against its shard's filter row, in one launch
        ("pair_count_batched", "30 x [512, 32768] x [32768] (a TopN pass's tiles)",
         lambda: kernels.pair_count_batched(topn_tiles, topn_filts, "and"),
         lambda: kernels.pair_count_batched_plain(topn_tiles, topn_filts, "and"),
         30 * 512 * w * 4 + 10 * w * 4 + 30 * 512 * 4, 2 * 30 * 512 * w, 30 * 512 * w),
        ("row_counts_batched", "8 x [1024, 32768]",
         lambda: kernels.row_counts_batched(batch_a),
         lambda: kernels.row_counts_batched_plain(batch_a),
         8 * plane + 8 * rows * 4, 8 * rows * w, 8 * rows * w),
        # 8 slots x 3 leaves over 15 distinct planes (a[z], b[z], a[z+1];
        # slot 5 pushes slot 3's b), each read once
        ("tree_count_batched", "8 x 3 x [1024, 32768] (and, and), 15 distinct planes",
         lambda: kernels.tree_count_batched(tables3, tape3),
         lambda: kernels.tree_count_batched_plain(tables3, tape3),
         15 * plane + 8 * rows * 4, 3 * 8 * rows * w, 8 * rows * w),
        # the same wave with no leaf shared
        ("tree_count_batched", "8 x 3 x [1024, 32768] (and, and), 24 distinct planes",
         lambda: kernels.tree_count_batched(tables24, tape3),
         lambda: kernels.tree_count_batched_plain(tables24, tape3),
         24 * plane + 8 * rows * 4, 3 * 8 * rows * w, 8 * rows * w),
        # the stack written once, the dense rows and COO words read once
        ("assemble_stack", asm_shape,
         lambda: kernels.assemble_stack(*asm_args),
         lambda: kernels.assemble_stack_plain(*asm_args),
         plane + asm[1].nbytes + 12 * asm[2].shape[0] + asm[0].nbytes, 0, 0),
        # GROUP_TIMED: each plane and the filter read once, the counts
        # written once; the prefix tree's ANDs, a count and an add per group
        # and word (lattice_work)
        ("group_count", "(4, 8) + filter: 32 groups, 12 planes + filter of [954, 32768]",
         lambda: kernels.group_count(gb_planes[:12], (4, 8), gb_filt),
         lambda: kernels.group_count_plain(gb_planes[:12], (4, 8), gb_filt),
         *group_timed_work((4, 8), True, 954)),
        ("group_count", "(4, 8, 3): 96 groups, 15 planes of [954, 32768]",
         lambda: kernels.group_count(gb_planes, (4, 8, 3), None),
         lambda: kernels.group_count_plain(gb_planes, (4, 8, 3), None),
         *group_timed_work((4, 8, 3), False, 954)),
        ("group_count", "(32, 256) over 4 rows: 8192 groups, 288 planes of [4, 32768]",
         lambda: kernels.group_count(gb_wide, (32, 256), None),
         lambda: kernels.group_count_plain(gb_wide, (32, 256), None),
         *group_timed_work((32, 256), False, 4)),
        *packed_timed_cases(kernels, packed),
        ("plane_scatter", ps_shape,
         lambda: kernels.plane_scatter(ps_pos, ps_vals, ps_depth),
         lambda: kernels.plane_scatter_plain(ps_pos, ps_vals, ps_depth),
         plane_scatter_work(ps_pos, ps_depth), 0, 0),
    ]
    gb_wide = list(t(seeded_words(rng, (288, 4, w))))
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
    ps_library = plane_scatter_library(torch, ps_pos, ps_vals, ps_depth)
    if not torch.equal(ps_library(), kernels.plane_scatter(ps_pos, ps_vals, ps_depth)):
        raise AssertionError("plane_scatter: the library call computes another image")
    sl_library = shift_left_library(torch, big_a, 33)
    bc_library = bsi_compare_library(torch, cube, filt, bsi_pred, 0, 17, "gt", False)
    if not (torch.equal(sl_library(), kernels.shift_left(big_a, 33)) and torch.equal(
            bc_library(), kernels.bsi_compare(cube, filt, bsi_pred, 0, 17, "gt", False))):
        raise AssertionError("shift_left or bsi_compare: the library calls compute other "
                             "words")
    library = {"assemble_stack": {asm_shape: assemble_library},
               "plane_scatter": {ps_shape: ps_library},
               "shift_left": {"[1024, 32768], n = 33": sl_library},
               "bsi_compare": {"[17, 1024, 32768] x [1024, 32768]": bc_library},
               **packed_library(torch, kernels, packed)}
    # and_count and pair_count at K = 8 and 4096 (PACKED_VS_WIDTHS), and the
    # packed wave kernels at PACKED_WAVE_TIMED slots, each held to its plain
    # version and its library calls first.
    def stacks(case, seed=SEED):
        return tuple(t(x) for x in packed_case(case, 1024, seed))

    for (name, shape, fn, plain_fn, *work), lib_fn in packed_width_cases(torch, kernels,
                                                                         stacks):
        want = plain_fn()
        if not (torch.equal(fn(), want) and torch.equal(lib_fn(), want)):
            raise AssertionError(f"{name} {shape}: the kernel or the library calls "
                                 "differ from the plain version")
        cases.append((name, shape, fn, plain_fn, *work))
        library.setdefault(name, {})[shape] = lib_fn
    for n in PACKED_WAVE_TIMED:
        for name, shape, fn, plain_fn, *work, lib_fn in packed_wave_cases(
                torch, kernels, packed, n):
            want = plain_fn()
            if not (torch.equal(fn(), want) and torch.equal(lib_fn(), want)):
                raise AssertionError(f"{name} {shape}: the kernel or the library calls "
                                     "differ from the plain version")
            cases.append((name, shape, fn, plain_fn, *work))
            library.setdefault(name, {})[shape] = lib_fn
    tree3 = [big_a, big_b, t(seeded_words(rng, (1024, w)))]
    # The path the 3-leaf Count took before tree_count: two elementwise
    # torch ops writing 128 MiB planes, then row_counts.
    torch_ms = time_cuda_ms(torch, lambda: kernels.row_counts(
        (tree3[0] & tree3[1]) & tree3[2]), KERNEL_RUNS)
    log(f"3-leaf Count on the torch-ops path (and, and, row_counts): "
        f"{torch_ms:.4f} ms, 7 planes moved  [{card}]")
    logic_rate, popc_rate = integer_rates(torch)
    log(f"bound rates: HBM {PEAK_BYTES_PER_S:.4g} B/s; 32-bit logic and adds "
        f"{logic_rate:.6g}/s, popcounts {popc_rate:.6g}/s ({LOGIC_PER_CLOCK_SM} and "
        f"{POPC_PER_CLOCK_SM} a clock per SM x {_RATES['sms']} SMs x {_RATES['mhz']:.0f} MHz, "
        f"the maximum SM clock)  [{card}]")
    # The least time one launch takes under this timer: torch.zeros of
    # 1024 int32. The packed kernels' bounds lie below it.
    floor = time_cuda_ms(torch, lambda: torch.zeros(1024, dtype=torch.int32, device=dev),
                         KERNEL_RUNS)
    log(f"one-launch floor: torch.zeros of 1024 int32 {floor:.4f} ms  [{card}]")
    timings = {}
    for name, shape, fn, plain_fn, nbytes, logic, popc in cases:
        ms = time_cuda_ms(torch, fn, KERNEL_RUNS)
        plain = time_cuda_ms(torch, plain_fn, 5)
        bound, by, term = bound_ms(torch, nbytes, logic, popc)
        lib = (time_cuda_ms(torch, library[name][shape], KERNEL_RUNS)
               if shape in library.get(name, {}) else None)
        lib_text = f"; library {lib:.4f} ms" if lib is not None else ""
        if name == "assemble_stack":
            alone = time_cuda_ms(torch, lambda: lib_out.index_put_(lib_idx, asm_args[4]),
                                 KERNEL_RUNS)
            lib_text += f" (same function), index_put_ of the COO words alone {alone:.4f} ms"
        if name == "group_count":
            host = statistics.median(host_enqueue_times(torch, fn, KERNEL_RUNS))
            lib_text += (f"; host enqueue {host:.4f} ms (median); library none "
                         "(torch has no popcount)")
        if name.startswith("packed_") and name != "packed_expand":
            share = f"{bound / (ms - floor):.1%}" if ms > floor else "n/a"
            lib_text += f"; above the one-launch floor {ms - floor:.4f} ms, {share} of bound"
        log(f"kernel {name} {shape}: {ms:.4f} ms, bound {bound:.4f} ms ({term}), "
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
    del gb_planes, gb_wide
    torch.cuda.empty_cache()
    timings.update(sketch_kernel_timings(torch, kernels, t, dev, card))
    timings.update(reduce_kernel_timings(torch, kernels, dev, card))
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
    u = distinct(rng.integers(0, n_cols, int(k * 1.05) + 16, dtype=np.int64))
    cols = np.sort(u[rng.permutation(len(u))[:k]])
    vals = rng.integers(BSI_MIN, BSI_MAX, k, dtype=np.int64)
    n_filt = max(1, BSI_FILTER_BITS * n_shards // COUNT_SHARDS)
    fpos = rng.integers(0, n_cols, n_filt, dtype=np.int64)
    return n_cols, cols, vals, fpos


def bsi_shard_planes(cols: np.ndarray, vals: np.ndarray, n_shards: int, depth: int):
    """Yield (shard, [2 + depth, W] uint32 planes): the exists, sign and
    magnitude bits of the distinct sorted columns ``cols`` in each shard,
    one bincount a plane over the shard's slice (the bits of a word are
    distinct, so their sum is their OR). A shard at a time keeps the
    bincounts in cache and never holds the whole [2 + depth, n_shards, W]
    image."""
    from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD

    exp = SHARD_WIDTH.bit_length() - 1
    bounds = np.searchsorted(cols, np.arange(n_shards + 1, dtype=np.int64) << exp)
    for shard in range(n_shards):
        c = cols[bounds[shard]:bounds[shard + 1]]
        v = vals[bounds[shard]:bounds[shard + 1]]
        word = (c & (SHARD_WIDTH - 1)) >> 5
        bit = np.left_shift(np.uint64(1), (c & 31).astype(np.uint64)).astype(np.float64)
        mag = np.abs(v)
        masks = [None, v < 0] + [((mag >> i) & 1) == 1 for i in range(depth)]
        out = np.empty((2 + depth, WORDS_PER_SHARD), dtype=np.uint32)
        for j, m in enumerate(masks):
            out[j] = np.bincount(word if m is None else word[m],
                                 weights=bit if m is None else bit[m],
                                 minlength=WORDS_PER_SHARD)
        yield shard, out


def bsi_oracles(cols: np.ndarray, vals: np.ndarray, fpos: np.ndarray) -> dict:
    """The BSI queries' numpy oracles over the values at ``cols`` (sorted),
    the filter row holding ``fpos``."""
    from pilosa_tpu_torch.config import SHARD_WIDTH

    shards = cols >> SHARD_WIDTH.bit_length() - 1
    in_f = np.isin(cols, fpos)
    neg = vals < 0
    return {
        "sum": {"value": int(vals.sum()), "count": len(vals)},
        "min": extreme_oracle(shards, vals, True),
        "max": extreme_oracle(shards, vals, False),
        "sum_filtered": {"value": int(vals[in_f].sum()), "count": int(in_f.sum())},
        "count_gt": int((vals > 50000).sum()),
        "count_between": int(((vals >= -1000) & (vals <= 1000)).sum()),
        "max_of_negatives": extreme_oracle(shards[neg], vals[neg], False),
    }


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
    per_shard = {"count_intersect": popcount_rows(fw & gw), "count_row": popcount_rows(fw),
                 "count_3leaf": popcount_rows((fw & gw) | gw)}
    data["want_count"] = {k: int(v.sum()) for k, v in per_shard.items()}
    # the persist phase's nodes hold the first PERSIST_SHARDS shards
    data["want_count_persist"] = {k: int(v[:PERSIST_SHARDS].sum())
                                  for k, v in per_shard.items()}
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
    made_s = time.perf_counter() - t0
    idx = h.index_or_raise("bsi")
    opts = idx.field("v").options
    from pilosa_tpu_torch import interop
    for shard, planes in bsi_shard_planes(cols, vals, bsi_shards,
                                          idx.field("v").bsi_group.bit_depth):
        interop.load_bsi_planes(h, "bsi", "v", shard, planes, opts)
    idx.field("f").import_bits(np.ones(len(fpos), dtype=np.uint64),
                               fpos.astype(np.uint64))
    log(f"bsi index: {bsi_shards} shards, {n_cols} columns, {len(vals)} values in "
        f"[{BSI_MIN}, {BSI_MAX}) at depth {idx.field('v').bsi_group.bit_depth}, "
        f"filter of {len(fpos)} positions; made and loaded through interop in "
        f"{time.perf_counter() - t0:.3f} s (host; the values made in {made_s:.3f})")
    data["want_bsi"] = bsi_oracles(cols, vals, fpos)
    held = cols < PERSIST_SHARDS * SHARD_WIDTH
    data["want_bsi_persist"] = bsi_oracles(cols[held], vals[held], fpos)
    data["bsi_values"] = (cols, vals)  # for the import_values check; freed there
    data["distinct_values"] = (cols, vals, fpos)  # the keys phase's oracles
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

    # Field.import_values writes the same planes as the interop load, at
    # the full column space: BSI_IMPORT_SHARDS shards into a fresh field
    # (fresh view, 65,536+ values, under 1 GiB of planes: the native
    # scatter), then the rest (past the 1 GiB guard and no longer fresh:
    # per fragment, the device transpose where ``auto`` picks it). The BSI
    # path's run starts here: counters at 0 just before it.
    from pilosa_tpu_torch import native
    from pilosa_tpu_torch.exec import ingest_transpose

    shard_of = cols >> SHARD_WIDTH.bit_length() - 1
    vi = idx.create_field("vi", FieldOptions(type="int", min=BSI_MIN, max=BSI_MAX))
    cut = int(np.searchsorted(shard_of, BSI_IMPORT_SHARDS))
    scatters = []
    scatter = native.scatter_bsi_blocks
    native.scatter_bsi_blocks = lambda *a: scatters.append(a[4]) or scatter(*a)
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        vi.import_values(cols[:cut], vals[:cut])
        head_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vi.import_values(cols[cut:], vals[cut:])
        rest_s = time.perf_counter() - t0
    finally:
        native.scatter_bsi_blocks = scatter
    import_launches = kernels.LAUNCHES["plane_scatter"]
    rest_frags = n_shards - min(BSI_IMPORT_SHARDS, n_shards)
    per_frag = (len(cols) - cut) // max(1, rest_frags) * (depth + 2)
    crossover = ingest_transpose._min_size(h.device)
    log(f"Field.import_values: {cut} values of shards 0-{BSI_IMPORT_SHARDS - 1} into a "
        f"fresh field in {head_s:.3f} s (native scatter calls over shards: {scatters}); "
        f"{len(cols) - cut} values of {rest_frags} more shards per fragment in "
        f"{rest_s:.3f} s: mode {ingest_transpose.mode()}, crossover {crossover} "
        f"plane-bit writes against about {per_frag} a fragment, plane_scatter "
        f"launches {import_launches} (host clock)  [{card}]")
    if scatters != [min(BSI_IMPORT_SHARDS, n_shards)]:
        raise AssertionError(f"the fresh import took the native scatter {scatters}")
    if device == "cuda" and import_launches < 1:
        raise AssertionError("the per-fragment import never launched plane_scatter")
    for shard in range(n_shards):
        a = h.fragment("bsi", "v", "bsig_v", shard)
        b = h.fragment("bsi", "vi", "bsig_vi", shard)
        for r in range(2 + depth):
            if not np.array_equal(a.row_words(r), b.row_words(r)):
                raise AssertionError(f"import_values plane {r} of shard {shard} "
                                     "differs from the interop planes")
    log(f"Field.import_values: planes of all {n_shards} shards equal to the interop "
        "planes")
    idx.delete_field("vi")

    ex = Executor(h, planner=Planner(h), result_cache=False)
    launches, first_ms = {}, {}
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
        if path_launches["plane_scatter"] < 1:
            raise AssertionError("kernel plane_scatter was not launched on the BSI path")
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
    bsi_import_ab(idx, cols, vals, card)
    return {"launches": path_launches}


def bsi_import_ab(idx, cols, vals, card: str) -> None:
    """The values of the last BSI_AB_SHARDS shards imported into a fresh
    field under each mode of BSI_IMPORT_AB (PILOSA_TPU_INGEST_TRANSPOSE),
    on one host clock: past the native scatter's 1 GiB guard, so every
    fragment takes the device transpose under ``on`` and the host plane
    loop under ``off``. A record, not a claim."""
    from pilosa_tpu_torch.config import SHARD_WIDTH
    from pilosa_tpu_torch.core import FieldOptions
    from pilosa_tpu_torch.ops import kernels

    n_shards = int(cols.max()) // SHARD_WIDTH + 1
    held = cols >= (n_shards - BSI_AB_SHARDS) * SHARD_WIDTH
    cols, vals = cols[held], vals[held]

    old = os.environ.get("PILOSA_TPU_INGEST_TRANSPOSE")
    secs = {m: [] for m in BSI_IMPORT_AB}
    try:
        for mode in BSI_IMPORT_AB:
            os.environ["PILOSA_TPU_INGEST_TRANSPOSE"] = mode
            f = idx.create_field("vt", FieldOptions(type="int", min=BSI_MIN, max=BSI_MAX))
            before = kernels.LAUNCHES["plane_scatter"]
            t0 = time.perf_counter()
            f.import_values(cols, vals)
            secs[mode].append(time.perf_counter() - t0)
            n = kernels.LAUNCHES["plane_scatter"] - before
            idx.delete_field("vt")
            log(f"import of the last {BSI_AB_SHARDS} shards under {mode}: "
                f"{secs[mode][-1]:.3f} s, "
                f"{len(cols)} values, plane_scatter launches {n} (host clock)  [{card}]")
    finally:
        if old is None:
            os.environ.pop("PILOSA_TPU_INGEST_TRANSPOSE", None)
        else:
            os.environ["PILOSA_TPU_INGEST_TRANSPOSE"] = old
    log(f"import of the last {BSI_AB_SHARDS} shards, {' '.join(BSI_IMPORT_AB)}: "
        + ", ".join(f"{m} {statistics.median(v):.3f} s" for m, v in secs.items())
        + f" (median of each mode)  [{card}]")


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
    pairs = distinct(rows * n_cols + cols)
    checks = [("bench", f"Count(Row(j={r}))", int((pairs // n_cols == r).sum()))
              for r in range(4)]

    vcols = distinct(rng.integers(0, data["bsi_cols"], HTTP_IMPORT_N, dtype=np.int64))
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
            ("a resize abort with no job running", "/cluster/resize/abort", "", None,
             200)):
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
            for shard in sorted(s for s in view.fragments if s < PERSIST_SHARDS):
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
    held = sorted(s for s in view.fragments if s < PERSIST_SHARDS)
    for shard in held:
        frag = view.fragments[shard]
        planes = np.stack([frag.row_words(r) for r in range(2 + depth)])
        interop.load_bsi_planes(data["node_b"].holder, "bsi", "v", shard, planes,
                                fv.options)
        n_planes += len(planes)
    secs = time.perf_counter() - t0
    log(f"bsi planes in process: {n_planes} plane rows of {len(held)} "
        f"shards through interop.load_bsi_planes in {secs:.3f} s "
        f"({n_planes * planes.shape[1] * 4 / secs / 1e6:.3f} MB/s of words)")


def persist_queries(node_a, node_c, data: dict, card: str, runs: int,
                    label: str = "reopened") -> dict:
    """Every Count and BSI query over HTTP on the reopened node C (or the
    restored node D): equal to the oracle, byte-equal to node A's body, the
    same launches per request; then ``runs`` timed requests of each.
    Returns the launches of node C's serial run."""
    from pilosa_tpu_torch.ops import kernels

    ca, cc = http_client(node_a.port), http_client(node_c.port)
    wants = {"bench": data["want_count_persist"], "bsi": data["want_bsi_persist"]}
    queries = [(index, name, q, wants[index][name])
               for index, name, q, _ in http_queries(data) if index in wants]
    path = QUERY_PATH + "&shards=" + ",".join(map(str, range(PERSIST_SHARDS)))
    want_bodies, want_launches = {}, {}
    for index, name, q, _ in queries:
        (status, body), l_a = launches_of(
            lambda index=index, q=q: request(ca, "POST", path.format(index), q))
        if status != 200:
            raise AssertionError(f"node A {q}: HTTP {status} {body[:300]!r}")
        want_bodies[name], want_launches[name] = body, l_a
    first_ms = {}
    kernels.reset_launches()  # the persist path's run: node C's requests
    for index, name, q, want in queries:
        t0 = time.perf_counter()
        (status, body), l_c = launches_of(
            lambda index=index, q=q: request(cc, "POST", path.format(index), q))
        first_ms[name] = (time.perf_counter() - t0) * 1e3
        if status != 200 or json.loads(body)["results"] != [want]:
            raise AssertionError(f"{label} {q}: HTTP {status} {body[:300]!r}, "
                                 f"oracle {want}")
        if body != want_bodies[name]:
            raise AssertionError(f"{label} {q}: body {body[:200]!r} is not node A's "
                                 f"{want_bodies[name][:200]!r}")
        if l_c != want_launches[name]:
            raise AssertionError(f"{label} {q}: launches {l_c}, node A {want_launches[name]}")
        log(f"{label} HTTP {q} = oracle, body byte-equal to node A's, launches {l_c}")
    path_launches = dict(kernels.LAUNCHES)
    log(f"persist path launches ({label} node): {path_launches}")
    if data["device"] == "cuda":
        for k in HTTP_KERNELS:
            if path_launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the reloaded data")
    log(f"cold first request on the {label} node: {first_ms['count_intersect']:.3f} ms "
        f"(Count(Intersect), stacks rebuilt from reloaded host rows), "
        f"{first_ms['sum']:.3f} ms (Sum, the cube rebuilt)  [{card}]")
    log(f"{label} first-request ms per query: "
        f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")
    for index, name, q, _ in queries if runs else ():
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            status, _ = request(cc, "POST", path.format(index), q)
            times.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"{label} {q}: HTTP {status}")
        log(f"{label} HTTP {q}: {spread_ms(times)} ms over {runs} requests, "
            f"keep-alive loopback, client clock  [{card}]")
    ca.close()
    cc.close()
    return path_launches


#: the incremental backup's writes: columns of bench row BACKUP_SET_ROW
#: (a row no other check reads), one in each of a few shards.
BACKUP_SET_ROW = 99
BACKUP_SET_COLS = (5, 2**20 + 7, PERSIST_SHARDS // 2 * 2**20 + 31, PERSIST_SHARDS * 2**20 - 1)


def await_job(conn, path: str, what: str) -> dict:
    """Poll a backup or restore status route until its job ends; the
    finished status, which must be ``done``."""
    while True:
        st = json.loads(expect_ok(conn, "GET", path))
        if st.get("state") in ("done", "failed", "idle"):
            break
        time.sleep(0.2)
    if st.get("state") != "done":
        raise AssertionError(f"{what}: {st}")
    return st


def persist_backup(node_a, node_c, data: dict, card: str, root: Path) -> dict:
    """Backup and restore of the held eighth of the 1B columns
    (PERSIST_SHARDS): ``POST /backup`` of node C's data dir (``bench`` and
    ``bsi``) into a LocalDirArchive; four Sets on C and
    an incremental backup against the full one (it stores their WAL
    segments and refers to the full backup for every other file);
    ``backup-verify`` on the archive (both backups and the chain);
    ``POST /restore`` of the incremental into node D on a fresh data dir:
    every query on D equal to node A's, and the Sets read back. One
    restore of the chain stands for a restore of the full backup and then
    of the incremental, each of which rebuilds every fragment: the run has
    room for one. Returns node D's launches (its serial query run)."""
    from pilosa_tpu_torch import cli
    from pilosa_tpu_torch.server import ServerNode

    archive, restored = root / "archive", root / "restored"

    def backup(body: dict, what: str) -> tuple[str, dict]:
        # A connection of its own each time: an idle keep-alive connection
        # may be closed by the node while a long step runs.
        conn = http_client(node_c.port)
        t0 = time.perf_counter()
        bid = json.loads(expect_ok(conn, "POST", "/backup", body))["id"]
        st = await_job(conn, "/backup/status", what)
        conn.close()
        log(f"{what} {bid}: {st['totalFragments']} fragments, {st['files']} files "
            f"stored ({st['unchanged']} unchanged), {st['bytes']} bytes in "
            f"{time.perf_counter() - t0:.3f} s (client clock; the writer's "
            f"{st['seconds']} s); archive {dir_bytes(archive)} bytes on disk  [{card}]")
        return bid, st

    full_id, _ = backup({"archive": str(archive)}, "full backup")
    conn = http_client(node_c.port)
    for col in BACKUP_SET_COLS:
        expect_ok(conn, "POST", "/index/bench/query", f"Set({col}, f={BACKUP_SET_ROW})")
    conn.close()
    inc_id, st = backup({"archive": str(archive), "parent": full_id},
                        f"incremental backup after {len(BACKUP_SET_COLS)} Sets")
    if not 0 < st["files"] <= 2 * len(BACKUP_SET_COLS):
        raise AssertionError(f"the incremental backup stored {st['files']} files")

    t0 = time.perf_counter()
    rc = cli.main(["backup-verify", str(archive)])
    log(f"backup-verify {archive}: exit {rc} in {time.perf_counter() - t0:.3f} s  [{card}]")
    if rc != 0:
        raise AssertionError(f"backup-verify exited {rc}")

    t0 = time.perf_counter()
    node_d = data["node_d"] = ServerNode(bind="127.0.0.1:0", device=data["device"],
                                         data_dir=str(restored))
    node_d.open()
    conn = http_client(node_d.port)
    expect_ok(conn, "POST", "/restore", {"archive": str(archive), "id": inc_id})
    st = await_job(conn, "/restore/status", "restore")
    log(f"restore {inc_id} into node D: {st['totalFragments']} fragments, {st['bytes']} "
        f"archive bytes in {time.perf_counter() - t0:.3f} s (client clock, node boot "
        f"included; the job's {st['seconds']} s); data dir {dir_bytes(restored)} bytes "
        f"({dir_bytes(restored, '.wal')} in WALs)  [{card}]")
    launches = persist_queries(node_a, node_d, data, card, 0, label="restored")
    q = f"Count(Row(f={BACKUP_SET_ROW}))"
    got = json.loads(expect_ok(conn, "POST", QUERY_PATH.format("bench"), q))["results"]
    log(f"restored {q} = {got}: the {len(BACKUP_SET_COLS)} Sets read back  [{card}]")
    if got != [len(BACKUP_SET_COLS)]:
        raise AssertionError(f"restored {q}: {got}, want {len(BACKUP_SET_COLS)}")
    conn.close()
    t0 = time.perf_counter()
    node_d.close()
    del data["node_d"]
    log(f"node D close: {time.perf_counter() - t0:.3f} s  [{card}]")
    return launches


#: rows of the topn shard the persist phase writes, snapshots and reloads
#: (all 1,536 until the backup round trip joined the phase, 512 until the
#: elastic cluster joined the run: each cut keeps the whole run within its
#: time).
PERSIST_TOPN_ROWS = 256


def persist_topn_shard(node_a, root: Path, card: str) -> None:
    """The topn index is not persisted whole (1,536 dense rows x 10 shards
    of 8-byte snapshot positions, about 4 GB raw): PERSIST_TOPN_ROWS dense
    rows of one shard go through a store of their own, WAL, snapshot and
    reload, rows held equal."""
    from pilosa_tpu_torch import interop
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.storage import DiskStore

    frag = node_a.holder.fragment("topn", "f2", "standard", 0)
    ids = sorted(frag.rows)[:PERSIST_TOPN_ROWS]
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
    log(f"topn shard 0 ({len(ids)} rows, {sum(frag.rows[r].n for r in ids)} bits): "
        f"setRow WAL "
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
        local = distinct(rng.integers(0, SHARD_WIDTH, 3000).astype(np.uint64))
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
        restored = persist_backup(node_a, node_c, data, card, PERSIST_DIR)
        launches = {k: launches[k] + restored[k] for k in launches}
        node_c.close()
        del data["node_c"], node_c
        persist_topn_shard(node_a, PERSIST_DIR, card)
        persist_crash(PERSIST_DIR, device, card)
    finally:
        for k in ("node_b", "node_c", "node_d"):
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
PQL_TANIMOTO_RUNS = 3
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
    from pilosa_tpu_torch.config import WORDS_PER_SHARD
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
    # The stored row's count kernel, from the class the JAX planner gives
    # it under auto (pilosa_tpu/exec/residency.py:104-126), worked out here
    # apart from the port's policy: packed when the pow2 bucket of its
    # fullest shard's bits, at least 8, is at most W / 8 = 4096 entries.
    # At 5% x 5% a shard holds about 2,600 bits: bucket 4096, packed. The
    # cleared row (no bits, bucket 8) is packed too.
    bucket = 1 << (max(int(popcount_rows(fw & gw).max()), 8) - 1).bit_length()
    store_launches = {("packed_count" if bucket <= WORDS_PER_SHARD // 8
                       else "row_counts"): 1}
    cleared_launches = {"packed_count": 1}
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
    both("bench", "stored", "Count(Row(h=9))", want_store, store_launches)
    both("bench", "rows_h", "Rows(h)", {"rows": [3, 9]}, {})
    t0 = time.perf_counter()
    body, _ = over_http("bench", "ClearRow(h=9)")
    clear_ms = (time.perf_counter() - t0) * 1e3
    if json.loads(body)["results"] != [True]:
        raise AssertionError(f"ClearRow over HTTP: {body[:200]!r}")
    log(f"pql ClearRow(h=9) over HTTP: {clear_ms:.3f} ms over {n_shards} shards  [{card}]")
    both("bench", "cleared", "Count(Row(h=9))", 0, cleared_launches)

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
    data["sparse_pos"] = sparse_pos  # the packed phase's oracle
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
    # its stack resident). Residency is pinned off for them: under auto the
    # sparse row is a packed leaf, and the sparse upload serves dense leaves
    # only (the packed phase times the packed row's cold upload beside
    # these).
    residency.set_mode("off")
    try:
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
    finally:
        residency.set_mode("auto")
    data["cold_sparse"] = cold
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


# -- phase 10: packed residency: the sparse rows as [S, K] index stacks ------

#: the second packed row of f: PACKED_ROW_BITS bits a shard, the first
#: PACKED_SHARED of row 30's positions among them.
PACKED_ROW = 31
PACKED_ROW_BITS = 2000
PACKED_SHARED = 500
#: row 30's bits in shard 0 after the growth: K = 8192, past auto's 4096.
PACKED_GROWN_BITS = 5000
PACKED_KERNELS = ("packed_count", "packed_and_dense_count", "packed_pair_count",
                  "packed_expand", "packed_count_batched", "packed_and_dense_count_batched",
                  "packed_pair_count_batched")
#: a TopN filtered by the packed row 30: its filter plans anew each time.
PACKED_TOPN_QUERY = "TopN(g, Row(f=30), n=5)"
#: the rows of f the packed waves count: PACKED_WAVE_BITS bits a shard
#: each (K = 1024), drawn from a pool of 4 x that many positions a shard
#: (each row the same random quarter of the pool's indices in every
#: shard), so two rows share about a quarter of their bits.
PACKED_WAVE_ROWS = tuple(range(40, 48))
PACKED_WAVE_BITS = 1000
#: alternating rounds of each held wave, batched and slot by slot.
PACKED_WAVE_RUNS = 5
#: alternating rounds of the uncached plans naming row 30 (the TopN takes
#: about 0.2 s a run).
PACKED_UNCACHED_RUNS = 10


def packed_oracle_bits(words: np.ndarray, cols: np.ndarray, exp: int) -> np.ndarray:
    """numpy oracle: bit ``col`` of each column's shard row in ``words``
    ([shards, W] uint32), as 0/1."""
    local = cols & ((1 << exp) - 1)
    return (words[(cols >> exp).astype(np.int64), (local >> 5).astype(np.int64)]
            >> (local & 31).astype(np.uint32)) & 1


def sorted_overlap(a: np.ndarray, b: np.ndarray) -> int:
    """numpy oracle: the entries two sorted arrays of distinct values share
    (``len(np.intersect1d(a, b))``, by a search of b for each entry of a
    rather than a sort of both)."""
    if (np.diff(a) <= 0).any() or (np.diff(b) <= 0).any():
        raise ValueError("sorted_overlap takes sorted arrays of distinct values")
    if not len(b):
        return 0
    pos = np.minimum(np.searchsorted(b, a), len(b) - 1)
    return int((b[pos] == a).sum())


def phase_packed(torch, card: str, data: dict, runs: int = QUERY_RUNS) -> dict:
    """Packed residency at 1B columns on ``bench``, under the default
    ``auto``: the async phase's row f=30 (1000 bits a shard, K = 1024) and
    a row f=31 (2000 bits a shard, K = 2048, holding the first 500 of row
    30's positions in each shard) are packed [1024, K] index stacks. In
    process (``node.executor``) and over HTTP, each answer equal to a numpy
    oracle and each body byte-equal to the in-process JSON: Count(Row(f=30))
    is ONE ``packed_count``, its Intersect with the dense row f=1 (either
    order) ONE ``packed_and_dense_count``, with row 31 ONE
    ``packed_pair_count``; its Union with row 1 a ``packed_expand`` and a
    ``pair_count``, a 3-leaf Intersect a ``packed_expand`` and a
    ``tree_count``, and Row(f=30) a ``packed_expand``. Prints the resident
    bytes by class (``GET /debug/device``), each Count's p50 beside the
    same query on a planner with the knob off, and row 30's cold packed
    upload beside the async phase's cold sparse upload. Then row 30 grows
    to PACKED_GROWN_BITS bits in shard 0: its plan is dropped and its Count
    runs dense (ONE ``row_counts``).

    The waves: 8 rows of f (PACKED_WAVE_ROWS, K = 1024) imported, then one
    held wave of 8 different Counts on each packed fast path -- the bare
    rows, each row AND the dense row f=1, each row AND the next -- is ONE
    launch of its wave kernel, every answer equal to numpy, and the bare
    wave the same over HTTP (8 connections); each wave's wall time from
    the release to the last answer beside the same wave launched slot by
    slot (the planner's batched form withheld, as it was for packed
    Counts before the wave kernels), in alternating rounds."""
    from pilosa_tpu_torch.config import SHARD_WIDTH
    from pilosa_tpu_torch.exec import Executor, residency, result_to_json
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import Planner, coalesce

    device, node, h = data["device"], data["node"], data["holder"]
    ex = node.executor
    planner = ex.planner
    n_shards = data["count_shards"]
    exp = SHARD_WIDTH.bit_length() - 1
    rng = np.random.default_rng(SEED + 7)
    t0 = time.perf_counter()
    p30 = data.pop("sparse_pos")  # each shard's positions sorted, shards ascending
    per_shard = len(p30) // n_shards
    p31 = []
    for s in range(n_shards):
        local = p30[s * per_shard:(s + 1) * per_shard] - np.uint64(s << exp)
        extra = sorted_sample(rng, PACKED_ROW_BITS - PACKED_SHARED, SHARD_WIDTH,
                              local.astype(np.int64))
        p31.append(np.union1d(local[:PACKED_SHARED], extra.astype(np.uint64))
                   + np.uint64(s << exp))
    p31 = np.concatenate(p31)
    h.field("bench", "f").import_bits(np.full(len(p31), PACKED_ROW, dtype=np.uint64), p31)
    fw = np.stack([h.fragment("bench", "f", "standard", s).row_words(1)
                   for s in range(n_shards)])
    gw = np.stack([h.fragment("bench", "g", "standard", s).row_words(2)
                   for s in range(n_shards)])
    in_f1 = packed_oracle_bits(fw, p30, exp)
    in_g2 = packed_oracle_bits(gw, p30, exp)
    del gw
    # Each shard's pool: 4 x PACKED_WAVE_BITS distinct positions, sorted
    # (the first of a sorted draw's distinct values).
    draw = np.sort(rng.integers(0, SHARD_WIDTH, (n_shards, 4 * PACKED_WAVE_BITS + 512)), axis=1)
    first = np.argsort(np.diff(draw, axis=1, prepend=-1) == 0, axis=1, kind="stable")
    pool = np.take_along_axis(draw, first[:, :4 * PACKED_WAVE_BITS], axis=1)
    if (np.diff(pool, axis=1) <= 0).any():
        raise AssertionError("packed wave rows: a shard's pool is not distinct")
    shard_base = (np.arange(n_shards, dtype=np.int64) << exp)[:, None]
    wave_pos = [(pool[:, np.sort(rng.permutation(pool.shape[1])[:PACKED_WAVE_BITS])]
                 + shard_base).ravel().astype(np.uint64) for _ in PACKED_WAVE_ROWS]
    del draw, first, pool
    t_import = time.perf_counter()
    h.field("bench", "f").import_bits(
        np.repeat(np.asarray(PACKED_WAVE_ROWS, dtype=np.uint64), len(wave_pos[0])),
        np.concatenate(wave_pos))
    import_s = time.perf_counter() - t_import
    nxt = {r: PACKED_WAVE_ROWS[(i + 1) % len(PACKED_WAVE_ROWS)]
           for i, r in enumerate(PACKED_WAVE_ROWS)}
    pos_of = dict(zip(PACKED_WAVE_ROWS, wave_pos))
    #: path -> (wave kernel, {query: numpy count})
    wave_want = {
        "bare": ("packed_count_batched",
                 {f"Count(Row(f={r}))": len(pos_of[r]) for r in PACKED_WAVE_ROWS}),
        "and_dense": ("packed_and_dense_count_batched",
                      {f"Count(Intersect(Row(f={r}), Row(f=1)))":
                       int(packed_oracle_bits(fw, pos_of[r], exp).sum())
                       for r in PACKED_WAVE_ROWS}),
        "pair": ("packed_pair_count_batched",
                 {f"Count(Intersect(Row(f={r}), Row(f={nxt[r]})))":
                  sorted_overlap(pos_of[r], pos_of[nxt[r]]) for r in PACKED_WAVE_ROWS}),
    }
    del fw, wave_pos, pos_of
    and_1 = int(in_f1.sum())
    want = {"count30": len(p30), "and_1": and_1, "and_1_rev": and_1,
            "and_31": sorted_overlap(p30, p31),
            "union_1": data["want_count"]["count_row"] + len(p30) - and_1,
            "and3": int((in_f1 & in_g2).sum())}
    queries = {"count30": "Count(Row(f=30))",
               "and_1": "Count(Intersect(Row(f=30), Row(f=1)))",
               "and_1_rev": "Count(Intersect(Row(f=1), Row(f=30)))",
               "and_31": f"Count(Intersect(Row(f=30), Row(f={PACKED_ROW})))",
               "union_1": "Count(Union(Row(f=30), Row(f=1)))",
               "and3": "Count(Intersect(Row(f=30), Row(f=1), Row(g=2)))"}
    expected = {"count30": {"packed_count": 1}, "and_1": {"packed_and_dense_count": 1},
                "and_1_rev": {"packed_and_dense_count": 1},
                "and_31": {"packed_pair_count": 1},
                "union_1": {"packed_expand": 1, "pair_count": 1},
                "and3": {"packed_expand": 1, "tree_count": 1}}
    log(f"packed set-up: row f={PACKED_ROW}, {PACKED_ROW_BITS} bits a shard ({PACKED_SHARED} "
        f"of row 30's), oracles in {time.perf_counter() - t0:.3f} s (host); rows "
        f"f={PACKED_WAVE_ROWS[0]}..{PACKED_WAVE_ROWS[-1]}, {PACKED_WAVE_BITS} bits a shard "
        f"each, imported in {import_s:.3f} s (host)")
    conn = http_client(node.port)

    def launched(before):
        return {k: kernels.LAUNCHES[k] - before[k] for k in before
                if kernels.LAUNCHES[k] != before[k]}

    def inproc(q):
        before = dict(kernels.LAUNCHES)
        results = ex.execute("bench", q, cache=False)
        body = (json.dumps({"results": [result_to_json(r) for r in results]})
                + "\n").encode()
        return body, launched(before)

    def over_http(q):
        before = dict(kernels.LAUNCHES)
        status, body = request(conn, "POST", QUERY_PATH.format("bench"), q)
        if status != 200:
            raise AssertionError(f"{q}: HTTP {status} {body[:300]!r}")
        return body, launched(before)

    def both(q, check, launches):
        """q in process (twice) and over HTTP: ``check`` of the results,
        byte-equal bodies, the expected launches each time (on the card)."""
        body, l_first = inproc(q)
        check(json.loads(body)["results"])
        hbody, l_http = over_http(q)
        body2, l_in = inproc(q)
        if hbody != body or body2 != body:
            raise AssertionError(f"{q}: HTTP body {hbody[:200]!r}, again "
                                 f"{body2[:200]!r}, in process {body[:200]!r}")
        if device == "cuda" and not l_first == l_http == l_in == launches:
            raise AssertionError(f"{q}: launched {l_first} first, {l_http} over HTTP, "
                                 f"{l_in} again; expected {launches}")
        return l_in

    # The packed path's run: counters at 0 just before, read just after.
    kernels.reset_launches()
    p50 = {}
    try:
        for name, q in queries.items():
            def check(got, name=name, q=q):
                if got != [want[name]]:
                    raise AssertionError(f"{q}: {got}, numpy oracle {want[name]}")
            l_in = both(q, check, expected[name])
            log(f"packed {q} = oracle, HTTP body byte-equal, launches {l_in}  [{card}]")

        def check_row(got):
            cols = np.asarray(got[0]["columns"], dtype=np.uint64)
            if not np.array_equal(cols, p30):
                raise AssertionError(f"Row(f=30): {len(cols)} columns, numpy {len(p30)}")
        l_in = both("Row(f=30)", check_row, {"packed_expand": 1})
        log(f"packed Row(f=30): {len(p30)} columns = oracle, HTTP body byte-equal, "
            f"launches {l_in}  [{card}]")

        # The resident bytes by class: the node's planner, and each row's stack.
        doc = json.loads(expect_ok(conn, "GET", "/debug/device"))
        by_row = {}
        with planner._cache_lock:
            for key, ent in planner._stack_cache.items():
                if key[0] == "bench" and key[2] == "f" and key[4] in (1, 30, PACKED_ROW):
                    by_row[(key[4], key[6])] = (residency.stack_nbytes(ent[2]),
                                                tuple(ent[2].shape))
        if by_row.get((30, residency.PACKED), (0, ()))[1] != (planner._pad(n_shards), 1024) \
                or (PACKED_ROW, residency.PACKED) not in by_row \
                or (1, residency.DENSE) not in by_row or not doc["class_bytes"]["packed"]:
            raise AssertionError(f"stacks by (row, class): {by_row}; class_bytes "
                                 f"{doc['class_bytes']}")
        log(f"packed residency: /debug/device class_bytes {doc['class_bytes']}; stacks "
            f"(row, class) -> (bytes, shape): {by_row}  [{card}]")

        # A held wave of 8 different Counts on each packed fast path: ONE
        # launch of its wave kernel (off the card: one dispatch). Each
        # query runs once first (its plan and stacks, one single kernel).
        co = planner.coalescer
        for path, (kern, table) in wave_want.items():
            for q, w in table.items():
                body, l_in = inproc(q)
                if json.loads(body)["results"] != [w]:
                    raise AssertionError(f"{q}: {body[:200]!r}, numpy oracle {w}")
        conns = [http_client(node.port) for _ in PACKED_WAVE_ROWS]

        def over(conn, q):
            status, body = request(conn, "POST", QUERY_PATH.format("bench"), q)
            if status != 200:
                raise AssertionError(f"{q}: HTTP {status} {body[:300]!r}")
            return json.loads(body)["results"]

        def slot_by_slot(fn, _batched=planner.fn_batched):
            return None if getattr(fn, "packed", False) else _batched(fn)

        coalesce.set_mode("on")
        try:
            wave_ms, wave_got = {}, {}
            for path, (kern, table) in wave_want.items():
                qs, want_w = list(table), [[w] for w in table.values()]
                sides = {"wave": ({kern: 1}, 1), "slot by slot": (
                    {kern.removesuffix("_batched"): len(qs)}, len(qs))}
                for rep_i in range(PACKED_WAVE_RUNS):
                    for side in sides if rep_i % 2 == 0 else list(sides)[::-1]:
                        if side == "slot by slot":
                            planner.fn_batched = slot_by_slot
                        try:
                            got, dispatched, answers, ms = wave(
                                co, kernels, len(qs),
                                lambda k, qs=qs: ex.execute("bench", qs[k], cache=False))
                        finally:
                            planner.__dict__.pop("fn_batched", None)
                        launches, n_dispatch = sides[side]
                        if (answers != want_w or dispatched != n_dispatch
                                or (device == "cuda" and got != launches)):
                            raise AssertionError(f"packed {path} wave, {side}: launches "
                                                 f"{got}, {dispatched} dispatches, answers "
                                                 f"{answers}, numpy {want_w}")
                        wave_ms.setdefault((path, side), []).append(ms)
                        wave_got[side] = got
                log(f"packed {path} wave: 8 different Counts ({qs[0]}, ...) -> launches "
                    f"{wave_got['wave']} (slot by slot {wave_got['slot by slot']}), every "
                    f"answer = numpy; release to last answer, "
                    f"{PACKED_WAVE_RUNS} alternating rounds: one wave launch "
                    f"{spread_ms(wave_ms[(path, 'wave')])} ms; slot by slot (8 launches) "
                    f"{spread_ms(wave_ms[(path, 'slot by slot')])} ms  [{card}]")
            kern, table = wave_want["bare"]
            qs, want_w = list(table), [[w] for w in table.values()]
            got, dispatched, answers, ms = wave(
                co, kernels, len(qs), lambda k: over(conns[k], qs[k]))
            if answers != want_w or dispatched != 1 or (device == "cuda"
                                                        and got != {kern: 1}):
                raise AssertionError(f"packed bare wave over HTTP: launches {got}, "
                                     f"{dispatched} dispatches, answers {answers}")
            log(f"packed bare wave over HTTP (8 connections): launches {got}, every body "
                f"= numpy, {ms:.3f} ms from release to the last answer  [{card}]")
        finally:
            coalesce.set_mode("auto")
            for c in conns:
                c.close()

        # Each Count's p50 under auto beside the same query with the knob
        # off: two executors of one make, each on a planner of its own (a
        # plan bakes its leaves' classes in), timed in alternation.
        sides = {}
        for mode in ("auto", "off"):
            residency.set_mode(mode)
            sides[mode] = Executor(h, planner=Planner(h), result_cache=False)
        times = {(name, mode): [] for name in queries for mode in sides}
        try:
            for rep_i in range(runs + 1):
                for name, q in queries.items():
                    for mode, side in sides.items():
                        residency.set_mode(mode)
                        t0 = time.perf_counter()
                        (got,) = side.execute("bench", q, cache=False)
                        ms = (time.perf_counter() - t0) * 1e3
                        if got != want[name]:
                            raise AssertionError(f"{q} with residency {mode}: {got}, "
                                                 f"numpy {want[name]}")
                        if rep_i:  # the first round plans and uploads
                            times[(name, mode)].append(ms)
        finally:
            residency.set_mode("auto")
            for side in sides.values():
                side.planner.close()
        del sides
        for name, q in queries.items():
            p50[name] = {mode: statistics.median(times[(name, mode)])
                         for mode in ("auto", "off")}
            log(f"packed {q} in process, {runs} alternating runs each: packed (auto) "
                f"{spread_ms(times[(name, 'auto')])} ms; dense (off) "
                f"{spread_ms(times[(name, 'off')])} ms  [{card}]")

        # The uncached plans that name row 30: Row(f=30) as a bitmap and a
        # TopN filtered by it. Under auto each plans anew (a shard walk
        # for the leaf's class) and expands the packed row into a fresh
        # plane; under off it reads the cached dense stack. Timed to the
        # card's idle (the bitmap's segments are device slices), auto
        # against off in alternation; the walk alone is timed beside them.
        uncached = {"row30": "Row(f=30)", "topn30": PACKED_TOPN_QUERY}
        sides = {}
        for mode in ("auto", "off"):
            residency.set_mode(mode)
            sides[mode] = Executor(h, planner=Planner(h), result_cache=False)
        utimes = {(name, mode): [] for name in uncached for mode in sides}
        answers = {}
        u_runs = min(runs, PACKED_UNCACHED_RUNS)
        try:
            for rep_i in range(u_runs + 1):
                for name, q in uncached.items():
                    for mode, side in sides.items():
                        residency.set_mode(mode)
                        t0 = time.perf_counter()
                        (got,) = side.execute("bench", q, cache=False)
                        if device == "cuda":
                            torch.cuda.synchronize()
                        ms = (time.perf_counter() - t0) * 1e3
                        if rep_i:
                            utimes[(name, mode)].append(ms)
                        else:
                            answers[(name, mode)] = result_to_json(got)
            residency.set_mode("auto")
            bench = h.index("bench")
            shard_t = tuple(range(n_shards))
            walk = []
            for _ in range(runs):
                t0 = time.perf_counter()
                klass = planner._leaf_class(bench, "f", "standard", 30, shard_t)
                walk.append((time.perf_counter() - t0) * 1e3)
            if klass != residency.PACKED:
                raise AssertionError(f"row 30's leaf class under auto: {klass}")
        finally:
            residency.set_mode("auto")
            for side in sides.values():
                side.planner.close()
        del sides
        if not np.array_equal(np.asarray(answers[("row30", "auto")]["columns"],
                                         dtype=np.uint64), p30) \
                or answers[("row30", "off")] != answers[("row30", "auto")] \
                or answers[("topn30", "off")] != answers[("topn30", "auto")]:
            raise AssertionError(f"uncached row 30 plans: auto and off disagree or "
                                 f"miss numpy: TopN {answers[('topn30', 'auto')]} / "
                                 f"{answers[('topn30', 'off')]}")
        for name, q in uncached.items():
            p50[name] = {mode: statistics.median(utimes[(name, mode)])
                         for mode in ("auto", "off")}
            log(f"packed {q} in process to the card's idle, {u_runs} alternating runs each: "
                f"packed (auto) {spread_ms(utimes[(name, 'auto')])} ms; dense (off) "
                f"{spread_ms(utimes[(name, 'off')])} ms  [{card}]")
        log(f"packed leaf class of row 30 ({klass}), the walk of {n_shards} fragments on "
            f"the host: {spread_ms(walk)} ms; one packed_expand on the card: see the "
            f"kernels line  [{card}]")

        # Row 30's cold packed upload, beside the async phase's cold sparse
        # (dense-class) upload of the same row.
        samples = []
        for _ in range(COLD_SAMPLES):
            cold = Planner(h)
            cex = Executor(h, planner=cold, result_cache=False)
            try:
                before = dict(kernels.LAUNCHES)
                t0 = time.perf_counter()
                (got,) = cex.execute("bench", queries["count30"], cache=False)
                ms = (time.perf_counter() - t0) * 1e3
                delta = launched(before)
                if got != want["count30"] or (device == "cuda"
                                              and delta != {"packed_count": 1}):
                    raise AssertionError(f"cold packed Count(Row(f=30)): {got}, launches "
                                         f"{delta}")
                split = cold.upload_split_ms()
                samples.append((ms, cold.h2d_bytes, split))
            finally:
                cold.close()
        median = {k: statistics.median(x[2][k] for x in samples) for k in samples[0][2]}
        sparse = data["cold_sparse"][ASYNC_SPARSE_ROW]
        log(f"cold packed Count(Row(f=30)): median {statistics.median(x[0] for x in samples):.3f}"
            f" ms of {COLD_SAMPLES} ({', '.join(f'{x[0]:.3f}' for x in samples)}), "
            f"{samples[0][1]} bytes host to device, split (ms): "
            f"{', '.join(f'{k} {v:.3f}' for k, v in median.items())}; the cold sparse "
            f"upload with residency off: {sparse[0]:.3f} ms, {sparse[1]} bytes  [{card}]")

        # Row 30 outgrows the packed class in shard 0: its plan is dropped at
        # the next Count, which runs dense.
        local0 = p30[:per_shard].astype(np.int64)
        grow = sorted_sample(rng, PACKED_GROWN_BITS - per_shard, SHARD_WIDTH, local0)
        h.field("bench", "f").import_bits(np.full(len(grow), 30, dtype=np.uint64),
                                          grow.astype(np.uint64))
        grown = len(p30) + len(grow)

        def check_grown(got):
            if got != [grown]:
                raise AssertionError(f"Count(Row(f=30)) grown: {got}, numpy {grown}")
        body, l_first = inproc(queries["count30"])
        check_grown(json.loads(body)["results"])
        l_first = {k: v for k, v in l_first.items() if k != "assemble_stack"}
        l_in = both(queries["count30"], check_grown, {"row_counts": 1})
        leaves = [hit[0] for key, hit in planner._plan_cache.items()
                  if key[0] == "bench" and key[3] == "Row(f=30)"]
        if device == "cuda" and l_first != {"row_counts": 1}:
            raise AssertionError(f"grown Count(Row(f=30)) launched {l_first}")
        if leaves != [[("row", "f", "standard", 30)]]:
            raise AssertionError(f"grown Count(Row(f=30)) planned {leaves}")
        log(f"packed revalidation: row 30 at {PACKED_GROWN_BITS} bits in shard 0 "
            f"(K {residency.pack_width(PACKED_GROWN_BITS)}): plan dropped, Count = oracle "
            f"{grown} dense, launches {l_in}  [{card}]")
    finally:
        residency.set_mode("auto")
        conn.close()
    launches = dict(kernels.LAUNCHES)
    log(f"packed path launches: {launches}")
    if device == "cuda":
        for k in PACKED_KERNELS:
            if launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the packed path")
    return {"launches": launches, "p50": p50}


# -- phase 10: time, mutex and bool fields, MinRow/MaxRow, GroupBy ------------

#: bench config 4's time field, scaled from 8M to 1B columns (then halved
#: when the elastic cluster joined the run): 5M bits in rows 0-2, stamped
#: on the hour, uniform over 30 days from 2019-01-15
#: (hour FIELDS_TIME_FIRST_HOUR of 2019), the first half of WINDOWS' span.
#: Bench config 4 spreads them over 90 days; the 30 days before the
#: windows were cut to keep the whole run within its time (they added 700K
#: fragments and about 40 s of host import, and no query read them), and
#: the windows' last 30 days when the elastic cluster joined the run.
#: The bits fall in the first FIELDS_TIME_SHARDS shards (a 24th of the 1B
#: columns: a 24th of the fragments, which set the import's cost), cut to
#: an eighth to make room for the keys phase, then to a 24th for the
#: cluster phase; the windows' Counts still run over all 954 shards. (A
#: 48th was tried on the card: its import took as long and the phase 20 s
#: longer, its windows' Counts slower.)
FIELDS_TIME_BITS = 5_000_000
FIELDS_TIME_SHARDS = 40
FIELDS_TIME_ROWS = 3
FIELDS_TIME_FIRST_HOUR = 14 * 24
FIELDS_TIME_HOURS = 24 * 30
#: bench config 5's GroupBy fields at its density (1.5%), at 1B columns.
FIELDS_SET_BITS = 15_000_000
FIELDS_SET_ROWS = {"a": 4, "b": 8, "c": 3}
#: the mutex field: 16 rows over 6.25M columns, then 1.25M of them moved
#: (50M and 10M until the backup round trip joined the persist phase,
#: 25M and 5M until the keys phase joined the run, 12.5M and 2.5M until
#: the elastic cluster did: halved each time to keep the whole run within
#: its time; rows stay in the packed class).
FIELDS_MUTEX_ROWS = 16
FIELDS_MUTEX_COLS = 6_250_000
FIELDS_MUTEX_MOVED = 1_250_000
#: the bool field: 10M columns, true or false (20M until the keys phase
#: joined the run; at 5M its rows would fall into the packed class).
FIELDS_BOOL_COLS = 10_000_000
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
    key = distinct(cols.astype(np.int64) * n_rows + rows.astype(np.int64))
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

    # The time field: FIELDS_TIME_BITS bits, rows 0-2, hourly stamps over
    # FIELDS_TIME_HOURS, in the first FIELDS_TIME_SHARDS shards.
    t0 = time.perf_counter()
    t_cols = rng.integers(0, min(n_cols, FIELDS_TIME_SHARDS * SHARD_WIDTH),
                          FIELDS_TIME_BITS, dtype=np.uint64)
    t_rows = rng.integers(0, FIELDS_TIME_ROWS, FIELDS_TIME_BITS).astype(np.uint64)
    t_hours = FIELDS_TIME_FIRST_HOUR + rng.integers(0, FIELDS_TIME_HOURS, FIELDS_TIME_BITS)
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
    want_http = len(distinct(http_cols[http_hours >= 31 * 24]))

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
        in_window = distinct(t_cols[sel])
        want[f"time{key}"] = len(in_window)
        if key == "32":
            want["time_and"] = int(in_g2(in_window).sum())
            rows = set(distinct(t_rows[(t_hours >= lo_h) & (t_hours < hi_h)]).tolist())
            if ((http_hours >= lo_h) & (http_hours < hi_h)).any():
                rows.add(7)
            want["time_rows"] = {"rows": sorted(int(r) for r in rows)}
    a_cols, a_rows = pairs["a"]
    b_cols, b_rows_ = pairs["b"]
    c_cols, c_rows = pairs["c"]
    data["similar_pairs"] = (pairs["a"], pairs["b"])  # the keys phase's SimilarTopN
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
    # planes and group_count splits the lattice into many units:
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


# -- phase 12: keys and sketches ---------------------------------------------

#: Count(Distinct) on bsi's v (bench config 3: 20M values over 1B columns)
#: at the default precision, filtered by the 5M-bit row, at precision 16,
#: and with a threshold the filtered estimate falls under (the exact leg).
DISTINCT_QUERIES = {
    "distinct": "Count(Distinct(field=v))",
    "distinct_filtered": "Count(Distinct(Row(f=1), field=v))",
    "distinct_p16": "Count(Distinct(field=v, precision=16))",
    "distinct_exact": "Count(Distinct(Row(f=1), field=v, threshold=200000))",
}
#: the first shards a variant asks (a cold first call builds each shard's
#: planes on the host): precision 16 and the exact leg, each a cut of the
#: default-precision runs over all 954 shards.
DISTINCT_SHARDS = {"distinct_p16": 96, "distinct_exact": 96}
#: SimilarTopN on bench's b (the fields phase's 8 rows over 1B columns:
#: an [8, 1024, 32768] cube, 1 GiB, SIM_CUBE_MAX_BYTES), both metrics.
SIMILAR_QUERIES = {
    "similar_jaccard": ("SimilarTopN(b, Row(a=1), n=5)", "jaccard"),
    "similar_overlap": ("SimilarTopN(b, Row(a=1), n=5, metric=overlap)", "overlap"),
}
#: the keyed index: 500,000 column keys (1,000,000 until the cluster
#: phase's backup and restore came in), 1,024 row keys, one row a column,
#: imported over HTTP by keys in batches.
KEYS_COLS = 500_000
KEYS_ROWS = 1024
KEYS_BATCH = 100_000
#: row keys of the keyed Union (a batch past the key plane's auto
#: threshold of 256).
KEYS_UNION = 300
KEYS_RUNS = 5
#: the keys phase planner's budget: the [1024, 2^20] hll plane stack
#: (4 GiB) beside its filter and the SimilarTopN cube and rows.
KEYS_STACK_BYTES = 12 << 30
KEYS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_keys"
KEYS_KERNELS = ("hll_expand", "hll_reduce", "similar_count", "plane_lookup")


def distinct_oracle(stored: np.ndarray, p: int, threshold: int) -> int:
    """Count(Distinct) of base-relative values: the estimate of the
    registers ``sketch_values`` folds from them (the planes' registers
    are the same), or the exact count under the threshold."""
    from pilosa_tpu_torch.sketch import hll

    est = hll.sketch_values(stored, p).estimate()
    if threshold and est < threshold:
        return int(len(distinct(stored)))
    return int(round(est))


def similar_oracle(a_pairs, b_pairs, a_row: int, n: int, metric: str) -> list:
    """SimilarTopN's pairs from the (column, row) pairs of a and b: each b
    row's overlap with a's row and its size, ranked by score, then overlap,
    then row id."""
    a_cols, a_rows = a_pairs
    b_cols, b_rows = b_pairs
    filt = distinct(a_cols[a_rows == a_row])
    ids = distinct(b_rows)
    hit = np.isin(b_cols, filt)
    overlap = np.array([int((hit & (b_rows == r)).sum()) for r in ids])
    selfcnt = np.array([int((b_rows == r).sum()) for r in ids])
    keep = overlap > 0
    ids, overlap, selfcnt = ids[keep], overlap[keep], selfcnt[keep]
    if metric == "jaccard":
        score = overlap / (selfcnt + len(filt) - overlap)
    else:
        score = overlap.astype(np.float64)
    order = np.lexsort((ids, -overlap, -score))[:n]
    return [{"id": int(ids[i]), "count": int(overlap[i])} for i in order]


def keyed_data(seed: int):
    """Each column key's row: the first KEYS_ROWS columns take rows 0..1023
    in order (so row key r{j} gets id j + 1), the rest random."""
    rows = np.random.default_rng(seed).integers(0, KEYS_ROWS, KEYS_COLS)
    rows[:KEYS_ROWS] = np.arange(KEYS_ROWS)
    return rows


def keyed_queries(rows: np.ndarray) -> dict:
    """name -> (PQL, oracle result) over the keyed index, from the id map:
    column key c{i} is id i + 1, row key r{j} id j + 1."""
    def row_json(j):
        cols = np.flatnonzero(rows == j)
        return {"attrs": {}, "columns": (cols + 1).tolist(), "keys": [f"c{i}" for i in cols]}

    counts = np.bincount(rows, minlength=KEYS_ROWS)
    top = np.lexsort((np.arange(KEYS_ROWS), -counts))[:10]
    union = ", ".join(f'Row(kf="r{j}")' for j in range(KEYS_UNION))
    return {
        "keyed_row": ('Row(kf="r5")', row_json(5)),
        "keyed_count": ('Count(Row(kf="r1000"))', int(counts[1000])),
        "keyed_topn": ("TopN(kf, n=10)", [{"id": int(j) + 1, "count": int(counts[j]),
                                          "key": f"r{j}"} for j in top]),
        "keyed_union": (f"Count(Union({union}))", int((rows < KEYS_UNION).sum())),
    }


def keyed_node(torch, device: str, path: Path):
    from pilosa_tpu_torch.server import ServerNode

    node = ServerNode(bind="127.0.0.1:0", device=device, data_dir=str(path),
                      compile_cache_dir="off")
    node.open()
    return node


def keyed_bodies(node, queries: dict) -> dict:
    """name -> the body of each keyed query over HTTP on ``node``."""
    conn = http_client(node.port)
    out = {name: expect_ok(conn, "POST", QUERY_PATH.format("keyed"), q)
           for name, (q, _) in queries.items()}
    conn.close()
    return out


def phase_keys(torch, card: str, data: dict, runs: int = KEYS_RUNS) -> dict:
    """Keys and sketches at full width. In process on a planner whose
    budget holds the 4 GiB hll plane stack: Count(Distinct) on bench config
    3's v (DISTINCT_QUERIES: the hll_reduce of the register stack; the
    filtered form ONE hll_expand and ONE hll_reduce; precision 16; the
    exact leg under a threshold), SimilarTopN on bench's 8-row b (ONE
    similar_count over a 1 GiB cube), each equal to its numpy oracle and
    (but the exact leg, a host walk of every shard asked once in process)
    over HTTP to the in-process JSON. Then a keyed index on a node with a
    data dir: 500,000 column keys and 1,024 row keys imported over HTTP by keys;
    keyed Row, Count and TopN bodies equal the oracle built from the id
    map; a Union of 300 keyed rows under ``auto`` is ONE plane_lookup once
    the plane is built (``/debug/translate`` shows it); the bodies equal
    after close and reopen, and after a backup restored into a fresh dir."""
    from pilosa_tpu_torch.exec import Executor, result_to_json
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import Planner

    device, node, h = data["device"], data["node"], data["holder"]
    cols, vals, fpos = data.pop("distinct_values")
    base = h.field("bsi", "v").bsi_group.base
    stored = vals - base
    in_f = np.isin(cols, fpos)
    from pilosa_tpu_torch.config import SHARD_WIDTH
    cut = {name: cols < n * SHARD_WIDTH for name, n in DISTINCT_SHARDS.items()}
    want = {"distinct": distinct_oracle(stored, 12, 1024),
            "distinct_filtered": distinct_oracle(stored[in_f], 12, 1024),
            "distinct_p16": distinct_oracle(stored[cut["distinct_p16"]], 16, 1024),
            "distinct_exact": distinct_oracle(stored[in_f & cut["distinct_exact"]], 12,
                                              200000)}
    a_pairs, b_pairs = data.pop("similar_pairs")
    for name, (_, metric) in SIMILAR_QUERIES.items():
        want[name] = similar_oracle(a_pairs, b_pairs, 1, 5, metric)
    del cols, vals, fpos, stored, in_f, cut, a_pairs, b_pairs
    planner = Planner(h, max_cache_bytes=KEYS_STACK_BYTES)
    ex = Executor(h, planner=planner)
    node_planner = node.executor.planner
    budget = node_planner.max_cache_bytes
    node_planner.max_cache_bytes = KEYS_STACK_BYTES
    kernels.reset_launches()
    per_query = {}
    conn = http_client(node.port)
    try:
        for name, q in {**DISTINCT_QUERIES,
                        **{k: q for k, (q, _) in SIMILAR_QUERIES.items()}}.items():
            index = "bsi" if name.startswith("distinct") else "bench"
            shards = (list(range(DISTINCT_SHARDS[name])) if name in DISTINCT_SHARDS
                      else None)
            path = QUERY_PATH.format(index) + (
                "&shards=" + ",".join(map(str, shards)) if shards else "")
            t0 = time.perf_counter()
            got, launched = launches_of(lambda: result_to_json(
                ex.execute(index, q, shards=shards, cache=False))[0])
            first = (time.perf_counter() - t0) * 1e3
            if got != want[name]:
                raise AssertionError(f"{q}: {got}, oracle {want[name]}")
            per_query[name] = {k: v for k, v in launched.items() if v}
            over = f" over shards 0-{len(shards) - 1}" if shards else ""
            if name == "distinct_exact":
                # Its exact leg walks every shard asked on the host: asked
                # once, in process.
                log(f"keys {q}{over} = {json.dumps(got)} (oracle equal); first {first:.3f} "
                    f"ms, launches {per_query[name]}  [{card}]")
                continue
            body = expect_ok(conn, "POST", path, q)
            if json.loads(body)["results"] != [got]:
                raise AssertionError(f"HTTP {q}: {body[:300]!r}, in process {got}")
            p50, spread = p50_ms(lambda: ex.execute(index, q, shards=shards, cache=False),
                                 runs)
            http_p50, http_spread = p50_ms(lambda: expect_ok(conn, "POST", path, q), runs)
            log(f"keys {q}{over} = {json.dumps(got)} (oracle equal, HTTP body equal); first "
                f"{first:.3f} ms, launches {per_query[name]}; p50 in process {p50:.4f} ms "
                f"({spread}), HTTP p50 {http_p50:.4f} ({http_spread}) ms over {runs} runs  "
                f"[{card}]")
        for name, kernel in (("distinct", "hll_reduce"), ("distinct_filtered", "hll_expand"),
                             ("similar_jaccard", "similar_count")):
            if device == "cuda" and per_query[name].get(kernel) != 1:
                raise AssertionError(f"{name}: launches {per_query[name]}, want ONE {kernel}")
        stats = planner.cache_stats()
        log(f"keys planner: resident bytes by class {stats['class_bytes']}, budget "
            f"{stats['budget_bytes'] / 2**30:.3f} GiB; hll class "
            f"{stats['class_bytes']['hll']} bytes")
    finally:
        conn.close()
        node_planner.max_cache_bytes = budget
        planner.close()
        del ex, planner
        if device == "cuda":
            torch.cuda.empty_cache()

    rows = keyed_data(SEED + 5)
    queries = keyed_queries(rows)
    shutil.rmtree(KEYS_DIR, ignore_errors=True)
    nodes = []
    try:
        node_k = keyed_node(torch, device, KEYS_DIR / "k")
        nodes.append(node_k)
        conn = http_client(node_k.port)
        expect_ok(conn, "POST", "/index/keyed", {"options": {"keys": True}})
        expect_ok(conn, "POST", "/index/keyed/field/kf", {"options": {"keys": True}})
        t0 = time.perf_counter()
        for lo in range(0, KEYS_COLS, KEYS_BATCH):
            hi = min(KEYS_COLS, lo + KEYS_BATCH)
            expect_ok(conn, "POST", "/index/keyed/field/kf/import", {
                "rowKeys": [f"r{j}" for j in rows[lo:hi].tolist()],
                "columnKeys": [f"c{i}" for i in range(lo, hi)]})
        import_s = time.perf_counter() - t0
        log(f"keyed import over HTTP: {KEYS_COLS} column keys, {KEYS_ROWS} row keys, "
            f"{KEYS_COLS // KEYS_BATCH} requests in {import_s:.3f} s (client clock)  [{card}]")
        union_q = queries["keyed_union"][0]
        # The first Union finds no plane: auto schedules its build on the
        # prefetcher and resolves on the host; then ONE plane_lookup.
        expect_ok(conn, "POST", QUERY_PATH.format("keyed"), union_q)
        planes = node_k.executor.keyplanes
        deadline = time.monotonic() + 60
        while planes.debug()["builds"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        keyed_launches = {}
        for name, (q, oracle) in queries.items():
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            body = expect_ok(conn, "POST", QUERY_PATH.format("keyed"), q)
            first = (time.perf_counter() - t0) * 1e3
            keyed_launches[name] = {k: kernels.LAUNCHES[k] - before[k] for k in before
                                    if kernels.LAUNCHES[k] != before[k]}
            if json.loads(body)["results"] != [oracle]:
                raise AssertionError(f"keyed {q[:80]}: {body[:300]!r}, oracle "
                                     f"{json.dumps(oracle)[:300]}")
            p50, spread = p50_ms(lambda: expect_ok(conn, "POST",
                                                   QUERY_PATH.format("keyed"), q), runs)
            log(f"keyed {name} {q[:60]}{'...' if len(q) > 60 else ''} = oracle; first "
                f"{first:.3f} ms, launches {keyed_launches[name]}; HTTP p50 {p50:.4f} ms "
                f"({spread}) over {runs} runs  [{card}]")
        if device == "cuda" and keyed_launches["keyed_union"].get("plane_lookup") != 1:
            raise AssertionError(f"keyed Union of {KEYS_UNION} keys: launches "
                                 f"{keyed_launches['keyed_union']}, want ONE plane_lookup")
        dbg = json.loads(expect_ok(conn, "GET", "/debug/translate"))
        log(f"/debug/translate: {json.dumps(dbg)}")
        if dbg["planes"]["deviceBatches"] < 1 or dbg["stores"]["keyed"]["maxId"] != KEYS_COLS:
            raise AssertionError(f"/debug/translate: {dbg}")
        conn.close()
        bodies = keyed_bodies(node_k, queries)
        t0 = time.perf_counter()
        node_k.close()
        nodes.remove(node_k)
        close_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        node_r = keyed_node(torch, device, KEYS_DIR / "k")
        nodes.append(node_r)
        log(f"keyed node closed in {close_s:.3f} s, reopened in "
            f"{time.perf_counter() - t0:.3f} s; {dir_bytes(KEYS_DIR / 'k', '.jsonl')} bytes "
            f"of jsonl stores on disk")
        if keyed_bodies(node_r, queries) != bodies:
            raise AssertionError("keyed bodies differ after close and reopen")
        conn = http_client(node_r.port)
        t0 = time.perf_counter()
        bid = json.loads(expect_ok(conn, "POST", "/backup",
                                   {"archive": str(KEYS_DIR / "archive")}))["id"]
        await_job(conn, "/backup/status", "keyed backup")
        conn.close()
        node_d = keyed_node(torch, device, KEYS_DIR / "restored")
        nodes.append(node_d)
        conn = http_client(node_d.port)
        expect_ok(conn, "POST", "/restore", {"archive": str(KEYS_DIR / "archive"), "id": bid})
        await_job(conn, "/restore/status", "keyed restore")
        conn.close()
        if keyed_bodies(node_d, queries) != bodies:
            raise AssertionError("keyed bodies differ after backup and restore")
        log(f"keyed index: bodies equal after close and reopen and after backup {bid} "
            f"restored into a fresh dir ({time.perf_counter() - t0:.3f} s)  [{card}]")
    finally:
        for n in nodes:
            n.close()
        shutil.rmtree(KEYS_DIR, ignore_errors=True)
    launches = dict(kernels.LAUNCHES)
    log(f"keys path launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    if device == "cuda":
        for k in KEYS_KERNELS:
            if launches[k] < 1:
                raise AssertionError(f"kernel {k} was not launched on the keys path")
    return {"launches": launches, "per_query": per_query, "keyed": keyed_launches}


# -- phase: the cluster's serving path ----------------------------------------

#: the cluster phase's ring: three CLI nodes on loopback sharing the card,
#: two owners a shard.
CLUSTER_NODES = 3
CLUSTER_REPLICAS = 2
#: the member SIGKILLed mid-phase (never the first, the one whose sweep is
#: read), and how long its liveness sweep may take to mark it DOWN.
CLUSTER_KILLED = 1
CLUSTER_SWEEP_WAIT_S = 40
#: samples of each p50, and the clients that load the bench over HTTP.
CLUSTER_RUNS = 10
CLUSTER_LOAD_CLIENTS = 4
#: the second index: 16 shards, a set field of 64 rows, one of 8, an int
#: field of distinct values, through the coordinator's JSON /import.
SMALL_SHARDS = 16
SMALL_ROWS = {"a": 64, "b": 8}
SMALL_BITS = {"a": 400_000, "b": 200_000}
SMALL_VALUES = 100_000
SMALL_VMIN, SMALL_VMAX = -1000, 100_000
SMALL_SCHEMA = [("/index/small", None), ("/index/small/field/a", None),
                ("/index/small/field/b", None),
                ("/index/small/field/v", {"type": "int", "min": SMALL_VMIN,
                                          "max": SMALL_VMAX})]
SMALL_ROW_SHARDS = (0, 5, 9, 15)
SMALL_QUERIES = {
    "topn": "TopN(a, n=5)",
    "topn_filtered": "TopN(a, Row(b=1), n=5)",
    "groupby": "GroupBy(Rows(b), Rows(a))",
    "sum": "Sum(field=v)",
    "min": "Min(field=v)",
    "max_filtered": "Max(Row(b=2), field=v)",
    "distinct": "Count(Distinct(field=v))",
    "rows": "Rows(a)",
    "count": "Count(Row(b=1))",
    "row_shards": "Row(a=3)",
}
CLUSTER_BENCH_QUERIES = ("count_intersect", "count_3leaf")
CLUSTER_KERNELS_NODES = ("pair_count", "tree_count")
#: the elastic part of the cluster phase: the anti-entropy tick (seconds)
#: the phase's cluster and its joiner read from a config file, the wait
#: for a resize or a repair, the acknowledged Set/Clear pairs sent through
#: the coordinator while the grow runs, the bits cleared in shards that
#: move off node A, the keyed index's column keys (a quarter of the keys
#: phase's million: the allocation path is the same at any count) and row
#: keys, and the kernels each node's launches over the part must include.
ELASTIC_SYNC_S = 5.0
ELASTIC_WAIT_S = 300
ELASTIC_WRITES = 6
ELASTIC_CLEARS = 8
ELASTIC_KEYS = 250_000
ELASTIC_KEY_ROWS = 300
ELASTIC_KERNELS = ("pair_count", "scatter_bits_grouped", "plane_lookup")
ELASTIC_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_elastic"
#: the cluster's backup and restore: the defaults cluster's data dirs, the
#: archive they back up into, and the restore target's data dirs (a
#: cluster of RESTORE_NODES on the CLI's defaults, replica RESTORE_REPLICAS:
#: each fragment to one owner, half of them on the peer; replica 2 until a
#: slow host's run passed 950 s).
BACKUP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cluster_backup"
RESTORE_NODES = 2
RESTORE_REPLICAS = 1
#: the restored members' launches over the bodies' checks must include.
RESTORE_KERNELS = ("pair_count", "row_counts")
#: the OTLP check: seconds to wait for a trace's spans at the collector
#: (the exporter flushes every 2 s).
OTLP_WAIT_S = 20


class Collector:
    """An OTLP/HTTP collector double on loopback: keeps every span POSTed
    to ``/v1/traces`` with its node's service name."""

    def __init__(self):
        import http.server

        self.spans: list[tuple[str, dict]] = []
        lock = threading.Lock()
        spans = self.spans

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                doc = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
                with lock:
                    for rs in doc["resourceSpans"]:
                        svc = rs["resource"]["attributes"][0]["value"]["stringValue"]
                        spans.extend((svc, sp) for ss in rs["scopeSpans"] for sp in ss["spans"])
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_port}/v1/traces"

    def trace(self, trace_id: str) -> list[tuple[str, dict]]:
        """The (service, span) pairs of one trace id (the exporter's
        ``traceId`` is the md5 of the node's trace id)."""
        import hashlib

        want = hashlib.md5(trace_id.encode()).hexdigest()
        return [(svc, sp) for svc, sp in list(self.spans) if sp["traceId"] == want]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def backup_run(port: int, body: dict, what: str) -> tuple[dict, float]:
    """POST /backup on one member and poll /backup/status to its end, which
    must be ``done``; the status and the seconds, client clock."""
    t0 = time.perf_counter()
    conn = http_client(port)
    try:
        expect_ok(conn, "POST", "/backup", body)
        st = await_job(conn, "/backup/status", what)
    finally:
        conn.close()
    return st, time.perf_counter() - t0


def corrupt_first_record(path: Path) -> None:
    """Flip one bit inside a WAL's first record, whose valid records after
    it make the copy corrupt on read (mid-file damage, not a torn tail)."""
    with open(path, "r+b") as f:
        f.seek(64)
        b = f.read(1)
        f.seek(64)
        f.write(bytes([b[0] ^ 0x10]))


def cluster_restore(card: str, device: str, dports: list, s: int, full: dict,
                    check_all, bodies: dict, collector: Collector, stop_source) -> dict:
    """The defaults cluster's incremental backup with one copy corrupt, and
    its restore into a fresh cluster of another size. The writes of the
    phase went through the defaults cluster after ``full``; shard ``s``
    holds them. One of its owners (the member the backup runs through) gets a bit flipped
    in its copy's WAL, so the incremental through that member captures the
    fragment from the other owner (``backup.skippedQuarantined``). Then
    the defaults cluster is killed (``stop_source``; its data dirs are
    thrown away), RESTORE_NODES fresh members with data dirs
    (booted meanwhile, exporting spans to ``collector``) restore the chain
    over POST /restore, and every query through each of them equals node
    A's body and its oracle, with ``pair_count`` and ``row_counts`` among
    their launches; one query's spans then reach the collector under one
    trace id from the coordinator and its peer. Returns the restored
    members' launches and the measurements."""
    from pilosa_tpu_torch.backup import LocalDirArchive

    archive = BACKUP_DIR / "archive"
    owners = [n["id"] for n in get_json(dports[0], f"/internal/fragment/nodes?index=bench"
                                                   f"&shard={s}")]
    via = next(p for p in dports if f"127.0.0.1:{p}" in owners)
    other = next(i for i in owners if i != f"127.0.0.1:{via}")
    # The restore target boots while the incremental runs.
    booted: list = []
    boot = threading.Thread(target=lambda: booted.append(cluster_start(
        device, RESTORE_REPLICAS, (True,), data_dirs=[BACKUP_DIR / "restore"],
        n_nodes=RESTORE_NODES, extra=["--trace-endpoint", collector.url])[0]))
    t_boot = time.perf_counter()
    boot.start()
    out = {}
    try:
        wal = BACKUP_DIR / "defaults" / f"n{dports.index(via)}" / "bench" / "f" / "standard"
        corrupt_first_record(wal / f"{s}.wal")
        skipped0 = node_counters(via).get("backup.skippedQuarantined", 0)
        st, secs = backup_run(via, {"archive": str(archive), "parent": full["id"]},
                              "the incremental backup")
        manifest = LocalDirArchive(str(archive)).read_manifest(st["id"])
        src = {e["source"] for e in manifest["files"]
               if (e.get("index"), e.get("field"), e.get("shard")) == ("bench", "f", s)}
        skipped = node_counters(via).get("backup.skippedQuarantined", 0) - skipped0
        if src != {other} or skipped < 1:
            raise AssertionError(f"incremental: bench/f/standard/{s} captured from {src}, "
                                 f"not {other}; {skipped} copies skipped as quarantined")
        stored = [e for e in manifest["files"] if e.get("stored_in") is None]
        out["incremental"] = {"s": secs, "files": len(manifest["files"]),
                              "stored": len(stored), "bytes": sum(e["size"] for e in stored)}
        log(f"cluster backup, incremental {st['id']} through {via} after the acknowledged "
            f"writes: {len(stored)} of {len(manifest['files'])} files stored "
            f"({out['incremental']['bytes']} bytes) in {secs:.3f} s (client clock); "
            f"bench/f/standard/{s}'s copy on {via} corrupt (a bit flipped in its WAL's "
            f"first record): captured from the other owner {other}, "
            f"backup.skippedQuarantined {skipped}; archive {dir_bytes(archive)} bytes  "
            f"[{card}]")
    except BaseException:
        boot.join()
        for rnodes in booted:
            cluster_stop(rnodes)
        raise
    stop_source()
    boot.join()
    t_ready = time.perf_counter()
    if not booted:
        raise AssertionError("the restore target did not boot")
    rnodes = booted[0]
    rports = [p for _, p in rnodes]
    try:
        log(f"restore target: {RESTORE_NODES} cli server processes on {rports} (CLI "
            f"defaults, replica {RESTORE_REPLICAS}, data dirs, --trace-endpoint), all "
            f"serving {t_ready - t_boot:.3f} s after their spawn")
        t0 = time.perf_counter()
        conn = http_client(rports[0])
        expect_ok(conn, "POST", "/restore", {"archive": str(archive), "id": st["id"]})
        rst = await_job(conn, "/restore/status", "the cluster restore")
        conn.close()
        secs = time.perf_counter() - t0
        out["restore"] = {"s": secs, "job_s": rst.get("seconds"),
                          "fragments": rst.get("totalFragments"), "bytes": rst.get("bytes"),
                          "data_dir_bytes": dir_bytes(BACKUP_DIR / "restore")}
        log(f"cluster restore of {st['id']} into the {RESTORE_NODES}-node cluster through "
            f"{rports[0]}: {rst.get('totalFragments')} fragments, {rst.get('bytes')} archive "
            f"bytes in {secs:.3f} s (client clock; the job's {rst.get('seconds')} s), each to "
            f"its owner; data dirs {out['restore']['data_dir_bytes']} bytes  [{card}]")
        before = {p: node_launches(p) for p in rports}
        t0 = time.perf_counter()
        check_all(rports, bodies, "(restored cluster: node A and oracle)")
        after = {p: node_launches(p) for p in rports}
        deltas = {p: {k: after[p][k] - before[p][k] for k in after[p]} for p in rports}
        for p in rports:
            log(f"restored member {p} launches over the queries: "
                f"{json.dumps({k: v for k, v in deltas[p].items() if v})}")
            if device == "cuda" and any(deltas[p][k] < 1 for k in RESTORE_KERNELS):
                raise AssertionError(f"restored member {p}: no {RESTORE_KERNELS} launch")
        out["check_s"] = time.perf_counter() - t0
        out["launches"] = {k: sum(deltas[p][k] for p in rports) for k in deltas[rports[0]]}

        # One query, one trace id: its spans on the coordinator (the call, the
        # remote leg) and on the peer reach the collector under it.
        tid = f"chip-smoke-otlp-{os.getpid()}"
        conn = http_client(rports[0])
        status, body = request(conn, "POST", "/index/bench/query?noCache=true",
                               COUNT_QUERIES["count_intersect"], {"X-Pilosa-Trace-Id": tid})
        conn.close()
        if status != 200 or body != bodies["count_intersect"]:
            raise AssertionError(f"traced query: HTTP {status} {body[:200]!r}")
        t0 = time.perf_counter()
        names = {f"pilosa-tpu:127.0.0.1:{p}" for p in rports}

        def whole():
            got = collector.trace(tid)
            legs = [sp for _, sp in got if sp["name"] == "cluster.remoteLeg"]
            return got if {svc for svc, _ in got} == names and legs else None

        spans = wait_for("the traced query's spans from both members", whole, OTLP_WAIT_S, 0.25)
        out["otlp"] = {"spans": len(spans), "s": time.perf_counter() - t0}
        names_seen = ", ".join(sorted(f"{svc} {sp['name']}" for svc, sp in spans))
        log(f"OTLP: one Count through {rports[0]} with trace id {tid}: {len(spans)} spans at "
            f"the collector double under one trace id ({names_seen}) within "
            f"{out['otlp']['s']:.3f} s of the answer")
    finally:
        cluster_stop(rnodes)
    return out




def cluster_start(device: str, replica_n: int, defaults: tuple = (False,),
                  configs: list | None = None, data_dirs: list | None = None,
                  n_nodes: int = CLUSTER_NODES, extra: list | None = None) -> list:
    """One cluster a flag of ``defaults``, each ``n_nodes`` ``cli server
    --peers`` processes on loopback, every port picked ahead of boot
    (``--peers`` names them) and every process booting at once; returns a
    [(process, port)] list a cluster, in ring order (by address, the first
    the coordinator flag's), once each serves. A cluster whose flag is
    False runs with hedged reads off and the device reduce ``on``, so its
    launch counts are fixed; one whose flag is True runs on the CLI's own
    settings (hedging on, device reduce ``auto``); ``configs`` names the
    config file each node of a False cluster reads, in ring order (None for
    none); ``data_dirs`` a data-dir root a cluster (None for none: node i's
    dir is ``root/n{i}``), ``n_nodes`` the nodes a cluster and ``extra``
    more flags for every node. Each node's boot split (the CLI's serving
    line) is logged."""
    import socket

    from pilosa_tpu_torch.ops import build

    socks = [socket.socket() for _ in range(n_nodes * len(defaults))]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    env = {k: v for k, v in os.environ.items() if not k.startswith("PILOSA_TPU_")}
    spawned = []  # [(process, addr)] a cluster
    for i, own in enumerate(defaults):
        addrs = sorted(f"127.0.0.1:{p}"
                       for p in ports[i * n_nodes:(i + 1) * n_nodes])
        fixed = [] if own else ["--device-reduce", "on", "--hedge", "off"]
        cfg = [None] * len(addrs) if own or not configs else configs
        root = data_dirs[i] if data_dirs else None
        spawned.append([(subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--bind", addr,
             "--peers", ",".join(a for a in addrs if a != addr),
             "--replica-n", str(replica_n), "--device", device, *fixed,
             *(["--config", c] if c else []),
             *(["--data-dir", str(Path(root) / f"n{j}")] if root else []),
             *(extra or []),
             "--qos-warmup", "", "--compile-cache-dir", str(build.BUILD_DIR)],
            cwd=Path(__file__).resolve().parent, env=env, stderr=subprocess.PIPE,
            text=True), addr) for j, (addr, c) in enumerate(zip(addrs, cfg))])
    out = []
    for cluster in spawned:
        out.append([])
        for proc, addr in cluster:
            seen = []
            for line in proc.stderr:
                seen.append(line)
                if "serving at" in line:
                    log(f"cluster node {addr}: {line.strip()}")
                    break
            else:
                for p, _ in sum(spawned, []):
                    p.kill()
                    p.wait()
                raise AssertionError(f"cluster node {addr} did not start: "
                                     f"{''.join(seen)[-2000:]}")
            threading.Thread(target=lambda p=proc: [None for _ in p.stderr],
                             daemon=True).start()
            out[-1].append((proc, int(addr.rpartition(":")[2])))
    return out


def cluster_stop(nodes) -> None:
    for proc, _ in nodes:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    for proc, _ in nodes:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def cluster_kill(nodes) -> None:
    """SIGKILL every process of a cluster whose data dirs are thrown away
    next: a SIGTERM's close would snapshot every fragment first."""
    for proc, _ in nodes:
        if proc.poll() is None:
            proc.kill()
    for proc, _ in nodes:
        proc.wait()


def node_launches(port: int) -> dict:
    conn = http_client(port)
    doc = json.loads(expect_ok(conn, "GET", "/debug/device"))
    conn.close()
    return doc["launches"]


def row_roaring(frag, row: int) -> bytes:
    """One row of a fragment as an ``import-roaring`` body: its positions
    in the reference's pos-encoded roaring (Fragment.to_roaring's format,
    this row alone)."""
    from pilosa_tpu_torch import native
    from pilosa_tpu_torch.config import SHARD_WIDTH

    pos = native.words_to_positions(frag.row_words(row))
    return native.encode_roaring(pos.astype(np.uint64) + np.uint64(row * SHARD_WIDTH))


def small_data(seed: int) -> dict:
    """The second index's seeded bits and values: a's rows skewed (row r
    weighted 1 / (r + 1)), b's uniform, v's values distinct."""
    from pilosa_tpu_torch.config import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    n_cols = SMALL_SHARDS * SHARD_WIDTH
    out = {}
    for f, rows in SMALL_ROWS.items():
        w = 1.0 / np.arange(1, rows + 1) if f == "a" else np.ones(rows)
        r = rng.choice(rows, SMALL_BITS[f], p=w / w.sum())
        c = rng.integers(0, n_cols, SMALL_BITS[f])
        key = distinct(r.astype(np.int64) * n_cols + c)
        out[f] = (key // n_cols, key % n_cols)
    cols = np.sort(rng.choice(n_cols, SMALL_VALUES, replace=False))
    vals = rng.choice(SMALL_VMAX - SMALL_VMIN, SMALL_VALUES, replace=False) + SMALL_VMIN
    out["v"] = (cols, vals)
    return out


def small_oracles(d: dict, base: int) -> dict:
    """The second index's answers from its data in numpy, as JSON bodies
    (the TopNs by the executor's two-pass rule, ``topn_oracle``)."""
    from pilosa_tpu_torch.config import SHARD_WIDTH

    (ar, ac), (br, bc), (vc, vv) = d["a"], d["b"], d["v"]
    n_cols = SMALL_SHARDS * SHARD_WIDTH
    na, nb = SMALL_ROWS["a"], SMALL_ROWS["b"]
    b1 = np.zeros(n_cols, bool)
    b1[bc[br == 1]] = True
    b2 = np.zeros(n_cols, bool)
    b2[bc[br == 2]] = True

    def per_shard(rows, cols, keep=None):
        m = np.ones(len(cols), bool) if keep is None else keep[cols]
        c = np.zeros((SMALL_SHARDS, na), np.int64)
        np.add.at(c, (cols[m] // SHARD_WIDTH, rows[m]), 1)
        return {s: (c[s], None, None) for s in range(SMALL_SHARDS)}

    def pairs(ranked):
        return [{"id": int(i), "count": int(n)} for i, n in ranked]

    groups = np.zeros((nb, na), np.int64)
    a_of = {}
    for r, c in zip(ar.tolist(), ac.tolist()):
        a_of.setdefault(c, []).append(r)
    for r, c in zip(br.tolist(), bc.tolist()):
        for a in a_of.get(c, ()):
            groups[r, a] += 1
    gb = [((int(b), int(a)), int(groups[b, a])) for b in range(nb) for a in range(na)
          if groups[b, a]]
    in_b2 = b2[vc]
    sel = np.isin(ac // SHARD_WIDTH, SMALL_ROW_SHARDS) & (ar == 3)
    body = {
        "topn": [pairs(topn_oracle(per_shard(ar, ac), 5))],
        "topn_filtered": [pairs(topn_oracle(per_shard(ar, ac, b1), 5))],
        "groupby": [group_json(["b", "a"], gb)],
        "sum": [{"value": int(vv.sum()), "count": len(vv)}],
        "min": [{"value": int(vv.min()), "count": 1}],
        "max_filtered": [{"value": int(vv[in_b2].max()), "count": 1}],
        "distinct": [distinct_oracle(vv - base, 12, 1024)],
        "rows": [{"rows": sorted(int(r) for r in distinct(ar))}],
        "count": [int(b1.sum())],
        "row_shards": [{"attrs": {}, "columns": sorted(int(c) for c in ac[sel])}],
    }
    return body


def cluster_load(clusters: list, h, n_shards: int, sd: dict) -> dict:
    """The schema, the bench's rows f=1 and g=2 (one import-roaring a field
    and shard, from node A's fragments ``h``; CLUSTER_LOAD_CLIENTS at once a
    cluster) and the second index ``sd`` (JSON /import, one more client),
    all sent to each cluster's first port, which routes each body to its
    owners; the clusters (lists of ports) and their clients load at once.
    Returns the request and byte counts of a cluster's bench load and the
    seconds of the whole load."""
    for ports in clusters:
        conn = http_client(ports[0])
        for path, opts in [s for s in SCHEMA if s[0].startswith("/index/bench")] + SMALL_SCHEMA:
            expect_ok(conn, "POST", path, {"options": opts} if opts else None)
        conn.close()
        schemas = set()
        for p in ports:
            c = http_client(p)
            schemas.add(expect_ok(c, "GET", "/schema"))
            c.close()
        if len(schemas) != 1:
            raise AssertionError("the schema did not reach every member")
    jobs = [(f, r, s) for f, r in (("f", 1), ("g", 2)) for s in range(n_shards)]
    sent = [0, 0]
    lock = threading.Lock()

    def load(coord, part):
        c = http_client(coord)
        for f, r, s in part:
            body = row_roaring(h.fragment("bench", f, "standard", s), r)
            expect_ok(c, "POST", f"/index/bench/field/{f}/import-roaring/{s}", body)
            with lock:
                sent[0] += 1
                sent[1] += len(body)
        c.close()

    def load_small(coord):
        c = http_client(coord)
        for f in SMALL_ROWS:
            expect_ok(c, "POST", f"/index/small/field/{f}/import",
                      {"rowIDs": sd[f][0].tolist(), "columnIDs": sd[f][1].tolist()})
        expect_ok(c, "POST", "/index/small/field/v/import",
                  {"columnIDs": sd["v"][0].tolist(), "values": sd["v"][1].tolist()})
        with lock:
            sent[2] += 1
        c.close()

    sent.append(0)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=load, args=(ports[0], jobs[i::CLUSTER_LOAD_CLIENTS]))
               for ports in clusters for i in range(CLUSTER_LOAD_CLIENTS)]
    threads += [threading.Thread(target=load_small, args=(ports[0],)) for ports in clusters]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if sent[0] != len(jobs) * len(clusters) or sent[2] != len(clusters):
        raise AssertionError(f"load: {sent[0]} of {len(jobs) * len(clusters)} bench requests, "
                             f"{sent[2]} of {len(clusters)} small index loads")
    return {"requests": sent[0] // len(clusters), "bytes": sent[1] // len(clusters),
            "seconds": time.perf_counter() - t0}


def node_spawn(device: str, addr: str, args: list) -> subprocess.Popen:
    """One ``cli server`` process on ``addr`` with the phase cluster's fixed
    settings (device reduce ``on``, hedging off) and ``args``, returned once
    it serves; its stderr is drained from then on."""
    from pilosa_tpu_torch.ops import build

    env = {k: v for k, v in os.environ.items() if not k.startswith("PILOSA_TPU_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--bind", addr,
         "--device", device, "--device-reduce", "on", "--hedge", "off", "--qos-warmup", "",
         "--compile-cache-dir", str(build.BUILD_DIR), *args],
        cwd=Path(__file__).resolve().parent, env=env, stderr=subprocess.PIPE, text=True)
    seen = []
    for line in proc.stderr:
        seen.append(line)
        if "serving at" in line:
            log(f"node {addr}: {line.strip()}")
            break
    else:
        proc.wait()
        raise AssertionError(f"node {addr} did not start: {''.join(seen)[-2000:]}")
    threading.Thread(target=lambda: [None for _ in proc.stderr], daemon=True).start()
    return proc


def get_json(port: int, path: str):
    conn = http_client(port)
    try:
        return json.loads(expect_ok(conn, "GET", path))
    finally:
        conn.close()


def post_json(port: int, path: str, body):
    conn = http_client(port)
    try:
        return json.loads(expect_ok(conn, "POST", path, body) or b"{}")
    finally:
        conn.close()


def node_counters(port: int) -> dict:
    return get_json(port, "/debug/vars")["counters"]


def ring_of(port: int) -> list:
    return sorted(n["id"] for n in get_json(port, "/status")["nodes"])


def wait_for(what: str, fn, timeout: float = ELASTIC_WAIT_S, every: float = 0.2):
    """Poll ``fn`` until it returns a true value; fail after ``timeout`` s."""
    t0 = time.perf_counter()
    while True:
        got = fn()
        if got:
            return got
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(every)


def body_diff(got: bytes, want: bytes) -> str:
    """A short account of how two query bodies differ: the columns one Row
    result has and the other lacks, or the bodies' heads."""
    g, w = json.loads(got), json.loads(want)
    try:
        gc, wc = set(g["results"][0]["columns"]), set(w["results"][0]["columns"])
    except (KeyError, IndexError, TypeError):
        return f"{got[:200]!r} != {want[:200]!r}"
    return (f"{len(gc)} columns against {len(wc)}; only in the first "
            f"{sorted(gc - wc)[:8]}, only in the second {sorted(wc - gc)[:8]}")


def cluster_elastic(card: str, device: str, ports: list, config: str, fw: np.ndarray,
                    mirror, refresh, check_all, bodies: dict) -> dict:
    """The elastic cluster on the card, on the phase's loaded three-node
    cluster (A, B, C; A the coordinator): a fourth ``cli server --join`` D
    grows the ring while acknowledged writes go through A and reads through
    each member, the moved shards streamed to D over PTS1; bits cleared in
    shards that moved off A; D restarted from its data dir's
    ``topology.json``; D removed again over ``POST
    /cluster/resize/remove-node``, A taking its shards back; a bit posted to
    one owner alone, repaired by the anti-entropy tick; and a keyed index of
    ELASTIC_KEYS column keys allocated through B and C. Each write is also
    sent to node A (``mirror``) and kept in ``fw`` (the bench's f=1 words);
    ``refresh()`` re-reads node A's bodies and holds each to its oracle, and
    ``check_all`` holds each member's bodies to them. Returns the launches
    of the members over the part and its measurements."""
    import socket

    from pilosa_tpu_torch.cluster import Cluster, Node
    from pilosa_tpu_torch.cluster.node import URI
    from pilosa_tpu_torch.config import SHARD_WIDTH

    t_part = time.perf_counter()
    a, b = ports[0], ports[1]
    ids = [f"127.0.0.1:{p}" for p in ports]
    # D's address sorts after the members' (a port picked until it does):
    # the ring orders members by address, and a joiner at its end moves
    # only the shards it gains (about half), not every shard's pair.
    for _ in range(64):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        d = s.getsockname()[1]
        s.close()
        if f"127.0.0.1:{d}" > max(ids):
            break
    d_id = f"127.0.0.1:{d}"
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ELASTIC_DIR.mkdir(parents=True)
    n_shards = fw.shape[0]

    def ring(members):
        return Cluster("x", [Node(id=i, uri=URI(host="127.0.0.1", port=int(i.rpartition(":")[2])))
                             for i in members], replica_n=CLUSTER_REPLICAS)

    old, new = ring(ids), ring(ids + [d_id])

    def owners(r, shard):
        return {n.id for n in r.shard_nodes("bench", shard)}

    to_d = [x for x in range(n_shards) if d_id in owners(new, x)]
    off_a = [x for x in range(n_shards) if ids[0] in owners(old, x) - owners(new, x)]
    if not to_d or not off_a:
        raise AssertionError("the grow moves no shard to D or none off A")
    rng = np.random.default_rng(SEED + 11)
    launches = {p: node_launches(p) for p in ports}
    totals = {k: 0 for k in launches[a]}
    passes0 = {p: node_counters(p).get("antiEntropyPasses", 0) for p in ports}
    counted = {}

    def bits(shard, on):
        w = np.unpackbits(fw[shard].view(np.uint8), bitorder="little").astype(bool)
        return np.flatnonzero(w == on)

    def write(pql, ops):
        """One acknowledged write through A, mirrored to node A; ``ops`` are
        its (column, set?) pairs on f=1, kept in ``fw``."""
        got = post_json(a, "/index/bench/query", pql)
        if got != {"results": [True] * len(ops)}:
            raise AssertionError(f"{pql} through A: {got}")
        mirror(pql)
        for col, on in ops:
            shard, off = divmod(col, SHARD_WIDTH)
            word, bit = divmod(off, 32)
            if on:
                fw[shard, word] |= np.uint32(1 << bit)
            else:
                fw[shard, word] &= np.uint32(~(1 << bit) & 0xFFFFFFFF)

    def f_total():
        return int(popcount_rows(fw).sum())

    def row_query(shards):
        cols = sorted(int(c) for x in shards for c in bitops_columns(fw[x], x * SHARD_WIDTH))
        return ("&shards=" + ",".join(map(str, shards)), {"results": [{"attrs": {}, "columns": cols}]})

    def own_row(p, shards):
        """Node ``p``'s own Row(f=1) over ``shards``: a remote leg, decoded."""
        from pilosa_tpu_torch.server import wire

        conn = http_client(p)
        st, frame = request(conn, "POST", "/index/bench/query?remote=true&noCache=true&shards="
                            + ",".join(map(str, shards)), "Row(f=1)",
                            {"Accept": wire.FRAMES_ACCEPT_V2})
        conn.close()
        if st != 200:
            raise AssertionError(f"remote leg via {p}: HTTP {st}")
        return [int(c) for c in wire.decode_frames(frame, device="cpu")[0].columns()]

    def hold_row(members, shards, when, remote=False):
        """Row(f=1) over ``shards`` through each member (or, ``remote``,
        each member's own fragments) equal to the oracle."""
        suffix, want = row_query(shards)
        for p in members:
            if remote:
                if own_row(p, shards) != want["results"][0]["columns"]:
                    raise AssertionError(f"{when}: node {p}'s own Row(f=1) over {shards} "
                                         f"differs from the oracle")
                continue
            conn = http_client(p)
            body = json.loads(expect_ok(conn, "POST", "/index/bench/query?noCache=true" + suffix,
                                        "Row(f=1)"))
            conn.close()
            if body != want:
                raise AssertionError(f"{when}: Row(f=1) over {shards} via {p} differs from "
                                     f"the oracle")

    def counters(members, name):
        return {p: node_counters(p).get(name, 0) for p in members}

    def settled_cleaners(t_commit, before):
        """The fragments each member's cleaner removed since ``before``,
        read once the cleaners' grace after the commit has passed."""
        from pilosa_tpu_torch.server.node import ServerNode

        time.sleep(max(0.0, t_commit + ServerNode.CLEANER_GRACE_S + 1.0 - time.perf_counter()))
        now = counters(ports, "holderCleanerRemoved")
        return {p: now[p] - before[p] for p in ports}

    def take_launches(p):
        now = node_launches(p)
        for k in totals:
            totals[k] += now[k] - launches[p][k]
        launches[p] = now

    out = {}
    # -- 1. grow: D joins through B; writes through A while the job runs
    streamed0 = counters(ports, "cluster.resize.bytesStreamed")
    cleaned0 = counters(ports, "holderCleanerRemoved")
    t0 = time.perf_counter()
    d_proc = node_spawn(device, d_id, ["--join", ids[1], "--replica-n", str(CLUSTER_REPLICAS),
                                       "--data-dir", str(ELASTIC_DIR / "d"), "--config", config])
    d_procs = [d_proc]
    launches[d] = node_launches(d)
    try:
        job = wait_for("the resize job on A", lambda: get_json(a, "/debug/resize")["job"], 60)
        t_job = time.perf_counter()
        # Writes start with the job: its resize-begin carries the schema, so
        # a dual write reaching D before its instruction finds the index
        # (ROADMAP.md Queue 3, F2).
        mid, written = 0, []
        targets = [x for x in to_d if len(bits(x, True)) and len(bits(x, False))]
        while True:
            state = get_json(a, "/debug/resize")["job"]["state"]
            if state != "RUNNING" or len(written) >= ELASTIC_WRITES:
                break
            x = targets[len(written) % len(targets)]
            on = int(rng.choice(bits(x, False))) + x * SHARD_WIDTH
            off = int(rng.choice(bits(x, True))) + x * SHARD_WIDTH
            write(f"Set({on}, f=1) Clear({off}, f=1)", [(on, True), (off, False)])
            written.append(x)
            if get_json(a, "/debug/resize")["job"]["state"] == "RUNNING":
                mid += 1
            want = f_total()
            for p in ports:  # serve-through: each member answers, no gate
                got = post_json(p, "/index/bench/query?noCache=true", "Count(Row(f=1))")
                if got != {"results": [want]}:
                    raise AssertionError(f"mid-resize Count(Row(f=1)) via {p}: {got} != {want}")
        wait_for("the grow's commit", lambda: (get_json(a, "/debug/resize")["job"]["state"]
                                                != "RUNNING"))
        job = get_json(a, "/debug/resize")["job"]
        t_done = time.perf_counter()
        if job["state"] != "DONE" or job["failed"]:
            raise AssertionError(f"the grow ended {job}")
        wait_for("D in every member's ring", lambda: all(
            ring_of(p) == sorted(ids + [d_id]) for p in ports + [d]), 60)
        streamed = sum(counters(ports, "cluster.resize.bytesStreamed")[p] - streamed0[p]
                       for p in ports)
        log(f"elastic grow: D {d_id} joined through B; resize job {job['job']} DONE, "
            f"{job['shards']['migrated']} shards cut over, {t_done - t_job:.3f} s from the job's "
            f"start to its commit ({t_done - t0:.3f} s from D's spawn), {streamed / 1e6:.3f} MB "
            f"streamed over PTS1 to D (logical bit pairs, 16 B each); {len(written)} "
            f"acknowledged Set/Clear pairs through A, {mid} of them while the job ran, each "
            f"followed by Count(Row(f=1)) through A, B and C equal to the oracle  [{card}]")
        if device == "cuda" and not mid:
            raise AssertionError("no write went through A while the grow ran")
        t1 = time.perf_counter()
        refresh()
        check_all(ports + [d], bodies, "after the grow (four coordinators)")
        hold_row(ports + [d], sorted(set(written)), "the writes of the grow")
        cleaned = settled_cleaners(t_done, cleaned0)
        out["grow"] = {"join_to_commit_s": t_done - t0, "job_s": t_done - t_job,
                       "mb_streamed": streamed / 1e6, "cleaned": cleaned,
                       "shards_to_d": len(to_d), "writes_mid_resize": mid}
        log(f"elastic grow: bodies checked in {time.perf_counter() - t1:.3f} s; fragments "
            f"removed by the old members' cleaners after their grace {cleaned}  [{card}]")

        # -- 2. re-ownership: clear bits of shards that moved off A
        t1 = time.perf_counter()
        cleared = sorted(set(off_a[:ELASTIC_CLEARS]))
        ops = [(int(rng.choice(bits(x, True))) + x * SHARD_WIDTH, False) for x in cleared]
        write(" ".join(f"Clear({c}, f=1)" for c, _ in ops), ops)
        hold_row(ports + [d], cleared, "the clears of shards that left A")
        refresh()
        out["cleared_shards"] = cleared
        log(f"elastic re-ownership: cleared one bit in each of shards {cleared} (owned by A "
            f"before the grow, not after) through A; Row(f=1) over them equal to the oracle "
            f"through all four ({time.perf_counter() - t1:.3f} s)  [{card}]")

        # -- 3. restart D from its data dir's topology.json
        t1 = time.perf_counter()
        take_launches(d)
        d_proc.send_signal(signal.SIGTERM)
        d_proc.wait(timeout=120)
        t_closed = time.perf_counter()
        d_proc = node_spawn(device, d_id, ["--peers", ",".join(ids), "--replica-n",
                                           str(CLUSTER_REPLICAS), "--data-dir",
                                           str(ELASTIC_DIR / "d"), "--config", config])
        t_booted = time.perf_counter()
        d_procs.append(d_proc)
        launches[d] = node_launches(d)
        memb = get_json(d, "/debug/membership")
        if memb["topologyVersion"] != 1 or ring_of(d) != sorted(ids + [d_id]):
            raise AssertionError(f"D restarted without its topology: {memb['topologyVersion']}, "
                                 f"{ring_of(d)}")
        # D merges its peers' shard availability as it boots (ROADMAP.md
        # Queue 3, F1): its first bodies, right after the boot, are whole.
        check_all([d], bodies, "right after D's restart from topology.json",
                  (*CLUSTER_BENCH_QUERIES, "row_leg"))
        t_checked = time.perf_counter()
        out["restart_s"] = t_checked - t1
        log(f"elastic restart: D SIGTERMed and booted again on its data dir with --peers and "
            f"no --join: topology version 1 and the four-node ring from topology.json, the "
            f"bench's bodies equal via D right after its boot ({out['restart_s']:.3f} s: "
            f"closing {t_closed - t1:.3f}, booting {t_booted - t_closed:.3f}, the checks "
            f"{t_checked - t_booted:.3f})  [{card}]")

        # -- 4. shrink: remove D; A streams its shards back
        streamed0 = counters(ports, "cluster.resize.bytesStreamed")
        cleaned0 = counters(ports, "holderCleanerRemoved")
        t1 = time.perf_counter()
        post_json(a, "/cluster/resize/remove-node", {"id": d_id})
        t_shrink = time.perf_counter() - t1
        job = get_json(a, "/debug/resize")["job"]
        if job["state"] != "DONE" or ring_of(a) != sorted(ids):
            raise AssertionError(f"the shrink ended {job}, ring {ring_of(a)}")
        if get_json(d, "/status")["state"] != "REMOVED":
            raise AssertionError("D is not REMOVED after its removal")
        take_launches(d)
        d_proc.send_signal(signal.SIGTERM)
        d_proc.wait(timeout=120)
        wait_for("every member's three-node ring", lambda: all(
            ring_of(p) == sorted(ids) for p in ports), 60)
        streamed = sum(counters(ports, "cluster.resize.bytesStreamed")[p] - streamed0[p]
                       for p in ports)
        refresh()
        check_all(ports, bodies, "after the shrink")
        hold_row([a], cleared, "A's own fragments of the shards it took back", remote=True)
        cleaned = settled_cleaners(t1 + t_shrink, cleaned0)
        out["shrink"] = {"s": t_shrink, "mb_streamed": streamed / 1e6, "cleaned": cleaned}
        log(f"elastic shrink: POST /cluster/resize/remove-node for D answered in "
            f"{t_shrink:.3f} s, {streamed / 1e6:.3f} MB streamed among A, B and C, cleaners "
            f"removed {cleaned}; D REMOVED; bodies through A, B and C equal; A's own Row(f=1) "
            f"over the shards it took back (a remote leg: its fresh fragments and stacks) "
            f"holds none of the cleared bits  [{card}]")

        # -- 5. anti-entropy: a bit on one owner alone
        t1 = time.perf_counter()
        x = next(y for y in range(n_shards) if owners(old, y) == set(ids[1:])
                 and len(bits(y, False)))
        col = int(bits(x, False)[0]) + x * SHARD_WIDTH
        one, two = sorted(owners(old, x))
        p_one, p_two = (int(i.rpartition(":")[2]) for i in (one, two))
        post_json(p_one, "/internal/import", {"index": "bench", "field": "f", "rowIDs": [1],
                                              "columnIDs": [col]})

        def has(p):
            return col in own_row(p, [x])

        if has(p_two):
            raise AssertionError("the bit reached the second owner before any sync")
        wait_for("the anti-entropy repair", lambda: has(p_two), 4 * ELASTIC_SYNC_S)
        out["repair_s"] = time.perf_counter() - t1
        if not has(p_one):
            raise AssertionError("the first owner lost the bit")
        mirror(f"Set({col}, f=1)")
        shard, off = divmod(col, SHARD_WIDTH)
        fw[shard, off // 32] |= np.uint32(1 << (off % 32))
        refresh()
        log(f"elastic anti-entropy: a bit of shard {x} posted to owner {one}'s /internal/import "
            f"alone reached owner {two} in {out['repair_s']:.3f} s (their tick {ELASTIC_SYNC_S} s, "
            f"from the config file; an even split keeps the bit)  [{card}]")

        # -- 6. a keyed index on the cluster
        t1 = time.perf_counter()
        post_json(a, "/index/kc", {"options": {"keys": True}})
        post_json(a, "/index/kc/field/kf", {"options": {"keys": True}})
        krows = rng.integers(0, ELASTIC_KEY_ROWS, ELASTIC_KEYS)
        keys = [f"col-{i}" for i in range(ELASTIC_KEYS)]
        half = ELASTIC_KEYS // 2
        # B allocates the first half; C the second half and a tenth of B's again.
        for p, lo, hi in ((b, 0, half), (ports[2], half - ELASTIC_KEYS // 10, ELASTIC_KEYS)):
            post_json(p, "/index/kc/field/kf/import",
                      {"rowKeys": [f"row-{r}" for r in krows[lo:hi].tolist()],
                       "columnKeys": keys[lo:hi]})
        # A replica reverse-translates result columns from its own store:
        # its bodies agree with the coordinator's once it has pulled the
        # coordinator's entries on an anti-entropy tick.
        # (``/debug/translate``: each store's contiguous watermark.)
        coord_ids = {k: v["maxId"] for k, v in get_json(a, "/debug/translate")["stores"].items()
                     if k.startswith("kc")}

        def pulled(p):
            stores = get_json(p, "/debug/translate")["stores"]
            return all(stores.get(k, {}).get("watermark", 0) >= v for k, v in coord_ids.items())

        wait_for("B's translation pull", lambda: pulled(b), 12 * ELASTIC_SYNC_S)
        sample = [keys[int(i)] for i in rng.integers(0, ELASTIC_KEYS, 20_000)]
        ids_by = {p: post_json(p, "/internal/translate/keys",
                               {"index": "kc", "field": None, "keys": sample})["ids"]
                  for p in ports}
        if len({json.dumps(v) for v in ids_by.values()}) != 1:
            raise AssertionError("a column key has different ids on different members")
        if len(set(ids_by[a])) != len(set(sample)):
            raise AssertionError("two column keys share an id")
        for r in (0, 7, ELASTIC_KEY_ROWS - 1):
            want_cols = sorted(keys[i] for i in np.flatnonzero(krows == r).tolist())
            got = [post_json(p, "/index/kc/query?noCache=true",
                             f'Count(Row(kf="row-{r}")) Row(kf="row-{r}")') for p in (a, b)]
            if any(g != got[0] for g in got):
                raise AssertionError(f"keyed bodies of row-{r} differ between A and B")
            res = got[0]["results"]
            if res[0] != len(want_cols) or sorted(res[1]["keys"]) != want_cols:
                raise AssertionError(f"keyed Count/Row of row-{r} differ from the oracle")
        union = "Count(Union(" + ", ".join(f'Row(kf="row-{r}")' for r in
                                           range(ELASTIC_KEY_ROWS)) + "))"
        before = node_launches(b)["plane_lookup"]
        for _ in range(20):  # auto builds the plane off the query thread first
            got = post_json(b, "/index/kc/query?noCache=true", union)
            if got != {"results": [ELASTIC_KEYS]}:
                raise AssertionError(f"keyed union via B: {got}")
            if device != "cuda" or node_launches(b)["plane_lookup"] > before:
                break
            time.sleep(0.5)
        lookups = node_launches(b)["plane_lookup"] - before
        if device == "cuda" and lookups < 1:
            raise AssertionError("B's 300-key batch never launched plane_lookup")
        out["keys_s"] = time.perf_counter() - t1
        log(f"elastic keys: {ELASTIC_KEYS} column keys allocated through B and C (a tenth "
            f"through both) on coordinator A: one id each, the same through A, B and C; keyed "
            f"Count and Row equal the oracle, through A and through B after its pull; B's "
            f"{ELASTIC_KEY_ROWS}-key "
            f"union after its translation pull: {lookups} plane_lookup launches "
            f"({out['keys_s']:.3f} s)  [{card}]")
    finally:
        for proc in d_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    for p in ports:
        take_launches(p)
    if device == "cuda":
        for k in ELASTIC_KERNELS:
            if totals[k] < 1:
                raise AssertionError(f"{k} was not launched on the elastic path")
    out["launches"] = totals
    out["seconds"] = time.perf_counter() - t_part
    passes = {p: node_counters(p).get("antiEntropyPasses", 0) - passes0[p] for p in ports}
    log(f"elastic part: anti-entropy passes a member {passes} in {out['seconds']:.3f} s "
        f"(ticks of {ELASTIC_SYNC_S} s on B and C, 10 s on A, jittered, plus each pass's "
        f"own time)")
    log(f"elastic part launches (A, B, C and D): "
        f"{json.dumps({k: v for k, v in totals.items() if v})}")
    log(f"elastic part: {out['seconds']:.3f} s  [{card}]")
    return out


def phase_cluster(torch, card: str, data: dict, runs: int = CLUSTER_RUNS) -> dict:
    """The cluster's serving path at full width. Three ``cli server --peers
    ... --replica-n 2`` processes on loopback share the card; the bench's
    rows f=1 and g=2 over all its shards go in as one ``import-roaring`` a
    field and shard through the coordinator, which routes each body to its
    two owners; a second index of 16 shards goes in through the
    coordinator's JSON /import. The section 2 Counts through each node as
    coordinator, ``Row(f=1)`` over ROW_LEG_SHARDS shards (remote legs
    decoded by ``scatter_bits_grouped`` on the coordinator) and the second index's
    TopN, GroupBy, Sum/Min/Max, Count(Distinct), Rows and Row with
    ``shards=`` (every frame type on the wire) are held to numpy oracles
    and byte for byte to node A's bodies; then acknowledged Set and Clear,
    a SIGKILLed member, the same bodies through the live coordinators
    (failing over to replicas), and the liveness sweep marking it DOWN.
    No cluster query folds a contested shard, so ``union_rows`` folds two
    live owners' remote legs of the same shards (``or_fold``), its launches
    returned apart from the queries'. A second cluster on the CLI's
    defaults (hedging on, device reduce ``auto``), booted and loaded beside
    the first and given the same writes, gives every body again after the
    writes (bodies only: hedged legs vary the launch counts); with data
    dirs, it is backed up across its members before the writes and again
    (incremental, one copy corrupt) after them, stops, and
    ``cluster_restore`` restores the chain into a fresh two-node cluster.
    Then, before the SIGKILL, ``cluster_elastic`` grows the first cluster by
    a fourth member and shrinks it back."""
    from pilosa_tpu_torch.config import SHARD_WIDTH
    from pilosa_tpu_torch.exec import device_reduce
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server import wire

    device, node_a, h = data["device"], data["node"], data["holder"]
    dev = torch.device(device)
    n_shards = data["count_shards"]
    t_phase = time.perf_counter()
    # auto's crossover on this card, measured in this process (the nodes
    # run with --device-reduce on, so every remote Row leg launches).
    xover = device_reduce._min_size(dev)
    log(f"device reduce: auto's crossover {xover} positions or folded words "
        f"({xover / SHARD_WORDS:.2f} shard rows)  [{card}]")
    kernels.reset_launches()
    t0 = time.perf_counter()
    # The phase's cluster (fixed launch counts) and one on the CLI's
    # defaults, booting and loading side by side.
    # B and C of the phase's cluster (and the elastic part's joiner) read a
    # short anti-entropy tick from a config file; A keeps the CLI's 10 s:
    # the coordinator is the busiest member, and each tick asks every
    # owned fragment's replica for its digests.
    config = Path(__file__).resolve().parent / "build" / "chip_smoke_cluster.toml"
    config.parent.mkdir(parents=True, exist_ok=True)
    config.write_text(f"anti-entropy-interval = {ELASTIC_SYNC_S}\n")
    # The defaults cluster keeps data dirs: the phase backs it up across its
    # members and restores the archive into a cluster of another size.
    shutil.rmtree(BACKUP_DIR, ignore_errors=True)
    nodes, dnodes = cluster_start(device, CLUSTER_REPLICAS, (False, True),
                                  [None, str(config), str(config)],
                                  data_dirs=[None, BACKUP_DIR / "defaults"])
    ports, dports = [p for _, p in nodes], [p for _, p in dnodes]
    coord = ports[0]
    log(f"cluster: {CLUSTER_NODES} cli server processes on ports {ports}, replica "
        f"{CLUSTER_REPLICAS}, and {CLUSTER_NODES} on the CLI's defaults on {dports}, "
        f"booted together in {time.perf_counter() - t0:.3f} s")
    sd = small_data(SEED + 5)
    collector = Collector()
    try:
        conn = http_client(coord)
        loaded = cluster_load([ports, dports], h, n_shards, sd)
        log(f"cluster load, both clusters at once in {loaded['seconds']:.3f} s: the bench's "
            f"{loaded['requests']} import-roaring requests, {loaded['bytes']} body bytes, "
            f"through each coordinator ({CLUSTER_LOAD_CLIENTS} clients a cluster; each body "
            f"to its {CLUSTER_REPLICAS} owners), and the small index's {SMALL_SHARDS} shards, "
            f"{sum(len(sd[f][0]) for f in SMALL_ROWS)} bits and {SMALL_VALUES} values, through "
            f"each coordinator's JSON /import (one client a cluster)")
        # The second index into node A alike.
        ca = http_client(node_a.port)
        for path, opts in SMALL_SCHEMA:
            expect_ok(ca, "POST", path, {"options": opts} if opts else None)
        for f in SMALL_ROWS:
            expect_ok(ca, "POST", f"/index/small/field/{f}/import",
                      {"rowIDs": sd[f][0].tolist(), "columnIDs": sd[f][1].tolist()})
        expect_ok(ca, "POST", "/index/small/field/v/import",
                  {"columnIDs": sd["v"][0].tolist(), "values": sd["v"][1].tolist()})
        base = h.field("small", "v").bsi_group.base
        want_small = small_oracles(sd, base)

        fw = np.stack([h.fragment("bench", "f", "standard", s).row_words(1)
                       for s in range(n_shards)])
        gw = np.stack([h.fragment("bench", "g", "standard", s).row_words(2)
                       for s in range(n_shards)])
        want_bench = {"count_intersect": int(popcount_rows(fw & gw).sum()),
                      "count_3leaf": int(popcount_rows((fw & gw) | gw).sum())}
        leg_shards = [int(s) for s in np.linspace(0, n_shards - 1,
                                                  min(ROW_LEG_SHARDS, n_shards)).astype(int)]
        leg_shards = sorted(set(leg_shards))

        def row_oracle(words, shards):
            return sorted(int(c) for s in shards for c in
                          bitops_columns(words[s], s * SHARD_WIDTH))

        want_row = row_oracle(fw, leg_shards)
        queries = {}  # name -> (index, path suffix, pql, oracle body or None)
        for name in CLUSTER_BENCH_QUERIES:
            queries[name] = ("bench", "", COUNT_QUERIES[name], {"results": [want_bench[name]]})
        queries["row_leg"] = ("bench", "&shards=" + ",".join(map(str, leg_shards)),
                              "Row(f=1)", {"results": [{"attrs": {}, "columns": want_row}]})
        for name, q in SMALL_QUERIES.items():
            suffix = ("&shards=" + ",".join(map(str, SMALL_ROW_SHARDS))
                      if name == "row_shards" else "")
            queries[f"small_{name}"] = ("small", suffix, q, {"results": want_small[name]})

        def ask(port, index, suffix, q):
            c = http_client(port)
            body = expect_ok(c, "POST", f"/index/{index}/query?noCache=true{suffix}", q)
            c.close()
            return body

        def check_all(coords, bodies, when, names=None):
            for name, (index, suffix, q, oracle) in queries.items():
                if names is not None and name not in names:
                    continue
                for p in coords:
                    got = ask(p, index, suffix, q)
                    if got != bodies[name]:
                        raise AssertionError(f"cluster {name} via {p} {when}: body differs "
                                             f"from node A's: {body_diff(got, bodies[name])}")
            log(f"cluster: {len(names or queries)} queries via {len(coords)} coordinators "
                f"{when}: every body byte-equal to node A's")

        # node A's bodies, each held to its oracle
        bodies = {}
        for name, (index, suffix, q, oracle) in queries.items():
            bodies[name] = ask(node_a.port, index, suffix, q)
            if oracle is not None and json.loads(bodies[name]) != oracle:
                raise AssertionError(f"node A {name}: {bodies[name][:300]!r} != oracle")
        before = {p: node_launches(p) for p in ports}
        check_all(ports, bodies, "(oracle and node A)")
        after = {p: node_launches(p) for p in ports}
        deltas = {p: {k: after[p][k] - before[p][k] for k in after[p]} for p in ports}
        for p in ports:
            log(f"cluster node {p} launches over the queries: "
                f"{json.dumps({k: v for k, v in deltas[p].items() if v})}")
        if device == "cuda":
            for k in CLUSTER_KERNELS_NODES:
                if any(deltas[p][k] < 1 for p in ports):
                    raise AssertionError(f"{k} did not launch on every node's legs")
            if deltas[coord]["scatter_bits_grouped"] < 1:
                raise AssertionError("scatter_bits_grouped did not launch on the coordinator")
            if any(deltas[p]["scatter_bits"] for p in ports):
                raise AssertionError("a remote leg's decode launched the general scatter_bits")
            # one section 2 Count: one pair_count a leg, the legs' nodes
            before = {p: node_launches(p)["pair_count"] for p in ports}
            ask(coord, "bench", "", COUNT_QUERIES["count_intersect"])
            per_leg = {p: node_launches(p)["pair_count"] - before[p] for p in ports}
            if sorted(per_leg.values()) != [1] * CLUSTER_NODES:
                raise AssertionError(f"section 2 Count: pair_count a node {per_leg}")
            before = node_launches(coord)["scatter_bits_grouped"]
            ask(coord, "bench", queries["row_leg"][1], "Row(f=1)")
            row_legs = node_launches(coord)["scatter_bits_grouped"] - before
            log(f"cluster section 2 Count: pair_count launches a node {per_leg}; "
                f"Row(f=1) over {len(leg_shards)} shards: {row_legs} scatter_bits_grouped on "
                f"the coordinator (one a remote leg)  [{card}]")
            if row_legs < 1:
                raise AssertionError("Row(f=1): no remote leg decoded by scatter_bits_grouped")

        q = COUNT_QUERIES["count_intersect"]
        p50_c, spread_c = p50_ms(lambda: ask(coord, "bench", "", q), runs)
        p50_a, spread_a = p50_ms(lambda: ask(node_a.port, "bench", "", q), runs)
        log(f"section 2 Count over HTTP: cluster coordinator p50 {p50_c:.3f} ms "
            f"({spread_c}), standalone node A p50 {p50_a:.3f} ms ({spread_a}), host clock, "
            f"{runs} runs each  [{card}]")
        doc = json.loads(expect_ok(conn, "GET", "/debug/vars"))
        wire_ctr = {k: v for k, v in doc["counters"].items() if k.startswith("cluster.wire")}
        log(f"coordinator wire counters: {json.dumps(wire_ctr)}")
        # Where one Count's time goes: the coordinator's profile, each remote
        # leg's round trip beside the peer's own total.
        prof = json.loads(ask(coord, "bench", "&profile=true", q))["profile"]
        legs = "; ".join(
            f"{leg['node']} {leg['shards']} shards rtt {leg['rttMs']:.3f} ms (peer "
            f"{leg.get('remote', {}).get('timings', {}).get('totalMs', float('nan')):.3f}, "
            f"decode {leg['decodeMs']:.3f}, {leg['bytesIn']} B)"
            for leg in prof.get("remoteLegs", []))
        log(f"section 2 Count profiled on the coordinator: total "
            f"{prof['timings'].get('totalMs', 0):.3f} ms, timings {json.dumps(prof['timings'])}, "
            f"device {prof['dispatch']['deviceMs']:.3f} ms; legs: {legs}  [{card}]")

        # The defaults cluster's full backup across its members, before the
        # writes: its 954 shards of f=1 and g=2 and the small index.
        full, secs = backup_run(dports[0], {"archive": str(BACKUP_DIR / "archive")},
                                "the full cluster backup")
        from pilosa_tpu_torch.backup import LocalDirArchive
        manifest = LocalDirArchive(str(BACKUP_DIR / "archive")).read_manifest(full["id"])
        frags = {(e["index"], e["field"], e["view"], e["shard"]) for e in manifest["files"]
                 if e["kind"] in ("snap", "wal")}
        sources = {}
        for e in manifest["files"]:
            if "source" in e:
                sources[e["source"]] = sources.get(e["source"], 0) + 1
        backup_full = {"s": secs, "fragments": len(frags), "files": len(manifest["files"]),
                       "bytes": dir_bytes(BACKUP_DIR / "archive")}
        log(f"cluster backup, full {full['id']} through {dports[0]} (POST /backup): "
            f"{len(frags)} fragments, {len(manifest['files'])} files, "
            f"{backup_full['bytes']} archive bytes in {secs:.3f} s (client clock); files by "
            f"the member they were captured from {json.dumps(sources)}; the members' data "
            f"dirs {dir_bytes(BACKUP_DIR / 'defaults')} bytes  [{card}]")

        # Writes through the coordinator, acknowledged, then node A alike.
        s = leg_shards[len(leg_shards) // 2]
        fb = np.unpackbits(fw[s].view(np.uint8), bitorder="little").astype(bool)
        gb = np.unpackbits(gw[s].view(np.uint8), bitorder="little").astype(bool)
        col_set = s * SHARD_WIDTH + int(np.flatnonzero(~fb & gb)[0])
        col_clear = s * SHARD_WIDTH + int(np.flatnonzero(fb & gb)[0])
        writes = f"Set({col_set}, f=1) Clear({col_clear}, f=1)"
        for p in (coord, dports[0], node_a.port):
            c = http_client(p)
            got = json.loads(expect_ok(c, "POST", "/index/bench/query", writes))
            c.close()
            if got != {"results": [True, True]}:
                raise AssertionError(f"writes via {p}: {got}")
        want_row = sorted(set(want_row) - {col_clear} | {col_set})
        queries["row_leg"] = queries["row_leg"][:3] + (
            {"results": [{"attrs": {}, "columns": want_row}]},)
        bodies["row_leg"] = ask(node_a.port, "bench", queries["row_leg"][1], "Row(f=1)")
        if json.loads(bodies["row_leg"]) != queries["row_leg"][3]:
            raise AssertionError("node A Row(f=1) after the writes differs from the oracle")
        # The CLI's defaults, as a user's cluster runs: hedged reads on and
        # the device reduce on auto. The same data and writes, every body
        # again; then the defaults cluster stops, before the elastic part
        # (its three processes would share the host with the resize).
        before = {p: node_launches(p) for p in dports}
        check_all(dports, bodies, "(CLI defaults: hedged reads on, device reduce auto)")
        for p in dports:
            now = node_launches(p)
            c = http_client(p)
            hedge = json.loads(expect_ok(c, "GET", "/debug/overload"))["hedge"]
            c.close()
            if hedge is None or hedge["primaries"] < 1:
                raise AssertionError(f"node {p} on the defaults: no hedge policy on its "
                                     f"legs: {hedge}")
            log(f"cluster node {p} on the defaults: hedge primaries {hedge['primaries']}, "
                f"fired {hedge['fired']}, won {hedge['won']}; scatter_bits_grouped "
                f"{now['scatter_bits_grouped'] - before[p]['scatter_bits_grouped']}, "
                f"scatter_bits {now['scatter_bits'] - before[p]['scatter_bits']}, or_fold "
                f"{now['or_fold'] - before[p]['or_fold']} (auto's calibration included)")
        restored = cluster_restore(card, device, dports, s, full, check_all, bodies,
                                   collector, lambda: cluster_kill(dnodes))
        restored["full"] = backup_full

        for col, on in ((col_set, True), (col_clear, False)):
            word, bit = divmod(col - s * SHARD_WIDTH, 32)
            fw[s, word] = fw[s, word] | np.uint32(1 << bit) if on else \
                fw[s, word] & np.uint32(~(1 << bit) & 0xFFFFFFFF)

        def mirror(pql):
            """An elastic write, acknowledged, on node A too, so every later
            body check holds."""
            c = http_client(node_a.port)
            got = json.loads(expect_ok(c, "POST", "/index/bench/query", pql))
            c.close()
            if not all(got["results"]):
                raise AssertionError(f"mirrored {pql} via node A: {got}")

        def refresh():
            """The bench queries' oracles from fw and gw, and node A's bodies
            of every query, each held to its oracle."""
            want = {"count_intersect": int(popcount_rows(fw & gw).sum()),
                    "count_3leaf": int(popcount_rows((fw & gw) | gw).sum())}
            for name in CLUSTER_BENCH_QUERIES:
                queries[name] = queries[name][:3] + ({"results": [want[name]]},)
            queries["row_leg"] = queries["row_leg"][:3] + (
                {"results": [{"attrs": {}, "columns": row_oracle(fw, leg_shards)}]},)
            for name, (index, suffix, q, oracle) in queries.items():
                bodies[name] = ask(node_a.port, index, suffix, q)
                if json.loads(bodies[name]) != oracle:
                    raise AssertionError(f"node A {name} differs from its oracle")

        elastic = cluster_elastic(card, device, ports, str(config), fw, mirror, refresh,
                                  check_all, bodies)
        conn.close()  # idle past the server's keep-alive timeout by now
        conn = http_client(coord)

        # SIGKILL one member: the live coordinators fail over to replicas.
        killed_proc, killed = nodes[CLUSTER_KILLED]
        killed_proc.kill()
        killed_proc.wait()
        live = [p for p in ports if p != killed]
        t0 = time.perf_counter()
        check_all(live, bodies, f"after SIGKILL of {killed}")
        log(f"cluster failover: every query via {live} answered in "
            f"{time.perf_counter() - t0:.3f} s with member {killed} dead")
        t0 = time.perf_counter()
        while True:
            doc = json.loads(expect_ok(conn, "GET", "/debug/membership"))
            state = {p["id"]: p["state"] for p in doc["peers"]}
            if state.get(f"127.0.0.1:{killed}") == "DOWN":
                break
            if time.perf_counter() - t0 > CLUSTER_SWEEP_WAIT_S:
                raise AssertionError(f"/debug/membership: {killed} not DOWN: {state}")
            time.sleep(0.5)
        log(f"/debug/membership on {coord}: {killed} DOWN after "
            f"{time.perf_counter() - t0:.3f} s (liveness sweep), cluster {doc['state']}, "
            f"fenced {doc['fenced']}")

        # No cluster query folds a contested shard (placement gives each
        # shard to one leg); fold two live owners' remote legs of the same
        # shards here, on the device.
        owned = []
        for s in range(n_shards):
            ns = json.loads(expect_ok(conn, "GET",
                                      f"/internal/fragment/nodes?index=bench&shard={s}"))
            if {n["id"] for n in ns} == {f"127.0.0.1:{p}" for p in live}:
                owned.append(s)
            if len(owned) == 4:
                break
        if not owned:
            raise AssertionError("no shard owned by both live members")
        kernels.reset_launches()  # from here: this process's fold alone
        device_reduce.set_mode("on")
        try:
            legs = []
            for p in live:
                c = http_client(p)
                st, frame = request(c, "POST", "/index/bench/query?remote=true&shards="
                                    + ",".join(map(str, owned)), "Row(f=1)",
                                    {"Accept": wire.FRAMES_ACCEPT_V2})
                c.close()
                if st != 200:
                    raise AssertionError(f"remote leg via {p}: HTTP {st}")
                legs.extend(wire.decode_frames(frame, device=dev))
            folded = device_reduce.union_rows(legs)
        finally:
            device_reduce.set_mode("auto")
        want_fold = row_oracle(np.stack([fw[s] for s in range(n_shards)]), owned)
        want_fold = sorted(set(want_fold) - {col_clear} | ({col_set} if col_set // SHARD_WIDTH
                                                         in owned else set()))
        if [int(c) for c in folded.columns()] != want_fold:
            raise AssertionError("union_rows of contested legs differs from the oracle")
        fold = dict(kernels.LAUNCHES)
        log(f"contested fold (constructed, not a cluster query): shards {owned} from "
            f"{len(legs)} remote legs, union_rows = oracle; this process launched "
            f"{json.dumps({k: v for k, v in fold.items() if v})}")
        if device == "cuda" and (fold["or_fold"] < 1 or fold["scatter_bits_grouped"] < 1
                                 or fold["scatter_bits"]):
            raise AssertionError("the contested fold launched no or_fold / "
                                 "scatter_bits_grouped, or the general scatter_bits")
        conn.close()
        ca.close()

    finally:
        cluster_stop(nodes + dnodes)
        collector.close()
        shutil.rmtree(BACKUP_DIR, ignore_errors=True)
    launches = {k: sum(deltas[p][k] for p in ports) + elastic["launches"][k]
                + restored["launches"][k] for k in deltas[coord]}
    log(f"cluster path launches (nodes' query legs and coordinators, the elastic part's "
        f"and the restored members' included): "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    log(f"cluster phase body: {time.perf_counter() - t_phase:.3f} s")
    return {"launches": launches, "fold_launches": fold, "elastic": elastic,
            "restored": restored, "p50": {"cluster": p50_c, "node_a": p50_a},
            "crossover": xover}


#: loadgen's scenarios the smoke run drives, each gated against its
#: baseline in scripts/slo_baselines/, and where their reports go.
LOADGEN_SCENARIOS = ("smoke3", "dr_drill")
LOADGEN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_loadgen"
LOADGEN_TIMEOUT_S = 300


def phase_loadgen(torch, card: str, data: dict) -> dict:
    """``python -m pilosa_tpu_torch.loadgen <scenario> --device <device>``
    for each of LOADGEN_SCENARIOS: managed port nodes in the loadgen
    process (on the card), open-loop traffic, chaos (a slow peer that
    heals; in ``dr_drill`` scheduled backups through a fault-injecting
    object store, a member resized out with its data dir destroyed, and the
    archive restored into a recovery cluster), each report gated by
    ``scripts/slo_gate.py`` against its unchanged baseline."""
    root = Path(__file__).resolve().parent
    shutil.rmtree(LOADGEN_DIR, ignore_errors=True)
    LOADGEN_DIR.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PILOSA_TPU_")}
    out = {}
    for name in LOADGEN_SCENARIOS:
        report = LOADGEN_DIR / f"{name}.json"
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch.loadgen", name,
                              "--device", data["device"], "--quiet", "--out", str(report)],
                             cwd=root, env=env, capture_output=True, text=True,
                             timeout=LOADGEN_TIMEOUT_S)
        secs = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"loadgen {name}: exit {run.returncode}: {run.stderr[-3000:]}")
        gate = subprocess.run([sys.executable, str(root / "scripts" / "slo_gate.py"),
                               str(report), str(root / "scripts" / "slo_baselines" /
                                                f"{name}.json")],
                              cwd=root, capture_output=True, text=True, timeout=60)
        rep = json.loads(report.read_text())
        classes = "; ".join(
            f"{cls} client p50 {v['client']['p50Ms']} p99 {v['client']['p99Ms']} ms "
            f"({v['client']['count']} requests, errorRate {v['errorRate']})"
            + (f", server p50 {v['server']['p50Ms']} p99 {v['server']['p99Ms']} ms"
               if v.get("server") else "")
            for cls, v in sorted(rep["perClass"].items()))
        log(f"loadgen {name}: {rep['target']['nodes']} managed nodes on {data['device']}, "
            f"{rep['arrivals']['dispatched']} requests at {rep['arrivals']['rateAchieved']}/s "
            f"(target {rep['arrivals']['rateTarget']}); {classes}; hedgeFired "
            f"{rep['rates']['hedgeFired']}, hedgeWon {rep['rates']['hedgeWon']}, cache "
            f"hitRatio {rep['cache']['hitRatio']}; chaos "
            f"{[(c['action'], c['ok']) for c in rep['chaos']]}; {secs:.3f} s of command  "
            f"[{card}]")
        if rep.get("dr"):
            log(f"loadgen {name} dr: {json.dumps(rep['dr'], sort_keys=True)}")
        log(f"loadgen {name} gate: {gate.stdout.strip()}")
        if gate.returncode != 0:
            raise AssertionError(f"loadgen {name}: scripts/slo_gate.py exit "
                                 f"{gate.returncode}: {gate.stdout[-2000:]}")
        out[name] = {"s": secs, "perClass": rep["perClass"], "rates": rep["rates"],
                     "dr": rep.get("dr")}
    shutil.rmtree(LOADGEN_DIR, ignore_errors=True)
    return out


def bitops_columns(words: np.ndarray, base: int) -> np.ndarray:
    """Absolute columns of one shard's uint32 words."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.int64) + base


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
              ("packed", lambda: phase_packed(torch, card, data)),
              ("fields", lambda: phase_fields(torch, card, data)),
              ("keys", lambda: phase_keys(torch, card, data)),
              ("cluster", lambda: phase_cluster(torch, card, data)),
              ("loadgen", lambda: phase_loadgen(torch, card, data)))
    total = 0.0
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
            total += time.perf_counter() - t0
            log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
        log(f"phases: {total:.3f} s in all")
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
                                 "packed", "fields", "keys", "cluster"))
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
               "group_count": "pilosa_tpu_torch/csrc/group_kernels.cu",
               **dict.fromkeys(PACKED_KERNELS, "pilosa_tpu_torch/csrc/packed_kernels.cu"),
               "plane_scatter": "pilosa_tpu_torch/csrc/ingest_kernels.cu",
               **dict.fromkeys(("hll_expand", "hll_reduce", "similar_count"),
                               "pilosa_tpu_torch/csrc/sketch_kernels.cu"),
               "plane_lookup": "pilosa_tpu_torch/csrc/keyplane_kernels.cu",
               **dict.fromkeys(("scatter_bits_grouped", "scatter_bits", "or_fold"),
                               "pilosa_tpu_torch/csrc/reduce_kernels.cu")}
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
                               "(XLA-fused, no pallas_call)",
                "packed_count": "pilosa_tpu/exec/residency.py:175-177 packed_count "
                                "(XLA-fused, no pallas_call)",
                "packed_and_dense_count": "pilosa_tpu/exec/residency.py:180-188 "
                                          "packed_and_dense_count (XLA-fused, no "
                                          "pallas_call)",
                "packed_pair_count": "pilosa_tpu/exec/residency.py:191-203 "
                                     "packed_pair_count (XLA-fused, no pallas_call)",
                "packed_expand": "pilosa_tpu/exec/residency.py:158-172 packed_expand "
                                 "(XLA-fused, no pallas_call)",
                "plane_scatter": "pilosa_tpu/exec/ingest_transpose.py:115-142 "
                                 "_plane_scatter (XLA-fused, no pallas_call)",
                "hll_expand": "pilosa_tpu/sketch/kernels.py:32-49 hll_expand, in the "
                              "distinct program pilosa_tpu/parallel/planner.py:749 "
                              "(XLA-fused, no pallas_call)",
                "hll_reduce": "pilosa_tpu/sketch/kernels.py:52-54 hll_reduce and "
                              "pilosa_tpu/parallel/planner.py:744,749 jnp.max(..., axis=0) "
                              "(XLA-fused, no pallas_call)",
                "similar_count": "pilosa_tpu/sketch/kernels.py:85-108 similar_program's "
                                 "totals (XLA-fused, no pallas_call)",
                "plane_lookup": "pilosa_tpu/exec/keyplane.py:149-171 _search + "
                                "plane_lookup (XLA-fused, no pallas_call)",
                "scatter_bits_grouped": "pilosa_tpu/exec/device_reduce.py:111-118 "
                                        "_scatter_bits, as row_from_columns (:127-152) "
                                        "calls it on a leg's sorted positions (XLA-fused, "
                                        "no pallas_call)",
                "scatter_bits": "pilosa_tpu/exec/device_reduce.py:111-118 _scatter_bits "
                                "(XLA-fused, no pallas_call)",
                "or_fold": "pilosa_tpu/exec/device_reduce.py:120-124 _or_fold "
                           "(XLA-fused, no pallas_call)"}
    packed_program = " (planner.py:1906-1929 _packed_count_program)"
    replaces.update({
        f"{name}_batched": f"{vmapped} over {replaces[name]}{packed_program}"
        for name in ("packed_count", "packed_and_dense_count", "packed_pair_count")})
    # No cluster query folds a contested shard: the cluster phase folds
    # remote legs itself, and the line labels those launches.
    fold = results["cluster"]["fold_launches"]
    entries = []
    for name in sources:
        ms, plain, bound, by, lib = timings[name]
        entries.append({"name": name, "route": "cuda", "source": sources[name],
                        "replaces": replaces[name], "launches": launches[name] + fold[name],
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                        "bound_ms": bound, "bound_by": by, "library_ms": lib})
        if fold[name]:
            entries[-1]["launches_constructed_fold"] = fold[name]
        if name == "scatter_bits":  # checked and timed here; no path calls it
            entries[-1]["path"] = ("none: input not grouped by segment; remote legs "
                                   "decode through scatter_bits_grouped")
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
    if sys.argv[1:2] == ["--group-count"] and len(sys.argv) == 3:
        sys.exit(group_count_times(sys.argv[2]))
    if sys.argv[1:2] == ["--group-count-vs"] and len(sys.argv) == 3:
        sys.exit(group_count_vs(sys.argv[2]))
    if sys.argv[1:2] == ["--packed"] and len(sys.argv) == 3:
        sys.exit(packed_times(sys.argv[2]))
    if sys.argv[1:2] == ["--packed-vs"] and len(sys.argv) == 3:
        sys.exit(packed_vs(sys.argv[2]))
    if sys.argv[1:2] == ["--plane-scatter"] and len(sys.argv) == 3:
        sys.exit(plane_scatter_times(sys.argv[2]))
    if sys.argv[1:2] == ["--plane-scatter-vs"] and len(sys.argv) == 3:
        sys.exit(plane_scatter_vs(sys.argv[2]))
    if sys.argv[1:2] == ["--sketch"] and len(sys.argv) == 3:
        sys.exit(sketch_times(sys.argv[2]))
    if sys.argv[1:2] == ["--sketch-vs"] and len(sys.argv) == 3:
        sys.exit(sketch_vs(sys.argv[2]))
    if sys.argv[1:2] == ["--reduce"] and len(sys.argv) == 3:
        sys.exit(reduce_times(sys.argv[2]))
    if sys.argv[1:2] == ["--reduce-vs"] and len(sys.argv) == 3:
        sys.exit(reduce_vs(sys.argv[2]))
    if sys.argv[1:] == ["--import-rule"]:
        sys.exit(import_rule_vs())
    if sys.argv[1:2] == ["--import-rule-side"] and len(sys.argv) == 3:
        sys.exit(import_rule_side(int(sys.argv[2])))
    sys.exit(main())
