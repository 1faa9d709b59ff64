"""Planner — run a PQL bitmap call tree over all shards of one device at
once, as ``[S_pad, W]`` stacks.

The port's counterpart of pilosa_tpu/parallel/planner.py (MeshPlanner),
cut down to one GPU: no mesh, no jit (PyTorch runs eagerly). This replaces
the reference's hot loop (executor.go:2561-2608: per-shard jobs, each
running per-container roaring kernels):

- every leaf ``Row()`` of the tree becomes an ``[S_pad, W]`` int32 stack —
  shard ``s``'s row in slot ``s``, zero rows past the last shard — cached
  on the device until a fragment under it mutates; ``Not`` adds the
  existence row (``_exists`` row 0) as a leaf;
- a standard-view ``Row()`` with no time bounds whose row is sparse enough
  (``exec/residency.choose_class`` on its largest per-shard cardinality)
  is held packed instead: an ``[S_pad, K]`` stack of sorted in-shard
  positions (a ``prow`` leaf, a ``pleaf`` node). Its Count is one
  ``packed_count``, a 2-leaf Intersect with it one
  ``packed_and_dense_count`` or ``packed_pair_count``, and every other
  tree expands it to a dense plane (``packed_expand``) and runs the dense
  kernels below;
- a ``Row(f=r, from=..., to=...)`` (or ``Range``) over a time field is the
  ``or`` of its row in each existing time view that covers the window: one
  leaf per view in the op tape, so a Count over it is one ``tree_count``
  (cut where the views outnumber the tape's leaves); no view is the zero
  leaf;
- a BSI condition ``Row(v > x)`` reads the field's exists and sign stacks
  and its magnitude planes as one cached ``[depth, S_pad, W]`` cube, and
  runs the ``bsi_compare`` kernel against the exists row; its output plane
  enters the tree as a leaf, and the sign-class branches become tree ops
  on the exists and sign leaves;
- a ``Shift`` node's child is evaluated to a plane, shifted by the
  ``shift_left`` kernel, and enters the tree as a leaf;
- the tree over those leaves is one postfix op tape: ``Count`` of a bare
  leaf runs the ``row_counts`` kernel, of a 2-leaf op the ``pair_count``
  kernel, and of every other tree ONE ``tree_count`` launch, which reads
  each leaf once and writes no intermediate plane. A bitmap result
  (``execute_bitmap``, TopN's filter, Store's source) is the same launch
  with its result plane written;
- ``Sum`` counts the cube against the positive and negative class rows
  with ``pair_count`` (an ``[S_pad, W]`` row against the ``[depth, S_pad,
  W]`` cube), ``Min``/``Max`` run the ``bsi_minmax`` descent on every shard
  at once;
- per-shard int32 counts come back to the host and are widened to int64
  before the cross-shard sum (reference reduceFn, executor.go:2455); Sum's
  2^i weights are applied in Python ints;
- a GroupBy lattice (``execute_group_by``) stacks each level's candidate
  rows and counts every group, filtered, in ONE ``group_count`` launch.

``prepare_count`` keeps the reference's plan cache: a repeated Count text
over the same shards and schema skips the signature walk, and its leaves
re-resolve through the epoch-validated stack cache.

The async path is the JAX planner's (pilosa_tpu/parallel/planner.py
:226-396, :553-645, :878-892, :1336-1525): every Count, Sum and Min/Max
launch goes through ``DispatchCoalescer.dispatch`` (a same-plan wave runs
as one launch, shared or batched) and its small output through
``TransferBatcher.submit`` (a pinned, event-ordered copy to the host; no
synchronising ``.cpu()``), and so do TopN's filter and tile counts. At
prepare time the plan's non-resident stacks go to the
``ResidencyPrefetcher``, whose workers upload them on the planner's upload
stream. On a CUDA device a sparse row (at most ``SPARSE_UPLOAD_MAX_BITS``
set bits in a shard) crosses PCIe as COO words, and the ``assemble_stack``
kernel builds its stack, each word written once; ``upload_split_ms``
splits the newest stack build's time into its phases.
"""

from __future__ import annotations

import datetime as dt
import functools
import itertools
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch

from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core.fragment import (
    BSI_EXISTS_BIT,
    BSI_OFFSET_BIT,
    BSI_SIGN_BIT,
    resolve_counts,
    row_id_arg,
)
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD, is_time_view, view_bsi_name
from pilosa_tpu_torch.errors import (
    BSIGroupNotFoundError,
    FieldNotFoundError,
    QueryError,
)
from pilosa_tpu_torch.exec import fuse as _fuse
from pilosa_tpu_torch.exec import residency as _residency
from pilosa_tpu_torch.obs import profile as _profile
from pilosa_tpu_torch.obs.histogram import WIDTH_BOUNDS, LogHistogram
from pilosa_tpu_torch.ops import bitops, kernels
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.parallel.batcher import TransferBatcher
from pilosa_tpu_torch.parallel.coalesce import DispatchCoalescer
from pilosa_tpu_torch.parallel.prefetch import ResidencyPrefetcher
from pilosa_tpu_torch.pql import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ, Call, Condition

_BITMAP_CALLS = frozenset(
    {"Row", "Range", "Difference", "Intersect", "Union", "Xor", "Not", "Shift"})
#: set-algebra calls -> the tape op that folds their children.
_PAIR_OPS = {"intersect": "and", "union": "or", "xor": "xor",
             "difference": "andnot"}


class Planner:
    """Shard-stacked execution of bitmap call trees on the holder's device."""

    #: default device-memory budget for cached leaf stacks (bytes).
    DEFAULT_CACHE_BYTES = 4 << 30

    #: prepared plans kept (LRU) and observed query shapes remembered.
    PLAN_CACHE_SIZE = 128
    OBSERVED_SIZE = 256

    #: rows with at most this many set bits in a shard upload as COO words
    #: (12 B per set word) instead of the 128 KiB dense block, where the
    #: host-to-device link is the expensive one (a CUDA device).
    SPARSE_UPLOAD_MAX_BITS = 2048

    def __init__(self, holder, max_cache_bytes: int = DEFAULT_CACHE_BYTES,
                 bucket_policy: str = "pow2", stats=None,
                 coalesce_window_us: float | None = None):
        self.holder = holder
        self.device = holder.device
        self.stats = stats
        #: plan-shape bucketing ("pow2" | "none"): stack heights round up
        #: to powers of two, so the space of [S_pad, W] shapes stays
        #: O(log S) (see _pad).
        if bucket_policy not in ("pow2", "none"):
            raise ValueError(f"bucket_policy must be pow2 or none, got "
                             f"{bucket_policy!r}")
        self.bucket_policy = bucket_policy
        #: LRU of (index, instance, field, view, row_id, shards) ->
        #: (epoch, gens, [S_pad, W] tensor, upload event or None); bounded
        #: by max_cache_bytes.
        #: A hit is ONE integer compare against the index's mutation
        #: epoch; only an epoch change triggers the per-fragment
        #: generation walk (and only for the touched leaf).
        self._stack_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._cache_bytes = 0
        #: resident bytes by representation class (the key's last element).
        self._class_bytes = {k: 0 for k in _residency.REPR_CLASSES}
        self.max_cache_bytes = max_cache_bytes
        #: lifetime host->device stack builds and their device bytes, and
        #: the bytes that crossed the link for them (less, for sparse rows).
        self.uploads = 0
        self.upload_bytes = 0
        self.h2d_bytes = 0
        #: the newest row-stack build's phases; upload_split_ms reads them.
        self._last_upload: dict = {}
        #: lifetime LRU evictions past the budget, and stack lookups the
        #: cache answered (a resident, current stack).
        self.evictions = 0
        self.stack_hits = 0
        self._cache_lock = threading.Lock()
        #: key -> event set when the build of that key in flight ends.
        self._building: dict[tuple, threading.Event] = {}
        #: structural signature -> count or bitmap program
        self._fn_cache: dict[tuple, Callable] = {}
        #: prepared plans: (index, instance, schema epoch, call text,
        #: shards) -> (leaf descriptors, program, data epoch). A repeated
        #: query shape skips the signature walk; its leaves re-resolve
        #: through the stack cache every query, so plans pin no device
        #: memory and never go stale.
        self._plan_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        #: (index, executable query text, shard count) -> hits, recency
        #: ordered: the shapes real traffic ran, which ServerNode persists
        #: and the next boot's warmup replays.
        self._observed: "OrderedDict[tuple, int]" = OrderedDict()
        #: the filter's host words for TopN's two passes (same filter, same
        #: epoch), keyed by call text, shards and epoch; a few entries.
        self._filter_host_cache: dict[tuple, np.ndarray] = {}
        #: id(program) -> its full signature: the coalescer's batch key.
        #: Entries live as long as _fn_cache pins the program.
        self._fn_keys: dict[int, tuple] = {}
        #: launch accounting (planner.dispatchCount / dispatchCoalesced /
        #: coalesceBatchWidth on /debug/vars).
        self._dispatch_lock = threading.Lock()
        self.dispatches = 0
        self.dispatches_coalesced = 0
        self._batch_widths: "deque[int]" = deque(maxlen=512)
        self._width_hist = LogHistogram(bounds=WIDTH_BOUNDS, lock=False)
        #: the stream stack uploads run on (CUDA), made at first use.
        self._upload_stream = None
        #: result copies to the host, same-plan launch waves, and the
        #: async miss path (parallel/batcher, coalesce, prefetch).
        self.batcher = TransferBatcher(stats=stats)
        self.coalescer = DispatchCoalescer(self, coalesce_window_us)
        self.prefetcher = ResidencyPrefetcher(self, stats=stats)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def supports(self, c: Call) -> bool:
        """True if the call tree is bitmap algebra this planner runs: Row
        leaves (BSI conditions included) under Intersect/Union/Xor/
        Difference, Not, and Shift with a literal ``n >= 0`` (reference
        planner.py:204-217; ``n >= SHARD_WIDTH`` legally gives zeros)."""
        if c.name not in _BITMAP_CALLS:
            return False
        if c.name in ("Row", "Range"):
            return True
        if c.name == "Shift":
            n = c.args.get("n", 0)
            if not isinstance(n, int) or isinstance(n, bool) or n < 0:
                return False
        return all(self.supports(ch) for ch in c.children)

    def supports_aggregate(self, idx: Index, c: Call) -> bool:
        """True for Sum/Min/Max calls whose (optional) filter child is a
        plannable bitmap tree over an existing BSI field."""
        if c.name not in ("Sum", "Min", "Max") or len(c.children) > 1:
            return False
        if c.children and not self.supports(c.children[0]):
            return False
        field_name, ok = c.string_arg("field")
        if not ok:
            return False
        f = idx.field(field_name)
        return f is not None and f.bsi_group is not None

    def execute_count(self, idx: Index, c: Call, shards: list[int],
                      const_rows: list | None = None) -> int:
        """Count(tree) over ``shards``: one count program on the stacked
        leaves, its per-shard counts delivered by the batcher."""
        return self.execute_count_async(idx, c, shards, const_rows=const_rows,
                                        waited=True).result()

    def execute_count_async(self, idx: Index, c: Call, shards: list[int],
                            const_rows: list | None = None,
                            waited: bool = False) -> Future:
        """Dispatch Count(tree) and return a Future[int]: the program is
        launched (or joins a wave) now, and the future resolves when its
        counts land on the host (reference planner.py:226). ``waited``: the
        caller calls ``result()`` next (TransferBatcher.submit)."""
        if not shards:
            fut: Future = Future()
            fut.set_result(0)
            return fut
        fn, arrays = self.prepare_count(idx, c, shards, const_rows=const_rows)
        _fuse.add_fused_steps(_fuse.call_steps(c) + 1)
        return self.dispatch_count(fn, arrays, waited=waited)

    @staticmethod
    def _sum_host(host) -> int:
        """Per-shard int32 popcounts (<= 2^30 each) widened before the sum:
        immune to int32 overflow across many full shards."""
        return int(np.asarray(host).astype(np.int64).sum())

    def dispatch_count(self, fn, arrays, post=None, waited: bool = False) -> Future:
        """Launch a prepared count's program through the coalescer;
        Future[int] (or ``post`` of the per-shard counts)."""
        return self.coalescer.dispatch(fn, arrays, post or self._sum_host, waited)

    # -- launch accounting / program registry --------------------------

    def _record_dispatch(self, width: int = 1, device_ms: float = 0.0,
                         profs=None) -> None:
        """One program launch answering ``width`` queries. ``profs``: the
        profiles of the queries it served (the coalescer passes them, its
        flusher has no query context); omitted, the active one is charged."""
        with self._dispatch_lock:
            self.dispatches += 1
            if width > 1:
                self.dispatches_coalesced += width - 1
            self._batch_widths.append(width)
            self._width_hist.observe(width)
        if self.stats is not None:
            self.stats.count("planner.dispatchCount", 1)
            if width > 1:
                self.stats.count("planner.dispatchCoalesced", width - 1)
            self.stats.gauge("planner.coalesceBatchWidth", width)
        if profs is None:
            p = _profile.current()
            profs = (p,) if p is not None else ()
        for p in profs:
            if p is not None:
                p.add_dispatch(width, device_ms)

    def batch_widths(self) -> list[int]:
        """Recent per-launch batch widths."""
        with self._dispatch_lock:
            return list(self._batch_widths)

    def fn_key(self, fn):
        """The coalescer's batch key for a program: its full signature
        (None for a callable the planner did not make)."""
        return self._fn_keys.get(id(fn))

    def fn_batched(self, fn):
        """The batched form of a program -- [args per slot] -> [B, ...] in
        one launch -- or None where it has none (the fused aggregates, and
        count programs with a packed leaf off the packed fast paths: their
        waves run slot by slot, where the JAX coalescer vmaps them into one
        launch). The counterpart of the JAX planner's fn_raw + vmapped."""
        if isinstance(fn, _CountProgram) and fn.has_batched:
            return fn.batched
        return None

    def prepare_count(self, idx: Index, c: Call, shards: list[int],
                      const_rows: list | None = None):
        """Count(tree) resolved to its (program, leaf device inputs)
        without running it (reference prepare_count, planner.py:243). The
        plan cache keys on the schema epoch -- plans bake field structure
        (a comparator's depth, sign-class branches) -- and the call text;
        a plan with ``__const__`` leaves bypasses it, since its text is the
        same while its host rows differ per query."""
        hit = None
        if const_rows is None:
            plan_key = (idx.name, idx.instance_id, idx.schema_epoch.value,
                        str(c), tuple(shards))
            with self._cache_lock:
                hit = self._plan_cache.get(plan_key)
                if hit is not None:
                    self._plan_cache.move_to_end(plan_key)
            if hit is not None:
                hit = self._revalidate_plan(idx, plan_key, hit, tuple(shards))
        if hit is not None:
            leaves, fn = hit[0], hit[1]
        else:
            leaves = []
            sig = self._signature(idx, c, leaves, tuple(shards))
            fn = self._compiled(("count",) + sig, sig, "per_shard")
            if const_rows is None and not _time_bound(leaves):
                with self._cache_lock:
                    self._plan_cache[plan_key] = (leaves, fn, idx.epoch.value)
                    while len(self._plan_cache) > self.PLAN_CACHE_SIZE:
                        self._plan_cache.popitem(last=False)
                    # The executable form, with the Count wrapper: warmup
                    # replays these texts through an Executor.
                    okey = (idx.name, f"Count({c})", len(shards))
                    self._observed[okey] = self._observed.get(okey, 0) + 1
                    self._observed.move_to_end(okey)
                    while len(self._observed) > self.OBSERVED_SIZE:
                        self._observed.popitem(last=False)
        self._prefetch_leaves(idx, leaves, tuple(shards))
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards), const_rows)
                  for leaf in leaves]
        return fn, arrays

    def _revalidate_plan(self, idx: Index, plan_key: tuple, hit: tuple,
                         shards: tuple):
        """The staleness hook of a prepared plan (reference
        planner.py:294-317), run only when the index epoch moved since the
        plan's stamp. A leaf's representation class is baked into the
        program (a ``pleaf`` runs packed kernels), so a plan whose packed
        leaf's row has outgrown the packed class is dropped, and the
        caller plans again; otherwise it is re-stamped and stands (a dense
        plan is always right)."""
        leaves, fn, seen_epoch = hit
        epoch = idx.epoch.value
        if seen_epoch == epoch:
            return hit
        for leaf in leaves:
            if leaf[0] != "prow":
                continue
            _, field_name, view, row_id = leaf
            if self._leaf_class(idx, field_name, view, row_id,
                                shards) != _residency.PACKED:
                with self._cache_lock:
                    self._plan_cache.pop(plan_key, None)
                return None
        hit = (leaves, fn, epoch)
        with self._cache_lock:
            if plan_key in self._plan_cache:
                self._plan_cache[plan_key] = hit
        return hit

    def _tree_stack(self, idx: Index, c: Call, shards: list[int],
                    const_rows: list | None = None) -> torch.Tensor:
        """Evaluate a bitmap tree to its stacked [S_pad, W] device tensor."""
        leaves: list[tuple] = []
        sig = self._signature(idx, c, leaves, tuple(shards))
        self._prefetch_leaves(idx, leaves, tuple(shards))
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards), const_rows)
                  for leaf in leaves]
        out = self._compiled(("row",) + sig, sig, None)(*arrays)
        self._record_dispatch(1)
        _fuse.add_fused_steps(_fuse.call_steps(c))
        return out

    def execute_bitmap(self, idx: Index, c: Call, shards: list[int],
                       const_rows: list | None = None) -> Row:
        """Evaluate the tree to a Row whose segments are device slices of
        the stacked result (no host sync)."""
        if not shards:
            return Row()
        out = self._tree_stack(idx, c, shards, const_rows)  # [S_pad, W]
        return Row({shard: out[i] for i, shard in enumerate(shards)})

    def observed_traffic(self) -> list[dict]:
        """The query shapes this planner prepared, oldest first: what
        ServerNode persists to warmup.json so the next boot's warmup
        replays them."""
        with self._cache_lock:
            return [{"index": i, "query": q, "shards": n, "count": k}
                    for (i, q, n), k in self._observed.items()]

    def drop_index(self, index_name: str) -> None:
        """Evict one index's stacks and plans; programs are structural and
        stay (this lets warmup drop its scratch index)."""
        with self._cache_lock:
            for key in [k for k in self._stack_cache if k[0] == index_name]:
                self._uncount(key, self._stack_cache.pop(key)[2])
            for cache in (self._plan_cache, self._filter_host_cache):
                for key in [k for k in cache if k[0] == index_name]:
                    del cache[key]

    # ------------------------------------------------------------------
    # BSI aggregates: Sum/Min/Max over every shard at once, one program
    # each through the coalescer, the host fold on the batcher's thread
    # (reference dispatch_sum / dispatch_min_max, planner.py:553-645)
    # ------------------------------------------------------------------

    def _prepare_agg(self, idx: Index, c: Call, shards: list[int], kind: str,
                     is_min: bool):
        """(program, leaf inputs, depth) of a Sum (``kind="sum"``) or
        Min/Max (``"minmax"``): leaf 0 is the field's ``bsi`` leaf, the
        rest the filter tree's. Plans cache like Count's, keyed by kind
        and call text (reference _prepare_agg, planner.py:470)."""
        field_name, _ = c.string_arg("field")
        depth = idx.field(field_name).bsi_group.bit_depth
        plan_key = (idx.name, idx.instance_id, idx.schema_epoch.value,
                    f"{kind}{int(is_min)}:{c}", tuple(shards))
        with self._cache_lock:
            hit = self._plan_cache.get(plan_key)
            if hit is not None:
                self._plan_cache.move_to_end(plan_key)
        if hit is not None:
            hit = self._revalidate_plan(idx, plan_key, hit, tuple(shards))
        if hit is not None:
            leaves, fn = hit[0], hit[1]
        else:
            leaves = [("bsi", field_name, depth)]
            filt_sig = (self._signature(idx, c.children[0], leaves, tuple(shards))
                        if c.children else None)
            fn = self._compiled_agg((kind, is_min, depth, filt_sig), kind, depth,
                                    filt_sig, is_min)
            if not _time_bound(leaves):
                with self._cache_lock:
                    self._plan_cache[plan_key] = (leaves, fn, idx.epoch.value)
                    while len(self._plan_cache) > self.PLAN_CACHE_SIZE:
                        self._plan_cache.popitem(last=False)
        self._prefetch_leaves(idx, leaves, tuple(shards))
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards)) for leaf in leaves]
        return fn, arrays, depth

    def _compiled_agg(self, full_sig: tuple, kind: str, depth: int, filt_sig,
                      is_min: bool) -> Callable:
        """The aggregate program: leaf inputs -> ONE int32 tensor holding
        every output the host fold reads, so one copy brings it back. Sum:
        ``[count per shard, pos[depth, S], neg[depth, S]]``; Min/Max:
        ``[consider count, alt count, a (lo, hi, count), b (lo, hi,
        count)]``, each per shard."""
        fn = self._fn_cache.get(full_sig)
        if fn is not None:
            return fn

        def fn(*args):
            exists, sign, cube = args[0]
            if filt_sig is not None:
                tape = _Tape()
                filt = tape.plane(_lower(filt_sig, args, tape))
            else:
                filt = torch.full_like(exists, -1)
            if kind == "sum":
                cnt, pos, neg = bsi_ops.sum_counts(exists, sign, cube, filt, depth)
                return torch.cat([cnt, pos.reshape(-1), neg.reshape(-1)])
            cons_cnt, alt_cnt, a, b = _agg_min_max(exists, sign, cube, filt, depth,
                                                   is_min)
            return torch.stack([cons_cnt, alt_cnt, *a, *b])

        self._fn_cache[full_sig] = fn
        self._fn_keys[id(fn)] = full_sig
        return fn

    def execute_sum(self, idx: Index, c: Call, shards: list[int]) -> tuple[int, int]:
        """Global (sum of base-relative values, count); the executor adds
        the BSI base (reference fragment.sum :1111 under executeSum
        :406)."""
        return self.dispatch_sum(idx, c, shards, waited=True).result()

    def dispatch_sum(self, idx: Index, c: Call, shards: list[int],
                     waited: bool = False) -> Future:
        """Async Sum: launch the program (or join a wave) and return a
        Future[(total, count)]; the fold runs where the copy lands."""
        if not shards:
            fut: Future = Future()
            fut.set_result((0, 0))
            return fut
        fn, arrays, depth = self._prepare_agg(idx, c, shards, "sum", False)
        _fuse.add_fused_steps(_fuse.call_steps(c))

        def fold(host):
            host = np.asarray(host).astype(np.int64)  # widen before any sum
            s_pad = len(host) // (2 * depth + 1)
            count = int(host[:s_pad].sum())
            p = host[s_pad:s_pad * (depth + 1)].reshape(depth, s_pad).sum(axis=-1)
            n = host[s_pad * (depth + 1):].reshape(depth, s_pad).sum(axis=-1)
            total = sum((1 << i) * (int(p[i]) - int(n[i])) for i in range(depth))
            return total, count

        return self.coalescer.dispatch(fn, arrays, fold, waited)

    def execute_min_max(self, idx: Index, c: Call, shards: list[int],
                        is_min: bool) -> tuple[int, int]:
        """Global (value, count) before the base: every shard's extremum
        from one stacked descent, host-folded with the reference's
        smaller/larger rule."""
        return self.dispatch_min_max(idx, c, shards, is_min, waited=True).result()

    def dispatch_min_max(self, idx: Index, c: Call, shards: list[int],
                         is_min: bool, waited: bool = False) -> Future:
        """Async Min/Max: Future[(value, count)] before the base."""
        if not shards:
            fut: Future = Future()
            fut.set_result((0, 0))
            return fut
        n_shards = len(shards)
        fn, arrays, _ = self._prepare_agg(idx, c, shards, "minmax", is_min)
        _fuse.add_fused_steps(_fuse.call_steps(c))

        def fold(host):
            return _fold_min_max(host[0], host[1], tuple(host[2:5]),
                                 tuple(host[5:8]), n_shards, is_min)

        return self.coalescer.dispatch(fn, arrays, fold, waited)

    # ------------------------------------------------------------------
    # approximate analytics (pilosa_tpu_torch.sketch): Count(Distinct) as
    # one program -- the filter tree's plane, the hll_expand masked
    # register gather, the hll_reduce register max -- and SimilarTopN as
    # one similar_count pass over the field's row cube (reference
    # planner.py:646-818). The estimate (harmonic mean in float64) and
    # the final ranking run in the host fold; no row set leaves the
    # device.
    # ------------------------------------------------------------------

    #: refuse to build a SimilarTopN row cube past this device footprint --
    #: the executor falls back to the per-shard host oracle instead.
    SIM_CUBE_MAX_BYTES = 1 << 30

    def supports_distinct(self, idx: Index, c: Call) -> bool:
        """True for Distinct calls whose (optional) filter child is a
        plannable bitmap tree over an existing BSI field."""
        if c.name != "Distinct" or len(c.children) > 1:
            return False
        if c.children and not self.supports(c.children[0]):
            return False
        field_name, ok = c.string_arg("field")
        if not ok:
            return False
        f = idx.field(field_name)
        return f is not None and f.bsi_group is not None

    def execute_distinct_registers(self, idx: Index, c: Call, shards: list[int],
                                   p: int) -> np.ndarray:
        """Merged uint8[2^p] HLL registers of the filtered column set across
        ``shards``: one program through the coalescer."""
        return self.dispatch_distinct(idx, c, shards, p).result()

    def dispatch_distinct(self, idx: Index, c: Call, shards: list[int], p: int) -> Future:
        """Async register fold: Future[uint8[2^p]]. Plans like the fused
        aggregates (shared plan cache, structural program cache); the
        unfiltered form reduces the cached [S_pad, 2^p] register stack, the
        filtered form expands the packed plane under the filter tree's
        plane and reduces that."""
        if not shards:
            fut: Future = Future()
            fut.set_result(np.zeros(1 << p, dtype=np.uint8))
            return fut
        fn, arrays = self._prepare_distinct(idx, c, shards, p)
        _fuse.add_fused_steps(_fuse.call_steps(c))
        return self.coalescer.dispatch(fn, arrays,
                                       lambda host: np.asarray(host, dtype=np.uint8))

    def _prepare_distinct(self, idx: Index, c: Call, shards: list[int], p: int):
        field_name, _ = c.string_arg("field")
        depth = idx.field(field_name).bsi_group.bit_depth
        plan_key = (idx.name, idx.instance_id, idx.schema_epoch.value,
                    f"distinct{p}:{c}", tuple(shards))
        with self._cache_lock:
            hit = self._plan_cache.get(plan_key)
            if hit is not None:
                self._plan_cache.move_to_end(plan_key)
        if hit is not None:
            hit = self._revalidate_plan(idx, plan_key, hit, tuple(shards))
        if hit is not None:
            leaves, fn = hit[0], hit[1]
        else:
            if c.children:
                leaves = [("hll", field_name, depth, p)]
                filt_sig = self._signature(idx, c.children[0], leaves, tuple(shards))
            else:
                leaves = [("hllreg", field_name, depth, p)]
                filt_sig = None
            fn = self._compiled_distinct(("distinct", p, depth, filt_sig), p, filt_sig)
            if not _time_bound(leaves):
                with self._cache_lock:
                    self._plan_cache[plan_key] = (leaves, fn, idx.epoch.value)
                    while len(self._plan_cache) > self.PLAN_CACHE_SIZE:
                        self._plan_cache.popitem(last=False)
        self._prefetch_leaves(idx, leaves, tuple(shards))
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards)) for leaf in leaves]
        return fn, arrays

    def _compiled_distinct(self, full_sig: tuple, p: int, filt_sig) -> Callable:
        """The distinct program: leaf inputs -> the merged [2^p] uint8
        registers. Unfiltered: ONE hll_reduce of the register stack.
        Filtered: the filter tree's plane (the leaf stack itself for a
        single Row, else one tree_count), ONE hll_expand, ONE hll_reduce."""
        fn = self._fn_cache.get(full_sig)
        if fn is not None:
            return fn

        def fn(*args):
            if filt_sig is None:
                return kernels.hll_reduce(args[0])
            tape = _Tape()
            filt = tape.plane(_lower(filt_sig, args, tape))
            return kernels.hll_reduce(kernels.hll_expand(args[0], filt, p))

        self._fn_cache[full_sig] = fn
        self._fn_keys[id(fn)] = full_sig
        return fn

    def supports_similar(self, idx: Index, field_name: str,
                         filter_call: Call | None) -> bool:
        if filter_call is not None and not self.supports(filter_call):
            return False
        return idx.field(field_name) is not None

    def execute_similar(self, idx: Index, field_name: str, filter_call: Call,
                        row_ids: list[int], shards: list[int]):
        """One-launch row-vs-all similarity: (ids, overlap, selfcnt,
        filtcnt, order) with int64 host widening, or None when the candidate
        cube would pass the device gate (the executor's host oracle takes
        over). The filter tree evaluates in the same program, so a warm
        query costs the filter's launch (none for a single dense Row) and
        ONE similar_count.

        No prepared-plan cache: a cached entry would pin a row-id universe
        that any Set() can grow; the structural program cache still
        dedupes programs by (padded R, filter shape)."""
        if not shards or not row_ids:
            return None
        s_pad = self._pad(len(shards))
        r = len(row_ids)
        r_pad = max(8, 1 << (r - 1).bit_length())
        if r_pad * s_pad * WORDS_PER_SHARD * 4 > self.SIM_CUBE_MAX_BYTES:
            return None
        ids = tuple(int(x) for x in row_ids)
        leaves: list[tuple] = [("simtopn", field_name, ids, r_pad)]
        filt_sig = self._signature(idx, filter_call, leaves, tuple(shards))
        fn = self._compiled_similar(("simtopn", r_pad, filt_sig), filt_sig)
        self._prefetch_leaves(idx, leaves, tuple(shards))
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards)) for leaf in leaves]
        _fuse.add_fused_steps(_fuse.call_steps(filter_call) + 1)
        ids_arr = np.asarray(ids, dtype=np.uint64)

        def fold(host):
            host = np.asarray(host).astype(np.int64)  # widen before any sum
            order, inter, selfc = host[:r_pad], host[r_pad:2 * r_pad], host[2 * r_pad:3 * r_pad]
            return ids_arr, inter[:r], selfc[:r], int(host[3 * r_pad]), order[:r]

        return self.coalescer.dispatch(fn, arrays, fold).result()

    def _compiled_similar(self, full_sig: tuple, filt_sig) -> Callable:
        """The SimilarTopN program: leaf inputs -> ONE int32 tensor
        ``[order, inter, selfc, filtc]`` (R_pad, R_pad, R_pad, 1), so one
        copy brings it back."""
        fn = self._fn_cache.get(full_sig)
        if fn is not None:
            return fn
        from pilosa_tpu_torch.sketch import kernels as sketch_kernels

        def fn(*args):
            tape = _Tape()
            filt = tape.plane(_lower(filt_sig, args, tape))
            order, inter, selfc, filtc = sketch_kernels.similar_totals(args[0], filt)
            return torch.cat([order.to(torch.int32), inter, selfc, filtc.reshape(1)])

        self._fn_cache[full_sig] = fn
        self._fn_keys[id(fn)] = full_sig
        return fn

    def execute_topn_counts(self, idx: Index, field_name: str, view: str,
                            shards: list[int], filter_call: Call | None,
                            row_ids=None) -> dict[int, tuple]:
        """shard -> (ids, counts) arrays SORTED by count desc / id asc,
        preserving per-fragment semantics (threshold filtering stays per
        shard in the executor, executor.go:902). With a filter, the dense
        tiers of all shards count against their slices of the filter stack
        in one ``pair_count_batched`` launch per tile shape, and all
        shards' device counts come back in one transfer."""
        allowed = (np.asarray(sorted(set(int(r) for r in row_ids)),
                              dtype=np.uint64)
                   if row_ids is not None else None)
        out: dict[int, tuple] = {}
        filt = filt_host = None
        if filter_call is not None:
            filt = self._tree_stack(idx, filter_call, shards)  # [S_pad, W]
            # ONE pull of the filter for every shard's sparse host tier,
            # through the batcher, kept for TopN's second pass (reference
            # planner.py:846-862).
            fkey = (idx.name, idx.instance_id, str(filter_call), tuple(shards),
                    idx.epoch.value)
            with self._cache_lock:
                filt_host = self._filter_host_cache.get(fkey)
            if filt_host is None:
                filt_host = self.batcher.submit(
                    filt, lambda h: h.view(np.uint32), waited=True).result()
                with self._cache_lock:
                    self._filter_host_cache[fkey] = filt_host
                    while len(self._filter_host_cache) > 4:
                        self._filter_host_cache.pop(next(iter(self._filter_host_cache)))
        pending: list[tuple[int, np.ndarray, np.ndarray, list]] = []
        for si, shard in enumerate(shards):
            frag = self.holder.fragment(idx.name, field_name, view, shard)
            if frag is None:
                continue
            if filt is None:
                ids, counts = frag.top_counts()  # cached sorted order
                if allowed is not None and len(ids):
                    keep = np.isin(ids, allowed)
                    ids, counts = ids[keep], counts[keep]
                if len(ids):
                    out[shard] = (ids, counts)
                continue
            ids, _ = frag.row_counts()
            if allowed is not None and len(ids):
                ids = ids[np.isin(ids, allowed, assume_unique=True)]
            if not len(ids):
                continue
            counts, tiles = frag.intersection_counts_async(
                ids, filt[si], reuse=True, seg_host=filt_host[si], defer=True)
            pending.append((shard, ids, counts, tiles))
        # Every shard's dense tiles of one shape are counted in ONE
        # pair_count_batched launch, and all the counts come back in one
        # batcher transfer (reference planner.py:878-892 launches and
        # submits each tile).
        groups: dict[tuple, list] = {}
        for _, _, counts, tiles in pending:
            for slots, arr, seg in tiles:
                groups.setdefault((tuple(arr.shape), tuple(seg.shape)), []).append(
                    (counts, slots, arr, seg))
        parts, outs = [], []
        for members in groups.values():
            dev = kernels.pair_count_batched([m[2] for m in members],
                                             [m[3] for m in members], "and")
            outs.append(dev.reshape(-1))
            parts += [(m[0], m[1], dev[z]) for z, m in enumerate(members)]
        if parts:
            host = self.batcher.submit(
                torch.cat(outs) if len(outs) > 1 else outs[0],
                lambda h: h, waited=True).result()
            resolve_counts(parts, host)
        for shard, ids, counts, _ in pending:
            order = np.lexsort((ids, -counts))
            out[shard] = (ids[order], counts[order])
        return out

    # ------------------------------------------------------------------
    # GroupBy: the whole lattice of the shard batch in one group_count
    # launch over the levels' cached [S_pad, W] stacks (reference
    # planner.py:903-978, one XLA-fused AND and count per group there;
    # executor.go:3058-3231 walks per-shard row iterators)
    # ------------------------------------------------------------------

    #: the most groups one lattice launch counts; past it, or past the
    #: stacks' memory cap, the executor's per-shard walk takes over.
    GROUP_BY_MAX_PAIRS = 8192

    def group_by_candidates(self, idx: Index, field_name: str,
                            shards: list[int]) -> list[int]:
        """The ids of the rows present in the field's standard view over
        the shard batch, ascending (host metadata, no device work)."""
        out: set[int] = set()
        for shard in shards:
            frag = self.holder.fragment(idx.name, field_name, VIEW_STANDARD,
                                        shard)
            if frag is not None:
                out.update(frag.row_ids())
        return sorted(out)

    def execute_group_by(self, idx: Index, fields: list[str],
                         cands: list[list[int]], shards: list[int],
                         filter_call: Call | None):
        """[(group row ids, count), ...] in lexicographic group order, zero
        counts dropped, or None when the lattice exceeds
        GROUP_BY_MAX_PAIRS groups, ``kernels.GROUP_MAX_LEVELS`` levels, or
        its stacks exceed min(max_cache_bytes, 2 GiB) (every candidate row
        is a stack held for the whole query). The filter tree is evaluated
        to a plane first; then ONE ``group_count`` launch counts every
        group, each shard's int32 count widened before the sum."""
        total = 1
        for rows in cands:
            total *= max(1, len(rows))
        if (total > self.GROUP_BY_MAX_PAIRS or not shards
                or len(cands) > kernels.GROUP_MAX_LEVELS):
            return None
        n_stacks = sum(len(rows) for rows in cands)
        stack_bytes = n_stacks * _residency.dense_nbytes(self._pad(len(shards)))
        if stack_bytes > min(self.max_cache_bytes, 2 << 30):
            return None
        shards_t = tuple(shards)
        filt = (self._tree_stack(idx, filter_call, shards)
                if filter_call is not None else None)
        leaves = [("row", fields[i], VIEW_STANDARD, r)
                  for i, rows in enumerate(cands) for r in rows]
        self._prefetch_leaves(idx, leaves, shards_t)
        # The kernel walks the real shard rows only: the pad rows are zero
        # and would count 0.
        n = len(shards)
        planes = [self._stack_rows(idx, f, view, r, shards_t)[:n]
                  for _, f, view, r in leaves]
        counts = kernels.group_count(planes, [len(rows) for rows in cands],
                                     None if filt is None else filt[:n])
        self._record_dispatch(1)
        host = self.batcher.submit(counts, lambda h: h, waited=True).result()
        out = []
        for group, cnt in zip(itertools.product(*cands), np.asarray(host).tolist()):
            if cnt > 0:
                out.append((group, int(cnt)))
        return out

    # ------------------------------------------------------------------
    # signatures
    # ------------------------------------------------------------------

    def _leaf_class(self, idx: Index, field_name: str, view: str, row_id: int,
                    shards: tuple) -> str:
        """Representation class of one row's stack: the residency policy
        (``exec/residency.choose_class``) on the row's largest per-shard
        cardinality, O(1) a fragment; dense when the mode is off
        (reference planner.py:1055-1072, less its mesh switch: the port has
        no mesh)."""
        if not shards or _residency.mode() == "off":
            return _residency.DENSE
        max_bits = 0
        for shard in shards:
            frag = self.holder.fragment(idx.name, field_name, view, shard)
            if frag is not None:
                max_bits = max(max_bits, frag.row_cardinality(row_id))
        return _residency.choose_class(max_bits)

    def _signature(self, idx: Index, c: Call, leaves: list[tuple],
                   shards: tuple = ()) -> tuple:
        """DFS the call tree, appending leaf specs and returning a
        hashable structure key. Leaf position in ``leaves`` is its input
        slot in the count program. A BSI condition appends its ``bsi``
        leaf and ``pred`` leaves (reference planner.py:1074-1207). With
        ``shards``, a standard-view Row with no time bounds chooses its
        representation class: a packed one appends a ``prow`` leaf and
        signs as ``pleaf``, so the class is part of the signature
        (reference :1100-1104)."""
        name = c.name
        if name in ("Row", "Range"):
            if c.has_condition_arg():
                return self._bsi_signature(idx, c, leaves)
            field_name = c.field_arg()
            f = idx.field(field_name)
            if f is None:
                raise FieldNotFoundError(f"field not found: {field_name!r}")
            row_id = row_id_arg(c, field_name)
            from_time = tq.parse_time(c.args["from"]) if "from" in c.args else None
            to_time = tq.parse_time(c.args["to"]) if "to" in c.args else None
            if name == "Row" and from_time is None and to_time is None:
                if self._leaf_class(idx, field_name, VIEW_STANDARD, row_id,
                                    shards) == _residency.PACKED:
                    leaves.append(("prow", field_name, VIEW_STANDARD, row_id))
                    return ("pleaf", len(leaves) - 1)
                leaves.append(("row", field_name, VIEW_STANDARD, row_id))
                return ("leaf", len(leaves) - 1)
            return self._time_signature(f, row_id, from_time, to_time, leaves)
        kind = name.lower()
        if kind in _PAIR_OPS:
            if not c.children:
                raise QueryError(f"empty {name} query is currently not supported")
            kids = tuple(self._signature(idx, ch, leaves, shards) for ch in c.children)
            return (kind, kids)
        if name == "Not":
            if len(c.children) != 1:
                raise QueryError("Not() requires a single row input")
            ef = idx.existence_field()
            if ef is None:
                raise QueryError(
                    f"index does not support existence tracking: {idx.name}")
            leaves.append(("row", ef.name, VIEW_STANDARD, 0))
            slot = len(leaves) - 1
            return ("not", slot, self._signature(idx, c.children[0], leaves, shards))
        if name == "Shift":
            # The JAX planner reads the first child and ignores any more
            # (its per-shard path refuses them): kept as it is (ROADMAP.md
            # Queue 3).
            n = c.args.get("n", 0)  # IntArg default, executor.go:1770
            return ("shift", n, self._signature(idx, c.children[0], leaves, shards))
        if name == "__const__":
            # Partial-fusion leaf: a Row computed on the host, uploaded as
            # a stack (Executor._fuse_partial).
            leaves.append(("const", c.args["slot"]))
            return ("leaf", len(leaves) - 1)
        raise QueryError(f"unsupported planner call: {name}")

    @staticmethod
    def _time_signature(f, row_id: int, from_time, to_time,
                        leaves: list[tuple]) -> tuple:
        """A time Row: the ``or`` of the row in each existing time view
        covering [from, to), a leaf each; the zero leaf when the field has
        no quantum or no view covers the window. An open ``to`` is now plus
        a day, an open ``from`` the first time view (reference
        planner.py:1098-1113, :1580-1600)."""
        views = []
        q = f.time_quantum()
        if to_time is None:
            to_time = dt.datetime.now() + dt.timedelta(days=1)
        if q and from_time is None:
            from_time, _ = f._time_view_bounds()
        if q and from_time is not None:
            views = [v for v in tq.views_by_time_range(VIEW_STANDARD, from_time,
                                                       to_time, q)
                     if f.view(v) is not None]
        if not views:
            leaves.append(("zero",))
            return ("leaf", len(leaves) - 1)
        kids = []
        for v in views:
            leaves.append(("row", f.name, v, row_id))
            kids.append(("leaf", len(leaves) - 1))
        return kids[0] if len(kids) == 1 else ("union", tuple(kids))

    def _bsi_signature(self, idx: Index, c: Call, leaves: list[tuple]) -> tuple:
        """BSI condition -> a node with the branch structure (operator,
        sign class, depth) in the signature and the predicate magnitudes in
        ``pred`` leaves (reference planner.py:1145-1207)."""
        if len(c.args) > 1:
            raise QueryError("Row(): too many arguments")
        (field_name, cond), = c.args.items()
        if not isinstance(cond, Condition):
            raise QueryError("Row(): expected condition argument")
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(f"field not found: {field_name!r}")
        bsig = f.bsi_group
        if bsig is None:
            raise BSIGroupNotFoundError()
        depth = bsig.bit_depth
        leaves.append(("bsi", field_name, depth))
        slot = len(leaves) - 1

        def pred(v: int) -> int:
            leaves.append(("pred", abs(v)))
            return len(leaves) - 1

        # Base and range handling, as executor._row_bsi_shard (reference
        # executor.go:1536-1663).
        if cond.op == NEQ and cond.value is None:
            return ("bsi_notnull", slot)
        if cond.op == BETWEEN:
            lo_hi = cond.int_slice_value()
            if len(lo_hi) != 2:
                raise QueryError("Row(): BETWEEN condition requires exactly "
                                 "two integer values")
            lo, hi, oor = bsig.base_value_between(*lo_hi)
            if oor:
                return ("bsi_zero", slot)
            if lo_hi[0] <= bsig.min and lo_hi[1] >= bsig.max:
                return ("bsi_notnull", slot)
            # Sign-class split of rangeBetween (fragment.go:1457).
            case = "pos" if lo >= 0 else "neg" if hi < 0 else "cross"
            return ("bsi_between", slot, depth, case, pred(lo), pred(hi))
        value = cond.value
        if not isinstance(value, int) or isinstance(value, bool):
            raise QueryError("Row(): conditions only support integer values")
        base_value, oor = bsig.base_value(cond.op, value)
        if oor and cond.op != NEQ:
            return ("bsi_zero", slot)
        if ((cond.op == LT and value > bsig.max)
                or (cond.op == LTE and value >= bsig.max)
                or (cond.op == GT and value < bsig.min)
                or (cond.op == GTE and value <= bsig.min)
                or oor):
            return ("bsi_notnull", slot)
        if cond.op in (EQ, NEQ):
            kind = "bsi_eq" if cond.op == EQ else "bsi_neq"
            return (kind, slot, depth, base_value < 0, pred(base_value))
        allow_eq = cond.op in (LTE, GTE)
        kind = "bsi_lt" if cond.op in (LT, LTE) else "bsi_gt"
        return (kind, slot, depth, allow_eq,
                bsi_ops._positive_branch(base_value, allow_eq), pred(base_value))

    def _compiled(self, full_sig: tuple, sig: tuple,
                  reduce: str | None) -> Callable:
        """The program for a signature: its [S_pad, W] leaf inputs ->
        int32 [S_pad] per-shard counts (``reduce="per_shard"``, a
        ``_CountProgram``, registered as a coalescer key) or the [S_pad, W]
        result plane (``None``). The tree is lowered to one op tape over
        leaf planes at each call (BSI compare and shift outputs join as
        planes): a bare leaf counts with row_counts, a 2-leaf op with
        pair_count, anything else with one tree_count launch."""
        fn = self._fn_cache.get(full_sig)
        if fn is not None:
            return fn
        if reduce == "per_shard":
            fn = _CountProgram(sig)
            self._fn_keys[id(fn)] = full_sig
        else:
            def fn(*args):
                tape = _Tape()
                return tape.plane(_lower(sig, args, tape))
        self._fn_cache[full_sig] = fn
        return fn

    # ------------------------------------------------------------------
    # leaf fetch: host rows -> [S_pad, W] device stacks
    # ------------------------------------------------------------------

    def _pad(self, s: int) -> int:
        """Stack height for ``s`` shards: under the default "pow2" bucket
        policy the next power of two, so the space of distinct [S_pad, W]
        shapes stays O(log S); ``s`` itself under "none". Padding rows are
        zero blocks — bit-identical results, because every consumer either
        sums popcounts (zero rows count 0) or slices only the real shard
        slots (execute_bitmap, TopN)."""
        if self.bucket_policy == "pow2" and s > 0:
            return 1 << (s - 1).bit_length()
        return s

    def _gens(self, index_name: str, field_name: str, view: str,
              shards: tuple) -> tuple:
        """Each shard's (fragment identity, generation), -1 where there is
        no fragment: a recreated field's fragments restart at generation 0
        and must not match a stack built from the old ones."""
        out = []
        for shard in shards:
            frag = self.holder.fragment(index_name, field_name, view, shard)
            out.append(-1 if frag is None else (frag.instance_id, frag.generation))
        return tuple(out)

    def _fetch_leaf(self, idx: Index, leaf: tuple, shards: tuple,
                    const_rows: list | None = None):
        """A leaf's device input: a ``row`` leaf's [S_pad, W] stack, a
        ``prow`` leaf's packed [S_pad, K] index stack, a ``bsi`` leaf's
        (exists, sign, [depth, S_pad, W] cube), a ``pred`` leaf's (lo, hi)
        halves, a ``const`` leaf's host Row uploaded as a stack (not
        cached: its contents vary per query)."""
        kind = leaf[0]
        if kind == "const":
            row = const_rows[leaf[1]]
            out = torch.zeros((self._pad(len(shards)), WORDS_PER_SHARD),
                              dtype=torch.int32, device=self.device)
            for i, shard in enumerate(shards):
                seg = row.segments.get(shard)
                if isinstance(seg, torch.Tensor):
                    out[i].copy_(seg)
                elif seg is not None:
                    out[i].copy_(torch.from_numpy(
                        np.ascontiguousarray(seg, dtype=np.uint32).view(np.int32)))
            return out
        if kind == "row":
            _, field_name, view, row_id = leaf
            return self._stack_rows(idx, field_name, view, row_id, shards)
        if kind == "prow":
            _, field_name, view, row_id = leaf
            return self._stack_rows(idx, field_name, view, row_id, shards,
                                    _residency.PACKED)
        if kind == "zero":
            return torch.zeros((self._pad(len(shards)), WORDS_PER_SHARD),
                               dtype=torch.int32, device=self.device)
        if kind == "pred":
            return bsi_ops.split_u64(leaf[1])
        if kind == "bsi":
            _, field_name, depth = leaf
            view = view_bsi_name(field_name)
            return (self._stack_rows(idx, field_name, view, BSI_EXISTS_BIT, shards),
                    self._stack_rows(idx, field_name, view, BSI_SIGN_BIT, shards),
                    self._stack_planes(idx, field_name, depth, shards))
        if kind == "hll":
            # Filtered-distinct leaf: the packed [S_pad, C] bucket|rho<<18
            # column planes (sketch/store), cached like any stack.
            _, field_name, depth, p = leaf
            return self._stack_hll_planes(idx, field_name, depth, p, shards)
        if kind == "hllreg":
            # Unfiltered-distinct leaf: the [S_pad, 2^p] uint8 register
            # stack, 2^p bytes a shard resident instead of 4 MiB.
            _, field_name, depth, p = leaf
            return self._stack_hll_registers(idx, field_name, depth, p, shards)
        if kind == "simtopn":
            _, field_name, row_ids, r_pad = leaf
            return self._stack_row_cube(idx, field_name, row_ids, r_pad, shards)
        raise QueryError(f"unknown leaf kind {kind!r}")

    def _stack_rows(self, idx: Index, field_name: str, view: str, row_id: int,
                    shards: tuple, klass: str = _residency.DENSE) -> torch.Tensor:
        """Stack of one row across shards on the device, in representation
        class ``klass``: the dense [S_pad, W] planes or the packed
        [S_pad, K] index stack, each class its own cache entry."""
        build = (self._build_stack_packed if klass == _residency.PACKED
                 else self._build_stack)
        return self._cached(idx, field_name, view, row_id, shards, lambda: (
            build(idx, field_name, view, row_id, shards)), klass)

    def _stack_planes(self, idx: Index, field_name: str, depth: int,
                      shards: tuple) -> torch.Tensor:
        """[depth, S_pad, W] cube of a BSI field's magnitude planes, uploaded
        plane by plane into one device tensor and cached like a row stack.
        The key carries the depth, so a field whose bit depth grew reads a
        new cube. Depth 0 gives an empty cube."""
        view = view_bsi_name(field_name)
        s_pad = self._pad(len(shards))

        def build():
            cube = self._alloc((depth, s_pad, WORDS_PER_SHARD))
            for i in range(depth):
                self._upload_into(cube[i], functools.partial(
                    self._fill_plane, idx, field_name, view, BSI_OFFSET_BIT + i,
                    shards))
            return cube, self._upload_done()

        return self._cached(idx, field_name, view, ("planes", depth), shards,
                            build)

    #: shards of the hll plane stack uploaded at a time: 32 x 4 MiB of
    #: pinned host buffer instead of the whole [S_pad, C] stack.
    HLL_UPLOAD_ROWS = 32

    def _stack_hll_planes(self, idx: Index, field_name: str, depth: int, p: int,
                          shards: tuple) -> torch.Tensor:
        """[S_pad, SHARD_WIDTH] int32 packed bucket|rho column planes, in
        the ``hll`` class, cached with the two-tier validation of every
        stack (reference _stack_hll_planes, planner.py:1710)."""
        from pilosa_tpu_torch.sketch import store as sketch_store
        view = view_bsi_name(field_name)
        s_pad = self._pad(len(shards))

        def fill(lo: int, mat: np.ndarray) -> None:
            for i in range(len(mat)):
                frag = (self.holder.fragment(idx.name, field_name, view, shards[lo + i])
                        if lo + i < len(shards) else None)
                if frag is None:
                    mat[i] = 0
                else:
                    mat[i] = sketch_store.plane(frag, depth, p).view(np.uint32)

        def build():
            out = self._alloc((s_pad, SHARD_WIDTH))
            for lo in range(0, s_pad, self.HLL_UPLOAD_ROWS):
                hi = min(s_pad, lo + self.HLL_UPLOAD_ROWS)
                self._upload_into(out[lo:hi], functools.partial(fill, lo))
            return out, self._upload_done()

        return self._cached(idx, field_name, view, ("hll", depth, p), shards, build,
                            _residency.HLL)

    def _stack_hll_registers(self, idx: Index, field_name: str, depth: int, p: int,
                             shards: tuple) -> torch.Tensor:
        """[S_pad, 2^p] uint8 per-shard register files (zero padding rows
        are the register-max identity), in the ``hll`` class."""
        from pilosa_tpu_torch.sketch import store as sketch_store
        view = view_bsi_name(field_name)

        def build():
            mat = np.zeros((self._pad(len(shards)), 1 << p), dtype=np.uint8)
            for i, shard in enumerate(shards):
                frag = self.holder.fragment(idx.name, field_name, view, shard)
                if frag is not None:
                    mat[i] = sketch_store.registers(frag, depth, p)
            with self._cache_lock:
                self.h2d_bytes += mat.nbytes
            return torch.from_numpy(mat).to(self.device)

        return self._cached(idx, field_name, view, ("hllreg", depth, p), shards, build,
                            _residency.HLL)

    def _stack_row_cube(self, idx: Index, field_name: str, row_ids: tuple, r_pad: int,
                        shards: tuple) -> torch.Tensor:
        """[r_pad, S_pad, W] cube of every candidate row's dense stack
        (SimilarTopN), stacked on the device from the per-row cached stacks
        and cached itself; zero padding rows rank with overlap 0 and are
        sliced off in the host fold."""
        def build():
            rows = [self._stack_rows(idx, field_name, VIEW_STANDARD, rid, shards)
                    for rid in row_ids]
            cube = torch.zeros((r_pad, self._pad(len(shards)), WORDS_PER_SHARD),
                               dtype=torch.int32, device=self.device)
            for i, row in enumerate(rows):
                cube[i].copy_(row)
            return cube

        return self._cached(idx, field_name, VIEW_STANDARD, ("simcube", row_ids, r_pad),
                            shards, build)

    def _cached(self, idx: Index, field_name: str, view: str, tag, shards: tuple,
                build: Callable, klass: str = _residency.DENSE) -> torch.Tensor:
        """The device tensor ``build()`` makes from (field, view, shards),
        in representation class ``klass`` (the key's last element), cached
        until any involved fragment mutates. ``build`` returns the
        tensor, or (tensor, event) when its upload runs on the upload
        stream: every reader's stream then waits on the event before using
        it. Validation is two-tier: an O(1) index-epoch compare, then (only
        when the epoch moved) the per-fragment generation walk -- if that
        shows the fragments unchanged the entry is re-stamped instead of
        re-uploaded.

        A miss first meets the prefetcher: an upload of the key in flight
        is waited for (a prefetch hit) instead of repeated; only then does
        the query build it itself (a sync miss). One build per key at a
        time: a thread that misses while another builds the same key waits
        for it and looks again, so concurrent queries on a cold 2 GiB cube
        share one build and one upload."""
        key = (idx.name, idx.instance_id, field_name, view, tag, shards, klass)
        worker = self.prefetcher.is_worker()
        rendezvous = not worker
        while True:
            epoch = idx.epoch.value
            with self._cache_lock:
                hit = self._stack_cache.get(key)
                gens = None
                if hit is not None:
                    if hit[0] != epoch:
                        gens = self._gens(idx.name, field_name, view, shards)
                        if gens == hit[1]:
                            hit = self._stack_cache[key] = (epoch, gens, hit[2],
                                                            hit[3])
                    if hit[0] == epoch:
                        self._stack_cache.move_to_end(key)
                        self.stack_hits += 1
                        return self._ready(hit[2], hit[3])
                building = self._building.get(key)
                if building is None and not rendezvous:
                    building = self._building[key] = threading.Event()
                    break
            if rendezvous:
                rendezvous = False
                self.prefetcher.wait(key)  # returns at once with none in flight
                continue
            building.wait()
        if not worker:
            self.prefetcher.note_sync_miss()
        # Build outside the lock: row materialization and the upload can
        # be slow.
        try:
            if gens is None:
                gens = self._gens(idx.name, field_name, view, shards)
            out = build()
            arr, ev = out if isinstance(out, tuple) else (out, None)
            self._insert_stack(key, epoch, gens, arr, ev)
        finally:
            with self._cache_lock:
                del self._building[key]
            building.set()
        return self._ready(arr, ev)

    def _ready(self, arr: torch.Tensor, ev) -> torch.Tensor:
        """``arr``, with the calling thread's current stream made to wait
        for its upload first (a stack the upload stream wrote)."""
        if ev is not None:
            torch.cuda.current_stream(arr.device).wait_event(ev)
        return arr

    def _insert_stack(self, key: tuple, epoch: int, gens: tuple,
                      arr: torch.Tensor, ev=None) -> None:
        """Insert first, then evict LRU entries past the byte budget (the
        eviction is double-buffered, as in the JAX planner: a prefetched
        stack lands before its victim goes). The class is the key's last
        element; its bytes feed ``class_bytes``."""
        nbytes = _residency.stack_nbytes(arr)
        with self._cache_lock:
            self.uploads += 1
            self.upload_bytes += nbytes
            old = self._stack_cache.pop(key, None)
            if old is not None:
                self._uncount(key, old[2])
            self._stack_cache[key] = (epoch, gens, arr, ev)
            self._cache_bytes += nbytes
            self._class_bytes[key[-1]] += nbytes
            while (self._cache_bytes > self.max_cache_bytes
                   and len(self._stack_cache) > 1):
                k2, dropped = self._stack_cache.popitem(last=False)
                self._uncount(k2, dropped[2])
                self.evictions += 1
            class_bytes = dict(self._class_bytes)
        if self.stats is not None:
            for k, v in class_bytes.items():
                self.stats.gauge(f"planner.residentBytes.{k}", v)

    def _uncount(self, key: tuple, arr: torch.Tensor) -> None:
        """Take a stack that left the cache out of the byte totals (under
        _cache_lock)."""
        nbytes = _residency.stack_nbytes(arr)
        self._cache_bytes -= nbytes
        self._class_bytes[key[-1]] -= nbytes

    def cache_stats(self) -> dict:
        """Locked snapshot of the stack cache's device-memory occupancy and
        the launch counts, for /debug/heap, /debug/device and the runtime
        gauges: the JAX planner's keys, the resident bytes by class."""
        with self._cache_lock:
            out = {"bytes": self._cache_bytes,
                   "budget_bytes": self.max_cache_bytes,
                   "entries": len(self._stack_cache),
                   "evictions": self.evictions,
                   "uploads": self.uploads,
                   "upload_bytes": self.upload_bytes,
                   "bucket_policy": self.bucket_policy,
                   "class_bytes": dict(self._class_bytes),
                   "residency_mode": _residency.mode(),
                   "programs": len(self._fn_cache)}
        with self._dispatch_lock:
            out["dispatches"] = self.dispatches
            out["dispatches_coalesced"] = self.dispatches_coalesced
        return out

    def device_debug(self) -> dict:
        """The /debug/device payload's planner half (reference
        planner.py:1038): residency, churn, the prefetch pipeline, the
        program population and the lifetime batch-width histogram."""
        out = self.cache_stats()
        with self._dispatch_lock:
            out["batch_width_hist"] = self._width_hist.snapshot()
        out["queue_depth"] = self.coalescer.queue_depth()
        out["transfer"] = self.batcher.debug()
        out["prefetch"] = self.prefetcher.debug()
        return out

    def close(self) -> None:
        """Stop the prefetcher, coalescer and batcher threads (each drains
        what it holds first)."""
        self.prefetcher.close()
        self.coalescer.close()
        self.batcher.close()

    # ------------------------------------------------------------------
    # the async miss path (reference planner.py:1448-1525)
    # ------------------------------------------------------------------

    def _leaf_stacks(self, idx: Index, leaves: list, shards: tuple):
        """(cache key, build) of every stack the plan's leaves will fetch:
        a row leaf's dense stack, a prow leaf's packed one, a BSI leaf's
        exists and sign stacks and its magnitude cube; pred and const
        leaves upload nothing (reference planner.py:1460-1528)."""
        for leaf in leaves:
            kind = leaf[0]
            if kind in ("row", "prow"):
                _, field_name, view, row_id = leaf
                klass = _residency.PACKED if kind == "prow" else _residency.DENSE
                yield ((idx.name, idx.instance_id, field_name, view, row_id, shards,
                        klass),
                       functools.partial(self._stack_rows, idx, field_name, view,
                                         row_id, shards, klass))
            elif kind == "bsi":
                _, field_name, depth = leaf
                view = view_bsi_name(field_name)
                for bit in (BSI_EXISTS_BIT, BSI_SIGN_BIT):
                    yield ((idx.name, idx.instance_id, field_name, view, bit, shards,
                            _residency.DENSE),
                           functools.partial(self._stack_rows, idx, field_name,
                                             view, bit, shards))
                yield ((idx.name, idx.instance_id, field_name, view,
                        ("planes", depth), shards, _residency.DENSE),
                       functools.partial(self._stack_planes, idx, field_name,
                                         depth, shards))

    def _prefetch_leaves(self, idx: Index, leaves: list, shards: tuple) -> None:
        """Peek the plan's full leaf set before execution and schedule an
        upload of every stack that is not resident, so the query's fetches
        wait on uploads already in flight instead of starting their own.
        The prefetcher dedupes by key: a wave of one plan prefetches the
        union of its leaves, one upload each."""
        if not (shards and self.prefetcher.enabled()):
            return
        epoch = idx.epoch.value
        for key, build in self._leaf_stacks(idx, leaves, shards):
            with self._cache_lock:
                hit = self._stack_cache.get(key)
                if hit is not None and hit[0] == epoch:
                    continue  # resident and current
            self.prefetcher.schedule(key, build)

    # ------------------------------------------------------------------
    # uploads: pinned host buffers, copied on the upload stream
    # ------------------------------------------------------------------

    def _sparse_upload_enabled(self) -> bool:
        """COO uploads pay off where the host-to-device link is the
        expensive one: a CUDA device over PCIe (the JAX planner turns them
        on for its TPU link, planner.py:1340). On the CPU the 'upload' is a
        memcpy, and the dense path stays."""
        return self.device.type == "cuda"

    def _alloc(self, shape) -> torch.Tensor:
        """An uninitialised int32 device tensor on the calling thread's
        current stream, for an upload to fill."""
        return torch.empty(shape, dtype=torch.int32, device=self.device)

    def _stream(self):
        if self._upload_stream is None:
            with self._cache_lock:
                if self._upload_stream is None:
                    self._upload_stream = torch.cuda.Stream(device=self.device)
        return self._upload_stream

    def _upload_into(self, dst: torch.Tensor, fill: Callable) -> dict:
        """``fill(host)`` writes every word of a uint32 host array of
        ``dst``'s shape; the array then lands in ``dst``. On a CUDA device
        the array is pinned and the copy runs on the upload stream, after
        the work the caller's stream has queued (``dst`` may reuse memory
        that work freed); ``_upload_done`` gives the event that follows.
        Returns the phases: host ms of the buffer (``pin``) and the fill,
        and on a CUDA device the events around the copy (``h2d``)."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            host = np.empty(dst.shape, dtype=np.uint32)
            t1 = time.perf_counter()
            fill(host)
            t2 = time.perf_counter()
            dst.copy_(torch.from_numpy(host.view(np.int32)))
            copy = None
        else:
            host = torch.empty(dst.shape, dtype=torch.int32, pin_memory=True)
            t1 = time.perf_counter()
            fill(host.numpy().view(np.uint32))
            t2 = time.perf_counter()
            with torch.cuda.device(self.device):
                up = self._stream()
                up.wait_stream(torch.cuda.current_stream(self.device))
                copy = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                with torch.cuda.stream(up):
                    copy[0].record()
                    dst.copy_(host, non_blocking=True)
                    copy[1].record()
                # Freed early (an eviction), dst's memory must not go to a
                # new tensor while the copy still writes it.
                dst.record_stream(up)
        with self._cache_lock:
            self.h2d_bytes += dst.numel() * dst.element_size()
        return {"pin": (t1 - t0) * 1e3, "fill": (t2 - t1) * 1e3, "h2d": copy}

    def upload_split_ms(self) -> dict:
        """The newest row-stack build's time by phase, in ms: on the host
        ``gather`` (each shard's host form and the OR-reduce of its sparse
        words; on the dense path the fill reads the rows itself), ``pin``
        (the host buffer) and ``fill``; on a CUDA device ``h2d`` (the copy)
        and, for a sparse upload, ``assemble`` (from the copy's end to the
        ``assemble_stack`` kernel's), from events on the upload stream,
        waited for here, and ``assemble_host`` (the host's time in the
        ``assemble_stack`` call, which lies within ``assemble``)."""
        out = {}
        for name, value in self._last_upload.items():
            if isinstance(value, tuple):
                value[1].synchronize()
                value = value[0].elapsed_time(value[1])
            if value is not None:
                out[name] = value
        return out

    def _upload_done(self):
        """An event after everything queued on the upload stream so far
        (None off the card): what a reader of the upload waits on."""
        if self.device.type != "cuda":
            return None
        with torch.cuda.device(self.device):
            ev = torch.cuda.Event()
            ev.record(self._stream())
        return ev

    def _fill_plane(self, idx: Index, field_name: str, view: str, row_id: int,
                    shards: tuple, mat: np.ndarray) -> None:
        """One row across ``shards`` into the [S_pad, W] uint32 ``mat``; rows
        of absent fragments and past the last shard are zero."""
        for i, shard in enumerate(shards):
            frag = self.holder.fragment(idx.name, field_name, view, shard)
            if frag is not None:
                mat[i] = frag.row_words(row_id)
            else:
                mat[i] = 0
        mat[len(shards):] = 0

    def _build_stack(self, idx: Index, field_name: str, view: str, row_id: int,
                     shards: tuple):
        """One row across ``shards`` as a device [S_pad, W] stack, and the
        event its readers wait on. Where sparse uploads are on, shards whose
        row holds at most SPARSE_UPLOAD_MAX_BITS bits ship as COO words
        (one OR-reduced word per distinct word) beside the dense rows of
        the others, and the ``assemble_stack`` kernel builds the stack from
        both, each word written once (reference _build_stack,
        planner.py:1346-1426). The packing meets the kernel's contract: the
        COO words grouped by shard in shard order (``ci`` non-decreasing),
        distinct words within a shard, no shard both dense and COO, both
        lists padded to pow2 buckets aimed at row s_pad, one past the
        stack, which the kernel drops: the stack is allocated at
        [S_pad, W], with no trash row."""
        s_pad = self._pad(len(shards))
        shape = (s_pad, WORDS_PER_SHARD)
        if not self._sparse_upload_enabled():
            arr = self._alloc(shape)
            self._last_upload = self._upload_into(arr, functools.partial(
                self._fill_plane, idx, field_name, view, row_id, shards))
            return arr, self._upload_done()
        t0 = time.perf_counter()
        dense_idx: list[int] = []
        dense_rows: list[np.ndarray] = []
        coo_i: list[np.ndarray] = []
        coo_w: list[np.ndarray] = []
        coo_v: list[np.ndarray] = []
        for i, shard in enumerate(shards):
            frag = self.holder.fragment(idx.name, field_name, view, shard)
            if frag is None:
                continue
            kind, payload = frag.row_upload(row_id)
            if kind == "sparse" and len(payload) == 0:
                continue
            if kind == "sparse" and len(payload) <= self.SPARSE_UPLOAD_MAX_BITS:
                w = (payload >> np.uint64(5)).astype(np.int32)
                b = np.uint32(1) << (payload & np.uint64(31)).astype(np.uint32)
                # Positions are sorted, so equal words are adjacent: one
                # reduceat OR per distinct word.
                starts = np.flatnonzero(np.diff(w, prepend=np.int32(-1)) != 0)
                coo_i.append(np.full(len(starts), i, dtype=np.int32))
                coo_w.append(w[starts])
                coo_v.append(np.bitwise_or.reduceat(b, starts))
            else:
                dense_idx.append(i)
                dense_rows.append(payload if kind == "dense"
                                  else bitops.positions_to_words(payload))
        nnz = sum(len(x) for x in coo_i)
        gather = {"gather": (time.perf_counter() - t0) * 1e3}
        if nnz == 0:
            # No COO words: the plain dense upload moves the same bytes.
            rows = dict(zip(dense_idx, dense_rows))

            def fill(mat):
                mat[:] = 0
                for i, row in rows.items():
                    mat[i] = row

            arr = self._alloc(shape)
            self._last_upload = {**gather, **self._upload_into(arr, fill)}
            return arr, self._upload_done()

        def bucket(n: int) -> int:
            return 0 if n == 0 else max(8, 1 << (n - 1).bit_length())

        # One pinned buffer, one copy: the dense rows, then didx, ci, cw,
        # cv (every offset a multiple of 8 words).
        d_pad, n_pad = bucket(len(dense_idx)), bucket(nnz)
        body = d_pad * WORDS_PER_SHARD
        packed = self._alloc(body + d_pad + 3 * n_pad)

        def fill(buf):
            buf[:] = 0
            dmat = buf[:body].reshape(d_pad, WORDS_PER_SHARD)
            for k, row in enumerate(dense_rows):
                dmat[k] = row
            didx = buf[body:body + d_pad]
            didx[:] = s_pad
            didx[:len(dense_idx)] = dense_idx
            ci, cw, cv = (buf[body + d_pad + j * n_pad:body + d_pad + (j + 1) * n_pad]
                          for j in range(3))
            ci[:] = s_pad
            ci[:nnz] = np.concatenate(coo_i)
            cw[:nnz] = np.concatenate(coo_w)
            cv[:nnz] = np.concatenate(coo_v)

        phases = {**gather, **self._upload_into(packed, fill)}
        at = body + d_pad
        parts = [packed[at + j * n_pad:at + (j + 1) * n_pad] for j in range(3)]
        args = (packed[body:body + d_pad], packed[:body].view(d_pad, WORDS_PER_SHARD),
                *parts, s_pad)
        if self.device.type != "cuda":
            # A CPU planner whose sparse path was turned on by hand, as the
            # parity tests do: the kernel's plain version.
            self._last_upload = phases
            return kernels.assemble_stack(*args), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream()):
            t0 = time.perf_counter()
            arr = kernels.assemble_stack(*args)
            phases["assemble_host"] = (time.perf_counter() - t0) * 1e3
            phases["assemble"] = (phases["h2d"][1], torch.cuda.Event(enable_timing=True))
            phases["assemble"][1].record()
        self._last_upload = phases
        # The stack was allocated on the upload stream: its readers run on
        # the caller's stream, so the allocator must not hand its memory
        # on before their work ends.
        arr.record_stream(torch.cuda.current_stream(self.device))
        return arr, self._upload_done()

    def _build_stack_packed(self, idx: Index, field_name: str, view: str, row_id: int,
                            shards: tuple):
        """One low-cardinality row across ``shards`` as a packed [S_pad, K]
        int32 stack of sorted in-shard positions, SENTINEL-padded, and the
        event its readers wait on (reference _build_stack_packed,
        planner.py:1428-1458): K is the pow2 bucket of the largest
        per-shard cardinality, so the upload and the residency cost 4 B a
        set bit instead of the 128 KiB dense block. It is uploaded through
        a pinned buffer on the upload stream, as a dense stack is. A row
        that outgrew the packed class since plan time still builds right,
        only wider: the plan's revalidation drops the packed plan at the
        next epoch move."""
        t0 = time.perf_counter()
        rows: list[tuple[int, np.ndarray]] = []
        max_bits = 0
        for i, shard in enumerate(shards):
            frag = self.holder.fragment(idx.name, field_name, view, shard)
            if frag is None:
                continue
            kind, payload = frag.row_upload(row_id)
            pos = bitops.words_to_positions(payload) if kind == "dense" else payload
            if len(pos):
                rows.append((i, pos))
                max_bits = max(max_bits, len(pos))
        k = _residency.pack_width(max_bits)
        gather = {"gather": (time.perf_counter() - t0) * 1e3}

        def fill(mat):
            mat[:] = _residency.SENTINEL
            for i, pos in rows:
                mat[i, :len(pos)] = pos

        arr = self._alloc((self._pad(len(shards)), k))
        self._last_upload = {**gather, **self._upload_into(arr, fill)}
        return arr, self._upload_done()


def _time_bound(leaves: list) -> bool:
    """True when a plan read time views (or a window's zero leaf): which
    views exist changes with the data, so such a plan is not cached."""
    return any(leaf[0] == "zero" or (leaf[0] == "row" and is_time_view(leaf[2]))
               for leaf in leaves)


class _CountProgram:
    """A count program: ``fn(*args)`` -> int32 [S_pad] per-shard counts of
    the signature's tree over the leaf inputs, one count launch (plus the
    compare, shift and expand launches its leaves need); ``fn.batched([args,
    ...])`` -> [B, S_pad] for a wave of B argument lists of this signature,
    with ONE count launch for the wave (the port's counterpart of the JAX
    planner's jit(vmap(program)), planner.py:387-396). A program with a
    packed leaf (``packed``) takes the fast paths of the JAX planner's
    ``_packed_count_program`` (:1906-1929): a bare packed leaf is ONE
    ``packed_count``, an Intersect of exactly two leaves with a packed one
    ONE ``packed_and_dense_count`` (either order) or, both packed, ONE
    ``packed_pair_count``, and a wave of them ONE launch of the wrapper's
    batched form; every other tree expands its packed leaves and counts as
    a dense one, and has no batched form (``has_batched``): a wave of it
    would hold B expanded planes at once."""

    __slots__ = ("sig", "packed", "_fast")

    def __init__(self, sig: tuple):
        self.sig = sig
        self.packed = _has_pleaf(sig)
        self._fast = _packed_fast_path(sig)

    @property
    def has_batched(self) -> bool:
        return not self.packed or self._fast is not None

    def __call__(self, *args) -> torch.Tensor:
        if self._fast is not None:
            name, slots = self._fast
            return getattr(kernels, name)(*(args[i] for i in slots))
        tape = _Tape()
        return _count_expr(_lower(self.sig, args, tape), tape.leaves)

    def batched(self, rows) -> torch.Tensor:
        if self._fast is not None:
            name, slots = self._fast
            return getattr(kernels, name + "_batched")(*([args[i] for args in rows]
                                                         for i in slots))
        # Leaves dedupe by their place in the signature, not by tensor, so
        # every slot lowers to the same expression and tape.
        lowered = []
        for args in rows:
            tape = _Tape()
            lowered.append((_lower(self.sig, args, tape), tape.leaves))
        expr = lowered[0][0]
        tables = [leaves for _, leaves in lowered]
        if expr[0] == "p":
            return kernels.row_counts_batched([ls[expr[1]] for ls in tables])
        op, a, b = expr
        if a[0] == "p" and b[0] == "p":
            return kernels.pair_count_batched([ls[a[1]] for ls in tables],
                                              [ls[b[1]] for ls in tables], op)
        return kernels.tree_count_batched(tables, _postfix(expr))


def _has_pleaf(sig) -> bool:
    """True when a signature (or a tuple of its nodes) holds a packed leaf
    anywhere."""
    if not isinstance(sig, tuple):
        return False
    return (bool(sig) and sig[0] == "pleaf") or any(_has_pleaf(x) for x in sig)


def _packed_fast_path(sig: tuple):
    """(kernel wrapper name, the argument slots it takes in order) for the
    signatures a packed kernel counts without expanding, else None
    (reference _packed_count_program, planner.py:1906-1929). The wrapper's
    ``_batched`` form counts a wave of them."""
    if sig[0] == "pleaf":
        return "packed_count", (sig[1],)
    if sig[0] == "intersect" and len(sig[1]) == 2:
        (ka, sa), (kb, sb) = ((k[0], k[1]) for k in sig[1])
        if ka == kb == "pleaf":
            return "packed_pair_count", (sa, sb)
        if ka == "pleaf" and kb == "leaf":
            return "packed_and_dense_count", (sa, sb)
        if ka == "leaf" and kb == "pleaf":
            return "packed_and_dense_count", (sb, sa)
    return None


def _count_expr(expr: tuple, leaves: list) -> torch.Tensor:
    """Per-row counts of ``expr`` over ``leaves``: row_counts of a bare
    leaf, pair_count of a 2-leaf op, one tree_count of anything else."""
    if expr[0] == "p":
        return kernels.row_counts(leaves[expr[1]])
    op, a, b = expr
    if a[0] == "p" and b[0] == "p":
        return kernels.pair_count(leaves[a[1]], leaves[b[1]], op)
    return kernels.tree_count(leaves, _postfix(expr))


class _Tape:
    """The leaf planes of one lowering and a plane maker over them."""

    def __init__(self):
        self.leaves: list[torch.Tensor] = []
        self._slots: dict = {}

    def slot(self, key):
        """The tape index of the plane keyed ``key``, or None."""
        return self._slots.get(key)

    def leaf(self, t: torch.Tensor, key=None) -> tuple:
        """``("p", i)`` for plane ``t``. ``key`` names the plane's place in
        the signature (an argument slot, or its exists/sign part): a leaf
        used twice is one kernel input, and one signature lowers to one
        tape whatever tensors its arguments hold. A computed plane (no
        key) gets its own slot."""
        if key is None:
            self.leaves.append(t)
            return ("p", len(self.leaves) - 1)
        i = self._slots.get(key)
        if i is None:
            i = self._slots[key] = len(self.leaves)
            self.leaves.append(t)
        return ("p", i)

    def plane(self, expr: tuple) -> torch.Tensor:
        """The [S_pad, W] plane of ``expr``: a leaf as it is, any tree from
        one tree_count launch with its result plane written."""
        if expr[0] == "p":
            return self.leaves[expr[1]]
        return kernels.tree_count(self.leaves, _postfix(expr), plane=True)[1]


def _postfix(expr: tuple) -> list:
    """The tree_count tape of an expression over ``_Tape`` planes."""
    if expr[0] == "p":
        return [expr[1]]
    return _postfix(expr[1]) + _postfix(expr[2]) + [expr[0]]


def _lower(sig: tuple, args, tape: _Tape) -> tuple:
    """A signature node as an expression over planes: ``("p", i)`` or
    ``(op, a, b)`` with op in and/or/xor/andnot (reference _eval_node,
    planner.py:1932-2030). Row, existence and const leaves enter as they
    are; a Shift evaluates its child to a plane and enters the
    ``shift_left`` kernel's output; a BSI condition runs ``bsi_compare``
    against the exists row, and its sign-class branches become tree ops
    on the exists (E), sign (S) and compare (C) planes:
    pos = E & ~S, neg = E & S, and C & ~S = C(pos) since C lies inside E.
    The leaves are never written in place."""
    kind = sig[0]
    if kind == "leaf":
        return tape.leaf(args[sig[1]], sig[1])
    if kind == "pleaf":
        # A packed leaf in a general tree: expanded to a dense plane on the
        # device, once however often the tree names it (reference
        # _eval_node, planner.py:1937-1942).
        slot = sig[1]
        i = tape.slot(slot)
        if i is None:
            return tape.leaf(kernels.packed_expand(args[slot]), slot)
        return ("p", i)
    if kind in _PAIR_OPS:
        op = _PAIR_OPS[kind]
        kids = [_lower(k, args, tape) for k in sig[1]]
        acc = kids[0]
        for k in kids[1:]:
            acc = (op, acc, k)
        return acc
    if kind == "not":
        _, slot, child = sig
        return ("andnot", tape.leaf(args[slot], slot), _lower(child, args, tape))
    if kind == "shift":
        _, n, child = sig
        expr = _lower(child, args, tape)
        if n == 0:
            return expr
        return tape.leaf(kernels.shift_left(tape.plane(expr), n))
    exists, sign, cube = args[sig[1]]
    e, s = tape.leaf(exists, (sig[1], 0)), tape.leaf(sign, (sig[1], 1))
    if kind == "bsi_notnull":
        return e
    if kind == "bsi_zero":
        return ("andnot", e, e)

    def cmp(op: str, pslot: int, allow_eq: bool) -> tuple:
        lo, hi = args[pslot]
        return tape.leaf(bsi_ops._compare_select(cube, exists, lo, hi, depth,
                                                 op, allow_eq))

    def pos(x):
        return ("andnot", x, s)

    def neg(x):
        return ("and", x, s)

    if kind in ("bsi_eq", "bsi_neq"):
        _, _, depth, negative, pslot = sig
        c = cmp("eq", pslot, True)
        eq = neg(c) if negative else pos(c)
        return eq if kind == "bsi_eq" else ("andnot", e, eq)
    if kind in ("bsi_lt", "bsi_gt"):
        _, _, depth, allow_eq, branch_pos, pslot = sig
        if kind == "bsi_lt":
            if branch_pos:
                # All negatives, plus positives below the predicate
                # (rangeLT fragment.go:1332).
                return ("or", neg(e), pos(cmp("lt", pslot, allow_eq)))
            return neg(cmp("gt", pslot, allow_eq))
        if branch_pos:
            return pos(cmp("gt", pslot, allow_eq))
        # Negatives with smaller magnitude, plus all positives (rangeGT
        # fragment.go:1404).
        return ("or", pos(e), neg(cmp("lt", pslot, allow_eq)))
    if kind == "bsi_between":
        _, _, depth, case, plo, phi = sig
        if case == "pos":
            return pos(("and", cmp("gt", plo, True), cmp("lt", phi, True)))
        if case == "neg":
            return neg(("and", cmp("gt", phi, True), cmp("lt", plo, True)))
        # Crossing zero (rangeBetween fragment.go:1457).
        return ("or", pos(cmp("lt", phi, True)), neg(cmp("lt", plo, True)))
    raise ValueError(f"unknown signature node {kind!r}")


def _agg_min_max(exists, sign, cube, filt, depth: int, is_min: bool):
    """Per-shard Min/Max over stacked [S_pad, W] BSI rows (reference
    planner.py:2086). Returns (consider_count[S], alt_count[S], a, b):
    ``a`` is the (lo, hi, count) of the branch taken when the sign class
    exists in the shard (negatives for Min, positives for Max,
    fragment.go:1146/:1189) and ``b`` the fallback; the host picks per
    shard."""
    consider = exists & filt
    alt = (sign & consider) if is_min else bitops.b_andnot(consider, sign)
    a = bsi_ops._max_unsigned(cube, alt, depth)  # Min: -max(|neg|); Max: max(pos)
    b = bsi_ops._min_unsigned(cube, consider, depth)
    return kernels.row_counts(consider), kernels.row_counts(alt), a, b


def _fold_min_max(cc, ac, a, b, n_shards: int, is_min: bool) -> tuple[int, int]:
    """The reference's smaller/larger fold over shards (planner.py:2107),
    vectorised: shards without values are skipped, and on a tie the first
    shard's count stands (counts do not add across shards). The
    reference's loop also lets a zero-count shard be replaced
    unconditionally; that cannot change the answer here, because at
    depth > 0 every shard with values has a count of at least 1 and at
    depth 0 every count is 0. lo/hi may be scalars or per-shard arrays."""
    cc = np.asarray(cc)
    av = [np.broadcast_to(np.asarray(x), cc.shape)[:n_shards] for x in a]
    bv = [np.broadcast_to(np.asarray(x), cc.shape)[:n_shards] for x in b]
    live = cc[:n_shards] != 0
    if not live.any():
        return 0, 0
    use_a = np.asarray(ac)[:n_shards] > 0

    def join(lo, hi):  # int32 bit-pattern halves -> magnitudes (depth <= 63)
        return ((hi.astype(np.int64) & 0xFFFFFFFF) << 32) | (lo.astype(np.int64)
                                                             & 0xFFFFFFFF)

    mag = np.where(use_a, join(av[0], av[1]), join(bv[0], bv[1]))
    cnt = np.where(use_a, av[2], bv[2])
    vals = np.where(use_a if is_min else ~use_a, -mag, mag)
    best = vals[live].min() if is_min else vals[live].max()
    first = int(np.flatnonzero(live & (vals == best))[0])
    return int(best), int(cnt[first])
