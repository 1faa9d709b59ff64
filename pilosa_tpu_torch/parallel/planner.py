"""Planner — run a PQL bitmap call tree over all shards of one device at
once, as ``[S_pad, W]`` stacks.

The port's counterpart of pilosa_tpu/parallel/planner.py (MeshPlanner),
cut down to one GPU: no mesh, no jit (PyTorch runs eagerly), dense leaves
only. This replaces the reference's hot loop (executor.go:2561-2608:
per-shard jobs, each running per-container roaring kernels):

- every leaf ``Row()`` of the tree becomes an ``[S_pad, W]`` int32 stack —
  shard ``s``'s row in slot ``s``, zero rows past the last shard — cached
  on the device until a fragment under it mutates;
- ``Count`` of a bare leaf runs the ``row_counts`` kernel, and of a 2-leaf
  Intersect/Union/Xor/Difference the ``pair_count`` kernel, which reads
  each leaf once and writes no intermediate plane. Every other tree is
  evaluated with torch bitwise ops and its popcount goes through
  ``row_counts``;
- per-shard int32 counts come back to the host and are widened to int64
  before the cross-shard sum (reference reduceFn, executor.go:2455).

Each query ends in one synchronising ``.cpu()``; the JAX package's
asynchronous batcher, dispatch coalescer and prefetcher come with a later
slice (ROADMAP.md Queue 1: executor remainder).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from pilosa_tpu_torch.config import WORDS_PER_SHARD
from pilosa_tpu_torch.core.fragment import resolve_counts, row_id_arg
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.errors import (
    SLICE_BSI,
    SLICE_EXECUTOR,
    FieldNotFoundError,
    NotPortedError,
    QueryError,
)
from pilosa_tpu_torch.ops import bitops, kernels
from pilosa_tpu_torch.pql import Call

_NARY = {"intersect": bitops.b_and, "union": bitops.b_or,
         "xor": bitops.b_xor, "difference": bitops.b_andnot}
_PAIR_OPS = {"intersect": "and", "union": "or", "xor": "xor",
             "difference": "andnot"}


class Planner:
    """Shard-stacked execution of bitmap call trees on the holder's device."""

    #: default device-memory budget for cached leaf stacks (bytes).
    DEFAULT_CACHE_BYTES = 4 << 30

    def __init__(self, holder, max_cache_bytes: int = DEFAULT_CACHE_BYTES):
        self.holder = holder
        self.device = holder.device
        #: LRU of (index, instance, field, view, row_id, shards) ->
        #: (epoch, gens, [S_pad, W] tensor); bounded by max_cache_bytes.
        #: A hit is ONE integer compare against the index's mutation
        #: epoch; only an epoch change triggers the per-fragment
        #: generation walk (and only for the touched leaf).
        self._stack_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._cache_bytes = 0
        self.max_cache_bytes = max_cache_bytes
        #: lifetime host->device stack builds and their bytes.
        self.uploads = 0
        self.upload_bytes = 0
        self._cache_lock = threading.Lock()
        #: structural signature -> count program
        self._fn_cache: dict[tuple, Callable] = {}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def supports(self, c: Call) -> bool:
        """True if the call tree is set-field bitmap algebra this planner
        runs: Row leaves under Intersect/Union/Xor/Difference."""
        if c.name == "Row":
            return not c.has_condition_arg()
        if c.name.lower() in _PAIR_OPS:
            return all(self.supports(ch) for ch in c.children)
        return False

    def execute_count(self, idx: Index, c: Call, shards: list[int]) -> int:
        """Count(tree) over ``shards``: one count program on the stacked
        leaves, one copy of the per-shard counts to the host."""
        if not shards:
            return 0
        leaves: list[tuple] = []
        sig = self._signature(idx, c, leaves)
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards)) for leaf in leaves]
        per_shard = self._compiled(sig)(*arrays)
        # Per-shard int32 popcounts (<= 2^30 each) widened before the sum:
        # immune to int32 overflow across many full shards.
        return int(per_shard.cpu().numpy().astype(np.int64).sum())

    def _tree_stack(self, idx: Index, c: Call, shards: list[int]) -> torch.Tensor:
        """Evaluate a bitmap tree to its stacked [S_pad, W] device tensor."""
        leaves: list[tuple] = []
        sig = self._signature(idx, c, leaves)
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards)) for leaf in leaves]
        return _eval_node(sig, arrays)

    def execute_bitmap(self, idx: Index, c: Call, shards: list[int]) -> Row:
        """Evaluate the tree to a Row whose segments are device slices of
        the stacked result (no host sync)."""
        if not shards:
            return Row()
        out = self._tree_stack(idx, c, shards)  # [S_pad, W]
        return Row({shard: out[i] for i, shard in enumerate(shards)})

    def execute_topn_counts(self, idx: Index, field_name: str, view: str,
                            shards: list[int], filter_call: Call | None,
                            row_ids=None) -> dict[int, tuple]:
        """shard -> (ids, counts) arrays SORTED by count desc / id asc,
        preserving per-fragment semantics (threshold filtering stays per
        shard in the executor, executor.go:902). With a filter, the dense
        tier of every shard runs ``pair_count`` against its slice of the
        filter stack, and all shards' device counts come back in one
        transfer."""
        allowed = (np.asarray(sorted(set(int(r) for r in row_ids)),
                              dtype=np.uint64)
                   if row_ids is not None else None)
        out: dict[int, tuple] = {}
        filt = filt_host = None
        if filter_call is not None:
            filt = self._tree_stack(idx, filter_call, shards)  # [S_pad, W]
            # ONE pull of the filter for every shard's sparse host tier.
            filt_host = bitops.to_host_words(filt)
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
            counts, parts = frag.intersection_counts_async(
                ids, filt[si], reuse=True, seg_host=filt_host[si])
            pending.append((shard, ids, counts, parts))
        # Resolve every shard's device tiles in one transfer.
        resolve_counts([(counts, slots, dev)
                        for _, _, counts, parts in pending
                        for slots, dev in parts])
        for shard, ids, counts, _ in pending:
            order = np.lexsort((ids, -counts))
            out[shard] = (ids[order], counts[order])
        return out

    # ------------------------------------------------------------------
    # signatures
    # ------------------------------------------------------------------

    def _signature(self, idx: Index, c: Call, leaves: list[tuple]) -> tuple:
        """DFS the call tree, appending leaf specs and returning a
        hashable structure key. Leaf position in ``leaves`` is its input
        slot in the count program."""
        name = c.name
        if name == "Row":
            if c.has_condition_arg():
                raise NotPortedError("Row() with a BSI condition", SLICE_BSI)
            if "from" in c.args or "to" in c.args:
                raise NotPortedError("Row() over time views", SLICE_BSI)
            field_name = c.field_arg()
            if idx.field(field_name) is None:
                raise FieldNotFoundError(f"field not found: {field_name!r}")
            row_id = row_id_arg(c, field_name)
            leaves.append(("row", field_name, VIEW_STANDARD, row_id))
            return ("leaf", len(leaves) - 1)
        kind = name.lower()
        if kind in _PAIR_OPS:
            if not c.children:
                raise QueryError(f"empty {name} query is currently not supported")
            kids = tuple(self._signature(idx, ch, leaves) for ch in c.children)
            return (kind, kids)
        if name in ("Not", "Shift"):
            raise NotPortedError(f"{name}()", SLICE_EXECUTOR)
        raise QueryError(f"unsupported planner call: {name}")

    def _compiled(self, sig: tuple) -> Callable:
        """The count program for a signature: [S_pad, W] leaves -> int32
        [S_pad] per-shard counts. A bare leaf runs row_counts, a 2-leaf
        op pair_count; any other tree is evaluated with torch ops and
        counted by row_counts."""
        fn = self._fn_cache.get(sig)
        if fn is not None:
            return fn
        if sig[0] == "leaf":
            slot = sig[1]

            def fn(*args):
                return kernels.row_counts(args[slot])
        elif (sig[0] in _PAIR_OPS and len(sig[1]) == 2
              and all(k[0] == "leaf" for k in sig[1])):
            i, j = sig[1][0][1], sig[1][1][1]
            op = _PAIR_OPS[sig[0]]

            def fn(*args):
                return kernels.pair_count(args[i], args[j], op)
        else:
            def fn(*args):
                return kernels.row_counts(_eval_node(sig, args))
        self._fn_cache[sig] = fn
        return fn

    # ------------------------------------------------------------------
    # leaf fetch: host rows -> [S_pad, W] device stacks
    # ------------------------------------------------------------------

    @staticmethod
    def _pad(s: int) -> int:
        """Stack height for ``s`` shards: the next power of two, so the
        space of distinct [S_pad, W] shapes stays O(log S). Padding rows are
        zero blocks — bit-identical results, because every consumer either
        sums popcounts (zero rows count 0) or slices only the real shard
        slots (execute_bitmap, TopN)."""
        return 1 << (s - 1).bit_length() if s > 0 else 0

    def _gens(self, index_name: str, field_name: str, view: str,
              shards: tuple) -> tuple:
        out = []
        for shard in shards:
            frag = self.holder.fragment(index_name, field_name, view, shard)
            out.append(-1 if frag is None else frag.generation)
        return tuple(out)

    def _fetch_leaf(self, idx: Index, leaf: tuple, shards: tuple) -> torch.Tensor:
        _, field_name, view, row_id = leaf
        return self._stack_rows(idx, field_name, view, row_id, shards)

    def _stack_rows(self, idx: Index, field_name: str, view: str, row_id: int,
                    shards: tuple) -> torch.Tensor:
        """Stack of one row across shards on the device; cached until any
        involved fragment mutates. Validation is two-tier: an O(1)
        index-epoch compare, then (only when the epoch moved) the
        per-fragment generation walk — if that shows the leaf unchanged
        the entry is re-stamped instead of re-uploaded."""
        key = (idx.name, idx.instance_id, field_name, view, row_id, shards)
        epoch = idx.epoch.value
        with self._cache_lock:
            hit = self._stack_cache.get(key)
            gens = None
            if hit is not None:
                if hit[0] == epoch:
                    self._stack_cache.move_to_end(key)
                    return hit[2]
                gens = self._gens(idx.name, field_name, view, shards)
                if gens == hit[1]:
                    self._stack_cache[key] = (epoch, gens, hit[2])
                    self._stack_cache.move_to_end(key)
                    return hit[2]
        # Build outside the lock: row materialization and the upload can
        # be slow. Two threads may race to build one stack; the second
        # insert simply wins.
        if gens is None:
            gens = self._gens(idx.name, field_name, view, shards)
        arr = self._build_stack(idx, field_name, view, row_id, shards)
        self._insert_stack(key, epoch, gens, arr)
        return arr

    def _insert_stack(self, key: tuple, epoch: int, gens: tuple,
                      arr: torch.Tensor) -> None:
        """Insert first, then evict LRU entries past the byte budget."""
        nbytes = arr.numel() * arr.element_size()
        with self._cache_lock:
            self.uploads += 1
            self.upload_bytes += nbytes
            old = self._stack_cache.pop(key, None)
            if old is not None:
                self._cache_bytes -= old[2].numel() * old[2].element_size()
            self._stack_cache[key] = (epoch, gens, arr)
            self._cache_bytes += nbytes
            while (self._cache_bytes > self.max_cache_bytes
                   and len(self._stack_cache) > 1):
                _, (_, _, dropped) = self._stack_cache.popitem(last=False)
                self._cache_bytes -= dropped.numel() * dropped.element_size()

    def _build_stack(self, idx: Index, field_name: str, view: str,
                     row_id: int, shards: tuple) -> torch.Tensor:
        """Materialize one row across ``shards`` as an [S_pad, W] stack on
        the device; rows past the last shard stay zero."""
        mat = np.zeros((self._pad(len(shards)), WORDS_PER_SHARD), dtype=np.uint32)
        for i, shard in enumerate(shards):
            frag = self.holder.fragment(idx.name, field_name, view, shard)
            if frag is not None:
                mat[i] = frag.row_words(row_id)
        return bitops.to_device_words(mat, self.device)


def _eval_node(sig: tuple, args) -> torch.Tensor:
    """Recursively evaluate a signature node against leaf stacks with
    torch bitwise ops (the leaves are never written in place)."""
    kind = sig[0]
    if kind == "leaf":
        return args[sig[1]]
    op = _NARY[kind]
    kids = [_eval_node(k, args) for k in sig[1]]
    acc = kids[0]
    for k in kids[1:]:
        acc = op(acc, k)
    return acc
