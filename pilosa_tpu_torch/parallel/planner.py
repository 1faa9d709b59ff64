"""Planner — run a PQL bitmap call tree over all shards of one device at
once, as ``[S_pad, W]`` stacks.

The port's counterpart of pilosa_tpu/parallel/planner.py (MeshPlanner),
cut down to one GPU: no mesh, no jit (PyTorch runs eagerly), dense leaves
only. This replaces the reference's hot loop (executor.go:2561-2608:
per-shard jobs, each running per-container roaring kernels):

- every leaf ``Row()`` of the tree becomes an ``[S_pad, W]`` int32 stack —
  shard ``s``'s row in slot ``s``, zero rows past the last shard — cached
  on the device until a fragment under it mutates;
- a BSI condition ``Row(v > x)`` reads the field's exists and sign stacks
  and its magnitude planes as one cached ``[depth, S_pad, W]`` cube, and
  runs the ``bsi_compare`` kernel (the signed branches are torch bitwise
  ops around it);
- ``Count`` of a bare leaf runs the ``row_counts`` kernel, and of a 2-leaf
  Intersect/Union/Xor/Difference the ``pair_count`` kernel, which reads
  each leaf once and writes no intermediate plane. Every other tree is
  evaluated with torch ops and its popcount goes through ``row_counts``;
- ``Sum`` counts the cube against the positive and negative class rows
  with ``pair_count`` (an ``[S_pad, W]`` row against the ``[depth, S_pad,
  W]`` cube), ``Min``/``Max`` run the ``bsi_minmax`` descent on every shard
  at once;
- per-shard int32 counts come back to the host and are widened to int64
  before the cross-shard sum (reference reduceFn, executor.go:2455); Sum's
  2^i weights are applied in Python ints.

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
from pilosa_tpu_torch.core.fragment import (
    BSI_EXISTS_BIT,
    BSI_OFFSET_BIT,
    BSI_SIGN_BIT,
    resolve_counts,
    row_id_arg,
)
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD, view_bsi_name
from pilosa_tpu_torch.errors import (
    SLICE_EXECUTOR,
    SLICE_FIELDS,
    BSIGroupNotFoundError,
    FieldNotFoundError,
    NotPortedError,
    QueryError,
)
from pilosa_tpu_torch.ops import bitops, kernels
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.pql import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ, Call, Condition

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
        """True if the call tree is bitmap algebra this planner runs: Row
        leaves (BSI conditions included) under
        Intersect/Union/Xor/Difference."""
        if c.name in ("Row", "Range"):
            return True
        if c.name.lower() in _PAIR_OPS:
            return all(self.supports(ch) for ch in c.children)
        return False

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

    # ------------------------------------------------------------------
    # BSI aggregates: Sum/Min/Max over every shard at once (the stepped
    # bodies of the reference's dispatch_sum / dispatch_min_max,
    # planner.py:553-645, run eagerly with one copy to the host)
    # ------------------------------------------------------------------

    def _bsi_inputs(self, idx: Index, c: Call, shards: list[int]):
        """(exists, sign, [depth, S_pad, W] cube, filter, depth) on the
        device; the filter is all ones without a child."""
        field_name, _ = c.string_arg("field")
        depth = idx.field(field_name).bsi_group.bit_depth
        exists, sign, cube = self._fetch_leaf(idx, ("bsi", field_name, depth),
                                              tuple(shards))
        if c.children:
            filt = self._tree_stack(idx, c.children[0], shards)
        else:
            filt = torch.full_like(exists, -1)
        return exists, sign, cube, filt, depth

    def execute_sum(self, idx: Index, c: Call, shards: list[int]) -> tuple[int, int]:
        """Global (sum of base-relative values, count); the executor adds
        the BSI base (reference fragment.sum :1111 under executeSum
        :406)."""
        if not shards:
            return 0, 0
        exists, sign, cube, filt, depth = self._bsi_inputs(idx, c, shards)
        cnt, pos, neg = bsi_ops.sum_counts(exists, sign, cube, filt, depth)
        host = torch.cat([cnt, pos.reshape(-1), neg.reshape(-1)]).cpu().numpy()
        host = host.astype(np.int64)  # widen before any sum
        s_pad = cnt.shape[0]
        count = int(host[:s_pad].sum())
        p = host[s_pad:s_pad * (depth + 1)].reshape(depth, s_pad).sum(axis=-1)
        n = host[s_pad * (depth + 1):].reshape(depth, s_pad).sum(axis=-1)
        total = sum((1 << i) * (int(p[i]) - int(n[i])) for i in range(depth))
        return total, count

    def execute_min_max(self, idx: Index, c: Call, shards: list[int],
                        is_min: bool) -> tuple[int, int]:
        """Global (value, count) before the base: every shard's extremum
        from one stacked descent, host-folded with the reference's
        smaller/larger rule."""
        if not shards:
            return 0, 0
        exists, sign, cube, filt, depth = self._bsi_inputs(idx, c, shards)
        cons_cnt, alt_cnt, a, b = _agg_min_max(exists, sign, cube, filt, depth,
                                               is_min)
        host = torch.stack([cons_cnt, alt_cnt, *a, *b]).cpu().numpy()
        return _fold_min_max(host[0], host[1], tuple(host[2:5]),
                             tuple(host[5:8]), len(shards), is_min)

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
        slot in the count program. A BSI condition appends its ``bsi``
        leaf and ``pred`` leaves (reference planner.py:1074-1207)."""
        name = c.name
        if name in ("Row", "Range"):
            if c.has_condition_arg():
                return self._bsi_signature(idx, c, leaves)
            if name == "Range" or "from" in c.args or "to" in c.args:
                raise NotPortedError(f"{name}() over time views", SLICE_FIELDS)
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

    def _fetch_leaf(self, idx: Index, leaf: tuple, shards: tuple):
        """A leaf's device input: a ``row`` leaf's [S_pad, W] stack, a
        ``bsi`` leaf's (exists, sign, [depth, S_pad, W] cube), a ``pred``
        leaf's (lo, hi) halves."""
        kind = leaf[0]
        if kind == "row":
            _, field_name, view, row_id = leaf
            return self._stack_rows(idx, field_name, view, row_id, shards)
        if kind == "pred":
            return bsi_ops.split_u64(leaf[1])
        if kind == "bsi":
            _, field_name, depth = leaf
            view = view_bsi_name(field_name)
            return (self._stack_rows(idx, field_name, view, BSI_EXISTS_BIT, shards),
                    self._stack_rows(idx, field_name, view, BSI_SIGN_BIT, shards),
                    self._stack_planes(idx, field_name, depth, shards))
        raise QueryError(f"unknown leaf kind {kind!r}")

    def _stack_rows(self, idx: Index, field_name: str, view: str, row_id: int,
                    shards: tuple) -> torch.Tensor:
        """Stack of one row across shards on the device."""
        return self._cached(idx, field_name, view, row_id, shards, lambda: (
            bitops.to_device_words(self._plane_words(idx, field_name, view,
                                                     row_id, shards), self.device)))

    def _stack_planes(self, idx: Index, field_name: str, depth: int,
                      shards: tuple) -> torch.Tensor:
        """[depth, S_pad, W] cube of a BSI field's magnitude planes, built
        plane by plane straight into one device tensor and cached like a
        row stack. The key carries the depth, so a field whose bit depth
        grew reads a new cube. Depth 0 gives an empty cube."""
        view = view_bsi_name(field_name)

        def build() -> torch.Tensor:
            cube = torch.empty((depth, self._pad(len(shards)), WORDS_PER_SHARD),
                               dtype=torch.int32, device=self.device)
            for i in range(depth):
                words = self._plane_words(idx, field_name, view,
                                          BSI_OFFSET_BIT + i, shards)
                cube[i].copy_(torch.from_numpy(words.view(np.int32)))
            return cube

        return self._cached(idx, field_name, view, ("planes", depth), shards,
                            build)

    def _cached(self, idx: Index, field_name: str, view: str, tag, shards: tuple,
                build: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The device tensor ``build()`` makes from (field, view, shards),
        cached until any involved fragment mutates. Validation is two-tier:
        an O(1) index-epoch compare, then (only when the epoch moved) the
        per-fragment generation walk — if that shows the fragments
        unchanged the entry is re-stamped instead of re-uploaded."""
        key = (idx.name, idx.instance_id, field_name, view, tag, shards)
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
        arr = build()
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

    def _plane_words(self, idx: Index, field_name: str, view: str,
                     row_id: int, shards: tuple) -> np.ndarray:
        """One row across ``shards`` as [S_pad, W] uint32 host words; rows
        past the last shard stay zero."""
        mat = np.zeros((self._pad(len(shards)), WORDS_PER_SHARD), dtype=np.uint32)
        for i, shard in enumerate(shards):
            frag = self.holder.fragment(idx.name, field_name, view, shard)
            if frag is not None:
                mat[i] = frag.row_words(row_id)
        return mat


def _eval_node(sig: tuple, args) -> torch.Tensor:
    """Recursively evaluate a signature node against leaf inputs: torch
    bitwise ops for the set algebra and the signed BSI branches, the
    ``bsi_compare`` kernel for the unsigned comparisons (reference
    planner.py:1932-2030). The leaves are never written in place."""
    kind = sig[0]
    if kind == "leaf":
        return args[sig[1]]
    if kind in _NARY:
        op = _NARY[kind]
        kids = [_eval_node(k, args) for k in sig[1]]
        acc = kids[0]
        for k in kids[1:]:
            acc = op(acc, k)
        return acc
    exists, sign, cube = args[sig[1]]
    if kind == "bsi_notnull":
        return exists
    if kind == "bsi_zero":
        return torch.zeros_like(exists)
    pos, neg = bitops.b_andnot(exists, sign), exists & sign
    if kind in ("bsi_eq", "bsi_neq"):
        _, _, depth, negative, pslot = sig
        eq = bsi_ops._compare_select(cube, neg if negative else pos, *args[pslot],
                                     depth, "eq", True)
        return eq if kind == "bsi_eq" else bitops.b_andnot(exists, eq)
    if kind in ("bsi_lt", "bsi_gt"):
        _, _, depth, allow_eq, branch_pos, pslot = sig
        lo, hi = args[pslot]
        if kind == "bsi_lt":
            if branch_pos:
                # All negatives, plus positives below the predicate
                # (rangeLT fragment.go:1332).
                return neg | bsi_ops._compare_select(cube, pos, lo, hi, depth,
                                                     "lt", allow_eq)
            return bsi_ops._compare_select(cube, neg, lo, hi, depth, "gt", allow_eq)
        if branch_pos:
            return bsi_ops._compare_select(cube, pos, lo, hi, depth, "gt", allow_eq)
        # Negatives with smaller magnitude, plus all positives (rangeGT
        # fragment.go:1404).
        return pos | bsi_ops._compare_select(cube, neg, lo, hi, depth, "lt", allow_eq)
    if kind == "bsi_between":
        _, _, depth, case, plo, phi = sig
        (llo, lhi), (hlo, hhi) = args[plo], args[phi]
        if case == "pos":
            return (bsi_ops._compare_select(cube, pos, llo, lhi, depth, "gt", True)
                    & bsi_ops._compare_select(cube, pos, hlo, hhi, depth, "lt", True))
        if case == "neg":
            return (bsi_ops._compare_select(cube, neg, hlo, hhi, depth, "gt", True)
                    & bsi_ops._compare_select(cube, neg, llo, lhi, depth, "lt", True))
        # Crossing zero (rangeBetween fragment.go:1457).
        return (bsi_ops._compare_select(cube, pos, hlo, hhi, depth, "lt", True)
                | bsi_ops._compare_select(cube, neg, llo, lhi, depth, "lt", True))
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
