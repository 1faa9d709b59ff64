"""Planner — run a PQL bitmap call tree over all shards of one device at
once, as ``[S_pad, W]`` stacks.

The port's counterpart of pilosa_tpu/parallel/planner.py (MeshPlanner),
cut down to one GPU: no mesh, no jit (PyTorch runs eagerly), dense leaves
only. This replaces the reference's hot loop (executor.go:2561-2608:
per-shard jobs, each running per-container roaring kernels):

- every leaf ``Row()`` of the tree becomes an ``[S_pad, W]`` int32 stack —
  shard ``s``'s row in slot ``s``, zero rows past the last shard — cached
  on the device until a fragment under it mutates; ``Not`` adds the
  existence row (``_exists`` row 0) as a leaf;
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
  2^i weights are applied in Python ints.

``prepare_count`` keeps the reference's plan cache: a repeated Count text
over the same shards and schema skips the signature walk, and its leaves
re-resolve through the epoch-validated stack cache. Each query ends in one
synchronising ``.cpu()``; the JAX package's asynchronous batcher, dispatch
coalescer and prefetcher come with a later slice (ROADMAP.md Queue 1:
executor remainder: async path).
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
    SLICE_FIELDS,
    BSIGroupNotFoundError,
    FieldNotFoundError,
    NotPortedError,
    QueryError,
)
from pilosa_tpu_torch.exec import fuse as _fuse
from pilosa_tpu_torch.ops import bitops, kernels
from pilosa_tpu_torch.ops import bsi as bsi_ops
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

    def __init__(self, holder, max_cache_bytes: int = DEFAULT_CACHE_BYTES,
                 bucket_policy: str = "pow2"):
        self.holder = holder
        self.device = holder.device
        #: plan-shape bucketing ("pow2" | "none"): stack heights round up
        #: to powers of two, so the space of [S_pad, W] shapes stays
        #: O(log S) (see _pad).
        if bucket_policy not in ("pow2", "none"):
            raise ValueError(f"bucket_policy must be pow2 or none, got "
                             f"{bucket_policy!r}")
        self.bucket_policy = bucket_policy
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
        #: lifetime LRU evictions past the budget.
        self.evictions = 0
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
        leaves, one copy of the per-shard counts to the host."""
        if not shards:
            return 0
        fn, arrays = self.prepare_count(idx, c, shards, const_rows=const_rows)
        _fuse.add_fused_steps(_fuse.call_steps(c) + 1)
        # Per-shard int32 popcounts (<= 2^30 each) widened before the sum:
        # immune to int32 overflow across many full shards.
        return int(fn(*arrays).cpu().numpy().astype(np.int64).sum())

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
            sig = self._signature(idx, c, leaves)
            fn = self._compiled(("count",) + sig, sig, "per_shard")
            if const_rows is None:
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
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards), const_rows)
                  for leaf in leaves]
        return fn, arrays

    def _revalidate_plan(self, idx: Index, plan_key: tuple, hit: tuple,
                         shards: tuple):
        """The staleness hook of a prepared plan (reference
        planner.py:294), run only when the index epoch moved since the
        plan's stamp. The JAX planner drops a plan here when a packed
        leaf's row outgrew its representation class, which is baked into
        the program; every leaf of the port is dense until packed
        residency (ROADMAP.md Queue 1 item 4) brings that check, so the
        plan is re-stamped and stands."""
        leaves, fn, seen_epoch = hit
        epoch = idx.epoch.value
        if seen_epoch == epoch:
            return hit
        hit = (leaves, fn, epoch)
        with self._cache_lock:
            if plan_key in self._plan_cache:
                self._plan_cache[plan_key] = hit
        return hit

    def _tree_stack(self, idx: Index, c: Call, shards: list[int],
                    const_rows: list | None = None) -> torch.Tensor:
        """Evaluate a bitmap tree to its stacked [S_pad, W] device tensor."""
        leaves: list[tuple] = []
        sig = self._signature(idx, c, leaves)
        arrays = [self._fetch_leaf(idx, leaf, tuple(shards), const_rows)
                  for leaf in leaves]
        out = self._compiled(("row",) + sig, sig, None)(*arrays)
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
                arr = self._stack_cache.pop(key)[2]
                self._cache_bytes -= arr.numel() * arr.element_size()
            for key in [k for k in self._plan_cache if k[0] == index_name]:
                del self._plan_cache[key]

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
        if name == "Not":
            if len(c.children) != 1:
                raise QueryError("Not() requires a single row input")
            ef = idx.existence_field()
            if ef is None:
                raise QueryError(
                    f"index does not support existence tracking: {idx.name}")
            leaves.append(("row", ef.name, VIEW_STANDARD, 0))
            slot = len(leaves) - 1
            return ("not", slot, self._signature(idx, c.children[0], leaves))
        if name == "Shift":
            # The JAX planner reads the first child and ignores any more
            # (its per-shard path refuses them): kept as it is (ROADMAP.md
            # Queue 3).
            n = c.args.get("n", 0)  # IntArg default, executor.go:1770
            return ("shift", n, self._signature(idx, c.children[0], leaves))
        if name == "__const__":
            # Partial-fusion leaf: a Row computed on the host, uploaded as
            # a stack (Executor._fuse_partial).
            leaves.append(("const", c.args["slot"]))
            return ("leaf", len(leaves) - 1)
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

    def _compiled(self, full_sig: tuple, sig: tuple,
                  reduce: str | None) -> Callable:
        """The program for a signature: its [S_pad, W] leaf inputs ->
        int32 [S_pad] per-shard counts (``reduce="per_shard"``) or the
        [S_pad, W] result plane (``None``). The tree is lowered to one
        op tape over leaf planes at each call (BSI compare and shift
        outputs join as planes): a bare leaf counts with row_counts, a
        2-leaf op with pair_count, anything else with one tree_count
        launch."""
        fn = self._fn_cache.get(full_sig)
        if fn is not None:
            return fn
        if reduce == "per_shard":
            def fn(*args):
                tape = _Tape()
                expr = _lower(sig, args, tape)
                if expr[0] == "p":
                    return kernels.row_counts(tape.leaves[expr[1]])
                op, a, b = expr
                if a[0] == "p" and b[0] == "p":
                    return kernels.pair_count(tape.leaves[a[1]],
                                              tape.leaves[b[1]], op)
                return kernels.tree_count(tape.leaves, _postfix(expr))
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
        ``bsi`` leaf's (exists, sign, [depth, S_pad, W] cube), a ``pred``
        leaf's (lo, hi) halves, a ``const`` leaf's host Row uploaded as a
        stack (not cached: its contents vary per query)."""
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
        unchanged the entry is re-stamped instead of re-uploaded.

        One build per key at a time: a thread that misses while another
        builds the same key waits for it and looks again, so concurrent
        queries on a cold 2 GiB cube share one build and one upload."""
        key = (idx.name, idx.instance_id, field_name, view, tag, shards)
        while True:
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
                building = self._building.get(key)
                if building is None:
                    building = self._building[key] = threading.Event()
                    break
            building.wait()
        # Build outside the lock: row materialization and the upload can
        # be slow.
        try:
            if gens is None:
                gens = self._gens(idx.name, field_name, view, shards)
            arr = build()
            self._insert_stack(key, epoch, gens, arr)
        finally:
            with self._cache_lock:
                del self._building[key]
            building.set()
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
                self.evictions += 1

    def cache_stats(self) -> dict:
        """Locked snapshot of the stack cache's device-memory occupancy,
        for /debug/heap and the runtime gauges."""
        with self._cache_lock:
            return {"bytes": self._cache_bytes,
                    "budget_bytes": self.max_cache_bytes,
                    "entries": len(self._stack_cache),
                    "evictions": self.evictions,
                    "uploads": self.uploads,
                    "upload_bytes": self.upload_bytes,
                    "programs": len(self._fn_cache)}

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


class _Tape:
    """The leaf planes of one lowering and a plane maker over them."""

    def __init__(self):
        self.leaves: list[torch.Tensor] = []
        self._slots: dict[int, int] = {}

    def leaf(self, t: torch.Tensor) -> tuple:
        """``("p", i)`` for plane ``t``; one slot per tensor, so a leaf
        used twice is one kernel input."""
        i = self._slots.get(id(t))
        if i is None:
            i = self._slots[id(t)] = len(self.leaves)
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
        return tape.leaf(args[sig[1]])
    if kind in _PAIR_OPS:
        op = _PAIR_OPS[kind]
        kids = [_lower(k, args, tape) for k in sig[1]]
        acc = kids[0]
        for k in kids[1:]:
            acc = (op, acc, k)
        return acc
    if kind == "not":
        _, slot, child = sig
        return ("andnot", tape.leaf(args[slot]), _lower(child, args, tape))
    if kind == "shift":
        _, n, child = sig
        expr = _lower(child, args, tape)
        if n == 0:
            return expr
        return tape.leaf(kernels.shift_left(tape.plane(expr), n))
    exists, sign, cube = args[sig[1]]
    e, s = tape.leaf(exists), tape.leaf(sign)
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
