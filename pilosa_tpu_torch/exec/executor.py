"""The PQL executor over set and int fields: a recursive call-tree
interpreter with per-shard map functions and a map/reduce spine.

The port's counterpart of pilosa_tpu/exec/executor.py. Reference:
executor.go — dispatch (:293-338), Sum/Min/Max (:406-520), bitmap calls
(:659-676, :1441), BSI conditions (:1536), Count, TopN two-pass
(:857-999), writes (:2067), mapReduce (:2455).

As in the JAX package, TopN is exact: per-shard batched intersection
counts on the device (``pair_count`` over a row stack) instead of the
reference's threshold-gated rank-cache walk. With a ``Planner`` attached,
plannable bitmap trees (BSI conditions included), ``Count``, ``TopN`` and
``Sum``/``Min``/``Max`` run over all shards at once as ``[S_pad, W]``
stacks; without one, shard by shard.

Calls of later slices raise ``NotPortedError`` naming the slice in
ROADMAP.md: time views (``from``/``to``), ``MinRow``/``MaxRow``,
``Not``/``Shift``, ``Rows``/``GroupBy``/``Distinct``, attrs, ``Options``,
keys. There is no result cache, batcher, coalescer,
prefetcher or ``execute_async``: every query runs on the device and ends
in a synchronising copy of its counts or columns to the host.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core.field import FIELD_TYPE_INT, op_name
from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, row_id_arg
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD, view_bsi_name
from pilosa_tpu_torch.errors import (
    SLICE_EXECUTOR,
    SLICE_FIELDS,
    SLICE_KEYS,
    BSIGroupNotFoundError,
    FieldNotFoundError,
    IndexNotFoundError,
    NotPortedError,
    QueryError,
)
from pilosa_tpu_torch.exec.result import Pair, ValCount, merge_pairs, sort_pairs
from pilosa_tpu_torch.pql import BETWEEN, GT, GTE, LT, LTE, NEQ, Call, Condition, Query, parse

#: reference defaultMinThreshold (executor.go:90).
DEFAULT_MIN_THRESHOLD = 1

_NARY_CALLS = {"Intersect": "intersect", "Union": "union",
               "Xor": "xor", "Difference": "difference"}

#: calls of the JAX executor that later slices port, by ROADMAP.md slice.
_NOT_PORTED = {
    "MinRow": SLICE_FIELDS, "MaxRow": SLICE_FIELDS, "GroupBy": SLICE_FIELDS,
    "Not": SLICE_EXECUTOR, "Shift": SLICE_EXECUTOR,
    "ClearRow": SLICE_EXECUTOR, "Store": SLICE_EXECUTOR,
    "Rows": SLICE_EXECUTOR, "Options": SLICE_EXECUTOR,
    "SetRowAttrs": SLICE_EXECUTOR, "SetColumnAttrs": SLICE_EXECUTOR,
    "Distinct": SLICE_KEYS, "SimilarTopN": SLICE_KEYS,
}

#: TopN arguments of later slices (attrs, tanimoto similarity).
_TOPN_NOT_PORTED = ("attrName", "attrValues", "tanimotoThreshold")


class Executor:
    """Reference executor (executor.go:72). ``planner`` (a
    ``pilosa_tpu_torch.parallel.Planner``) runs plannable calls over all
    shards at once; without one every call runs shard by shard."""

    def __init__(self, holder: Holder, planner=None):
        self.holder = holder
        self.planner = planner

    def _planner_for(self, c: Call):
        if self.planner is None:
            return None
        return self.planner if self.planner.supports(c) else None

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def execute(self, index_name: str, query: Query | str,
                shards: Iterable[int] | None = None) -> list[Any]:
        """Reference executor.Execute (executor.go:113): one result per
        top-level call."""
        if isinstance(query, str):
            query = parse(query)
        idx = self.holder.index(index_name)
        if idx is None:
            raise IndexNotFoundError(f"index not found: {index_name!r}")
        needs_shards = any(c.name not in ("Set", "Clear") for c in query.calls)
        if shards is None and needs_shards:
            shards = sorted(idx.available_shards())
        shards = list(shards) if shards is not None else []
        return [self._execute_call(idx, call.clone(), shards)
                for call in query.calls]

    def _execute_call(self, idx: Index, c: Call, shards: list[int]) -> Any:
        name = c.name
        if name == "Count":
            return self._execute_count(idx, c, shards)
        if name == "Set":
            return self._execute_set(idx, c)
        if name == "Clear":
            return self._execute_clear_bit(idx, c)
        if name == "TopN":
            return self._execute_top_n(idx, c, shards)
        if name == "Sum":
            return self._execute_sum(idx, c, shards)
        if name in ("Min", "Max"):
            return self._execute_min_max(idx, c, shards, is_min=name == "Min")
        if name in ("Row", "Range") or name in _NARY_CALLS:
            return self._execute_bitmap_call(idx, c, shards)
        if name in _NOT_PORTED:
            raise NotPortedError(f"{name}()", _NOT_PORTED[name])
        raise QueryError(f"unknown call: {name}")

    # ------------------------------------------------------------------
    # map/reduce spine (reference mapReduce executor.go:2455)
    # ------------------------------------------------------------------

    def map_reduce(self, shards: list[int], map_fn: Callable[[int], Any],
                   reduce_fn: Callable[[Any, Any], Any],
                   local_batch_fn: Callable[[list[int]], Any] | None = None) -> Any:
        """Single-node spine: ``local_batch_fn`` (the planner) takes the
        whole shard batch at once; otherwise map_fn runs per shard and
        reduce_fn folds the results."""
        if local_batch_fn is not None:
            return local_batch_fn(list(shards))
        acc = None
        for shard in shards:
            acc = reduce_fn(acc, map_fn(shard))
        return acc

    # ------------------------------------------------------------------
    # bitmap calls
    # ------------------------------------------------------------------

    def _execute_bitmap_call(self, idx: Index, c: Call, shards: list[int]) -> Row:
        planner = self._planner_for(c)

        def map_fn(shard):
            return self._bitmap_call_shard(idx, c, shard)

        def reduce_fn(prev, v):
            return v if prev is None else prev.union(v)  # disjoint shards

        local_batch = None
        if planner is not None:
            local_batch = lambda shs: planner.execute_bitmap(idx, c, shs)
        return self.map_reduce(shards, map_fn, reduce_fn,
                               local_batch_fn=local_batch) or Row()

    def _bitmap_call_shard(self, idx: Index, c: Call, shard: int) -> Row:
        """Reference executeBitmapCallShard (executor.go:659)."""
        name = c.name
        if name in ("Row", "Range"):
            return self._row_shard(idx, c, shard)
        if name in _NARY_CALLS:
            return self._nary_shard(idx, c, shard, _NARY_CALLS[name])
        if name in _NOT_PORTED:
            raise NotPortedError(f"{name}()", _NOT_PORTED[name])
        raise QueryError(f"unknown call: {name}")

    def _nary_shard(self, idx: Index, c: Call, shard: int, op: str) -> Row:
        if not c.children:
            raise QueryError(f"empty {c.name} query is currently not supported")
        rows = [self._bitmap_call_shard(idx, ch, shard) for ch in c.children]
        acc = rows[0]
        for r in rows[1:]:
            acc = getattr(acc, op)(r)
        return acc

    def _row_shard(self, idx: Index, c: Call, shard: int) -> Row:
        """Reference executeRowShard (executor.go:1441): the standard view,
        or a BSI condition."""
        if c.has_condition_arg():
            return self._row_bsi_shard(idx, c, shard)
        if c.name == "Range" or "from" in c.args or "to" in c.args:
            raise NotPortedError(f"{c.name}() over time views", SLICE_FIELDS)
        field_name = c.field_arg()
        if idx.field(field_name) is None:
            raise FieldNotFoundError(f"field not found: {field_name!r}")
        row_id = row_id_arg(c, field_name)
        frag = self.holder.fragment(idx.name, field_name, VIEW_STANDARD, shard)
        return frag.row(row_id) if frag else Row()

    def _row_bsi_shard(self, idx: Index, c: Call, shard: int) -> Row:
        """Reference executeRowBSIGroupShard (executor.go:1536)."""
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
        frag = self.holder.fragment(idx.name, field_name,
                                    view_bsi_name(field_name), shard)

        if cond.op == NEQ and cond.value is None:  # `!= null`: not-null
            return frag.not_null() if frag else Row()

        if cond.op == BETWEEN:
            predicates = cond.int_slice_value()
            if len(predicates) != 2:
                raise QueryError(
                    "Row(): BETWEEN condition requires exactly two integer values")
            lo, hi, out_of_range = bsig.base_value_between(*predicates)
            if out_of_range or frag is None:
                return Row()
            if predicates[0] <= bsig.min and predicates[1] >= bsig.max:
                return frag.not_null()
            return frag.range_between(bsig.bit_depth, lo, hi)

        value = cond.value
        if not isinstance(value, int) or isinstance(value, bool):
            raise QueryError("Row(): conditions only support integer values")
        base_value, out_of_range = bsig.base_value(cond.op, value)
        if out_of_range and cond.op != NEQ:
            return Row()
        if frag is None:
            return Row()
        # Fully-encompassing LT/GT, or a NEQ out of range: every value
        # (executor.go:1648-1652).
        if ((cond.op == LT and value > bsig.max)
                or (cond.op == LTE and value >= bsig.max)
                or (cond.op == GT and value < bsig.min)
                or (cond.op == GTE and value <= bsig.min)
                or out_of_range):
            return frag.not_null()
        return frag.range_op(op_name(cond.op), bsig.bit_depth, base_value)

    # ------------------------------------------------------------------
    # Sum / Min / Max (reference executor.go:406-520)
    # ------------------------------------------------------------------

    def _agg_filter(self, idx: Index, c: Call, shard: int) -> Row | None:
        if len(c.children) > 1:
            raise QueryError(f"{c.name}() only accepts a single bitmap input")
        if len(c.children) == 1:
            return self._bitmap_call_shard(idx, c.children[0], shard)
        return None

    def _bsi_fragment(self, idx: Index, field_name: str, shard: int):
        f = idx.field(field_name)
        if f is None or f.bsi_group is None:
            return None, None
        frag = self.holder.fragment(idx.name, field_name,
                                    view_bsi_name(field_name), shard)
        return f, frag

    def _agg_field(self, c: Call) -> str:
        field_name, ok = c.string_arg("field")
        if not ok:
            raise QueryError(f"{c.name}(): field required")
        return field_name

    def _execute_sum(self, idx: Index, c: Call, shards: list[int]) -> ValCount:
        field_name = self._agg_field(c)

        def map_fn(shard):
            f, frag = self._bsi_fragment(idx, field_name, shard)
            if frag is None:
                return ValCount()
            filt = self._agg_filter(idx, c, shard)
            s, cnt = frag.sum(filt, f.bsi_group.bit_depth)
            return ValCount(s + cnt * f.bsi_group.base, cnt)

        local_batch = None
        if self.planner is not None and self.planner.supports_aggregate(idx, c):
            base = idx.field(field_name).bsi_group.base

            def local_batch(shs):
                s, cnt = self.planner.execute_sum(idx, c, list(shs))
                return ValCount(s + cnt * base, cnt)

        result = self.map_reduce(shards, map_fn,
                                 lambda p, v: v if p is None else p.add(v),
                                 local_batch_fn=local_batch) or ValCount()
        return ValCount() if result.count == 0 else result

    def _execute_min_max(self, idx: Index, c: Call, shards: list[int],
                         is_min: bool) -> ValCount:
        field_name = self._agg_field(c)

        def map_fn(shard):
            f, frag = self._bsi_fragment(idx, field_name, shard)
            if frag is None:
                return ValCount()
            filt = self._agg_filter(idx, c, shard)
            if is_min:
                v, cnt = frag.min(filt, f.bsi_group.bit_depth)
            else:
                v, cnt = frag.max(filt, f.bsi_group.bit_depth)
            if cnt == 0:
                return ValCount()
            return ValCount(v + f.bsi_group.base, cnt)

        def reduce_fn(p, v):
            if p is None:
                return v
            return p.smaller(v) if is_min else p.larger(v)

        local_batch = None
        if self.planner is not None and self.planner.supports_aggregate(idx, c):
            base = idx.field(field_name).bsi_group.base

            def local_batch(shs):
                v, cnt = self.planner.execute_min_max(idx, c, list(shs), is_min)
                return ValCount(v + base, cnt) if cnt else ValCount()

        result = self.map_reduce(shards, map_fn, reduce_fn,
                                 local_batch_fn=local_batch) or ValCount()
        return ValCount() if result.count == 0 else result

    # ------------------------------------------------------------------
    # Count
    # ------------------------------------------------------------------

    def _execute_count(self, idx: Index, c: Call, shards: list[int]) -> int:
        if len(c.children) != 1:
            raise QueryError("Count() requires a single bitmap input")
        child = c.children[0]
        if child.name in _NOT_PORTED:
            raise NotPortedError(f"Count({child.name}())", _NOT_PORTED[child.name])
        planner = self._planner_for(child)

        def map_fn(shard):
            return self._bitmap_call_shard(idx, child, shard).count()

        local_batch = None
        if planner is not None:
            local_batch = lambda shs: planner.execute_count(idx, child, shs)
        return self.map_reduce(shards, map_fn, lambda p, v: (p or 0) + v,
                               local_batch_fn=local_batch) or 0

    # ------------------------------------------------------------------
    # TopN (reference executor.go:857 two-pass)
    # ------------------------------------------------------------------

    def _execute_top_n(self, idx: Index, c: Call, shards: list[int]) -> list[Pair]:
        for arg in _TOPN_NOT_PORTED:
            if arg in c.args:
                raise NotPortedError(f"TopN({arg}=...)", SLICE_EXECUTOR)
        ids_arg, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")

        pairs = self._top_n_shards(idx, c, shards)
        if not pairs or ids_arg:
            return pairs

        # Pass 2: exact counts for the merged candidate ids.
        other = c.clone()
        other.args["ids"] = sorted(p.id for p in pairs)
        trimmed = self._top_n_shards(idx, other, shards)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return trimmed

    def _top_n_shards(self, idx: Index, c: Call, shards: list[int]) -> list[Pair]:
        def reduce_fn(p, v):
            return merge_pairs(p or [], v)

        merged = self.map_reduce(
            shards, lambda shard: self._top_n_shard(idx, c, shard), reduce_fn,
            local_batch_fn=self._topn_batch_fn(idx, c)) or []
        return sort_pairs(merged)

    def _topn_args(self, c: Call) -> tuple[int, list[int] | None, int]:
        """(n, explicit row ids or None, threshold) of a TopN call: explicit
        ids disable truncation (fragment.go:1575), threshold 0 means the
        default."""
        row_ids, has_ids = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")
        if has_ids:
            n = 0
        min_threshold, _ = c.uint_arg("threshold")
        if min_threshold == 0:
            min_threshold = DEFAULT_MIN_THRESHOLD
        return n, ([int(r) for r in row_ids] if has_ids else None), min_threshold

    def _topn_batch_fn(self, idx: Index, c: Call):
        """Planner TopN: one sparse-aware device sweep for ALL shards
        (planner.execute_topn_counts) instead of a per-shard loop,
        preserving per-shard threshold/truncate semantics. None when the
        call needs the per-shard path."""
        if self.planner is None:
            return None
        field_name = c.args.get("_field")
        f = idx.field(field_name) if field_name else None
        if f is None or len(c.children) > 1:
            return None
        filter_call = c.children[0] if c.children else None
        if filter_call is not None and not self.planner.supports(filter_call):
            return None
        n, row_ids, min_threshold = self._topn_args(c)

        def batch(shs: list[int]) -> list[Pair]:
            # cache_type 'none' errors only if a fragment exists, exactly
            # like the per-shard path.
            if f.options.cache_type == "none":
                if any(self.holder.fragment(idx.name, field_name,
                                            VIEW_STANDARD, s) is not None
                       for s in shs):
                    raise QueryError(
                        f'cannot compute TopN(), field has no cache: '
                        f'"{field_name}"')
                return []
            per_shard = self.planner.execute_topn_counts(
                idx, field_name, VIEW_STANDARD, list(shs), filter_call,
                row_ids=row_ids)
            acc: list[Pair] = []
            for shard in sorted(per_shard):
                # Arrives sorted (count desc, id asc); the threshold is an
                # order-preserving mask, then truncate.
                ids, counts = per_shard[shard]
                keep = counts >= min_threshold
                ids, counts = ids[keep], counts[keep]
                if n:
                    ids, counts = ids[:n], counts[:n]
                acc = merge_pairs(acc, [Pair(id=rid, count=cnt) for rid, cnt
                                        in zip(ids.tolist(), counts.tolist())])
            return acc

        return batch

    def _top_n_shard(self, idx: Index, c: Call, shard: int) -> list[Pair]:
        """Exact per-shard TopN: device-batched intersection counts over
        the row stack (replaces the reference's rank-cache walk,
        fragment.go:1570)."""
        field_name = c.args.get("_field")
        src: Row | None = None
        if len(c.children) == 1:
            src = self._bitmap_call_shard(idx, c.children[0], shard)
        elif len(c.children) > 1:
            raise QueryError("TopN() can only have one input bitmap")

        frag = self.holder.fragment(idx.name, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return []
        if frag.cache_type == "none":
            raise QueryError(f'cannot compute TopN(), field has no cache: "{field_name}"')
        n, row_ids, min_threshold = self._topn_args(c)
        pairs = [Pair(id=rid, count=cnt)
                 for rid, cnt in frag.top(n=0, src=src, row_ids=row_ids)
                 if cnt >= min_threshold]
        return pairs[:n] if n else pairs

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def _write_target(self, idx: Index, c: Call, what: str):
        """(field, column id) of a Set()/Clear() call."""
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise QueryError(f"{what}() column argument 'col' required")
        field_name = c.field_arg()
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(f"field not found: {field_name!r}")
        if "_timestamp" in c.args:
            raise NotPortedError(f"{what}() with a timestamp", SLICE_FIELDS)
        return f, col_id

    def _execute_set(self, idx: Index, c: Call) -> bool:
        """Reference executeSet (executor.go:2067): a bit, or an int
        field's value."""
        f, col_id = self._write_target(idx, c, "Set")
        idx.add_existence([col_id])
        if f.field_type == FIELD_TYPE_INT:
            value, ok = c.int_arg(f.name)
            if not ok:
                raise QueryError("Set() row argument 'row' required")
            return f.set_value(col_id, value)
        return f.set_bit(row_id_arg(c, f.name), col_id)

    def _execute_clear_bit(self, idx: Index, c: Call) -> bool:
        """Clearing an int field's value clears its exists bit."""
        f, col_id = self._write_target(idx, c, "Clear")
        row_id = row_id_arg(c, f.name)
        if f.field_type != FIELD_TYPE_INT:
            return f.clear_bit(row_id, col_id)
        v = f.bsi_view()
        frag = v.fragment(col_id // SHARD_WIDTH) if v is not None else None
        return frag.clear_bit(BSI_EXISTS_BIT, col_id) if frag is not None else False

