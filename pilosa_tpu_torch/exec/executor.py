"""The PQL executor: a recursive call-tree interpreter with per-shard map
functions, a map/reduce spine and a result cache.

The port's counterpart of pilosa_tpu/exec/executor.py. Reference:
executor.go — dispatch (:293-338), Sum/Min/Max (:406-520), MinRow/MaxRow,
bitmap calls (:659-676, :1441) over the standard view or the time views a
``from``/``to`` window covers (:1490-1528), BSI conditions (:1536), Count,
TopN two-pass (:857-999), GroupBy (:1069-1272, iterator :3058-3231), Rows
(:1272-1441), writes (:1823-2330), Options (:360), mapReduce (:2455).

As in the JAX package, TopN is exact: per-shard batched intersection
counts on the device (``pair_count`` over a row stack) instead of the
reference's threshold-gated rank-cache walk. With a ``Planner`` attached,
plannable bitmap trees (``Not``, ``Shift`` and BSI conditions included),
``Count``, ``TopN``, ``Sum``/``Min``/``Max`` and ``Store``'s source row run
over all shards at once as ``[S_pad, W]`` stacks; a tree with an
unplannable subtree keeps its plannable parts on the device
(``_fuse_partial``); without a planner, everything runs shard by shard.
A planner GroupBy over plain ``Rows`` children runs its whole lattice in
one ``group_count`` launch; cursors (``previous``), ``limit``/``column``
children, time windows and lattices past the planner's caps take the
per-shard walk, as in the JAX executor.

Read-only queries given as text are answered from the result cache
(``pilosa_tpu_torch.cache``) while the epochs of the index's schema and of
the shards they read stand still; a write misses, and so does a schema
change. ``cache=False`` (``?noCache=true``) bypasses it.

``Count(Distinct(...))`` estimates distinct values of an int field from
HyperLogLog registers (``pilosa_tpu_torch.sketch``), with an exact leg
under the threshold, and ``SimilarTopN`` ranks every row of a set field by
its overlap with a filter; with a planner each is one program over all
shards (``hll_expand``/``hll_reduce`` and ``similar_count``). String keys
in a query translate to ids before it runs (``_translate_call``: the
device key plane first for a large batch, then one host pass) and ids back
to keys in its results (``_translate_result``), as in the JAX executor.

``execute_async`` is the JAX executor's non-blocking entry: a single
plannable ``Count``, ``Sum``, ``Min`` or ``Max`` is launched at once (or
joins a same-plan wave in the planner's coalescer) and its future resolves
when the planner's batcher brings the counts back, so one thread keeps
many queries in flight; a repeated query text rides the prepared-query
table (``_prepared``) while its index's instance, schema epoch and data
epoch stand still. Everything else runs synchronously before its future
resolves.

On a cluster (``cluster=``, a ``cluster.Cluster``) ``map_reduce`` hands
the shard batch to ``Cluster.map_reduce``, which runs this node's shards
here and sends the rest to their owners as remote legs; a remote leg
(``ExecOptions(remote=True)``) returns raw partials -- a Count's int, a
TopN's first-pass pairs, a sketch's registers -- for the coordinator to
fold, and bitmap legs fold on the device (``exec/device_reduce``). Writes
go to every replica through ``Cluster.write_fanout``, attrs to every node
through ``broadcast_call``. Keys on a cluster resolve through
``translator`` (``cluster.translate_sync.ClusterKeyTranslator``): the
coordinator is the one id authority, and a replica serves what it has
synced before it asks the coordinator for the rest.

The active deadline (``qos.deadline``, set by the HTTP edge) is checked
between the query's calls and before each shard or shard batch, as in the
JAX executor, so an expired query stops at the next step and never returns
a partial result.
"""

from __future__ import annotations

import datetime as dt
import math
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, replace
from typing import Any, Callable, Iterable

import numpy as np

from pilosa_tpu_torch.cache.remote import RemoteEpochTable
from pilosa_tpu_torch.cache.tenant import current_tenant
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core.field import FIELD_TYPE_INT, FIELD_TYPE_TIME, op_name
from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, row_id_arg
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD, view_bsi_name
from pilosa_tpu_torch.errors import (
    BSIGroupNotFoundError,
    FieldNotFoundError,
    IndexNotFoundError,
    QueryError,
)
from pilosa_tpu_torch import sketch as _sketch
from pilosa_tpu_torch.config import WORDS_PER_SHARD
from pilosa_tpu_torch.exec import fuse as _fuse
from pilosa_tpu_torch.exec.keyplane import KeyPlaneCache
from pilosa_tpu_torch.exec.result import (
    FieldRow,
    GroupCount,
    Pair,
    RowIdentifiers,
    ValCount,
    merge_group_counts,
    merge_pairs,
    merge_row_ids,
    sort_pairs,
)
from pilosa_tpu_torch.obs import NopStats, start_span
from pilosa_tpu_torch.obs import profile as _profile
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.pql import BETWEEN, GT, GTE, LT, LTE, NEQ, Call, Condition, Query, parse
from pilosa_tpu_torch.pql import ast as pql_ast
from pilosa_tpu_torch.qos.deadline import check_current as check_deadline
from pilosa_tpu_torch.sketch import hll as _hll
from pilosa_tpu_torch.sketch import store as sketch_store
from pilosa_tpu_torch.storage.quarantine import ShardCorruptError

_MAXINT = (1 << 63) - 1

#: reference defaultMinThreshold (executor.go:90).
DEFAULT_MIN_THRESHOLD = 1

_NARY_CALLS = {"Intersect": "intersect", "Union": "union",
               "Xor": "xor", "Difference": "difference"}

_BITMAP_CALLS = frozenset(
    {"Row", "Range", "Difference", "Intersect", "Union", "Xor", "Not", "Shift"})



@dataclass
class ExecOptions:
    """Reference execOptions (executor.go:62). ``remote`` marks a cluster
    leg: it returns raw partials and neither translates keys nor fans out
    again."""

    remote: bool = False
    exclude_row_attrs: bool = False
    exclude_columns: bool = False
    column_attrs: bool = False


class Executor:
    """Reference executor (executor.go:72). ``planner`` (a
    ``pilosa_tpu_torch.parallel.Planner``) runs plannable calls over all
    shards at once; without one every call runs shard by shard. ``stats``
    receives the node's per-class service times (the HTTP edge records
    them through ``executor.stats``). ``result_cache`` takes a shared
    ``ResultCache`` (ServerNode passes its byte-bounded one), True for a
    private default, False/0 to disable."""

    #: bounded size of the query-string -> parsed Query cache.
    PARSE_CACHE_SIZE = 512
    #: prepared Count plans kept for execute_async (LRU).
    PREPARED_CACHE_SIZE = 256

    def __init__(self, holder: Holder, planner=None, stats=None,
                 result_cache=True, cluster=None):
        self.holder = holder
        self.planner = planner
        #: cluster hooks (pilosa_tpu_torch.cluster); None = standalone node.
        self.cluster = cluster
        #: cluster key-allocation hook, (index, field or None, keys) -> ids
        #: (cluster.translate_sync.ClusterKeyTranslator); None allocates in
        #: the local stores.
        self.translator = None
        #: device key planes (exec/keyplane): read-through forward
        #: translation for large key batches; the tensors live in the
        #: planner's budgeted stack cache when a planner is attached.
        self.keyplanes = KeyPlaneCache(planner, device=holder.device)
        self.stats = stats or NopStats()
        if result_cache is True:
            from pilosa_tpu_torch.cache.result_cache import ResultCache
            self.result_cache = ResultCache(stats=self.stats)
        elif not result_cache:
            self.result_cache = None
        else:
            self.result_cache = result_cache
        #: (index, shard) -> (node, epoch) observed from remote legs and
        #: index-dirty broadcasts: the cross-node half of cache stamps.
        self.remote_epochs = RemoteEpochTable()
        self._cache_lock = threading.Lock()
        #: query-string -> parsed Query; parsed trees are shared across
        #: threads, and every consumer clones before mutating.
        self._parse_cache: "OrderedDict[str, Query]" = OrderedDict()
        #: (index, query text) -> (instance_id, schema_epoch, data epoch,
        #: shards, program, leaf tensors, result-cache key, post, prepared
        #: from shards=None, fused steps): execute_async's prepared-query
        #: path. It caches the program, not the answer -- the device runs
        #: every query; the epochs gate staleness, and the tensors are
        #: references into the planner's budgeted stack cache.
        self._prepared: "OrderedDict[tuple, tuple]" = OrderedDict()

    def _planner_for(self, c: Call):
        if self.planner is None:
            return None
        return self.planner if self.planner.supports(c) else None

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def execute(self, index_name: str, query: Query | str,
                shards: Iterable[int] | None = None,
                opt: ExecOptions | None = None,
                cache: bool = True) -> list[Any]:
        """Reference executor.Execute (executor.go:113): one result per
        top-level call. ``cache=False`` bypasses the result cache (reads
        and writes of it) for this call."""
        raw = query if isinstance(query, str) else None
        if raw is not None:
            prof = _profile.current()
            t0 = time.perf_counter()
            query = self._parse_cached(raw)
            if prof is not None:
                prof.add_ms("parseMs", (time.perf_counter() - t0) * 1e3)
        opt = opt or ExecOptions()
        if not opt.remote:
            _fuse.reset_fused_steps()
        idx = self.holder.index(index_name)
        if idx is None:
            raise IndexNotFoundError(f"index not found: {index_name!r}")
        needs_shards = any(c.name not in ("Set", "Clear", "SetRowAttrs",
                                          "SetColumnAttrs")
                           for c in query.calls)
        if shards is None and needs_shards:
            shards = sorted(idx.available_shards())
        shards = list(shards) if shards is not None else []

        cacheable = (cache and self.result_cache is not None
                     and raw is not None and not query.has_writes())
        if cacheable:
            key = self._cache_key(idx, query, shards, opt)
            tenant = current_tenant()
            # Epochs read BEFORE execution: a write landing mid-query
            # leaves the stored stamp stale, so the entry dies on its
            # first lookup instead of serving pre-write state as fresh.
            stamp = self._exec_stamp(idx, shards)
            prof = _profile.current()
            t0 = time.perf_counter()
            hit = self.result_cache.get(tenant, key, stamp)
            if prof is not None:
                prof.add_ms("cacheLookupMs", (time.perf_counter() - t0) * 1e3)
                prof.cache_hit = hit is not None
            if hit is not None:
                return hit

        results = []
        for call in query.calls:
            # Between plan steps: an expired deadline stops the query
            # before it spends more device time.
            check_deadline()
            # Keys translate on the coordinator only: a remote leg already
            # carries ids and returns raw partials (executor.go:113-160);
            # the parse cache shares trees, so it runs on a clone.
            call = call.clone() if opt.remote else self._translate_call(idx, call)
            results.append(self._execute_call(idx, call, shards, opt))
        if not opt.remote:
            results = [self._translate_result(idx, c, r)
                       for c, r in zip(query.calls, results)]
        if cacheable:
            # Remote rows re-read AFTER the legs: each leg reported the
            # vector it read before executing, so the stored stamp is as
            # conservative as the pre-execution local one.
            self.result_cache.put(tenant, key, stamp[:2] + (
                self.remote_epochs.rows_for(idx.name, shards),), results)
        return results

    def execute_async(self, index_name: str, query: Query | str,
                      shards: Iterable[int] | None = None,
                      opt: ExecOptions | None = None,
                      cache: bool = True) -> Future:
        """Non-blocking submission; resolves to ``execute(...)``'s list
        (reference execute_async, executor.py:273).

        A single plannable ``Count(...)``, ``Sum``, ``Min`` or ``Max`` is
        launched now and resolves when its transfer lands, so ONE thread
        can keep many queries in flight. Anything else (writes, host-side
        calls) executes synchronously before the future resolves."""
        fut: Future = Future()
        opt = opt or ExecOptions()
        _fuse.reset_fused_steps()
        raw = query if isinstance(query, str) else None
        if shards is not None and not isinstance(shards, list):
            shards = list(shards)  # one materialization of an iterator
        # A cluster's queries fan out through map_reduce: the prepared and
        # fast dispatch paths are a standalone node's.
        local = self.cluster is None and not opt.remote
        if local and self.planner is not None and raw is not None:
            # Prepared-query path: a repeated (index, text) whose epochs
            # stand still re-dispatches its program and leaves directly,
            # with no parse, plan-key hash or leaf fetch.
            e = self._prepared.get((index_name, raw))
            if e is not None:
                idx = self.holder.index(index_name)
                if (idx is None or e[0] != idx.instance_id
                        or e[1] != idx.schema_epoch.value
                        or e[2] != idx.epoch.value):
                    # Drop the tensor references the moment the entry
                    # goes stale.
                    with self._cache_lock:
                        if self._prepared.get((index_name, raw)) is e:
                            del self._prepared[(index_name, raw)]
                    e = None
                if e is not None and ((shards is None and e[8])
                                      or (shards is not None and shards == e[3])):
                    _, _, _, pshards, fn, arrays, rkey, post, _, steps = e
                    with self._cache_lock:
                        if (index_name, raw) in self._prepared:
                            self._prepared.move_to_end((index_name, raw))
                    try:
                        self._check_quarantine(idx, pshards)
                        if cache and self.result_cache is not None:
                            # Stamp and tenant captured now: the store runs
                            # on the batcher's thread, which has neither
                            # this request's context nor its epochs.
                            stamp = self._exec_stamp(idx, pshards)
                            tenant = current_tenant()
                            hit = self.result_cache.get(tenant, rkey, stamp)
                            if hit is not None:
                                fut.set_result(hit)
                                return fut

                            def post(host, _k=rkey, _s=stamp, _t=tenant, _p=post):
                                results = _p(host)
                                self.result_cache.put(_t, _k, _s, results)
                                return results
                        _fuse.add_fused_steps(steps)
                        return self.planner.dispatch_count(fn, arrays, post)
                    except Exception as exc:
                        fut.set_exception(exc)
                        return fut
        fast = None
        if local and self.planner is not None:
            try:
                q = self._parse_cached(raw) if raw is not None else query
            except Exception as exc:
                fut.set_exception(exc)
                return fut
            if len(q.calls) == 1:
                call0 = q.calls[0]
                idx = self.holder.index(index_name)
                if idx is None:
                    pass
                elif (call0.name == "Count" and len(call0.children) == 1
                        and self.planner.supports(call0.children[0])):
                    fast = (q, idx)
                elif (call0.name in ("Sum", "Min", "Max")
                      and self.planner.supports_aggregate(idx, call0)):
                    fast = (q, idx)
        if fast is None:
            try:
                fut.set_result(self.execute(index_name, query, shards, opt,
                                            cache=cache))
            except Exception as exc:
                fut.set_exception(exc)
            return fut

        q, idx = fast
        try:
            shards_given = shards is not None
            shards = (sorted(idx.available_shards()) if shards is None
                      else list(shards))
            self._check_quarantine(idx, shards)
            epoch = idx.epoch.value
            cacheable = cache and self.result_cache is not None and raw is not None
            key = self._cache_key(idx, q, shards, opt) if raw is not None else None
            stamp = self._exec_stamp(idx, shards) if cacheable else None
            tenant = current_tenant()
            if cacheable:
                hit = self.result_cache.get(tenant, key, stamp)
                if hit is not None:
                    fut.set_result(hit)
                    return fut
            check_deadline()
            call = self._translate_call(idx, q.calls[0])  # clones
            finish = lambda v: [v]  # noqa: E731  (Count: resolve to [int])
            if call.name in ("Sum", "Min", "Max"):
                base = idx.field(self._agg_field(call)).bsi_group.base
                name = call.name

                def finish(pair, _b=base, _n=name):  # noqa: F811
                    total, cnt = pair
                    if cnt == 0:
                        return [ValCount()]
                    if _n == "Sum":
                        return [ValCount(total + cnt * _b, cnt)]
                    return [ValCount(total + _b, cnt)]

                if name == "Sum":
                    inner = self.planner.dispatch_sum(idx, call, shards)
                else:
                    inner = self.planner.dispatch_min_max(idx, call, shards,
                                                          name == "Min")
            elif shards:
                fn, arrays = self.planner.prepare_count(idx, call.children[0],
                                                        shards)
                steps = _fuse.call_steps(call.children[0]) + 1
                if raw is not None:
                    sum_host = self.planner._sum_host
                    with self._cache_lock:
                        # `shards` is our own copy. The flag says whether it
                        # was the full available set (shards=None): only
                        # such an entry answers a later shards=None query;
                        # a subset program never answers a full one.
                        self._prepared[(index_name, raw)] = (
                            idx.instance_id, idx.schema_epoch.value, epoch,
                            shards, fn, arrays, key,
                            lambda host, _s=sum_host: [_s(host)],
                            not shards_given, steps)
                        while len(self._prepared) > self.PREPARED_CACHE_SIZE:
                            self._prepared.popitem(last=False)
                _fuse.add_fused_steps(steps)
                inner = self.planner.dispatch_count(fn, arrays)
            else:
                inner = self.planner.execute_count_async(idx, call.children[0],
                                                         shards)
        except Exception as exc:
            fut.set_exception(exc)
            return fut

        def _done(f):
            try:
                results = finish(f.result())
            except Exception as exc:
                fut.set_exception(exc)
                return
            if cacheable:
                self.result_cache.put(tenant, key, stamp, results)
            fut.set_result(results)

        inner.add_done_callback(_done)
        return fut

    def _check_quarantine(self, idx: Index, shards: list[int]) -> None:
        """Refuse a shard whose local data the store quarantined
        (``ShardCorruptError``), never serving it as zeros."""
        q = getattr(self.holder, "quarantine", None)
        if q is not None and len(q):
            blocked = q.blocked_shards(idx.name)
            if blocked and any(s in blocked for s in shards):
                raise ShardCorruptError()

    def _cache_key(self, idx: Index, query: Query, shards: list[int],
                   opt: ExecOptions) -> tuple:
        from pilosa_tpu_torch.cache.signature import cache_key
        return cache_key(idx, query, shards, opt)

    def _exec_stamp(self, idx: Index, shards: list[int]) -> tuple:
        """The freshness stamp of a cached result: the index's schema
        epoch, the newest mutation among the plan's shards, and the epochs
        remote legs and peers reported for them."""
        return (idx.schema_epoch.value, idx.epoch.max_shard_epoch(shards),
                self.remote_epochs.rows_for(idx.name, shards))

    def _parse_cached(self, raw: str) -> Query:
        with self._cache_lock:
            q = self._parse_cache.get(raw)
            if q is not None:
                self._parse_cache.move_to_end(raw)
                return q
        q = parse(raw)
        with self._cache_lock:
            self._parse_cache[raw] = q
            while len(self._parse_cache) > self.PARSE_CACHE_SIZE:
                self._parse_cache.popitem(last=False)
        return q

    # ------------------------------------------------------------------
    # dispatch (reference executor.go:293-338)
    # ------------------------------------------------------------------

    def _execute_call(self, idx: Index, c: Call, shards: list[int],
                      opt: ExecOptions) -> Any:
        # One span a call (the JAX executor's): with an exporter behind
        # the tracer, a query's spans on every node it touched share its
        # trace id.
        with start_span(f"Executor.execute{c.name}") as span:
            before = _fuse.fused_steps()
            try:
                return self._execute_call_inner(idx, c, shards, opt)
            finally:
                span.set_tag("exec.fusedSteps", _fuse.fused_steps() - before)

    def _execute_call_inner(self, idx: Index, c: Call, shards: list[int],
                            opt: ExecOptions) -> Any:
        name = c.name
        if name == "Count":
            return self._execute_count(idx, c, shards, opt)
        if name == "Set":
            return self._execute_set(idx, c, opt)
        if name == "Clear":
            return self._execute_clear_bit(idx, c, opt)
        if name == "ClearRow":
            return self._execute_clear_row(idx, c, shards, opt)
        if name == "Store":
            return self._execute_store(idx, c, shards, opt)
        if name == "SetRowAttrs":
            self._execute_set_row_attrs(idx, c, opt)
            return None
        if name == "SetColumnAttrs":
            self._execute_set_column_attrs(idx, c, opt)
            return None
        if name == "TopN":
            return self._execute_top_n(idx, c, shards, opt)
        if name == "Rows":
            return self._execute_rows(idx, c, shards, opt)
        if name == "Options":
            return self._execute_options(idx, c, shards, opt)
        if name == "Sum":
            return self._execute_sum(idx, c, shards, opt)
        if name in ("Min", "Max"):
            return self._execute_min_max(idx, c, shards, opt, is_min=name == "Min")
        if name in ("MinRow", "MaxRow"):
            return self._execute_min_max_row(idx, c, shards, opt,
                                             is_min=name == "MinRow")
        if name == "GroupBy":
            return self._execute_group_by(idx, c, shards, opt)
        if name == "Distinct":
            # Bare Distinct() has no client-facing result shape: it is the
            # map half of Count(Distinct(...)), which intercepts it in
            # _execute_count. A cluster's remote leg runs it bare (the
            # coordinator ships the inner call) and returns the partial.
            if not opt.remote:
                raise QueryError("Distinct() must be wrapped in Count()")
            return self._execute_distinct(idx, c, shards, opt)
        if name == "SimilarTopN":
            return self._execute_similar_top_n(idx, c, shards, opt)
        if name in _BITMAP_CALLS:
            return self._execute_bitmap_call(idx, c, shards, opt)
        raise QueryError(f"unknown call: {name}")

    # ------------------------------------------------------------------
    # map/reduce spine (reference mapReduce executor.go:2455)
    # ------------------------------------------------------------------

    def map_reduce(self, idx: Index, shards: list[int], c: Call,
                   opt: ExecOptions, map_fn: Callable[[int], Any],
                   reduce_fn: Callable[[Any, Any], Any],
                   local_batch_fn: Callable[[list[int]], Any] | None = None) -> Any:
        """The spine: on a cluster (and not as a remote leg) the cluster
        groups the shards by node and sends ``c`` to the other owners;
        here ``local_batch_fn`` (the planner) takes the whole shard batch
        at once, or map_fn runs per shard and reduce_fn folds the results.
        A shard whose local data the store quarantined is refused with
        ``ShardCorruptError``, never served as zeros (as a remote leg that
        makes the coordinator fail over to a replica)."""
        if self.cluster is not None and not opt.remote:
            return self.cluster.map_reduce(self, idx, shards, c, opt,
                                           map_fn, reduce_fn,
                                           local_batch_fn=local_batch_fn)
        self._check_quarantine(idx, shards)
        if local_batch_fn is not None:
            check_deadline()
            return local_batch_fn(list(shards))
        acc = None
        for shard in shards:
            # Per-shard cancellation point.
            check_deadline()
            acc = reduce_fn(acc, map_fn(shard))
        return acc

    # ------------------------------------------------------------------
    # bitmap calls
    # ------------------------------------------------------------------

    def _execute_bitmap_call(self, idx: Index, c: Call, shards: list[int],
                             opt: ExecOptions) -> Row:
        planner = self._planner_for(c)

        def map_fn(shard):
            return self._bitmap_call_shard(idx, c, shard)

        def reduce_fn(prev, v):
            return v if prev is None else prev.union(v)  # disjoint shards

        # The cluster defers row legs and folds them on the device in one
        # batched program (exec/device_reduce.py) when it sees this tag.
        reduce_fn.reduce_kind = "row_union"

        local_batch = None
        if planner is not None:
            local_batch = lambda shs: planner.execute_bitmap(idx, c, shs)
        else:
            fusion = self._fuse_partial(c)
            if fusion is not None:
                fused_call, const_calls = fusion
                local_batch = (lambda shs: self.planner.execute_bitmap(
                    idx, fused_call, shs,
                    const_rows=self._const_rows(idx, const_calls, shs)))
        row = self.map_reduce(idx, shards, c, opt, map_fn, reduce_fn,
                              local_batch_fn=local_batch) or Row()

        # Row attributes of a plain Row() (executor.go:604-639).
        if c.name == "Row" and not c.has_condition_arg():
            if opt.exclude_row_attrs:
                row.attrs = {}
            else:
                try:
                    field_name = c.field_arg()
                    f = idx.field(field_name)
                    row_id, ok = c.uint_arg(field_name)
                    if f is not None and ok:
                        row.attrs = f.row_attr_store.attrs(row_id)
                except ValueError:
                    pass
        if opt.exclude_columns:
            row.segments = {}
        return row

    def _fuse_partial(self, c: Call):
        """Maximal-subtree fusion for a mixed tree: when the planner
        rejects the whole bitmap tree, every maximal plannable subtree
        still runs on the device and each unplannable subtree becomes a
        ``__const__`` leaf (a Row computed on the host, uploaded as a
        stack). Returns (fused_call, const_calls), or None when the planner
        takes the whole tree, fusion is off, or nothing plannable is left
        (reference executor.py:637-675)."""
        planner = self.planner
        if planner is None or not _fuse.enabled() or planner.supports(c):
            return None
        consts: list[Call] = []
        kept = [False]

        def rewrite(node: Call) -> Call:
            if planner.supports(node):
                kept[0] = True
                return node
            # Only n-ary set ops descend: Not/Shift carry requirements
            # (existence field, shift bounds) that supports() checks as a
            # whole, so an unplannable child makes the unary subtree a
            # const leaf.
            if node.name in _NARY_CALLS and node.children:
                return Call(node.name, args=dict(node.args),
                            children=[rewrite(ch) for ch in node.children])
            consts.append(node)
            return Call("__const__", args={"slot": len(consts) - 1})

        fused = rewrite(c)
        if not kept[0] or not consts:
            return None
        return fused, consts

    def _const_rows(self, idx: Index, const_calls: list[Call],
                    shards: list[int]) -> list[Row]:
        """Each replaced subtree evaluated on the host over ``shards``: the
        per-shard interpreter, for the unplannable part of the tree only."""
        rows = []
        for cc in const_calls:
            segs: dict[int, Any] = {}
            for shard in shards:
                segs.update(self._bitmap_call_shard(idx, cc, shard).segments)
            rows.append(Row(segs))
        return rows

    def _bitmap_call_shard(self, idx: Index, c: Call, shard: int) -> Row:
        """Reference executeBitmapCallShard (executor.go:659)."""
        name = c.name
        if name in ("Row", "Range"):
            return self._row_shard(idx, c, shard)
        if name in _NARY_CALLS:
            return self._nary_shard(idx, c, shard, _NARY_CALLS[name])
        if name == "Not":
            return self._not_shard(idx, c, shard)
        if name == "Shift":
            return self._shift_shard(idx, c, shard)
        raise QueryError(f"unknown call: {name}")

    def _nary_shard(self, idx: Index, c: Call, shard: int, op: str) -> Row:
        if not c.children:
            raise QueryError(f"empty {c.name} query is currently not supported")
        rows = [self._bitmap_call_shard(idx, ch, shard) for ch in c.children]
        acc = rows[0]
        for r in rows[1:]:
            acc = getattr(acc, op)(r)
        return acc

    def _not_shard(self, idx: Index, c: Call, shard: int) -> Row:
        """The existence row minus the child (executor.py:717)."""
        if len(c.children) != 1:
            raise QueryError("Not() requires a single row input")
        ef = idx.existence_field()
        if ef is None:
            raise QueryError(
                f"index does not support existence tracking: {idx.name}")
        frag = self.holder.fragment(idx.name, ef.name, VIEW_STANDARD, shard)
        existence = frag.row(0) if frag else Row()
        return existence.difference(self._bitmap_call_shard(idx, c.children[0],
                                                            shard))

    def _shift_shard(self, idx: Index, c: Call, shard: int) -> Row:
        """The child shifted within its shard (executor.py:729)."""
        n, _ = c.int_arg("n")
        if len(c.children) != 1:
            raise QueryError("Shift() requires a single row input")
        return self._bitmap_call_shard(idx, c.children[0], shard).shift(n)

    def _row_shard(self, idx: Index, c: Call, shard: int) -> Row:
        """Reference executeRowShard (executor.go:1441): the standard view,
        the union of the time views a ``from``/``to`` window (or a
        ``Range``) covers, or a BSI condition. An open ``to`` is now plus a
        day and an open ``from`` the year 1, as in the JAX executor's
        per-shard path (its planner starts at the first time view)."""
        if c.has_condition_arg():
            return self._row_bsi_shard(idx, c, shard)
        field_name = c.field_arg()
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(f"field not found: {field_name!r}")
        row_id = row_id_arg(c, field_name)
        from_time = tq.parse_time(c.args["from"]) if "from" in c.args else None
        to_time = tq.parse_time(c.args["to"]) if "to" in c.args else None
        if c.name == "Row" and from_time is None and to_time is None:
            frag = self.holder.fragment(idx.name, field_name, VIEW_STANDARD, shard)
            return frag.row(row_id) if frag else Row()
        q = f.time_quantum()
        if not q:
            return Row()
        if to_time is None:
            to_time = dt.datetime.now() + dt.timedelta(days=1)
        if from_time is None:
            from_time = dt.datetime.min.replace(year=1)
        out = Row()
        for view_name in tq.views_by_time_range(VIEW_STANDARD, from_time,
                                                to_time, q):
            frag = self.holder.fragment(idx.name, field_name, view_name, shard)
            if frag is not None:
                out = out.union(frag.row(row_id))
        return out

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

    def _execute_sum(self, idx: Index, c: Call, shards: list[int],
                     opt: ExecOptions) -> ValCount:
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

        result = self.map_reduce(idx, shards, c, opt, map_fn,
                                 lambda p, v: v if p is None else p.add(v),
                                 local_batch_fn=local_batch) or ValCount()
        return ValCount() if result.count == 0 else result

    def _execute_min_max(self, idx: Index, c: Call, shards: list[int],
                         opt: ExecOptions, is_min: bool) -> ValCount:
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

        result = self.map_reduce(idx, shards, c, opt, map_fn, reduce_fn,
                                 local_batch_fn=local_batch) or ValCount()
        return ValCount() if result.count == 0 else result

    def _execute_min_max_row(self, idx: Index, c: Call, shards: list[int],
                             opt: ExecOptions, is_min: bool) -> Pair:
        """MinRow/MaxRow (executor.py:918): per shard the smallest (largest)
        row with a bit, in the filter child if there is one, and its count;
        the fold keeps the smallest (largest) id, and on equal ids the
        first shard's count (counts do not add)."""
        field_name = self._agg_field(c)

        def map_fn(shard):
            if idx.field(field_name) is None:
                return Pair()
            frag = self.holder.fragment(idx.name, field_name, VIEW_STANDARD, shard)
            if frag is None:
                return Pair()
            filt = self._agg_filter(idx, c, shard)
            rid, cnt = frag.min_row(filt) if is_min else frag.max_row(filt)
            return Pair(id=rid, count=cnt)

        def reduce_fn(p, v):
            if p is None or p.count == 0:
                return v
            if v.count == 0:
                return p
            if (v.id < p.id) == is_min and v.id != p.id:
                return v
            return p

        return self.map_reduce(idx, shards, c, opt, map_fn, reduce_fn) or Pair()

    # ------------------------------------------------------------------
    # Count
    # ------------------------------------------------------------------

    def _execute_count(self, idx: Index, c: Call, shards: list[int],
                       opt: ExecOptions) -> int:
        if len(c.children) != 1:
            raise QueryError("Count() requires a single bitmap input")
        child = c.children[0]
        if child.name == "Distinct":
            return self._execute_distinct(idx, child, shards, opt)
        planner = self._planner_for(child)

        def map_fn(shard):
            return self._bitmap_call_shard(idx, child, shard).count()

        local_batch = None
        if planner is not None:
            local_batch = lambda shs: planner.execute_count(idx, child, shs)
        else:
            fusion = self._fuse_partial(child)
            if fusion is not None:
                fused_call, const_calls = fusion
                local_batch = (lambda shs: self.planner.execute_count(
                    idx, fused_call, shs,
                    const_rows=self._const_rows(idx, const_calls, shs)))
        return self.map_reduce(idx, shards, c, opt, map_fn, lambda p, v: (p or 0) + v,
                               local_batch_fn=local_batch) or 0

    # ------------------------------------------------------------------
    # approximate analytics (pilosa_tpu_torch/sketch; reference
    # executor.py:989-1190)
    # ------------------------------------------------------------------

    @staticmethod
    def _row_words_for(filt: Row | None, shard: int) -> np.ndarray | None:
        """A filter Row's [W] uint32 word plane for one shard. None for "no
        filter" (distinct from a filter that matched nothing, which is an
        all-zero plane)."""
        if filt is None:
            return None
        seg = filt.segments.get(shard)
        if seg is None:
            return np.zeros(WORDS_PER_SHARD, dtype=np.uint32)
        return bitops.to_host_words(seg)

    def _execute_distinct(self, idx: Index, c: Call, shards: list[int],
                          opt: ExecOptions) -> Any:
        """Count(Distinct(filter?, field=f)): HLL estimate over the field's
        register planes -- one program over all shards with a planner --
        with an EXACT per-shard-unique leg when the estimate lands under
        the threshold (where relative HLL error is most visible and exact
        is cheapest). The coordinator pins the resolved precision and
        threshold into the shipped call so every node sketches at the same
        precision, and a remote leg returns the raw partial (HLLSketch on
        the sketch leg, DistinctValues on the exact leg)."""
        field_name, ok = c.string_arg("field")
        if not ok:
            raise QueryError("Distinct(): field required")
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(field_name)
        if f.bsi_group is None:
            raise QueryError(f"Distinct(): field {field_name!r} has no BSI data "
                             "(int field required)")
        if len(c.children) > 1:
            raise QueryError("Distinct() only accepts a single bitmap input")
        depth = f.bsi_group.bit_depth

        p, has_p = c.uint_arg("precision")
        p = _sketch.validate_precision(p) if has_p else _sketch.precision()
        thr, has_thr = c.uint_arg("threshold")
        if not has_thr:
            thr = _sketch.exact_threshold()

        cc = c.clone()
        cc.args["precision"] = int(p)
        cc.args["threshold"] = int(thr)

        if cc.args.get("exact"):
            part = self._distinct_exact(idx, cc, shards, opt, f, depth)
            return part if opt.remote else int(len(part.values))

        def map_fn(shard):
            _, frag = self._bsi_fragment(idx, field_name, shard)
            if frag is None:
                return _hll.HLLSketch.empty(p)
            fw = self._row_words_for(self._agg_filter(idx, cc, shard), shard)
            return sketch_store.shard_sketch(frag, depth, p, fw)

        def reduce_fn(prev, v):
            return v if prev is None else prev.merge(v)

        # The cluster defers sketch legs and folds them in one stacked
        # register max when it sees this tag.
        reduce_fn.reduce_kind = "register_max"

        local_batch = None
        if self.planner is not None and self.planner.supports_distinct(idx, cc):
            def local_batch(shs):
                regs = self.planner.execute_distinct_registers(idx, cc, list(shs), p)
                return _hll.HLLSketch(p=p, regs=regs)

        sk = self.map_reduce(idx, shards, cc, opt, map_fn, reduce_fn,
                             local_batch_fn=local_batch)
        sk = sk or _hll.HLLSketch.empty(p)
        if opt.remote:
            return sk
        est = sk.estimate()
        if thr and est < thr:
            ec = cc.clone()
            ec.args["exact"] = True
            part = self._distinct_exact(idx, ec, shards, opt, f, depth)
            return int(len(part.values))
        return int(round(est))

    def _distinct_exact(self, idx: Index, c: Call, shards: list[int],
                        opt: ExecOptions, f, depth: int) -> _hll.DistinctValues:
        """Exact leg: per-shard sorted unique values, host union fold; on a
        cluster each node returns the DistinctValues of its own shards."""
        base = np.int64(f.bsi_group.base)

        def map_fn(shard):
            _, frag = self._bsi_fragment(idx, f.name, shard)
            if frag is None:
                return _hll.DistinctValues.empty()
            fw = self._row_words_for(self._agg_filter(idx, c, shard), shard)
            return _hll.DistinctValues(values=sketch_store.shard_distinct(frag, depth, fw)
                                       + base)

        def reduce_fn(prev, v):
            return v if prev is None else prev.merge(v)

        return (self.map_reduce(idx, shards, c, opt, map_fn, reduce_fn)
                or _hll.DistinctValues.empty())

    def _execute_similar_top_n(self, idx: Index, c: Call, shards: list[int],
                               opt: ExecOptions) -> Any:
        """SimilarTopN(f, Row(...), n=, metric=): Jaccard/overlap of the
        filter row against EVERY row of the field, one similar_count pass
        over the field's row cube with a planner. Returns the TopN pair
        shape: Pair(id=row, count=overlap), best-score-first."""
        field_name = c.args.get("_field")
        if not field_name:
            raise QueryError("SimilarTopN(): field required")
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(field_name)
        if f.field_type == FIELD_TYPE_INT:
            raise QueryError("SimilarTopN(): set field required")
        if len(c.children) != 1:
            raise QueryError("SimilarTopN() requires a single bitmap input")
        n, has_n = c.uint_arg("n")
        if not has_n or not n:
            n = _sketch.DEFAULT_SIMILAR_N
        metric, has_m = c.string_arg("metric")
        if not has_m:
            metric = "jaccard"
        if metric not in ("jaccard", "overlap"):
            raise QueryError(f"SimilarTopN(): unknown metric {metric!r}")
        cc = c.clone()
        cc.args["n"] = int(n)
        cc.args["metric"] = metric
        filter_call = cc.children[0]

        def map_fn(shard):
            return self._similar_shard(idx, field_name, filter_call, shard)

        def reduce_fn(prev, v):
            return v if prev is None else prev.merge(v)

        local_batch = None
        if (self.planner is not None
                and self.planner.supports_similar(idx, field_name, filter_call)):
            def local_batch(shs):
                shs = list(shs)
                row_ids = self._field_row_ids(idx, field_name, shs)
                res = self.planner.execute_similar(idx, field_name, filter_call,
                                                   row_ids, shs)
                if res is None:
                    # Cube over the device gate: the host per-shard fold.
                    acc = None
                    for shard in shs:
                        acc = reduce_fn(acc, map_fn(shard))
                    return acc or _hll.SimPartial.empty()
                ids, inter, selfc, filtc, order = res
                return _hll.SimPartial(ids=ids, overlap=inter, selfcnt=selfc,
                                       filtcnt=filtc, order=order)

        part = self.map_reduce(idx, shards, cc, opt, map_fn, reduce_fn,
                               local_batch_fn=local_batch)
        part = part or _hll.SimPartial.empty()
        if opt.remote:
            return part
        return [Pair(id=rid, count=cnt) for rid, cnt, _score in part.top_pairs(n, metric)]

    def _similar_shard(self, idx: Index, field_name: str, filter_call: Call,
                       shard: int) -> _hll.SimPartial:
        """Host oracle / per-shard map half: one shard's overlap and
        cardinality totals for every row of the field."""
        frag = self.holder.fragment(idx.name, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return _hll.SimPartial.empty()
        fw = self._row_words_for(self._bitmap_call_shard(idx, filter_call, shard), shard)
        rids = list(frag.row_ids())
        ids = np.asarray(rids, dtype=np.uint64)
        overlap = np.zeros(len(rids), dtype=np.int64)
        selfcnt = np.zeros(len(rids), dtype=np.int64)
        for i, rid in enumerate(rids):
            words = frag.row_words(rid)
            overlap[i] = bitops.np_count(words & fw)
            selfcnt[i] = bitops.np_count(words)
        return _hll.SimPartial(ids=ids, overlap=overlap, selfcnt=selfcnt,
                               filtcnt=int(bitops.np_count(fw)))

    def _field_row_ids(self, idx: Index, field_name: str, shards) -> list[int]:
        """Sorted union of the field's row ids over the given shards -- the
        id-ascending candidate universe the similarity cube stacks."""
        ids: set[int] = set()
        for shard in shards:
            frag = self.holder.fragment(idx.name, field_name, VIEW_STANDARD, shard)
            if frag is not None:
                ids.update(int(r) for r in frag.row_ids())
        return sorted(ids)

    # ------------------------------------------------------------------
    # TopN (reference executor.go:857 two-pass)
    # ------------------------------------------------------------------

    def _execute_top_n(self, idx: Index, c: Call, shards: list[int],
                       opt: ExecOptions) -> list[Pair]:
        ids_arg, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")

        pairs = self._top_n_shards(idx, c, shards, opt)
        if not pairs or ids_arg or opt.remote:
            return pairs

        # Pass 2: exact counts for the merged candidate ids.
        other = c.clone()
        other.args["ids"] = sorted(p.id for p in pairs)
        trimmed = self._top_n_shards(idx, other, shards, opt)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return trimmed

    def _top_n_shards(self, idx: Index, c: Call, shards: list[int],
                      opt: ExecOptions) -> list[Pair]:
        def reduce_fn(p, v):
            return merge_pairs(p or [], v)

        merged = self.map_reduce(
            idx, shards, c, opt, lambda shard: self._top_n_shard(idx, c, shard), reduce_fn,
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

    @staticmethod
    def _allowed_attrs(c: Call):
        """(attrName, the set of allowed values) of a TopN attr filter, or
        (name, None) without one."""
        attr_name = c.args.get("attrName")
        attr_values = c.args.get("attrValues")
        if attr_name and attr_values:
            return attr_name, set(attr_values)
        return attr_name, None

    def _topn_batch_fn(self, idx: Index, c: Call):
        """Planner TopN: one sparse-aware device sweep for ALL shards
        (planner.execute_topn_counts) instead of a per-shard loop,
        preserving per-shard threshold/attr-filter/truncate semantics. None
        when the call needs the per-shard path (tanimoto needs per-shard
        source counts; unplannable filter trees; int fields)."""
        if self.planner is None:
            return None
        field_name = c.args.get("_field")
        f = idx.field(field_name) if field_name else None
        if f is None or f.field_type == FIELD_TYPE_INT or len(c.children) > 1:
            return None
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 0:
            return None
        filter_call = c.children[0] if c.children else None
        if filter_call is not None and not self.planner.supports(filter_call):
            return None
        n, row_ids, min_threshold = self._topn_args(c)
        attr_name, allowed = self._allowed_attrs(c)

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
                # order-preserving mask, then the attr filter, then
                # truncate -- the order of _top_filter_pairs.
                ids, counts = per_shard[shard]
                keep = counts >= min_threshold
                ids, counts = ids[keep], counts[keep]
                if len(ids) == 0:
                    continue
                if allowed is None and n:
                    ids, counts = ids[:n], counts[:n]
                pairs: list[Pair] = []
                for rid, cnt in zip(ids.tolist(), counts.tolist()):
                    if (allowed is not None and f.row_attr_store.attrs(rid)
                            .get(attr_name) not in allowed):
                        continue
                    pairs.append(Pair(id=rid, count=cnt))
                    if n and len(pairs) >= n:
                        break
                acc = merge_pairs(acc, pairs)
            return acc

        return batch

    def _top_n_shard(self, idx: Index, c: Call, shard: int) -> list[Pair]:
        """Exact per-shard TopN: device-batched intersection counts over
        the row stack (replaces the reference's rank-cache walk,
        fragment.go:1570), then the threshold, tanimoto and attr
        predicates."""
        field_name = c.args.get("_field")
        f = idx.field(field_name) if field_name else None
        if f is not None and f.field_type == FIELD_TYPE_INT:
            raise QueryError(
                f"cannot compute TopN() on integer field: {field_name!r}")
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            raise QueryError("Tanimoto Threshold is from 1 to 100 only")
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
        raw = frag.top(n=0, src=src, row_ids=row_ids)
        pairs = self._top_filter_pairs(f, frag, raw, src, tanimoto,
                                       min_threshold, c)
        return pairs[:n] if n else pairs

    def _top_filter_pairs(self, f, frag, raw, src, tanimoto: int,
                          min_threshold: int, c: Call) -> list[Pair]:
        """Threshold/tanimoto/attr predicates over the sorted (rid, count)
        pairs of ONE shard (fragment.go:1617-1691, executor.py:1340). The
        tanimoto score takes the source row's count (``row_counts``) and
        each row's count from the fragment's host counts."""
        attr_name, allowed = self._allowed_attrs(c)
        src_count = src.count() if (src is not None and tanimoto > 0) else 0
        pairs = []
        for rid, cnt in raw:
            if tanimoto > 0:
                base = frag.rows[rid].count() if rid in frag.rows else 0
                if math.ceil(cnt * 100 / (base + src_count - cnt)) <= tanimoto:
                    continue
            elif cnt < min_threshold:
                continue
            if allowed is not None:
                attrs = f.row_attr_store.attrs(rid) if f else {}
                if attrs.get(attr_name) not in allowed:
                    continue
            pairs.append(Pair(id=rid, count=cnt))
        return pairs

    # ------------------------------------------------------------------
    # Rows (reference executor.go:1272)
    # ------------------------------------------------------------------

    def _execute_rows(self, idx: Index, c: Call, shards: list[int],
                      opt: ExecOptions) -> list[int]:
        """Raw row ids (reference RowIDs); a top-level Rows() result is
        wrapped in RowIdentifiers (with the rows' keys on a keyed field) by
        _translate_result (executor.go:1272, :2800)."""
        field_name = (c.args.get("field") if isinstance(c.args.get("field"), str)
                      else c.args.get("_field"))
        if not isinstance(field_name, str):
            raise QueryError("Rows() field required")
        column, has_col = c.uint_arg("column")
        if has_col:
            shards = [column // SHARD_WIDTH]
        limit, has_limit = c.uint_arg("limit")
        limit = limit if has_limit else _MAXINT

        def reduce_fn(p, v):
            return merge_row_ids(p or [], v, limit)

        views = self._rows_views(idx, field_name, c)
        return self.map_reduce(
            idx, shards, c, opt,
            lambda shard: self._rows_shard(idx, field_name, c, shard, views),
            reduce_fn) or []

    @staticmethod
    def _rows_views(idx: Index, field_name: str, c: Call) -> list[str] | None:
        """The views Rows() reads (reference executeRowsShard,
        executor.go:1320): the standard view, or on a time field with a
        window (or no standard view) the time views covering the window
        clamped to the views that exist; None for a missing field (each
        shard raises, as the JAX executor's per-shard lookup does). The
        same for every shard, so found once per query."""
        f = idx.field(field_name)
        if f is None:
            return None
        if f.field_type != FIELD_TYPE_TIME:
            return [VIEW_STANDARD]
        from_time = tq.parse_time(c.args["from"]) if "from" in c.args else None
        to_time = tq.parse_time(c.args["to"]) if "to" in c.args else None
        if not (from_time or to_time or f.options.no_standard_view):
            return [VIEW_STANDARD]
        q = f.time_quantum()
        if not q:
            return []
        lo, hi = f._time_view_bounds()
        if lo is None:
            return []
        from_time = from_time if (from_time and from_time > lo) else lo
        to_time = to_time if (to_time and to_time < hi) else hi
        return tq.views_by_time_range(VIEW_STANDARD, from_time, to_time, q)

    def _rows_shard(self, idx: Index, field_name: str, c: Call, shard: int,
                    views: list[str] | None) -> list[int]:
        """One shard's row ids over ``views`` (``_rows_views``)."""
        if views is None:
            raise FieldNotFoundError(f"field not found: {field_name!r}")
        start = 0
        previous, has_prev = c.uint_arg("previous")
        if has_prev:
            start = previous + 1
        column, has_col = c.uint_arg("column")
        if has_col and column // SHARD_WIDTH != shard:
            return []
        limit, has_limit = c.uint_arg("limit")
        out: list[int] = []
        for view_name in views:
            frag = self.holder.fragment(idx.name, field_name, view_name, shard)
            if frag is None:
                continue
            rows = frag.rows_list(start_row=start,
                                  column=column if has_col else None,
                                  limit=limit if has_limit else None)
            out = merge_row_ids(out, rows, limit if has_limit else _MAXINT)
        return out

    # ------------------------------------------------------------------
    # GroupBy (reference executor.go:1069, iterator :3058)
    # ------------------------------------------------------------------

    def _execute_group_by(self, idx: Index, c: Call, shards: list[int],
                          opt: ExecOptions) -> list[GroupCount]:
        """GroupBy over ``Rows`` children: group counts in lexicographic
        group order, zero counts dropped; ``offset`` and ``limit`` apply
        once, after the unbounded merge of every shard (executor.py:1442).
        ``Rows`` children with ``limit`` or ``column`` are resolved first
        and restrict their level to those ids."""
        if not c.children:
            raise QueryError("need at least one child call")
        limit, has_limit = c.uint_arg("limit")
        filter_call, _ = c.call_arg("filter")

        child_rows: list[list[int] | None] = [None] * len(c.children)
        for i, child in enumerate(c.children):
            if isinstance(child.args.get("field"), str):
                child.args["_field"] = child.args["field"]
            if child.name != "Rows":
                raise QueryError(
                    f"'{child.name}' is not a valid child query for GroupBy, "
                    f"must be 'Rows'")
            _, has_lim = child.uint_arg("limit")
            _, has_col = child.uint_arg("column")
            if has_lim or has_col:
                ids = self._execute_rows(idx, child, shards, opt)
                if not ids:
                    return []
                child_rows[i] = ids

        def map_fn(shard):
            return self._group_by_shard(idx, c, filter_call, shard, child_rows)

        def reduce_fn(p, v):
            # Unbounded: a limit applied per shard would drop groups that
            # other shards still add to.
            return merge_group_counts(p or [], v, _MAXINT)

        local_batch = None
        gb_fields = self._planner_group_by_fields(idx, c, filter_call,
                                                  child_rows)
        if gb_fields is not None:
            def local_batch(shs):
                p = self.planner
                cands = [p.group_by_candidates(idx, fn, shs) for fn in gb_fields]
                res = None
                if all(cands):
                    res = p.execute_group_by(idx, gb_fields, cands, shs,
                                             filter_call)
                elif shs:  # a level has no rows anywhere: empty result
                    return []
                if res is None:  # past the planner's caps: per shard
                    acc = None
                    for shard in shs:
                        acc = reduce_fn(acc, map_fn(shard))
                    return acc or []
                return [GroupCount(
                    group=[FieldRow(field=gb_fields[i], row_id=rid)
                           for i, rid in enumerate(grp)],
                    count=cnt) for grp, cnt in res]

        results = self.map_reduce(idx, shards, c, opt, map_fn, reduce_fn,
                                  local_batch_fn=local_batch) or []
        offset, has_off = c.uint_arg("offset")
        if has_off and offset < len(results):
            results = results[offset:]
        if has_limit and limit < len(results):
            results = results[:limit]
        return results

    def _planner_group_by_fields(self, idx: Index, c: Call,
                                 filter_call: Call | None,
                                 child_rows) -> list[str] | None:
        """The children's field names when the planner's lattice applies:
        plain ``Rows`` children (no cursor, column, limit or time window)
        over fields with a standard view, and a plannable filter. None
        sends the query to the per-shard walk."""
        if self.planner is None:
            return None
        if filter_call is not None and not self.planner.supports(filter_call):
            return None
        fields = []
        for i, child in enumerate(c.children):
            if child_rows[i] is not None:
                return None
            if any(a in child.args
                   for a in ("previous", "column", "limit", "from", "to")):
                return None
            field_name = child.args.get("_field")
            f = idx.field(field_name)
            if f is None:
                raise FieldNotFoundError(f"field not found: {field_name!r}")
            if f.field_type == FIELD_TYPE_TIME or f.options.no_standard_view:
                return None
            fields.append(field_name)
        return fields

    def _group_by_shard(self, idx: Index, c: Call, filter_call: Call | None,
                        shard: int, child_rows) -> list[GroupCount]:
        """One shard's groups: a depth-first walk over the levels' rows
        with empty intersections pruned, the last level counted in one
        ``intersection_counts`` per prefix; each child's ``previous``
        cursor seeks its level, and once a level cannot resume at its
        cursor row the deeper levels restart (the reference's ignorePrev
        cascade, executor.go:3116-3137)."""
        filter_row = None
        if filter_call is not None:
            filter_row = self._bitmap_call_shard(idx, filter_call, shard)
            if filter_row.segment(shard) is None:
                return []

        fields, frags, cands = [], [], []
        for i, child in enumerate(c.children):
            field_name = child.args.get("_field")
            if idx.field(field_name) is None:
                raise FieldNotFoundError(f"field not found: {field_name!r}")
            frag = self.holder.fragment(idx.name, field_name, VIEW_STANDARD, shard)
            if frag is None:
                return []
            rows = frag.rows_list(among=child_rows[i])
            if not rows:
                return []
            fields.append(field_name)
            frags.append(frag)
            cands.append(rows)

        prev: list[int | None] = []
        for child in c.children:
            p, has_p = child.uint_arg("previous")
            prev.append(p if has_p else None)
        any_prev = any(p is not None for p in prev)

        limit, has_limit = c.uint_arg("limit")
        limit = limit if has_limit else _MAXINT
        results: list[GroupCount] = []
        k = len(cands)

        def recurse(level: int, acc: Row | None, prefix: list[int],
                    at_cursor: bool):
            if len(results) >= limit:
                return
            rows = cands[level]
            if at_cursor and prev[level] is not None:
                # Strictly after the cursor at the last level, at or after
                # it above.
                lo = prev[level] + (1 if level == k - 1 else 0)
                rows = [r for r in rows if r >= lo]
            if level == k - 1:
                if acc is None and filter_row is None:
                    counts = [(r, frags[level].rows[r].count()) for r in rows]
                else:
                    base = acc if acc is not None else filter_row
                    seg = base.segment(shard)
                    if seg is None:
                        return
                    cnts = frags[level].intersection_counts(rows, seg,
                                                            reuse=True)
                    counts = list(zip(rows, cnts.tolist()))
                for r, cnt in counts:
                    if len(results) >= limit:
                        return
                    if cnt > 0:
                        results.append(GroupCount(
                            group=[FieldRow(field=fields[i], row_id=p)
                                   for i, p in enumerate(prefix)] +
                                  [FieldRow(field=fields[level], row_id=r)],
                            count=int(cnt)))
                return
            for j, r in enumerate(rows):
                if len(results) >= limit:
                    return
                row = frags[level].row(r)
                if level == 0 and filter_row is not None:
                    row = row.intersect(filter_row)
                elif acc is not None:
                    row = row.intersect(acc)
                # The cursor chain survives only along the first row of a
                # level, and only if that row is its cursor (or the level
                # has none); otherwise deeper levels restart.
                still_cursor = (at_cursor and j == 0
                                and (prev[level] is None or r == prev[level]))
                if not still_cursor and row.is_empty():
                    continue
                recurse(level + 1, row, prefix + [r], still_cursor)

        recurse(0, None, [], any_prev)
        return results

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
        return f, col_id

    def _write(self, idx: Index, c: Call, col_id: int, opt: ExecOptions,
               apply: Callable[[], bool]) -> bool:
        """Apply a single-column write here, or on a cluster on every
        replica of its shard (executor.go:2144)."""
        if self.cluster is not None:
            return self.cluster.write_fanout(idx.name, col_id // SHARD_WIDTH,
                                             c, opt, apply)
        return apply()

    def _execute_set(self, idx: Index, c: Call, opt: ExecOptions) -> bool:
        """Reference executeSet (executor.go:2067): a bit (with a
        timestamp, also into the time views), or an int field's value."""
        f, col_id = self._write_target(idx, c, "Set")
        idx.add_existence([col_id])
        if f.field_type == FIELD_TYPE_INT:
            value, ok = c.int_arg(f.name)
            if not ok:
                raise QueryError("Set() row argument 'row' required")
            return self._write(idx, c, col_id, opt,
                               lambda: f.set_value(col_id, value))
        row_id = row_id_arg(c, f.name)
        timestamp = None
        if "_timestamp" in c.args:
            timestamp = tq.parse_time(c.args["_timestamp"])
        return self._write(idx, c, col_id, opt,
                           lambda: f.set_bit(row_id, col_id, timestamp))

    def _execute_clear_bit(self, idx: Index, c: Call, opt: ExecOptions) -> bool:
        """Clearing an int field's value clears its exists bit."""
        f, col_id = self._write_target(idx, c, "Clear")
        row_id = row_id_arg(c, f.name)
        if f.field_type != FIELD_TYPE_INT:
            return self._write(idx, c, col_id, opt,
                               lambda: f.clear_bit(row_id, col_id))

        def apply():
            v = f.bsi_view()
            frag = v.fragment(col_id // SHARD_WIDTH) if v is not None else None
            return frag.clear_bit(BSI_EXISTS_BIT, col_id) if frag is not None else False

        return self._write(idx, c, col_id, opt, apply)


    def _execute_clear_row(self, idx: Index, c: Call, shards: list[int],
                           opt: ExecOptions) -> bool:
        """Reference ClearRow (executor.py:1709): the row dropped from every
        view of the field in every shard; True when any held bits."""
        field_name = c.field_arg()
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(f"field not found: {field_name!r}")
        if f.field_type == FIELD_TYPE_INT:
            raise QueryError(
                f"ClearRow() is not supported on {f.field_type} field types")
        row_arg = c.args.get(field_name)
        if isinstance(row_arg, bool):
            row_id = 1 if row_arg else 0
        else:
            row_id, ok = c.uint_arg(field_name)
            if not ok:
                raise QueryError("ClearRow() row argument 'row' required")

        def map_fn(shard):
            changed = False
            for v in list(f.views.values()):
                frag = v.fragment(shard)
                if frag is not None:
                    changed |= frag.clear_row(row_id)
            return changed

        return bool(self.map_reduce(idx, shards, c, opt, map_fn,
                                    lambda p, v: bool(p) or v))

    def _execute_store(self, idx: Index, c: Call, shards: list[int],
                       opt: ExecOptions) -> bool:
        """Reference executeSetRow / Store() (executor.go:1990): the source
        row, evaluated over a node's shards at once (``execute_bitmap``
        with a planner), replaces the target row in each of them; on a
        cluster each owner does its own shards."""
        field_name = c.field_arg()
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(f"field not found: {field_name!r}")
        if f.field_type != "set":
            raise QueryError(f"can't Store() on a {f.field_type} field")
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise QueryError("need the <FIELD>=<ROW> argument on Store()")
        if len(c.children) != 1:
            raise QueryError("Store() requires a source row")
        def store(shs, src):
            view = f.create_view_if_not_exists(VIEW_STANDARD)
            changed = False
            for shard in shs:
                changed |= view.create_fragment_if_not_exists(shard).set_row(src, row_id)
            return changed

        def local_batch(shs):
            # The source over this node's shards only: a remote-style
            # option, so a cluster does not fan the source out again.
            src = self._execute_bitmap_call(idx, c.children[0], list(shs),
                                            ExecOptions(remote=True))
            return store(shs, src)

        return bool(self.map_reduce(
            idx, shards, c, opt,
            lambda shard: store([shard], self._bitmap_call_shard(idx, c.children[0], shard)),
            lambda p, v: bool(p) or v, local_batch_fn=local_batch))

    def _execute_set_row_attrs(self, idx: Index, c: Call, opt: ExecOptions) -> None:
        field_name = c.args.get("_field")
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(f"field not found: {field_name!r}")
        row_id, ok = c.uint_arg("_row")
        if not ok:
            raise QueryError("SetRowAttrs() row field 'row' required")
        attrs = {k: v for k, v in c.args.items() if k not in ("_field", "_row")}
        f.row_attr_store.set_attrs(row_id, attrs)
        if self.cluster is not None:
            self.cluster.broadcast_call(idx.name, c, opt)

    def _execute_set_column_attrs(self, idx: Index, c: Call, opt: ExecOptions) -> None:
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise QueryError("SetColumnAttrs() col required")
        attrs = {k: v for k, v in c.args.items() if k != "_col"}
        idx.column_attr_store.set_attrs(col_id, attrs)
        if self.cluster is not None:
            self.cluster.broadcast_call(idx.name, c, opt)

    # ------------------------------------------------------------------
    # Options (reference executor.go:360)
    # ------------------------------------------------------------------

    def _execute_options(self, idx: Index, c: Call, shards: list[int],
                         opt: ExecOptions) -> Any:
        opt_copy = replace(opt)
        if "columnAttrs" in c.args:
            v = c.args["columnAttrs"]
            if not isinstance(v, bool):
                raise QueryError("Query(): columnAttrs must be a bool")
            opt.column_attrs = v  # the outer opt, as the reference does
        if "excludeRowAttrs" in c.args:
            v = c.args["excludeRowAttrs"]
            if not isinstance(v, bool):
                raise QueryError("Query(): excludeRowAttrs must be a bool")
            opt_copy.exclude_row_attrs = v
        if "excludeColumns" in c.args:
            v = c.args["excludeColumns"]
            if not isinstance(v, bool):
                raise QueryError("Query(): excludeColumns must be a bool")
            opt_copy.exclude_columns = v
        if "shards" in c.args:
            v = c.args["shards"]
            if not isinstance(v, list) or not all(
                    isinstance(s, int) and not isinstance(s, bool) for s in v):
                raise QueryError("Query(): shards must be a list of unsigned integers")
            shards = v
        if len(c.children) != 1:
            raise QueryError("Options() requires a single child call")
        return self._execute_call(idx, c.children[0], shards, opt_copy)

    # ------------------------------------------------------------------
    # key translation (reference executor.go:2610-2905; JAX executor
    # :1815-1975)
    # ------------------------------------------------------------------

    def _resolve_keys(self, idx: Index, f, keys: list[str]) -> list[int]:
        """Batched key -> id resolution, the one forward-translate path:
        the device key plane first (exec/keyplane -- no lock, no
        allocation), then ONE batched host pass over the misses: the
        cluster translator when set (the coordinator is the sole id
        authority; a replica's translator serves its synced local snapshot
        before it batches the remaining misses into one RPC), else the
        store's ``translate_keys`` (one lock acquisition, one epoch bump for
        the whole batch). Plane misses are re-checked under the store lock
        before any allocation, so a stale plane costs a host fallback,
        never a duplicate id."""
        fname = f.name if f is not None else None
        store = (f if f is not None else idx).translate_store
        ids = self.keyplanes.lookup(idx, fname, store, keys)
        if ids is None:
            if self.translator is not None:
                return self.translator(idx.name, fname, list(keys))
            return store.translate_keys(keys)
        missing = [i for i, v in enumerate(ids) if v is None]
        if missing:
            sub = [keys[i] for i in missing]
            if self.translator is not None:
                got = self.translator(idx.name, fname, sub)
            else:
                got = store.translate_keys(sub)
            for i, v in zip(missing, got):
                ids[i] = v
        return ids

    def _translate_call(self, idx: Index, c: Call) -> Call:
        """Map string keys to ids in place on a clone: collect every
        string-key slot in the tree (with the reference translateCall's
        per-slot validation), then resolve each field's keys (or the
        index's column keys) in ONE ``_resolve_keys`` batch."""
        c = c.clone()
        slots: list[tuple[Call, str, str | None, str]] = []
        self._collect_key_slots(idx, c, slots)
        if slots:
            groups: dict[str | None, list[int]] = {}
            for i, (_, _, fname, _) in enumerate(slots):
                groups.setdefault(fname, []).append(i)
            for fname, positions in groups.items():
                f = idx.field(fname) if fname is not None else None
                ids = self._resolve_keys(idx, f, [slots[i][3] for i in positions])
                for i, id_ in zip(positions, ids):
                    call, arg, _, _ = slots[i]
                    call.args[arg] = id_
        return c

    def _collect_key_slots(self, idx: Index, c: Call,
                           slots: list[tuple[Call, str, str | None, str]]) -> None:
        """Gather (call, arg, field-name|None, key) for every string key in
        the tree; validation mirrors reference translateCall
        (executor.go:2634-2637 for the Rows cursor args)."""
        col = c.args.get("_col")
        if isinstance(col, str):
            if not idx.options.keys:
                raise QueryError(f"string 'col' value not allowed unless "
                                 f"index 'keys' option enabled: {col!r}")
            slots.append((c, "_col", None, col))
        for key in list(c.args):
            if pql_ast.is_reserved_arg(key):
                continue
            f = idx.field(key)
            if f is None:
                continue
            val = c.args[key]
            if isinstance(val, str) and f.keys:
                slots.append((c, key, f.name, val))
        row = c.args.get("_row")
        if isinstance(row, str):
            fname = c.args.get("_field")
            f = idx.field(fname) if fname else None
            if f is None or not f.keys:
                raise QueryError("string 'row' value not allowed unless "
                                 "field 'keys' option enabled")
            slots.append((c, "_row", f.name, row))
        if c.name == "Rows":
            fname = c.args.get("_field") or c.args.get("field")
            f = idx.field(fname) if isinstance(fname, str) else None
            p = c.args.get("previous")
            if isinstance(p, str):
                if f is None or not f.keys:
                    raise QueryError("string 'previous' value not allowed "
                                     "unless field 'keys' option enabled")
                slots.append((c, "previous", f.name, p))
            col = c.args.get("column")
            if isinstance(col, str):
                if not idx.options.keys:
                    raise QueryError("string 'column' value not allowed "
                                     "unless index 'keys' option enabled")
                slots.append((c, "column", None, col))
        for ch in c.children:
            self._collect_key_slots(idx, ch, slots)
        for v in c.args.values():
            if isinstance(v, Call):
                self._collect_key_slots(idx, v, slots)

    def _translate_result(self, idx: Index, c: Call, result: Any) -> Any:
        """Map ids back to keys on a top-level result (reference :2781),
        one ``translate_ids`` snapshot pass per result set; a top-level
        Rows() result becomes RowIdentifiers."""
        if isinstance(result, Row) and idx.options.keys:
            cols = [int(i) for i in result.columns()]
            names = idx.translate_store.translate_ids(cols)
            result.keys = [n if n is not None else str(i) for n, i in zip(names, cols)]
        elif c.name == "Rows" and isinstance(result, list):
            fname = c.args.get("_field") or c.args.get("field")
            f = idx.field(fname) if isinstance(fname, str) else None
            if f is not None and f.keys:
                names = f.translate_store.translate_ids(list(result))
                result = RowIdentifiers(keys=[n if n is not None else str(r)
                                              for n, r in zip(names, result)])
            else:
                result = RowIdentifiers(rows=list(result))
        elif isinstance(result, Pair) and c.name in ("MinRow", "MaxRow"):
            fname = c.args.get("field")
            f = idx.field(fname) if isinstance(fname, str) else None
            if f is not None and f.keys:
                result.key = f.translate_store.translate_id(result.id) or ""
        elif isinstance(result, list) and result and isinstance(result[0], Pair):
            fname = c.args.get("_field")
            f = idx.field(fname) if isinstance(fname, str) else None
            if f is not None and f.keys:
                names = f.translate_store.translate_ids([p.id for p in result])
                for p, n in zip(result, names):
                    p.key = n if n is not None else str(p.id)
        elif isinstance(result, list) and result and isinstance(result[0], GroupCount):
            # One reverse batch per keyed field across ALL groups.
            by_field: dict[str, list] = {}
            for gc in result:
                for fr in gc.group:
                    by_field.setdefault(fr.field, []).append(fr)
            for fname, frs in by_field.items():
                f = idx.field(fname)
                if f is None or not f.keys:
                    continue
                names = f.translate_store.translate_ids([fr.row_id for fr in frs])
                for fr, n in zip(frs, names):
                    fr.row_key = n if n is not None else ""
        return result
