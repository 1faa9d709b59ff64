"""The port's result cache against the JAX package's: the cases of
tests/test_result_cache.py that a standalone node has.

- Epoch per-shard semantics (the floor of a shardless bump, selective
  shard bumps, one increment per batch), each beside the JAX Epoch;
- ResultCache's byte-accounted LRU, TTL backstop, tenant partitions and
  fair-share eviction, with snapshots equal to the JAX cache's after the
  same operations;
- canonical plan signatures;
- the executor: hits, misses after a write (only to a shard the plan
  reads), ``cache=False``, a disabled cache, attr writes and bulk imports
  bumping the epochs, the data dir's attr stores keeping them;
- generative equivalence: random interleavings of writes and reads, every
  cached answer equal to an uncached one and to the JAX executor's;
- HTTP: ``/debug/cache`` as the JAX node shows it, the internal-class and
  ``noCache`` exemptions, tenant partitions by X-API-Key, the cache in
  ``/debug/overload`` and ``/debug/vars``, and ``--result-cache-mb 0``.

The cluster cases (remote-leg epoch vectors, index-dirty broadcasts) and
the key-translation ones come with later slices (ROADMAP.md Queue 1).
"""

import json

import numpy as np
import pytest

from pilosa_tpu.cache import ResultCache as JResultCache
from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core.index import Epoch as JEpoch
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu_torch.cache import ResultCache, estimate_result_size, plan_signature
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.index import Epoch
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.obs import MemoryStats
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.server import ServerNode
from test_torch_server import Client

# -- Epoch: per-shard semantics ---------------------------------------------


def _both_epochs(ops):
    """Apply ``ops`` (callables on an epoch) to a port and a JAX Epoch;
    returns both."""
    t, j = Epoch(), JEpoch()
    for op in ops:
        op(t)
        op(j)
    return t, j


def test_epoch_zero_arg_bump_floors_every_shard():
    t, j = _both_epochs([lambda e: e.bump(shard=3)])
    before = t.shard_epoch(7)
    for e in (t, j):
        e.bump()  # index-wide
    assert t.shard_epoch(3) > before and t.shard_epoch(7) > before
    assert t.shard_epoch(3) == t.shard_epoch(7) == t.value
    assert [t.shard_epoch(s) for s in (3, 7)] == [j.shard_epoch(s) for s in (3, 7)]


def test_epoch_per_shard_bump_is_selective():
    e = Epoch()
    base0, base1 = e.shard_epoch(0), e.shard_epoch(1)
    e.bump(shard=0)
    assert e.shard_epoch(0) > base0
    assert e.shard_epoch(1) == base1
    assert e.max_shard_epoch([1]) == base1
    assert e.max_shard_epoch([0, 1]) == e.shard_epoch(0)


def test_epoch_value_stays_monotonic_as_the_jax_epoch():
    ops = [lambda e: e.bump(shard=0), lambda e: e.bump_shards([1, 2]),
           lambda e: e.bump(), lambda e: e.bump(shard=5)]
    seen = []
    t, j = Epoch(), JEpoch()
    for op in ops:
        op(t)
        op(j)
        seen.append(t.value)
        assert t.value == j.value
        assert ([t.max_shard_epoch([s]) for s in range(6)]
                == [j.max_shard_epoch([s]) for s in range(6)])
    assert seen == sorted(set(seen))


def test_epoch_bump_shards_single_increment_per_batch():
    e = Epoch()
    v0 = e.value
    e.bump_shards([0, 1, 2, 3])
    assert e.value == v0 + 1
    assert all(e.shard_epoch(s) == v0 + 1 for s in range(4))
    e.bump_shards([])
    assert e.value == v0 + 1


# -- ResultCache: LRU bytes, TTL, tenants -----------------------------------


def _rows(n_cols):
    return [Row.from_columns(list(range(n_cols)))]


def test_cache_hit_requires_matching_stamp():
    c = ResultCache(max_bytes=1 << 20)
    c.put("t", ("k",), (1, 2), [42])
    assert c.get("t", ("k",), (1, 2)) == [42]
    assert c.get("t", ("k",), (1, 3)) is None  # stale stamp
    assert c.total_bytes == 0  # removed on sight
    assert c.hits == 1 and c.misses == 1


def test_cache_lru_byte_accounting_and_eviction():
    one = estimate_result_size(_rows(64))
    c = ResultCache(max_bytes=3 * one)
    for i in range(5):
        c.put("t", (i,), (0,), _rows(64))
    assert c.total_bytes <= c.max_bytes
    assert c.evictions >= 2
    assert c.get("t", (4,), (0,)) is not None
    assert c.get("t", (0,), (0,)) is None


def test_result_sizes_equal_the_jax_estimates():
    """A Row of device words, counts, pairs: charged as the JAX cache
    charges the same results, so the two budgets hold as many entries."""
    from pilosa_tpu.cache import estimate_result_size as j_estimate
    from pilosa_tpu.core.row import Row as JRow
    from pilosa_tpu.exec.result import Pair as JPair
    from pilosa_tpu.exec.result import RowIdentifiers as JRowIds
    from pilosa_tpu_torch.exec.result import Pair, RowIdentifiers

    cols = [3, SHARD_WIDTH + 9, 2 * SHARD_WIDTH]
    holder = Holder(device="cpu")
    holder.create_index("i").create_field("f").import_bits([1] * 3, cols)
    trow = Executor(holder).execute("i", "Row(f=1)")[0]
    jrow = JRow.from_columns(cols)
    assert (estimate_result_size([trow, 5, [Pair(1, 2)], RowIdentifiers([1, 2])])
            == j_estimate([jrow, 5, [JPair(1, 2)], JRowIds(rows=[1, 2])]))


def test_cache_reput_sole_entry_keeps_partition():
    c = ResultCache(max_bytes=1 << 20)
    c.put("t", ("k",), (1,), [1])
    c.put("t", ("k",), (2,), [2])
    assert c.get("t", ("k",), (2,)) == [2]
    snap = c.snapshot()
    assert snap["entries"] == 1
    assert snap["tenants"]["t"]["bytes"] == c.total_bytes > 0


def test_cache_get_refreshes_lru_position():
    one = estimate_result_size(_rows(64))
    c = ResultCache(max_bytes=2 * one + one // 2)
    c.put("t", ("a",), (0,), _rows(64))
    c.put("t", ("b",), (0,), _rows(64))
    assert c.get("t", ("a",), (0,)) is not None
    c.put("t", ("c",), (0,), _rows(64))  # evicts the LRU: "b"
    assert c.get("t", ("a",), (0,)) is not None
    assert c.get("t", ("b",), (0,)) is None


def test_cache_oversized_entry_skipped():
    c = ResultCache(max_bytes=128)
    c.put("t", ("big",), (0,), _rows(10_000))
    assert c.total_bytes == 0
    assert c.get("t", ("big",), (0,)) is None


def test_cache_ttl_backstop():
    now = [0.0]
    c = ResultCache(max_bytes=1 << 20, ttl=10.0, clock=lambda: now[0])
    c.put("t", ("k",), (0,), [1])
    now[0] = 5.0
    assert c.get("t", ("k",), (0,)) == [1]
    now[0] = 11.0
    assert c.get("t", ("k",), (0,)) is None
    assert c.total_bytes == 0


def test_cache_tenant_isolation():
    c = ResultCache(max_bytes=1 << 20)
    c.put("a", ("k",), (0,), [1])
    assert c.get("b", ("k",), (0,)) is None
    assert c.get("a", ("k",), (0,)) == [1]


def test_cache_fair_share_eviction_as_the_jax_cache():
    """The same puts and gets leave the port's and the JAX cache with
    equal snapshots: the light tenant survives the heavy one's churn."""
    caches = [ResultCache(max_bytes=4 * 256 + 400), JResultCache(max_bytes=4 * 256 + 400)]
    for c in caches:
        c.put("light", ("x",), (0,), [1])
        for i in range(10):
            c.put("heavy", (i,), (0,), [i, i])
        c.get("light", ("x",), (0,))
        c.get("heavy", (0,), (0,))
    snaps = [c.snapshot() for c in caches]
    assert snaps[0] == snaps[1]
    assert snaps[0]["tenants"]["light"]["entries"] == 1
    assert snaps[0]["evictions"] >= 6


def test_cache_snapshot_shape():
    c = ResultCache(max_bytes=1 << 20)
    c.put("", ("k",), (0,), [1])
    c.get("", ("k",), (0,))
    j = JResultCache(max_bytes=1 << 20)
    j.put("", ("k",), (0,), [1])
    j.get("", ("k",), (0,))
    assert c.snapshot() == j.snapshot()
    assert c.snapshot()["tenants"]["(default)"]["entries"] == 1


def test_cache_stats_counters():
    stats = MemoryStats()
    c = ResultCache(max_bytes=1 << 20, stats=stats)
    c.put("t", ("k",), (0,), [1])
    c.get("t", ("k",), (0,))
    c.get("t", ("missing",), (0,))
    assert stats.counter_value("cache.hits") == 1
    assert stats.counter_value("cache.misses") == 1


# -- plan signatures ---------------------------------------------------------


@pytest.mark.parametrize("a,b,same", [
    ("Count(Row(f=1))", "Count( Row( f = 1 ) )", True),
    ("Count(Row(f=1))", "Count(Row(f=2))", False),
    ("Row(f=1)\nRow(f=2)", "Row(f=2)\nRow(f=1)", False),
    ("Count(Shift(Row(f=1), n=3))", "Count(Shift(Row(f=1),n=3))", True),
    ("Options(Row(f=1), shards=[0, 1])", "Options(Row(f=1), shards=[1, 0])", False),
])
def test_signature_as_the_jax_signature(a, b, same):
    from pilosa_tpu.cache.signature import plan_signature as j_sig
    from pilosa_tpu.pql import parse as j_parse

    assert (plan_signature(parse(a)) == plan_signature(parse(b))) is same
    for q in (a, b):
        assert plan_signature(parse(q)) == j_sig(j_parse(q))


# -- executor: per-shard selectivity ----------------------------------------


def _seeded(n_shards=2, planned=False):
    h = Holder(device="cpu")
    idx = h.create_index("i")
    f = idx.create_field("f")
    rng = np.random.default_rng(7)
    cols = rng.integers(0, n_shards * SHARD_WIDTH, 1000)
    f.import_bits(np.ones(1000, dtype=np.int64), cols)
    return h, idx, Executor(h, planner=Planner(h) if planned else None)


@pytest.mark.parametrize("planned", [False, True], ids=["shards", "planner"])
def test_executor_caches_and_invalidates(planned):
    h, idx, ex = _seeded(planned=planned)
    q = "Count(Row(f=1))"
    r1 = ex.execute("i", q)
    assert ex.execute("i", q) == r1
    assert ex.result_cache.hits >= 1
    col = next(c for c in range(SHARD_WIDTH)
               if not h.fragment("i", "f", "standard", 0).contains(1, c))
    h.field("i", "f").set_bit(1, col)
    assert ex.execute("i", q) == [r1[0] + 1]


def test_executor_write_to_other_shard_keeps_entry():
    h, idx, ex = _seeded()
    q = "Count(Row(f=1))"
    ex.execute("i", q, shards=[0])
    hits0 = ex.result_cache.hits
    h.field("i", "f").set_bit(1, SHARD_WIDTH + 5)  # shard 1 only
    ex.execute("i", q, shards=[0])
    assert ex.result_cache.hits == hits0 + 1
    ex.execute("i", q, shards=[1])
    h.field("i", "f").set_bit(1, SHARD_WIDTH + 6)
    m0 = ex.result_cache.misses
    ex.execute("i", q, shards=[1])
    assert ex.result_cache.misses == m0 + 1


def test_executor_schema_change_misses():
    h, idx, ex = _seeded()
    q = "Count(Row(f=1))"
    ex.execute("i", q)
    m0 = ex.result_cache.misses
    idx.create_field("g")
    ex.execute("i", q)
    assert ex.result_cache.misses == m0 + 1


def test_executor_cache_disabled():
    h = Holder(device="cpu")
    h.create_index("i").create_field("f").set_bit(1, 1)
    ex = Executor(h, result_cache=False)
    assert ex.result_cache is None
    assert ex.execute("i", "Count(Row(f=1))") == [1]


def test_executor_cache_flag_bypasses():
    h, idx, ex = _seeded()
    q = "Count(Row(f=1))"
    ex.execute("i", q)
    hits0 = ex.result_cache.hits
    ex.execute("i", q, cache=False)
    assert ex.result_cache.hits == hits0


def test_writes_are_never_cached():
    h, idx, ex = _seeded()
    for _ in range(2):
        ex.execute("i", "Set(3, f=2) Count(Row(f=2))")
        ex.execute("i", "Store(Row(f=1), f=5)")
    assert ex.result_cache.hits == 0
    assert not ex.result_cache.snapshot()["entries"]


# -- the epoch-bump audit: silent mutating paths ----------------------------


def test_attr_writes_bump_epoch_and_miss():
    h, idx, ex = _seeded()
    f = idx.field("f")
    before = idx.epoch.value
    f.row_attr_store.set_attrs(1, {"color": "red"})
    assert idx.epoch.value > before
    mid = idx.epoch.value
    idx.column_attr_store.set_attrs(3, {"x": 1})
    assert idx.epoch.value > mid
    (row,) = ex.execute("i", "Row(f=1)")
    assert row.attrs == {"color": "red"}
    ex.execute("i", 'SetRowAttrs(f, 1, color="blue")')
    (row,) = ex.execute("i", "Row(f=1)")
    assert row.attrs == {"color": "blue"}


def test_bulk_import_bumps_every_touched_shard():
    h = Holder(device="cpu")
    idx = h.create_index("i")
    f = idx.create_field("f")
    cols = np.arange(0, 4 * SHARD_WIDTH, SHARD_WIDTH // 2)
    f.import_bits(np.ones(len(cols), dtype=np.int64), cols)
    before = {s: idx.epoch.shard_epoch(s) for s in range(5)}
    cols2 = np.arange(0, 2 * SHARD_WIDTH, SHARD_WIDTH // 2)
    f.import_bits(2 * np.ones(len(cols2), dtype=np.int64), cols2)
    for s in (0, 1):
        assert idx.epoch.shard_epoch(s) > before[s], f"shard {s} silent"
    for s in (2, 3, 4):
        assert idx.epoch.shard_epoch(s) == before[s], f"untouched shard {s}"


def test_diskstore_attached_stores_keep_epoch(tmp_path):
    from pilosa_tpu_torch.storage import DiskStore

    h = Holder(device="cpu")
    idx = h.create_index("i")
    idx.create_field("f")
    store = DiskStore(str(tmp_path), h)
    store.open()
    try:
        before = idx.epoch.value
        idx.column_attr_store.set_attrs(1, {"a": 1})
        assert idx.epoch.value > before
        mid = idx.epoch.value
        h.field("i", "f").row_attr_store.set_attrs(1, {"b": 2})
        assert idx.epoch.value > mid
    finally:
        store.close()


# -- generative equivalence: cache-on vs cache-off --------------------------


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_generative_equivalence(seed):
    """Random writes and reads: every cached answer equals a cache-bypassing
    one at the same instant, and the JAX executor's."""
    rng = np.random.default_rng(seed)
    n_shards = 3
    holders = [Holder(device="cpu"), JHolder()]
    rows = rng.integers(0, 4, 2000)
    cols = rng.integers(0, n_shards * SHARD_WIDTH, 2000)
    for h in holders:
        h.create_index("i").create_field("f").import_bits(rows, cols)
        h.index("i").add_existence(cols)
    tex = Executor(holders[0], planner=Planner(holders[0]))
    jex = JExecutor(holders[1])
    queries = ["Count(Row(f=1))", "Row(f=2)", "TopN(f, n=3)",
               "Count(Union(Row(f=0), Row(f=3)))", "Count(Not(Row(f=1)))",
               "Count(Intersect(Row(f=1), Row(f=2), Shift(Row(f=3), n=1)))",
               "Rows(f)", "Options(Count(Row(f=2)), shards=[1])"]
    checked = 0
    for _ in range(60):
        if rng.random() < 0.35:
            row = int(rng.integers(0, 4))
            col = int(rng.integers(0, n_shards * SHARD_WIDTH))
            op = "Set" if rng.random() < 0.8 else "Clear"
            q = f"{op}({col}, f={row})"
            assert t_json(tex.execute("i", q)) == j_json(jex.execute("i", q))
        else:
            q = queries[int(rng.integers(0, len(queries)))]
            got = t_json(tex.execute("i", q))
            assert got == t_json(tex.execute("i", q, cache=False)), q
            assert got == j_json(jex.execute("i", q, cache=False)), q
            checked += 1
    assert checked > 0 and tex.result_cache.hits > 0


# -- HTTP surface ------------------------------------------------------------


def test_http_debug_cache_and_internal_exemption():
    nodes = [JServerNode(bind="127.0.0.1:0", use_planner=False),
             ServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False)]
    for n in nodes:
        n.open()
    try:
        snaps = []
        for n in nodes:
            c = Client(n.port)
            c("POST", "/index/i", "{}")
            c("POST", "/index/i/field/f", "{}")
            c("POST", "/index/i/query", "Set(1, f=1)")
            c("POST", "/index/i/query", "Count(Row(f=1))")
            c("POST", "/index/i/query", "Count(Row(f=1))")
            snap = json.loads(c("GET", "/debug/cache")[1])
            assert snap["enabled"] and snap["hits"] >= 1
            entries = snap["entries"]
            for _ in range(2):  # internal class: no tenant partition entry
                c("POST", "/index/i/query", "Count(Row(f=2))",
                  {"X-Qos-Class": "internal"})
            assert json.loads(c("GET", "/debug/cache")[1])["entries"] == entries
            c("POST", "/index/i/query", "Count(Row(f=1))", {"X-API-Key": "tenant-a"})
            snap3 = json.loads(c("GET", "/debug/cache")[1])
            assert "tenant-a" in snap3["tenants"]
            assert json.loads(c("GET", "/debug/overload")[1])["cache"]["bytes"] >= 0
            assert any(k.startswith("cache.hits")
                       for k in json.loads(c("GET", "/debug/vars")[1])["counters"])
            c("POST", "/index/i/query?noCache=true", "Count(Row(f=1))")
            c("POST", "/index/i/query?profile=true", "Count(Row(f=1))")
            snap4 = json.loads(c("GET", "/debug/cache")[1])
            assert snap4["hits"] == snap3["hits"]
            snaps.append(snap4)
            c.close()
        assert snaps[0] == snaps[1]
    finally:
        for n in nodes:
            n.close()


def test_http_result_cache_knobs():
    n = ServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False,
                   result_cache_mb=0)
    assert n.executor.result_cache is None
    n2 = ServerNode(bind="127.0.0.1:0", device="cpu", result_cache_mb=3,
                    result_cache_ttl=2.5)
    snap = n2.executor.result_cache.snapshot()
    assert snap["maxBytes"] == 3 << 20 and snap["ttlSeconds"] == 2.5
    for node in (n, n2):
        node.open()
        node.close()
