"""The port's async serving path against the JAX package, on the CPU, exact.

- ``execute_async`` and its prepared-query table: the cases of
  tests/test_concurrency.py and tests/test_planner.py (matches sync; a
  write, a subset of shards, a recreated index and a stale entry each
  re-plan), with the JAX executor's answers beside the port's.
- ``TransferBatcher``: mixed shapes, close drains and joins, the bounded
  pinned-buffer pool.
- ``ResidencyPrefetcher``: the oversubscription drill of
  tests/test_residency.py (``sync_misses == 0`` while evictions churn) and
  the ``off`` mode's sync misses; the JAX side pinned to dense leaves
  (``PILOSA_TPU_RESIDENCY_PACKED=off``).
- the plain versions of the batched kernels against the JAX ``pair_count``
  and ``row_counts`` (Pallas in interpret mode) and ``_eval_node`` slot by
  slot, and the plain ``assemble_stack`` against the JAX ``_assemble_stack``
  on all-ones and bit-31 words; the planner's sparse upload (turned on
  here, as on the card) against its dense stacks and the JAX counts.
- tests/test_generative.py's random trees through ``execute_async`` on 3
  seeds, against the JAX executor and the set model.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.ops import bitops as jbitops
from pilosa_tpu.ops import pallas_kernels
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu.parallel.batcher import TransferBatcher as JTransferBatcher
from pilosa_tpu.parallel.planner import _assemble_stack as j_assemble_stack
from pilosa_tpu.parallel.planner import _eval_node as j_eval_node
from pilosa_tpu_torch.core import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import residency
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.parallel.batcher import TransferBatcher
from pilosa_tpu_torch.pql import parse as t_parse
from test_generative import FIELDS, ROWS, _eval_model, _gen_tree
from test_torch_kernels import _t, _words

OPS = ["and", "or", "xor", "andnot"]
W = SHARD_WIDTH // 32


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(autouse=True)
def _launch_counts_stay_zero():
    """Every CPU call takes the plain version: no kernel launch is counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


def _both(fn):
    """``fn(holder)`` on a JAX holder and a port CPU holder."""
    jh, th = JHolder(), THolder(device="cpu")
    fn(jh)
    fn(th)
    return jh, th


# -- execute_async and the prepared-query table --------------------------------


def test_execute_async_matches_sync(mesh):
    def load(h):
        idx = h.create_index("i")
        idx.create_field("f").import_bits(np.ones(50, dtype=np.uint64),
                                          np.arange(50, dtype=np.uint64) * 3)
        idx.create_field("g").import_bits(np.full(80, 2, dtype=np.uint64),
                                          np.arange(80, dtype=np.uint64) * 2)

    jh, th = _both(load)
    jex = JExecutor(jh, planner=MeshPlanner(jh, mesh))
    tex = TExecutor(th, planner=Planner(th))
    q = "Count(Intersect(Row(f=1), Row(g=2)))"
    want = jex.execute("i", q)
    assert tex.execute("i", q) == want
    futs = [tex.execute_async("i", q, cache=False) for _ in range(40)]
    assert all(fut.result() == want for fut in futs)
    # A query off the fast path still resolves through the future.
    fut = tex.execute_async("i", "TopN(f, n=2)")
    assert fut.result() == tex.execute("i", "TopN(f, n=2)")
    assert ([(p.id, p.count) for p in fut.result()[0]]
            == [(p.id, p.count) for p in jex.execute("i", "TopN(f, n=2)")[0]])
    tex.planner.close()
    jex.planner.close()


def test_execute_async_aggregates_match_jax(mesh):
    """Sum/Min/Max dispatch async too, the base applied when the wave
    lands; errors resolve on the future."""
    rng = np.random.default_rng(3)
    cols = rng.choice(3 * SHARD_WIDTH, 500, replace=False)
    vals = rng.integers(-300, 300, len(cols))

    def load(h, opts):
        idx = h.create_index("i")
        idx.create_field("f").import_bits(np.ones(200, dtype=np.uint64),
                                          cols[:200].astype(np.uint64))
        idx.create_field("v", opts(type="int", min=-300, max=300)).import_values(
            cols.tolist(), vals.tolist())

    from pilosa_tpu.core import FieldOptions as JFieldOptions
    jh, th = JHolder(), THolder(device="cpu")
    load(jh, JFieldOptions)
    load(th, TFieldOptions)
    jex = JExecutor(jh, planner=MeshPlanner(jh, mesh))
    tex = TExecutor(th, planner=Planner(th))
    for q in ("Sum(field=v)", "Sum(Row(f=1), field=v)", "Min(field=v)",
              "Max(Row(f=1), field=v)", "Min(Row(v > 100), field=v)"):
        want = jex.execute("i", q, cache=False)[0]
        got = tex.execute_async("i", q, cache=False).result()[0]
        assert (got.val, got.count) == (want.val, want.count), q
    assert tex.execute_async("nope", "Count(Row(f=1))").exception() is not None
    tex.planner.close()
    jex.planner.close()


def test_prepared_count_fast_path_invalidation(mesh):
    """The prepared table never serves a stale program: a write (data
    epoch), a subset of shards and a recreated index each re-plan."""
    cols = [0, 1, SHARD_WIDTH, SHARD_WIDTH + 1, 2 * SHARD_WIDTH]

    def load(h):
        idx = h.create_index("prep")
        idx.create_field("f").import_bits([1] * len(cols), cols)
        idx.create_field("g").import_bits([2] * len(cols), cols)

    jh, th = _both(load)
    jex = JExecutor(jh, planner=MeshPlanner(jh, mesh))
    ex = TExecutor(th, planner=Planner(th))
    q = "Count(Intersect(Row(f=1), Row(g=2)))"

    def both(**kw):
        got = ex.execute_async("prep", q, cache=False, **kw).result()
        assert got == jex.execute_async("prep", q, cache=False, **kw).result()
        return got

    assert both() == [5]
    assert ("prep", q) in ex._prepared
    assert both() == [5]  # rides the prepared entry
    for e in (ex, jex):
        e.execute("prep", f"Set({3 * SHARD_WIDTH}, f=1)")
        e.execute("prep", f"Set({3 * SHARD_WIDTH}, g=2)")
    assert both() == [6]
    assert both(shards=[0]) == [2]
    for h in (th, jh):
        h.delete_index("prep")
        idx = h.create_index("prep")
        idx.create_field("f")
        idx.create_field("g")
    assert both() == [0]
    ex.planner.close()
    jex.planner.close()


def test_prepared_entry_dropped_when_stale():
    """A stale prepared entry releases its tensors at once and is
    re-prepared at the new epoch."""
    h = THolder(device="cpu")
    idx = h.create_index("prep2")
    idx.create_field("f")
    ex = TExecutor(h, planner=Planner(h))
    ex.execute("prep2", "Set(1, f=1)")
    q = "Count(Row(f=1))"
    assert ex.execute_async("prep2", q, cache=False).result() == [1]
    assert ("prep2", q) in ex._prepared
    ex.execute("prep2", "Set(2, f=1)")  # bumps the epoch
    assert ex.execute_async("prep2", q, cache=False).result() == [2]
    e = ex._prepared.get(("prep2", q))
    assert e is not None and e[2] == idx.epoch.value
    ex.planner.close()


def test_prepared_subset_never_serves_full_query():
    """An entry prepared for a subset of shards never answers a later
    full-index query; a full entry keeps answering full queries."""
    h = THolder(device="cpu")
    h.create_index("prep3").create_field("f")
    ex = TExecutor(h, planner=Planner(h))
    for c in (0, SHARD_WIDTH, 2 * SHARD_WIDTH):
        ex.execute("prep3", f"Set({c}, f=1)")
    q = "Count(Row(f=1))"
    assert ex.execute_async("prep3", q, shards=[0], cache=False).result() == [1]
    assert ex.execute_async("prep3", q, cache=False).result() == [3]
    assert ex.execute_async("prep3", q, cache=False).result() == [3]
    ex.planner.close()


def test_prepared_path_stores_and_serves_the_result_cache():
    """With the result cache on, a prepared query's answer is stored by the
    batcher's thread under the stamp taken at dispatch, and served next."""
    h = THolder(device="cpu")
    h.create_index("i").create_field("f").import_bits([1, 1], [3, 9])
    ex = TExecutor(h, planner=Planner(h))
    q = "Count(Row(f=1))"
    assert ex.execute_async("i", q).result() == [2]
    assert ex.execute_async("i", q).result() == [2]  # prepared: stores
    d0 = ex.planner.dispatches
    assert ex.execute_async("i", q).result() == [2]  # a cache hit
    assert ex.planner.dispatches == d0
    ex.execute("i", "Set(20, f=1)")
    assert ex.execute_async("i", q).result() == [3]
    ex.planner.close()


# -- TransferBatcher ------------------------------------------------------------


def test_batcher_mixed_shapes():
    bt, jbt = TransferBatcher(), JTransferBatcher()
    futs = []
    for i in range(1, 40):
        arr = np.full(i % 5 + 1, i, dtype=np.int32)
        futs.append((i, bt.submit(torch.from_numpy(arr), lambda host: int(host.sum())),
                     jbt.submit(jax.device_put(arr), lambda host: int(host.sum()))))
    for i, fut, jfut in futs:
        assert fut.result() == jfut.result() == i * (i % 5 + 1)
    bt.close()
    jbt.close()


def test_batcher_close_drains_and_joins():
    """close() wakes the resolver, waits for every queued future, and
    leaves later submits resolving on the caller's thread; twice is safe."""
    bt = TransferBatcher()
    futs = [bt.submit(torch.full((3,), i, dtype=torch.int32), lambda host: int(host.sum()))
            for i in range(50)]
    bt.close()
    assert bt._thread is not None and not bt._thread.is_alive()
    assert all(f.done() for f in futs)
    assert [f.result() for f in futs] == [3 * i for i in range(50)]
    fut = bt.submit(torch.arange(4, dtype=torch.int32), lambda host: int(host.max()))
    assert fut.done() and fut.result() == 3
    bad = bt.submit(torch.arange(2, dtype=torch.int32), lambda host: 1 / 0)
    assert isinstance(bad.exception(), ZeroDivisionError)
    bt.close()


def test_batcher_pinned_pool_is_bounded():
    """The pool keeps PINNED_KEEP free buffers of a size (one past
    PINNED_KEEP_LARGE bytes) and frees the rest; the stats gauge follows
    the pooled bytes. (The buffers are pinned on the card; the pool's
    bookkeeping does not look.)"""
    from pilosa_tpu_torch.obs.stats import MemoryStats
    from pilosa_tpu_torch.parallel import batcher as batcher_mod

    stats = MemoryStats()
    bt = TransferBatcher(stats=stats)
    small, large = 1024, 2 * batcher_mod.PINNED_KEEP_LARGE
    for size in (small,) * (batcher_mod.PINNED_KEEP + 3) + (large,) * 3:
        bt._give_pinned(torch.empty(size, dtype=torch.uint8))
    pooled = batcher_mod.PINNED_KEEP * small + large
    assert [len(bt._pinned[n]) for n in (small, large)] == [batcher_mod.PINNED_KEEP, 1]
    assert stats.gauges[("planner.pinnedPoolBytes", ())] == pooled
    assert bt._take_pinned(large).numel() == large
    assert bt._take_pinned(small - 1).numel() == small
    assert stats.gauges[("planner.pinnedPoolBytes", ())] == pooled - large - small
    bt.close()


# -- ResidencyPrefetcher ----------------------------------------------------------


def test_oversubscribed_prefetch_no_sync_uploads(mesh, monkeypatch):
    """Working set over the device budget with prefetch on: evictions
    churn, yet every query-thread miss meets an upload in flight -- zero
    synchronous uploads -- and every answer equals the JAX node's."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "off")
    monkeypatch.setenv("PILOSA_TPU_PREFETCH", "on")
    n_shards = 8
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, n_shards * SHARD_WIDTH, 2000) for _ in range(6)]

    def load(h):
        f = h.create_index("ov").create_field("f")
        for r, cols in enumerate(rows):
            f.import_bits(np.full(2000, r), cols)

    jh, th = _both(load)
    planner = Planner(th, max_cache_bytes=3 * residency.dense_nbytes(8))
    e = TExecutor(th, planner=planner, result_cache=False)
    je = JExecutor(jh, planner=MeshPlanner(jh, mesh), result_cache=False)
    shards = list(range(n_shards))
    try:
        for _ in range(2):  # 12 misses through 3 slots
            for r in range(6):
                q = f"Count(Row(f={r}))"
                assert e.execute("ov", q, shards=shards) == je.execute("ov", q,
                                                                      shards=shards)
        assert planner.cache_stats()["evictions"] > 0
        dbg = planner.prefetcher.debug()
        assert dbg["sync_misses"] == 0
        assert dbg["hits"] > 0
        assert dbg["completed"] == dbg["scheduled"] >= 6
        assert dbg["inflight"] == 0 and dbg["queued"] == 0
    finally:
        planner.close()
        je.planner.close()


def test_prefetch_off_counts_sync_misses(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_PREFETCH", "off")
    h = THolder(device="cpu")
    h.create_index("sy").create_field("f").import_bits(np.full(100, 0), np.arange(100))
    planner = Planner(h)
    e = TExecutor(h, planner=planner, result_cache=False)
    try:
        assert e.execute("sy", "Count(Row(f=0))", shards=[0]) == [100]
        dbg = planner.prefetcher.debug()
        assert dbg["scheduled"] == 0
        assert dbg["sync_misses"] >= 1
    finally:
        planner.close()


def test_residency_knob():
    """The dense class is the only one built; packed residency is refused
    as not ported."""
    assert residency.choose_class(5) == residency.DENSE
    assert residency.dense_nbytes(4) == 4 * W * 4
    from pilosa_tpu_torch.errors import NotPortedError
    with pytest.raises(NotPortedError,
                       match="packed residency and the device value transpose"):
        residency.set_mode("on")
    with pytest.raises(ValueError):
        residency.set_mode("bogus")
    residency.set_mode("off")
    residency.set_mode("auto")


# -- plain versions of the new kernels against the JAX package ---------------------


@pytest.mark.parametrize("op", OPS)
def test_pair_count_batched_matches_pallas(rng, op):
    """Slot z of the batched count is the JAX pair_count of slot z's pair;
    slots 1 and 3 share one b tensor."""
    a = [_words(rng, (5, 2048)) for _ in range(4)]
    b = [_words(rng, (5, 2048)) for _ in range(3)]
    b = [b[0], b[1], b[2], b[1]]
    got = kernels.pair_count_batched([_t(x) for x in a], [_t(x) for x in b], op)
    assert got.shape == (4, 5) and got.dtype == torch.int32
    for z in range(4):
        want = np.asarray(pallas_kernels.pair_count(jnp.asarray(a[z]),
                                                    jnp.asarray(b[z]), op))
        np.testing.assert_array_equal(got[z].numpy(), want)


def test_row_counts_batched_matches_pallas(rng):
    a = [_words(rng, (6, 2048)) for _ in range(3)]
    got = kernels.row_counts_batched([_t(x) for x in a])
    assert got.shape == (3, 6)
    for z in range(3):
        np.testing.assert_array_equal(
            got[z].numpy(), np.asarray(pallas_kernels.row_counts(jnp.asarray(a[z]))))


def test_batched_wrappers_refuse(rng):
    a, b = _t(_words(rng, (2, 64))), _t(_words(rng, (3, 64)))
    with pytest.raises(ValueError):
        kernels.pair_count_batched([a, b], [a, a])  # slot shapes differ
    with pytest.raises(ValueError):
        kernels.pair_count_batched([a], [a, a])
    with pytest.raises(ValueError):
        kernels.row_counts_batched([])
    with pytest.raises(ValueError):
        kernels.pair_count_batched([a], [a], "nand")
    with pytest.raises(ValueError):
        kernels.tree_count_batched([[a, a], [a]], [0, 1, "and"])


_TREE_SIGS = [
    # (JAX planner signature over leaf slots, port tape over the same leaves)
    (("intersect", (("leaf", 0), ("leaf", 1), ("leaf", 2))), [0, 1, "and", 2, "and"]),
    (("xor", (("union", (("leaf", 0), ("leaf", 1))), ("difference", (("leaf", 2),
                                                                      ("leaf", 0))))),
     [0, 1, "or", 2, 0, "andnot", "xor"]),
]


@pytest.mark.parametrize("sig,tape", _TREE_SIGS, ids=["3-leaf", "mixed"])
def test_tree_count_batched_matches_eval_node(rng, sig, tape):
    tables = [[_words(rng, (4, 2048)) for _ in range(3)] for _ in range(5)]
    got = kernels.tree_count_batched([[_t(x) for x in ls] for ls in tables], tape)
    assert got.shape == (5, 4)
    for z, ls in enumerate(tables):
        want = np.asarray(jax.jit(lambda *a: jbitops.count(j_eval_node(sig, a)))(
            *[jnp.asarray(x) for x in ls]))
        np.testing.assert_array_equal(got[z].numpy(), want)


@pytest.mark.parametrize("words", ["ones", "bit31", "random"])
def test_assemble_stack_matches_jax(rng, words):
    """Dense rows and COO words (all-ones, bit-31 only, random) with pow2
    padding aimed at the trash row: the plain version equals the JAX
    _assemble_stack bit for bit, and no pad reaches a real row."""
    s_pad, d_pad, n_pad, nnz = 8, 8, 16, 11
    dense_at = [1, 4, 6]
    dmat = np.zeros((d_pad, W), dtype=np.uint32)
    dmat[:3] = _words(rng, (3, W))
    didx = np.full(d_pad, s_pad, dtype=np.int32)
    didx[:3] = dense_at
    ci = np.full(n_pad, s_pad, dtype=np.int32)
    cw = np.zeros(n_pad, dtype=np.int32)
    cv = np.zeros(n_pad, dtype=np.uint32)
    sparse_rows = np.array([0, 2, 3, 5], dtype=np.int32)
    ci[:nnz] = np.sort(rng.choice(sparse_rows, nnz))
    cw[:nnz] = rng.choice(W, nnz, replace=False)
    cv[:nnz] = {"ones": 0xFFFFFFFF, "bit31": 0x80000000}.get(words, 0)
    if words == "random":
        cv[:nnz] = _words(rng, (nnz,))
    want = np.asarray(j_assemble_stack(jnp.asarray(didx), jnp.asarray(dmat),
                                       jnp.asarray(ci), jnp.asarray(cw),
                                       jnp.asarray(cv), s_pad=s_pad))
    i32 = lambda x: torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)  # noqa: E731
    got = kernels.assemble_stack(i32(didx), i32(dmat), i32(ci), i32(cw), i32(cv), s_pad)
    assert got.shape == (s_pad, W) and got.dtype == torch.int32
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
    assert not got[7].any()  # the pad row past the last shard stays zero


def test_planner_sparse_upload_matches_dense(mesh, monkeypatch):
    """The planner's sparse upload (on for a CUDA device; turned on here):
    shards with few bits ship as COO words, dense and absent shards beside
    them, and the stack equals the dense upload's; counts equal the JAX
    planner's. Fewer bytes cross the link than the stack holds."""
    rng = np.random.default_rng(8)
    n_shards = 5
    cols = [rng.choice(SHARD_WIDTH, 300, replace=False) + 0 * SHARD_WIDTH,
            rng.choice(SHARD_WIDTH, 9000, replace=False) + 1 * SHARD_WIDTH,
            np.array([2 * SHARD_WIDTH + 31, 2 * SHARD_WIDTH + 63,
                      3 * SHARD_WIDTH - 1]),
            rng.choice(SHARD_WIDTH, 2048, replace=False) + 4 * SHARD_WIDTH]
    cols = np.concatenate(cols)
    sparse_cols = np.concatenate([rng.choice(SHARD_WIDTH, 100, replace=False)
                                  + s * SHARD_WIDTH for s in range(n_shards)])
    g_cols = rng.choice(n_shards * SHARD_WIDTH, 4000, replace=False)

    def load(h):
        idx = h.create_index("sp")
        f = idx.create_field("f")
        f.import_bits(np.ones(len(cols), dtype=np.uint64), cols.astype(np.uint64))
        f.import_bits(np.full(len(sparse_cols), 2, dtype=np.uint64),
                      sparse_cols.astype(np.uint64))
        idx.create_field("g").import_bits(np.ones(4000, dtype=np.uint64),
                                          g_cols.astype(np.uint64))

    jh, th = _both(load)
    dense, sparse = Planner(th), Planner(th)
    monkeypatch.setattr(sparse, "_sparse_upload_enabled", lambda: True)
    tidx = th.index("sp")
    shards = tuple(range(n_shards + 1))  # one shard with no fragment
    for row in (1, 2):  # 1: sparse, dense and absent shards; 2: all sparse
        before = sparse.h2d_bytes
        a = dense._stack_rows(tidx, "f", "standard", row, shards)
        b = sparse._stack_rows(tidx, "f", "standard", row, shards)
        assert torch.equal(a, b)
    assert dense.h2d_bytes == 2 * a.numel() * 4
    # Row 2's 500 bits crossed as 12 B per COO word (pow2-padded to 512),
    # not 8 x 128 KiB.
    assert 0 < sparse.h2d_bytes - before <= 3 * 4 * 512
    jex = JExecutor(jh, planner=MeshPlanner(jh, mesh))
    tex = TExecutor(th, planner=sparse)
    for q in ("Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=1)))",
              "Count(Union(Row(f=2), Row(g=1)))"):
        assert tex.execute("sp", q, cache=False) == jex.execute("sp", q, cache=False)
    for p in (dense, sparse, jex.planner):
        p.close()


# -- generative traffic through execute_async ------------------------------------


def _build_both(rng, n_bits=400, n_shards=3):
    model, existing = {}, set()
    plan = []
    for fname in FIELDS:
        rows = rng.choice(ROWS, n_bits)
        cols = rng.integers(0, n_shards * SHARD_WIDTH, n_bits)
        plan.append((fname, rows, cols))
        for r, c in zip(rows.tolist(), cols.tolist()):
            model.setdefault((fname, r), set()).add(c)
            existing.add(c)

    def load(h):
        idx = h.create_index("g")
        for fname, rows, cols in plan:
            idx.create_field(fname).import_bits(rows.astype(np.uint64),
                                                cols.astype(np.uint64))
        idx.add_existence(sorted(existing))

    jh, th = _both(load)
    return jh, th, model, existing


@pytest.mark.parametrize("seed", [11, 29, 47])
def test_random_trees_async_match_jax(mesh, seed):
    """40 random trees (Not and Shift included), all submitted from one
    thread before any is read: every Count equals the set model and the
    JAX executor's answer."""
    rng = np.random.default_rng(seed)
    jh, th, model, existing = _build_both(rng)
    jex = JExecutor(jh, planner=MeshPlanner(jh, mesh))
    tex = TExecutor(th, planner=Planner(th))
    trees = [_gen_tree(rng, depth=3) for _ in range(40)]
    futs = [tex.execute_async("g", f"Count({q})", cache=False) for q, _ in trees]
    for (q, tree), fut in zip(trees, futs):
        want = len(_eval_model(tree, model, existing))
        assert fut.result() == [want] == jex.execute("g", f"Count({q})", cache=False), q
    tex.planner.close()
    jex.planner.close()


def test_async_from_many_threads():
    """8 threads, each keeping 10 futures in flight: every answer exact."""
    h = THolder(device="cpu")
    idx = h.create_index("i")
    rng = np.random.default_rng(4)
    for fname in ("f", "g"):
        idx.create_field(fname).import_bits(rng.integers(0, 4, 3000),
                                            rng.integers(0, 2 * SHARD_WIDTH, 3000))
    ex = TExecutor(h, planner=Planner(h))
    plain = TExecutor(h)
    qs = [f"Count(Intersect(Row(f={a}), Row(g={b})))" for a in range(4) for b in range(4)]
    want = {q: plain.execute("i", q) for q in qs}
    errors = []

    def worker(k):
        futs = [(q, ex.execute_async("i", q, cache=False))
                for q in qs[k % 4::4] + qs[:2]]
        for q, f in futs:
            if f.result() != want[q]:
                errors.append(q)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors
    ex.planner.close()


def test_planner_leaf_tape_is_structural():
    """One signature lowers to one tape whatever tensors its arguments
    hold (the batched wave's precondition): the same leaf passed twice is
    still two tape leaves."""
    h = THolder(device="cpu")
    h.create_index("i").create_field("f").import_bits([1, 2], [0, 5])
    p = Planner(h)
    idx = h.index("i")
    leaves_a, leaves_b = [], []
    sig = p._signature(idx, t_parse("Intersect(Row(f=1), Row(f=1))").calls[0], leaves_a)
    assert sig == p._signature(idx, t_parse("Intersect(Row(f=1), Row(f=2))").calls[0],
                               leaves_b)
    fn = p._compiled(("count",) + sig, sig, "per_shard")
    args_a = [p._fetch_leaf(idx, leaf, (0,)) for leaf in leaves_a]
    args_b = [p._fetch_leaf(idx, leaf, (0,)) for leaf in leaves_b]
    assert fn.batched([args_a, args_b]).tolist() == [[1], [0]]
    assert fn(*args_a).tolist() == [1] and fn(*args_b).tolist() == [0]
    p.close()


def test_topn_tiles_count_in_one_batched_launch(mesh, monkeypatch):
    """A filtered TopN counts every shard's dense tiles in one
    pair_count_batched call per pass (no per-tile pair_count), with the
    JAX executor's answer."""
    rng = np.random.default_rng(12)
    n_shards = 3
    rows = np.repeat(np.arange(4), 20000 * n_shards)
    cols = np.concatenate([rng.choice(n_shards * SHARD_WIDTH, 20000 * n_shards,
                                      replace=False) for _ in range(4)])
    gcols = rng.choice(n_shards * SHARD_WIDTH, 50000, replace=False)

    def load(h):
        idx = h.create_index("t")
        idx.create_field("f").import_bits(rows, cols)
        idx.create_field("g").import_bits(np.zeros(len(gcols), dtype=np.int64), gcols)

    jh, th = _both(load)
    assert th.fragment("t", "f", "standard", 0).rows[0].is_dense
    calls = []
    for name in ("pair_count", "pair_count_batched"):
        orig = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _n=name, _o=orig, **k: (
            calls.append(_n), _o(*a, **k))[1])
    tex = TExecutor(th, planner=Planner(th))
    jex = JExecutor(jh, planner=MeshPlanner(jh, mesh))
    q = "TopN(f, Row(g=0), n=3)"
    got = tex.execute("t", q, cache=False)[0]
    assert calls == ["pair_count_batched"] * 2  # one per pass
    want = jex.execute("t", q, cache=False)[0]
    assert [(p.id, p.count) for p in got] == [(p.id, p.count) for p in want]
    tex.planner.close()
    jex.planner.close()
