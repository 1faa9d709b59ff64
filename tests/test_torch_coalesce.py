"""The port's DispatchCoalescer and inline transfer against the JAX package,
on the CPU, exact: the coalescer and batcher cases of
tests/test_dispatch_fusion.py.

- an identical-argument wave (the deterministic barrier of ``hold()`` /
  ``release()``) is ONE launch, every caller exact;
- the batch past ``MAX_BATCH`` opens a fresh batch and neither is lost;
- ``off`` launches serially;
- a same-shape wave (one signature, different leaves) is ONE launch of the
  batched program, whose per-slot answers equal the serial ones and the
  JAX planner's vmapped wave, for bare leaves, 2-leaf and 3-leaf trees;
- a wave of packed Counts on each packed fast path (a bare packed row, a
  packed row AND a dense one, two packed rows) is ONE dispatch of the
  packed wave kernel's batched form, its answers the JAX executor's; a
  general tree with a packed leaf still launches slot by slot;
- a wave of fused aggregates with different arguments launches slot by
  slot, exact;
- inline transfer steals per knob mode;
- the launch counters surface in ``cache_stats`` and the runtime gauges.
"""

import threading
import time

import numpy as np
import pytest

from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu.parallel import coalesce as j_coalesce
from pilosa_tpu.pql import parse as j_parse
from pilosa_tpu_torch.core import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.parallel import batcher as batcher_mod
from pilosa_tpu_torch.parallel import coalesce as coalesce_mod
from pilosa_tpu_torch.pql import parse as t_parse

SEED = 11


@pytest.fixture(autouse=True)
def _launch_counts_stay_zero():
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


def _seed(idx, rng, n_shards=3, n_rows=6, bits_per_row=2000):
    """tests/test_dispatch_fusion.py's seed() on a port index."""
    total = n_shards * SHARD_WIDTH
    for name in ("f", "g"):
        rows = rng.integers(0, n_rows, n_rows * bits_per_row)
        cols = rng.integers(0, total, n_rows * bits_per_row)
        idx.create_field(name).import_bits(rows, cols)
    v = idx.create_field("v", TFieldOptions(type="int", min=-500, max=500))
    vcols = rng.choice(total, 4000, replace=False)
    v.import_values(vcols.tolist(), rng.integers(-500, 500, len(vcols)).tolist())


@pytest.fixture
def env():
    h = THolder(device="cpu")
    idx = h.create_index("i")
    _seed(idx, np.random.default_rng(SEED))
    plain = TExecutor(h)
    fast = TExecutor(h, planner=Planner(h))
    yield h, idx, plain, fast
    fast.planner.close()


def _wait_pending(co, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with co._lock:
            got = sum(len(b.entries) for b in co._pending.values())
        if got == n:
            return got
        time.sleep(0.005)
    return got


def test_coalesce_barrier_one_launch(env, monkeypatch):
    """N identical concurrent Counts become ONE launch (the
    identical-argument wave), every caller exact."""
    h, idx, plain, fast = env
    p = fast.planner
    q = "Count(Intersect(Row(f=1), Row(g=2)))"
    (want,) = plain.execute("i", q, cache=False)
    fast.execute("i", q, cache=False)  # warm the plan and stack caches
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "on")
    co = p.coalescer
    co.hold()
    results: list = [None] * 4
    try:
        def worker(i):
            (results[i],) = fast.execute("i", q, cache=False)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        assert _wait_pending(co, 4) == 4, "batch never assembled"
        d0, c0 = p.dispatches, p.dispatches_coalesced
    finally:
        co.release()
    for t in threads:
        t.join(timeout=30)
    assert results == [want] * 4
    assert p.dispatches - d0 == 1
    assert p.dispatches_coalesced - c0 == 3
    assert p.batch_widths()[-1] == 4


def test_coalesce_overflow_batch_not_lost(monkeypatch):
    """Entry MAX_BATCH + 1 opens a fresh batch; the sealed full batch stays
    pending until flushed, and every future resolves."""
    h = THolder(device="cpu")
    idx = h.create_index("i")
    idx.create_field("f").import_bits([1], [0])
    planner = Planner(h)
    try:
        fn, a1 = planner.prepare_count(idx, t_parse("Row(f=1)").calls[0], [0])
        co = planner.coalescer
        monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "on")
        co.hold()
        n = coalesce_mod.MAX_BATCH + 3
        assert coalesce_mod.MAX_BATCH == j_coalesce.MAX_BATCH
        try:
            futs = [co.dispatch(fn, a1, planner._sum_host) for _ in range(n)]
            with co._lock:
                batches = list(co._pending.values())
            assert sum(len(b.entries) for b in batches) == n
            assert len(batches) == 2
        finally:
            co.release()
        assert [f.result(timeout=30) for f in futs] == [1] * n
    finally:
        planner.close()


def test_coalesce_off_launches_serially(env, monkeypatch):
    h, idx, plain, fast = env
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "off")
    p = fast.planner
    d0, c0 = p.dispatches, p.dispatches_coalesced
    for _ in range(3):
        fast.execute("i", "Count(Row(f=1))", cache=False)
    assert p.dispatches - d0 == 3
    assert p.dispatches_coalesced == c0


_WAVES = {
    "bare": ["Row(f={r})", "Row(g={r})"],
    "2-leaf": ["Intersect(Row(f={r}), Row(g={s}))"],
    "3-leaf": ["Union(Intersect(Row(f={r}), Row(g={s})), Row(f={s}))",
               "Xor(Row(f={r}), Row(g={s}), Row(f={t}))"],
}


@pytest.mark.parametrize("wave", sorted(_WAVES))
def test_coalesce_vmapped_wave_same_shape(monkeypatch, wave):
    """One signature, different leaves: ONE launch of the batched program,
    per-slot answers equal to serial launches and to the JAX planner's
    vmapped wave on the same data (a 1-device planner, as there; its
    leaves pinned dense, so every slot's stacks have one shape)."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "off")
    rng = np.random.default_rng(SEED)
    rows = [(int(a), int(b), int(c)) for a, b, c in rng.integers(0, 6, (5, 3))]
    data = {name: (rng.integers(0, 6, 6000), rng.integers(0, 2 * SHARD_WIDTH, 6000))
            for name in ("f", "g")}
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        idx = h.create_index("i")
        for name, (r, c) in data.items():
            idx.create_field(name).import_bits(r, c)
    planner, jplanner = Planner(th), MeshPlanner(jh, make_mesh(n=1))
    shards = [0, 1]
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "on")
    try:
        for shape in _WAVES[wave]:
            texts = [shape.format(r=r, s=s, t=t) for r, s, t in rows]
            prepared = [planner.prepare_count(th.index("i"), t_parse(q).calls[0], shards)
                        for q in texts]
            jprepared = [jplanner.prepare_count(jh.index("i"), j_parse(q).calls[0], shards)
                         for q in texts]
            serial = [planner._sum_host(fn(*args)) for fn, args in prepared]
            assert len({planner.fn_key(fn) for fn, _ in prepared}) == 1
            for co, pl, pairs in ((planner.coalescer, planner, prepared),
                                  (jplanner.coalescer, jplanner, jprepared)):
                co.hold()
                try:
                    futs = [co.dispatch(fn, args, pl._sum_host) for fn, args in pairs]
                    assert _wait_pending(co, len(texts)) == len(texts)
                    d0 = pl.dispatches
                finally:
                    co.release()
                got = [f.result(timeout=60) for f in futs]
                assert got == serial, (wave, shape)
                assert pl.dispatches - d0 == 1
                assert pl.batch_widths()[-1] == len(texts)
    finally:
        planner.close()
        jplanner.close()


@pytest.mark.parametrize("policy", ["pow2", "none"])
def test_wave_mixing_shard_sets_splits_by_shape(env, monkeypatch, policy):
    """One plan over different shard sets in one held wave (its leaves of
    different heights): each shape is a wave of its own -- one batched
    launch for a shape with different leaves, one plain launch for a lone
    slot -- and every answer equals its serial launch."""
    # Dense leaves: the dense kernels' batched forms (packed waves:
    # test_packed_wave_is_one_dispatch).
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "off")
    h, idx, plain, fast = env
    p = fast.planner
    p.bucket_policy = policy
    qs = ["Intersect(Row(f=1), Row(g=2))", "Intersect(Row(f=3), Row(g=4))"]
    sets = [[0, 1], [0, 1, 2]]
    prepared = [p.prepare_count(idx, t_parse(q).calls[0], shards)
                for shards in sets for q in qs]
    prepared.append(p.prepare_count(idx, t_parse(qs[0]).calls[0], [2]))
    assert len({p.fn_key(fn) for fn, _ in prepared}) == 1
    assert len({tuple(a[0].shape) for _, a in prepared}) == 3
    serial = [p._sum_host(fn(*args)) for fn, args in prepared]
    want = [plain.execute("i", f"Options(Count({q}), shards={shards})",
                          cache=False)[0]
            for shards in sets for q in qs]
    assert serial[:4] == want
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "on")
    p.coalescer.hold()
    try:
        futs = [p.dispatch_count(fn, args) for fn, args in prepared]
        assert _wait_pending(p.coalescer, 5) == 5
        d0 = p.dispatches
    finally:
        p.coalescer.release()
    assert [f.result(timeout=30) for f in futs] == serial
    assert p.dispatches - d0 == 3
    assert sorted(p.batch_widths()[-3:]) == [1, 2, 2]


@pytest.fixture
def packed_env(monkeypatch):
    """A JAX and a port holder with the same data, both packages in the
    ``auto`` residency mode: rows 0-5 of f and g about 670 bits a shard
    (packed, K = 1024) and row 0 of h 10,000 bits a shard (dense), over 3
    shards; the port's planner, and the JAX executor."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "auto")
    rng = np.random.default_rng(SEED)
    total = 3 * SHARD_WIDTH
    data = {name: (rng.integers(0, 6, 12000), rng.integers(0, total, 12000))
            for name in ("f", "g")}
    data["h"] = (np.zeros(30000, dtype=np.int64), rng.choice(total, 30000, replace=False))
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        idx = h.create_index("i")
        for name, (r, c) in data.items():
            idx.create_field(name).import_bits(r, c)
    planner = Planner(th)
    yield th.index("i"), planner, JExecutor(jh)
    planner.close()


#: each packed fast path: a Count shape over rows r = 0..3, the wave
#: wrapper its wave launches, and its leaves' widths (K = 1024 packed,
#: 32768 words dense).
_PACKED_WAVES = {
    "bare": ("Row(f={r})", "packed_count_batched", [1024]),
    "and_dense": ("Intersect(Row(f={r}), Row(h=0))", "packed_and_dense_count_batched",
                  [1024, 32768]),
    "dense_and": ("Intersect(Row(h=0), Row(g={r}))", "packed_and_dense_count_batched",
                  [1024, 32768]),
    "pair": ("Intersect(Row(f={r}), Row(g={r}))", "packed_pair_count_batched", [1024, 1024]),
}


def _held_wave(p, prepared):
    """``prepared`` dispatched into one held batch; (answers, dispatches)."""
    p.coalescer.hold()
    try:
        futs = [p.dispatch_count(fn, args) for fn, args in prepared]
        assert _wait_pending(p.coalescer, len(prepared)) == len(prepared)
        d0 = p.dispatches
    finally:
        p.coalescer.release()
    return [f.result(timeout=30) for f in futs], p.dispatches - d0


@pytest.mark.parametrize("path", sorted(_PACKED_WAVES))
def test_packed_wave_is_one_dispatch(packed_env, monkeypatch, path):
    """A held wave of 4 different packed Counts on one fast path is ONE
    dispatch, one call of the fast path's wave wrapper over the 4 slots
    (the JAX coalescer's vmap of ``_packed_count_program``), its answers
    the JAX executor's; a wave of one repeated Count is still one shared
    launch of the single wrapper."""
    idx, p, jex = packed_env
    shape, wrapper, widths = _PACKED_WAVES[path]
    qs = [shape.format(r=r) for r in range(4)]
    prepared = [p.prepare_count(idx, t_parse(q).calls[0], [0, 1, 2]) for q in qs]
    (fn, args0), *_ = prepared
    assert len({p.fn_key(f) for f, _ in prepared}) == 1
    assert len({coalesce_mod._arg_shapes(a) for _, a in prepared}) == 1
    assert fn.packed and p.fn_batched(fn) is not None
    assert sorted(a.shape[1] for a in args0) == widths
    want = [jex.execute("i", f"Count({q})")[0] for q in qs]
    calls = []
    real = getattr(kernels, wrapper)

    def spy(*slots):
        calls.append([len(x) for x in slots])
        return real(*slots)

    monkeypatch.setattr(kernels, wrapper, spy)
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "on")
    got, dispatches = _held_wave(p, prepared)
    assert got == want
    assert dispatches == 1 and p.batch_widths()[-1] == 4
    assert calls == [[4] * len(calls[0])] and len(calls[0]) in (1, 2)
    got, dispatches = _held_wave(p, [prepared[0]] * 4)
    assert got == [want[0]] * 4
    assert dispatches == 1 and len(calls) == 1


def test_packed_wave_launches_slot_by_slot(packed_env, monkeypatch):
    """A general tree with a packed leaf (a Union, which expands it) has no
    batched form: a wave of 4 different ones launches slot by slot on the
    flusher, each answer the JAX executor's; a wave of one such Count is
    still ONE shared launch."""
    idx, p, jex = packed_env
    qs = [f"Union(Row(f={r}), Row(g={r}))" for r in range(4)]
    prepared = [p.prepare_count(idx, t_parse(q).calls[0], [0, 1, 2]) for q in qs]
    assert len({p.fn_key(fn) for fn, _ in prepared}) == 1
    assert all(fn.packed and p.fn_batched(fn) is None for fn, _ in prepared)
    want = [jex.execute("i", f"Count({q})")[0] for q in qs]
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "on")
    for wave, n_launches in ((prepared, 4), ([prepared[0]] * 4, 1)):
        got, dispatches = _held_wave(p, wave)
        assert got == (want if n_launches == 4 else [want[0]] * 4)
        assert dispatches == n_launches


def test_aggregate_wave_launches_slot_by_slot(env, monkeypatch):
    """Fused Sums with different filters have no batched form: the wave
    launches slot by slot on the flusher, each exact."""
    h, idx, plain, fast = env
    p = fast.planner
    qs = [f"Sum(Row(f={r}), field=v)" for r in range(4)]
    want = [plain.execute("i", q, cache=False)[0] for q in qs]
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "on")
    p.coalescer.hold()
    try:
        futs = [p.dispatch_sum(idx, t_parse(q).calls[0], [0, 1, 2]) for q in qs]
        assert _wait_pending(p.coalescer, 4) == 4
        d0 = p.dispatches
    finally:
        p.coalescer.release()
    base = idx.field("v").bsi_group.base
    got = [f.result(timeout=30) for f in futs]
    assert [(s + c * base, c) for s, c in got] == [(w.val, w.count) for w in want]
    assert p.dispatches - d0 == 4


def test_inline_transfer_steal(monkeypatch):
    b = batcher_mod.TransferBatcher()
    # Pin the resolver as started, so entries leave the queue only through
    # _steal here.
    b._thread = threading.current_thread()
    monkeypatch.setenv("PILOSA_TPU_INLINE_TRANSFER", "on")
    fut = b.submit(np.asarray([2, 3]), lambda hst: int(hst.sum()))
    assert fut.result(timeout=5) == 5  # resolved on this thread
    assert b.inline_resolved == 1

    monkeypatch.setenv("PILOSA_TPU_INLINE_TRANSFER", "off")
    f2 = b.submit(np.asarray([4]), lambda hst: int(hst.sum()))
    b._steal(f2)
    assert b.inline_resolved == 1 and len(b._queue) == 1  # declined

    monkeypatch.setenv("PILOSA_TPU_INLINE_TRANSFER", "auto")
    f3 = b.submit(np.asarray([6]), lambda hst: int(hst.sum()))
    b._steal(f3)  # auto with two waiters: no steal
    assert b.inline_resolved == 1 and len(b._queue) == 2

    monkeypatch.setenv("PILOSA_TPU_INLINE_TRANSFER", "on")
    assert f3.result(timeout=5) == 6
    assert f2.result(timeout=5) == 4
    assert b.inline_resolved == 3 and len(b._queue) == 0


def test_knob_validation(monkeypatch):
    for mod, setter in ((coalesce_mod, coalesce_mod.set_mode),
                        (batcher_mod, batcher_mod.set_inline_mode)):
        with pytest.raises(ValueError):
            setter("bogus")
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "off")
    coalesce_mod.set_mode("on")
    try:
        assert coalesce_mod.mode() == "off"  # env wins
    finally:
        coalesce_mod.set_mode("auto")
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE_US", "75")
    assert coalesce_mod.default_window_us() == 75.0


def test_dispatch_counters_surface(env):
    from pilosa_tpu_torch.obs.runtime import collect_runtime_gauges
    from pilosa_tpu_torch.obs.stats import MemoryStats

    h, idx, plain, fast = env
    p = fast.planner
    fast.execute("i", "Count(Row(f=1))", cache=False)
    snap = p.cache_stats()
    assert snap["dispatches"] >= 1
    assert "dispatches_coalesced" in snap
    out = collect_runtime_gauges(MemoryStats(), planner=p, probe_device=False)
    assert out["plannerDispatches"] == float(snap["dispatches"])
    assert "plannerDispatchesCoalesced" in out


def test_profiles_carry_dispatch_and_wave_widths(env):
    """A profiled query records its dispatch and transfer-wave widths, as
    /debug/queries/{trace} shows them."""
    from pilosa_tpu_torch.obs import profile as profile_mod

    h, idx, plain, fast = env
    prof = profile_mod.QueryProfile("t1", "Count(Row(f=2))", "i")
    token = profile_mod.activate(prof)
    try:
        fast.execute("i", "Count(Row(f=2))", cache=False)
    finally:
        profile_mod.deactivate(token)
    assert prof.dispatch_widths == [1]
    assert prof.wave_widths and prof.transfer_waves == 1
