"""Time, mutex and bool fields and MinRow/MaxRow: the port against the JAX
package on the CPU, exact.

- ``core/timequantum.py``: ``views_by_time_range`` and ``views_by_time``
  view for view on the reference's cases (tests/test_datamodel.py) and on
  seeded windows for every quantum, and ``parse_time``.
- Writes and reads through both port executors (per-shard, ``Planner``)
  against both JAX executors (per-shard, ``MeshPlanner``) on the cases of
  tests/test_executor.py (time windows, mutex and bool ``Set``),
  tests/test_core.py (the fragment's mutex vector, bulk mutex imports) and
  tests/test_datamodel.py (field time views, mutex, bool), and on seeded
  imports with timestamps, duplicate mutex columns and moving imports.
  Where the two JAX executors answer differently (an open ``from`` bound:
  the year 1 per shard, the first time view in the planner) each port
  executor is held to its counterpart.
- Imports with timestamps over HTTP, against a JAX node.
- Data dirs holding time views and mutex and bool fields, crossing the
  packages both ways, with byte-equal WAL files for the same writes.
"""

import datetime as dt
import json
import os
import shutil

import numpy as np
import pytest

from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import FieldOptions as JFieldOptions
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core import timequantum as jtq
from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu.storage.diskstore import DiskStore as JDiskStore
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.core import timequantum as ttq
from pilosa_tpu_torch.core.field import parse_stamps
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.server import ServerNode
from pilosa_tpu_torch.storage import DiskStore
from test_torch_server import Client

QUANTA = ["Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H"]


# -- the time quantum -------------------------------------------------------

RANGE_CASES = [
    (dt.datetime(2016, 12, 30), dt.datetime(2017, 1, 3), "YMDH"),
    (dt.datetime(2016, 1, 1), dt.datetime(2018, 1, 1), "YMDH"),
    (dt.datetime(2016, 11, 30, 22), dt.datetime(2016, 12, 2, 2), "YMDH"),
    (dt.datetime(2016, 5, 10), dt.datetime(2016, 5, 12), "YMD"),
    (dt.datetime(2019, 1, 15), dt.datetime(2019, 3, 15), "YMDH"),
    (dt.datetime(2019, 1, 15, 6), dt.datetime(2019, 3, 15, 18), "YMDH"),
    (dt.datetime(2019, 1, 31), dt.datetime(2019, 5, 31), "YM"),
    (dt.datetime(2020, 2, 29, 5), dt.datetime(2021, 3, 1), "YMDH"),
    (dt.datetime(2017, 3, 2, 15), dt.datetime(2017, 3, 2, 15), "YMDH"),
    (dt.datetime(2018, 6, 1), dt.datetime(2017, 6, 1), "YMD"),
]


@pytest.mark.parametrize("start,end,quantum", RANGE_CASES)
def test_views_by_time_range_cases(start, end, quantum):
    assert (ttq.views_by_time_range("standard", start, end, quantum)
            == jtq.views_by_time_range("standard", start, end, quantum))


@pytest.mark.parametrize("quantum", QUANTA)
def test_views_by_time_range_generated(quantum):
    """Seeded windows from an hour to two years (40 days where the
    quantum's coarsest unit is the hour, walked hour by hour), on and off
    unit edges, month ends included: the same views, name for name."""
    rng = np.random.default_rng(len(quantum) * 31 + ord(quantum[0]))
    span = 2 * 365 * 24 if set(quantum) & set("YMD") else 40 * 24
    base = dt.datetime(2015, 1, 1)
    for _ in range(150):
        start = base + dt.timedelta(hours=int(rng.integers(0, 6 * 365 * 24)),
                                    minutes=int(rng.choice([0, 0, 17])))
        if rng.random() < 0.3:  # a month's last days
            start = start.replace(day=min(28 + int(rng.integers(0, 4)), 28)
                                  if start.month == 2 else 28 + int(rng.integers(0, 3)))
        end = start + dt.timedelta(hours=int(rng.integers(0, span)))
        got = ttq.views_by_time_range("standard", start, end, quantum)
        assert got == jtq.views_by_time_range("standard", start, end, quantum)


@pytest.mark.parametrize("quantum", QUANTA + [""])
def test_views_by_time(quantum):
    rng = np.random.default_rng(7)
    for h in rng.integers(0, 10 * 365 * 24, 50).tolist():
        t = dt.datetime(2012, 1, 1) + dt.timedelta(hours=h)
        assert (ttq.views_by_time("standard", t, quantum)
                == jtq.views_by_time("standard", t, quantum))


@pytest.mark.parametrize("value", [
    "2017-01-02T03:04", "2017-1-2T3:04", "bad", "", 1500000000, 0, -86400, 3.5,
    None, True,
])
def test_parse_time(value):
    try:
        want = jtq.parse_time(value)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("'")[0]):
            ttq.parse_time(value)
        return
    assert ttq.parse_time(value) == want


@pytest.mark.parametrize("quantum", ["YMDHX", "HD", "q"])
def test_invalid_quantum(quantum):
    with pytest.raises(Exception) as je:
        jtq.validate_quantum(quantum)
    with pytest.raises(Exception) as te:
        ttq.validate_quantum(quantum)
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)
    opts = {"type": "time", "timeQuantum": quantum}
    with pytest.raises(Exception) as je:
        JHolder().create_index("i").create_field("t", JFieldOptions.from_json(opts))
    with pytest.raises(Exception) as te:
        Holder(device="cpu").create_index("i").create_field(
            "t", FieldOptions.from_json(opts))
    assert type(te.value).__name__ == type(je.value).__name__


def test_parse_stamps_matches_the_jax_api():
    """An import's timestamps: epoch seconds (0 for none) in one numpy
    conversion, strings and mixed lists one by one, as the JAX API's
    parse_time gives them."""
    cases = [[1546300800, 0, 1551398400 + 3599], ["2019-01-01T05:00", "", None],
             [True, False, 7], []]
    for ts in cases:
        want = [jtq.parse_time(t) if t else None for t in ts]
        got = parse_stamps(ts)
        assert [None if np.isnat(x) else x.astype("datetime64[s]").astype(dt.datetime)
                for x in got] == want


# -- writes and reads through the four executors ----------------------------


class Quad:
    """A JAX holder and a port holder with both executors each. Writes run
    once per holder (the per-shard executors) and must answer alike; reads
    run through all four."""

    def __init__(self, mesh, fields: dict):
        self.jh, self.th = JHolder(), Holder(device="cpu")
        for h, opts_cls in ((self.jh, JFieldOptions), (self.th, FieldOptions)):
            idx = h.create_index("i")
            for name, opts in fields.items():
                idx.create_field(name, opts_cls.from_json(opts))
        self.jexecs = [JExecutor(self.jh), JExecutor(self.jh, planner=MeshPlanner(self.jh, mesh))]
        self.texecs = [Executor(self.th), Executor(self.th, planner=Planner(self.th))]

    def write(self, query: str):
        want = j_json(self.jexecs[0].execute("i", query))
        assert t_json(self.texecs[0].execute("i", query)) == want
        return want

    def read(self, query: str, split: bool = False):
        """All four answers equal, or with ``split`` each port executor
        equal to its JAX counterpart."""
        jans = [j_json(e.execute("i", query)) for e in self.jexecs]
        tans = [t_json(e.execute("i", query)) for e in self.texecs]
        if split:
            assert tans == jans
        else:
            assert jans[0] == jans[1], "JAX executors disagree"
            assert tans == [jans[0]] * 2
        return jans[0]

    def both(self, fn):
        """fn(holder) on each holder."""
        return fn(self.jh), fn(self.th)

    def rows_equal(self):
        """Every row of every fragment, byte-equal, and the view names."""
        def words(h):
            out = {}
            for fname, f in h.index("i").fields.items():
                for vname, v in f.views.items():
                    for shard, frag in v.fragments.items():
                        for rid in sorted(frag.rows):
                            if frag.rows[rid].n:
                                out[(fname, vname, shard, rid)] = frag.row_words(rid).tobytes()
            return out
        jw, tw = self.both(words)
        assert tw == jw
        return len(tw)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


TIME_YMDH = {"type": "time", "timeQuantum": "YMDH"}


def test_row_time_range(mesh):
    """tests/test_executor.py test_row_time_range, then Clear, Rows and
    open bounds."""
    q = Quad(mesh, {"t": TIME_YMDH})
    for s in ("Set(1, t=1, 2018-01-01T00:00)", "Set(2, t=1, 2018-06-05T12:00)",
              "Set(3, t=1, 2019-02-03T04:00)", f"Set({SHARD_WIDTH + 4}, t=1, 2018-06-05T13:00)",
              "Set(9, t=2, 2018-06-05T12:00)"):
        assert q.write(s) == [True]
    assert q.read("Range(t=1, from='2018-01-01T00:00', to='2019-01-01T00:00')") == [
        {"attrs": {}, "columns": [1, 2, SHARD_WIDTH + 4]}]
    assert q.read("Row(t=1, from='2018-06-01T00:00', to='2019-03-01T00:00')")[0][
        "columns"] == [2, 3, SHARD_WIDTH + 4]
    assert q.read("Row(t=1)")[0]["columns"] == [1, 2, 3, SHARD_WIDTH + 4]
    for query in ("Count(Row(t=1, from='2018-06-05T12:00', to='2018-06-05T13:00'))",
                  "Count(Union(Row(t=1, from='2018-06-05T00:00', to='2018-06-06T00:00'), "
                  "Row(t=2, from='2018-01-01T00:00', to='2018-07-01T00:00')))",
                  "Rows(t, from='2018-06-01T00:00', to='2018-07-01T00:00')",
                  "Rows(t)", "Rows(t, from='2030-01-01T00:00')",
                  "Row(t=1, to='2018-06-05T13:00')",
                  "Count(Row(t=1, from='2018-02-01T00:00'))",
                  "Row(t=1, from='2020-01-01T00:00', to='2021-01-01T00:00')"):
        q.read(query)
    # An open from: the year 1 per shard, the first view in the planner;
    # either way every bit here.
    q.read("Range(t=1)", split=True)
    assert q.write("Clear(2, t=1)") == [True]
    q.read("Row(t=1, from='2018-01-01T00:00', to='2019-01-01T00:00')")
    q.read("Count(Row(t=1, from='2018-06-05T00:00', to='2018-06-06T00:00'))")
    assert q.rows_equal() > 10


def test_time_field_without_standard_view(mesh):
    q = Quad(mesh, {"n": {"type": "time", "timeQuantum": "YMD", "noStandardView": True},
                    "a": {}})
    q.write("Set(4, n=1, 2020-03-04T05:00)")
    q.write("Set(5, n=2, 2020-04-04T05:00)")
    q.write("Set(4, a=0)")
    q.write("Set(5, a=0)")
    for query in ("Row(n=1)", "Rows(n)", "Rows(n, from='2020-04-01T00:00')",
                  "Count(Row(n=2, from='2020-01-01T00:00', to='2021-01-01T00:00'))",
                  "GroupBy(Rows(a), Rows(n))", "Row(n=1, from='2020-03-01T00:00')"):
        q.read(query)
    assert q.both(lambda h: h.field("i", "n").view_names()) == (
        ["standard_2020", "standard_202003", "standard_20200304", "standard_202004",
         "standard_20200404"],) * 2


def test_mutex_and_bool_via_executor(mesh):
    """tests/test_executor.py's mutex and bool cases, and the field cases
    of tests/test_datamodel.py."""
    q = Quad(mesh, {"m": {"type": "mutex"}, "b": {"type": "bool"}})
    for s in ("Set(5, m=1)", "Set(5, m=2)", f"Set({SHARD_WIDTH + 5}, m=1)",
              "Set(5, b=true)", "Set(6, b=false)"):
        q.write(s)
    for query in ("Count(Row(m=1))", "Count(Row(m=2))", "Row(b=true)", "Row(b=false)",
                  "Rows(m)", "Rows(b)", "Count(Intersect(Row(m=2), Row(b=true)))"):
        q.read(query)
    q.write("Set(5, b=false)")
    assert q.read("Row(b=true)")[0]["columns"] == []
    assert q.read("Row(b=false)")[0]["columns"] == [5, 6]
    q.write("Clear(5, m=2)")
    q.write("Set(5, m=2)")
    q.write("Set(5, m=2)")
    q.read("Rows(m, column=5)")
    assert q.both(lambda h: h.field("i", "b").options.to_json()) == ({"type": "bool"},) * 2
    assert q.both(lambda h: h.field("i", "m").options.to_json())[0] == \
        q.th.field("i", "m").options.to_json()
    q.rows_equal()


def test_time_import_with_timestamps(mesh):
    """A seeded import with timestamps (a datetime list, with None, on the
    JAX side; a datetime64 array on the port's) over 3 shards, dense
    standard rows beside tiny time views; then a clearing import."""
    rng = np.random.default_rng(3)
    n = 40000
    cols = rng.integers(0, 3 * SHARD_WIDTH, n, dtype=np.uint64)
    rows = rng.integers(0, 3, n).astype(np.uint64)
    hours = rng.integers(0, 24 * 40, n)
    stamps = [None if h % 7 == 0 else dt.datetime(2019, 1, 1) + dt.timedelta(hours=int(h))
              for h in hours.tolist()]
    q = Quad(mesh, {"t": TIME_YMDH})
    q.jh.field("i", "t").import_bits(rows, cols, stamps)
    q.th.field("i", "t").import_bits(
        rows, cols, np.array(stamps, dtype="datetime64[s]"))
    assert q.rows_equal() > 1000
    clear = rng.choice(n, 3000, replace=False)
    q.jh.field("i", "t").import_bits(rows[clear], cols[clear],
                                     [stamps[i] for i in clear.tolist()], clear=True)
    q.th.field("i", "t").import_bits(rows[clear], cols[clear],
                                     [stamps[i] for i in clear.tolist()], clear=True)
    q.rows_equal()
    for query in ("Count(Row(t=1, from='2019-01-05T06:00', to='2019-02-03T18:00'))",
                  "Count(Intersect(Row(t=0, from='2019-01-01T00:00', to='2019-01-20T00:00'), "
                  "Row(t=2, from='2019-01-10T00:00', to='2019-02-01T00:00')))",
                  "Rows(t, from='2019-01-02T03:00', to='2019-01-02T05:00')",
                  "Count(Row(t=2))", "Count(Row(t=0))"):
        q.read(query)
    # Timestamps on a field without a quantum: refused in both packages.
    for h in (JHolder(), Holder(device="cpu")):
        with pytest.raises(ValueError, match="time quantum"):
            h.create_index("x").create_field("s").import_bits(
                [1], [1], [dt.datetime(2019, 1, 1)])


def test_time_window_beyond_the_tape(mesh):
    """A window of 67 views (more leaves than one tree_count tape holds)
    and one of many hours, counted and read through the planner's op tape
    against the JAX executors."""
    rng = np.random.default_rng(8)
    n = 6000
    cols = rng.integers(0, 2 * SHARD_WIDTH, n, dtype=np.uint64)
    hours = rng.integers(0, 24 * 90, n)
    stamps = [dt.datetime(2019, 1, 1) + dt.timedelta(hours=int(h)) for h in hours.tolist()]
    q = Quad(mesh, {"t": TIME_YMDH, "g": {}})
    for h in (q.jh, q.th):
        h.field("i", "t").import_bits(np.ones(n, dtype=np.uint64), cols, stamps)
        h.field("i", "g").import_bits(np.full(n // 2, 2, dtype=np.uint64), cols[::2])
    for query in ("Count(Row(t=1, from='2019-01-15T06:00', to='2019-03-15T18:00'))",
                  "Count(Intersect(Row(t=1, from='2019-01-15T06:00', "
                  "to='2019-03-15T18:00'), Row(g=2)))",
                  "Row(t=1, from='2019-02-27T23:00', to='2019-03-01T01:00')",
                  "Count(Row(t=1, from='2019-01-01T01:00', to='2019-01-02T23:00'))"):
        q.read(query)
    views = ttq.views_by_time_range("standard", dt.datetime(2019, 1, 15, 6),
                                    dt.datetime(2019, 3, 15, 18), "YMDH")
    assert len(views) == 67


def test_bulk_mutex_imports(mesh):
    """Duplicate columns in a batch (the last write wins), then a moving
    import, on mutex and bool fields over 3 shards: every row byte-equal
    to the JAX package's, and the reads."""
    rng = np.random.default_rng(4)
    n = 30000
    cols = rng.integers(0, 3 * SHARD_WIDTH, n, dtype=np.uint64)
    cols[n // 2:n // 2 + 500] = cols[:500]  # columns written twice
    rows = rng.integers(0, 16, n).astype(np.uint64)
    q = Quad(mesh, {"m": {"type": "mutex"}, "b": {"type": "bool"}})
    for h in (q.jh, q.th):
        h.field("i", "m").import_bits(rows, cols)
        h.field("i", "b").import_bits(rows % 2, cols)
    q.rows_equal()
    moved = rng.choice(n, 8000, replace=False)
    new_rows = rng.integers(0, 16, 8000).astype(np.uint64)
    for h in (q.jh, q.th):
        h.field("i", "m").import_bits(new_rows, cols[moved])
        h.field("i", "b").import_bits(new_rows % 2, cols[moved])
    q.rows_equal()
    for query in ("Count(Row(m=3))", "Count(Row(b=true))", "Rows(m)", "TopN(m, n=4)",
                  "MaxRow(field=m)", "MinRow(Row(b=true), field=m)"):
        q.read(query)
    q.write(f"Set({int(cols[0])}, m=15)")
    q.rows_equal()


# -- the fragment's mutex vector (tests/test_core.py) ------------------------


def _frags():
    return (JFragment("i", "f", "standard", 0, mutex=True),
            Fragment("i", "f", "standard", 0, "cpu", mutex=True))


def _same_rows(jf, tf):
    assert sorted(r for r in tf.rows if tf.rows[r].n) == sorted(
        r for r in jf.rows if jf.rows[r].n)
    for rid in jf.rows:
        assert np.array_equal(tf.row_words(rid), jf.row_words(rid))


def test_fragment_mutex_import():
    jf, tf = _frags()
    for f in (jf, tf):
        f.bulk_import_mutex([1, 2], [10, 10])  # the second write steals the column
    _same_rows(jf, tf)
    assert tf.row_for_column(10) == jf.row_for_column(10) == 2


def test_mutex_map_interleaved_ops():
    """Single-bit, bulk and clear_row changes, and a non-mutex bulk import
    (a WAL replay), keep the column vector right, as in the JAX fragment."""
    jf, tf = _frags()
    steps = [
        ("bulk_import_mutex", ([1, 2, 3], [10, 20, 30])),
        ("set_bit", (5, 10)),
        ("bulk_import_mutex", ([1], [10])),
        ("clear_row", (2,)),
        ("bulk_import", ([7], [40])),
        ("bulk_import_mutex", ([8, 9, 8], [40, 41, 42])),
        ("clear_bit", (9, 41)),
        ("set_bit", (9, 30)),
    ]
    for name, args in steps:
        assert getattr(tf, name)(*args) == getattr(jf, name)(*args), name
        for col in (10, 20, 30, 40, 41, 42, 50):
            assert tf.row_for_column(col) == jf.row_for_column(col), (name, col)
        _same_rows(jf, tf)


def test_mutex_import_many_rows():
    """A 30k-row mutex import and a second one stealing every column into
    new rows (tests/test_core.py test_mutex_import_scales_past_row_scan at
    a third of its size)."""
    jf, tf = _frags()
    n = 30_000
    rows = np.arange(n, dtype=np.uint64)
    cols = np.arange(n, dtype=np.uint64)
    for f in (jf, tf):
        f.bulk_import_mutex(rows.tolist(), cols.tolist())
        f.bulk_import_mutex((rows + np.uint64(n)).tolist(), cols.tolist())
    assert tf.row_for_column(0) == jf.row_for_column(0) == n
    assert sorted(tf.rows) == sorted(jf.rows)
    assert all(tf.rows[r].n == jf.rows[r].n for r in jf.rows)


def test_min_max_row(mesh):
    """MinRow/MaxRow with and without a filter over 3 shards whose extreme
    rows differ: the smallest (largest) id, the first shard's count on
    equal ids."""
    q = Quad(mesh, {"f": {}, "g": {}})
    bits = {"f": ([3, 7, 3, 9, 1, 4, 4], [0, 1, SHARD_WIDTH, SHARD_WIDTH + 1,
                                           2 * SHARD_WIDTH, 2 * SHARD_WIDTH + 1, 5]),
            "g": ([1, 1, 1], [1, SHARD_WIDTH + 1, 2 * SHARD_WIDTH + 1])}
    for h in (q.jh, q.th):
        for fname, (rows, cols) in bits.items():
            h.field("i", fname).import_bits(rows, cols)
    for query in ("MinRow(field=f)", "MaxRow(field=f)", "MinRow(Row(g=1), field=f)",
                  "MaxRow(Row(g=1), field=f)", "MaxRow(Row(g=9), field=f)",
                  "MinRow(field=g)", "MinRow(field=nope)",
                  "MaxRow(Intersect(Row(g=1), Row(f=4)), field=f)"):
        q.read(query)
    with pytest.raises(Exception):
        q.texecs[0].execute("i", "MinRow()")


def test_result_cache_tells_windows_apart(mesh):
    """Counts that differ only in from/to are different plans: the port's
    result cache (on by default) keeps them apart, and a write to a new
    time view misses it."""
    q = Quad(mesh, {"t": TIME_YMDH})
    q.write("Set(1, t=1, 2020-01-01T00:00)")
    q.write("Set(2, t=1, 2020-02-01T00:00)")
    a = "Count(Row(t=1, from='2020-01-01T00:00', to='2020-01-15T00:00'))"
    b = "Count(Row(t=1, from='2020-01-01T00:00', to='2020-03-01T00:00'))"
    assert q.read(a) == [1] and q.read(b) == [2]
    assert q.read(a) == [1] and q.read(b) == [2]
    q.write("Set(3, t=1, 2020-01-02T05:00)")
    assert q.read(a) == [2] and q.read(b) == [3]


# -- imports with timestamps over HTTP ---------------------------------------


@pytest.fixture(scope="module")
def http_nodes():
    jn = JServerNode(bind="127.0.0.1:0", ingest_transpose="off")
    tn = ServerNode(bind="127.0.0.1:0", device="cpu")
    jn.open()
    tn.open()
    jc, tc = Client(jn.port), Client(tn.port)
    yield jc, tc
    jc.close()
    tc.close()
    jn.close()
    tn.close()


def _same(clients, method, path, body=None):
    jc, tc = clients
    want = jc(method, path, body)[:2]
    assert tc(method, path, body)[:2] == want
    return want


def test_http_imports_with_timestamps(http_nodes):
    """Field creation for the three types, imports with epoch-second and
    string timestamps (0 and "" for none), errors, and the reads: equal
    statuses and byte-equal bodies."""
    c = http_nodes
    assert _same(c, "POST", "/index/h")[0] == 200
    for name, opts in (("t", TIME_YMDH), ("m", {"type": "mutex"}), ("b", {"type": "bool"}),
                       ("d", {"type": "time", "timeQuantum": "D", "noStandardView": True})):
        assert _same(c, "POST", f"/index/h/field/{name}", {"options": opts})[0] == 200
    assert _same(c, "POST", "/index/h/field/bad",
                 {"options": {"type": "time", "timeQuantum": "XY"}})[0] == 400
    assert _same(c, "POST", "/index/h/field/bad2", {"options": {"type": "nope"}})[0] == 400
    rng = np.random.default_rng(5)
    n = 3000
    cols = rng.integers(0, 2 * SHARD_WIDTH, n).tolist()
    secs = (1546300800 + 3600 * rng.integers(0, 24 * 60, n)).tolist()
    secs[::9] = [0] * len(secs[::9])
    req = {"rowIDs": rng.integers(0, 3, n).tolist(), "columnIDs": cols, "timestamps": secs}
    assert _same(c, "POST", "/index/h/field/t/import", req)[0] == 200
    req = {"rowIDs": [4, 4, 5], "columnIDs": [1, 2, 3],
           "timestamps": ["2019-02-03T04:00", "", "2019-02-04T00:00"]}
    assert _same(c, "POST", "/index/h/field/t/import", req)[0] == 200
    req = {"rowIDs": [1, 2, 3], "columnIDs": [1, 2, 3], "timestamps": [1546300800] * 3}
    assert _same(c, "POST", "/index/h/field/d/import", req)[0] == 200
    assert _same(c, "POST", "/index/h/field/t/import",
                 {"rowIDs": [1], "columnIDs": [1], "timestamps": ["junk"]})[0] != 200
    req = {"rowIDs": rng.integers(0, 6, n).tolist(), "columnIDs": cols}
    assert _same(c, "POST", "/index/h/field/m/import", req)[0] == 200
    req = {"rowIDs": rng.integers(0, 2, n).tolist(), "columnIDs": cols}
    assert _same(c, "POST", "/index/h/field/b/import", req)[0] == 200
    for query in ("Count(Row(t=1, from='2019-01-10T00:00', to='2019-02-10T05:00'))",
                  "Row(t=4, from='2019-02-01T00:00', to='2019-03-01T00:00')",
                  "Rows(t, from='2019-02-03T00:00', to='2019-02-04T00:00')",
                  "Count(Row(t=2))", "Rows(d)", "Count(Row(m=3))", "Count(Row(b=true))",
                  "MaxRow(Row(b=false), field=m)", "MinRow(field=t)",
                  "GroupBy(Rows(m), Rows(b), limit=4, offset=2)",
                  "Set(7, t=2, 2019-03-01T01:00) Count(Row(t=2, from='2019-03-01T00:00'))",
                  "Clear(7, t=2) Count(Row(t=2, from='2019-03-01T00:00'))",
                  "Set(1, m=5) Count(Row(m=5))", "Set(1, b=true) Row(b=true)"):
        status, body = _same(c, "POST", "/index/h/query", query)
        assert status == 200, (query, body)
    for path in ("/schema", "/index/h/field/t/views", "/index/h/field/d/views"):
        assert _same(c, "GET", path)[0] == 200
    assert _same(c, "DELETE", "/index/h")[0] == 200


# -- data dirs across the packages -------------------------------------------


def _write_fields(pkg: str, d: str):
    """Time, mutex and bool data written through one package's DiskStore:
    imports with timestamps, a moving mutex import, single writes, a
    flush, then more writes left in the WAL."""
    rng = np.random.default_rng(12)
    if pkg == "jax":
        h, opts = JHolder(), JFieldOptions
        store = JDiskStore(d, h)
    else:
        h, opts = Holder(device="cpu"), FieldOptions
        store = DiskStore(d, h)
    store.open()
    idx = h.create_index("i")
    t = idx.create_field("t", opts.from_json(TIME_YMDH))
    m = idx.create_field("m", opts.from_json({"type": "mutex"}))
    b = idx.create_field("b", opts.from_json({"type": "bool"}))
    n = 2000
    cols = rng.integers(0, 3 * SHARD_WIDTH, n, dtype=np.uint64)
    stamps = [dt.datetime(2019, 5, 1) + dt.timedelta(hours=int(x))
              for x in rng.integers(0, 24 * 12, n)]
    t.import_bits(rng.integers(0, 3, n).astype(np.uint64), cols, stamps)
    m.import_bits(rng.integers(0, 8, n).astype(np.uint64), cols)
    b.import_bits(rng.integers(0, 2, n).astype(np.uint64), cols)
    m.import_bits(rng.integers(0, 8, 600).astype(np.uint64), cols[:600])
    t.set_bit(1, 77, dt.datetime(2019, 7, 4, 3))
    m.set_bit(2, int(cols[3]))
    store.flush()
    t.clear_bit(1, 77)
    m.import_bits([6, 7, 6], [int(cols[5]), int(cols[6]), int(cols[5])])
    b.set_bit(1, int(cols[9]))
    store.save_schema()
    return h, store


def _open_dir(pkg: str, d: str):
    h = JHolder() if pkg == "jax" else Holder(device="cpu")
    store = (JDiskStore if pkg == "jax" else DiskStore)(d, h)
    store.open()
    return h, store


def _dir_words(h) -> dict:
    out = {}
    for fname, f in h.index("i").fields.items():
        for vname, v in f.views.items():
            for shard, frag in v.fragments.items():
                for rid in sorted(frag.rows):
                    out[(fname, vname, shard, rid)] = frag.row_words(rid).tobytes()
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_fields_data_dir_crosses_packages(tmp_path, writer, reader):
    """A dir of time views and mutex and bool fields (snapshots and a WAL
    tail) written by one package opens in the other with byte-equal rows
    and the same answers; after a flush, equal schema.json."""
    src = str(tmp_path / "src")
    _write_fields(writer, src)
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(src, dirs[pkg])
    opened = {pkg: _open_dir(pkg, dirs[pkg]) for pkg in (writer, reader)}
    words = {pkg: _dir_words(h) for pkg, (h, _) in opened.items()}
    assert words[reader] == words[writer] and len(words[reader]) > 500
    jh, th = opened["jax"][0], opened["port"][0]
    for query in ("Count(Row(t=1, from='2019-05-03T03:00', to='2019-05-11T00:00'))",
                  "Count(Row(m=6))", "Count(Row(b=true))", "Rows(t, from='2019-07-04T00:00')"):
        assert t_json(Executor(th).execute("i", query)) == j_json(JExecutor(jh).execute("i", query))
    for _, store in opened.values():
        store.close()
    schemas = {pkg: open(os.path.join(dirs[pkg], "schema.json"), "rb").read()
               for pkg in opened}
    assert schemas["jax"] == schemas["port"]
    assert json.loads(schemas["port"])


def test_fields_same_writes_same_wal(tmp_path):
    """The same time, mutex and bool writes leave byte-equal WAL files in
    both packages: the time views' records, and the mutex imports' clears
    and sets in the JAX fragment's order."""
    d = {pkg: str(tmp_path / pkg) for pkg in ("jax", "port")}
    for pkg in d:
        _write_fields(pkg, d[pkg])

    def files(root, ext):
        out = {}
        for r, _, fs in os.walk(root):
            for fn in fs:
                if fn.endswith(ext):
                    p = os.path.join(r, fn)
                    out[os.path.relpath(p, root)] = open(p, "rb").read()
        return out

    wals = {pkg: files(d[pkg], ".wal") for pkg in d}
    assert wals["jax"] == wals["port"]
    assert sum(len(b) > 0 for b in wals["port"].values()) >= 6
    snaps = {pkg: files(d[pkg], ".snap") for pkg in d}
    assert snaps["jax"] == snaps["port"] and len(snaps["port"]) > 100


def test_time_counts_through_execute_async(mesh, monkeypatch):
    """Time-window Counts as ``execute_async`` futures, and as a held
    coalescer wave of one signature (the same window, other rows: one
    batched tree launch over each slot's view leaves, the wide tape cut
    slot by slot), answer as the JAX executor does."""
    rng = np.random.default_rng(6)
    n = 8000
    cols = rng.integers(0, 2 * SHARD_WIDTH, n, dtype=np.uint64)
    rows = rng.integers(0, 4, n).astype(np.uint64)
    stamps = [dt.datetime(2019, 1, 1) + dt.timedelta(hours=int(h))
              for h in rng.integers(0, 24 * 40, n)]
    q = Quad(mesh, {"t": TIME_YMDH})
    for h in (q.jh, q.th):
        h.field("i", "t").import_bits(rows, cols, stamps)
    texts = [f"Count(Row(t={r}, from='2019-01-03T05:00', to='2019-02-01T17:00'))"
             for r in range(4)]
    want = [j_json(q.jexecs[0].execute("i", t)) for t in texts]
    planned = q.texecs[1]
    assert [t_json(f.result(timeout=60)) for f in
            [planned.execute_async("i", t, cache=False) for t in texts]] == want
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_COALESCE", "on")
    co = planned.planner.coalescer
    co.hold()
    try:
        futs = [planned.execute_async("i", t, cache=False) for t in texts]
        d0 = planned.planner.dispatches
    finally:
        co.release()
    assert [t_json(f.result(timeout=60)) for f in futs] == want
    assert planned.planner.dispatches - d0 == 1
