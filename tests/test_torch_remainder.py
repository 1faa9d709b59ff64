"""The executor remainder of the port against the JAX package, end to end:
``Not``, ``Shift``, ``Rows``, ``Store``, ``ClearRow``, ``Options``, row and
column attrs, TopN's ``threshold``/``attrName``/``tanimotoThreshold``, and
mixed trees that the planner takes in part (a negative ``Shift`` kept on
the host as a ``__const__`` leaf).

The data is tests/test_torch_executor.py's (3 shards, dense and sparse
rows, 3 seeds) plus an existence row (every column with a bit, and more)
and an empty field. Every query runs through both JAX executors
(per-shard, and ``MeshPlanner`` over the CPU mesh) and both port executors
(per-shard, and ``Planner``), and the ``result_to_json`` of all four must
be equal -- exact; an error must be the same type name and message. The
cases follow tests/test_executor.py:95-330.
"""

import numpy as np
import pytest

from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.index import IndexOptions as JIndexOptions
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.index import IndexOptions as TIndexOptions
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner
from test_torch_executor import N_SHARDS, SEEDS, _bits

SW = SHARD_WIDTH

READ_QUERIES = [
    # Not (existence row 0 minus the child)
    "Not(Row(f=0))", "Not(Union(Row(f=1), Row(g=1)))", "Count(Not(Row(f=3)))",
    "Count(Not(Intersect(Row(f=0), Row(g=0))))", "Intersect(Not(Row(f=0)), Row(g=1))",
    "Count(Not(Not(Row(f=4))))", "Not(Row(f=9))",
    # Shift at the word and shard edges, inside trees
    "Shift(Row(f=3), n=1)", "Shift(Row(f=4), n=0)", "Shift(Row(f=5))",
    "Count(Shift(Row(f=0), n=31))", "Count(Shift(Row(f=1), n=32))",
    "Count(Shift(Row(g=0), n=33))", "Count(Shift(Row(f=0), n=1000))",
    f"Count(Shift(Row(f=0), n={SW - 1}))", f"Count(Shift(Row(f=0), n={SW}))",
    "Count(Intersect(Shift(Row(f=0), n=33), Row(g=0)))", "Shift(Not(Row(g=1)), n=7)",
    "Count(Not(Shift(Row(f=2), n=5)))", "Count(Shift(Shift(Row(f=1), n=3), n=40))",
    # 3+ leaves, duplicate leaves: one tree on the planner
    "Count(Intersect(Row(f=0), Row(f=1), Row(g=0)))",
    "Count(Xor(Union(Row(f=0), Row(g=1)), Difference(Row(f=1), Row(f=0)), Row(g=0)))",
    "Union(Intersect(Row(f=2), Row(g=0)), Xor(Row(f=3), Row(f=4)), Row(f=5))",
    "Count(Intersect(Row(f=0), Row(f=0)))", "Count(Difference(Row(g=0), Row(g=0)))",
    # mixed trees: a negative Shift stays on the host (a __const__ leaf)
    "Count(Union(Shift(Row(e=1), n=-1), Row(g=1)))",
    "Union(Shift(Row(e=1), n=-1), Intersect(Row(f=0), Row(g=0)))",
    "Count(Union(Shift(Row(f=3), n=-1), Row(g=1)))",
    # Rows
    "Rows(f)", "Rows(f, previous=1)", "Rows(f, limit=2)", "Rows(f, previous=2, limit=2)",
    f"Rows(f, column={SW + 5})", "Rows(g)", "Rows(e)", "Rows(f, column=3, limit=1)",
    # Options
    "Options(Row(f=0), shards=[0, 2])", "Options(Count(Row(f=0)), shards=[1])",
    "Options(Row(f=3), excludeColumns=true)", "Options(Rows(f), shards=[0])",
    "Options(Row(f=4), excludeRowAttrs=true)", "Options(Count(Not(Row(f=0))), shards=[2])",
    "Options(Row(f=0), shards=[0], shards2=[1])",
    # TopN threshold and tanimoto
    "TopN(f, threshold=400)", "TopN(f, Row(g=0), n=4, threshold=100)",
    "TopN(f, Row(g=0), n=5, tanimotoThreshold=1)",
    "TopN(f, Row(g=1), tanimotoThreshold=2)", "TopN(f, Not(Row(g=0)), n=3)",
    "TopN(f, Shift(Row(g=0), n=1), n=3)", "TopN(f, Row(g=0), tanimotoThreshold=101)",
    "TopN(f, n=2, attrName=x, attrValues=[1])",
    # errors
    "Not(Row(f=0), Row(g=0))", "Shift(Row(f=0), Row(g=0), n=1)", "Rows()",
    "Options(Row(f=0), columnAttrs=1)", "Options(Row(f=0), Row(g=0))",
    "ClearRow(v=1)", "Store(Row(f=0), v=1)", "Store(Row(v > 0), v=1)", "Store(f=3)",
    "TopN(v)",
]

WRITES = ('SetRowAttrs(f, 3, color="blue", weight=3) SetRowAttrs(f, 4, color="red") '
          'SetRowAttrs(f, 4, weight=7) SetColumnAttrs(9, name="bob") '
          'Store(Intersect(Row(f=0), Row(g=0)), f=7) ClearRow(f=5) ClearRow(f=5) '
          'Store(Not(Row(f=1)), g=8) Store(Shift(Row(f=4), n=3), f=4) ClearRow(g=1)')
READS = ('Row(f=3) Row(f=4) Row(f=7) Count(Row(f=7)) Count(Row(f=5)) Count(Row(g=8)) '
         'Count(Row(g=1)) TopN(f, attrName="color", attrValues=["blue"]) '
         'TopN(f, Row(g=0), n=3, attrName="color", attrValues=["blue", "red"]) '
         'TopN(f, n=2, attrName="weight", attrValues=[7]) '
         'Options(Row(f=3), excludeRowAttrs=true) Rows(f) Rows(g) '
         'Options(Row(f=4), columnAttrs=true) Row(g=8)')


def _holders(seed, track_existence=True):
    """JAX and port holders with the executor tests' bits, an int field,
    an empty field ``e``, and the existence row: every column with a bit
    plus 2,000 more per shard."""
    bits = _bits(seed)
    rng = np.random.default_rng(seed + 100)
    extra = np.concatenate([rng.choice(SW, 2000, replace=False) + s * SW
                            for s in range(N_SHARDS)]).astype(np.uint64)
    exists = np.unique(np.concatenate([c for _, c in bits.values()] + [extra]))
    out = []
    for H, FO, IO in ((JHolder, JFieldOptions, JIndexOptions),
                      (lambda: THolder(device="cpu"), TFieldOptions, TIndexOptions)):
        h = H()
        idx = h.create_index("i", IO(track_existence=track_existence))
        for field, (rows, cols) in bits.items():
            idx.create_field(field).import_bits(rows, cols)
        idx.create_field("e")
        idx.create_field("v", FO(type="int", min=-100, max=100))
        if track_existence:
            idx.add_existence(exists)
        out.append(h)
    return out


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _execs(jh, th, mesh):
    return ([JExecutor(jh), JExecutor(jh, planner=MeshPlanner(jh, mesh))],
            [TExecutor(th), TExecutor(th, planner=Planner(th))])


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def parity(request, mesh):
    jh, th = _holders(request.param)
    return _execs(jh, th, mesh)


def _run(execute, to_json, query):
    """result_to_json of the query, or (error type name, message)."""
    try:
        return to_json(execute("i", query))
    except Exception as e:  # the same error from every executor
        return (type(e).__name__, str(e))


#: queries whose two JAX executors answer differently (ROADMAP.md Queue
#: 3): each port executor must answer as its JAX counterpart does.
JAX_SPLIT = {"Shift(Row(f=0), Row(g=0), n=1)"}


def _answers(jexecs, texecs, query):
    """(JAX answers, port answers), per-shard then planner; the JAX
    executors agree unless the query is in JAX_SPLIT."""
    want = [_run(e.execute, j_json, query) for e in jexecs]
    assert (want[0] == want[1]) != (query in JAX_SPLIT), "JAX executors"
    return want, [_run(e.execute, t_json, query) for e in texecs]


@pytest.mark.parametrize("query", READ_QUERIES)
def test_read_parity(parity, query):
    jexecs, texecs = parity
    want, got = _answers(jexecs, texecs, query)
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_writes_parity(mesh, seed):
    """Attrs, Store and ClearRow through every executor pair on holders of
    its own, then the reads; the rows left behind are byte-equal."""
    results = []
    for planned in (False, True):
        jh, th = _holders(seed)
        je = JExecutor(jh, planner=MeshPlanner(jh, mesh) if planned else None)
        te = TExecutor(th, planner=Planner(th) if planned else None)
        want = j_json(je.execute("i", WRITES)) + j_json(je.execute("i", READS))
        got = t_json(te.execute("i", WRITES)) + t_json(te.execute("i", READS))
        assert got == want
        assert want[:10] == [None, None, None, None, True, True, False, True, True,
                             True]
        assert want[10]["attrs"] == {"color": "blue", "weight": 3}
        for field in ("f", "g"):
            for shard in range(N_SHARDS):
                jf = jh.fragment("i", field, "standard", shard)
                tf = th.fragment("i", field, "standard", shard)
                assert sorted(tf.rows) == sorted(jf.rows)
                for r in jf.rows:
                    assert (tf.row_words(r).tobytes()
                            == jf.row_words(r).tobytes()), (field, shard, r)
        assert (th.index("i").column_attr_store.attrs(9)
                == jh.index("i").column_attr_store.attrs(9) == {"name": "bob"})
        results.append(got)
    assert results[0] == results[1]


@pytest.mark.parametrize("planned", [False, True], ids=["shards", "planner"])
def test_not_requires_existence(mesh, planned):
    jh, th = _holders(0, track_existence=False)
    jexecs, texecs = _execs(jh, th, mesh)
    for q in ("Not(Row(f=0))", "Count(Not(Row(f=0)))"):
        want = _run(jexecs[int(planned)].execute, j_json, q)
        assert want[0] == "QueryError"
        assert _run(texecs[int(planned)].execute, t_json, q) == want


def test_options_sets_column_attrs_on_the_outer_options(mesh):
    """Options(columnAttrs=true) changes the caller's ExecOptions in place
    (the reference's quirk, which turns on the response's columnAttrs)."""
    from pilosa_tpu.exec.executor import ExecOptions as JExecOptions
    from pilosa_tpu_torch.exec import ExecOptions as TExecOptions

    jh, th = _holders(1)
    jexecs, texecs = _execs(jh, th, mesh)
    for ex, opt_cls in ((jexecs[1], JExecOptions), (texecs[1], TExecOptions)):
        opt = opt_cls()
        ex.execute("i", "Options(Count(Row(f=0)), columnAttrs=true)", opt=opt)
        assert opt.column_attrs is True


def test_mixed_tree_fuses_its_plannable_part(mesh, monkeypatch):
    """A tree with a negative Shift: the planner takes the rest of it with
    the host-evaluated subtree as a const leaf, and with fusion off the
    whole tree runs shard by shard; the same answer either way."""
    jh, th = _holders(2)
    jexecs, texecs = _execs(jh, th, mesh)
    q = "Count(Union(Shift(Row(e=1), n=-1), Intersect(Row(f=0), Row(g=0))))"
    want, got = _answers(jexecs, texecs, q)
    assert got == want and want[0] == want[1]
    want = want[0]
    planner = texecs[1].planner
    calls = []
    orig = planner.execute_count
    monkeypatch.setattr(planner, "execute_count",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    assert texecs[1].execute("i", q, cache=False) == want
    assert calls and calls[0].get("const_rows") is not None
    calls.clear()
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_FUSE", "off")
    assert texecs[1].execute("i", q, cache=False) == want
    assert not calls


def test_planner_counts_through_one_tape(mesh, monkeypatch):
    """On the planner a 3+-leaf Count is one tree_count call, a 2-leaf op
    one pair_count, a bare leaf one row_counts; Not adds the existence
    leaf; a Shift shifts its child's plane with shift_left."""
    _, th = _holders(0)
    ex = TExecutor(th, planner=Planner(th), result_cache=False)
    seen = []
    for name in ("tree_count", "pair_count", "row_counts", "shift_left"):
        orig = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _n=name, _o=orig, **k: (
            seen.append(_n), _o(*a, **k))[1])
    for q, want in (("Count(Intersect(Row(f=0), Row(f=1), Row(g=0)))", ["tree_count"]),
                    ("Count(Not(Row(f=0)))", ["pair_count"]),
                    ("Count(Row(f=1))", ["row_counts"]),
                    ("Count(Shift(Row(f=1), n=3))", ["shift_left", "row_counts"]),
                    ("Count(Intersect(Shift(Row(f=0), n=33), Row(g=0)))",
                     ["shift_left", "pair_count"]),
                    ("Count(Union(Not(Row(f=0)), Row(g=1)))", ["tree_count"])):
        seen.clear()
        ex.execute("i", q)
        assert seen == want, q


def test_plan_cache_and_observed_traffic():
    """A repeated Count reuses its prepared plan; a schema change misses;
    the executable text lands in observed_traffic for warmup to replay."""
    _, th = _holders(0)
    planner = Planner(th)
    ex = TExecutor(th, planner=planner, result_cache=False)
    q = "Count(Intersect(Row(f=0), Row(g=0), Row(f=1)))"
    (first,) = ex.execute("i", q)
    assert len(planner._plan_cache) == 1
    walks = []
    orig = planner._signature
    planner._signature = lambda *a: walks.append(1) or orig(*a)
    assert ex.execute("i", q) == [first]
    assert not walks
    th.index("i").create_field("z")  # schema epoch moves
    assert ex.execute("i", q) == [first]
    assert walks
    observed = planner.observed_traffic()
    assert {"index": "i", "query": f"Count({ex._parse_cached(q).calls[0].children[0]})",
            "shards": N_SHARDS, "count": 2} in observed
    planner.drop_index("i")
    assert not planner._plan_cache and not planner._stack_cache
