"""The set-field slice of the port against the JAX package, end to end.

The same seeded ``import_bits`` data goes into a JAX ``Holder`` and a port
``Holder(device="cpu")``: 3 shards (a count that is not a power of two, so
the planner's stacks carry a zero pad row), dense rows (more than
``DENSE_CUTOFF`` bits in a shard) beside sparse ones. Every query runs
through both JAX executors (per-shard, and ``MeshPlanner`` over the CPU
mesh) and both port executors (per-shard, and ``Planner``), and the
``result_to_json`` of all four must be equal: exact, since every result is
a set of columns or integer counts.
"""

import numpy as np
import pytest

from pilosa_tpu.config import DENSE_CUTOFF, SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu_torch import interop
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.core import fragment as tfragment
from pilosa_tpu_torch.errors import NotPortedError
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner

N_SHARDS = 3
SEEDS = [0, 1, 2]

READ_QUERIES = [
    "Row(f=0)",
    "Row(g=1)",
    "Intersect(Row(f=0), Row(g=0))",
    "Union(Row(f=3), Row(g=1))",
    "Difference(Row(f=1), Row(g=0))",
    "Xor(Row(f=2), Row(f=4))",
    "Intersect(Row(f=0), Row(f=1), Row(g=0))",
    "Count(Row(f=0))",
    "Count(Row(f=9))",
    "Count(Intersect(Row(f=0), Row(g=0)))",
    "Count(Union(Row(f=1), Row(g=1)))",
    "Count(Difference(Row(f=2), Row(g=0)))",
    "Count(Xor(Row(f=0), Row(f=3)))",
    "Count(Union(Intersect(Row(f=0), Row(g=0)), Row(g=1)))",
    "TopN(f, n=5)",
    "TopN(f, Row(g=0), n=5)",
    "TopN(f, Row(g=1), n=3)",
    "TopN(f, ids=[0, 2, 4, 9])",
    "TopN(f, Row(g=0), ids=[1, 3, 5])",
    "TopN(f, n=4, threshold=300)",
    "TopN(f, Union(Row(g=0), Row(g=1)), threshold=2)",
]


def _bits(seed: int):
    """{field: (row_ids, column_ids)}: f rows 0-2 dense, 3-5 sparse; g row
    0 dense, row 1 sparse. Row 2 of f is dense in shard 0 only."""
    rng = np.random.default_rng(seed)
    dense = DENSE_CUTOFF + 4000
    out = {}
    for field, spec in (("f", {0: dense, 1: dense + 3000, 2: None,
                               3: 400, 4: 90, 5: 7}),
                        ("g", {0: 9 * dense, 1: 500})):
        rows, cols = [], []
        for rid, n in spec.items():
            for shard in range(N_SHARDS):
                k = n if n is not None else (dense if shard == 0 else 50)
                local = rng.choice(SHARD_WIDTH, size=k, replace=False)
                rows.append(np.full(k, rid, dtype=np.uint64))
                cols.append(local.astype(np.uint64) + np.uint64(shard * SHARD_WIDTH))
        out[field] = (np.concatenate(rows), np.concatenate(cols))
    return out


def _holders(bits):
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        idx = h.create_index("i")
        for field, (rows, cols) in bits.items():
            idx.create_field(field).import_bits(rows, cols)
    return jh, th


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def parity(request, mesh):
    jh, th = _holders(_bits(request.param))
    jexecs = [JExecutor(jh), JExecutor(jh, planner=MeshPlanner(jh, mesh))]
    texecs = [TExecutor(th), TExecutor(th, planner=Planner(th))]
    return jh, th, jexecs, texecs


def _answers(jexecs, texecs, query):
    """Every executor's result_to_json for ``query``; all must agree."""
    want = j_json(jexecs[0].execute("i", query))
    for e in jexecs[1:]:
        assert j_json(e.execute("i", query)) == want, "JAX executors disagree"
    return want, [t_json(e.execute("i", query)) for e in texecs]


def test_data_has_both_tiers(parity):
    _, th, _, _ = parity
    frag = th.fragment("i", "f", "standard", 1)
    assert frag.rows[0].is_dense and not frag.rows[3].is_dense
    assert th.fragment("i", "f", "standard", 0).rows[2].is_dense


@pytest.mark.parametrize("query", READ_QUERIES)
def test_read_parity(parity, query):
    _, _, jexecs, texecs = parity
    want, got = _answers(jexecs, texecs, query)
    for g in got:
        assert g == want


@pytest.mark.parametrize("seed", SEEDS)
def test_writes_parity(mesh, seed):
    """Set/Clear through every executor pair, then the reads again: each
    executor pair gets its own holders so writes do not compound."""
    bits = _bits(seed)
    # Rows 7 and 8 of f and 5 of g start empty, so the first eight
    # answers are known; the last two write into the dense rows.
    writes = ("Set(5, f=7) Set(5, f=7) Set({c}, f=7) Set(9, g=5) "
              "Clear(5, f=7) Clear(5, f=7) Clear(11, f=8) Set({c}, f=8) "
              "Set({c}, f=0) Clear(3, g=0)").format(c=2 * SHARD_WIDTH + 17)
    reads = ("Row(f=7) Count(Row(f=8)) Count(Row(g=5)) Count(Row(f=0)) "
             "TopN(f, n=3) TopN(f, Row(g=0), n=3)")
    results = []
    for planned in (False, True):
        jh, th = _holders(bits)
        je = JExecutor(jh, planner=MeshPlanner(jh, mesh) if planned else None)
        te = TExecutor(th, planner=Planner(th) if planned else None)
        want = j_json(je.execute("i", writes)) + j_json(je.execute("i", reads))
        got = t_json(te.execute("i", writes)) + t_json(te.execute("i", reads))
        assert got == want
        assert want[:8] == [True, False, True, True, True, False, False, True]
        results.append(got)
    assert results[0] == results[1]


def test_topn_streams_zero_padded_tiles(parity, monkeypatch):
    """Shrink the port's stack cut-off and tile so the 3 dense rows of f
    in shard 0 stream as [2, W] tiles, the last one zero-padded (and, with
    the planner, device-resident): the counts still match the JAX
    package."""
    _, _, jexecs, texecs = parity
    monkeypatch.setattr(tfragment, "STACK_CACHE_MAX_ROWS", 1)
    monkeypatch.setattr(tfragment, "ROW_TILE", 2)
    for q in ("TopN(f, Row(g=0), n=5)", "TopN(f, Row(g=1), ids=[0, 1, 2])"):
        want, got = _answers(jexecs, texecs, q)
        for g in got:
            assert g == want


def test_interop_load_fragment_words(parity):
    """JAX ``row_words`` handed over through ``interop``: every row is
    byte-equal in the port, and queries give the same answers."""
    jh, _, jexecs, _ = parity
    th = THolder(device="cpu")
    for field in ("f", "g"):
        for shard in range(N_SHARDS):
            jfrag = jh.fragment("i", field, "standard", shard)
            ids = sorted(jfrag.rows)
            interop.load_fragment_words(
                th, "i", field, shard, ids,
                np.stack([jfrag.row_words(r) for r in ids]))
    for field in ("f", "g"):
        for shard in range(N_SHARDS):
            jfrag = jh.fragment("i", field, "standard", shard)
            tfrag = th.fragment("i", field, "standard", shard)
            assert sorted(tfrag.rows) == sorted(jfrag.rows)
            for r in jfrag.rows:
                assert tfrag.row_words(r).tobytes() == jfrag.row_words(r).tobytes()
    texecs = [TExecutor(th), TExecutor(th, planner=Planner(th))]
    for q in ("Count(Intersect(Row(f=0), Row(g=0)))", "TopN(f, Row(g=0), n=5)",
              "Xor(Row(f=1), Row(g=1))"):
        want, got = _answers(jexecs, texecs, q)
        for g in got:
            assert g == want


def test_interop_refuses_bad_words():
    th = THolder(device="cpu")
    with pytest.raises(TypeError):
        interop.load_fragment_words(th, "i", "f", 0, [1],
                                    np.zeros((1, 8), dtype=np.int64))
    with pytest.raises(ValueError):
        interop.load_fragment_words(th, "i", "f", 0, [1, 2],
                                    np.zeros((1, 8), dtype=np.uint32))


def test_cpu_queries_launch_no_kernel(parity):
    _, _, _, texecs = parity
    kernels.reset_launches()
    for e in texecs:
        e.execute("i", "Count(Intersect(Row(f=0), Row(g=0))) TopN(f, Row(g=0), n=2)")
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("query", [
    "MinRow(field=f)", "Range(f=0)", "GroupBy(Rows(f))",
    "Row(f=0, from='2020-01-01T00:00', to='2021-01-01T00:00')",
])
@pytest.mark.parametrize("planned", [False, True], ids=["shards", "planner"])
def test_later_slices_raise(parity, query, planned):
    _, _, _, texecs = parity
    with pytest.raises(NotPortedError, match="ROADMAP.md"):
        texecs[int(planned)].execute("i", query)


def test_planner_stack_cache_follows_writes():
    """Leaf stacks are [S_pad, W] with zero pad rows, cached across
    queries, kept when a write touches another field (epoch moved,
    generations not), and rebuilt when a write touches the leaf."""
    _, th = _holders(_bits(3))
    th.index("i").create_field("h")
    planner = Planner(th)
    planned, per_shard = TExecutor(th, planner=planner), TExecutor(th)
    q = "Count(Intersect(Row(f=0), Row(g=0)))"
    (first,) = planned.execute("i", q)
    assert planned.execute("i", q) == [first] == per_shard.execute("i", q)
    assert planner.uploads == 2
    stacks = [ent[2] for ent in planner._stack_cache.values()]
    assert [tuple(s.shape) for s in stacks] == [(4, SHARD_WIDTH // 32)] * 2
    assert all(int(s[3].abs().sum()) == 0 for s in stacks)

    planned.execute("i", "Set(5, h=1)")
    assert planned.execute("i", q) == [first] and planner.uploads == 2

    col = next(c for c in range(SHARD_WIDTH)
               if th.fragment("i", "g", "standard", 0).rows[0].contains(c)
               and not th.fragment("i", "f", "standard", 0).rows[0].contains(c))
    assert planned.execute("i", f"Set({col}, f=0)") == [True]
    assert planned.execute("i", q) == [first + 1] == per_shard.execute("i", q)
    assert planner.uploads == 3
