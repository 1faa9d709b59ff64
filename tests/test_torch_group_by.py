"""GroupBy: the port against the JAX package on the CPU, exact.

- Both port executors (per-shard walk, ``Planner`` lattice) against both
  JAX executors on the cases of tests/test_executor.py (filter, limit,
  previous cursors, a non-Rows child) and tests/test_core.py (a last level
  of many rows), and on seeded fields over 3 shards: two and three levels,
  filters, ``limit``/``offset``, cursors, ``Rows`` children with ``limit``
  or ``column``, a time field child. The JAX executors page a GroupBy with
  ``limit`` differently (the per-shard walk stops each shard at ``limit``
  before the offset); each port executor is held to its counterpart there.
- ``group_count_plain`` (the plain version of the lattice kernel, given
  the level sizes) against the JAX planner's ``execute_group_by`` on
  seeded words with all-ones and bit-31 words and a pow2 pad row, with 1
  to 5 levels and a level of one row in the middle, with and without a
  filter; and against each group's AND spelled out in numpy, up to 16
  levels (8192 groups).
- Wide lattices at 2 shards (450 rows in one level; 12 x 40) are ONE
  ``group_count`` call, equal to both JAX executors.
- Lattices past ``GROUP_BY_MAX_PAIRS`` groups, or past the stacks' memory
  cap, take the per-shard path in both packages.
"""

import itertools

import numpy as np
import pytest
import torch

from pilosa_tpu.config import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu.core import FieldOptions as JFieldOptions
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu.pql import parse as j_parse
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.errors import QueryError
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner

N_SHARDS = 3


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(autouse=True)
def _dense_jax_leaves(monkeypatch):
    """The JAX planner's stacks in the dense class, the port's only one."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "off")


def _quad(mesh, bits: dict, options: dict | None = None, planner_kw=None):
    """(JAX executors, port executors) over the same imported bits."""
    jh, th = JHolder(), Holder(device="cpu")
    for h, opts_cls in ((jh, JFieldOptions), (th, FieldOptions)):
        idx = h.create_index("i")
        for name, (rows, cols) in bits.items():
            opts = (options or {}).get(name)
            f = idx.create_field(name, opts_cls.from_json(opts) if opts else None)
            f.import_bits(rows, cols)
    kw = planner_kw or {}
    return ([JExecutor(jh), JExecutor(jh, planner=MeshPlanner(jh, mesh, **kw))],
            [Executor(th), Executor(th, planner=Planner(th, **kw))])


def _check(execs, query, split=False):
    jexecs, texecs = execs
    jans = [j_json(e.execute("i", query)) for e in jexecs]
    tans = [t_json(e.execute("i", query)) for e in texecs]
    if split:
        assert tans == jans
    else:
        assert jans[0] == jans[1], "JAX executors disagree"
        assert tans == [jans[0]] * 2
    return jans[0][0]


def _groups(result):
    return {tuple(fr["rowID"] for fr in g["group"]): g["count"] for g in result}


# -- the cases of tests/test_executor.py and tests/test_core.py --------------


def test_group_by(mesh):
    ex = _quad(mesh, {"a": ([0, 0, 0, 1, 1], [0, 1, 2, 1, 2]),
                      "b": ([0, 0, 1], [0, 1, 2])})
    got = _check(ex, "GroupBy(Rows(a), Rows(b))")
    assert _groups(got) == {(0, 0): 2, (0, 1): 1, (1, 0): 1, (1, 1): 1}


def test_group_by_filter_and_limit(mesh):
    ex = _quad(mesh, {"a": ([0, 0, 1], [0, 1, 1]), "b": ([0, 0], [0, 1])})
    got = _check(ex, "GroupBy(Rows(a), Rows(b), filter=Row(a=0))")
    assert _groups(got) == {(0, 0): 2, (1, 0): 1}
    got = _check(ex, "GroupBy(Rows(a), Rows(b), limit=1)")
    assert len(got) == 1 and got[0]["count"] == 2


def test_group_by_previous(mesh):
    ex = _quad(mesh, {"a": ([0, 1], [0, 0]), "b": ([0, 1], [0, 0])})
    got = _check(ex, "GroupBy(Rows(a, previous=0), Rows(b, previous=0))")
    assert list(_groups(got)) == [(0, 1), (1, 0), (1, 1)]


def test_group_by_rejects_non_rows_child(mesh):
    ex = _quad(mesh, {"a": ([1], [1])})
    for e in ex[1]:
        with pytest.raises(QueryError, match="not a valid child"):
            e.execute("i", "GroupBy(Row(a=1))")
        with pytest.raises(QueryError, match="at least one child"):
            e.execute("i", "GroupBy()")


def test_group_by_many_last_level_rows(mesh):
    """tests/test_core.py test_group_by_streams_row_tiles' data: one a row
    over 80 columns, b row r = {column r}."""
    n = 80
    cols = list(range(n))
    ex = _quad(mesh, {"a": ([0] * n, cols), "b": (cols, cols)})
    assert len(_check(ex, "GroupBy(Rows(a), Rows(b))")) == n


# -- seeded fields over 3 shards ---------------------------------------------


def _seeded_bits(seed: int):
    """a (4 rows), b (8 rows), c (3 rows) and g (a filter row) over 3
    shards, dense and sparse rows, and t (a time field's standard view)."""
    rng = np.random.default_rng(seed)
    n_cols = N_SHARDS * SHARD_WIDTH
    out = {}
    for name, n_rows, n in (("a", 4, 60000), ("b", 8, 9000), ("c", 3, 40000),
                            ("g", 1, 300000)):
        out[name] = (rng.integers(0, n_rows, n).astype(np.uint64),
                     rng.integers(0, n_cols, n, dtype=np.uint64))
    cols = out["a"][1][:500]
    out["t"] = (np.ones(500, dtype=np.uint64), cols)
    return out


@pytest.fixture(scope="module", params=[0, 1], ids=lambda s: f"seed{s}")
def seeded(request, mesh):
    return _quad(mesh, _seeded_bits(request.param),
                 options={"t": {"type": "time", "timeQuantum": "YMD"}})


PLANNED_QUERIES = [
    "GroupBy(Rows(a))",
    "GroupBy(Rows(a), Rows(b))",
    "GroupBy(Rows(b), Rows(a))",
    "GroupBy(Rows(a), Rows(b), filter=Row(g=0))",
    "GroupBy(Rows(a), Rows(b), Rows(c))",
    "GroupBy(Rows(a), Rows(b), Rows(c), filter=Intersect(Row(g=0), Row(c=1)))",
    "GroupBy(Rows(a), Rows(b), offset=5)",
    "GroupBy(Rows(a), Rows(b), offset=500)",
    "GroupBy(Rows(a), Rows(a))",
    "GroupBy(Rows(field=b), Rows(c), filter=Row(g=9))",
    "Options(GroupBy(Rows(a), Rows(b)), shards=[0, 2])",
]

PER_SHARD_QUERIES = [
    "GroupBy(Rows(a, previous=1), Rows(b, previous=3))",
    "GroupBy(Rows(a, previous=2), Rows(b, previous=7), Rows(c, previous=0))",
    "GroupBy(Rows(a, previous=9), Rows(b))",
    "GroupBy(Rows(a), Rows(b, previous=5), filter=Row(g=0))",
    "GroupBy(Rows(a, limit=2), Rows(b))",
    f"GroupBy(Rows(a), Rows(b, column={SHARD_WIDTH + 17}))",
    "GroupBy(Rows(a), Rows(b, limit=3), filter=Row(g=0))",
    "GroupBy(Rows(a), Rows(t))",
    "GroupBy(Rows(a), Rows(t, from='2020-01-01T00:00', to='2021-01-01T00:00'))",
]


@pytest.mark.parametrize("query", PLANNED_QUERIES + PER_SHARD_QUERIES)
def test_group_by_parity(seeded, query):
    assert _check(seeded, query) is not None


@pytest.mark.parametrize("query", [
    "GroupBy(Rows(a), Rows(b), limit=5)",
    "GroupBy(Rows(a), Rows(b), limit=4, offset=3)",
    "GroupBy(Rows(a), Rows(b), Rows(c), limit=7, offset=20)",
    "GroupBy(Rows(a, previous=1), Rows(b, previous=3), limit=5)",
    "GroupBy(Rows(a), Rows(b, previous=2), limit=6, offset=1)",
])
def test_group_by_paging_parity(seeded, query):
    """``limit`` pages each executor its own way in the JAX package (the
    per-shard walk stops each shard at the limit before the offset
    applies): each port executor answers as its counterpart."""
    _check(seeded, query, split=True)


def test_planner_group_by_is_one_lattice(seeded, monkeypatch):
    """A planner GroupBy makes one group_count call over the levels'
    stacks; a cursor query makes none (the per-shard walk)."""
    calls = []
    real = kernels.group_count

    def spy(planes, sizes, filt=None):
        calls.append((len(planes), tuple(sizes), filt is not None))
        return real(planes, sizes, filt)

    monkeypatch.setattr(kernels, "group_count", spy)
    texec = seeded[1][1]
    texec.execute("i", "GroupBy(Rows(a), Rows(b), filter=Row(g=0))", cache=False)
    assert calls == [(12, (4, 8), True)]
    texec.execute("i", "GroupBy(Rows(a), Rows(b), Rows(c))", cache=False)
    assert calls[1] == (15, (4, 8, 3), False)
    texec.execute("i", "GroupBy(Rows(a, previous=1), Rows(b))", cache=False)
    assert len(calls) == 2


@pytest.mark.parametrize("sizes", [(450,), (12, 40)], ids=["450rows", "12x40"])
def test_wide_lattice_parity(mesh, monkeypatch, sizes):
    """Wide lattices over 2 shards, where the stack cap admits hundreds of
    planes (on the card group_count then reads them from device memory,
    unstaged): ONE group_count call over every candidate row, the answer
    equal to both JAX executors'."""
    rng = np.random.default_rng(len(sizes))
    names = "wxy"[:len(sizes)]
    bits = {name: (rng.integers(0, n, 20000).astype(np.uint64),
                   rng.integers(0, 2 * SHARD_WIDTH, 20000, dtype=np.uint64))
            for name, n in zip(names, sizes)}
    ex = _quad(mesh, bits)
    calls = []
    real = kernels.group_count

    def spy(planes, sizes, filt=None):
        calls.append((len(planes), tuple(sizes)))
        return real(planes, sizes, filt)

    monkeypatch.setattr(kernels, "group_count", spy)
    query = "GroupBy({})".format(", ".join(f"Rows({n})" for n in names))
    got = _check(ex, query)
    assert calls == [(sum(sizes), sizes)]
    assert got


# -- group_count_plain against the JAX planner's lattice ----------------------


def _words(rng, n_rows: int) -> np.ndarray:
    """[n_rows, N_SHARDS, W] uint32 words: random, with all-ones, bit-31
    and zero words mixed in, and a whole all-ones row and a zero row."""
    w = rng.integers(0, 2**32, size=(n_rows, N_SHARDS, WORDS_PER_SHARD), dtype=np.uint32)
    w &= rng.integers(0, 2**32, size=w.shape, dtype=np.uint32)
    flat = w.reshape(-1)
    flat[::97] = 0xFFFFFFFF
    flat[5::89] = 0x80000000
    flat[11::83] = 0
    w[0, 1] = 0xFFFFFFFF
    if n_rows > 1:
        w[1, 2] = 0
    return w


@pytest.mark.parametrize("sizes,filtered", [
    ((5,), False), ((5,), True), ((4, 3), False), ((4, 3), True), ((3, 2, 3), True),
    ((3, 1, 4), False), ((3, 1, 4), True),  # a level of one row in the middle
    ((2, 3, 2, 2), False), ((2, 3, 2, 2), True),  # 4 levels
    ((2, 2, 1, 2, 3), False), ((2, 2, 1, 2, 3), True)])  # 5 levels
def test_group_count_plain_matches_jax_lattice(mesh, sizes, filtered):
    rng = np.random.default_rng(sum(sizes) * 7 + filtered)
    fields = [f"l{i}" for i in range(len(sizes))]
    words = {f: _words(rng, n) for f, n in zip(fields, sizes)}
    fwords = _words(rng, 1)[0]
    jh = JHolder()
    idx = jh.create_index("i")
    for f in fields + ["g"]:
        idx.create_field(f)
    for f, w in list(words.items()) + [("g", fwords[None])]:
        view = jh.field("i", f).create_view_if_not_exists("standard")
        for s in range(N_SHARDS):
            frag = view.create_fragment_if_not_exists(s)
            for r in range(w.shape[0]):
                frag.merge_row_words(r, w[r, s].copy())
    planner = MeshPlanner(jh, mesh)
    cands = [list(range(n)) for n in sizes]
    filt_call = j_parse("Row(g=0)").calls[0] if filtered else None
    want = planner.execute_group_by(idx, fields, cands, list(range(N_SHARDS)), filt_call)

    s_pad = 4  # 3 shards in a pow2 stack: one zero pad row
    def stack(w):
        out = np.zeros((s_pad, WORDS_PER_SHARD), dtype=np.uint32)
        out[:N_SHARDS] = w
        return torch.from_numpy(out.view(np.int32))

    planes = [stack(words[f][r]) for f, n in zip(fields, sizes) for r in range(n)]
    filt = stack(fwords) if filtered else None
    counts = kernels.group_count_plain(planes, sizes, filt)
    assert counts.dtype == torch.int64 and counts.shape == (int(np.prod(sizes)),)
    got = [(g, int(c)) for g, c in zip(itertools.product(*cands), counts.tolist()) if c > 0]
    assert got == [(tuple(g), c) for g, c in want]
    # The wrapper takes the plain version for CPU tensors.
    assert torch.equal(kernels.group_count(planes, sizes, filt), counts)


def _lattice_oracle(planes: np.ndarray, sizes, filt) -> np.ndarray:
    """Each group's AND over its levels' rows (and the filter), counted per
    row and summed: the lattice spelled out group by group in numpy."""
    first = np.cumsum([0] + list(sizes[:-1]))
    out = []
    for group in itertools.product(*[range(n) for n in sizes]):
        acc = np.full(planes.shape[1:], 0xFFFFFFFF, dtype=np.uint32) if filt is None else filt
        for f, r in zip(first, group):
            acc = acc & planes[f + r]
        out.append(int(np.unpackbits(acc.view(np.uint8)).sum()))
    return np.asarray(out, dtype=np.int64)


@pytest.mark.parametrize("sizes", [
    (7,), (1,), (2, 1), (1, 3), (3, 1, 2), (2, 2, 2, 2),
    (2, 1, 2, 2, 1, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 2),  # 16 levels, 8192 groups
], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("filtered", [False, True], ids=["nofilt", "filt"])
def test_group_count_plain_walks_the_product(sizes, filtered):
    """The plain version's prefix-tree walk against every group's AND
    spelled out: levels of one row anywhere, 16 levels, with and without a
    filter, zero pad rows and all-ones words in the planes."""
    rng = np.random.default_rng(len(sizes) * 31 + sum(sizes) + filtered)
    n_rows = 4 if len(sizes) < 16 else 2
    planes = rng.integers(0, 2**32, size=(sum(sizes), n_rows, 6), dtype=np.uint32)
    planes |= rng.integers(0, 2**32, size=planes.shape, dtype=np.uint32)  # dense enough
    planes[:, -1] = 0  # a pad row
    planes[0, 0] = 0xFFFFFFFF
    filt = rng.integers(0, 2**32, size=(n_rows, 6), dtype=np.uint32) if filtered else None
    t = [torch.from_numpy(x.view(np.int32)) for x in planes]
    tf = None if filt is None else torch.from_numpy(filt.view(np.int32))
    got = kernels.group_count_plain(t, sizes, tf)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _lattice_oracle(planes, sizes, filt))


def _p(n=3, rows=2, words=8, dtype=torch.int32):
    return [torch.zeros((rows, words), dtype=dtype) for _ in range(n)]


@pytest.mark.parametrize("case", [
    "17 levels", "sizes off the planes", "negative size", "float sizes", "float tensor",
    "mismatched planes", "mismatched filter", "int64 planes", "zero groups"])
def test_group_count_wrapper_checks(case):
    """What the wrapper refuses, and a level of no rows (no groups)."""
    p = _p()
    if case == "17 levels":
        with pytest.raises(ValueError, match="at most 16 levels"):
            kernels.group_count(_p(17), [1] * 17)
    elif case == "sizes off the planes":
        with pytest.raises(ValueError, match="must sum to the 3 planes"):
            kernels.group_count(p, [2, 2])
    elif case == "negative size":
        with pytest.raises(ValueError, match="must not be negative"):
            kernels.group_count(p, [4, -1])
    elif case == "float sizes":
        with pytest.raises(TypeError, match="integers"):
            kernels.group_count(p, [1.0, 2.0])
    elif case == "float tensor":
        with pytest.raises(TypeError, match="integers"):
            kernels.group_count(p, torch.tensor([1.0, 2.0]))
    elif case == "mismatched planes":
        with pytest.raises(ValueError, match="plane 1"):
            kernels.group_count([p[0], torch.zeros((3, 8), dtype=torch.int32)], [1, 1])
    elif case == "mismatched filter":
        with pytest.raises(ValueError, match="filt"):
            kernels.group_count(p, [1, 2], torch.zeros((2, 4), dtype=torch.int32))
    elif case == "int64 planes":
        with pytest.raises(TypeError):
            kernels.group_count(_p(1, dtype=torch.int64), [1])
    else:
        got = kernels.group_count(p, [0, 3])
        assert got.shape == (0,) and got.dtype == torch.int64
        assert kernels.group_count(p, np.asarray([3])).shape == (3,)


# -- the planner's caps: the per-shard path in both packages ------------------


def test_lattice_past_max_pairs_takes_the_per_shard_path(mesh, monkeypatch):
    """100 x 100 rows (10,000 groups > GROUP_BY_MAX_PAIRS): both planners
    decline, both executors walk the shards, and the answers agree."""
    n = 100
    rng = np.random.default_rng(9)
    cols = rng.integers(0, 2 * SHARD_WIDTH, 3000, dtype=np.uint64)
    bits = {"a": (rng.integers(0, n, 3000).astype(np.uint64), cols),
            "b": (rng.integers(0, n, 3000).astype(np.uint64), cols[::-1].copy())}
    ex = _quad(mesh, bits)
    declined = []
    real_j = MeshPlanner.execute_group_by

    def j_spy(self, *a, **k):
        out = real_j(self, *a, **k)
        declined.append(out is None)
        return out

    monkeypatch.setattr(MeshPlanner, "execute_group_by", j_spy)
    monkeypatch.setattr(kernels, "group_count", lambda *a, **k: pytest.fail("launched"))
    assert Planner.GROUP_BY_MAX_PAIRS == MeshPlanner.GROUP_BY_MAX_PAIRS == 8192
    got = _check(ex, "GroupBy(Rows(a), Rows(b))")
    assert declined == [True] and len(got) > 100


def test_lattice_past_the_stack_cap_takes_the_per_shard_path(mesh, monkeypatch):
    """Stacks over min(max_cache_bytes, 2 GiB): the per-shard path in both
    packages, with the same answers."""
    rng = np.random.default_rng(10)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 4000, dtype=np.uint64)
    bits = {"a": (rng.integers(0, 4, 4000).astype(np.uint64), cols),
            "b": (rng.integers(0, 8, 4000).astype(np.uint64), cols[::-1].copy())}
    ex = _quad(mesh, bits, planner_kw={"max_cache_bytes": 5 << 20})
    monkeypatch.setattr(kernels, "group_count", lambda *a, **k: pytest.fail("launched"))
    _check(ex, "GroupBy(Rows(a), Rows(b), filter=Row(a=1))")
