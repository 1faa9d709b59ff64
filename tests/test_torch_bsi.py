"""Int (BSI) fields of the port against the JAX package, on the CPU.

Three levels, every comparison exact:

- ops: the port's plain comparator, signed range branches, Sum counts and
  min/max descent (``pilosa_tpu_torch.ops.bsi`` on CPU tensors) against
  ``pilosa_tpu.ops.bsi`` on the same seeded words, at depths 0, 1, 17 and
  40 with all-ones and bit-31 words, predicates 0, -1, +-1 and
  +-(2^depth - 1);
- executor: int fields with a zero base, a base of 10, and depth 40, over 3
  shards (so the planner's stacks carry a zero pad row) and 3 seeds, with
  the extreme values repeated in several shards so that Min/Max ties cross
  shards; every query through both JAX executors (per-shard and
  ``MeshPlanner``) and both port executors (per-shard and ``Planner``);
- data: ``import_values`` and ``Set`` leave byte-equal planes in both
  packages, and ``interop.load_bsi_planes`` fed the JAX planes answers the
  same.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu_torch import interop
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.errors import (
    BSIGroupNotFoundError,
    BSIGroupValueTooHighError,
    BSIGroupValueTooLowError,
    InvalidBSIGroupRangeError,
)
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.ops import bsi as tbsi
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner

DEPTHS = [0, 1, 17, 40]
W = 160  # words per row at the ops level: small, and a multiple of 32


def _words(rng, shape):
    """Random words with all-ones, bit-31-only and zero words mixed in, and
    the last row all ones."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = w.reshape(-1)
    flat[::7] = 0xFFFFFFFF
    flat[3::11] = 0x80000000
    flat[5::13] = 0
    w[..., -4:] = 0xFFFFFFFF
    return w


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _preds(depth):
    top = (1 << depth) - 1
    return sorted({0, -1, 1, top, -top})


@pytest.fixture(autouse=True)
def _no_launches():
    """Every CPU call takes the plain versions: no kernel launch."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


def _bsi_words(seed, depth, lead=(3,)):
    rng = np.random.default_rng(seed)
    exists = _words(rng, lead + (W,))
    sign = _words(rng, lead + (W,))
    bits = _words(rng, (depth,) + lead + (W,))
    filt = _words(rng, lead + (W,))
    return exists, sign, bits, filt


# -- ops level ---------------------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("op", ["eq", "neq", "lt", "lte", "gt", "gte"])
def test_signed_range_ops_match_jax(depth, op):
    exists, sign, bits, _ = _bsi_words(depth, depth)
    je, js, jb = jnp.asarray(exists), jnp.asarray(sign), jnp.asarray(bits)
    te, ts, tb = _t(exists), _t(sign), _t(bits)
    for pred in _preds(depth):
        if op in ("eq", "neq"):
            fn = getattr(jbsi, f"range_{op}")
            want = fn(je, js, jb, pred, depth)
            got = getattr(tbsi, f"range_{op}")(te, ts, tb, pred, depth)
        else:
            base, allow_eq = op[:2], op.endswith("e")
            want = getattr(jbsi, f"range_{base}")(je, js, jb, pred, depth, allow_eq)
            got = getattr(tbsi, f"range_{base}")(te, ts, tb, pred, depth, allow_eq)
        np.testing.assert_array_equal(_u32(got), np.asarray(want), err_msg=f"pred {pred}")


@pytest.mark.parametrize("depth", DEPTHS)
def test_range_between_matches_jax(depth):
    exists, sign, bits, _ = _bsi_words(100 + depth, depth)
    top = (1 << depth) - 1
    cases = {(0, top), (-top, top), (-top, -1), (-1, 1), (0, 0), (1, top),
             (-top, 0), (-1, -1)}
    for lo, hi in sorted(cases):
        want = jbsi.range_between(jnp.asarray(exists), jnp.asarray(sign),
                                  jnp.asarray(bits), lo, hi, depth)
        got = tbsi.range_between(_t(exists), _t(sign), _t(bits), lo, hi, depth)
        np.testing.assert_array_equal(_u32(got), np.asarray(want), err_msg=f"{lo}..{hi}")


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("allow_eq", [False, True])
def test_compare_select_matches_jax(depth, allow_eq):
    """The unsigned comparator itself, every op, predicates whose halves
    both carry bits."""
    _, _, bits, filt = _bsi_words(200 + depth, depth, lead=(2, 3))
    for pred in _preds(depth) + [(1 << 31) | 5, (1 << 33) + 7]:
        upred = abs(pred)
        lo, hi = tbsi.split_u64(upred)
        for op in ("lt", "gt", "eq"):
            want = jbsi._compare_select(jnp.asarray(bits), jnp.asarray(filt),
                                        jnp.uint32(lo), jnp.uint32(hi), depth, op,
                                        allow_eq)
            got = tbsi._compare_select(_t(bits), _t(filt), lo, hi, depth, op, allow_eq)
            np.testing.assert_array_equal(_u32(got), np.asarray(want),
                                          err_msg=f"{op} {upred}")
        lanes = tbsi.compare_unsigned(_t(bits), lo, hi, depth)
        want = jbsi.compare_unsigned(jnp.asarray(bits), jnp.uint32(lo), jnp.uint32(hi),
                                     depth)
        for got, w in zip(lanes, want):  # lt, eq, gt
            np.testing.assert_array_equal(_u32(got), np.broadcast_to(np.asarray(w),
                                                                     got.shape))


@pytest.mark.parametrize("depth", DEPTHS)
def test_sum_counts_match_jax(depth):
    exists, sign, bits, filt = _bsi_words(300 + depth, depth)
    want = jbsi.sum_counts(jnp.asarray(exists), jnp.asarray(sign),
                           jnp.asarray(bits), jnp.asarray(filt), depth)
    got = tbsi.sum_counts(_t(exists), _t(sign), _t(bits), _t(filt), depth)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # One shard at a time, as the per-shard executor runs it.
    for s in range(3):
        assert tbsi.host_sum(_t(exists[s]), _t(sign[s]), _t(bits[:, s]), _t(filt[s]),
                             depth) == \
            jbsi.host_sum(jnp.asarray(exists[s]), jnp.asarray(sign[s]),
                          jnp.asarray(bits[:, s]), jnp.asarray(filt[s]), depth)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("is_max", [False, True], ids=["min", "max"])
def test_min_max_unsigned_match_jax(depth, is_max):
    """Per-row descent over a [4, W] filter whose row 2 is empty and row 3
    one column (a pad row and a lone value)."""
    _, _, bits, filt = _bsi_words(400 + depth, depth, lead=(4,))
    filt[2] = 0
    filt[3] = 0
    filt[3, 7] = 1 << 31
    jfn = jbsi._max_unsigned if is_max else jbsi._min_unsigned
    tfn = tbsi._max_unsigned if is_max else tbsi._min_unsigned
    want = [np.broadcast_to(np.asarray(x), (4,))
            for x in jfn(jnp.asarray(bits), jnp.asarray(filt), depth)]
    got = tfn(_t(bits), _t(filt), depth)
    assert all(g.dtype == torch.int32 and tuple(g.shape) == (4,) for g in got)
    np.testing.assert_array_equal(_u32(got[0]), want[0].astype(np.uint32))
    np.testing.assert_array_equal(_u32(got[1]), want[1].astype(np.uint32))
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("depth", DEPTHS)
def test_host_min_max_match_jax(depth):
    exists, sign, bits, filt = _bsi_words(500 + depth, depth)
    for s in range(3):
        j_in = [jnp.asarray(a) for a in (exists[s], sign[s], bits[:, s], filt[s])]
        t_in = [_t(a) for a in (exists[s], sign[s], bits[:, s], filt[s])]
        assert tbsi.host_min(*t_in, depth) == jbsi.host_min(*j_in, depth)
        assert tbsi.host_max(*t_in, depth) == jbsi.host_max(*j_in, depth)


def test_split_join_u64():
    for v in (0, 1, (1 << 32) - 1, 1 << 32, (1 << 40) - 1, (1 << 63) - 1):
        assert tbsi.split_u64(v) == jbsi.split_u64(v)
        lo, hi = tbsi.split_u64(v)
        as_i32 = [x - (1 << 32) if x >= 1 << 31 else x for x in (lo, hi)]
        assert tbsi._join_u64(*as_i32) == v


# -- executor level ----------------------------------------------------------

N_SHARDS = 3
SEEDS = [0, 1, 2]
#: int fields: (min, max). v spans zero (base 0, depth 11), w has base 10,
#: x has depth 40 (magnitudes past bit 31).
INT_FIELDS = {"v": (-1100, 1000), "w": (10, 5000), "x": (-(2**40 - 1), 2**40 - 1)}

QUERIES = [
    # tests/test_executor.py:121-169 on these fields
    "Row(v > 5)", "Row(v < 0)", "Row(v == 30)", "Row(v != 30)", "Row(v != null)",
    "Row(v >< [0, 30])", "Row(-20 <= v < 30)", "Row(v < 1000000)", "Row(v >= -1100)",
    "Sum(field=v)", "Min(field=v)", "Max(field=v)",
    "Sum(Row(f=1), field=v)", "Min(Row(f=1), field=v)", "Max(Row(f=1), field=v)",
    # chip_smoke.py's BSI phase, as written and at these sizes
    "Count(Row(v > 50000))", "Count(Row(-1000 <= v <= 1000))",
    "Count(Row(v > 500))", "Count(Row(-100 <= v <= 100))", "Max(Row(v < 0), field=v)",
    # operators, quirks and range edges
    "Count(Row(v < -1))", "Count(Row(v > -1))", "Count(Row(v <= -1))",
    "Count(Row(v >= -1))", "Count(Row(v == -1100))", "Count(Row(v != 5000))",
    "Count(Row(v > 1000))", "Count(Row(v < -1100))", "Count(Row(v >< [-5000, 5000]))",
    "Count(Row(v >< [-1100, -3]))", "Range(v > 20)", "Count(Range(v <= -20))",
    "Count(Intersect(Row(v > 0), Row(f=1)))", "Count(Union(Row(v < -500), Row(f=1)))",
    "TopN(f, Row(v > 0), n=2)",
    "Min(Row(v > 10), field=v)", "Sum(Row(v < 0), field=v)", "Max(Row(v == 999), field=v)",
    # base 10
    "Sum(field=w)", "Min(field=w)", "Max(field=w)", "Row(w > 4000)",
    "Count(Row(w < 11))", "Count(Row(w == 10))", "Count(Row(20 <= w <= 30))",
    "Sum(Row(w > 100), field=w)", "Min(Row(f=1), field=w)",
    # depth 40
    "Sum(field=x)", "Min(field=x)", "Max(field=x)", "Count(Row(x > 4294967296))",
    "Count(Row(x < -2147483648))", "Count(Row(-8589934592 <= x <= 8589934592))",
    "Max(Row(x < 0), field=x)", "Sum(Row(x > 0), field=x)",
]


def _values(seed):
    """{field: (columns, values)} over N_SHARDS shards. Each field's min
    and max appear in shards 0 and 2 (several times in shard 2), so the
    executor's first-shard count rule shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (lo, hi) in INT_FIELDS.items():
        n = 600
        cols = rng.choice(N_SHARDS * SHARD_WIDTH, n, replace=False)
        vals = rng.integers(lo + 1, hi, n, dtype=np.int64)  # ends placed below
        shard = cols // SHARD_WIDTH
        first0 = np.flatnonzero(shard == 0)[:2]
        in2 = np.flatnonzero(shard == 2)[:6]
        vals[first0] = [lo, hi]
        vals[in2] = [lo, lo, lo, hi, hi, hi]
        out[name] = (cols.astype(np.uint64), vals)
    return out


def _filter_bits(seed):
    rng = np.random.default_rng(seed + 1000)
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, 900, replace=False).astype(np.uint64)
    return cols


@contextlib.contextmanager
def _jax_ingest(mode: str):
    """Pin the JAX package's value import to its host plane loop ("off")
    or its device transpose ("on"). Rows the device transpose adopts are
    read-only views, so a later single-bit Set on them fails in the JAX
    package; tests that write after importing use "off"."""
    old = os.environ.get("PILOSA_TPU_INGEST_TRANSPOSE")
    os.environ["PILOSA_TPU_INGEST_TRANSPOSE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["PILOSA_TPU_INGEST_TRANSPOSE"]
        else:
            os.environ["PILOSA_TPU_INGEST_TRANSPOSE"] = old


def _holders(seed, jax_ingest: str = "off"):
    values = _values(seed)
    # f row 1 overlaps v's columns, so filtered aggregates are not empty.
    fcols = np.concatenate([_filter_bits(seed), values["v"][0][::3], values["w"][0][::4]])
    jh, th = JHolder(), THolder(device="cpu")
    with _jax_ingest(jax_ingest):
        for h, opts in ((jh, JFieldOptions), (th, TFieldOptions)):
            idx = h.create_index("i")
            for name, (lo, hi) in INT_FIELDS.items():
                idx.create_field(name, opts(type="int", min=lo, max=hi))
                idx.field(name).import_values(*values[name])
            idx.create_field("f").import_bits(np.ones(len(fcols), dtype=np.uint64),
                                              fcols)
    return jh, th


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def parity(request, mesh):
    jh, th = _holders(request.param)
    jexecs = [JExecutor(jh), JExecutor(jh, planner=MeshPlanner(jh, mesh))]
    texecs = [TExecutor(th), TExecutor(th, planner=Planner(th))]
    return jh, th, jexecs, texecs


def _answers(jexecs, texecs, query):
    want = j_json(jexecs[0].execute("i", query))
    for e in jexecs[1:]:
        assert j_json(e.execute("i", query)) == want, "JAX executors disagree"
    return want, [t_json(e.execute("i", query)) for e in texecs]


@pytest.mark.parametrize("query", QUERIES)
def test_query_parity(parity, query):
    _, _, jexecs, texecs = parity
    want, got = _answers(jexecs, texecs, query)
    for g in got:
        assert g == want


def test_min_max_ties_keep_first_shard_count(parity):
    """The extremes sit in shards 0 (once) and 2 (three times): Min/Max
    report shard 0's count, as ValCount.smaller/larger do."""
    _, _, _, texecs = parity
    for e in texecs:
        for name, (lo, hi) in INT_FIELDS.items():
            assert t_json(e.execute("i", f"Min(field={name})")) == [
                {"value": lo, "count": 1}]
            assert t_json(e.execute("i", f"Max(field={name})")) == [
                {"value": hi, "count": 1}]


@pytest.mark.parametrize("seed", SEEDS)
def test_writes_parity(mesh, seed):
    """Set on int fields (new columns, overwrites, a sign flip, the range
    ends, depth-40 magnitudes) and Clear, then reads, through every
    executor pair on fresh holders."""
    c2 = 2 * SHARD_WIDTH + 17
    writes = (f"Set(5, v=7) Set(5, v=7) Set(5, v=-7) Set({c2}, v=1000) "
              f"Set(6, w=10) Set(6, w=5000) Set({c2}, x=-1099511627775) "
              f"Set(9, x=1099511627775) Clear(5, v=0) Clear(5, v=0)")
    reads = ("Sum(field=v) Min(field=v) Max(field=v) Count(Row(v > 999)) "
             "Sum(field=w) Min(field=x) Max(field=x) Count(Row(x != null))")
    results = []
    for planned in (False, True):
        jh, th = _holders(seed)
        je = JExecutor(jh, planner=MeshPlanner(jh, mesh) if planned else None)
        te = TExecutor(th, planner=Planner(th) if planned else None)
        want = j_json(je.execute("i", reads)) + j_json(je.execute("i", writes)) + \
            j_json(je.execute("i", reads))
        got = t_json(te.execute("i", reads)) + t_json(te.execute("i", writes)) + \
            t_json(te.execute("i", reads))
        assert got == want
        results.append(got)
    assert results[0] == results[1]


def test_planner_cube_follows_depth_and_writes():
    """The cube is [depth, S_pad, W] with a zero pad shard, cached across
    queries, rebuilt after a write to the field, and keyed on the depth:
    a field that grows deeper reads a new cube."""
    jh, th = _holders(7)
    planner = Planner(th)
    te, je = TExecutor(th, planner=planner), JExecutor(jh)
    def cubes(field):
        return {key[4][1]: ent[2] for key, ent in planner._stack_cache.items()
                if key[2] == field and isinstance(key[4], tuple)}

    q = "Sum(field=v) Max(Row(v > 0), field=v)"
    assert t_json(te.execute("i", q)) == j_json(je.execute("i", q))
    (cube,) = cubes("v").values()
    assert tuple(cube.shape) == (11, 4, SHARD_WIDTH // 32)
    assert int(cube[:, 3].abs().sum()) == 0
    uploads = planner.uploads
    assert t_json(te.execute("i", q)) == j_json(je.execute("i", q))
    assert planner.uploads == uploads
    for e in (te, je):
        e.execute("i", "Set(4, v=-3)")
    assert t_json(te.execute("i", q)) == j_json(je.execute("i", q))
    assert planner.uploads > uploads
    # e holds only zeros: depth 0, an empty cube. z starts at depth 1 and
    # grows to 6 with its first large value.
    for h, opts in ((jh, JFieldOptions), (th, TFieldOptions)):
        h.index("i").create_field("e", opts(type="int", min=0, max=0))
        h.index("i").create_field("z", opts(type="int", min=-100, max=100,
                                            bit_depth=1))
    q = ("Sum(field=z) Min(field=z) Max(field=z) Count(Row(z == 1)) "
         "Count(Row(z < 0)) Sum(field=e) Min(field=e) Count(Row(e == 0))")
    assert t_json(te.execute("i", q)) == j_json(je.execute("i", q))
    for e in (te, je):
        e.execute("i", "Set(3, z=1) Set(4, z=-1) Set(5, e=0)")
    assert t_json(te.execute("i", q)) == j_json(je.execute("i", q))
    assert set(cubes("z")) == {1} and tuple(cubes("e")[0].shape)[0] == 0
    for e in (te, je):
        e.execute("i", "Set(6, z=50)")
    assert t_json(te.execute("i", q)) == j_json(je.execute("i", q))
    assert set(cubes("z")) == {1, 6}


def test_errors_match_reference():
    th = THolder(device="cpu")
    idx = th.create_index("i")
    with pytest.raises(InvalidBSIGroupRangeError, match="invalid bsigroup range"):
        idx.create_field("bad", TFieldOptions(type="int", min=5, max=1))
    f = idx.create_field("v", TFieldOptions(type="int", min=-10, max=10))
    with pytest.raises(BSIGroupValueTooLowError, match="value too low for bsigroup"):
        f.set_value(1, -11)
    with pytest.raises(BSIGroupValueTooHighError, match="value too high for bsigroup"):
        f.import_values([1, 2], [3, 11])
    idx.create_field("s")
    for planned in (False, True):
        e = TExecutor(th, planner=Planner(th) if planned else None)
        with pytest.raises(BSIGroupNotFoundError, match="bsigroup not found"):
            e.execute("i", "Row(s > 3)")
        assert t_json(e.execute("i", "Sum(field=s)")) == [{"value": 0, "count": 0}]
    assert f.options.to_json() == JFieldOptions(type="int", min=-10, max=10,
                                                bit_depth=4).to_json()


def test_field_api_matches_jax(parity):
    """Field.sum/min/max/range/range_between/not_null (the View and
    Fragment BSI methods under them): View.min/max add the counts of tied
    fragments, unlike the executor."""
    jh, th, _, _ = parity
    for name, (lo, hi) in INT_FIELDS.items():
        jf, tf = jh.index("i").field(name), th.index("i").field(name)
        jfilt, tfilt = (h.index("i").field("f").row(1) for h in (jh, th))
        assert tf.sum() == jf.sum()
        assert tf.min() == jf.min()
        assert tf.max() == jf.max()
        assert tf.sum(tfilt) == jf.sum(jfilt)
        assert tf.min(tfilt) == jf.min(jfilt)
        assert tf.max(tfilt) == jf.max(jfilt)
        mid = (lo + hi) // 2
        for op, pred in (("<", mid), (">=", mid), ("==", lo), ("!=", hi), (">", hi + 1)):
            assert t_json(tf.range(op, pred)) == j_json(jf.range(op, pred)), (op, pred)
        for a, b in ((lo, mid), (mid, hi), (lo - 5, hi + 5)):
            assert t_json(tf.range_between(a, b)) == j_json(jf.range_between(a, b))
        assert t_json(tf.not_null()) == j_json(jf.not_null())


# -- data level --------------------------------------------------------------

def _bsi_rows(h, field, shard):
    frag = h.fragment("i", field, f"bsig_{field}", shard)
    return {r: frag.row_words(r).tobytes() for r in sorted(frag.rows)
            if frag.row_words(r).any()}


@pytest.mark.parametrize("seed", SEEDS)
def test_import_planes_byte_equal(seed):
    """Both of the JAX package's import paths leave the port's planes."""
    for jax_ingest in ("on", "off"):
        jh, th = _holders(seed, jax_ingest)
        for name in INT_FIELDS:
            for shard in range(N_SHARDS):
                assert _bsi_rows(th, name, shard) == _bsi_rows(jh, name, shard)


@pytest.mark.parametrize("seed", SEEDS)
def test_set_and_overwrite_planes_byte_equal(seed):
    jh, th = _holders(seed)
    for e in (JExecutor(jh), TExecutor(th)):
        e.execute("i", "Set(11, v=-1100) Set(11, v=999) Set(12, w=4321) "
                       f"Set({SHARD_WIDTH + 3}, x=-4294967297)")
    for h in (jh, th):  # overwrite, last write wins, in one batch
        h.index("i").field("v").import_values([11, 12, 11], [5, -6, -7])
    for name in INT_FIELDS:
        assert jh.index("i").field(name).options.bit_depth == \
            th.index("i").field(name).options.bit_depth
        for shard in range(N_SHARDS):
            assert _bsi_rows(th, name, shard) == _bsi_rows(jh, name, shard)
    for name, col in (("v", 11), ("v", 12), ("w", 12), ("x", SHARD_WIDTH + 3), ("v", 99)):
        assert th.index("i").field(name).value(col) == jh.index("i").field(name).value(col)


def test_interop_load_bsi_planes(parity):
    """The JAX package's planes handed over shard by shard through
    ``interop.load_bsi_planes`` answer every query as the JAX package does."""
    jh, _, jexecs, _ = parity
    th = THolder(device="cpu")
    for shard in range(N_SHARDS):
        jfrag = jh.fragment("i", "f", "standard", shard)
        interop.load_fragment_words(th, "i", "f", shard, [1],
                                    jfrag.row_words(1)[None])
        for name, (lo, hi) in INT_FIELDS.items():
            jf = jh.index("i").field(name)
            jfrag = jh.fragment("i", name, f"bsig_{name}", shard)
            planes = np.stack([jfrag.row_words(r)
                               for r in range(2 + jf.options.bit_depth)])
            interop.load_bsi_planes(th, "i", name, shard, planes,
                                    TFieldOptions(type="int", min=lo, max=hi))
    texecs = [TExecutor(th), TExecutor(th, planner=Planner(th))]
    for q in ("Sum(field=v)", "Min(field=w)", "Max(Row(f=1), field=x)",
              "Count(Row(-100 <= v <= 100))", "Row(w > 4000)"):
        want, got = _answers(jexecs, texecs, q)
        for g in got:
            assert g == want
