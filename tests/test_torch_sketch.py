"""Count(Distinct) and SimilarTopN of the port against the JAX package, on
the CPU.

Four levels, every comparison exact except the float32 estimate rows
(rtol 1e-6, the float32 sums' order):

- host math: the port's copy of ``sketch/hll.py`` (hash, bucket/rho, plane
  packing, the float64 estimator, sketches and partials) equals the JAX
  module's on seeded values;
- plain versions: ``hll_expand_plain`` (p = 4, 12, 16, 18, a few full
  shards, 2% of the columns present, filters with bit 31 set; and
  ``chip_smoke.HLL_CHECKS``'s filters and precisions, 4 to 18),
  ``hll_reduce_plain``, ``similar_count_plain`` and the wrappers on CPU
  tensors against pilosa_tpu/sketch/kernels.py; the torch ``hll_count``
  rows against the JAX float32 ones; ``similar_totals``'s order against
  ``jax.lax.top_k``;
- store: the packed planes, register files and exact values the port's
  ``sketch/store.py`` builds from a fragment equal the JAX store's, also
  after ``Set`` and ``import_values`` moved them through the hooks;
- executor: Count(Distinct) (unfiltered, filtered by a Row and by trees,
  every precision, the exact leg and the threshold) and SimilarTopN (both
  metrics, Row and tree filters) through both JAX executors (per-shard and
  ``MeshPlanner``) and both port executors (per-shard and ``Planner``),
  over 3 shards so the planner's stacks carry a zero pad row; spies show
  the planner's programs call ``hll_expand``, ``hll_reduce`` and
  ``similar_count``.

The kernels themselves run only on the card: ``chip_smoke.py`` holds each
to its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pilosa_tpu.cache import signature as j_signature
from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu.pql import parse as j_parse
from pilosa_tpu.sketch import hll as jhll
from pilosa_tpu.sketch import kernels as jsk
from pilosa_tpu.sketch import store as jstore
from pilosa_tpu_torch.cache import signature as t_signature
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.pql import parse as t_parse
from pilosa_tpu_torch.sketch import hll as thll
from pilosa_tpu_torch.sketch import kernels as tsk
from pilosa_tpu_torch.sketch import store as tstore

N_SHARDS = 3
PRECISIONS = [4, 12, 16, 18]


@pytest.fixture(autouse=True)
def _no_launches(monkeypatch):
    """Every CPU call takes the plain versions: no kernel launch. The
    sketch knobs' env overrides are cleared so both packages run their
    defaults."""
    for var in ("PILOSA_TPU_SKETCH_PRECISION", "PILOSA_TPU_SKETCH_EXACT_THRESHOLD"):
        monkeypatch.delenv(var, raising=False)
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


# -- host math ---------------------------------------------------------------


@pytest.mark.parametrize("p", PRECISIONS)
def test_host_math_matches_jax(p):
    rng = np.random.default_rng(p)
    vals = np.concatenate([rng.integers(-2**62, 2**62, 5000), [0, -1, 2**63 - 1, -2**63]])
    u = vals.astype(np.uint64)
    for a, b in zip(thll.bucket_rho(u, p), jhll.bucket_rho(u, p)):
        np.testing.assert_array_equal(a, b)
    bucket, rho = thll.bucket_rho(u, p)
    np.testing.assert_array_equal(thll.pack_plane(bucket, rho), jhll.pack_plane(bucket, rho))
    ts, js = thll.sketch_values(vals, p), jhll.sketch_values(vals, p)
    np.testing.assert_array_equal(ts.regs, js.regs)
    assert ts.estimate() == js.estimate()
    small = thll.sketch_values(vals[:7], p)
    assert small.estimate() == jhll.sketch_values(vals[:7], p).estimate()
    merged = thll.merge_all([ts, small]).regs
    np.testing.assert_array_equal(merged, jhll.merge_all([js, jhll.sketch_values(vals[:7], p)]).regs)
    assert thll.error_bound(p) == jhll.error_bound(p)


def test_partials_match_jax():
    rng = np.random.default_rng(3)
    ids = [np.sort(rng.choice(50, 20, replace=False)).astype(np.uint64) for _ in range(2)]
    overlap, selfcnt = rng.integers(0, 9, 20), rng.integers(9, 30, 20)
    parts = []
    for mod in (thll, jhll):
        a = mod.SimPartial(ids=ids[0], overlap=overlap, selfcnt=selfcnt, filtcnt=40)
        b = mod.SimPartial(ids=ids[1], overlap=overlap[::-1].copy(),
                           selfcnt=selfcnt[::-1].copy(), filtcnt=11)
        m = a.merge(b)
        parts.append([m.top_pairs(10, "jaccard"), m.top_pairs(10, "overlap"),
                      m.filtcnt, m.overlap.tolist()])
    assert parts[0] == parts[1]
    dv = thll.DistinctValues(np.array([1, 5])).merge(thll.DistinctValues(np.array([2, 5])))
    np.testing.assert_array_equal(dv.values, [1, 2, 5])


# -- plain versions against the JAX functions -----------------------------------


def _plane(rng, s: int, p: int, density: float) -> np.ndarray:
    """[s, SHARD_WIDTH] packed planes: ``density`` of the columns present,
    buckets below 2^p, rho 1..33."""
    present = rng.random((s, SHARD_WIDTH)) < density
    bucket = rng.integers(0, 1 << p, (s, SHARD_WIDTH))
    rho = rng.integers(1, 34, (s, SHARD_WIDTH))
    return np.where(present, bucket | (rho << 18), 0).astype(np.int32)


def _filter(rng, s: int) -> np.ndarray:
    """[s, W] uint32 filter words: random, all ones, bit 31 only, zero."""
    w = rng.integers(0, 2**32, (s, SHARD_WIDTH // 32), dtype=np.uint32)
    w[:, ::5] = 0
    w[:, 1::7] = 0xFFFFFFFF
    w[:, 2::11] = 0x80000000
    return w


@pytest.mark.parametrize("p", PRECISIONS)
def test_hll_expand_and_reduce_match_jax(p):
    rng = np.random.default_rng(10 + p)
    packed = _plane(rng, N_SHARDS, p, 0.02)
    filt = _filter(rng, N_SHARDS)
    want = np.asarray(jsk.hll_expand(jnp.asarray(packed), jnp.asarray(filt), p))
    got = kernels.hll_expand(_t(packed), _t(filt), p)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (N_SHARDS, 1 << p)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kernels.hll_expand_plain(_t(packed), _t(filt), p).numpy(),
                                  want)
    np.testing.assert_array_equal(kernels.hll_reduce(got).numpy(),
                                  np.asarray(jsk.hll_reduce(jnp.asarray(want))))
    # Each shard's registers are what the host oracle folds from its
    # masked plane.
    for s in range(N_SHARDS):
        masked = jstore._filter_mask(packed[s], filt[s])
        np.testing.assert_array_equal(want[s], jhll.registers_from_plane(masked, p))


@pytest.mark.parametrize("shards", [1, 3, 1025])
@pytest.mark.parametrize("p", [4, 18])
def test_hll_reduce_matches_jax(p, shards):
    """hll_reduce_plain and the CPU wrapper against the JAX hll_reduce on
    seeded, all-zero and all-255 register stacks of one shard, three and
    1025 (one past the keys phase's 1024), at the narrowest and widest
    precisions; the seeded stack's last shard holds some of the maxima."""
    rng = np.random.default_rng([p, shards])
    for kind in ("seeded", "zero", "full"):
        if kind == "seeded":
            regs = rng.integers(0, 34, (shards, 1 << p), dtype=np.uint8)
            regs[-1, ::7] = 60
        else:
            regs = np.full((shards, 1 << p), 0 if kind == "zero" else 255, dtype=np.uint8)
        want = np.asarray(jsk.hll_reduce(jnp.asarray(regs)))
        for fn in (kernels.hll_reduce_plain, kernels.hll_reduce):
            got = fn(torch.from_numpy(regs))
            assert got.dtype == torch.uint8, kind
            np.testing.assert_array_equal(got.numpy(), want, err_msg=kind)
        del regs, want


#: chip_smoke.HLL_CHECKS's precisions and filter kinds (the card holds the
#: kernel to the plain version on them), and the first case's own inputs.
HLL_EDGE_CASES = ["one_row"] + [f"p{p}-{kind}" for p, _, _, kind in chip_smoke.HLL_CHECKS]


@pytest.mark.parametrize("case", HLL_EDGE_CASES)
def test_hll_expand_edge_inputs(case):
    """All-zero and all-ones filters, an empty plane, one row; then each
    HLL_CHECKS case at 2 shards (3 for "absent", whose odd shards' planes
    are empty): a sparse filter, one with all-ones, sign-bit-only and zero
    words, all bits in one chunk, a 3,104-word shard, at p = 4 to 18."""
    if case != "one_row":
        p, kind = int(case.split("-")[0][1:]), case.split("-", 1)[1]
        rows = 3 if kind == "absent" else 2
        packed, filt = chip_smoke.hll_case_inputs(
            kind, _plane(np.random.default_rng(p), rows, p, 0.3),
            chip_smoke.hll_filter(kind, rows, chip_smoke.SEED + p))
        want = np.asarray(jsk.hll_expand(jnp.asarray(packed), jnp.asarray(filt), p))
        assert want.shape == (rows, 1 << p)
        for fn in (kernels.hll_expand, kernels.hll_expand_plain):
            np.testing.assert_array_equal(fn(_t(packed), _t(filt), p).numpy(), want)
        if kind == "absent":
            assert not want[1].any() and want[0].any()
        return
    rng = np.random.default_rng(0)
    packed = _plane(rng, 1, 12, 0.5)
    for filt in (np.zeros((1, 32768), np.uint32), np.full((1, 32768), 0xFFFFFFFF, np.uint32)):
        want = np.asarray(jsk.hll_expand(jnp.asarray(packed), jnp.asarray(filt), 12))
        np.testing.assert_array_equal(kernels.hll_expand(_t(packed), _t(filt), 12).numpy(),
                                      want)
    zero = np.zeros_like(packed)
    assert not kernels.hll_expand(_t(zero), _t(_filter(rng, 1)), 12).any()
    with pytest.raises(ValueError):
        kernels.hll_expand(_t(packed), _t(_filter(rng, 1)), 3)
    with pytest.raises(ValueError):
        kernels.hll_expand(_t(packed[:, :64]), _t(_filter(rng, 1)), 12)


def test_hll_filters_of_the_card_checks():
    """chip_smoke's one-chunk filters put every bit in words 2048-4095 (the
    kernel's chunk 1), their set nibbles under and past the kernel's list
    cap of a quarter of the chunk's 16,384; "narrow" cuts a shard to a
    whole chunk and a short one."""
    lo, hi = chip_smoke.HLL_CHUNK
    for kind, (under, cap) in (("chunk_list", (True, 4096)), ("chunk_dense", (False, 4096))):
        words = chip_smoke.hll_filter(kind, 3, 1)
        assert not words[:, :lo].any() and not words[:, hi:].any()
        nibbles = ((words[:, lo:hi, None] >> np.arange(0, 32, 4, dtype=np.uint32)) & 0xF) != 0
        assert ((nibbles.sum(axis=(1, 2)) <= cap) == under).all()
    packed, filt = chip_smoke.hll_case_inputs("narrow", np.zeros((2, SHARD_WIDTH), np.int32),
                                              chip_smoke.hll_filter("narrow", 2, 1))
    assert filt.shape == (2, chip_smoke.HLL_NARROW_WORDS) and packed.shape[1] == 32 * 3104
    assert 2048 < chip_smoke.HLL_NARROW_WORDS < 4096 and chip_smoke.HLL_NARROW_WORDS % 32 == 0


def test_sketch_wrappers_refuse_ragged_word_axes():
    """hll_expand and similar_count take whole 32-word groups, as every
    shard's 32,768 words are; a ragged word axis is refused on both paths."""
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (2, 33), dtype=np.uint32)
    with pytest.raises(ValueError, match="multiple of 32"):
        kernels.hll_expand(_t(_plane(rng, 2, 12, 0.5)[:, :33 * 32]), _t(words), 12)
    with pytest.raises(ValueError, match="multiple of 32"):
        kernels.similar_count(_t(np.stack([words, words])), _t(words))
    inter, selfc, filtc = kernels.similar_count(_t(np.stack([words[:, :32]])),
                                                _t(words[:, :32]))
    assert int(inter[0]) == int(selfc[0]) == int(filtc)


@pytest.mark.parametrize("p", [4, 12])
def test_hll_count_rows_match_jax(p):
    """The torch float32 estimate rows (``hll`` count, and_count,
    pair_count) against the JAX ones, rtol 1e-6."""
    rng = np.random.default_rng(p)
    regs = [jhll.sketch_values(rng.integers(0, n, n), p).regs
            for n in (1, 30, 3000, 300000)] + [np.zeros(1 << p, np.uint8)]
    a = np.stack(regs)
    b = a[::-1].copy()
    for name in ("hll_count", "hll_and_count", "hll_pair_count"):
        args = (a,) if name == "hll_count" else (a, b)
        want = np.asarray(getattr(jsk, name)(*map(jnp.asarray, args)))
        got = getattr(tsk, name)(*map(torch.from_numpy, args)).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("r,s", [(1, 1), (5, 3), (8, 4)])
def test_similar_totals_match_jax(r, s):
    rng = np.random.default_rng(r * 10 + s)
    cube = rng.integers(0, 2**32, (r, s, 96), dtype=np.uint32)
    cube[:, :, ::4] &= np.uint32(0x80000001)
    filt = rng.integers(0, 2**32, (s, 96), dtype=np.uint32)
    if r > 1:
        cube[1] = cube[0]  # a tie: the lower index ranks first
    jorder, jinter, jself, jfilt = jsk.similar_program(r)(jnp.asarray(cube), jnp.asarray(filt))
    for got in (kernels.similar_count(_t(cube), _t(filt)),
                kernels.similar_count_plain(_t(cube), _t(filt))):
        inter, selfc, filtc = got
        np.testing.assert_array_equal(inter.numpy(), np.asarray(jinter))
        np.testing.assert_array_equal(selfc.numpy(), np.asarray(jself))
        assert int(filtc) == int(jfilt) and inter.dtype == torch.int32
    order, *_ = tsk.similar_totals(_t(cube), _t(filt))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    ties = torch.tensor([3, 5, 5, 0, 5, 3], dtype=torch.int32)
    _, want = jax.lax.top_k(jnp.asarray(ties.numpy()), 6)
    got = torch.sort(ties, descending=True, stable=True).indices
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the store ----------------------------------------------------------------


def _int_field(h, opts_cls, name, lo, hi):
    return h.create_index_if_not_exists("i").create_field(name, opts_cls(type="int", min=lo,
                                                                          max=hi))


@pytest.mark.parametrize("p", [4, 12])
def test_store_matches_jax(p, monkeypatch):
    """Planes, registers, sketches and exact values of one fragment, then
    after a Set and an import moved values (the hooks patch the cached
    plane in place). Both packages' value imports run their host loops
    (rows the JAX device transpose adopts are read-only, and a later Set
    on them fails there); the port's device transpose path is checked
    against a rebuild at the end."""
    monkeypatch.setenv("PILOSA_TPU_INGEST_TRANSPOSE", "off")
    rng = np.random.default_rng(p)
    sides = []
    for h, opts in ((JHolder(), JFieldOptions), (THolder(device="cpu"), TFieldOptions)):
        f = _int_field(h, opts, "v", -5000, 70000)
        cols = rng.integers(0, SHARD_WIDTH, 4000)
        vals = rng.integers(-5000, 70001, 4000)
        f.import_values(cols, vals)
        sides.append((h, f))
        rng = np.random.default_rng(p)
    filt = _filter(np.random.default_rng(1), 1)[0]

    def state():
        out = []
        for h, f in sides:
            mod = jstore if isinstance(h, JHolder) else tstore
            frag = h.fragment("i", "v", "bsig_v", 0)
            depth = f.bsi_group.bit_depth
            out.append((mod.plane(frag, depth, p).copy(), mod.registers(frag, depth, p).copy(),
                        mod.shard_sketch(frag, depth, p, filt).regs,
                        mod.shard_distinct(frag, depth), mod.shard_distinct(frag, depth, filt)))
        return out

    for a, b in zip(*state()):
        np.testing.assert_array_equal(a, b)
    for h, f in sides:
        f.set_value(17, -4321)
        f.import_values([5, 6, 17], [1, 2, 69999])
    for a, b in zip(*state()):
        np.testing.assert_array_equal(a, b)
    # The hooks kept the cached plane current, on the port's device
    # transpose path too: a rebuild agrees with it.
    monkeypatch.setenv("PILOSA_TPU_INGEST_TRANSPOSE", "on")
    frag = sides[1][0].fragment("i", "v", "bsig_v", 0)
    depth = sides[1][1].bsi_group.bit_depth
    sides[1][1].import_values(np.arange(0, 3000, 7), np.arange(0, 3000, 7) * 13 - 4000)
    assert frag._hll_planes[(depth, p)][0] == frag.generation  # patched, not stale
    cached = tstore.plane(frag, depth, p).copy()
    tstore.invalidate(frag)
    np.testing.assert_array_equal(tstore.plane(frag, depth, p), cached)


# -- executor level -----------------------------------------------------------


def _load(h, opts_cls, seed: int) -> None:
    """Int fields ``v`` (about 6000 distinct values over 20000 columns,
    negatives included, base 0) and ``w`` (a handful of values, base 100,
    the exact leg), set fields ``f`` (filter rows) and ``g`` (SimilarTopN
    candidates: 6 rows of varied density, a row absent from shard 2), over
    N_SHARDS shards."""
    rng = np.random.default_rng(seed)
    idx = h.create_index_if_not_exists("i")
    v = idx.create_field("v", opts_cls(type="int", min=-3000, max=3000))
    w = idx.create_field("w", opts_cls(type="int", min=100, max=160))
    f = idx.create_field("f")
    g = idx.create_field("g")
    n = N_SHARDS * SHARD_WIDTH
    cols = rng.choice(n, 20000, replace=False)
    v.import_values(cols, rng.integers(-3000, 3001, 20000))
    w.import_values(cols[::4], rng.integers(100, 110, 5000))
    f.import_bits(rng.integers(1, 4, 40000), rng.integers(0, n, 40000))
    f.import_bits(np.full(3000, 4), cols[:3000])
    for rid, k in enumerate((50, 400, 3000, 9000, 15000, 27000)):
        c = rng.integers(0, n if rid != 2 else 2 * SHARD_WIDTH, k)
        g.import_bits(np.full(k, rid), c)


@pytest.fixture(scope="module")
def parity():
    jh, th = JHolder(), THolder(device="cpu")
    _load(jh, JFieldOptions, 7)
    _load(th, TFieldOptions, 7)
    jexecs = [JExecutor(jh), JExecutor(jh, planner=MeshPlanner(jh, make_mesh()))]
    texecs = [TExecutor(th), TExecutor(th, planner=Planner(th))]
    yield jh, th, jexecs, texecs
    texecs[1].planner.close()


DISTINCT_QUERIES = [
    "Count(Distinct(field=v))",
    "Count(Distinct(Row(f=1), field=v))",
    "Count(Distinct(Row(f=4), field=v))",
    "Count(Distinct(Intersect(Row(f=1), Row(f=2)), field=v))",
    "Count(Distinct(Union(Row(f=3), Not(Row(f=1))), field=v))",
    "Count(Distinct(Row(v > 1000), field=v))",
    *[f"Count(Distinct(field=v, precision={p}))" for p in PRECISIONS],
    *[f"Count(Distinct(Row(f=2), field=v, precision={p}))" for p in PRECISIONS],
    "Count(Distinct(field=v, threshold=0))",
    "Count(Distinct(field=v, threshold=100000))",
    "Count(Distinct(field=v, exact=true))",
    "Count(Distinct(field=w))",
    "Count(Distinct(Row(f=3), field=w))",
    "Count(Distinct(Row(f=9), field=v))",
]

SIMILAR_QUERIES = [
    "SimilarTopN(g, Row(f=4))",
    "SimilarTopN(g, Row(f=4), n=3, metric=overlap)",
    "SimilarTopN(g, Row(g=3), n=4)",
    "SimilarTopN(g, Union(Row(f=1), Row(f=4)), n=6, metric=overlap)",
    "SimilarTopN(g, Intersect(Row(f=2), Row(g=5)))",
    "SimilarTopN(g, Row(f=9))",
]


@pytest.mark.parametrize("query", DISTINCT_QUERIES + SIMILAR_QUERIES)
def test_query_parity(parity, query):
    _, _, jexecs, texecs = parity
    want = j_json(jexecs[0].execute("i", query, cache=False))
    assert j_json(jexecs[1].execute("i", query, cache=False)) == want, "JAX executors disagree"
    for e in texecs:
        assert t_json(e.execute("i", query, cache=False)) == want


def test_distinct_answers_are_the_oracle(parity):
    """The unfiltered answer is the HLL estimate of every stored value (the
    same registers as ``sketch_values``), the exact leg the true count."""
    _, th, _, texecs = parity
    vals = []
    for shard in range(N_SHARDS):
        frag = th.fragment("i", "v", "bsig_v", shard)
        vals.append(tstore.shard_distinct(frag, th.field("i", "v").bsi_group.bit_depth))
    u = np.unique(np.concatenate(vals))
    for e in texecs:
        got = e.execute("i", "Count(Distinct(field=v, threshold=0))", cache=False)[0]
        assert got == int(round(thll.sketch_values(u, 12).estimate()))
        assert e.execute("i", "Count(Distinct(field=v, exact=true))", cache=False)[0] == len(u)


def test_planner_programs_call_the_kernels(parity, monkeypatch):
    """The port planner's filtered Count(Distinct) is ONE hll_expand and
    ONE hll_reduce (the single Row filter enters as its leaf stack), the
    unfiltered one ONE hll_reduce of the register stack, SimilarTopN ONE
    similar_count."""
    _, _, _, texecs = parity
    calls = []
    for name in ("hll_expand", "hll_reduce", "similar_count", "tree_count"):
        real = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    e = texecs[1]
    for query, want in (("Count(Distinct(Row(f=1), field=v, threshold=0))",
                         ["hll_expand", "hll_reduce"]),
                        ("Count(Distinct(field=v, threshold=0))", ["hll_reduce"]),
                        ("Count(Distinct(Union(Row(f=1), Row(f=2)), field=v, threshold=0))",
                         ["tree_count", "hll_expand", "hll_reduce"]),
                        ("SimilarTopN(g, Row(f=4))", ["similar_count"])):
        calls.clear()
        e.execute("i", query, cache=False)
        assert calls == want, query
    stats = e.planner.cache_stats()
    assert stats["class_bytes"]["hll"] > 0


def test_similar_cube_gate_takes_the_host_fold(parity, monkeypatch):
    """A candidate cube past SIM_CUBE_MAX_BYTES is not built: the executor
    folds the shards on the host, with the same answer."""
    _, _, jexecs, texecs = parity
    q = "SimilarTopN(g, Row(f=4), n=4)"
    want = j_json(jexecs[0].execute("i", q, cache=False))
    monkeypatch.setattr(Planner, "SIM_CUBE_MAX_BYTES", 1)
    assert t_json(texecs[1].execute("i", q, cache=False)) == want


def test_distinct_errors_match_jax(parity):
    _, _, jexecs, texecs = parity
    for q in ("Distinct(field=v)", "Count(Distinct(field=f))", "Count(Distinct(field=zz))",
              "Count(Distinct(field=v, precision=3))", "SimilarTopN(v, Row(f=1))",
              "SimilarTopN(g, Row(f=1), metric=cosine)"):
        with pytest.raises(Exception) as je:
            jexecs[0].execute("i", q)
        with pytest.raises(Exception) as te:
            texecs[1].execute("i", q)
        assert str(te.value) == str(je.value), q


@pytest.mark.parametrize("text", [
    "Count(Distinct(field=v))", "Count(Distinct(field=v, precision=12))",
    "Count(Distinct(Row(f=1), field=v, threshold=7))", "SimilarTopN(g, Row(f=1))",
    "SimilarTopN(g, Row(f=1), n=10, metric=jaccard)", "Count(Row(f=1))"])
def test_cache_signature_matches_jax(text):
    """Omitted sketch literals resolve to the server defaults in both
    packages' result-cache keys."""
    assert t_signature.plan_signature(t_parse(text)) == \
        j_signature.plan_signature(j_parse(text))


def test_knobs_and_env_match_jax(monkeypatch):
    from pilosa_tpu import sketch as jsketch
    from pilosa_tpu_torch import sketch as tsketch
    for mod in (jsketch, tsketch):
        assert (mod.precision(), mod.exact_threshold(), mod.DEFAULT_SIMILAR_N) == (12, 1024, 10)
    monkeypatch.setenv("PILOSA_TPU_SKETCH_PRECISION", "9")
    monkeypatch.setenv("PILOSA_TPU_SKETCH_EXACT_THRESHOLD", "5")
    assert (tsketch.precision(), tsketch.exact_threshold()) == (9, 5)
    with pytest.raises(ValueError):
        tsketch.validate_precision(19)
    with pytest.raises(ValueError):
        tsketch.set_exact_threshold(-1)
