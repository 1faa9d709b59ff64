"""The port's packed residency against the JAX package, on the CPU, exact.

- ``exec/residency.py``: the pow2 buckets of ``pack_width``, ``choose_class``
  in each mode (the JAX function's answer for every width), the env knob
  over ``set_mode``, the byte accounting and the kernel table.
- the plain versions of the four packed kernels against
  ``pilosa_tpu.exec.residency``'s functions on ``chip_smoke.PACKED_CASES``
  (the card holds the CUDA kernels to the same plain versions on the same
  cases at 1024 rows): sentinel-only rows, rows full to K, bit-31
  positions, all-ones plane words, Ka != Kb, K = 8 and K = 16384; and
  and_count's and pair_count's on ``chip_smoke.PACKED_ANY_CASES``, inputs
  the planner never makes (unsorted a, negative entries, a narrower
  plane, duplicates in b, b unaligned or at its widest).
- the wave forms of packed_count, and_count and pair_count: their plain
  versions and CPU wrappers against ``jax.vmap`` of the JAX functions over
  the stacked slots, at B = 1, 3 and 8, on both kinds of cases, with slots
  that share a tensor, sit in a wider stack (another row stride) or start
  one entry in; the wave wrappers' refusals, and their slot count against
  the kernel source's and the coalescer's.
- the planner, with both packages in the same residency mode: every query
  family of tests/test_residency.py (Count, bitmap results, TopN filters,
  aggregate filters, GroupBy) bit-identical to the JAX executor's; the
  program each Count shape runs, held by spies on the kernel wrappers; a
  row that grows past the packing ceiling drops its plan; the prefetch
  drill with packed leaves (``sync_misses == 0``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pilosa_tpu.config import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu.core import FieldOptions as JFieldOptions
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import residency as jres
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu_torch.core import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import residency
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.parallel import coalesce as t_coalesce
from pilosa_tpu_torch.server import ServerNode
from test_residency import EQ_QUERIES, N_SHARDS


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(autouse=True)
def _launch_counts_stay_zero():
    """Every CPU call takes the plain version: no kernel launch is counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


# -- the representation policy --------------------------------------------------

WIDTHS = [0, 1, 7, 8, 9, 250, 256, 257, 1000, 2048, 2049, 4096, 4097, 8192,
          16384, 16385, SHARD_WIDTH // 2, SHARD_WIDTH]


def test_constants_match_jax():
    assert residency.SENTINEL == jres.SENTINEL == kernels.PACK_SENTINEL
    assert residency.MIN_PACK_WIDTH == jres.MIN_PACK_WIDTH
    assert residency.AUTO_RATIO == jres.AUTO_RATIO
    assert residency.MAX_PACK_WIDTH == jres.MAX_PACK_WIDTH
    assert residency.REPR_CLASSES == jres.REPR_CLASSES


def test_pack_width_pow2_buckets():
    assert residency.pack_width(0) == residency.MIN_PACK_WIDTH
    assert residency.pack_width(8) == 8
    assert residency.pack_width(9) == 16
    assert residency.pack_width(250) == 256
    assert residency.pack_width(256) == 256
    assert residency.pack_width(257) == 512
    assert [residency.pack_width(n) for n in WIDTHS] == [jres.pack_width(n) for n in WIDTHS]


@pytest.mark.parametrize("mode", ["off", "auto", "on"])
def test_choose_class_per_mode(monkeypatch, mode):
    """Both packages choose the same class for every width in every mode;
    the JAX test's boundaries hold."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", mode)
    assert [residency.choose_class(n) for n in WIDTHS] == [jres.choose_class(n)
                                                           for n in WIDTHS]
    lo, hi = 100, SHARD_WIDTH // 2
    mid = WORDS_PER_SHARD // residency.AUTO_RATIO + 1  # auto's boundary
    assert residency.choose_class(hi) == residency.DENSE  # dense in every mode
    want = {"off": (residency.DENSE, residency.DENSE),
            "auto": (residency.PACKED, residency.DENSE),
            "on": (residency.PACKED, residency.PACKED)}[mode]
    assert (residency.choose_class(lo), residency.choose_class(mid)) == want


def test_mode_knob_validates_and_env_wins(monkeypatch):
    with pytest.raises(ValueError):
        residency.set_mode("sometimes")
    monkeypatch.delenv("PILOSA_TPU_RESIDENCY_PACKED", raising=False)
    try:
        residency.set_mode("on")
        assert residency.mode() == "on"
        monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "off")
        assert residency.mode() == "off"  # env beats the server knob
        monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "bogus")
        assert residency.mode() == "on"  # junk env is ignored
    finally:
        residency.set_mode("auto")


def test_server_knob_sets_the_mode(monkeypatch):
    monkeypatch.delenv("PILOSA_TPU_RESIDENCY_PACKED", raising=False)
    node = ServerNode(bind="127.0.0.1:0", device="cpu", residency_packed="off")
    try:
        assert residency.mode() == "off"
        assert node.executor.planner.cache_stats()["residency_mode"] == "off"
    finally:
        residency.set_mode("auto")
        node.executor.planner.close()
    node = ServerNode(bind="127.0.0.1:0", device="cpu")
    node.executor.planner.close()
    assert residency.mode() == "auto"


def test_byte_accounting_matches_jax():
    for s_pad, k in ((1, 8), (4, 256), (1024, 1024), (1024, 16384)):
        assert residency.packed_nbytes(s_pad, k) == jres.packed_nbytes(s_pad, k)
        assert residency.dense_nbytes(s_pad) == jres.dense_nbytes(s_pad)
    x = torch.zeros((4, 256), dtype=torch.int32)
    assert residency.stack_nbytes(x) == residency.packed_nbytes(4, 256)


def test_kernel_table():
    """Every class registers every op of the dense class; the packed rows
    are the port's wrappers. The sketch classes raised NotPortedError until
    the keys-and-sketches slice; now the hll row expands with the
    hll_expand wrapper and the keyplane row counts on plane_lookup
    (tests/test_torch_sketch.py and tests/test_torch_translate.py hold
    both rows to the JAX functions)."""
    ops = {op for klass, op in residency.KERNELS if klass == residency.DENSE}
    assert set(residency.KERNELS) == {(k, op) for k in residency.REPR_CLASSES for op in ops}
    assert set(residency.KERNELS) == set(jres.KERNELS)
    assert residency.kernel(residency.PACKED, "count") is kernels.packed_count
    assert residency.kernel(residency.PACKED, "expand") is kernels.packed_expand
    regs = torch.zeros((2, 16), dtype=torch.uint8)
    assert float(residency.kernel(residency.HLL, "count")(regs)[0]) == float(
        jres.kernel(jres.HLL, "count")(regs.numpy())[0])
    plane = torch.tensor([[1, -1], [2, -1], [7, 0]], dtype=torch.int32)
    assert int(residency.kernel(residency.KEYPLANE, "count")(plane)) == 1
    with pytest.raises(KeyError, match="no 'count' kernel.*'run'"):
        residency.kernel("run", "count")


# -- the plain versions against the JAX functions --------------------------------


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("case", list(chip_smoke.PACKED_CASES))
def test_plain_versions_match_jax(case):
    """Each plain version equals the JAX residency function bit for bit,
    and so does each wrapper on CPU tensors."""
    a, b, plane = chip_smoke.packed_case(case, 6, words=WORDS_PER_SHARD)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tp = torch.from_numpy(plane.view(np.int32))
    for x, tx in ((a, ta), (b, tb), (a[:, 1:], ta[:, 1:])):
        want = np.asarray(jres.packed_count(_j(x)))
        assert kernels.packed_count_plain(tx).tolist() == want.tolist()
        assert kernels.packed_count(tx).tolist() == want.tolist()
        want = np.asarray(jres.packed_and_dense_count(_j(x), _j(plane)))
        assert kernels.packed_and_dense_count_plain(tx, tp).tolist() == want.tolist()
        assert kernels.packed_and_dense_count(tx, tp).tolist() == want.tolist()
        want = np.asarray(jres.packed_expand(_j(x))).astype(np.uint32)
        got = kernels.packed_expand_plain(tx)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(kernels.packed_expand(tx).numpy().view(np.uint32),
                                      want)
    for x, y, tx, ty in ((a, b, ta, tb), (b, a, tb, ta), (a[:, 1:], b, ta[:, 1:], tb)):
        want = np.asarray(jres.packed_pair_count(_j(x), _j(y)))
        assert kernels.packed_pair_count_plain(tx, ty).tolist() == want.tolist()
        assert kernels.packed_pair_count(tx, ty).tolist() == want.tolist()


def test_packed_case_edges():
    """The cases hold the edges they name: a row of sentinels only, a row
    full to K, bit-31 positions, an all-ones plane row, b sharing a's
    entries; every row sorted and distinct."""
    a, b, plane = chip_smoke.packed_case("k1024", 6, words=WORDS_PER_SHARD)
    sent = residency.SENTINEL
    assert (a[0] == sent).all() and (b[0] == sent).all()
    assert (a[1] < sent).all() and (b[1] < sent).all()
    assert ((a[2][a[2] < sent] & 31) == 31).all()
    assert (plane[3] == 0xFFFFFFFF).all()
    assert np.array_equal(a[4][a[4] < sent][:b.shape[1]], b[4][b[4] < sent])
    for x in (a, b):
        for row in x:
            valid = row[row < sent]
            assert (np.diff(valid) > 0).all() and (row[len(valid):] == sent).all()


@pytest.mark.parametrize("case", list(chip_smoke.PACKED_ANY_CASES))
def test_any_input_matches_jax(case):
    """and_count's and pair_count's plain versions, and their wrappers on
    CPU tensors, equal the JAX functions on inputs the planner never makes
    (``chip_smoke.PACKED_ANY_CASES``; the card holds the kernels to the
    plain versions on the same cases at 1024 rows). The JAX function clips
    a word index to W - 1 of a shard's plane, the port to the plane's last
    word: on a narrower plane that is the JAX function on the plane widened
    by copies of its last word."""
    a, b, plane = chip_smoke.packed_any_case(case, 3)
    pad = np.repeat(plane[:, -1:], WORDS_PER_SHARD - plane.shape[1], axis=1)
    wide = np.concatenate([plane, pad], axis=1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tp = torch.from_numpy(plane.view(np.int32))
    for x, tx in ((a, ta), (a[:, 1:], ta[:, 1:]), (b, tb)):
        want = np.asarray(jres.packed_and_dense_count(_j(x), _j(wide))).tolist()
        assert kernels.packed_and_dense_count_plain(tx, tp).tolist() == want
        assert kernels.packed_and_dense_count(tx, tp).tolist() == want
    for x, y, tx, ty in ((a, b, ta, tb), (a, b[:, 1:], ta, tb[:, 1:]),
                         (a[:, 1:], b, ta[:, 1:], tb), (b, b, tb, tb)):
        want = np.asarray(jres.packed_pair_count(_j(x), _j(y))).tolist()
        assert kernels.packed_pair_count_plain(tx, ty).tolist() == want
        assert kernels.packed_pair_count(tx, ty).tolist() == want


def test_packed_any_case_edges():
    """The any-input cases hold the inputs they name: a's rows unsorted,
    with negative entries, the int32 extremes, sentinels, entries above the
    sentinel and, on a narrower plane, entries past its last word; b's rows
    sorted with duplicates and hits in a; b at the kernel's widest; b from
    its second entry on unaligned with Kb - 1 not a multiple of 4; K = 8
    and K = 16384."""
    sent = jres.SENTINEL
    widths = set()
    for case in chip_smoke.PACKED_ANY_CASES:
        a, b, plane = chip_smoke.packed_any_case(case, 3)
        widths |= {a.shape[1], b.shape[1]}
        words = plane.shape[1]
        assert (b.shape[1] - 1) % 4 != 0
        for row_a, row_b in zip(a, b):
            assert (np.diff(row_a) < 0).any()
            assert (row_a < 0).any() and (row_a == sent).any() and (row_a > sent).any()
            assert row_a.min() == np.iinfo(np.int32).min
            assert row_a.max() == np.iinfo(np.int32).max
            if words < WORDS_PER_SHARD:
                assert ((row_a >= 32 * words) & (row_a < sent)).any()
            assert (np.diff(row_b) >= 0).all() and (np.diff(row_b) == 0).any()
            assert np.isin(row_a[row_a < sent], row_b).any()
    assert {8, 16384, kernels.PACK_PAIR_MAX_ENTRIES} <= widths


def test_wrappers_refuse():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.packed_count(a.long())
    with pytest.raises(ValueError):
        kernels.packed_count(a[0])
    with pytest.raises(ValueError):
        kernels.packed_count(a.t())  # not contiguous along K
    with pytest.raises(ValueError):
        kernels.packed_and_dense_count(a, torch.zeros((3, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.packed_pair_count(a, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.packed_expand(a, 0)


# -- the wave forms against jax.vmap ---------------------------------------------

#: the rows of each slot of a wave.
WAVE_ROWS = 6
WAVE_SIZES = [1, 3, 8]
WAVE_CASES = ([("sorted", c) for c in chip_smoke.PACKED_CASES]
              + [("any", c) for c in chip_smoke.PACKED_ANY_CASES])


def _wave_slots(x: np.ndarray, n: int, sliced: bool) -> list:
    """``n`` slots of WAVE_ROWS rows cut from ``x`` (at least WAVE_ROWS +
    n - 1 rows): slot z starts at row z. Whole rows: every third slot a
    contiguous copy, the next a view of a stack 3 entries wider (another
    row stride), the next slot z - 2's tensor again (a shared slot).
    ``sliced``: every slot from its second entry on (a view one entry
    in)."""
    t = torch.from_numpy(x)
    if sliced:
        return [t[z:z + WAVE_ROWS, 1:] for z in range(n)]
    wide = torch.full((x.shape[0], x.shape[1] + 3), -1, dtype=t.dtype)
    wide[:, :x.shape[1]] = t
    slots = []
    for z in range(n):
        if z % 3 == 0:
            slots.append(t[z:z + WAVE_ROWS].clone())
        elif z % 3 == 1:
            slots.append(wide[z:z + WAVE_ROWS, :x.shape[1]])
        else:
            slots.append(slots[z - 2])
    return slots


@pytest.mark.parametrize("n", WAVE_SIZES)
@pytest.mark.parametrize("kind,case", WAVE_CASES)
def test_wave_plain_versions_match_jax_vmap(kind, case, n):
    """Each wave form's plain version, and its wrapper on CPU tensors,
    equals ``jax.vmap`` of the JAX residency function over the stacked
    slots, exactly: count of a's and b's slots, and_count of a's and b's
    against planes (each slot its own, and every slot on one plane: the
    plane, a strided view of it, a view one word in), pair_count of a
    against b (and b against a on the sorted cases), whole and sliced. The
    any-input cases' narrower planes go to the JAX function widened by
    their last word, as in test_any_input_matches_jax."""
    rows = WAVE_ROWS + n - 1
    if kind == "sorted":
        a, b, plane = chip_smoke.packed_case(case, rows, words=WORDS_PER_SHARD)
    else:
        a, b, plane = chip_smoke.packed_any_case(case, rows)
    planes = _wave_slots(plane.view(np.int32), n, False)
    jplanes = jnp.asarray(np.stack([np.concatenate(
        [x, np.repeat(x[:, -1:], WORDS_PER_SHARD - x.shape[1], axis=1)], axis=1)
        for x in (p.numpy().view(np.uint32) for p in planes)]))
    own = torch.from_numpy(plane.view(np.int32))[:WAVE_ROWS]
    shared = [own]
    for skew in (4, 1):
        wide = torch.full((WAVE_ROWS, own.shape[1] + 8), -1, dtype=torch.int32)
        wide[:, skew:skew + own.shape[1]] = own
        shared.append(wide[:, skew:skew + own.shape[1]])
    jshared = jnp.asarray(np.stack([np.concatenate(
        [x, np.repeat(x[:, -1:], WORDS_PER_SHARD - x.shape[1], axis=1)], axis=1)
        for x in [own.numpy().view(np.uint32)] * n]))
    v_count = jax.jit(jax.vmap(jres.packed_count))
    v_and = jax.jit(jax.vmap(jres.packed_and_dense_count))
    v_pair = jax.jit(jax.vmap(jres.packed_pair_count))

    def same(got, want):
        assert got.dtype == torch.int32 and tuple(got.shape) == (n, WAVE_ROWS)
        assert got.tolist() == np.asarray(want).tolist()

    for sliced in (False, True):
        xa, xb = _wave_slots(a, n, sliced), _wave_slots(b, n, sliced)
        ja, jb = (jnp.asarray(np.stack([x.numpy() for x in xs])) for xs in (xa, xb))
        for xs, jx in ((xa, ja), (xb, jb)):
            want = v_count(jx)
            same(kernels.packed_count_batched_plain(xs), want)
            same(kernels.packed_count_batched(xs), want)
            want = v_and(jx, jplanes)
            same(kernels.packed_and_dense_count_batched_plain(xs, planes), want)
            same(kernels.packed_and_dense_count_batched(xs, planes), want)
            # every slot on one plane: the plane itself, a strided view of
            # it and a view one word in (the card's staged route, bulk
            # copied or staged by loads)
            want = v_and(jx, jshared)
            for one in shared:
                same(kernels.packed_and_dense_count_batched_plain(xs, [one] * n), want)
                same(kernels.packed_and_dense_count_batched(xs, [one] * n), want)
        pairs = [(xa, xb, ja, jb)] + ([(xb, xa, jb, ja)] if kind == "sorted" else [])
        for xs, ys, jx, jy in pairs:
            want = v_pair(jx, jy)
            same(kernels.packed_pair_count_batched_plain(xs, ys), want)
            same(kernels.packed_pair_count_batched(xs, ys), want)


def test_wave_wrappers_refuse():
    """The wave wrappers' checks: no slot, slots of another shape, dtype or
    rank, slot lists of different lengths, rows that differ between the
    operands, operands on two devices; and a wave neither on the CPU nor on
    a CUDA device raises rather than run the plain version."""
    a = torch.zeros((2, 8), dtype=torch.int32)
    plane = torch.zeros((2, 16), dtype=torch.int32)
    meta = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    for fn, args in ((kernels.packed_count_batched, ([],)),
                     (kernels.packed_count_batched, ([a, a[:, :4]],)),
                     (kernels.packed_count_batched, ([a[0]],)),
                     (kernels.packed_count_batched, ([a, meta],)),
                     (kernels.packed_count_batched, ([meta],)),
                     (kernels.packed_count_batched, ([a.t()],)),
                     (kernels.packed_and_dense_count_batched, ([a, a], [plane])),
                     (kernels.packed_and_dense_count_batched, ([a], [plane[:1]])),
                     (kernels.packed_and_dense_count_batched, ([meta], [plane])),
                     (kernels.packed_pair_count_batched, ([a], [])),
                     (kernels.packed_pair_count_batched, ([a], [a[:1]])),
                     (kernels.packed_pair_count_batched, ([a, a], [a, a[:, :4]])),
                     (kernels.packed_pair_count_batched, ([meta], [meta]))):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(TypeError):
        kernels.packed_count_batched([a, a.long()])
    with pytest.raises(TypeError):
        kernels.packed_and_dense_count_batched([a], [plane.long()])


def test_and_wave_route():
    """The and wave's route: the gather for a single call at every timed
    width, for a wave whose slots read different planes, and for waves
    whose entries are few against the plane row (K = 8; 8 slots of 1024;
    2 of 4096); the staged route from a plane row's worth of entries (32
    slots of 1024, 8 and 32 of 4096), the crossover on the H100 (see
    kernels.and_wave_route)."""
    words = WORDS_PER_SHARD
    route = kernels.and_wave_route
    for k in (8, 1024, 4096):
        assert route(True, 1, k, words) == 0
        assert route(False, 32, k, words) == 0
    for n in (1, 2, 8, 32):
        assert route(True, n, 8, words) == 0
    assert [route(True, n, 1024, words) for n in (2, 8, 32)] == [0, 0, 1]
    assert [route(True, n, 4096, words) for n in (2, 8, 32)] == [0, 1, 1]
    assert route(True, 2, 16384, words) == 1
    assert route(True, 2, 8, 16) == 1  # a narrow plane: a row's worth at 16 entries


def test_one_plane():
    """A launch's planes are one plane only where every slot has slot 0's
    base address and row stride: the same tensor, or views that start at
    the same row and step alike; not copies, not two views of one stack
    with different row strides, not views that start on other rows."""
    def one(*planes):
        return kernels.one_plane([x.data_ptr() for x in planes], [x.stride(0) for x in planes])

    stack = torch.zeros((12, 64), dtype=torch.int32)
    flat = stack.view(-1)
    assert one(stack, stack, stack)
    assert one(stack, stack[:, :64], stack.view(12, 64))
    assert not one(stack[:6], stack[:6, 1:])
    assert not one(stack, stack.clone())
    assert not one(flat.as_strided((6, 64), (64, 1)), flat.as_strided((6, 64), (128, 1)))
    assert not one(stack[:6], stack[1:7])


def test_wave_slot_count():
    """A wave launch takes PACKED_WAVE_SLOTS slots: the kernel source's
    kWaveSlots and the coalescer's largest wave, so no coalesced wave is
    split."""
    cu = Path(kernels.__file__).resolve().parent.parent / "csrc" / "packed_kernels.cu"
    m = re.search(r"constexpr int kWaveSlots = (\d+);", cu.read_text())
    assert m and int(m.group(1)) == kernels.PACKED_WAVE_SLOTS == t_coalesce.MAX_BATCH


# -- the planner against the JAX planner -----------------------------------------


def _seed(h, FO, seed):
    """tests/test_residency.py's mixed data: rows 0-3 of f and g sparse
    (packable), rows 4-5 heavy, an int field v and the existence row."""
    rng = np.random.default_rng(seed)
    idx = h.create_index("rq")
    f, g = idx.create_field("f"), idx.create_field("g")
    v = idx.create_field("v", FO(type="int", min=-500, max=500))
    total = N_SHARDS * SHARD_WIDTH
    for field in (f, g):
        for r in range(4):
            n = int(rng.integers(50, 2000))
            field.import_bits(np.full(n, r), rng.integers(0, total, n))
        for r in (4, 5):
            field.import_bits(np.full(60000, r), rng.integers(0, total, 60000))
    vcols = rng.choice(total, 3000, replace=False)
    v.import_values(vcols.tolist(), rng.integers(-500, 500, len(vcols)).tolist())
    idx.add_existence(np.arange(0, total, 5))
    return idx


def _pair(seed):
    jh, th = JHolder(), THolder(device="cpu")
    _seed(jh, JFieldOptions, seed)
    _seed(th, TFieldOptions, seed)
    return jh, th


def _run(execute, to_json, queries, shards):
    out = []
    for q in queries:
        try:
            out.append(to_json(execute("rq", q, shards=shards)))
        except Exception as e:  # the same error from both packages
            out.append((type(e).__name__, str(e)))
    return out


@pytest.fixture(scope="module")
def mixed():
    return _pair(0)


@pytest.mark.parametrize("mode", ["off", "auto", "on"])
def test_every_query_family_matches_jax(mesh, mixed, monkeypatch, mode):
    """Both packages in ``mode``: every query family's answer equal to the
    JAX executor's, and (in auto and on) packed stacks resident, within
    auto's ratio, with the class bytes summing to the total."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", mode)
    jh, th = mixed
    shards = list(range(N_SHARDS))
    jp, tp = MeshPlanner(jh, mesh), Planner(th)
    try:
        want = _run(JExecutor(jh, planner=jp, result_cache=False).execute, j_json,
                    EQ_QUERIES, shards)
        got = _run(TExecutor(th, planner=tp, result_cache=False).execute, t_json,
                   EQ_QUERIES, shards)
        assert got == want
        classes = [k[6] for k in tp._stack_cache]
        st = tp.cache_stats()
        assert sum(st["class_bytes"].values()) == st["bytes"]
        assert st["residency_mode"] == mode
        if mode == "off":
            assert set(classes) == {residency.DENSE}
            return
        n_packed = classes.count(residency.PACKED)
        assert n_packed and st["class_bytes"][residency.PACKED] > 0
        if mode == "auto":
            assert st["class_bytes"][residency.PACKED] <= (
                n_packed * residency.dense_nbytes(tp._pad(N_SHARDS)) // residency.AUTO_RATIO)
    finally:
        jp.close()
        tp.close()


@pytest.mark.parametrize("seed", [1, 2])
def test_packed_equals_dense_generative(monkeypatch, seed):
    """The port alone, on other seeds: auto and on answer every query family
    exactly as off does."""
    th = THolder(device="cpu")
    _seed(th, TFieldOptions, seed)
    shards = list(range(N_SHARDS))
    answers = {}
    for mode in ("off", "auto", "on"):
        monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", mode)
        tp = Planner(th)
        try:
            answers[mode] = _run(TExecutor(th, planner=tp, result_cache=False).execute,
                                 t_json, EQ_QUERIES, shards)
        finally:
            tp.close()
    assert answers["auto"] == answers["off"] and answers["on"] == answers["off"]


#: Count shapes -> the wrapper calls the planner's program makes for them
#: (f=0..3 and g=0..3 packed, f=4 dense).
PROGRAMS = {
    "Count(Row(f=0))": ["packed_count"],
    "Count(Row(f=4))": ["row_counts"],
    "Count(Intersect(Row(f=1), Row(f=4)))": ["packed_and_dense_count"],
    "Count(Intersect(Row(f=4), Row(f=1)))": ["packed_and_dense_count"],
    "Count(Intersect(Row(f=1), Row(g=2)))": ["packed_pair_count"],
    "Count(Union(Row(f=0), Row(f=4)))": ["packed_expand", "pair_count"],
    "Count(Intersect(Row(f=0), Row(f=4), Row(g=5)))": ["packed_expand", "tree_count"],
    "Count(Intersect(Row(f=0), Row(g=0), Row(f=1)))": ["packed_expand"] * 3 + ["tree_count"],
    "Count(Not(Row(f=1)))": ["packed_expand", "pair_count"],
    "Row(f=1)": ["packed_expand"],
}


def test_planner_programs_by_spy(mesh, mixed, monkeypatch):
    """The program each Count shape runs, seen by spies on the wrappers
    (the JAX planner's _packed_count_program and _eval_node choices): the
    packed fast paths take the packed stack first, and every answer equals
    the JAX executor's."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "auto")
    calls = []
    names = ("packed_count", "packed_and_dense_count", "packed_pair_count",
             "packed_expand", "row_counts", "pair_count", "tree_count")

    def spy(name, real):
        def fn(*args, **kw):
            calls.append((name, [tuple(x.shape) for x in args
                                 if isinstance(x, torch.Tensor)]))
            return real(*args, **kw)
        return fn

    for name in names:
        monkeypatch.setattr(kernels, name, spy(name, getattr(kernels, name)))
    jh, th = mixed
    shards = list(range(N_SHARDS))
    jp, tp = MeshPlanner(jh, mesh), Planner(th)
    je = JExecutor(jh, planner=jp, result_cache=False)
    te = TExecutor(th, planner=tp, result_cache=False)
    try:
        for q, want_calls in PROGRAMS.items():
            calls.clear()
            got = t_json(te.execute("rq", q, shards=shards))
            assert got == j_json(je.execute("rq", q, shards=shards)), q
            assert [c[0] for c in calls] == want_calls, q
            if calls[0][0] in ("packed_and_dense_count", "packed_pair_count"):
                k = calls[0][1][0][1]
                assert k < WORDS_PER_SHARD and k == residency.pack_width(k), q
        fn, arrays = tp.prepare_count(th.index("rq"), parsed_call(
            "Intersect(Row(f=1), Row(g=2))"), shards)
        assert fn.packed and tp.fn_batched(fn) is not None  # packed_pair_count_batched
        assert [tuple(a.shape)[1] < WORDS_PER_SHARD for a in arrays] == [True, True]
        for text in ("Union(Row(f=4), Row(f=0))", "Not(Intersect(Row(f=4), Row(g=0)))"):
            fn, _ = tp.prepare_count(th.index("rq"), parsed_call(text), shards)
            assert fn.packed and tp.fn_batched(fn) is None, text
        fn, _ = tp.prepare_count(th.index("rq"), parsed_call(
            "Intersect(Row(f=4), Row(g=5))"), shards)
        assert not fn.packed and tp.fn_batched(fn) is not None
    finally:
        jp.close()
        tp.close()


def parsed_call(text: str):
    """The parsed call of a bitmap expression."""
    from pilosa_tpu_torch.pql import parse
    return parse(text).calls[0]


def test_grown_row_drops_its_plan(mesh, monkeypatch):
    """A packed row that grows past auto's ceiling drops its plan at the
    next query that names it, a Count or an aggregate's filter, which then
    runs dense; every query family's answer equals the JAX one before and
    after, and a row whose bits are cleared stays packed."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "auto")
    jh, th = _pair(7)
    shards = list(range(N_SHARDS))
    jp, tp = MeshPlanner(jh, mesh), Planner(th)
    je = JExecutor(jh, planner=jp, result_cache=False)
    te = TExecutor(th, planner=tp, result_cache=False)
    queries = EQ_QUERIES
    tidx = th.index("rq")

    def leaves_of(text):
        return [hit[0] for key, hit in tp._plan_cache.items() if key[3] == text]

    try:
        assert (_run(te.execute, t_json, queries, shards)
                == _run(je.execute, j_json, queries, shards))
        mixed = "Intersect(Row(f=1), Row(f=4))"
        assert leaves_of(mixed) == [[("prow", "f", "standard", 1), ("row", "f", "standard", 4)]]
        assert leaves_of("Row(f=0)") == [[("prow", "f", "standard", 0)]]
        sum_f1 = 'sum0:Sum(Row(f=1), field="v")'
        assert [lv[1:] for lv in leaves_of(sum_f1)] == [[("prow", "f", "standard", 1)]]
        rng = np.random.default_rng(8)
        grow = rng.choice(SHARD_WIDTH, 6000, replace=False)  # shard 0: K 8192
        more = rng.integers(0, N_SHARDS * SHARD_WIDTH, 500)
        cleared = [int(c) for c in tidx.field("f").row(0).columns()[:20]]
        for h in (jh, th):
            h.index("rq").field("f").import_bits(np.full(len(grow), 1), grow)
            h.index("rq").field("g").import_bits(np.full(len(more), 5), more)
            for col in cleared:
                h.index("rq").field("f").clear_bit(0, col)
        assert (_run(te.execute, t_json, queries, shards)
                == _run(je.execute, j_json, queries, shards))
        assert leaves_of(mixed) == [[("row", "f", "standard", 1), ("row", "f", "standard", 4)]]
        assert leaves_of("Row(f=0)") == [[("prow", "f", "standard", 0)]]
        assert [lv[1:] for lv in leaves_of(sum_f1)] == [[("row", "f", "standard", 1)]]
    finally:
        jp.close()
        tp.close()


def test_oversubscribed_prefetch_with_packed_leaves(mesh, monkeypatch):
    """tests/test_residency.py's drill with packed leaves: 6 packed stacks
    through a budget of 3, the prefetcher on; evictions churn, no query
    thread uploads a stack itself, and every answer equals the JAX node's."""
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", "auto")
    monkeypatch.setenv("PILOSA_TPU_PREFETCH", "on")
    n_shards = 8
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, n_shards * SHARD_WIDTH, 2000) for _ in range(6)]
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        f = h.create_index("ov").create_field("f")
        for r, cols in enumerate(rows):
            f.import_bits(np.full(2000, r), cols)
    k = max(residency.pack_width(th.fragment("ov", "f", "standard", s).row_cardinality(r))
            for s in range(n_shards) for r in range(6))
    planner = Planner(th, max_cache_bytes=3 * residency.packed_nbytes(8, k))
    e = TExecutor(th, planner=planner, result_cache=False)
    je = JExecutor(jh, planner=MeshPlanner(jh, mesh), result_cache=False)
    shards = list(range(n_shards))
    try:
        for _ in range(2):  # 12 misses through 3 slots
            for r in range(6):
                q = f"Count(Row(f={r}))"
                assert e.execute("ov", q, shards=shards) == je.execute("ov", q,
                                                                      shards=shards)
        assert {key[6] for key in planner._stack_cache} == {residency.PACKED}
        assert planner.cache_stats()["evictions"] > 0
        dbg = planner.prefetcher.debug()
        assert dbg["sync_misses"] == 0
        assert dbg["hits"] > 0
        assert dbg["completed"] == dbg["scheduled"] >= 6
        assert dbg["inflight"] == 0 and dbg["queued"] == 0
    finally:
        planner.close()
        je.planner.close()
