"""The coordinator's device reduce (pilosa_tpu_torch/exec/device_reduce.py)
against the JAX package's (pilosa_tpu/exec/device_reduce.py): the plain
``scatter_bits_grouped``, ``scatter_bits`` and ``or_fold`` against
``_scatter_bits`` and ``_or_fold`` on the same inputs, exact, and
``row_from_columns`` and ``union_rows`` under ``on``, ``off`` and
``auto``. The kernels themselves run only on the card
(``chip_smoke.check_reduce_kernels`` holds them to these plain versions
there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.exec import device_reduce as j_dr
from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec import device_reduce as t_dr
from pilosa_tpu_torch.ops import kernels

W = WORDS_PER_SHARD
CPU = torch.device("cpu")


def _jax_scatter(seg: np.ndarray, local: np.ndarray, n_segs: int) -> np.ndarray:
    """The JAX package's scatter on the positions as its row_from_columns
    lays them out: word index and bit value a position, n_segs static."""
    words = j_dr._scatter_bits(jnp.asarray(seg), jnp.asarray(local >> 5),
                               jnp.asarray(np.left_shift(np.uint32(1),
                                                         (local & 31).astype(np.uint32))),
                               n_segs)
    return np.asarray(words)


# The JAX scatter wraps a negative index where the port's plain version
# drops it: out_of_range is held to the contract on its own below.
@pytest.mark.parametrize("name", [c for c in chip_smoke.SCATTER_CASES if c != "out_of_range"])
def test_scatter_bits_plain_matches_jax(name):
    seg, local, n_segs = chip_smoke.scatter_case(name)
    got = kernels.scatter_bits(torch.from_numpy(seg), torch.from_numpy(local), n_segs)
    assert got.dtype == torch.int32 and got.shape == (n_segs + 1, W)
    want = _jax_scatter(seg, local, n_segs)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_scatter_bits_edges():
    """Bit 31 of word 32767, the padding sink, and entries out of range
    dropped; a repeated position sets its bit once."""
    seg = torch.tensor([0, 0, 1, 2, -1, 3, 0, 0], dtype=torch.int32)
    local = torch.tensor([32 * 32767 + 31, 0, 7, 9, 5, 5, 32 * W, 0], dtype=torch.int32)
    out = kernels.scatter_bits(seg, local, 2)
    assert out.shape == (3, W)
    assert int(out[0, 32767]) == -2**31 and int(out[0, 0]) == 1
    assert int(out[1, 0]) == 1 << 7 and int(out[2, 0]) == 1 << 9  # row 2: the sink
    assert int(kernels.row_counts(out).sum()) == 4
    assert not kernels.scatter_bits(seg[:0], local[:0], 0).any()


def _grouped_starts(seg: np.ndarray, n_segs: int) -> np.ndarray:
    """Row starts of positions grouped by segment, by searchsorted."""
    return np.searchsorted(seg, np.arange(n_segs + 2)).astype(np.int32)


#: the SCATTER_CASES whose positions are grouped by segment.
GROUPED_CASES = [c for c in chip_smoke.SCATTER_CASES if c in chip_smoke.GROUPED_SCATTER_CASES]


@pytest.mark.parametrize("name", chip_smoke.SCATTER_CASES)
def test_grouped_cases_are_the_card_checks(name):
    """Every SCATTER_CASES case whose positions are grouped by segment is
    one of the card's grouped checks; grouped_case refuses the others."""
    if name in GROUPED_CASES:
        chip_smoke.grouped_case(name)
    else:
        with pytest.raises(ValueError):
            chip_smoke.grouped_case(name)


@pytest.mark.parametrize("name", GROUPED_CASES + ["empty_rows", "dense_unaligned"])
def test_scatter_bits_grouped_plain_matches_jax(name):
    seg, local, n_segs = chip_smoke.scatter_case(name)
    starts = _grouped_starts(seg, n_segs)
    assert np.array_equal(starts, chip_smoke.grouped_case(name)[0])
    got = kernels.scatter_bits_grouped(torch.from_numpy(starts), torch.from_numpy(local))
    assert got.dtype == torch.int32 and got.shape == (n_segs + 1, W)
    assert np.array_equal(got.numpy().view(np.uint32), _jax_scatter(seg, local, n_segs))


@pytest.mark.parametrize("name", chip_smoke.GROUPED_SCATTER_CASES)
def test_scatter_bits_grouped_plain_matches_general(name):
    """Every card check of the grouped form (offsets out of range too,
    which the JAX scatter wraps) equals the general form on the same
    positions."""
    starts, local, n_segs = chip_smoke.grouped_case(name)
    seg, _, _ = chip_smoke.scatter_case(name)
    got = kernels.scatter_bits_grouped(torch.from_numpy(starts), torch.from_numpy(local))
    want = kernels.scatter_bits(torch.from_numpy(seg), torch.from_numpy(local), n_segs)
    assert torch.equal(got, want)
    if name == "offsets_out_of_range":  # only 3 and bits - 1 of row 1 and 64 kept
        assert int(kernels.row_counts(got).sum()) == 3
        assert int(got[0, 0]) == 1 << 3 and int(got[1, W - 1]) == -2**31
        assert int(got[2, 2]) == 1


def test_scatter_bits_grouped_edges():
    """Bit 31 of word 32767, an empty row, the sink, positions before
    starts[0] belonging to no row, and any order within a row."""
    local = torch.tensor([5, 32 * W - 1, 0, 9, 40, 33, 7], dtype=torch.int32)
    starts = torch.tensor([1, 3, 3, 6, 7], dtype=torch.int32)  # rows 0-2, the sink row 3
    out = kernels.scatter_bits_grouped(starts, local)
    assert out.shape == (4, W)
    assert int(out[0, W - 1]) == -2**31 and int(out[0, 0]) == 1  # local[0] is in no row
    assert not out[1].any()
    assert int(out[2, 0]) == 1 << 9 and int(out[2, 1]) == (1 << 8) | (1 << 1)
    assert int(out[3, 0]) == 1 << 7
    shuffled = kernels.scatter_bits_grouped(starts, local[[0, 2, 1, 5, 3, 4, 6]])
    assert torch.equal(shuffled, out)
    empty = kernels.scatter_bits_grouped(torch.zeros(2, dtype=torch.int32),
                                         torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (1, W) and not empty.any()


@pytest.mark.parametrize("starts", [
    [0, 3, 2, 4],      # decreasing
    [0, 1, 2, 3],      # ends short of len(local)
    [0, 1, 2, 5],      # ends past it
    [-1, 1, 2, 4],     # begins before the buffer
])
def test_scatter_bits_grouped_plain_refuses_bad_starts(starts):
    local = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.scatter_bits_grouped_plain(torch.tensor(starts, dtype=torch.int32), local)
    with pytest.raises(ValueError):
        kernels.scatter_bits_grouped(torch.tensor(starts, dtype=torch.int32), local)


@pytest.mark.parametrize("bad", [
    lambda st, l: kernels.scatter_bits_grouped(st.long(), l),
    lambda st, l: kernels.scatter_bits_grouped(st, l.long()),
    lambda st, l: kernels.scatter_bits_grouped(st[:1], l),
    lambda st, l: kernels.scatter_bits_grouped(st.reshape(1, 3), l),
    lambda st, l: kernels.scatter_bits_grouped(st, l, 1000),
    lambda st, l: kernels.scatter_bits_grouped(st, l, 32),
    lambda st, l: kernels.scatter_bits_grouped(st, l, 2**20),
    lambda st, l: kernels.scatter_bits_grouped(st.tolist(), l),
])
def test_scatter_bits_grouped_refuses_bad_input(bad):
    with pytest.raises((TypeError, ValueError)):
        bad(torch.tensor([0, 2, 3], dtype=torch.int32), torch.arange(3, dtype=torch.int32))


@pytest.mark.parametrize("bad", [
    lambda s, l: kernels.scatter_bits(s.long(), l, 1),
    lambda s, l: kernels.scatter_bits(s, l[:1], 1),
    lambda s, l: kernels.scatter_bits(s, l, -1),
    lambda s, l: kernels.or_fold(torch.zeros(2, W, dtype=torch.int32)),
    lambda s, l: kernels.or_fold(torch.zeros(2, 2, W, dtype=torch.int64)),
    lambda s, l: kernels.or_fold(torch.zeros(2, 2, 33, dtype=torch.int32)),
])
def test_wrappers_refuse_bad_input(bad):
    s = torch.zeros(3, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        bad(s, s.clone())


@pytest.mark.parametrize("b,k", [(4, 1), (64, 2), (8, 16), (3, 5)])
def test_or_fold_plain_matches_jax(b, k):
    rng = np.random.default_rng(b * 100 + k)
    stack = rng.integers(0, 2**32, (b, k, W), dtype=np.uint64).astype(np.uint32)
    stack[0, :, 0] = 0xFFFFFFFF  # all ones
    stack[-1, :, -1] = 1 << 31   # bit 31
    got = kernels.or_fold(torch.from_numpy(stack.view(np.int32)))
    want = np.asarray(j_dr._or_fold(jnp.asarray(stack)))
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.fixture(params=["on", "off", "auto"])
def both_modes(request, monkeypatch):
    """Both packages' device reduce in one mode (the env var sets both)."""
    monkeypatch.setenv("PILOSA_TPU_DEVICE_REDUCE", request.param)
    if request.param == "auto":
        # a pinned crossover between the small and the large inputs below
        monkeypatch.setenv("PILOSA_TPU_DEVICE_REDUCE_MIN", "5000")
    return request.param


def _columns(rng, shards, n) -> np.ndarray:
    cols = rng.integers(0, SHARD_WIDTH, n).astype(np.uint64)
    return cols + np.uint64(SHARD_WIDTH) * rng.choice(shards, n).astype(np.uint64)


@pytest.fixture
def scatter_spies(monkeypatch):
    """Calls of both scatter forms: the grouped form's row starts, the
    general form's segment counts."""
    calls = {"grouped": [], "general": []}
    grouped, general = kernels.scatter_bits_grouped, kernels.scatter_bits

    def spy_grouped(starts, local, *a, **kw):
        calls["grouped"].append(starts.tolist())
        return grouped(starts, local, *a, **kw)

    def spy_general(*a, **kw):
        calls["general"].append(a[2])
        return general(*a, **kw)

    monkeypatch.setattr(kernels, "scatter_bits_grouped", spy_grouped)
    monkeypatch.setattr(kernels, "scatter_bits", spy_general)
    return calls


@pytest.mark.parametrize("shards,n", [([0], 1), ([0, 3, 7], 40), ([1, 2, 5, 9], 20_000), ([], 0)])
def test_row_from_columns_matches_jax(both_modes, scatter_spies, shards, n):
    rng = np.random.default_rng(n)
    cols = _columns(rng, shards, n) if n else np.empty(0, np.uint64)
    cols = np.concatenate([cols, cols[:3]])  # a leg's decode never repeats; the host path may
    got = t_dr.row_from_columns(cols, CPU)
    want = j_dr.row_from_columns(cols)
    assert np.array_equal(got.columns(), want.columns())
    assert sorted(got.segments) == sorted(want.segments)
    on_device = both_modes == "on" or (both_modes == "auto" and len(cols) >= 5000)
    calls = scatter_spies["grouped"]
    assert len(calls) == (1 if on_device and len(np.unique(cols)) else 0)
    assert scatter_spies["general"] == []
    if calls:  # one launch for every shard of the leg, segments int32 tensors
        assert len(calls[0]) == len(shards) + 2
        assert all(isinstance(s, torch.Tensor) and s.dtype == torch.int32
                   for s in got.segments.values())


def _leg(kind: str, seed: int) -> np.ndarray:
    """A remote leg's columns: one position; shards whose last holds bit 31
    of word 32767 (its last column); or 12 shards spread over 954."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        return np.array([rng.integers(0, 954 * SHARD_WIDTH)], np.uint64)
    shards = np.sort(rng.choice(954, 3 if kind == "bit31_last_shard" else 12, replace=False))
    cols = _columns(rng, shards, 9000)
    if kind == "bit31_last_shard":
        cols = np.r_[cols, np.uint64((int(shards[-1]) + 1) * SHARD_WIDTH - 1)]
    return rng.permutation(cols)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", ["one", "bit31_last_shard", "spread"])
def test_row_from_columns_legs_match_jax(both_modes, scatter_spies, kind, seed):
    """The device path builds the same rows as the JAX package's from ONE
    grouped scatter and no general one; the host path from none."""
    cols = _leg(kind, seed)
    got = t_dr.row_from_columns(cols, CPU)
    want = j_dr.row_from_columns(cols)
    assert np.array_equal(got.columns(), want.columns())
    assert sorted(got.segments) == sorted(want.segments)
    for s, seg in want.segments.items():
        assert np.array_equal(np.asarray(got.segments[s]).view(np.uint32), np.asarray(seg))
    on_device = both_modes == "on" or (both_modes == "auto" and len(cols) >= 5000)
    assert len(scatter_spies["grouped"]) == int(on_device)
    assert scatter_spies["general"] == []
    if kind == "bit31_last_shard":
        last = max(got.segments)
        assert int(np.asarray(got.segments[last]).view(np.uint32)[W - 1]) >> 31 == 1


def test_leg_buffer_is_one_aligned_upload():
    """The device path's one int32 buffer: the row starts (found by
    searchsorted, the sink row empty) padded to 16 bytes, then every
    offset; dense and far-apart shard ids alike."""
    rng = np.random.default_rng(7)
    for shards in ([0], [0, 3, 7], [2, 5, 10**9], [2**43], list(range(40))):
        cols = np.unique(_columns(rng, shards, 300))
        ref_shards, ref_starts = np.unique(cols // np.uint64(SHARD_WIDTH), return_index=True)
        got_shards, got_starts = t_dr.shard_starts(cols)
        assert np.array_equal(got_shards, ref_shards)
        assert np.array_equal(got_starts, ref_starts)
        sh, buf, head = t_dr.leg_buffer(cols)
        k = len(sh)
        assert buf.dtype == np.int32 and head % 4 == 0 and head >= k + 2
        assert np.array_equal(buf[:k], ref_starts) and (buf[k:head] == len(cols)).all()
        assert np.array_equal(buf[head:], (cols % np.uint64(SHARD_WIDTH)).astype(np.int32))


@pytest.mark.parametrize("kind", ["ascending", "unsorted", "repeats", "one", "empty"])
def test_sorted_unique_is_np_unique(kind):
    """The device path's dedupe equals np.unique on any input, and hands a
    strictly ascending leg (a decoded roaring leg) back as it is."""
    rng = np.random.default_rng(11)
    cols = np.unique(rng.integers(0, 40 * SHARD_WIDTH, 5000).astype(np.uint64))
    cols = {"ascending": cols, "unsorted": rng.permutation(cols),
            "repeats": np.sort(np.r_[cols, cols[::7]]), "one": cols[:1],
            "empty": cols[:0]}[kind]
    got = t_dr.sorted_unique(cols)
    assert got.dtype == np.uint64 and np.array_equal(got, np.unique(cols))
    if kind in ("ascending", "one", "empty"):
        assert got is cols


def test_device_path_uploads_once(monkeypatch):
    """Under ``on`` a leg goes to the device as ONE host-to-device copy."""
    monkeypatch.setenv("PILOSA_TPU_DEVICE_REDUCE", "on")
    copies = []
    real = torch.Tensor.to

    def spy(self, *a, **kw):
        if "device" in kw or (a and isinstance(a[0], (torch.device, str))):
            copies.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    cols = np.sort(_leg("spread", 4))  # ascending, as a decoded leg is
    got = t_dr.row_from_columns(cols, CPU)
    monkeypatch.undo()
    assert copies == [(len(np.unique(cols)) + 16,)]  # 12 shards: 14 starts padded to 16
    assert np.array_equal(got.columns(), j_dr.row_from_columns(cols).columns())


def _legs(rng, shard_sets, n):
    cols = [_columns(rng, s, n) for s in shard_sets]
    return cols, [Row.from_columns(c) for c in cols], [JRow.from_columns(c) for c in cols]


@pytest.mark.parametrize("shard_sets", [
    [[0, 1]],                      # one leg passes through
    [[0, 1], [2, 3]],              # disjoint shards: a dict merge
    [[0, 1], [1, 2], [1, 5]],      # shard 1 contested three ways
    [[4], [4], [4], [4], [4]],     # one shard, five legs
])
def test_union_rows_matches_jax(both_modes, shard_sets):
    rng = np.random.default_rng(len(shard_sets))
    cols, t_legs, j_legs = _legs(rng, shard_sets, 3000)
    # int32 tensor segments, as a leg's decode under "on" makes them
    t_legs = [Row({s: torch.from_numpy(np.asarray(seg).view(np.int32).copy())
                   for s, seg in r.segments.items()}) for r in t_legs]
    folds = []
    real = kernels.or_fold

    def spy(stack):
        folds.append(tuple(stack.shape))
        return real(stack)

    kernels.or_fold = spy
    try:
        got = t_dr.union_rows(t_legs + [None])
    finally:
        kernels.or_fold = real
    want = j_dr.union_rows(j_legs)
    assert np.array_equal(got.columns(), want.columns())
    assert np.array_equal(got.columns(), np.unique(np.concatenate(cols)))
    contested = [s for s in {x for ss in shard_sets for x in ss}
                 if sum(s in ss for ss in shard_sets) > 1]
    n_words = sum(sum(s in ss for ss in shard_sets) for s in contested) * W
    on_device = contested and (both_modes == "on" or (both_modes == "auto" and n_words >= 5000))
    if on_device:
        k = max(sum(s in ss for ss in shard_sets) for s in contested)
        assert folds == [(len(contested), k, W)]
    else:
        assert folds == []
    if len(shard_sets) == 1:
        assert got is t_legs[0]
    assert t_dr.union_rows([None]) is None and t_dr.union_rows([]) is None


def test_mode_knob_and_env(monkeypatch):
    """``set_mode`` is the server knob; PILOSA_TPU_DEVICE_REDUCE wins over
    it in both packages."""
    monkeypatch.delenv("PILOSA_TPU_DEVICE_REDUCE", raising=False)
    try:
        for mode in ("on", "off", "auto"):
            t_dr.set_mode(mode)
            j_dr.set_mode(mode)
            assert t_dr.mode() == j_dr.mode() == mode
        monkeypatch.setenv("PILOSA_TPU_DEVICE_REDUCE", "off")
        t_dr.set_mode("on")
        assert t_dr.mode() == "off"
        with pytest.raises(ValueError):
            t_dr.set_mode("sometimes")
    finally:
        t_dr.set_mode("auto")
        j_dr.set_mode("auto")


def test_auto_crossover_is_measured_once_and_clamped(monkeypatch):
    """``auto``'s crossover follows the JAX rule: a host round trip of the
    fold against numpy's OR a word, clamped to [W, 256 W], measured once a
    device and kept for it; the _MIN env pins it."""
    monkeypatch.delenv("PILOSA_TPU_DEVICE_REDUCE_MIN", raising=False)
    monkeypatch.setattr(t_dr, "_calibrated", {})
    assert str(CPU) not in t_dr._calibrated
    x = t_dr._min_size(CPU)
    assert W <= x <= 256 * W
    assert t_dr._calibrated[str(CPU)] == x == t_dr._min_size(CPU)
    monkeypatch.setenv("PILOSA_TPU_DEVICE_REDUCE_MIN", "123")
    assert t_dr._min_size(CPU) == 123
