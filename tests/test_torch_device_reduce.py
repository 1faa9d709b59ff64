"""The coordinator's device reduce (pilosa_tpu_torch/exec/device_reduce.py)
against the JAX package's (pilosa_tpu/exec/device_reduce.py): the plain
``scatter_bits`` and ``or_fold`` against ``_scatter_bits`` and ``_or_fold``
on the same inputs, exact, and ``row_from_columns`` and ``union_rows``
under ``on``, ``off`` and ``auto``. The kernels themselves run only on the
card (``chip_smoke.check_reduce_kernels`` holds them to these plain
versions there)."""

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


@pytest.mark.parametrize("shards,n", [([0], 1), ([0, 3, 7], 40), ([1, 2, 5, 9], 20_000), ([], 0)])
def test_row_from_columns_matches_jax(both_modes, shards, n):
    rng = np.random.default_rng(n)
    cols = _columns(rng, shards, n) if n else np.empty(0, np.uint64)
    cols = np.concatenate([cols, cols[:3]])  # a leg's decode never repeats; the host path may
    calls = []
    real = kernels.scatter_bits

    def spy(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    kernels.scatter_bits = spy
    try:
        got = t_dr.row_from_columns(cols, CPU)
    finally:
        kernels.scatter_bits = real
    want = j_dr.row_from_columns(cols)
    assert np.array_equal(got.columns(), want.columns())
    assert sorted(got.segments) == sorted(want.segments)
    on_device = both_modes == "on" or (both_modes == "auto" and len(cols) >= 5000)
    assert len(calls) == (1 if on_device and len(np.unique(cols)) else 0)
    if calls:  # one launch for every shard of the leg, segments int32 tensors
        assert calls == [len(shards)]
        assert all(isinstance(s, torch.Tensor) and s.dtype == torch.int32
                   for s in got.segments.values())


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
