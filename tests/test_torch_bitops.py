"""The port's bitops (numpy host half, int32-tensor device half) against
pilosa_tpu.ops.bitops on the same seeded inputs. Exact comparisons."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitops as jbit
from pilosa_tpu_torch.config import WORDS_PER_SHARD
from pilosa_tpu_torch.ops import bitops as tbit
from pilosa_tpu_torch.ops import kernels


def _words(rng, shape):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = w.reshape(-1)
    flat[::7] = 0xFFFFFFFF
    flat[3::11] = 0x80000000
    return w


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _host(t):
    return t.numpy().view(np.uint32)


# -- host half ---------------------------------------------------------------

def test_positions_words_roundtrip(rng):
    pos = np.unique(rng.integers(0, WORDS_PER_SHARD * 32, 5000, dtype=np.uint64))
    w_t = tbit.positions_to_words(pos)
    np.testing.assert_array_equal(w_t, jbit.positions_to_words(pos))
    np.testing.assert_array_equal(tbit.words_to_positions(w_t),
                                  jbit.words_to_positions(w_t))
    np.testing.assert_array_equal(tbit.words_to_positions(w_t), pos)
    assert tbit.np_count(w_t) == jbit.np_count(w_t) == len(pos)


@pytest.mark.parametrize("start,stop", [(0, 1), (5, 37), (31, 33), (64, 64),
                                        (100, 1 << 20), (-3, 10)])
def test_range_mask(start, stop):
    np.testing.assert_array_equal(tbit.np_range_mask(start, stop),
                                  jbit.np_range_mask(start, stop))


def test_set_get_clear_bit():
    a, b = tbit.np_zero_row(), jbit.np_zero_row()
    for pos in (0, 31, 32, 1000, WORDS_PER_SHARD * 32 - 1):
        assert tbit.np_set_bit(a, pos) == jbit.np_set_bit(b, pos) is True
        assert tbit.np_set_bit(a, pos) == jbit.np_set_bit(b, pos) is False
        assert tbit.np_get_bit(a, pos) and jbit.np_get_bit(b, pos)
    np.testing.assert_array_equal(a, b)
    assert tbit.np_clear_bit(a, 31) == jbit.np_clear_bit(b, 31) is True
    assert tbit.np_clear_bit(a, 31) == jbit.np_clear_bit(b, 31) is False
    np.testing.assert_array_equal(a, b)


def test_columns_of_tensor_and_numpy(rng):
    w = _words(rng, (300,))
    want = jbit.columns_of(w, base=1 << 20)
    np.testing.assert_array_equal(tbit.columns_of(w, base=1 << 20), want)
    np.testing.assert_array_equal(tbit.columns_of(_t(w), base=1 << 20), want)


def test_device_word_roundtrip(rng):
    w = _words(rng, (3, 100))
    t = tbit.to_device_words(w, torch.device("cpu"))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tbit.to_host_words(t), w)


# -- device half -------------------------------------------------------------

@pytest.mark.parametrize("tname,jname", [
    ("b_and", "b_and"), ("b_or", "b_or"), ("b_xor", "b_xor"),
    ("b_andnot", "b_andnot"),
])
def test_binary_ops(rng, tname, jname):
    a, b = _words(rng, (4, 999)), _words(rng, (4, 999))
    got = getattr(tbit, tname)(_t(a), _t(b))
    want = np.asarray(getattr(jbit, jname)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_host(got), want)


def test_popcount_words(rng):
    a = _words(rng, (4, 999))
    np.testing.assert_array_equal(tbit.popcount_words(_t(a)).numpy(),
                                  np.asarray(jbit.popcount_words(jnp.asarray(a))))


#: the JAX package's fused counts -> the op of the port's plain pair count.
_COUNT_OPS = {"intersection_count": "and", "union_count": "or",
              "difference_count": "andnot", "xor_count": "xor"}


@pytest.mark.parametrize("name", ["count", *_COUNT_OPS])
def test_counts(rng, name):
    a, b = _words(rng, (2, 3, 999)), _words(rng, (2, 3, 999))
    if name == "count":
        got = tbit.count(_t(a))
        want = jbit.count(jnp.asarray(a))
    else:
        got = kernels.pair_count_plain(_t(a), _t(b), _COUNT_OPS[name])
        want = getattr(jbit, name)(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
