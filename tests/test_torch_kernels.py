"""The port's count kernels on CPU tensors (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode.

Counts are integers: every comparison is exact. The CUDA kernels
themselves run only on the card and are checked against these same plain
versions by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import pallas_kernels
from pilosa_tpu_torch.ops import build, kernels

OPS = ["and", "or", "xor", "andnot"]


def _words(rng, shape):
    """Random uint32 words with all-ones, sign-bit-only and zero words
    mixed in (the int32 view of 0xFFFFFFFF is -1, of 0x80000000 INT_MIN)."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = w.reshape(-1)
    n = flat.size
    flat[rng.choice(n, n // 8, replace=False)] = 0xFFFFFFFF
    flat[rng.choice(n, n // 8, replace=False)] = 0x80000000
    flat[rng.choice(n, n // 16, replace=False)] = 0
    return w


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.fixture(autouse=True)
def _launch_counts_stay_zero():
    """Every CPU call takes the plain version: no kernel launch is ever
    counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("shape_a,shape_b", [
    ((5, 6244), (5, 6244)),
    ((2, 3, 6244), (2, 3, 6244)),
    ((7, 2048), (2048,)),
    ((7, 2048), (1, 2048)),
    ((2048,), (4, 2048)),
    ((3, 4, 2048), (4, 2048)),
    ((4, 2048), (3, 4, 2048)),
    ((5, 3, 2, 2048), (1, 3, 2, 2048)),
], ids=["2d", "3d", "bcast-w", "bcast-1w", "bcast-left", "bcast-cube",
        "bcast-cube-left", "bcast-suffix-4d"])
@pytest.mark.parametrize("op", OPS)
def test_pair_count_matches_pallas(rng, op, shape_a, shape_b):
    a = _words(rng, shape_a)
    b = _words(rng, shape_b)
    want = np.asarray(pallas_kernels.pair_count(jnp.asarray(a), jnp.asarray(b), op))
    got = kernels.pair_count(_t(a), _t(b), op)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(5, 6244), (2, 3, 6244), (6244,)],
                         ids=["2d", "3d", "1d"])
def test_row_counts_matches_pallas(rng, shape):
    a = _words(rng, shape)
    a2 = a.reshape(-1, shape[-1])
    want = np.asarray(pallas_kernels.row_counts(jnp.asarray(a2))).reshape(shape[:-1])
    got = kernels.row_counts(_t(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_extreme_rows(rng):
    """All-ones rows count W*32; sign-bit-only rows count W."""
    w = 6244
    ones = np.full((2, w), 0xFFFFFFFF, dtype=np.uint32)
    sign = np.full((2, w), 0x80000000, dtype=np.uint32)
    assert kernels.row_counts(_t(ones)).tolist() == [w * 32] * 2
    assert kernels.row_counts(_t(sign)).tolist() == [w] * 2
    assert kernels.pair_count(_t(ones), _t(sign), "andnot").tolist() == [w * 31] * 2
    assert kernels.pair_count(_t(sign), _t(ones), "xor").tolist() == [w * 31] * 2


def test_strided_rows_and_slices(rng):
    """A row sliced out of a stack, and a stack whose rows are wider than
    the counted words, count like their contiguous copies."""
    a = _words(rng, (6, 4100))
    b = _words(rng, (6, 4100))
    ta, tb = _t(a), _t(b)
    sub_a, sub_b = ta[:, 3:4099], tb[:, 3:4099]  # row stride 4100, offset 3
    want = np.asarray(pallas_kernels.pair_count(
        jnp.asarray(a[:, 3:4099]), jnp.asarray(b[:, 3:4099]), "and"))
    np.testing.assert_array_equal(kernels.pair_count(sub_a, sub_b, "and").numpy(), want)
    np.testing.assert_array_equal(
        kernels.pair_count(sub_a, tb[2, 3:4099], "or").numpy(),
        np.asarray(pallas_kernels.pair_count(jnp.asarray(a[:, 3:4099]),
                                             jnp.asarray(b[2, 3:4099]), "or")))
    np.testing.assert_array_equal(
        kernels.row_counts(sub_a).numpy(),
        np.asarray(pallas_kernels.row_counts(jnp.asarray(a[:, 3:4099]))))


def test_pair_count_cube_against_class_rows(rng):
    """BSI Sum's shape: a [D, S, W] magnitude cube against one [S, W] class
    row per shard, in one call, with the [S, W] operand a row-sliced view;
    equal to the Pallas kernel and to counting plane by plane."""
    cube = _words(rng, (17, 8, 2048))
    rows = _words(rng, (8, 2048))
    want = np.asarray(pallas_kernels.pair_count(jnp.asarray(cube), jnp.asarray(rows),
                                                "and"))
    got = kernels.pair_count(_t(cube), _t(rows), "and")
    assert tuple(got.shape) == (17, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    per_plane = np.stack([kernels.pair_count(_t(cube[d]), _t(rows), "and").numpy()
                          for d in range(17)])
    np.testing.assert_array_equal(got.numpy(), per_plane)
    wide = _t(_words(rng, (8, 4096)))
    np.testing.assert_array_equal(
        kernels.pair_count(_t(cube), wide[:, 100:2148], "andnot").numpy(),
        np.asarray(pallas_kernels.pair_count(jnp.asarray(cube),
                                             jnp.asarray(wide.numpy()[:, 100:2148]
                                                         .view(np.uint32)),
                                             "andnot")))


def test_zero_pad_rows_count_zero(rng):
    """Pow2 pad rows of a stack are zeros and count 0 against any filter."""
    stack = np.zeros((8, 2048), dtype=np.uint32)
    stack[:5] = _words(rng, (5, 2048))
    filt = _words(rng, (2048,))
    got = kernels.pair_count(_t(stack), _t(filt), "and").numpy()
    assert got[5:].tolist() == [0, 0, 0]
    assert kernels.row_counts(_t(stack)).numpy()[5:].tolist() == [0, 0, 0]


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.to(torch.int64), TypeError),
    (lambda a: a.t(), ValueError),            # word axis not contiguous
    (lambda a: a[:, :0], ValueError),         # empty word axis
    (lambda a: a.to("meta"), ValueError),     # neither CPU nor CUDA
], ids=["dtype", "stride", "empty", "device"])
def test_wrapper_refuses(rng, bad, err):
    a = _t(_words(rng, (4, 64)))
    with pytest.raises(err):
        kernels.row_counts(bad(a))
    with pytest.raises(err):
        kernels.pair_count(bad(a), bad(a), "and")


def test_pair_count_refuses_mismatch(rng):
    a = _t(_words(rng, (4, 64)))
    with pytest.raises(ValueError):
        kernels.pair_count(a, _t(_words(rng, (4, 32))), "and")   # word axes
    with pytest.raises(ValueError):
        kernels.pair_count(a, _t(_words(rng, (2, 3, 64))), "and")  # no bcast
    with pytest.raises(ValueError):  # broadcasts, but not as a row or a suffix
        kernels.pair_count(_t(_words(rng, (2, 1, 64))), _t(_words(rng, (2, 3, 64))),
                           "and")
    with pytest.raises(ValueError):
        kernels.pair_count(a, a, "nand")


def test_library_path_keyed_by_source(tmp_path, monkeypatch):
    """The built library is named by a hash of its source: an edited
    source gets a new path, so it is rebuilt."""
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    p1 = build.library_path("k.cu")
    src.write_text("// two\n")
    p2 = build.library_path("k.cu")
    assert p1 != p2
    assert p1.parent == build.BUILD_DIR and p1.name.startswith("k-")
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")


def test_library_path_keyed_by_headers(tmp_path, monkeypatch):
    """A shared header (``csrc/*.cuh``, such as bulk_ring.cuh) is part of
    every library's name: editing it rebuilds the sources that include it."""
    (tmp_path / "k.cu").write_text('#include "ring.cuh"\n')
    hdr = tmp_path / "ring.cuh"
    hdr.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    p1 = build.library_path("k.cu")
    hdr.write_text("// two\n")
    assert build.library_path("k.cu") != p1
