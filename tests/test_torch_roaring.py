"""The port's roaring codec, numpy and native, against the JAX package's.

The cases of tests/test_roaring.py run against ``pilosa_tpu_torch.roaring``
(numpy) and ``pilosa_tpu_torch.native`` (the shared C++ codec, built by
the port's own loader into ``build/native/``). On the same seeded
positions, every encoding is byte-equal to the JAX package's, numpy and
native, and every decoding equal, the official format with run
containers included.
"""

import struct

import numpy as np
import pytest

from pilosa_tpu import native as j_native
from pilosa_tpu import roaring as j_roaring
from pilosa_tpu_torch import native, roaring
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.fragment import Fragment
from test_roaring import _official_no_runs, _official_runs


def cases(rng):
    yield np.empty(0, dtype=np.uint64)                       # empty
    yield np.array([0], dtype=np.uint64)                     # single
    yield np.arange(100, dtype=np.uint64)                    # one run
    yield np.array([1, 5, 9, 70000, 70001], dtype=np.uint64)  # array+run mix
    yield np.uint64(1) << np.arange(16, 40, dtype=np.uint64)  # sparse keys
    dense = rng.choice(1 << 16, 60000, replace=False).astype(np.uint64)
    yield np.sort(dense)                                     # bitmap container
    multi = rng.choice(1 << 22, 50000, replace=False).astype(np.uint64)
    yield np.sort(multi)                                     # many containers
    yield np.arange(0, 1 << 16, dtype=np.uint64)             # full run container


def _case(i):
    return list(cases(np.random.default_rng(42)))[i]


@pytest.mark.parametrize("case_i", range(8))
def test_roundtrip_numpy(case_i):
    pos = _case(case_i)
    assert np.array_equal(roaring.decode(roaring.encode(pos)), pos)


@pytest.mark.parametrize("case_i", range(8))
def test_numpy_native_parity(case_i):
    pos = _case(case_i)
    assert np.array_equal(roaring.decode(native.encode_roaring(pos)), pos)
    assert np.array_equal(native.decode_roaring(roaring.encode(pos)), pos)


@pytest.mark.parametrize("case_i", range(8))
def test_bytes_equal_to_the_jax_codec(case_i):
    """Encodings byte-equal to the JAX package's, numpy and native."""
    pos = _case(case_i)
    assert roaring.encode(pos) == j_roaring.encode(pos)
    assert native.encode_roaring(pos) == j_native.encode_roaring(pos)
    buf = j_native.encode_roaring(pos)
    assert np.array_equal(native.decode_roaring(buf), j_native.decode_roaring(buf))
    assert np.array_equal(roaring.decode(buf), j_roaring.decode(buf))


def test_native_available_and_status():
    """g++ is on this host: the port builds the codec from the repo's
    source into build/native/, under a hashed name, and says so."""
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert native.status().startswith("native codec build/native/roaring_codec-")


def test_numpy_codec_without_the_library(monkeypatch):
    """PILOSA_TPU_NO_NATIVE=1: every entry point takes the numpy codec,
    with the same answers, and status() names the reason."""
    monkeypatch.setenv("PILOSA_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", native._status)
    assert not native.available()
    assert "PILOSA_TPU_NO_NATIVE" in native.status()
    pos = _case(6)
    assert native.encode_roaring(pos) == j_roaring.encode(pos)
    assert np.array_equal(native.decode_roaring(roaring.encode(pos)), pos)
    words = native.positions_to_words(pos[pos < 1 << 20], 1 << 15)
    assert np.array_equal(native.words_to_positions(words), pos[pos < 1 << 20])
    assert native.scatter_row_blocks(pos, 20, 1, 1 << 15) is None
    assert native.pool_stats() is None and native.pool_reserve(1 << 20) == 0


def test_positions_words_popcount_parity():
    rng = np.random.default_rng(3)
    pos = np.unique(rng.integers(0, 1 << 20, 30000, dtype=np.uint64))
    words = native.positions_to_words(pos, 1 << 15)
    assert np.array_equal(words, j_native.positions_to_words(pos, 1 << 15))
    assert np.array_equal(native.words_to_positions(words), pos)
    assert native.popcount_words(words) == len(pos)
    other = native.positions_to_words(pos[::3], 1 << 15)
    assert native.intersection_count_words(words, other) == len(pos[::3])


def test_scatter_row_blocks_parity():
    rng = np.random.default_rng(4)
    cols = rng.integers(0, 3 << 20, 100000, dtype=np.uint64)
    got = native.scatter_row_blocks(cols, 20, 3, 1 << 15)
    want = j_native.scatter_row_blocks(cols, 20, 3, 1 << 15)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_container_type_choices():
    buf = roaring.encode(np.arange(5000, dtype=np.uint64))
    _, typ, _ = struct.unpack_from("<QHH", buf, 8)
    assert typ == roaring.TYPE_RUN
    buf = roaring.encode(np.array([1, 100, 9999], dtype=np.uint64))
    _, typ, _ = struct.unpack_from("<QHH", buf, 8)
    assert typ == roaring.TYPE_ARRAY
    rng = np.random.default_rng(42)
    dense = np.sort(rng.choice(1 << 16, 30000, replace=False).astype(np.uint64))
    buf = roaring.encode(dense * np.uint64(2))  # kill runs; > ARRAY_MAX
    _, typ, _ = struct.unpack_from("<QHH", buf, 8)
    assert typ == roaring.TYPE_BITMAP


def test_malformed_buffers_rejected():
    with pytest.raises(ValueError):
        roaring.decode(b"")
    with pytest.raises(ValueError):
        roaring.decode(b"\x00\x00\x00\x00\x01\x00\x00\x00")  # bad cookie
    with pytest.raises(ValueError):
        native.decode_roaring(b"\xff" * 4)
    good = roaring.encode(np.arange(10, dtype=np.uint64))
    with pytest.raises(ValueError):
        native.decode_roaring(good[: len(good) - 4])


def test_decode_rejects_lying_cardinality():
    hdr = struct.pack("<II", 12348, 1)
    meta = struct.pack("<QHH", 0, 3, 0)          # key 0, run, N-1=0
    off = struct.pack("<I", len(hdr) + len(meta) + 4)
    payload = struct.pack("<H", 1) + struct.pack("<HH", 0, 65535)
    with pytest.raises(ValueError):
        native.decode_roaring(hdr + meta + off + payload)


def test_fragment_import_export_roaring():
    h = Holder(device="cpu")
    f = h.create_index("i").create_field("f")
    pos = np.array([0 * SHARD_WIDTH + 5, 3 * SHARD_WIDTH + 7,
                    3 * SHARD_WIDTH + 9], dtype=np.uint64)
    assert f.import_roaring(shard=0, data=native.encode_roaring(pos)) == 3
    assert f.row(0).columns().tolist() == [5]
    assert f.row(3).columns().tolist() == [7, 9]
    frag = h.fragment("i", "f", "standard", 0)
    assert np.array_equal(native.decode_roaring(frag.to_roaring()), pos)
    f.import_roaring(shard=0, data=native.encode_roaring(pos[:1]), clear=True)
    assert f.row(0).columns().tolist() == []


def test_to_roaring_equals_the_jax_fragments():
    """The same bits in a JAX and a port fragment (dense and sparse rows,
    shard 2) export byte-equal roaring bodies, and each imports into the
    other package's fragment as the same rows."""
    from pilosa_tpu.core import Holder as JHolder
    rng = np.random.default_rng(9)
    cols = 2 * SHARD_WIDTH + rng.integers(0, SHARD_WIDTH, 40000, dtype=np.uint64)
    rows = rng.integers(0, 3, 40000, dtype=np.uint64)
    rows[:30000] = 1  # row 1 dense
    jh, th = JHolder(), Holder(device="cpu")
    for h in (jh, th):
        h.create_index("i").create_field("f").import_bits(rows, cols)
    jbuf = jh.fragment("i", "f", "standard", 2).to_roaring()
    tbuf = th.fragment("i", "f", "standard", 2).to_roaring()
    assert tbuf == jbuf
    jh2, th2 = JHolder(), Holder(device="cpu")
    jh2.create_index("i").create_field("f").import_roaring(2, tbuf)
    th2.create_index("i").create_field("f").import_roaring(2, jbuf)
    for r in range(3):
        assert np.array_equal(
            th2.fragment("i", "f", "standard", 2).row_words(r),
            jh2.fragment("i", "f", "standard", 2).row_words(r))


def test_official_format_no_runs_decodes():
    dense = sorted(set(range(0, 65536, 13)))  # > 4096 -> bitmap
    buf = _official_no_runs([(0, [1, 5, 9]), (2, dense)])
    want = [1, 5, 9] + [(2 << 16) + v for v in dense]
    assert roaring.decode_official(buf).tolist() == want
    assert roaring.decode(buf).tolist() == want
    assert native.decode_roaring(buf).tolist() == want


def test_official_format_runs_decode():
    buf = _official_runs([(1, [(10, 2), (100, 0)])])
    want = [(1 << 16) + v for v in (10, 11, 12, 100)]
    assert roaring.decode(buf).tolist() == want
    assert native.decode_roaring(buf).tolist() == want
    buf4 = _official_runs([(i, [(i * 3, 1)]) for i in range(5)])
    want4 = [(i << 16) + i * 3 + k for i in range(5) for k in (0, 1)]
    assert roaring.decode(buf4).tolist() == want4
    assert native.decode_roaring(buf4).tolist() == want4
    assert np.array_equal(roaring.decode(buf4), j_roaring.decode(buf4))


def test_official_format_imports_into_fragment():
    import torch
    frag = Fragment("i", "f", "standard", 0, torch.device("cpu"))
    assert frag.import_roaring(_official_no_runs([(0, [3, 7])])) == 2
    assert frag.contains(0, 3) and frag.contains(0, 7)


def test_official_bitmap_then_sequential_container():
    dense = list(range(0, 65536, 13))
    cookie = 12347 | (1 << 16)  # two containers
    desc = struct.pack("<HH", 0, len(dense) - 1) + struct.pack("<HH", 1, 2)
    words = np.zeros(1024, dtype="<u8")
    arr = np.asarray(dense, dtype=np.uint64)
    np.bitwise_or.at(words, (arr >> np.uint64(6)).astype(np.int64),
                     np.uint64(1) << (arr & np.uint64(63)))
    runs = struct.pack("<H", 1) + struct.pack("<HH", 7, 2)  # 7..9
    buf = struct.pack("<I", cookie) + bytes([0b10]) + desc + words.tobytes() + runs
    want = dense + [(1 << 16) + v for v in (7, 8, 9)]
    assert roaring.decode(buf).tolist() == want
    assert native.decode_roaring(buf).tolist() == want


def test_official_array_of_exactly_4096():
    vals = list(range(0, 8192, 2))
    buf = _official_no_runs([(3, vals)])
    want = [(3 << 16) + v for v in vals]
    assert roaring.decode_official(buf).tolist() == want
    assert native.decode_roaring(buf).tolist() == want


def test_official_decode_allocation_bound():
    n = 4096
    cookie = 12347 | ((n - 1) << 16)
    rb = b"\xff" * ((n + 7) // 8)
    desc = b"".join(struct.pack("<HH", i % 65536, 65535) for i in range(n))
    run = struct.pack("<H", 1) + struct.pack("<HH", 0, 65535)
    hdr_len = 4 + len(rb) + len(desc) + 4 * n
    buf = struct.pack("<I", cookie) + rb + desc + struct.pack("<I", hdr_len) * n + run
    with pytest.raises(ValueError):
        roaring.decode_official(buf)
