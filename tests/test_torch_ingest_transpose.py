"""The device value transpose of the port against the JAX package, on the CPU.

- ``exec/ingest_transpose.transpose_planes`` (``kernels.plane_scatter``'s
  plain version on CPU tensors) bit-equal to the JAX ``transpose_planes``
  (CPU XLA) on 3 seeded shards at depth 17, bit 31 of words, depth 40 with
  values past 2^32, depth 63 with the int64 extremes, all-negative, empty
  and single-entry batches, and on the cases the card holds the CUDA
  kernel to (``chip_smoke.PLANE_SCATTER_CASES``); the card's out-of-range
  case dropped to its in-range entries;
- ``Fragment.import_values`` under ``on``, ``off`` and ``auto`` in both
  packages (the cases of ``tests/test_ingest.py``: generative batches with
  clears, last-write-wins duplicates, clear then reimport, shard-boundary
  positions): equal rows, WAL records and values;
- the mode knob with both env vars;
- ``Field._scatter_import_values``: a fresh import of 65,536+ values across
  shards lands rows and WAL bytes equal to the JAX package's;
- rows the transpose adopted stay writable in the port.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu.exec import ingest_transpose as j_it
from pilosa_tpu.storage import DiskStore as JDiskStore
from pilosa_tpu_torch import native
from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.exec import ingest_transpose as t_it
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.storage import DiskStore

CPU = torch.device("cpu")
MODES = ("on", "off", "auto")


@pytest.fixture(autouse=True)
def _no_transpose_env(monkeypatch):
    """Each test picks its mode; no env override or module mode leaks."""
    monkeypatch.delenv("PILOSA_TPU_INGEST_TRANSPOSE", raising=False)
    monkeypatch.delenv("PILOSA_TPU_INGEST_TRANSPOSE_MIN", raising=False)
    for m in (j_it, t_it):
        m.set_mode("auto")
    yield
    for m in (j_it, t_it):
        m.set_mode("auto")


def _set_mode(mode: str) -> None:
    for m in (j_it, t_it):
        m.set_mode(mode)


def _case(name: str):
    """(sorted distinct in-shard positions, int64 values, depth)."""
    rng = np.random.default_rng({"seed0": 0, "seed1": 1, "seed2": 2}.get(name, 7))
    if name.startswith("seed"):
        pos = np.sort(rng.choice(SHARD_WIDTH, 3000, replace=False))
        return pos, rng.integers(-100000, 100000, len(pos)), 17
    if name == "bit31":
        pos = np.arange(31, SHARD_WIDTH, 32 * 97)
        return pos, rng.integers(-(2**16), 2**16, len(pos)), 17
    if name == "depth40":
        pos = np.sort(rng.choice(SHARD_WIDTH, 2000, replace=False))
        vals = rng.integers(-(2**40 - 1), 2**40, len(pos))
        vals[::5] = rng.integers(2**32, 2**40, len(vals[::5]))
        return pos, vals, 40
    if name == "depth63":
        pos = np.array([0, 31, 32, 63, SHARD_WIDTH - 1])
        info = np.iinfo(np.int64)
        return pos, np.array([info.min, info.max, -1, 2**62 + 5, -(2**62) - 3]), 63
    if name == "negative":
        pos = np.sort(rng.choice(SHARD_WIDTH, 1000, replace=False))
        return pos, rng.integers(-100000, 0, len(pos)), 17
    if name == "empty":
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64), 17
    if name == "single":
        return np.array([SHARD_WIDTH - 1]), np.array([-77]), 17
    raise KeyError(name)


CASES = ("seed0", "seed1", "seed2", "bit31", "depth40", "depth63", "negative", "empty",
         "single")


@pytest.mark.parametrize("name", CASES)
def test_transpose_planes_matches_jax(name):
    pos, vals, depth = _case(name)
    local = pos.astype(np.uint32)
    want = j_it.transpose_planes(local, vals.astype(np.int64), depth)
    got = t_it.transpose_planes(local, vals.astype(np.int64), depth, CPU)
    assert got.dtype == np.uint32 and got.shape == (depth + 2, WORDS_PER_SHARD)
    np.testing.assert_array_equal(got, want)
    assert got.flags.writeable


#: plane_scatter's card cases where the JAX function defines the answer (it
#: takes in-range positions only).
CHIP_CASES = [c for c in chip_smoke.PLANE_SCATTER_CASES if c != "out_of_range"]


@pytest.mark.parametrize("name", CHIP_CASES)
def test_transpose_planes_matches_jax_on_card_cases(name):
    """The cases the card holds the CUDA kernel to its plain version on
    (``chip_smoke.PLANE_SCATTER_CASES``: slab and group edges, depth 0 and
    63, a full word, an unaligned dense run, shuffled shards), through the
    port's CPU path, bit-equal to the JAX ``transpose_planes``."""
    assert chip_smoke.SHARD_WORDS == WORDS_PER_SHARD
    pos, vals, depth = chip_smoke.plane_scatter_case(name)
    local = pos.astype(np.uint32)
    want = j_it.transpose_planes(local, vals, depth)
    got = t_it.transpose_planes(local, vals, depth, CPU)
    assert got.shape == (depth + 2, WORDS_PER_SHARD)
    np.testing.assert_array_equal(got, want)


def test_plane_scatter_out_of_range_card_case_drops_them():
    """The card's out-of-range case (a bench shard with negative and past-
    the-shard positions mixed in): the plain version drops them, equal to
    the JAX image of the in-range entries alone."""
    pos, vals, depth = chip_smoke.plane_scatter_case("out_of_range")
    inside = (pos >= 0) & (pos < 32 * WORDS_PER_SHARD)
    assert 0 < inside.sum() < len(pos)
    got = kernels.plane_scatter(torch.from_numpy(pos), torch.from_numpy(vals), depth)
    want = j_it.transpose_planes(pos[inside].astype(np.uint32), vals[inside], depth)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_plane_scatter_drops_out_of_range_and_checks_inputs():
    pos = torch.tensor([-1, 5, 32 * WORDS_PER_SHARD], dtype=torch.int32)
    vals = torch.tensor([3, -3, 3], dtype=torch.int64)
    out = kernels.plane_scatter(pos, vals, 4)
    want = np.zeros((6, WORDS_PER_SHARD), dtype=np.uint32)
    want[[0, 1, 2, 3], 0] = 1 << 5
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)
    with pytest.raises(TypeError):
        kernels.plane_scatter(pos.long(), vals, 4)
    with pytest.raises(ValueError):
        kernels.plane_scatter(pos, vals[:2], 4)
    with pytest.raises(ValueError):
        kernels.plane_scatter(pos, vals, 64)


# -- Fragment.import_values, both packages, every mode ---------------------------


def _frag(pkg: str, shard: int = 0):
    if pkg == "jax":
        return JFragment("i", "v", "bsig_v", shard)
    return Fragment("i", "v", "bsig_v", shard, CPU)


def _run(pkg, mode, prefill, batches, depth, shard=0, probe=()):
    """(row words, WAL records, value reads) after the prefill and batches."""
    _set_mode(mode)
    f = _frag(pkg, shard)
    records = []
    if prefill is not None:
        f.import_values(*prefill, depth)
    f.op_writer = lambda op, rows, cols: records.append(
        (op, np.asarray(rows, dtype=np.uint64).tobytes(),
         np.asarray(cols, dtype=np.uint64).tobytes()))
    for cols, vals, clear in batches:
        f.import_values(cols, vals, depth, clear=clear)
    state = {rid: hr.to_words().tobytes() for rid, hr in f.rows.items() if hr.n}
    return state, records, [f.value(c, depth) for c in probe]


def _both(mode, *args, **kw):
    want = _run("jax", mode, *args, **kw)
    got = _run("port", mode, *args, **kw)
    assert got[0] == want[0], "rows differ"
    assert got[1] == want[1], "WAL records differ"
    assert got[2] == want[2], "values differ"
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_import_values_generative(mode, seed):
    """Duplicates, negatives, overwrites and clears, depth 1 to 39."""
    rng = np.random.default_rng(seed)
    depth = int(rng.integers(1, 40))
    lo, hi = (-(1 << (depth - 1)) if depth > 1 else -1), 1 << (depth - 1)
    prefill = (rng.integers(0, 4096, 300), rng.integers(lo, hi, 300))
    batches = []
    for _ in range(4):
        n = int(rng.integers(1, 500))
        batches.append((rng.integers(0, 4096, n), rng.integers(lo, hi, n),
                        bool(rng.integers(0, 5) == 0)))
    _both(mode, prefill, batches, depth, probe=rng.integers(0, 4096, 64).tolist())


@pytest.mark.parametrize("mode", MODES)
def test_import_values_last_write_wins(mode):
    _, _, got = _both(mode, None, [([7, 7, 7], [5, -9, 42], False),
                                   ([7, 3, 7], [1, 2, -6], False)], 8, probe=[7, 3])
    assert got == [(-6, True), (2, True)]


@pytest.mark.parametrize("mode", MODES)
def test_import_values_clear_then_reimport(mode):
    _, _, got = _both(mode, None, [([1, 2, 3], [10, -20, 30], False),
                                   ([2], [], True), ([2], [-1], False)], 8, probe=[1, 2, 3])
    assert got == [(10, True), (-1, True), (30, True)]


@pytest.mark.parametrize("mode", MODES)
def test_import_values_shard_boundary_positions(mode):
    base = 3 * SHARD_WIDTH
    edges = [base, base + 1, base + 31, base + 32, base + SHARD_WIDTH - 33,
             base + SHARD_WIDTH - 1]
    vals = [1, -2, 3, -4, 5, -6]
    _, _, got = _both(mode, None, [(edges, vals, False)], 8, shard=3, probe=edges)
    assert got == [(v, True) for v in vals]


def test_mode_knob(monkeypatch):
    t_it.set_mode("on")
    assert t_it.use_device(1, CPU)
    t_it.set_mode("off")
    assert not t_it.use_device(1 << 30, CPU)
    monkeypatch.setenv("PILOSA_TPU_INGEST_TRANSPOSE", "on")
    assert t_it.use_device(1, CPU)  # env wins over set_mode
    monkeypatch.setenv("PILOSA_TPU_INGEST_TRANSPOSE", "auto")
    monkeypatch.setenv("PILOSA_TPU_INGEST_TRANSPOSE_MIN", "1000")
    assert not t_it.use_device(999, CPU) and t_it.use_device(1000, CPU)
    monkeypatch.delenv("PILOSA_TPU_INGEST_TRANSPOSE_MIN")
    assert t_it._min_size(CPU) >= 1024  # the calibrated crossover's floor
    with pytest.raises(ValueError):
        t_it.set_mode("sideways")


def test_rows_adopted_by_the_transpose_stay_writable():
    """A fresh fragment adopts its planes from the transpose's image; a Set
    and a clear on them afterwards go through (the JAX package's adopted
    rows are read-only views of a device array, ROADMAP.md Queue 3)."""
    t_it.set_mode("on")
    h = Holder(device="cpu")
    v = h.create_index("i").create_field("v", FieldOptions(type="int", min=-1000,
                                                           max=1000))
    cols = np.arange(0, 3000, 3)
    v.import_values(cols, (cols % 1000) - 500)
    frag = h.fragment("i", "v", "bsig_v", 0)
    assert frag.rows[0].is_dense
    assert v.set_value(3, 777) and v.value(3) == (777, True)
    assert v.set_value(4, -5) and v.value(4) == (-5, True)
    assert v.value(6) == (-494, True)
    frag.clear_bit(0, 9)
    assert v.value(9) == (0, False)


# -- Field._scatter_import_values ---------------------------------------------


def _wal_bytes(d, shards):
    return {s: open(os.path.join(d, "i", "v", "bsig_v", f"{s}.wal"), "rb").read()
            for s in shards}


@pytest.mark.skipif(not native.available(), reason=native.status())
@pytest.mark.parametrize("mode", MODES)
def test_scatter_import_values_matches_jax(tmp_path, mode):
    """A fresh 70,000-value import over 3 shards with duplicates takes the
    native scatter in the port (spied), and lands rows and WAL bytes equal
    to the JAX package's; a second batch goes through the fragments."""
    _set_mode(mode)
    rng = np.random.default_rng(5)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 70000)
    vals = rng.integers(-(2**20), 2**20, 70000)
    out = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        if pkg == "jax":
            h, store = JHolder(), None
            store = JDiskStore(d, h)
            opts = JFieldOptions(type="int", min=-(2**20), max=2**20)
        else:
            h = Holder(device="cpu")
            store = DiskStore(d, h)
            opts = FieldOptions(type="int", min=-(2**20), max=2**20)
        store.open()
        f = h.create_index("i").create_field("v", opts)
        if pkg == "port":
            calls = []
            orig = native.scatter_bsi_blocks
            native.scatter_bsi_blocks = lambda *a: calls.append(1) or orig(*a)
        try:
            f.import_values(cols, vals)
            f.import_values(cols[:100], -vals[:100])
        finally:
            if pkg == "port":
                native.scatter_bsi_blocks = orig
        rows = {(s, r): h.fragment("i", "v", "bsig_v", s).row_words(r).tobytes()
                for s in range(3) for r in range(2 + f.bsi_group.bit_depth)}
        out[pkg] = (rows, _wal_bytes(d, range(3)))
        store.close()
    assert calls == [1]
    assert out["port"][0] == out["jax"][0]
    # The JAX native library is built in place and can be missing under
    # parallel test workers (ROADMAP.md Queue 3); its WAL is then the
    # per-fragment path's, grouped differently.
    from pilosa_tpu import native as j_native
    if j_native.available():
        assert out["port"][1] == out["jax"][1]
