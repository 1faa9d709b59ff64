"""Keys of the port against the JAX package, on the CPU: translate stores,
device key planes, keyed queries, keyed data dirs, imports by keys and the
CLI's CSV import and export.

Every comparison is exact:

- ``TranslateStore``: the same allocations, replays and cursors give the
  same ids, versions, entries and watermarks, and the framed
  ``translate.jsonl`` files are byte-equal and read by both packages;
- key planes: ``hash_keys`` and ``build_plane`` bit-equal to the JAX
  functions (unicode, empty and long keys, hash high halves on both sides
  of 2^31, a collision bucket); ``plane_lookup_plain`` and the wrapper on
  CPU tensors against the JAX ``plane_lookup`` (absent probes, a probe
  equal to the padding hash, a real key with that hash, repeated hashes,
  and ``chip_smoke.KEYPLANE_CHECKS``'s planes: one slot, unpadded widths,
  runs of equal hashes and high words across the kernel's fences), a host
  copy of the kernel's fence-and-interpolation search on the same
  planes, and the rest of the KEYPLANE row; ``KeyPlaneCache`` in ``on``, ``auto``
  and ``off`` against the JAX cache (ids and counters);
- executor: keyed indexes and fields (Set, Row, Count, TopN, Rows with
  key cursors, GroupBy, MinRow/MaxRow, a 300-key Union under ``auto``, the
  error texts) through both JAX executors and both port executors; a JAX
  holder's translate stores copied with ``interop.copy_translate_stores``;
  keyed data dirs opened by the other package;
- HTTP and CLI: imports by row and column keys over HTTP, and ``import``
  then ``export`` through the port's CLI and the JAX CLI against a port
  node and a JAX node, for set, int and keyed fields: equal rows and CSV
  lines.

``plane_lookup`` runs only on the card: ``chip_smoke.py`` holds it to its
plain version there.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu import cli as j_cli
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.index import IndexOptions as JIndexOptions
from pilosa_tpu.core.translate import TranslateStore as JTranslateStore
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import keyplane as jkp
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu.storage import DiskStore as JDiskStore
from pilosa_tpu_torch import cli, interop
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.index import IndexOptions as TIndexOptions
from pilosa_tpu_torch.core.translate import TranslateStore as TTranslateStore
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import keyplane as tkp
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.server import ServerNode as TServerNode
from pilosa_tpu_torch.storage import DiskStore as TDiskStore
from test_torch_server import Client

import chip_smoke

KEYS = ["", "a", "b", "café", "漢字", "x" * 300, "k,1", "key with spaces",
        *[f"key-{i}" for i in range(400)]]


@pytest.fixture(autouse=True)
def _no_launches(monkeypatch):
    """Every CPU call takes the plain versions: no kernel launch. Both
    packages' value imports run their host loops (rows the JAX device
    transpose adopts are read-only)."""
    monkeypatch.setenv("PILOSA_TPU_INGEST_TRANSPOSE", "off")
    monkeypatch.delenv("PILOSA_TPU_TRANSLATE_PLANES", raising=False)
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


# -- the store ------------------------------------------------------------------


def _drive(store) -> list:
    """One history of allocations, a replay with gaps and a re-key, and
    reads; everything observable along the way."""
    out = [store.translate_keys(KEYS[:50]), store.version, store.max_id()]
    out.append(store.translate_keys(KEYS[25:80] + ["a", "new"], create=True))
    out.append(store.translate_keys(["never"], create=False))
    store.apply_entries([(200, "remote-200"), (90, "remote-90"), (3, "b-renamed")])
    out += [store.version, store.max_id(), store.replication_watermark(),
            store.entries_since(0), store.entries_since(60), store.entries_since(500),
            store.translate_ids([1, 3, 90, 199, 200]), store.translate_id(2)]
    out.append(store.translate_keys(["after-replay"]))
    return out


def test_store_matches_jax(tmp_path):
    paths = {k: str(tmp_path / k / "translate.jsonl") for k in ("jax", "port")}
    stores = {"jax": JTranslateStore(paths["jax"]), "port": TTranslateStore(paths["port"])}
    got = {k: _drive(s) for k, s in stores.items()}
    assert got["port"] == got["jax"]
    for s in stores.values():
        s.save()
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["port"] == data["jax"]
    # Each package reads the other's file, and a damaged line is skipped
    # (and counted) alike.
    with open(paths["jax"], "ab") as f:
        f.write(b"garbage line\n")
    for cls in (JTranslateStore, TTranslateStore):
        for p in paths.values():
            s = cls(p)
            assert s.entries_since(0) == stores["jax"].entries_since(0)
    assert TTranslateStore(paths["jax"]).corrupt_lines == JTranslateStore(
        paths["jax"]).corrupt_lines == 1


def test_read_only_store_refuses_new_keys():
    s = TTranslateStore(read_only=True)
    with pytest.raises(Exception, match="read only"):
        s.translate_keys(["a"])
    assert s.translate_keys(["a"], create=False) == [None]


# -- key planes -----------------------------------------------------------------


def test_hash_and_plane_match_jax():
    h = tkp.hash_keys(KEYS)
    np.testing.assert_array_equal(h, jkp.hash_keys(KEYS))
    hi = (h >> np.uint64(32)).astype(np.uint32)
    assert (hi >= 2**31).any() and (hi < 2**31).any()  # both sides of bit 31
    fwd = {k: i + 1 for i, k in enumerate(KEYS)}
    for sub in (fwd, dict(list(fwd.items())[:1]), {}, dict(list(fwd.items())[:9])):
        t, j = tkp.build_plane(sub), jkp.build_plane(sub)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:] == j[1:]


def test_collision_bucket_matches_jax(monkeypatch):
    """Keys whose fingerprints collide leave the plane and resolve from the
    host bucket, in both packages alike."""
    table = {"x": 7, "y": 7, "a": 101, "b": 2**64 - 1, "nope": 303}

    def fake_hash(keys):
        return np.array([table[k] for k in keys], dtype=np.uint64)

    monkeypatch.setattr(tkp, "hash_keys", fake_hash)
    monkeypatch.setattr(jkp, "hash_keys", fake_hash)
    monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "on")
    got = []
    for holder, iopts, mod in ((JHolder(), JIndexOptions, jkp),
                               (THolder(device="cpu"), TIndexOptions, tkp)):
        idx = holder.create_index("p", iopts(keys=True))
        store = idx.translate_store
        store.translate_keys(["x", "y", "a", "b"])
        mat, collisions, valid = mod.build_plane(store.snapshot()[1])
        cache = mod.KeyPlaneCache(planner=None)
        got.append((np.asarray(mat).tolist(), collisions, valid,
                    cache.lookup(idx, None, store, ["x", "y", "a", "b", "nope"]),
                    cache.debug()))
    assert got[0] == got[1]
    assert got[1][3] == [1, 2, 3, 4, None]  # "b" hashes to the padding value


def _plane_and_probes(seed: int, h: int, q: int):
    """A plane of ``h`` random hashes (some repeated, the last real one
    2^64 - 1 beside the padding), and probes: present hashes, absent
    ones, the padding hash, all-zero."""
    rng = np.random.default_rng(seed)
    hashes = np.sort(rng.integers(0, 2**64 - 1, h, dtype=np.uint64, endpoint=True))
    if h > 4:
        hashes[1:4] = hashes[1]  # a repeated hash: the leftmost slot answers
    hashes[-1] = np.uint64(2**64 - 1)
    ids = np.arange(1, h + 1, dtype=np.uint32)
    pad = 4
    mat = np.empty((3, h + pad), dtype=np.uint32)
    mat[0, :h] = (hashes >> np.uint64(32)).astype(np.uint32)
    mat[1, :h] = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mat[2, :h] = ids
    mat[:2, h:] = 0xFFFFFFFF
    mat[2, h:] = 0
    probes = np.concatenate([hashes[rng.integers(0, h, q)],
                             rng.integers(0, 2**64 - 1, q, dtype=np.uint64, endpoint=True),
                             np.array([2**64 - 1, 0], dtype=np.uint64)])
    return mat, (probes >> np.uint64(32)).astype(np.uint32), \
        (probes & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


#: this file's own planes, then chip_smoke.KEYPLANE_CHECKS's (the card holds
#: the kernel to the plain version on them) but its timed one: one slot and
#: 1,000 unpadded, 393,221 slots, runs of equal hashes and high words across
#: the kernel's fences, hash 0 real, probes of 0 and 2^64 - 1.
PLANE_CASES = [pytest.param(h, q, None, id=f"{h}-{q}")
               for h, q in ((1, 3), (8, 20), (1000, 500), (1 << 14, 4096))] + [
    pytest.param(h, q, (pad, runs), id=f"card-{h}-{q}-{'pad' if pad else 'exact'}"
                 f"{'-runs' if runs else ''}")
    for h, q, pad, runs in chip_smoke.KEYPLANE_CHECKS[:-1]]


@pytest.mark.parametrize("h,q,card", PLANE_CASES)
def test_plane_lookup_matches_jax(h, q, card):
    if card is None:
        mat, phi, plo = _plane_and_probes(h, h, q)
        present = q
    else:
        mat, phi, plo = chip_smoke.key_plane(h, q, chip_smoke.SEED + h, *card)
        present = q // 2
        assert mat.shape[1] == (max(8, 1 << (h - 1).bit_length()) if card[0] else h)
    want = np.asarray(jkp.plane_lookup(jnp.asarray(mat), jnp.asarray(phi), jnp.asarray(plo)))
    for fn in (kernels.plane_lookup, kernels.plane_lookup_plain):
        got = fn(_i32(mat), _i32(phi), _i32(plo))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want[:present] != 0).all()  # every present hash found
    if card is not None and card[1]:  # the runs answer at their leftmost slots
        assert want[0] == 1001 and want[2] == 1
        hashes = (mat[0].astype(np.uint64) << np.uint64(32)) | mat[1]
        assert (hashes[1000:1300] == hashes[1000]).all()
        assert ((mat[0, 5000:5400] == mat[0, 5000]) & (mat[1, 5000:5400] > 0)).all()


def _fenced_lookup(mat: np.ndarray, phi: np.ndarray, plo: np.ndarray, max_fences: int,
                   interp_steps: int) -> np.ndarray:
    """The search of csrc/keyplane_kernels.cu, probe by probe: count the
    fences (every 2^shift-th slot's high word, at most ``max_fences``) below
    the probe's high word; then, in the window they leave, read the 8-slot
    sector at the slot interpolated from the window's end values (its
    midpoint after ``interp_steps``) until a sector holds the boundary;
    then the low word and id where the high words match, and a search of
    the run of equal high words on (hi, lo) where the low word is below."""
    hi, lo, ids = mat[0].tolist(), mat[1].tolist(), mat[2].tolist()
    h, shift = len(hi), 0
    while -(-h >> shift) > max_fences:
        shift += 1
    count = -(-h >> shift)
    below = np.searchsorted(mat[0, ::1 << shift], phi, side="left").tolist()
    out = []
    for ph, pl, c in zip(phi.tolist(), plo.tolist(), below):
        a = 0 if c == 0 else ((c - 1) << shift) + 1
        b = h if c == count else c << shift
        va = 0 if c == 0 else hi[(c - 1) << shift]
        vb = 0 if c == count else hi[c << shift]
        step = 0
        while a < b:
            pos = (a + b) >> 1
            if step < interp_steps:
                top = np.float32(2.0**32) if b == h else np.float32(vb)
                with np.errstate(divide="ignore", invalid="ignore"):
                    f = (np.float32(ph) - np.float32(va)) / (top - np.float32(va))
                f = 0.0 if np.isnan(f) else min(max(float(f), 0.0), 1.0)
                pos = min(max(a + int(np.float32(f) * np.float32(b - a)), a), b - 1)
            s0 = pos & ~7
            w = [hi[s0 + j] if s0 + j < h else 0xFFFFFFFF for j in range(8)]
            n = sum(s0 + j < h and w[j] < ph for j in range(8))
            if n == 0:
                b, vb = s0, w[0]
            elif n == 8:
                a, va = s0 + 8, w[7]
            else:
                a = b = s0 + n
                vb = w[n]
            step += 1
        if a >= h or vb != ph:
            out.append(0)
            continue
        if lo[a] < pl:
            a, b = a + 1, h
            while a < b:
                mid = (a + b) >> 1
                a, b = (mid + 1, b) if (hi[mid], lo[mid]) < (ph, pl) else (a, mid)
        out.append(ids[a] if a < h and (hi[a], lo[a]) == (ph, pl) else 0)
    return np.asarray(out, dtype=np.uint32)


@pytest.mark.parametrize("max_fences,interp_steps", [(1, 0), (1, 3), (4, 3), (256, 0),
                                                     (256, 3), (256, 64)])
@pytest.mark.parametrize("h,q,pad,runs", chip_smoke.KEYPLANE_CHECKS[:-2])
def test_fenced_search_matches_jax(h, q, pad, runs, max_fences, interp_steps):
    """The kernel's search, mirrored on the host, finds the JAX
    ``plane_lookup``'s ids on the card's check planes: one fence (a single
    window) or a few, the kernel's 256; halving from the start, the
    kernel's 3 interpolated steps, or interpolation to the end."""
    mat, phi, plo = chip_smoke.key_plane(h, q, chip_smoke.SEED + h, pad, runs)
    want = np.asarray(jkp.plane_lookup(jnp.asarray(mat), jnp.asarray(phi), jnp.asarray(plo)))
    np.testing.assert_array_equal(_fenced_lookup(mat, phi, plo, max_fences, interp_steps), want)


def test_keyplane_row_matches_jax():
    """count, and_count and pair_count of the KEYPLANE row."""
    fwd = {k: i + 1 for i, k in enumerate(KEYS)}
    mat = tkp.build_plane(fwd)[0]
    sub = tkp.build_plane({k: fwd[k] for k in KEYS[::3]})[0]
    h = tkp.hash_keys(KEYS[::2] + ["absent", "also-absent"])
    hi, lo = (h >> np.uint64(32)).astype(np.uint32), (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    assert int(tkp.plane_count(_i32(mat))) == int(jkp.plane_count(jnp.asarray(mat)))
    assert int(tkp.plane_and_count(_i32(mat), _i32(hi), _i32(lo))) == int(
        jkp.plane_and_count(jnp.asarray(mat), jnp.asarray(hi), jnp.asarray(lo)))
    assert int(tkp.plane_pair_count(_i32(sub), _i32(mat))) == int(
        jkp.plane_pair_count(jnp.asarray(sub), jnp.asarray(mat)))
    assert tkp.plane_expand(_i32(mat)).shape == (3, mat.shape[1])


def test_keyplane_cache_matches_jax(monkeypatch):
    """The JAX tests' plane story (tests/test_translate.py): builds,
    reuse, misses, a version bump rebuilding under ``on``, small batches
    and stale planes under ``auto``, ``off`` -- the same ids and counters
    in both packages."""
    def story(holder, iopts, mod):
        idx = holder.create_index("p", iopts(keys=True))
        store = idx.translate_store
        keys = [f"k{i}" for i in range(mod.MIN_DEVICE_BATCH)]
        ids = store.translate_keys(keys)
        cache = mod.KeyPlaneCache(planner=None)
        out = []
        monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "on")
        out += [cache.lookup(idx, None, store, keys) == ids,
                cache.lookup(idx, None, store, ["k3", "nope"])]
        store.translate_keys(["c"])
        out.append(cache.lookup(idx, None, store, ["c", "k1"]))
        monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "auto")
        out.append(cache.lookup(idx, None, store, keys[:4]))
        store.translate_keys(["new"])
        out.append(cache.lookup(idx, None, store, keys + ["new"])[-3:])
        monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "off")
        out += [cache.lookup(idx, None, store, keys), cache.debug()]
        return out

    assert story(THolder(device="cpu"), TIndexOptions, tkp) == story(JHolder(), JIndexOptions,
                                                                     jkp)


def test_plane_lives_in_the_planner_cache(monkeypatch):
    """With a planner the plane is a ``keyplane`` stack-cache entry,
    accounted by class, and an evicted plane rebuilds."""
    monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "on")
    h = THolder(device="cpu")
    idx = h.create_index("p", TIndexOptions(keys=True))
    ids = idx.translate_store.translate_keys(KEYS)
    planner = Planner(h)
    cache = tkp.KeyPlaneCache(planner)
    assert cache.lookup(idx, None, idx.translate_store, KEYS) == ids
    assert planner.cache_stats()["class_bytes"]["keyplane"] == 3 * 4 * 512
    planner.drop_index("p")
    assert planner.cache_stats()["class_bytes"]["keyplane"] == 0
    assert cache.lookup(idx, None, idx.translate_store, KEYS[:5]) == ids[:5]
    assert cache.builds == 2
    planner.close()


# -- executor level -----------------------------------------------------------------

ROW_KEYS = [f"row-{i}" for i in range(12)]
COL_KEYS = [f"col-{i}" for i in range(900)]


def _load_keyed(h, iopts, fopts, seed: int) -> None:
    """Keyed index ``k``: keyed set field ``f`` (12 row keys), keyed mutex
    ``m``, unkeyed set field ``u``, keyed int field ``v``; columns by key
    over 2 shards (ids allocated in one batch, then bits by id), and an
    unkeyed index ``plain`` to check the key errors on."""
    rng = np.random.default_rng(seed)
    idx = h.create_index("k", iopts(keys=True))
    f = idx.create_field("f", fopts(keys=True))
    m = idx.create_field("m", fopts(type="mutex", keys=True))
    u = idx.create_field("u")
    v = idx.create_field("v", fopts(type="int", min=-50, max=50))
    cols = np.asarray(idx.translate_store.translate_keys(COL_KEYS), dtype=np.int64)
    cols[::2] += SHARD_WIDTH  # half the columns in shard 1
    rows = np.asarray(f.translate_store.translate_keys(ROW_KEYS))
    pick = rng.integers(0, len(ROW_KEYS), 5000)
    at = rng.integers(0, len(cols), 5000)
    f.import_bits(rows[pick], cols[at])
    mrows = np.asarray(m.translate_store.translate_keys(["yes", "no", "maybe"]))
    m.import_bits(mrows[rng.integers(0, 3, 400)], cols[:400])
    u.import_bits(rng.integers(0, 4, 2000), cols[rng.integers(0, len(cols), 2000)])
    v.import_values(cols[::3], rng.integers(-50, 51, len(cols[::3])))
    h.create_index("plain").create_field("f").import_bits([1], [1])


@pytest.fixture(scope="module")
def keyed():
    jh, th = JHolder(), THolder(device="cpu")
    os.environ["PILOSA_TPU_INGEST_TRANSPOSE"] = "off"
    try:
        _load_keyed(jh, JIndexOptions, JFieldOptions, 3)
        _load_keyed(th, TIndexOptions, TFieldOptions, 3)
    finally:
        del os.environ["PILOSA_TPU_INGEST_TRANSPOSE"]
    jexecs = [JExecutor(jh), JExecutor(jh, planner=MeshPlanner(jh, make_mesh()))]
    texecs = [TExecutor(th), TExecutor(th, planner=Planner(th))]
    yield jh, th, jexecs, texecs
    texecs[1].planner.close()


UNION_300 = "Count(Union(" + ", ".join(f'Row(f="{ROW_KEYS[i % 12]}")' for i in range(300)) \
    + "))"

KEYED_QUERIES = [
    'Row(f="row-3")',
    'Count(Row(f="row-3"))',
    'Count(Intersect(Row(f="row-1"), Row(f="row-2")))',
    'Count(Union(Row(f="row-1"), Row(m="yes")))',
    "TopN(f)",
    'TopN(f, Row(f="row-0"), n=4)',
    "TopN(u, n=2)",
    "Rows(f)",
    'Rows(f, previous="row-4")',
    'Rows(f, column="col-7")',
    "Rows(m)",
    "GroupBy(Rows(f), Rows(m))",
    "GroupBy(Rows(m), Rows(u))",
    "MinRow(field=f)",
    "MaxRow(field=m)",
    'Count(Row(f="no-such-row"))',
    UNION_300,
    'Sum(Row(f="row-5"), field=v)',
    "Count(Distinct(field=v))",
    'SimilarTopN(f, Row(f="row-2"), n=5)',
    'Row(m="maybe")',
    'Options(Row(f="row-9"), excludeColumns=true)',
]


@pytest.mark.parametrize("mode", ["off", "auto", "on"])
@pytest.mark.parametrize("query", KEYED_QUERIES)
def test_keyed_query_parity(keyed, monkeypatch, mode, query):
    monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", mode)
    _, _, jexecs, texecs = keyed
    want = j_json(jexecs[0].execute("k", query, cache=False))
    assert j_json(jexecs[1].execute("k", query, cache=False)) == want, "JAX executors disagree"
    for e in texecs:
        assert t_json(e.execute("k", query, cache=False)) == want


def test_keyed_writes_match_jax(keyed):
    """Set and Clear by keys allocate new ids alike, and read back."""
    _, _, jexecs, texecs = keyed
    for q in ('Set("col-new", f="row-new")', 'Set("col-3", f="row-1")',
              'Clear("col-3", f="row-1")', 'Row(f="row-new")', 'Count(Row(f="row-1"))'):
        want = j_json(jexecs[1].execute("k", q))
        assert t_json(texecs[1].execute("k", q)) == want, q


def test_union_300_is_one_plane_lookup(keyed, monkeypatch):
    """A keyed Count over 300 row keys under ``auto`` resolves them in ONE
    plane_lookup (a batch past MIN_DEVICE_BATCH), once the plane is built;
    under ``off`` it makes none."""
    _, _, _, texecs = keyed
    e = texecs[1]
    calls = []
    real = kernels.plane_lookup
    monkeypatch.setattr(kernels, "plane_lookup",
                        lambda *a: (calls.append(1), real(*a))[1])
    monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "on")
    e.execute("k", UNION_300, cache=False)  # builds the plane in line
    calls.clear()
    monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "auto")
    e.execute("k", UNION_300, cache=False)
    assert len(calls) == 1
    assert e.keyplanes.debug()["deviceBatches"] >= 2
    monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "off")
    calls.clear()
    e.execute("k", UNION_300, cache=False)
    assert calls == []


def test_key_errors_match_jax(keyed):
    _, _, jexecs, texecs = keyed
    for index, q in (("plain", 'Row(f="a")'), ("plain", 'Set("a", f=1)'),
                     ("k", 'Row(u="a")'), ("plain", 'Rows(f, column="a")'),
                     ("k", 'Rows(u, previous="a")')):
        with pytest.raises(Exception) as je:
            jexecs[1].execute(index, q)
        with pytest.raises(Exception) as te:
            texecs[1].execute(index, q)
        assert str(te.value) == str(je.value), q


def test_interop_copies_translate_stores(keyed):
    """A port holder given the JAX holder's schema, rows and translate
    stores (``interop``) answers every keyed query as the JAX one."""
    jh, _, jexecs, _ = keyed
    th = THolder(device="cpu")
    th.apply_schema(jh.schema())
    for iname in jh.index_names():
        for fname, f in jh.index(iname).fields.items():
            for vname, view in f.views.items():
                for shard, frag in view.fragments.items():
                    rids = sorted(frag.rows)
                    if rids:
                        interop.load_fragment_words(
                            th, iname, fname, shard, rids,
                            np.stack([frag.row_words(r) for r in rids]), view=vname)
    interop.copy_translate_stores(jh, th)
    ex = TExecutor(th, planner=Planner(th))
    for q in KEYED_QUERIES[:12]:
        assert t_json(ex.execute("k", q)) == j_json(jexecs[0].execute("k", q)), q
    ex.planner.close()


@pytest.mark.parametrize("src", ["jax", "port"])
def test_keyed_data_dir_crosses_packages(tmp_path, src):
    """A keyed data dir written by one package opens in the other with the
    same translate entries and answers; its translate.jsonl files are
    byte-equal to the ones the other package writes from the same data."""
    sides = {}
    for pkg, (holder, store_cls, iopts, fopts) in {
            "jax": (JHolder(), JDiskStore, JIndexOptions, JFieldOptions),
            "port": (THolder(device="cpu"), TDiskStore, TIndexOptions, TFieldOptions)}.items():
        d = str(tmp_path / pkg)
        store = store_cls(d, holder)
        store.open()
        _load_keyed(holder, iopts, fopts, 1)
        store.close()
        sides[pkg] = d
    for rel in ("k/translate.jsonl", "k/f/translate.jsonl", "k/m/translate.jsonl",
                "k/u/translate.jsonl"):
        assert open(os.path.join(sides["jax"], rel), "rb").read() == \
            open(os.path.join(sides["port"], rel), "rb").read(), rel
    dst = "port" if src == "jax" else "jax"
    holder = THolder(device="cpu") if dst == "port" else JHolder()
    store = (TDiskStore if dst == "port" else JDiskStore)(sides[src], holder)
    store.open()
    ref = JHolder()  # the same data, loaded in memory
    _load_keyed(ref, JIndexOptions, JFieldOptions, 1)
    ex = (TExecutor if dst == "port" else JExecutor)(holder)
    for q in KEYED_QUERIES[:12]:
        got = (t_json if dst == "port" else j_json)(ex.execute("k", q))
        assert got == j_json(JExecutor(ref).execute("k", q)), q
    assert holder.index("k").translate_store.entries_since(0)[:3] == [
        (1, "col-0"), (2, "col-1"), (3, "col-2")]
    store.close()


# -- HTTP and the CLI --------------------------------------------------------------


@pytest.fixture(scope="module")
def nodes():
    """A JAX node and a port node on loopback, empty."""
    jn = JServerNode(bind="127.0.0.1:0", ingest_transpose="off")
    tn = TServerNode(bind="127.0.0.1:0", device="cpu")
    jn.open()
    tn.open()
    yield {"jax": jn, "port": tn}
    jn.close()
    tn.close()


CSV_CASES = {
    # kind: (index options, field options, csv lines)
    "set": ({}, {}, [f"{r},{c}" for r, c in ((1, 3), (1, SHARD_WIDTH + 5), (2, 7), (9, 3),
                                               (2, 2 * SHARD_WIDTH + 1))]),
    "int": ({}, {"type": "int", "min": -100, "max": 100},
            [f"{c},{v}" for c, v in ((3, -17), (SHARD_WIDTH + 5, 99), (8, 0))]),
    "keyed": ({"keys": True}, {"keys": True},
              [f"{r},{c}" for r, c in (("red", "alice"), ("red", "bob"), ("blue", "alice"),
                                        ("green", "carol"), ("blue", "dave"))]),
    "keyed-cols": ({"keys": True}, {}, ["1,alice", "4,bob", "4,erin"]),
    "keyed-int": ({"keys": True}, {"type": "int", "min": 0, "max": 1000},
                  ["alice,5", "bob,700", "carol,0"]),
}


def _csv_round(nodes, tmp_path, capsys, kind: str, cli_pkg: str, node_pkg: str):
    """Schema over HTTP, then ``import`` of the case's CSV and ``export``
    of the field through one package's CLI against one package's node:
    (export lines, query answers)."""
    iopts, fopts, lines = CSV_CASES[kind]
    node = nodes[node_pkg]
    index = f"{kind.replace('-', '')}{cli_pkg[0]}"
    c = Client(node.port)
    assert c("POST", f"/index/{index}", {"options": iopts})[0] == 200
    assert c("POST", f"/index/{index}/field/f", {"options": fopts})[0] == 200
    path = tmp_path / f"{kind}-{cli_pkg}-{node_pkg}.csv"
    path.write_text("\n".join(lines) + "\n")
    main = cli.main if cli_pkg == "port" else j_cli.main
    host = f"127.0.0.1:{node.port}"
    assert main(["import", "--host", host, "--buffer-size", "2", index, "f", str(path)]) == 0
    capsys.readouterr()
    assert main(["export", "--host", host, index, "f"]) == 0
    exported = sorted(capsys.readouterr().out.splitlines())
    queries = ["Rows(f)", "TopN(f)", "Count(Row(f=1))"] if fopts.get("type") != "int" else [
        "Sum(field=f)", "Count(Row(f > 1))"]
    if fopts.get("keys"):
        queries = ["Rows(f)", "TopN(f)", 'Row(f="red")', 'Count(Row(f="blue"))']
    answers = []
    for q in queries:
        status, body, _ = c("POST", f"/index/{index}/query", q)
        assert status == 200, body
        answers.append(json.loads(body))
    c.close()
    return exported, answers


@pytest.mark.parametrize("kind", list(CSV_CASES))
def test_csv_import_export_parity(nodes, tmp_path, capsys, kind):
    """``import`` then ``export`` through the port's CLI and the JAX CLI,
    each against a port node and a JAX node: the four runs export the same
    CSV lines (keys in place of ids on a keyed field or index) and answer
    the same queries."""
    runs = {(cli_pkg, node_pkg): _csv_round(nodes, tmp_path, capsys, kind, cli_pkg, node_pkg)
            for cli_pkg in ("port", "jax") for node_pkg in ("port", "jax")}
    want = runs[("jax", "jax")]
    for key, got in runs.items():
        assert got == want, key
    if "int" not in kind:
        assert len(want[0]) == len(CSV_CASES[kind][2])


def test_import_by_keys_over_http(nodes):
    """``POST /index/{i}/field/{f}/import`` with rowKeys and columnKeys,
    then the key routes and keyed queries, equal on both nodes."""
    bodies = []
    for pkg in ("jax", "port"):
        c = Client(nodes[pkg].port)
        c("POST", "/index/hk", {"options": {"keys": True}})
        c("POST", "/index/hk/field/f", {"options": {"keys": True}})
        c("POST", "/index/hk/field/v", {"options": {"type": "int", "min": 0, "max": 9}})
        out = [c("POST", "/index/hk/field/f/import",
                 {"rowKeys": ["a", "b", "a"], "columnKeys": ["x", "y", "z"]})[:2],
               c("POST", "/index/hk/field/v/import",
                 {"columnKeys": ["x", "q"], "values": [3, 9]})[:2],
               c("POST", "/index/hk/query", 'Row(f="a") Sum(field=v) TopN(f)')[:2],
               c("GET", "/internal/translate/entries?index=hk&after=0")[:2],
               c("POST", "/internal/translate/keys", {"index": "hk", "keys": ["y", "w"]})[:2],
               c("GET", "/debug/translate")[:2]]
        bodies.append(out)
        c.close()
    assert bodies[0] == bodies[1]
