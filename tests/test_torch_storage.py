"""The port's durability engine, alone and against the JAX package's.

Part 1 ports the cases of tests/test_storage.py and tests/test_integrity.py
to ``pilosa_tpu_torch.storage`` (WAL, snapshots, reload, deletion,
integrity framing, quarantine, the HTTP surface of a node with a data
dir). The JAX cases that need a cluster (replica routing, the scrubber)
become their standalone counterparts; key translation is not ported, so
its cases check that such a data dir refuses to open and that translate
files pass through untouched.

Part 2 crosses data dirs between the packages: a dir written by one opens
in the other with byte-equal ``row_words`` for every fragment, equal
quarantine entries and an equal ``schema.json``, for set and int fields,
a snapshot plus a WAL tail, a torn WAL tail, a mid-file corrupt WAL and a
bit-flipped snapshot; and the same writes produce byte-equal ``.wal``
files and ``.snap`` files in both.
"""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.core import FieldOptions as JFieldOptions
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core.translate import TranslateStore as JTranslateStore
from pilosa_tpu.exec import ingest_transpose as j_ingest_transpose
from pilosa_tpu.storage.diskstore import DiskStore as JDiskStore
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.errors import NotPortedError
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.obs import MemoryStats
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.storage import DiskStore, WalReader, WalWriter, scan_wal
from pilosa_tpu_torch.storage.diskstore import read_snapshot
from pilosa_tpu_torch.storage.faults import FaultyDiskStore, corrupt_file
from pilosa_tpu_torch.storage.integrity import (
    FOOTER_SIZE,
    LineCorruptError,
    SnapshotCorruptError,
    frame_line,
    parse_line,
    snapshot_footer,
    split_snapshot,
)
from pilosa_tpu_torch.storage.quarantine import ShardCorruptError
from pilosa_tpu_torch.storage.wal import OP_ADD, OP_REMOVE, OP_SET_ROW

KEY = ("i", "f", "standard", 0)


def make_holder(data_dir, **kw):
    h = Holder(device="cpu")
    store = DiskStore(data_dir, h, **kw)
    store.open()
    return h, store


def cols_of(h, query="Row(f=1)", index="i"):
    (row,) = Executor(h).execute(index, query)
    return row.columns().tolist()


# -- part 1: the cases of tests/test_storage.py ------------------------------


def test_wal_roundtrip(tmp_path):
    p = str(tmp_path / "f.wal")
    w = WalWriter(p)
    w.append("add", [1, 2], [10, 20])
    w.append("removeBatch", [3], [30])
    w.append("setRow", [4], [40, 41])
    w.close()
    ops = list(WalReader(p))
    assert [op[0] for op in ops] == [OP_ADD, OP_REMOVE, OP_SET_ROW]
    assert ops[0][1].tolist() == [1, 2] and ops[0][2].tolist() == [10, 20]
    assert ops[2][1].tolist() == [4] and ops[2][2].tolist() == [40, 41]


def test_wal_torn_tail(tmp_path):
    p = str(tmp_path / "f.wal")
    w = WalWriter(p)
    w.append("add", [1], [10])
    w.append("add", [2], [20])
    w.close()
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 5)  # tear the second record
    ops = list(WalReader(p))
    assert len(ops) == 1 and ops[0][1].tolist() == [1]


def test_wal_replay_after_crash(tmp_path):
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    h.create_index("i").create_field("f")
    e = Executor(h)
    e.execute("i", "Set(5, f=1) Set(9, f=1)")
    e.execute("i", "Clear(5, f=1)")
    store.save_schema()
    # crash: NO snapshot/flush — only schema.json + WAL on disk
    h2, _ = make_holder(d)
    assert cols_of(h2) == [9]


def test_snapshot_and_reload(tmp_path):
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    idx = h.create_index("i")
    f = idx.create_field("f")
    v = idx.create_field("v", FieldOptions(type="int", min=-100, max=100))
    cols = [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3]
    f.import_bits([7] * len(cols), cols)
    v.import_values([1, 2], [42, -9])
    store.close()  # flush: schema + snapshots + attr stores

    h2, store2 = make_holder(d)
    assert cols_of(h2, "Row(f=7)") == cols
    assert Executor(h2).execute("i", "Sum(field=v)")[0].val == 33
    assert h2.field("i", "v").value(2) == (-9, True)
    wal = os.path.join(d, "i", "f", "standard", "0.wal")
    assert not os.path.exists(wal) or os.path.getsize(wal) == 0
    store2.close()


def test_snapshot_trigger_on_max_op_n(tmp_path):
    """Past max_op_n WAL records the fragment is queued for a snapshot.
    With no workers the queue is read here, so no clock is involved."""
    d = str(tmp_path / "data")
    h, store = make_holder(d, max_op_n=10, snapshot_workers=0)
    f = h.create_index("i").create_field("f")
    for i in range(10):
        f.set_bit(1, i)
    assert store._snap_q.empty()
    f.set_bit(1, 10)  # the 11th record
    assert store._snap_q.get_nowait() == KEY
    for i in range(11, 25):
        f.set_bit(1, i)  # already pending: queued once
    assert store._snap_q.empty()
    store.snapshot_fragment(KEY)
    assert store._writers[KEY].op_n == 0
    assert os.path.getsize(os.path.join(d, "i", "f", "standard", "0.wal")) == 0
    store.save_schema()
    h2, _ = make_holder(d)
    assert h2.fragment(*KEY).bit_count() == 25


def test_attrs_persist_and_translate_passes_through(tmp_path):
    """Attr files load and flush back unchanged; a translate file the
    port does not read stays byte for byte."""
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    idx = h.create_index("i")
    f = idx.create_field("f")
    f.row_attr_store.set_attrs(1, {"color": "red"})
    idx.column_attr_store.set_attrs(9, {"name": "bob"})
    tpath = os.path.join(d, "i", "f", "translate.jsonl")
    store.close()
    with open(tpath, "w") as fh:
        fh.write(frame_line('["alpha", 1]') + "\n")
    before = {p: open(p, "rb").read() for p in (
        tpath, os.path.join(d, "i", "f", "row_attrs.jsonl"),
        os.path.join(d, "i", "column_attrs.jsonl"))}

    h2, store2 = make_holder(d)
    assert h2.field("i", "f").row_attr_store.attrs(1) == {"color": "red"}
    assert h2.index("i").column_attr_store.attrs(9) == {"name": "bob"}
    store2.close()
    assert {p: open(p, "rb").read() for p in before} == before


@pytest.mark.parametrize("options,slice_word", [
    ({"type": "time", "timeQuantum": "YMD"}, "time"),
    ({"type": "set", "keys": True}, "keys"),
])
def test_unported_schema_refuses_to_open(tmp_path, options, slice_word):
    """A data dir whose schema holds a keyed field (written by the JAX
    package) refuses to open, naming the slice that ports it. A time field
    refused too until ROADMAP.md Queue 1 item 4a; now the dir opens with
    the JAX field's options and the rows of its time views
    (tests/test_torch_fields.py crosses such dirs both ways)."""
    d = str(tmp_path / "data")
    jh = JHolder()
    js = JDiskStore(d, jh)
    js.open()
    jf = jh.create_index("i").create_field("t", JFieldOptions.from_json(options))
    if slice_word == "time":
        import datetime as dt
        jf.import_bits([1, 1, 2], [3, SHARD_WIDTH + 5, 7],
                       [dt.datetime(2020, 1, 2), dt.datetime(2020, 3, 4), None])
    js.close()
    if slice_word != "time":
        with pytest.raises(NotPortedError, match=slice_word):
            make_holder(d)
        return
    h, store = make_holder(d)
    f = h.field("i", "t")
    assert f.options.to_json() == jf.options.to_json()
    assert f.view_names() == jf.view_names()
    for view in jf.view_names():
        for shard in jf.view(view).fragments:
            frag = h.fragment("i", "t", view, shard)
            for rid in jf.view(view).fragments[shard].row_ids():
                assert np.array_equal(frag.row_words(rid),
                                      jf.view(view).fragments[shard].row_words(rid))
    store.close()


def _post(base, path, body):
    r = urllib.request.Request(base + path, data=body.encode(), method="POST")
    return urllib.request.urlopen(r, timeout=30).read()


def test_server_node_with_data_dir(tmp_path):
    from pilosa_tpu_torch.server import ServerNode
    d = str(tmp_path / "data")
    n = ServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False, data_dir=d)
    n.open()
    _post(n.address, "/index/i", "{}")
    _post(n.address, "/index/i/field/f", "{}")
    _post(n.address, "/index/i/query", "Set(123, f=1)")
    n.close()

    n2 = ServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False, data_dir=d)
    n2.open()
    try:
        resp = json.loads(_post(n2.address, "/index/i/query", "Row(f=1)"))
        assert resp["results"][0]["columns"] == [123]
    finally:
        n2.close()


@pytest.mark.parametrize("level", ["field", "index"])
def test_deleted_data_does_not_resurrect_on_reload(tmp_path, level):
    """Delete a field (or index), recreate the name, restart: the new one
    must be EMPTY, since the reloader is schema-driven and stale files
    would re-populate it unless deletion unlinks the subtree."""
    d = str(tmp_path / "data")
    h = Holder(device="cpu")
    h.create_index("i").create_field("f").set_bit(1, 42)
    store = DiskStore(d, h)
    store.open()
    store.flush()
    api = API(h, Executor(h))
    api.store = store
    if level == "field":
        api.delete_field("i", "f")
        h.index("i").create_field("f").set_bit(2, 7)
    else:
        api.delete_index("i")
        h.create_index("i").create_field("f").set_bit(2, 7)
    store.flush()
    store.close()

    h2, store2 = make_holder(d)
    assert cols_of(h2, "Row(f=1)") == [], "deleted data resurrected"
    assert cols_of(h2, "Row(f=2)") == [7]
    store2.close()


def test_delete_view_unlinks_files_and_survives_reload(tmp_path):
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    f = h.create_index("i").create_field("f")
    api = API(h, Executor(h))
    api.store = store
    f.set_bit(1, 3)
    f.create_view_if_not_exists("standard_2024").create_fragment_if_not_exists(
        0).set_bit(1, 9)
    store.flush()
    assert os.path.isdir(os.path.join(d, "i", "f", "standard_2024"))
    api.delete_view("i", "f", "standard_2024")
    assert f.view("standard_2024") is None
    assert not os.path.isdir(os.path.join(d, "i", "f", "standard_2024"))
    store.close()

    h2, store2 = make_holder(d)
    assert h2.field("i", "f").view("standard_2024") is None
    assert cols_of(h2) == [3]
    store2.close()


def test_snapshot_footer_roundtrip():
    payload = b"not really an npz but bytes are bytes"
    got, meta = split_snapshot(payload + snapshot_footer(payload, rows=3, bits=9))
    assert got == payload
    assert meta["rows"] == 3 and meta["bits"] == 9


@pytest.mark.parametrize("damage,match", [
    (lambda d: d[:50] + bytes([d[50] ^ 0x10]) + d[51:], "crc"),
    (lambda d: d[:-7], "truncated"),
])
def test_snapshot_footer_rejects_damage(damage, match):
    """A flipped payload bit fails the CRC; a footer cut mid-write reads
    as CORRUPT, not as an unverified legacy file."""
    payload = b"x" * 100
    data = payload + snapshot_footer(payload, rows=1, bits=1)
    with pytest.raises(SnapshotCorruptError, match=match):
        split_snapshot(damage(data))


def test_line_frame_roundtrip_and_legacy():
    framed = frame_line('["k", 7]')
    assert parse_line(framed) == ('["k", 7]', True)
    assert parse_line('["legacy", 1]') == ('["legacy", 1]', False)
    with pytest.raises(LineCorruptError):
        parse_line(framed[:-1] + "X")


def test_bitflip_snapshot_quarantined_preserved(tmp_path):
    """Bit-flipped snapshot + empty WAL: the file moves to *.quarantine,
    the shard is unavailable, and a query over it raises."""
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    h.create_index("i").create_field("f").import_bits([1] * 20, range(20))
    store.close()
    snap = os.path.join(d, "i", "f", "standard", "0.snap")
    corrupt_file(snap, "bitflip")

    h2, store2 = make_holder(d)
    e = store2.quarantine.get(KEY)
    assert e is not None and e["state"] == "unavailable"
    assert os.path.exists(snap + ".quarantine") and not os.path.exists(snap)
    with pytest.raises(ShardCorruptError):
        Executor(h2).execute("i", "Row(f=1)")
    store2.close()


def test_corrupt_snapshot_falls_back_to_wal(tmp_path):
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    h.create_index("i").create_field("f")
    Executor(h).execute("i", "Set(5, f=1) Set(9, f=1)")
    store.save_schema()  # crash: WAL only
    with open(os.path.join(d, "i", "f", "standard", "0.snap"), "wb") as f:
        f.write(b"\x01" * 48)

    h2, store2 = make_holder(d)
    assert store2.quarantine.get(KEY)["state"] == "degraded"
    assert cols_of(h2) == [5, 9]
    store2.close()


def test_scan_wal_midfile_corruption(tmp_path):
    p = str(tmp_path / "f.wal")
    w = WalWriter(p)
    for i in range(8):
        w.append("add", [i], [i * 10])
    w.close()
    info = scan_wal(p)
    assert info["ops"] == 8 and not info["torn"] and not info["corrupt"]
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    info = scan_wal(p)
    assert info["corrupt"] and 0 < info["ops"] < 8
    p2 = str(tmp_path / "g.wal")
    w2 = WalWriter(p2)
    w2.append("add", [1], [10])
    w2.append("add", [2], [20])
    w2.close()
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) - 3)
    info = scan_wal(p2)
    assert info["torn"] and not info["corrupt"] and info["ops"] == 1


def test_corrupt_wal_quarantined_as_degraded(tmp_path):
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    h.create_index("i").create_field("f")
    e = Executor(h)
    for c in range(10):
        e.execute("i", f"Set({c}, f=1)")
    store.save_schema()
    wal = os.path.join(d, "i", "f", "standard", "0.wal")
    with open(wal, "r+b") as f:
        f.seek(os.path.getsize(wal) // 2)
        f.write(b"\xde\xad\xbe\xef")

    h2, store2 = make_holder(d)
    assert store2.quarantine.get(KEY)["state"] == "degraded"
    assert os.path.exists(wal + ".quarantine")
    assert 0 < len(cols_of(h2)) < 10  # prefix salvaged, damaged tail lost
    store2.close()


def test_corrupt_jsonl_lines_skipped(tmp_path):
    apath = str(tmp_path / "a.jsonl")
    st = AttrStore(apath)
    st.set_attrs(1, {"color": "red"})
    st.set_attrs(2, {"color": "blue"})
    st.save()
    lines = open(apath).read().splitlines()
    lines[0] = lines[0][:-1]  # truncate a framed line
    with open(apath, "w") as f:
        f.write("\n".join(lines) + "\n")
    st2 = AttrStore(apath)
    assert st2.corrupt_lines == 1
    assert st2.attrs(1) == {} and st2.attrs(2) == {"color": "blue"}


def test_legacy_unframed_snapshot_still_loads(tmp_path):
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    h.create_index("i").create_field("f").import_bits([1, 2], [10, 20])
    store.close()
    snap = os.path.join(d, "i", "f", "standard", "0.snap")
    data = open(snap, "rb").read()
    with open(snap, "wb") as f:
        f.write(data[:-FOOTER_SIZE])
    arrays, meta, status = read_snapshot(snap)
    assert status == "legacy" and meta is None
    assert arrays["row_ids"].tolist() == [1, 2]

    h2, store2 = make_holder(d)
    assert len(store2.quarantine) == 0
    assert cols_of(h2) == [10]
    store2.snapshot_fragment(KEY)
    assert store2.verify_snapshot(KEY) == "ok"
    store2.close()


def test_faulty_diskstore_one_shot(tmp_path):
    h = Holder(device="cpu")
    store = FaultyDiskStore(str(tmp_path / "data"), h)
    store.open()
    h.create_index("i").create_field("f").set_bit(1, 5)
    store.fault_next_snapshot = "bitflip"
    store.snapshot_fragment(KEY)
    assert store.faults_injected == 1
    assert read_snapshot(store._snap_path(KEY))[2] == "bad"
    store.snapshot_fragment(KEY)  # one-shot: clean again
    assert store.faults_injected == 1
    assert read_snapshot(store._snap_path(KEY))[2] == "ok"
    store.close()


def test_snapshot_guard_refuses_blocked_overwrite(tmp_path):
    """flush() on a node holding an unavailable shard must not launder
    the corruption into a clean-looking empty snapshot."""
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    h.create_index("i").create_field("f").import_bits([1] * 5, range(5))
    store.close()
    snap = os.path.join(d, "i", "f", "standard", "0.snap")
    corrupt_file(snap, "bitflip")

    h2, store2 = make_holder(d)
    assert store2.quarantine.get(KEY)["state"] == "unavailable"
    store2.flush()
    assert not os.path.exists(snap)
    assert store2.verify_snapshot(KEY) == "missing"
    store2.close()


def test_threaded_snapshot_and_reload_under_switching(tmp_path):
    """flush() snapshots and open() reloads fragments on IO_WORKERS
    threads: with the interpreter switching threads every microsecond,
    40 shards come back with every row, and 5 corrupted snapshots give
    exactly 5 quarantine entries."""
    import sys

    d = str(tmp_path / "data")
    rng = np.random.default_rng(5)
    h, store = make_holder(d)
    f = h.create_index("i").create_field("f")
    f.import_bits(rng.integers(0, 6, 200000), rng.integers(0, 40 * SHARD_WIDTH, 200000))
    want = {k: h.fragment(*k).rows_snapshot() for k in store._all_keys()}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        store.close()
        for shard in range(0, 40, 8):
            corrupt_file(os.path.join(d, "i", "f", "standard", f"{shard}.snap"),
                         "truncate")
        h2, store2 = make_holder(d)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(store2.quarantine.keys()) == [
        ("i", "f", "standard", s) for s in range(0, 40, 8)]
    for k, rows in want.items():
        if k[3] % 8 == 0:
            continue
        got = h2.fragment(*k).rows_snapshot()
        assert [r for r, _ in got] == [r for r, _ in rows]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, rows))
    store2.close()


# -- part 1: the cases of tests/test_integrity.py, standalone ---------------


def seed_and_close(d, n_bits=50, n_rows=5):
    """50 bits over 5 rows through the executor, then a clean close."""
    h, store = make_holder(d)
    h.create_index("i").create_field("f")
    e = Executor(h)
    for c in range(n_bits):
        e.execute("i", f"Set({c}, f={c % n_rows})")
    store.close()


def test_bitflip_counted_and_rewritten_from_the_wal(tmp_path):
    """The standalone half of the cluster acceptance path: a bit-flipped
    snapshot is detected at load, counted, its evidence kept; with the
    ops still in the WAL the fragment is degraded, serves the WAL's bits,
    and the workers publish a clean snapshot a restart trusts."""
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    h.create_index("i").create_field("f")
    Executor(h).execute("i", "Set(3, f=1) Set(4, f=1)")
    store.snapshot_fragment(KEY)
    Executor(h).execute("i", "Set(5, f=1)")
    store.save_schema()  # crash after one more write
    snap = os.path.join(d, "i", "f", "standard", "0.snap")
    corrupt_file(snap, "bitflip")

    stats = MemoryStats()
    h2, store2 = make_holder(d, stats=stats)
    assert store2.quarantine.get(KEY)["state"] == "degraded"
    assert stats.counter_value("integrity.quarantined") == 1
    assert stats.counter_value("integrity.snapshotCorrupt") == 1
    assert stats.counter_value("integrity.walReplayFallback") == 1
    assert cols_of(h2) == [5]  # only the WAL tail survives
    store2.close()  # drains the queued re-snapshot
    assert read_snapshot(snap)[2] == "ok"
    h3, store3 = make_holder(d)
    assert len(store3.quarantine) == 0 and cols_of(h3) == [5]
    store3.close()


def test_latent_bit_rot_found_and_resnapshotted(tmp_path):
    """Disk rots AFTER a clean load: re-verification finds the bad
    footer and a snapshot from the in-memory truth repairs it."""
    d = str(tmp_path / "data")
    seed_and_close(d)
    h, store = make_holder(d)
    snap = os.path.join(d, "i", "f", "standard", "0.snap")
    corrupt_file(snap, "bitflip")  # memory still healthy
    assert store.verify_snapshot(KEY) == "bad"
    store.snapshot_fragment(KEY)
    assert store.verify_snapshot(KEY) == "ok"
    assert [c for r in range(5) for c in cols_of(h, f"Row(f={r})")
            ] == [c for r in range(5) for c in range(r, 50, 5)]
    store.close()


def test_quarantine_evidence_pruned_to_keep_n(tmp_path):
    """Repeated corruption of one fragment keeps numbered evidence files;
    quarantine_keep_n prunes them oldest first."""
    d = str(tmp_path / "data")
    seed_and_close(d)
    snap = os.path.join(d, "i", "f", "standard", "0.snap")
    for i in range(3):
        corrupt_file(snap, "bitflip")
        h, store = make_holder(d, quarantine_keep_n=2)
        assert store.quarantine.get(KEY)["state"] == "unavailable"
        store.close()
        with open(snap, "wb") as fh:  # an operator's replacement copy
            fh.write(b"\x00" * 64)
    files = sorted(os.listdir(os.path.dirname(snap)))
    assert [f for f in files if "quarantine" in f] == [
        "0.snap.quarantine", "0.snap.quarantine.1", "0.snap.quarantine.2"]
    h, store = make_holder(d, quarantine_keep_n=2)
    assert store.prune_quarantine_evidence(KEY) == 2
    left = [f for f in os.listdir(os.path.dirname(snap)) if "quarantine" in f]
    assert len(left) == 2
    store.close()


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path, timeout=30).read())


def test_debug_quarantine_endpoint_and_503(tmp_path):
    from pilosa_tpu_torch.server import ServerNode
    d = str(tmp_path / "data")
    n = ServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False, data_dir=d)
    n.open()
    _post(n.address, "/index/i", "{}")
    _post(n.address, "/index/i/field/f", "{}")
    _post(n.address, "/index/i/query", "Set(123, f=1)")
    n.close()
    corrupt_file(os.path.join(d, "i", "f", "standard", "0.snap"), "bitflip")

    n2 = ServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False, data_dir=d)
    n2.open()
    try:
        q = _get(n2.address, "/debug/quarantine")
        assert q["count"] == 1
        (e,) = q["entries"]
        assert (e["index"], e["field"], e["shard"], e["state"]) == (
            "i", "f", 0, "unavailable")
        assert e["files"] and all(f.endswith(".quarantine") for f in e["files"])
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(n2.address, "/index/i/query", "Row(f=1)")
        assert exc.value.code == 503
        assert "quarantined" in exc.value.read().decode()
    finally:
        n2.close()


def test_standalone_degraded_serves_wal_salvage(tmp_path):
    """Snapshot corrupt but the WAL holds the ops: the node serves the
    WAL's bits as degraded, says so, and persists the salvage, so the
    next boot loads clean."""
    from pilosa_tpu_torch.server import ServerNode
    d = str(tmp_path / "data")
    h, store = make_holder(d)
    h.create_index("i").create_field("f")
    Executor(h).execute("i", "Set(7, f=1) Set(9, f=1)")
    store.save_schema()
    with open(os.path.join(d, "i", "f", "standard", "0.snap"), "wb") as f:
        f.write(b"\x00" * 64)

    for expect_count in (1, 0):
        n = ServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False, data_dir=d)
        n.open()
        try:
            q = _get(n.address, "/debug/quarantine")
            assert q["count"] == expect_count
            if expect_count:
                assert q["entries"][0]["state"] == "degraded"
            out = json.loads(_post(n.address, "/index/i/query", "Row(f=1)"))
            assert out["results"][0]["columns"] == [7, 9]
        finally:
            n.close()


# -- part 2: data dirs across the packages ------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _jax_host_value_path():
    """The JAX package's value import on its host path (the device
    transpose adopts read-only rows: ROADMAP Queue 3)."""
    j_ingest_transpose.set_mode("off")
    yield
    j_ingest_transpose.set_mode("auto")


def _write(pkg: str, d: str, crash_tail: bool):
    """Seeded set and int data, written by one package's Holder through
    its DiskStore: bulk imports (the scatter path and the sorted path),
    single bits, values, a snapshot, then more writes left in the WAL.
    ``crash_tail`` stops without a flush (schema.json only)."""
    rng = np.random.default_rng(11)
    if pkg == "jax":
        h = JHolder()
        store = JDiskStore(d, h)
        opts = JFieldOptions(type="int", min=-1000, max=1000)
    else:
        h = Holder(device="cpu")
        store = DiskStore(d, h)
        opts = FieldOptions(type="int", min=-1000, max=1000)
    store.open()
    idx = h.create_index("i")
    f, g = idx.create_field("f"), idx.create_field("g")
    v = idx.create_field("v", opts)
    n_cols = 3 * SHARD_WIDTH
    big = rng.integers(0, n_cols, 70000, dtype=np.uint64)
    f.import_bits(np.full(len(big), 1, np.uint64), big)        # scatter path
    g.import_bits(rng.integers(0, 40, 3000, dtype=np.uint64),
                  rng.integers(0, n_cols, 3000, dtype=np.uint64))  # sorted
    vcols = rng.choice(n_cols, 2000, replace=False).astype(np.uint64)
    v.import_values(vcols, rng.integers(-1000, 1001, 2000))
    for c in (3, SHARD_WIDTH + 4, 2 * SHARD_WIDTH + 5):
        f.set_bit(2, c)
    f.clear_bit(1, int(big[0]))
    store.flush()  # snapshots; the writes below stay in the WAL
    g.import_bits([5, 6, 7], [9, SHARD_WIDTH + 9, 2 * SHARD_WIDTH + 9], clear=False)
    g.import_bits([5], [9], clear=True)
    v.import_values(vcols[:50], rng.integers(-1000, 1001, 50))
    f.set_bit(3, 77)
    if crash_tail:
        store.save_schema()
    else:
        store.close()
    return store


def _open(pkg: str, d: str):
    h = JHolder() if pkg == "jax" else Holder(device="cpu")
    store = (JDiskStore if pkg == "jax" else DiskStore)(d, h)
    store.open()
    return h, store


def _frag_words(h) -> dict:
    out = {}
    for iname in h.index_names():
        for fname, f in h.index(iname).fields.items():
            for vname, v in f.views.items():
                for shard, frag in v.fragments.items():
                    for rid in sorted(frag.rows):
                        out[(iname, fname, vname, shard, rid)] = \
                            frag.row_words(rid).tobytes()
    return out


def _entries(store, d):
    out = []
    for e in store.quarantine.entries():
        e = dict(e)
        e.pop("since")
        e["files"] = [os.path.relpath(p, d) for p in e["files"]]
        out.append(e)
    return out


def _damage(d: str, fault: str) -> None:
    wal = os.path.join(d, "i", "g", "standard", "0.wal")
    snap = os.path.join(d, "i", "f", "standard", "1.snap")
    if fault == "torn":
        with open(wal, "r+b") as f:
            f.truncate(os.path.getsize(wal) - 5)
    elif fault == "midfile":
        w = WalWriter(wal)  # one more record after the damage
        w.append("add", [8], [10])
        w.close()
        with open(wal, "r+b") as f:
            f.seek(30)
            f.write(b"\xde\xad\xbe\xef")
    elif fault == "bitflip":
        corrupt_file(snap, "bitflip")


@pytest.mark.parametrize("fault", ["none", "torn", "midfile", "bitflip"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_data_dir_crosses_packages(tmp_path, writer, reader, fault):
    """A dir written by ``writer`` (snapshot + WAL tail, set and int
    fields, then ``fault``) opens in both packages with byte-equal rows,
    equal quarantine entries, and an equal schema.json after a flush."""
    src = str(tmp_path / "src")
    _write(writer, src, crash_tail=True)
    _damage(src, fault)
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(src, dirs[pkg])
    opened = {pkg: _open(pkg, dirs[pkg]) for pkg in (writer, reader)}
    words = {pkg: _frag_words(h) for pkg, (h, _) in opened.items()}
    assert words[reader] == words[writer] and len(words[reader]) > 100
    entries = {pkg: _entries(s, dirs[pkg]) for pkg, (_, s) in opened.items()}
    assert entries[reader] == entries[writer]
    assert len(entries[reader]) == (0 if fault in ("none", "torn") else 1)
    for pkg, (_, store) in opened.items():
        store.close()
    schemas = {pkg: open(os.path.join(dirs[pkg], "schema.json"), "rb").read()
               for pkg in opened}
    assert schemas["jax"] == schemas["port"]


def test_same_writes_same_bytes(tmp_path):
    """The same writes through either package leave byte-equal WAL files
    (records, order, op codes) and, after close, byte-equal snapshots and
    schema.json."""
    d = {pkg: str(tmp_path / pkg) for pkg in ("jax", "port")}
    for pkg in d:
        _write(pkg, d[pkg], crash_tail=True)

    def files(root, ext):
        out = {}
        for r, _, fs in os.walk(root):
            for fn in fs:
                if fn.endswith(ext):
                    p = os.path.join(r, fn)
                    out[os.path.relpath(p, root)] = open(p, "rb").read()
        return out

    wals = {pkg: files(d[pkg], ".wal") for pkg in d}
    assert wals["jax"] == wals["port"]
    assert sum(len(b) > 0 for b in wals["port"].values()) >= 4
    snaps = {pkg: files(d[pkg], ".snap") for pkg in d}
    assert snaps["jax"] == snaps["port"] and len(snaps["port"]) >= 9
    for pkg in d:
        _open(pkg, d[pkg])[1].close()
    for ext in (".snap", ".json"):
        got = {pkg: files(d[pkg], ext) for pkg in d}
        assert got["jax"] == got["port"]


def test_jax_translate_and_attr_files_survive_a_port_flush(tmp_path):
    """A JAX dir with attrs and a translate store of an unkeyed field:
    the port opens and flushes it and every such file is unchanged."""
    d = str(tmp_path / "data")
    jh = JHolder()
    js = JDiskStore(d, jh)
    js.open()
    idx = jh.create_index("i")
    f = idx.create_field("f")
    f.set_bit(1, 5)
    f.row_attr_store.set_attrs(1, {"color": "red"})
    idx.column_attr_store.set_attrs(5, {"n": 1})
    js.close()
    tpath = os.path.join(d, "i", "f", "translate.jsonl")
    ts = JTranslateStore(tpath)
    ts.translate_key("alpha")
    ts.save()
    meta = [os.path.join(d, "i", "column_attrs.jsonl"),
            os.path.join(d, "i", "f", "row_attrs.jsonl"), tpath]
    before = {p: open(p, "rb").read() for p in meta}
    h, store = make_holder(d)
    assert h.field("i", "f").row_attr_store.attrs(1) == {"color": "red"}
    store.flush()
    store.close()
    assert {p: open(p, "rb").read() for p in meta} == before


def test_value_wal_equals_the_device_transpose_log(tmp_path, monkeypatch):
    """The JAX package's device value transpose logs its batch through
    ``_emit_value_wal``; the port's host planes write the same records in
    the same order, for a fresh import and an overwrite with negatives."""
    monkeypatch.setenv("PILOSA_TPU_INGEST_TRANSPOSE", "on")
    rng = np.random.default_rng(21)
    cols = rng.choice(2 * SHARD_WIDTH, 3000, replace=False)
    batches = [(cols, rng.integers(0, 1001, 3000)),
               (cols[::2], rng.integers(-1000, 1001, 1500))]
    wal = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        if pkg == "jax":
            h = JHolder()
            store = JDiskStore(d, h)
            opts = JFieldOptions(type="int", min=-1000, max=1000)
        else:
            h = Holder(device="cpu")
            store = DiskStore(d, h)
            opts = FieldOptions(type="int", min=-1000, max=1000)
        store.open()
        v = h.create_index("i").create_field("v", opts)
        for c, vals in batches:
            v.import_values(c, vals)
        wal[pkg] = {s: open(os.path.join(d, "i", "v", "bsig_v", f"{s}.wal"), "rb").read()
                    for s in (0, 1)}
    assert wal["port"] == wal["jax"]
    assert all(len(b) > 0 for b in wal["port"].values())
