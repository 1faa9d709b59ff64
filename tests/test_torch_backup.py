"""Backup and restore of the port on a single node, against the JAX package.

Both packages run on the same seeded data (set and int fields over 3
shards, single Sets, a row replaced and a row cleared in the WAL, row and
column attrs; the JAX side's value import pinned to its host loop, whose
rows stay writable):

- archives cross packages both ways: a JAX holder's archive restores into
  a port holder and the reverse, with byte-equal rows and equal Count and
  Sum answers, and equal manifests' file lists;
- ``rebuild_fragment`` (the port's numpy replay) against the JAX one on
  generated WAL histories of every op code, at every PITR offset;
- ``verify_archive`` verdicts equal on clean and damaged archives;
- PITR, incremental capture and retention on single-node fixtures of
  ``tests/test_backup.py``, ``test_backup_scheduler.py`` and
  ``test_objstore.py``, the object-store cases against the port's
  ``FakeObjectServer``;
- the backup routes' HTTP bodies against a JAX node's, and ``backup``,
  ``restore``, ``backup-verify``, ``check --archive``, ``config`` and
  ``generate-config`` against the JAX CLI;
- keyed archives (a keyed index and field, their translate stores) cross
  packages both ways with equal entries, rows and keyed answers;
- what the port does not carry yet answers ``NotPortedError``: a writer,
  job or scheduler given a cluster.
"""

import json
import os
import random
import time

import numpy as np
import pytest

from pilosa_tpu import cli as j_cli
from pilosa_tpu.backup import BackupWriter as JBackupWriter
from pilosa_tpu.backup import LocalDirArchive as JLocalDirArchive
from pilosa_tpu.backup import RestoreJob as JRestoreJob
from pilosa_tpu.backup import verify_archive as j_verify_archive
from pilosa_tpu.backup.restore import rebuild_fragment as j_rebuild_fragment
from pilosa_tpu.backup.retention import plan_prune as j_plan_prune
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.index import IndexOptions as JIndexOptions
from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_json
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu.storage import DiskStore as JDiskStore
from pilosa_tpu_torch import cli as t_cli
from pilosa_tpu_torch.backup import (
    ArchiveStore,
    BackupError,
    BackupScheduler,
    BackupWriter,
    LocalDirArchive,
    ObjectArchiveStore,
    RestoreJob,
    capture_fragment,
    new_backup_id,
    open_archive,
    parse_archive_url,
    plan_prune,
    preflight_restore,
    prune_archive,
    resolve_files,
    select_backup_at,
    verify_archive,
)
from pilosa_tpu_torch.backup.archive import file_crc
from pilosa_tpu_torch.backup.faults import FakeObjectServer, FaultyArchive
from pilosa_tpu_torch.backup.restore import rebuild_fragment
from pilosa_tpu_torch.backup.scheduler import FAILED, RAN, SKIP_NOT_DUE, SKIP_UNCHANGED
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.errors import NotPortedError
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec import result_to_json as t_json
from pilosa_tpu_torch.obs.stats import MemoryStats
from pilosa_tpu_torch.server import ServerNode
from pilosa_tpu_torch.storage import DiskStore
from pilosa_tpu_torch.storage.faults import corrupt_file
from test_torch_persist_server import Client

N_SHARDS = 3
QUERIES = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=2)))", "Count(Row(f=3))",
           "Sum(field=v)", "Sum(Row(f=1), field=v)", "Min(field=v)", "Max(field=v)",
           "Count(Row(v > 100))"]


@pytest.fixture(autouse=True)
def _host_value_import(monkeypatch):
    """Both packages' value imports on their host plane loops: rows the JAX
    device transpose adopts are read-only, and these fixtures write after
    importing (ROADMAP.md Queue 3, "read-only views")."""
    monkeypatch.setenv("PILOSA_TPU_INGEST_TRANSPOSE", "off")


class Side:
    """One package's holder, store, executor and backup classes."""

    def __init__(self, pkg: str, d: str):
        self.pkg = pkg
        if pkg == "jax":
            self.h = JHolder()
            self.store = JDiskStore(d, self.h)
            self.opts, self.ex_cls, self.to_json = JFieldOptions, JExecutor, j_json
            self.writer, self.job, self.archive = JBackupWriter, JRestoreJob, JLocalDirArchive
        else:
            self.h = Holder(device="cpu")
            self.store = DiskStore(d, self.h)
            self.opts, self.ex_cls, self.to_json = FieldOptions, Executor, t_json
            self.writer, self.job, self.archive = BackupWriter, RestoreJob, LocalDirArchive
        self.store.open()

    def answers(self) -> list:
        ex = self.ex_cls(self.h)
        return [self.to_json(ex.execute("i", q)[0]) for q in QUERIES]

    def backup(self, root: str, parent: str | None = None) -> dict:
        return self.writer(self.h, None, None, self.store, self.archive(root)).run(
            parent=parent)

    def restore(self, root: str, backup_id: str, **kw) -> dict:
        return self.job(self.h, None, None, self.archive(root), backup_id,
                        store=self.store, **kw).run()


def _seed(side: Side, seed: int = 0) -> None:
    """Set and int fields over N_SHARDS shards: bulk bits, single Sets, a
    snapshot in the middle, a replaced and a cleared row in the WAL, values
    with negatives, row and column attrs."""
    rng = np.random.default_rng(seed)
    h = side.h
    idx = h.create_index("i")
    f = idx.create_field("f")
    v = idx.create_field("v", side.opts(type="int", min=-1000, max=1000))
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 6000)
    f.import_bits(rng.integers(1, 5, 6000), cols)
    v.import_values(cols[:2000], rng.integers(-1000, 1001, 2000))
    side.store.flush()  # snapshots: later writes land in WALs after them
    for c in rng.integers(0, N_SHARDS * SHARD_WIDTH, 40).tolist():
        f.set_bit(int(c % 5), int(c))
    frag = f.view("standard").fragments[1]
    row_cls = Row if side.pkg == "port" else JRow
    frag.set_row(row_cls.from_columns([SHARD_WIDTH + 9, SHARD_WIDTH + 10]), 3)
    frag.clear_row(4)
    v.import_values(cols[2000:2100], rng.integers(-1000, 1001, 100))
    f.row_attr_store.set_attrs(1, {"k": "v", "n": 3})
    idx.column_attr_store.set_attrs(7, {"c": True})


def _rows(h) -> dict:
    out = {}
    for iname in h.index_names():
        for fname, f in h.index(iname).fields.items():
            for vname, view in f.views.items():
                for shard, frag in view.fragments.items():
                    for rid, hr in frag.rows.items():
                        if hr.n:
                            out[(iname, fname, vname, shard, rid)] = hr.to_words().tobytes()
    return out


def _attrs(h) -> tuple:
    idx = h.index("i")
    return (idx.column_attr_store.attrs(7), idx.field("f").row_attr_store.attrs(1))


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_archive_crosses_packages(tmp_path, src, dst):
    """An archive written by one package's writer restores through the
    other's RestoreJob with byte-equal rows, attrs and answers; both
    packages' writers archive the same files from the same data."""
    sides = {pkg: Side(pkg, str(tmp_path / f"{pkg}-src")) for pkg in ("jax", "port")}
    for s in sides.values():
        _seed(s)
    manifests = {pkg: s.backup(str(tmp_path / f"arch-{pkg}")) for pkg, s in sides.items()}
    files = {pkg: sorted((e["path"], e["kind"], e["size"], e["crc"]) for e in m["files"])
             for pkg, m in manifests.items()}
    assert files["port"] == files["jax"]
    source = sides[src]
    target = Side(dst, str(tmp_path / f"{dst}-dst"))
    out = target.restore(str(tmp_path / f"arch-{src}"), manifests[src]["id"])
    assert out["fragments"] == len({(e["index"], e["field"], e["view"], e["shard"])
                                    for e in manifests[src]["files"]
                                    if e["kind"] in ("snap", "wal")})
    assert _rows(target.h) == _rows(source.h)
    assert _attrs(target.h) == _attrs(source.h)
    assert target.answers() == source.answers()
    for s in (*sides.values(), target):
        s.store.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rebuild_fragment_matches_jax(tmp_path, seed):
    """Generated WAL histories over a snapshot -- add, remove (also of
    absent rows), set_row, clear_row, multi-row batches -- replay to the
    same bits as the JAX rebuild at every PITR offset."""
    rng = np.random.default_rng(seed)
    side = Side("port", str(tmp_path / "d"))
    f = side.h.create_index("i").create_field("f")
    frag = f.create_view_if_not_exists("standard").create_fragment_if_not_exists(1)
    base = SHARD_WIDTH
    frag.bulk_import(rng.integers(0, 4, 500), base + rng.integers(0, 5000, 500))
    side.store.snapshot_fragment(("i", "f", "standard", 1))
    for _ in range(30):
        op = rng.integers(0, 4)
        n = int(rng.integers(1, 40))
        if op == 0:
            frag.bulk_import(rng.integers(0, 6, n), base + rng.integers(0, 5000, n))
        elif op == 1:
            frag.bulk_import(rng.integers(0, 6, n), base + rng.integers(0, 5000, n),
                             clear=True)
        elif op == 2:
            frag.set_row(Row.from_columns((base + rng.integers(0, 5000, n)).tolist()),
                         int(rng.integers(0, 6)))
        else:
            frag.clear_row(int(rng.integers(0, 6)))
    pair = capture_fragment(side.store, ("i", "f", "standard", 1))
    assert pair["snap"] is not None and pair["ops"] > 0
    for pitr in (None, 0, 1, pair["ops"] // 2, pair["ops"]):
        jr, jc, ja = j_rebuild_fragment(pair["snap"], pair["wal"], 1, pitr_ops=pitr)
        tr, tc, ta = rebuild_fragment(pair["snap"], pair["wal"], 1, pitr_ops=pitr)
        assert ta == ja
        assert tr.tolist() == jr and tc.tolist() == jc
    side.store.close()


def _damage(root: str, how: str) -> None:
    bid = sorted(os.listdir(root))[0]
    files = sorted(os.path.join(dp, fn) for dp, _, fns in os.walk(os.path.join(root, bid))
                   for fn in fns)
    snaps = [p for p in files if p.endswith(".snap")]
    wals = [p for p in files if p.endswith(".wal")]
    if how == "snap_bitflip":
        corrupt_file(snaps[0], "bitflip")
    elif how == "wal_garbage":
        with open(wals[0], "ab") as f:
            f.write(b"garbage-after-valid-records")
    elif how == "missing_file":
        os.remove(snaps[-1])
    elif how == "attrs_line":
        p = next(p for p in files if p.endswith("row_attrs.jsonl"))
        with open(p, "a") as f:
            f.write("not a framed line\n")
    elif how == "no_manifest":
        os.remove(os.path.join(root, bid, "manifest.json"))


@pytest.mark.parametrize("how", ["clean", "snap_bitflip", "wal_garbage", "missing_file",
                                 "attrs_line", "no_manifest"])
def test_verify_archive_verdicts_match_jax(tmp_path, how):
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    root = str(tmp_path / "arch")
    side.backup(root)
    side.store.close()
    _damage(root, how)
    got, want = verify_archive(root), j_verify_archive(root)
    assert got == want
    assert got["ok"] == (how == "clean")


def test_pitr_restores_history_and_incremental_ships_changes(tmp_path):
    """A full backup, more writes, an incremental: the incremental stores
    only the changed files and restores the live state; PITR at the full's
    op count restores the full's state from the incremental's WALs."""
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    root = str(tmp_path / "arch")
    full = side.backup(root)
    at_full = _rows(side.h)
    frag = side.h.field("i", "f").view("standard").fragments[0]
    ops_at_full = capture_fragment(side.store, ("i", "f", "standard", 0))["ops"]
    for c in (11, 12, 13):
        frag.set_bit(2, c)
    inc = side.backup(root, parent=full["id"])
    assert inc["kind"] == "incremental" and inc["parent"] == full["id"]
    stored = [e for e in inc["files"] if e.get("stored_in", inc["id"]) == inc["id"]]
    assert [e["path"] for e in stored] == ["data/i/f/standard/0.wal"]
    live = _rows(side.h)
    side.store.close()

    fresh = Side("port", str(tmp_path / "r1"))
    fresh.restore(root, inc["id"])
    assert _rows(fresh.h) == live
    fresh.store.close()
    pitr = Side("port", str(tmp_path / "r2"))
    pitr.restore(root, inc["id"], pitr_ops=ops_at_full)
    shard0 = {k: v for k, v in _rows(pitr.h).items() if k[:4] == ("i", "f", "standard", 0)}
    assert shard0 == {k: v for k, v in at_full.items() if k[:4] == ("i", "f", "standard", 0)}
    pitr.store.close()


def test_restore_refuses_clobber_without_force_and_selects_latest(tmp_path):
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    root = str(tmp_path / "arch")
    m = side.backup(root)
    before = side.answers()
    with pytest.raises(BackupError, match="force"):
        side.restore(root, m["id"])
    assert side.answers() == before
    side.restore(root, m["id"], force=True)
    assert side.answers() == before
    side.store.close()
    a = LocalDirArchive(str(tmp_path / "sel"))
    for i, created in enumerate((100.0, 200.0, 300.0)):
        a.write_manifest(f"b{i}", {"format": 1, "id": f"b{i}", "created": created,
                                   "files": []})
    assert select_backup_at(a, 250.0)["id"] == "b1"
    assert select_backup_at(a, 1e12)["id"] == "b2"
    assert select_backup_at(a, 50.0) is None


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_damaged_archive_rolls_the_restore_back(tmp_path, pkg):
    """A snapshot whose bytes no longer match the manifest's CRC fails the
    restore mid-way (the port's fragments run on a thread pool): nothing
    of the half-restored index stays, in memory or on disk, and the error
    is the JAX package's."""
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    root = str(tmp_path / "arch")
    m = side.backup(root)
    side.store.close()
    bid = m["id"]
    snap = os.path.join(root, bid, "data/i/v/bsig_v/2.snap")
    corrupt_file(snap, "bitflip")
    target = Side(pkg, str(tmp_path / "t"))
    target.h.create_index("other")
    a = target.archive(root)
    job = target.job(target.h, None, None, a, bid, store=target.store)
    with pytest.raises(Exception, match="CRC mismatch") as e:
        job.run()
    assert type(e.value).__name__ == "BackupError"
    assert target.h.index_names() == ["other"]
    assert not os.path.exists(str(tmp_path / "t" / "i"))
    assert job.progress["state"] == "failed"
    target.store.close()


def test_local_dir_archive_roundtrip_and_traversal_guard(tmp_path):
    a = LocalDirArchive(str(tmp_path / "arch"))
    bid = new_backup_id("full")
    a.write(bid, "data/i/f/standard/0.snap", b"hello")
    assert a.read(bid, "data/i/f/standard/0.snap") == b"hello"
    assert a.list_backups() == []  # no manifest yet = incomplete
    a.write_manifest(bid, {"id": bid, "files": []})
    assert a.list_backups() == [bid]
    for bad in ("../escape", "../../etc/passwd"):
        with pytest.raises(BackupError):
            a.write(bid, bad, b"x")


# -- keyed archives ----------------------------------------------------------

KEYED_QUERIES = ['Row(kf="red")', 'Count(Row(kf="blue"))', "TopN(kf)", "Rows(kf)",
                 'Count(Union(Row(kf="red"), Row(kf="green")))']


def _seed_keyed(side: Side, seed: int = 0) -> None:
    """A keyed index ``k`` with a keyed set field ``kf``: column and row
    keys allocated through the translate stores, bits over 2 shards."""
    rng = np.random.default_rng(seed)
    iopts = JIndexOptions if side.pkg == "jax" else IndexOptions
    idx = side.h.create_index("k", iopts(keys=True))
    f = idx.create_field("kf", side.opts(keys=True))
    names = ["red", "green", "blue", "cyan"]
    rows = f.translate_store.translate_keys(names)
    cols = idx.translate_store.translate_keys([f"c{i}" for i in range(300)])
    pick = rng.integers(0, len(names), 600)
    at = rng.integers(0, len(cols), 600)
    f.import_bits([rows[i] for i in pick], [cols[i] + SHARD_WIDTH * (i % 2) for i in at])


def _keyed_state(side: Side) -> tuple:
    idx = side.h.index("k")
    ex = side.ex_cls(side.h)
    return (idx.translate_store.entries_since(0),
            idx.field("kf").translate_store.entries_since(0),
            [side.to_json(ex.execute("k", q)[0]) for q in KEYED_QUERIES])


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_keyed_archive_crosses_packages(tmp_path, src, dst):
    """A keyed index's archive (its translate.jsonl files beside the
    fragments) restores through the other package's RestoreJob with equal
    translate entries, rows and keyed answers; both writers archive the
    same files from the same data."""
    sides = {pkg: Side(pkg, str(tmp_path / f"{pkg}-src")) for pkg in ("jax", "port")}
    for s in sides.values():
        _seed_keyed(s)
    manifests = {pkg: s.backup(str(tmp_path / f"arch-{pkg}")) for pkg, s in sides.items()}
    files = {pkg: sorted((e["path"], e["kind"], e["size"], e["crc"]) for e in m["files"])
             for pkg, m in manifests.items()}
    assert files["port"] == files["jax"]
    assert any(e["kind"] == "translate" for e in manifests[src]["files"])
    target = Side(dst, str(tmp_path / f"{dst}-dst"))
    target.restore(str(tmp_path / f"arch-{src}"), manifests[src]["id"])
    assert _rows(target.h) == _rows(sides[src].h)
    assert _keyed_state(target) == _keyed_state(sides[src])
    for s in (*sides.values(), target):
        s.store.close()


# -- what this slice does not carry ------------------------------------------


def test_keyed_manifest_and_cluster_paths_are_not_ported(tmp_path):
    """A manifest with key translation answered NotPortedError until the
    keys-and-sketches slice; now the port restores it (here: the port's
    own keyed archive into a fresh port holder, and into a JAX holder, with
    equal translate entries and answers). A writer, job or scheduler given
    a cluster still answers NotPortedError."""
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    _seed_keyed(side)
    root = str(tmp_path / "arch")
    m = side.backup(root)
    a = LocalDirArchive(root)
    for pkg in ("port", "jax"):
        other = Side(pkg, str(tmp_path / f"t-{pkg}"))
        other.restore(root, m["id"])
        assert _keyed_state(other) == _keyed_state(side)
        other.store.close()
    side.store.close()
    target = Side("port", str(tmp_path / "t"))
    for make in (lambda: BackupWriter(target.h, object(), None, target.store, a),
                 lambda: RestoreJob(target.h, object(), None, a, m["id"]),
                 lambda: BackupScheduler(holder=target.h, cluster=object(), client=None,
                                         store=target.store, archive=a, interval=1.0)):
        with pytest.raises(NotPortedError, match="cluster and operations"):
            make()
    target.store.close()


# -- scheduler and retention (single-node fixtures of test_backup_scheduler) --


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _sched(side, archive, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("rng", random.Random(1))
    return BackupScheduler(holder=side.h, cluster=None, client=None, store=side.store,
                           archive=archive, interval=kw.pop("interval", 10.0), **kw)


def test_scheduler_cadence_backoff_and_status(tmp_path):
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    fa = FaultyArchive(LocalDirArchive(str(tmp_path / "arch")), seed=3)
    clk, stats = FakeClock(), MemoryStats()
    sched = _sched(side, fa, clock=clk, stats=stats, rng=random.Random(5))
    f = side.h.field("i", "f")
    assert sched.tick() == SKIP_NOT_DUE
    clk.advance(10.0)
    assert sched.tick() == RAN and sched.last_manifest["kind"] == "full"
    clk.advance(10.0)
    assert sched.tick() == SKIP_UNCHANGED
    f.set_bit(2, 5)
    fa.fail_next_ops = 1
    clk.advance(10.0)
    assert sched.tick() == FAILED and sched.consecutive_failures == 1
    assert "injected archive fault" in sched.last_error
    assert 0.0 < sched._backoff_until - clk.t <= 12.5
    clk.advance(13.0)
    assert sched.tick() == RAN and sched.last_manifest["kind"] == "incremental"
    assert (sched.runs, sched.skipped, sched.failed) == (2, 1, 1)
    assert stats.counter_value("backup.scheduler.runs") == 2
    st = sched.status()
    assert st["fenced"] is False and st["lastBackupId"] == sched.last_manifest["id"]
    json.dumps(st)

    sched.run_once = lambda **kw: (_ for _ in ()).throw(RuntimeError("survive this"))
    clk.advance(100.0)
    assert sched.tick() == FAILED and "survive" in sched.last_error
    side.store.close()


def test_scheduler_rollover_prune_and_adopt(tmp_path):
    """full_every=2 and keep_chains=1: the third run opens a new chain and
    prunes the old one whole, as the JAX planner of the prune decides; a
    restarted scheduler adopts the latest backup."""
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    archive = LocalDirArchive(str(tmp_path / "arch"))
    f = side.h.field("i", "f")
    sched = _sched(side, archive, full_every=2, keep_chains=1)
    assert sched.run_once(force=True) == RAN
    first = sched.last_manifest["id"]
    f.set_bit(3, 7)
    assert sched.run_once(force=True) == RAN
    f.set_bit(4, 8)
    assert j_plan_prune(JLocalDirArchive(archive.root), 1)["victims"] == []
    assert sched.run_once(force=True) == RAN
    assert sched.last_manifest["kind"] == "full" and sched.last_prune["pruned"] == 2
    assert archive.list_backups() == [sched.last_manifest["id"]] and first not in \
        archive.list_backups()
    again = _sched(side, archive)
    assert again.run_once(force=True) == SKIP_UNCHANGED
    f.set_bit(1, 9)
    assert again.run_once(force=True) == RAN
    assert again.last_manifest["parent"] == sched.last_manifest["id"]
    side.store.close()


def _synthetic_archive(tmp_path, rng: random.Random, n_chains: int):
    """Random full+incremental chains whose incrementals reference ancestor
    payloads via ``stored_in`` (tests/test_objstore.py's shapes)."""
    arch = LocalDirArchive(str(tmp_path / "arch"))
    created = 1_000.0
    for c in range(n_chains):
        parent, parent_files = None, {}
        for depth in range(1 + rng.randrange(3)):
            kind = "full" if parent is None else "incremental"
            bid = f"{2000 + c:04d}{depth}-{kind}-x{c}{depth}"
            files = [{"path": p, "kind": "snap", "crc": e["crc"], "stored_in": e["stored_in"]}
                     for p, e in parent_files.items() if rng.random() < 0.7]
            data = bytes([c, depth]) * 8
            path = f"data/i/f/standard/{depth}.snap"
            arch.write(bid, path, data)
            files.append({"path": path, "kind": "snap", "crc": file_crc(data)})
            created += 1.0
            arch.write_manifest(bid, {"format": 1, "id": bid, "parent": parent, "kind": kind,
                                      "created": created, "epochs": {}, "schema": {},
                                      "files": files})
            parent, parent_files = bid, resolve_files(arch.read_manifest(bid))
    return arch


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_retention_plans_like_jax_and_keeps_reachable(tmp_path, seed):
    rng = random.Random(seed)
    arch = _synthetic_archive(tmp_path, rng, n_chains=4)
    keep = 1 + rng.randrange(3)
    plan = plan_prune(arch, keep)
    assert plan == j_plan_prune(JLocalDirArchive(arch.root), keep)
    summary = prune_archive(arch, keep)
    assert summary["aborted"] is None
    for bid in arch.list_backups():
        preflight_restore(arch, arch.read_manifest(bid))
    assert set(plan["survivors"]) <= set(arch.list_backups())


# -- object store, against the port's FakeObjectServer ------------------------


@pytest.fixture
def objsrv():
    srv = FakeObjectServer(seed=7)
    yield srv
    srv.close()


def test_objstore_dispatch_retries_and_roundtrip(tmp_path, objsrv):
    assert parse_archive_url("http://h:9000/b/p/q") == ("http", "h", 9000, "b", "p/q/")
    with pytest.raises(BackupError):
        parse_archive_url("ftp://h/b")
    assert isinstance(open_archive(str(tmp_path / "a")), LocalDirArchive)
    objsrv.fail_rate = 0.2
    stats = MemoryStats()
    store = ObjectArchiveStore(objsrv.url(bucket="b"), stats=stats, attempts=8,
                               rng=random.Random(3))
    assert isinstance(open_archive(objsrv.url(bucket="b")), ArchiveStore)
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    m = BackupWriter(side.h, None, None, side.store, store).run()
    live = _rows(side.h)
    side.store.close()
    assert store.list_backups() == [m["id"]]
    assert verify_archive(store)["ok"]
    target = Side("port", str(tmp_path / "t"))
    RestoreJob(target.h, None, None, store, m["id"], store=target.store).run()
    assert _rows(target.h) == live
    target.store.close()
    assert stats.counter_value("archive.retries") > 0
    store.close()


# -- the HTTP routes and the CLI against the JAX node and CLI ------------------


def _nodes(tmp_path, data_dir: bool = True):
    jn = JServerNode(bind="127.0.0.1:0", ingest_transpose="off", scrub_interval=0,
                     data_dir=str(tmp_path / "jn") if data_dir else None)
    tn = ServerNode(bind="127.0.0.1:0", device="cpu",
                    data_dir=str(tmp_path / "tn") if data_dir else None)
    jn.open()
    tn.open()
    return jn, tn


def _load_over_http(c: Client) -> None:
    for path in ("/index/i", "/index/i/field/f"):
        assert c("POST", path)[0] == 200
    for q in ("Set(1, f=1)", f"Set({SHARD_WIDTH + 2}, f=1)", "Set(3, f=2)"):
        assert c("POST", "/index/i/query", q)[0] == 200


def _wait(c: Client, path: str) -> dict:
    for _ in range(600):
        st = json.loads(c("GET", path)[1])
        if st.get("state") in ("done", "failed", "idle"):
            return st
        time.sleep(0.05)
    raise AssertionError(f"{path} never finished")


def _strip(doc: dict) -> dict:
    """A job status without what differs between two runs: ids, times."""
    return {k: v for k, v in doc.items() if k not in ("id", "seconds")}


def test_backup_routes_match_the_jax_node(tmp_path):
    jn, tn = _nodes(tmp_path)
    jc, tc = Client(jn.port), Client(tn.port)
    try:
        for c in (jc, tc):
            _load_over_http(c)
        assert tc("GET", "/backup/status") == jc("GET", "/backup/status")
        assert tc("GET", "/restore/status") == jc("GET", "/restore/status")
        assert tc("GET", "/debug/backup") == jc("GET", "/debug/backup")
        assert tc("POST", "/backup", {}) == jc("POST", "/backup", {})
        assert tc("POST", "/restore", {"archive": str(tmp_path / "none")}) == \
            jc("POST", "/restore", {"archive": str(tmp_path / "none")})
        # the store's keys and one fragment's pair, byte for byte
        assert tc("GET", "/internal/backup/keys") == jc("GET", "/internal/backup/keys")
        frag = "/internal/backup/fragment?index=i&field=f&view=standard&shard=1"
        assert tc("GET", frag) == jc("GET", frag)
        missing = "/internal/backup/fragment?index=i&field=f&view=standard&shard=9"
        assert tc("GET", missing) == jc("GET", missing)
        # a full backup of each, then each node's archive into the other
        docs = {}
        for name, c in (("jax", jc), ("port", tc)):
            status, body = c("POST", "/backup", {"archive": str(tmp_path / f"a-{name}")})
            assert status == 200 and json.loads(body)["state"] == "started"
            docs[name] = _strip(_wait(c, "/backup/status"))
        assert docs["port"] == docs["jax"] and docs["port"]["state"] == "done"
        assert tc("POST", "/backup?parent=nope", {"archive": str(tmp_path / "a-port")}) == \
            jc("POST", "/backup?parent=nope", {"archive": str(tmp_path / "a-port")})
        force = "/restore?force=true"
        for c, src in ((tc, "jax"), (jc, "port")):
            assert c("POST", force, {"archive": str(tmp_path / f"a-{src}")})[0] == 200
        assert _strip(_wait(tc, "/restore/status")) == _strip(_wait(jc, "/restore/status"))
        for q in ("Count(Row(f=1))", "Row(f=1)", "Count(Row(f=2))"):
            assert tc("POST", "/index/i/query", q) == jc("POST", "/index/i/query", q)
    finally:
        jc.close()
        tc.close()
        jn.close()
        tn.close()


def test_backup_routes_without_a_data_dir_match(tmp_path):
    jn, tn = _nodes(tmp_path, data_dir=False)
    jc, tc = Client(jn.port), Client(tn.port)
    try:
        for method, path, body in (("POST", "/backup", {"archive": "x"}),
                                   ("POST", "/restore", {"archive": "x"}),
                                   ("GET", "/backup/status", None),
                                   ("GET", "/restore/status", None),
                                   ("GET", "/internal/backup/keys", None),
                                   ("GET", "/debug/backup", None)):
            assert tc(method, path, body) == jc(method, path, body), path
    finally:
        jc.close()
        tc.close()
        jn.close()
        tn.close()


def test_unattended_backups_debug_doc(tmp_path):
    """``backup_interval`` with ``archive_url`` runs the scheduler; its
    /debug/backup document carries the JAX node's keys."""
    tn = ServerNode(bind="127.0.0.1:0", device="cpu", data_dir=str(tmp_path / "d"),
                    backup_interval=0.2, archive_url=str(tmp_path / "arch"))
    jn = JServerNode(bind="127.0.0.1:0", ingest_transpose="off", scrub_interval=0,
                     data_dir=str(tmp_path / "jd"), backup_interval=0.2,
                     archive_url=str(tmp_path / "jarch"))
    tn.open()
    jn.open()
    tc, jc = Client(tn.port), Client(jn.port)
    try:
        for c in (tc, jc):
            _load_over_http(c)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            doc = json.loads(tc("GET", "/debug/backup")[1])
            if doc["runs"] >= 1:
                break
            time.sleep(0.1)
        jdoc = json.loads(jc("GET", "/debug/backup")[1])
        assert doc["enabled"] and doc["runs"] >= 1 and doc["lastStatus"] in (RAN,
                                                                           SKIP_UNCHANGED)
        assert sorted(doc) == sorted(jdoc) and doc["archive"] == str(tmp_path / "arch")
        assert verify_archive(str(tmp_path / "arch"))["ok"]
    finally:
        tc.close()
        jc.close()
        tn.close()
        jn.close()


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("how", ["clean", "wal_garbage", "missing_file"])
def test_backup_verify_and_check_archive_match_the_jax_cli(tmp_path, capsys, how):
    side = Side("port", str(tmp_path / "d"))
    _seed(side)
    root = str(tmp_path / "arch")
    side.backup(root)
    side.store.close()
    _damage(root, how)
    for argv in (["backup-verify", root], ["check", "--archive", root],
                 ["check", str(tmp_path / "d"), "--archive", root]):
        got, want = _run(t_cli.main, argv, capsys), _run(j_cli.main, argv, capsys)
        assert got == want
        assert got[0] == (0 if how == "clean" else 1)


def test_cli_backup_and_restore_against_nodes(tmp_path, capsys):
    """``backup`` then ``restore --force`` through each CLI against each
    package's node: the same exit codes and final status documents. A
    restore that would clobber a live index fails on the port's node with
    exit 1; the JAX node's job stays ``starting`` and its CLI polls on
    (ROADMAP.md Queue 3), so only the port runs that case."""
    jn, tn = _nodes(tmp_path)
    jc, tc = Client(jn.port), Client(tn.port)
    try:
        for c in (jc, tc):
            _load_over_http(c)
        outs = {}
        for name, main, node in (("jax", j_cli.main, jn), ("port", t_cli.main, tn)):
            root = str(tmp_path / f"cli-{name}")
            host = f"127.0.0.1:{node.port}"
            rc1, out1, _ = _run(main, ["backup", "--host", host, root], capsys)
            rc2, out2, _ = _run(main, ["restore", "--host", host, "--force", root], capsys)
            outs[name] = (rc1, _strip(json.loads(out1)), rc2, _strip(json.loads(out2)))
        assert outs["port"] == outs["jax"]
        assert outs["port"][0] == 0 and outs["port"][2] == 0
        rc, _, err = _run(t_cli.main, ["restore", "--host", f"127.0.0.1:{tn.port}",
                                       str(tmp_path / "cli-port")], capsys)
        assert rc == 1 and "clobber" in err
        assert json.loads(tc("GET", "/restore/status")[1])["state"] == "failed"
    finally:
        jc.close()
        tc.close()
        jn.close()
        tn.close()


def test_config_and_generate_config_match_the_jax_cli(tmp_path, capsys, monkeypatch):
    for k in list(os.environ):
        if k.startswith("PILOSA_TPU_"):
            monkeypatch.delenv(k)
    assert _run(t_cli.main, ["generate-config"], capsys) == \
        _run(j_cli.main, ["generate-config"], capsys)
    assert _run(t_cli.main, ["config"], capsys) == _run(j_cli.main, ["config"], capsys)
    cfg = tmp_path / "node.toml"
    cfg.write_text('backup-interval = 30.0\nringing = "x"\ningest-transpose = "on"\n')
    monkeypatch.setenv("PILOSA_TPU_RESULT_CACHE_MB", "8")
    got = _run(t_cli.main, ["config", "--config", str(cfg)], capsys)
    assert got == _run(j_cli.main, ["config", "--config", str(cfg)], capsys)
    doc = json.loads(got[1])
    assert (doc["backup_interval"], doc["ingest_transpose"], doc["result_cache_mb"]) == (
        30.0, "on", 8)


def test_server_takes_the_generated_config(tmp_path, capsys, monkeypatch):
    """A file written by ``generate-config`` (every key at its default,
    those of unported features too) configures the port's server."""
    from pilosa_tpu_torch.server import node as t_node_mod
    for k in list(os.environ):
        if k.startswith("PILOSA_TPU_"):
            monkeypatch.delenv(k)
    t_cli.main(["generate-config"])
    cfg = tmp_path / "node.toml"
    cfg.write_text(capsys.readouterr().out)
    seen = {}

    class Stop(Exception):
        pass

    def fake(**kw):
        seen.update(kw)
        raise Stop()

    monkeypatch.setattr(t_node_mod, "ServerNode", fake)
    with pytest.raises(Stop):
        t_cli.main(["server", "--device", "cpu", "--config", str(cfg)])
    assert (seen["backup_interval"], seen["archive_url"], seen["backup_full_every"],
            seen["backup_keep_chains"], seen["ingest_transpose"]) == (0.0, None, 8, 2, "auto")
    cfg.write_text(cfg.read_text().replace('peers = ""', 'peers = "127.0.0.1:1"'))
    with pytest.raises(SystemExit) as e:
        t_cli.main(["server", "--device", "cpu", "--config", str(cfg)])
    assert e.value.code == 2
    assert "cluster and operations" in capsys.readouterr().err
