"""Backup and restore across a cluster in the port, against the JAX package:
the cases of tests/test_backup.py's cluster scenarios on port
``LocalCluster``s with data dirs, each run on a JAX ``LocalCluster`` fed the
same writes and held to it and to a numpy oracle of the seeded bits:

- a full backup of a four-node cluster (replica 2) restored into a
  three-node one; an incremental backup restoring the exact live state;
  point-in-time recovery; capture failing over from a quarantined replica
  (and failing loudly with no healthy copy left); a restore under chaos
  that completes on the survivors or fails atomically; translation keys;
- the incremental fast path's dirty-shard exception;
- archives crossing packages both ways on clusters of different sizes;
- ``POST /backup`` and ``POST /restore`` on members of port ServerNode
  clusters;
- the scheduler's coordinator-only duty and handoff
  (tests/test_backup_scheduler.py) and the fence gates of the scheduler
  and the retention prune (tests/test_partition.py)."""

import json
import os
import socket
import time
import urllib.request

import pytest

from pilosa_tpu.backup import BackupWriter as JBackupWriter
from pilosa_tpu.backup import LocalDirArchive as JLocalDirArchive
from pilosa_tpu.backup import RestoreJob as JRestoreJob
from pilosa_tpu.backup import verify_archive as j_verify_archive
from pilosa_tpu.backup.retention import prune_archive as j_prune_archive
from pilosa_tpu.backup.scheduler import BackupScheduler as JBackupScheduler
from pilosa_tpu.cluster.harness import LocalCluster as JLocalCluster
from pilosa_tpu.core.index import IndexOptions as JIndexOptions
from pilosa_tpu.obs.stats import MemoryStats as JMemoryStats
from pilosa_tpu_torch.backup import (
    BackupError,
    BackupScheduler,
    BackupWriter,
    LocalDirArchive,
    RestoreJob,
    verify_archive,
)
from pilosa_tpu_torch.backup.retention import prune_archive
from pilosa_tpu_torch.backup.scheduler import RAN, SKIP_FENCED, SKIP_NOT_COORDINATOR
from pilosa_tpu_torch.cluster.harness import LocalCluster
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.obs.stats import MemoryStats
from pilosa_tpu_torch.server.node import ServerNode
from pilosa_tpu_torch.storage.faults import corrupt_file

N_ROWS = 7
STEP = 37_717  # ~80 bits over 3 shards

PKGS = {
    "jax": dict(cluster=lambda n, **kw: JLocalCluster(n, **kw), writer=JBackupWriter,
                job=JRestoreJob, archive=JLocalDirArchive, stats=JMemoryStats,
                scheduler=JBackupScheduler, index_options=JIndexOptions),
    "port": dict(cluster=lambda n, **kw: LocalCluster(n, device="cpu", **kw),
                 writer=BackupWriter, job=RestoreJob, archive=LocalDirArchive,
                 stats=MemoryStats, scheduler=BackupScheduler, index_options=IndexOptions),
}


def _cluster(pkg, n, tmp_path, tag, replica_n=1):
    dirs = [str(tmp_path / f"{pkg}-{tag}{i}") for i in range(n)]
    return PKGS[pkg]["cluster"](n, replica_n=replica_n, data_dirs=dirs), dirs


def _seed(lc, n_cols=3_000_000, step=STEP) -> dict:
    """tests/test_backup.py's seed; returns its numpy-free oracle: the
    columns of each row."""
    lc.create_index("i")
    lc.create_field("i", "f")
    want = {r: [] for r in range(N_ROWS)}
    for c in range(0, n_cols, step):
        lc.query("i", f"Set({c}, f={c % N_ROWS})")
        want[c % N_ROWS].append(c)
    return want


def _counts(lc, node: int = 0) -> dict:
    return {r: lc.query("i", f"Count(Row(f={r}))", node=node)[0] for r in range(N_ROWS)}


def _oracle_counts(want: dict) -> dict:
    return {r: len(set(cols)) for r, cols in want.items()}


def _close(*clusters):
    for lc in clusters:
        for cn in lc.nodes:
            if cn.store is not None:
                cn.store.close()


def _backup(pkg, lc, root, node=0, **kw):
    n = lc[node]
    return PKGS[pkg]["writer"](n.holder, n.cluster, lc.client, n.store,
                               PKGS[pkg]["archive"](root), **kw)


def _restore(pkg, lc, root, backup_id, node=0, **kw):
    n = lc[node]
    return PKGS[pkg]["job"](n.holder, n.cluster, lc.client, PKGS[pkg]["archive"](root),
                            backup_id, store=n.store, **kw)


def test_full_backup_restores_into_a_resized_cluster(tmp_path):
    """A four-node replica-2 cluster backed up from one member and restored
    into a fresh three-node one through another: every Count and the column
    attrs equal on every member, in both packages and against the oracle."""
    got = {}
    for pkg in PKGS:
        lc, _ = _cluster(pkg, 4, tmp_path, "a", replica_n=2)
        want = _seed(lc)
        lc.query("i", 'SetColumnAttrs(37717, city="x")')
        root = str(tmp_path / f"{pkg}-arch")
        stats = PKGS[pkg]["stats"]()
        w = _backup(pkg, lc, root, stats=stats)
        m = w.run()
        assert w.progress["state"] == "done"
        assert stats.counter_value("backup.runs") == 1
        assert m["cluster"] == {"nodes": 4, "replicaN": 2}
        assert verify_archive(root)["ok"] and j_verify_archive(root)["ok"]
        lc2, _ = _cluster(pkg, 3, tmp_path, "b", replica_n=2)
        out = _restore(pkg, lc2, root, m["id"], node=1).run()
        assert out["indexes"] == ["i"]
        got[pkg] = [_counts(lc2, node) for node in range(3)]
        assert all(c == _oracle_counts(want) for c in got[pkg])
        assert lc2[1].holder.index("i").column_attr_store.attrs(37717) == {"city": "x"}
        assert sorted(e["path"] for e in m["files"] if e["kind"] in ("snap", "wal"))
        got[pkg + "-files"] = sorted((e["path"], e["crc"]) for e in m["files"]
                                     if e["kind"] in ("snap", "wal"))
        _close(lc, lc2)
    assert got["port"] == got["jax"]
    assert got["port-files"] == got["jax-files"]


def test_incremental_backup_restores_the_exact_live_state(tmp_path):
    got = {}
    for pkg in PKGS:
        lc, _ = _cluster(pkg, 2, tmp_path, "a")
        want = _seed(lc, n_cols=2_000_000)
        root = str(tmp_path / f"{pkg}-arch")
        w = _backup(pkg, lc, root)
        full = w.run()
        for c in range(0, 2_000_000, 54_001):
            lc.query("i", f"Set({c}, f={c % N_ROWS})")
            want[c % N_ROWS].append(c)
        lc.query("i", "Set(1234567, f=0)")
        want[0].append(1234567)
        incr = w.run(parent=full["id"])
        assert incr["kind"] == "incremental" and incr["parent"] == full["id"]
        assert any(e.get("stored_in") == full["id"] for e in incr["files"])
        lc2, _ = _cluster(pkg, 3, tmp_path, "b")
        _restore(pkg, lc2, root, incr["id"]).run()
        got[pkg] = [_counts(lc2, node) for node in range(3)]
        assert got[pkg] == [_counts(lc)] * 3 == [_oracle_counts(want)] * 3
        _close(lc, lc2)
    assert got["port"] == got["jax"]


def test_incremental_recaptures_dirty_shards(tmp_path):
    """The incremental fast path references an unchanged index's files
    wholesale, except the shards the write fan-out marked dirty: those are
    captured again. Equal capture counts in both packages."""
    got = {}
    for pkg in PKGS:
        lc, _ = _cluster(pkg, 3, tmp_path, "a", replica_n=2)
        _seed(lc)
        for cn in lc.nodes:  # the writes' index-dirty messages land now
            cn.dirty.flush_now()
        root = str(tmp_path / f"{pkg}-arch")
        full = _backup(pkg, lc, root).run()
        quiet = PKGS[pkg]["stats"]()
        clean = _backup(pkg, lc, root, stats=quiet).run(parent=full["id"])
        lc[0].cluster.dirty_shards.mark("i", 1)
        marked = PKGS[pkg]["stats"]()
        dirty = _backup(pkg, lc, root, stats=marked).run(parent=clean["id"])
        got[pkg] = (quiet.counter_value("backup.fragments"),
                    marked.counter_value("backup.fragments"),
                    sorted(e["path"] for e in dirty["files"] if "source" in e
                           and e.get("stored_in") is None))
        assert got[pkg][0] == 0 and got[pkg][1] >= 1
        _close(lc)
    assert got["port"][:2] == got["jax"][:2]


def test_pitr_restores_historical_counts(tmp_path):
    got = {}
    for pkg in PKGS:
        lc, _ = _cluster(pkg, 1, tmp_path, "n")
        lc.create_index("i")
        lc.create_field("i", "f")
        historical = None
        for k in range(20):
            lc.query("i", f"Set({k}, f=1)")
            if k + 1 == 10:
                historical = lc.query("i", "Count(Row(f=1))")[0]
        assert (historical, lc.query("i", "Count(Row(f=1))")[0]) == (10, 20)
        root = str(tmp_path / f"{pkg}-arch")
        m = _backup(pkg, lc, root).run()
        assert sum(e.get("ops", 0) for e in m["files"]
                   if e["kind"] == "wal" and e["field"] == "f") == 20
        out = []
        for tag, pitr in (("p", 10), ("q", None)):
            lc2, _ = _cluster(pkg, 1, tmp_path, tag)
            _restore(pkg, lc2, root, m["id"], pitr_ops=pitr).run()
            out.append(lc2.query("i", "Count(Row(f=1))")[0])
            _close(lc2)
        got[pkg] = out
        assert out == [10, 20]
        _close(lc)
    assert got["port"] == got["jax"]


def test_backup_fails_over_a_quarantined_replica(tmp_path):
    """A corrupt copy on the node running the backup never reaches the archive: capture
    fails over to the clean replica; with no healthy copy left the whole
    backup fails."""
    for pkg in PKGS:
        lc, dirs = _cluster(pkg, 2, tmp_path, "n", replica_n=2)
        want = _seed(lc, n_cols=100_000, step=7_001)
        for cn in lc.nodes:
            cn.store.save_schema()
            cn.store.close()
        snap = os.path.join(dirs[0], "i", "f", "standard", "0.snap")
        assert os.path.exists(snap)
        corrupt_file(snap, "bitflip")
        lc = PKGS[pkg]["cluster"](2, replica_n=2, data_dirs=dirs)
        stats = PKGS[pkg]["stats"]()
        root = str(tmp_path / f"{pkg}-arch")
        m = _backup(pkg, lc, root, stats=stats).run()
        assert stats.counter_value("backup.skippedQuarantined") >= 1
        assert verify_archive(root)["ok"]
        sources = {e["source"] for e in m["files"]
                   if e.get("field") == "f" and e.get("shard") == 0}
        assert sources == {"node1"}
        lc2, _ = _cluster(pkg, 1, tmp_path, "r")
        _restore(pkg, lc2, root, m["id"]).run()
        assert _counts(lc2) == _oracle_counts(want)
        _close(lc, lc2)
        for cn in lc.nodes:
            cn.store.close()
        corrupt_file(os.path.join(dirs[1], "i", "f", "standard", "0.snap"), "bitflip")
        lc = PKGS[pkg]["cluster"](2, replica_n=2, data_dirs=dirs)
        w = _backup(pkg, lc, str(tmp_path / f"{pkg}-arch2"))
        with pytest.raises(Exception, match="no healthy copy"):
            w.run()
        assert w.progress["state"] == "failed"
        _close(lc)


def test_restore_under_chaos_survivors_or_atomic_failure(tmp_path):
    """A node killed mid-restore: with replica 2 the restore completes on
    the survivors; with replica 1 it fails and no member keeps the index."""
    for pkg in PKGS:
        lc, _ = _cluster(pkg, 3, tmp_path, "a", replica_n=2)
        want = _seed(lc)
        root = str(tmp_path / f"{pkg}-arch")
        m = _backup(pkg, lc, root).run()

        lc2, _ = _cluster(pkg, 3, tmp_path, "b", replica_n=2)
        killed = []

        def kill_once(key, lc2=lc2, killed=killed):
            if not killed:
                killed.append(key)
                lc2.down("node2")

        out = _restore(pkg, lc2, root, m["id"], on_fragment=kill_once).run()
        assert killed and out["indexes"] == ["i"]
        assert _counts(lc2) == _oracle_counts(want)

        lc3, dirs3 = _cluster(pkg, 3, tmp_path, "c")
        runner = lc3[0]
        victim = next(o for o in (runner.cluster.shard_nodes("i", s)[0].id for s in range(3))
                      if o != runner.id)
        killed3 = []

        def kill_victim(key, lc3=lc3, killed3=killed3, victim=victim):
            if not killed3:
                killed3.append(key)
                lc3.down(victim)

        with pytest.raises(Exception, match="no live owner"):
            _restore(pkg, lc3, root, m["id"], on_fragment=kill_victim).run()
        for cn in lc3.nodes:
            if cn.id != victim:
                assert cn.holder.index("i") is None
        assert not os.path.exists(os.path.join(dirs3[0], "i"))
        _close(lc, lc2)
        for cn in lc3.nodes:
            if cn.id != victim:
                cn.store.close()


def test_translation_keys_roundtrip_through_backup(tmp_path):
    got = {}
    for pkg in PKGS:
        lc, _ = _cluster(pkg, 1, tmp_path, "n")
        lc.create_index("k", PKGS[pkg]["index_options"](keys=True))
        lc.create_field("k", "f")
        for name in ("alice", "bob", "carol"):
            lc.query("k", f'Set("{name}", f=1)')
        root = str(tmp_path / f"{pkg}-arch")
        m = _backup(pkg, lc, root).run()
        assert any(e["kind"] == "translate" for e in m["files"])
        lc2, _ = _cluster(pkg, 1, tmp_path, "r")
        _restore(pkg, lc2, root, m["id"]).run()
        lc2.query("k", 'Set("alice", f=2)')
        got[pkg] = [lc2.query("k", q)[0] for q in
                    ("Count(Row(f=1))", "Count(Union(Row(f=1), Row(f=2)))")]
        assert got[pkg] == [3, 3]
        _close(lc, lc2)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_archives_cross_packages_between_clusters(tmp_path, src, dst):
    """A three-node replica-2 cluster's archive written by one package
    restores into the other package's two-node cluster, and a full plus
    incremental chain alike: every member answers the source's counts."""
    lc, _ = _cluster(src, 3, tmp_path, "s", replica_n=2)
    want = _seed(lc)
    at_full = _oracle_counts(want)
    root = str(tmp_path / "arch")
    w = _backup(src, lc, root)
    full = w.run()
    lc.query("i", "Set(2345678, f=3) Clear(0, f=0)")
    want[3].append(2345678)
    want[0].remove(0)
    incr = w.run(parent=full["id"])
    assert _counts(lc) == _oracle_counts(want) != at_full
    for tag, m, counts in (("f", full, at_full), ("i", incr, _oracle_counts(want))):
        lc2, _ = _cluster(dst, 2, tmp_path, f"d{tag}", replica_n=1)
        _restore(dst, lc2, root, m["id"], node=1).run()
        assert [_counts(lc2, node) for node in range(2)] == [counts] * 2
        _close(lc2)
    _close(lc)


# -- the operator surface over HTTP --------------------------------------------

def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _req(base, method, path, body=None):
    data = body if isinstance(body, bytes) else (
        json.dumps(body).encode() if body is not None else None)
    r = urllib.request.Request(base + path, data=data, method=method)
    with urllib.request.urlopen(r, timeout=30) as resp:
        return json.loads(resp.read() or b"{}")


def _wait(base, path):
    deadline = time.time() + 60
    while time.time() < deadline:
        st = _req(base, "GET", path)
        if st.get("state") in ("done", "failed"):
            return st
        time.sleep(0.05)
    raise AssertionError(f"job at {path} never finished")


def _server_cluster(tmp_path, tag, n, replica_n):
    addrs = sorted(f"127.0.0.1:{p}" for p in _free_ports(n))
    nodes = [ServerNode(bind=a, peers=[x for x in addrs if x != a], replica_n=replica_n,
                        device="cpu", data_dir=str(tmp_path / f"{tag}{i}"),
                        anti_entropy_interval=0.0, check_nodes_interval=0.0,
                        scrub_interval=0.0)
             for i, a in enumerate(addrs)]
    for node in nodes:
        node.open()
    return nodes


def test_http_backup_and_restore_on_a_cluster(tmp_path):
    """POST /backup on one member of a two-node replica-2 cluster captures
    the whole ring, then an incremental through the other member after
    acknowledged writes;
    POST /restore on a member of a fresh three-node cluster restores the
    chain; every member answers the oracle, and the archive also restores
    into a JAX cluster with the same counts."""
    arch = str(tmp_path / "arch")
    src = _server_cluster(tmp_path, "s", 2, 2)
    want = {r: set() for r in range(3)}
    try:
        base = src[0].address
        _req(base, "POST", "/index/i", {})
        _req(base, "POST", "/index/i/field/f", {})
        for c in range(0, 6 * SHARD_WIDTH, 99_991):
            _req(base, "POST", "/index/i/query", f"Set({c}, f={c % 3})".encode())
            want[c % 3].add(c)
        assert _req(src[1].address, "POST", "/backup", {"archive": arch})["state"] == "started"
        full = _wait(src[1].address, "/backup/status")
        assert full["state"] == "done", full
        _req(base, "POST", "/index/i/query", b"Set(7, f=2) Clear(0, f=0)")
        want[2].add(7)
        want[0].discard(0)
        _req(src[0].address, "POST", "/backup", {"archive": arch, "parent": full["id"]})
        incr = _wait(src[0].address, "/backup/status")
        assert incr["state"] == "done", incr
    finally:
        for node in src:
            node.close()
    assert verify_archive(arch)["ok"]
    dst = _server_cluster(tmp_path, "d", 3, 1)
    try:
        _req(dst[2].address, "POST", "/restore", {"archive": arch, "id": incr["id"]})
        st = _wait(dst[2].address, "/restore/status")
        assert st["state"] == "done", st
        for node in dst:
            for r in range(3):
                assert _req(node.address, "POST", "/index/i/query",
                            f"Count(Row(f={r}))".encode()) == {"results": [len(want[r])]}
            assert _req(node.address, "POST", "/index/i/query", b"Row(f=2)") == \
                {"results": [{"attrs": {}, "columns": sorted(want[2])}]}
    finally:
        for node in dst:
            node.close()
    lc, _ = _cluster("jax", 2, tmp_path, "j")
    _restore("jax", lc, arch, incr["id"]).run()
    assert {r: lc.query("i", f"Count(Row(f={r}))")[0] for r in range(3)} == \
        {r: len(want[r]) for r in range(3)}
    _close(lc)


# -- the coordinator's duty and the fence gates -----------------------------------

@pytest.mark.parametrize("pkg", list(PKGS))
def test_coordinator_handoff_adopts_chain(tmp_path, pkg):
    """Only the coordinator captures; after a handoff the new coordinator
    adopts the old one's last backup as its incremental parent."""
    lc, _ = _cluster(pkg, 2, tmp_path, "n")
    _seed(lc, n_cols=100_000, step=7_001)
    archive = PKGS[pkg]["archive"](str(tmp_path / "arch"))

    def sched(node):
        n = lc[node]
        return PKGS[pkg]["scheduler"](holder=n.holder, cluster=n.cluster, client=lc.client,
                                      store=n.store, archive=archive, interval=3600.0,
                                      node_id=f"node{node}", stats=PKGS[pkg]["stats"](),
                                      rng=__import__("random").Random(0))

    s0, s1 = sched(0), sched(1)
    assert s1.run_once(force=True) == SKIP_NOT_COORDINATOR
    assert s0.run_once(force=True) == RAN
    first = s0.last_manifest["id"]
    for cn in lc.nodes:
        for m in cn.cluster.nodes:
            m.is_coordinator = (m.id == "node1")
    lc.query("i", "Set(11, f=0)")
    assert s0.run_once(force=True) == SKIP_NOT_COORDINATOR
    assert s1.run_once(force=True) == RAN
    assert s1.last_manifest["kind"] == "incremental"
    assert s1.last_manifest["parent"] == first
    _close(lc)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_backup_scheduler_fence_suspends_capture_single_ticker(pkg):
    lc = PKGS[pkg]["cluster"](3, replica_n=2)
    stats = PKGS[pkg]["stats"]()
    coord = PKGS[pkg]["scheduler"](holder=lc[0].holder, cluster=lc[0].cluster,
                                   client=lc[0].cluster.client, store=None, archive=None,
                                   interval=3600.0, node_id="node0", stats=stats)
    lc[0].cluster.fenced = True
    assert coord.run_once(force=True) == SKIP_FENCED
    assert stats.counter_value("backup.scheduler.skippedFenced") == 1
    assert coord.last_status == SKIP_FENCED and coord.status()["fenced"] is True
    peer = PKGS[pkg]["scheduler"](holder=lc[2].holder, cluster=lc[2].cluster,
                                  client=lc[2].cluster.client, store=None, archive=None,
                                  interval=3600.0, node_id="node2",
                                  stats=PKGS[pkg]["stats"]())
    assert peer.run_once(force=True) == SKIP_NOT_COORDINATOR


@pytest.mark.parametrize("prune,stats_cls", [(j_prune_archive, JMemoryStats),
                                             (prune_archive, MemoryStats)],
                         ids=["jax", "port"])
def test_retention_prune_fence_gate_deletes_nothing(prune, stats_cls):
    stats = stats_cls()
    summary = prune(None, 1, stats=stats, fence=lambda: True)
    assert summary["aborted"] == "fenced"
    assert summary["pruned"] == 0 and summary["victims"] == []
    assert stats.counter_value("backup.retention.fenced") == 1


def test_no_live_owner_is_a_backup_error(tmp_path):
    """Every owner of a shard down: the port's restore raises BackupError
    naming the fragment, as the JAX job does."""
    lc, _ = _cluster("port", 2, tmp_path, "a")
    _seed(lc)
    root = str(tmp_path / "arch")
    m = _backup("port", lc, root).run()
    lc2, _ = _cluster("port", 2, tmp_path, "b")
    lc2.down("node1")
    with pytest.raises(BackupError, match="no live owner reachable for i/"):
        _restore("port", lc2, root, m["id"]).run()
    _close(lc)
    lc2[0].store.close()
