"""The port's elastic cluster (pilosa_tpu_torch/cluster/resize.py,
migration.py, cleaner.py, the harness's ``add_node``/``remove_node``, and
``ServerNode``'s join, remove-node and ``topology.json``) against the JAX
package's: ``fragment_sources`` on the same old and new rings, the
``MigrationTable`` snapshot and dual-write targets, the ``topology.json``
document, the PTS1 import stream's reply and WAL bytes against a JAX
node's, and query bodies after a grow and a shrink on a port
``LocalCluster`` (its planner on) held to a JAX ``LocalCluster`` (per
shard) fed the same writes and to a single port node. Then the JAX
package's resize drills (tests/test_resize.py) on the port, exact
everywhere, and one join and one remove-node over HTTP."""

import dataclasses
import json
import os
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cluster import Cluster as JCluster
from pilosa_tpu.cluster import Node as JNode
from pilosa_tpu.cluster.harness import LocalCluster as JLocalCluster
from pilosa_tpu.cluster.migration import MigrationTable as JMigrationTable
from pilosa_tpu.cluster.node import URI as JURI
from pilosa_tpu.cluster.resize import fragment_sources as j_fragment_sources
from pilosa_tpu.exec.result import result_to_json as j_json
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu_torch.cluster import Cluster, Node
from pilosa_tpu_torch.cluster.cleaner import clean_holder
from pilosa_tpu_torch.cluster.client import LocalClient
from pilosa_tpu_torch.cluster.cluster import STATE_NORMAL, STATE_RESIZING, STATE_STARTING
from pilosa_tpu_torch.cluster.harness import ClusterNode, LocalCluster
from pilosa_tpu_torch.cluster.migration import MigrationTable
from pilosa_tpu_torch.cluster.node import URI
from pilosa_tpu_torch.cluster.resize import ResizeJob, apply_cluster_status, fragment_sources
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.obs.stats import MemoryStats
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.server import wire
from pilosa_tpu_torch.server.node import ServerNode

SEED = 41
N_SHARDS = 10


def _planner(i):
    return lambda h: Planner(h)


# -- pure placement and tables against the JAX package ------------------------

def _rings(n_old: int, n_new: int, replica_n: int):
    """((JAX old, JAX new), (port old, port new)) rings of the same
    members: a grow adds members, a shrink drops the first ones."""
    names = [f"n{i}" for i in range(max(n_old, n_new))]
    old = names[:n_old]
    new = names[:n_new] if n_new >= n_old else names[n_old - n_new:n_old]
    out = []
    for cls, node, uri in ((JCluster, JNode, JURI), (Cluster, Node, URI)):
        def ring(ids):
            return [node(id=x, uri=uri(host="h", port=10100 + int(x[1:]))) for x in ids]
        out.append((cls("a", ring(old), replica_n=replica_n),
                    cls("a", ring(new), replica_n=replica_n)))
    return out


@pytest.mark.parametrize("n_old,n_new,replica_n", [
    (2, 3, 1), (3, 4, 2), (4, 3, 2), (3, 5, 3), (5, 4, 3), (1, 2, 1)])
def test_fragment_sources_match_jax(n_old, n_new, replica_n):
    (jo, jn), (to, tn) = _rings(n_old, n_new, replica_n)
    frags = [(i, f, v, s) for i in ("i", "bench") for f in ("f", "g")
             for v in ("standard",) for s in range(40)]
    want = j_fragment_sources(jo, jn, frags)
    got = fragment_sources(to, tn, frags)
    assert {k: [dataclasses.asdict(s) for s in v] for k, v in got.items()} == \
        {k: [dataclasses.asdict(s) for s in v] for k, v in want.items()}
    assert got  # the ring change moves something


def test_fragment_sources_no_surviving_replica_raises_like_jax():
    (jo, jn), (to, tn) = _rings(2, 1, 1)
    frags = [("i", "f", "standard", s) for s in range(8)]
    with pytest.raises(ValueError) as want:
        j_fragment_sources(jo, jn, frags)
    with pytest.raises(ValueError) as got:
        fragment_sources(to, tn, frags)
    assert str(got.value) == str(want.value)


def test_migration_table_matches_jax():
    (jo, _), (to, _) = _rings(3, 4, 2)
    msg = {"type": "resize-begin", "job": "resize-7",
           "coordinator": {"id": "n0", "uri": {"scheme": "http", "host": "h", "port": 10100}},
           "nodes": [{"id": f"n{i}", "uri": {"scheme": "http", "host": "h", "port": 10100 + i}}
                     for i in range(4)],
           "replicaN": 2, "partitionN": 256}
    jt, tt = JMigrationTable.from_message(jo, msg), MigrationTable.from_message(to, msg)
    for s in range(60):
        assert [n.id for n in tt.dual_targets(to, "i", s)] == \
            [n.id for n in jt.dual_targets(jo, "i", s)]
    for s in (3, 1, 300):
        jt.mark_cutover("i", s)
        tt.mark_cutover("i", s)
    assert tt.snapshot() == jt.snapshot()
    assert tt.is_cutover("i", 300) and not tt.is_cutover("i", 2)


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


_QUIET = dict(anti_entropy_interval=0.0, check_nodes_interval=0.0, scrub_interval=0.0)


def test_topology_json_matches_jax(tmp_path):
    """The same committed ring on the same address writes the same
    ``topology.json``; each package's node boots from the other's."""
    a, b = (f"127.0.0.1:{p}" for p in _free_ports(2))
    docs = {}
    for pkg, make in (("jax", lambda d: JServerNode(bind=a, peers=[b], data_dir=d,
                                                     use_planner=False, **_QUIET)),
                      ("port", lambda d: ServerNode(bind=a, peers=[b], data_dir=d,
                                                    device="cpu", **_QUIET))):
        d = str(tmp_path / pkg)
        n = make(d)
        n.open()
        try:
            n.cluster.topology_version = 4
            n.cluster.replica_n = 2
            for m in n.cluster.nodes:
                m.is_coordinator = m.id == b
            n.cluster.notify_topology()
        finally:
            n.close()
        docs[pkg] = open(os.path.join(d, "topology.json")).read()
    assert json.loads(docs["port"]) == json.loads(docs["jax"])
    # Each resumes from the other's file.
    for pkg, make in (("port", lambda d: ServerNode(bind=a, peers=[b], data_dir=d,
                                                    device="cpu", **_QUIET)),
                      ("jax", lambda d: JServerNode(bind=a, peers=[b], data_dir=d,
                                                    use_planner=False, **_QUIET))):
        d = str(tmp_path / ("jax" if pkg == "port" else "port"))
        n = make(d)
        try:
            assert n.cluster.topology_version == 4 and n.cluster.replica_n == 2
            assert n.cluster.coordinator().id == b
        finally:
            n.close()


# -- the PTS1 import stream against a JAX node --------------------------------

def _stream_body(reqs) -> bytes:
    return b"".join([wire.stream_preamble()] + [wire.stream_chunk(r) for r in reqs]
                    + [wire.stream_end()])


def _post(port: int, path: str, body: bytes, headers=None):
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST",
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _wal_files(root: str) -> dict:
    out = {}
    for r, _, fs in os.walk(root):
        for fn in fs:
            if fn.endswith(".wal"):
                p = os.path.join(r, fn)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_import_stream_reply_and_wal_match_jax(tmp_path):
    rng = np.random.default_rng(SEED)
    reqs = []
    for shard in range(3):
        cols = shard * SHARD_WIDTH + rng.integers(0, SHARD_WIDTH, 500)
        reqs.append({"kind": "field", "index": "i", "field": "f", "shard": shard,
                     "rowIDs": rng.integers(0, 4, 500), "columnIDs": cols,
                     "values": None, "clear": False})
    reqs.append({"kind": "fragment", "index": "i", "field": "f", "view": "standard",
                 "shard": 4, "rowIDs": np.full(40, 2), "columnIDs":
                 4 * SHARD_WIDTH + np.arange(40) * 7})
    reqs.append({"kind": "field", "index": "i", "field": "f", "shard": 0,
                 "rowIDs": reqs[0]["rowIDs"][:100], "columnIDs": reqs[0]["columnIDs"][:100],
                 "values": None, "clear": True})
    bad = reqs[:2] + [{"kind": "field", "index": "nope", "field": "f", "shard": 0,
                       "rowIDs": [1], "columnIDs": [1], "values": None, "clear": False}]
    jn = JServerNode(bind="127.0.0.1:0", data_dir=str(tmp_path / "jax"), use_planner=False,
                     ingest_transpose="off", **_QUIET)
    tn = ServerNode(bind="127.0.0.1:0", data_dir=str(tmp_path / "port"), device="cpu",
                    **_QUIET)
    replies = {}
    try:
        for pkg, n in (("jax", jn), ("port", tn)):
            n.open()
            _post(n.port, "/index/i", b"{}")
            _post(n.port, "/index/i/field/f", b"{}")
            hdr = {"Content-Type": wire.STREAM_CONTENT_TYPE}
            got = [_post(n.port, "/internal/import-stream", _stream_body(reqs), hdr)]
            got.append(_post(n.port, "/internal/import-stream", _stream_body(bad), hdr))
            got.append(_post(n.port, "/internal/import-stream", b"XXXX", hdr))
            # Backpressure: a chunk held in flight trips the byte budget.
            n.ingest_gate.max_inflight_bytes = 1
            with n.ingest_gate.admit(1):
                got.append(_post(n.port, "/internal/import-stream", _stream_body(reqs), hdr))
            n.ingest_gate.max_inflight_bytes = 0
            got.append(_post(n.port, "/index/i/query", b"Count(Row(f=1)) Count(Row(f=2))"))
            replies[pkg] = [(s, json.loads(b), h.get("Retry-After")) for s, b, h in got]
        assert replies["port"] == replies["jax"]
        assert [r[0] for r in replies["port"]] == [200, 404, 400, 429, 200]
        assert replies["port"][0][1] == {"applied": len(reqs)}
        assert replies["port"][1][1]["applied"] == 2
        assert replies["port"][3][1]["applied"] == 0 and replies["port"][3][2] == "1"
        wals = {pkg: _wal_files(str(tmp_path / pkg)) for pkg in ("jax", "port")}
        assert wals["port"] == wals["jax"]
        assert sum(len(b) > 0 for b in wals["port"].values()) >= 4
    finally:
        jn.close()
        tn.close()


# -- query bodies after a grow and a shrink, against the JAX cluster ----------

QUERIES = ["Count(Row(f=1))", "Row(f=2)", "Count(Intersect(Row(f=1), Row(g=0)))",
           "TopN(f, n=3)", "Count(Union(Row(f=0), Row(g=1)))",
           "Row(g=1)", "Count(Difference(Row(f=3), Row(g=2)))"]


def _bits(seed: int):
    rng = np.random.default_rng(seed)
    total = N_SHARDS * SHARD_WIDTH
    return {f: (rng.integers(0, 5, 4000), rng.integers(0, total, 4000)) for f in ("f", "g")}


def _load(lc, bits) -> None:
    """Each shard's batch straight into each owner (a routed import)."""
    for f, (rows, cols) in bits.items():
        shards = cols // SHARD_WIDTH
        for s in np.unique(shards):
            sel = shards == s
            for owner in lc[0].cluster.shard_nodes("i", int(s)):
                lc.client.peers[owner.id].handle_import_request(
                    "i", f, rows=rows[sel].tolist(), cols=cols[sel].tolist())


def _schema(lc):
    lc.create_index("i")
    for f in ("f", "g"):
        lc.create_field("i", f)


def _bodies(lc, node: int, jax: bool) -> list:
    to_json = j_json if jax else result_to_json
    return [to_json(lc.query("i", q, node=node, cache=False)) for q in QUERIES]


def test_grow_and_shrink_bodies_match_jax_and_a_single_node():
    bits = _bits(SEED)
    jl = JLocalCluster(3, replica_n=2)
    tl = LocalCluster(3, replica_n=2, device="cpu", planner_factory=_planner)
    h = Holder(device="cpu")
    single = Executor(h, planner=Planner(h))
    idx = h.create_index("i")
    for f, (rows, cols) in bits.items():
        idx.create_field(f).import_bits(rows.tolist(), cols.tolist())
    for lc in (jl, tl):
        _schema(lc)
        _load(lc, bits)
    want = [result_to_json(single.execute("i", q, cache=False)) for q in QUERIES]
    writes = "Set(5, f=1) Clear({}, f=1) Set({}, g=0)".format(
        int(bits["f"][1][bits["f"][0] == 1][0]), 3 * SHARD_WIDTH + 9)
    steps = [("grow", lambda lc: lc.add_node()),
             ("write", lambda lc: lc.query("i", writes, node=1)),
             ("shrink", lambda lc: lc.remove_node("node0", coordinator=1)),
             ("grow again", lambda lc: lc.add_node(coordinator=0))]
    for name, step in steps:
        for lc in (jl, tl):
            step(lc)
        if name == "write":
            single.execute("i", writes)
            want = [result_to_json(single.execute("i", q, cache=False)) for q in QUERIES]
        assert [n.id for n in tl[0].cluster.nodes] == [n.id for n in jl[0].cluster.nodes]
        assert tl[0].cluster.topology_version == jl[0].cluster.topology_version
        for node in range(len(tl.nodes)):
            got = _bodies(tl, node, jax=False)
            assert got == _bodies(jl, node, jax=True), (name, node)
            assert got == want, (name, node)
        # Each node holds exactly the shards it owns after the cleaner.
        for cn in tl.nodes:
            for s in range(N_SHARDS):
                owns = any(n.id == cn.id for n in cn.cluster.shard_nodes("i", s))
                has = cn.holder.fragment("i", "f", "standard", s) is not None
                assert has == owns or not has, (name, cn.id, s)


# -- the JAX package's drills on the port ------------------------------------

def seed(lc, n_shards=6):
    lc.create_index("i")
    lc.create_field("i", "f")
    cols = [s * SHARD_WIDTH + s for s in range(n_shards)]
    for c in cols:
        lc.query("i", f"Set({c}, f=1)")
    return cols


def _boot_joiner(lc, node_id=None, port=None, state=STATE_STARTING) -> Node:
    """A fresh empty member on the shared transport (a process booted with
    ``--join``); returns its ring Node."""
    node_id = node_id or f"node{len(lc.nodes)}"
    member = Node(id=node_id, uri=URI(port=port or 10130 + len(lc.nodes)))
    ring = [Node(id=n.id, uri=n.uri) for n in lc[0].cluster.nodes]
    c = Cluster(node_id, ring + [member], replica_n=lc[0].cluster.replica_n,
                client=lc.client)
    c.set_state(state)
    cn = ClusterNode(node_id, c, device="cpu")
    cn.apply_schema(lc[0].holder.schema())
    lc.client.register(node_id, cn)
    lc.nodes.append(cn)
    return member


def _old_ring(lc) -> list[Node]:
    return [Node(id=n.id, uri=n.uri) for n in lc[0].cluster.nodes]


def test_grow_cluster_in_process():
    lc = LocalCluster(2, device="cpu")
    cols = seed(lc)
    assert lc.query("i", "Count(Row(f=1))") == [len(cols)]
    member = _boot_joiner(lc, "node2", 10103, state=STATE_NORMAL)
    job = ResizeJob(lc[0].cluster, lc[0].holder, lc.client)
    assert job.run(_old_ring(lc) + [member]) == "DONE"
    assert len(lc[0].cluster.nodes) == 3
    for node in range(3):
        assert lc.query("i", "Count(Row(f=1))", node=node) == [len(cols)]


def test_shrink_cluster_in_process():
    lc = LocalCluster(3, replica_n=2, device="cpu")
    cols = seed(lc)
    keep = [Node(id=n.id, uri=n.uri, is_coordinator=n.is_coordinator)
            for n in lc[0].cluster.nodes if n.id != "node2"]
    assert ResizeJob(lc[0].cluster, lc[0].holder, lc.client).run(keep) == "DONE"
    lc.client.down.add("node2")
    for node in range(2):
        assert lc.query("i", "Count(Row(f=1))", node=node) == [len(cols)]


def test_resize_abort():
    lc = LocalCluster(2, device="cpu")
    seed(lc)
    job = ResizeJob(lc[0].cluster, lc[0].holder, lc.client)
    job.abort()
    state = job.run(_old_ring(lc) + [Node(id="nodeX", uri=URI(port=10199))])
    assert state == "ABORTED"
    assert len(lc[0].cluster.nodes) == 2


def test_resize_failure_keeps_old_topology():
    lc = LocalCluster(2, device="cpu")
    seed(lc)
    old = list(lc[0].cluster.nodes)
    lc.client.down.add("nodeX")
    job = ResizeJob(lc[0].cluster, lc[0].holder, lc.client)
    state = job.run([Node(id=n.id, uri=n.uri, is_coordinator=n.is_coordinator)
                     for n in old + [Node(id="nodeX", uri=URI(port=10199))]])
    assert state == "FAILED"
    assert job.failed == ["nodeX"]
    assert [n.id for n in lc[0].cluster.nodes] == [n.id for n in old]
    assert lc[0].cluster.state == "NORMAL"
    assert lc.query("i", "Count(Row(f=1))") == [6]


def test_holder_cleaner_removes_unowned_fragments():
    lc = LocalCluster(2, device="cpu")
    cols = seed(lc, n_shards=12)
    before = {cn.id: set(cn.holder.field("i", "f").views["standard"].available_shards())
              for cn in lc.nodes}
    member = _boot_joiner(lc, "node2", 10103, state=STATE_NORMAL)
    assert ResizeJob(lc[0].cluster, lc[0].holder, lc.client).run(
        _old_ring(lc) + [member]) == "DONE"
    moved = 0
    for cn in lc.nodes[:2]:
        now = cn.holder.field("i", "f").views["standard"].available_shards()
        for s in before[cn.id]:
            if not any(n.id == cn.id for n in cn.cluster.shard_nodes("i", s)):
                moved += 1
                assert s not in now, (cn.id, s)
                # Routing still counts the shard: its new owner serves it.
                assert s in cn.holder.field("i", "f").available_shards()
    assert moved, "the grow moved nothing"
    for node in range(3):
        assert lc.query("i", "Count(Row(f=1))", node=node, cache=False) == [len(cols)]


def test_holder_cleaner_prevents_stale_bits_on_reownership():
    """Clear a bit after its shard moved away, then move the shard back: the
    original owner serves the repaired state. The port's planner is on, so
    a device stack left resident from before the move would answer the
    stale bit."""
    lc = LocalCluster(2, replica_n=2, device="cpu", planner_factory=_planner)
    lc.create_index("i")
    lc.create_field("i", "f")
    ring3 = Cluster("node0", [Node(id=f"node{i}", uri=URI(port=10101 + i))
                              for i in range(3)], replica_n=2)
    shard = next(s for s in range(64)
                 if {"node0", "node1"} - {n.id for n in ring3.shard_nodes("i", s)})
    x = shard * SHARD_WIDTH + 11
    # Bits in eight more shards: a multi-shard Count runs on the planner.
    extra = [s * SHARD_WIDTH + 1 for s in range(8) if s != shard]
    lc.query("i", " ".join(f"Set({c}, f=1)" for c in [x, x + 1] + extra))
    n = len(extra) + 2
    for node in range(2):  # stacks resident on both planners
        for _ in range(2):
            assert lc.query("i", "Count(Row(f=1))", node=node, cache=False) == [n]
    lc.add_node()
    owners = {n.id for n in lc[0].cluster.shard_nodes("i", shard)}
    loser = ({"node0", "node1"} - owners).pop()
    lv = lc.client.peers[loser].holder.field("i", "f").views
    assert all(shard not in v.available_shards() for v in lv.values())
    lc.query("i", f"Clear({x}, f=1)")
    assert lc.query("i", "Count(Row(f=1))", cache=False) == [n - 1]
    lc.remove_node("node2")
    for node in range(2):
        assert lc.query("i", "Count(Row(f=1))", node=node, cache=False) == [n - 1], \
            "stale bit resurrected"
        assert lc.query("i", "Row(f=1)", node=node, cache=False)[0].columns().tolist() == \
            sorted(extra + [x + 1])
    planner = lc.client.peers[loser].executor.planner
    assert planner.stack_hits >= 1, "no stack was ever resident: the drill is vacuous"


def test_cleaner_never_runs_mid_resize():
    lc = LocalCluster(2, device="cpu")
    seed(lc, n_shards=4)
    b = lc[1]
    unowned = [s for s in range(4)
               if not any(n.id == "node1" for n in b.cluster.shard_nodes("i", s))]
    v = b.holder.index("i").field("f").create_view_if_not_exists("standard")
    v.create_fragment_if_not_exists(unowned[0]).set_bit(1, 5)
    b.cluster.set_state(STATE_RESIZING)
    assert clean_holder(b.holder, b.cluster) == 0
    assert v.fragment(unowned[0]) is not None
    b.cluster.set_state(STATE_NORMAL)
    b.cluster.migration = object()  # a migration table is the in-flight signal
    assert clean_holder(b.holder, b.cluster) == 0
    b.cluster.migration = None
    assert clean_holder(b.holder, b.cluster) >= 1
    assert v.fragment(unowned[0]) is None


def test_server_cleaner_waits_out_the_grace_after_a_ring_change(monkeypatch):
    """A server node drops a fragment it no longer owns only once the new
    ring has stood CLEANER_GRACE_S: a read planned under the old ring
    still finds the shard here meanwhile."""
    monkeypatch.setattr(ServerNode, "CLEANER_GRACE_S", 0.3)
    a, b = sorted(f"127.0.0.1:{p}" for p in _free_ports(2))
    nodes = [ServerNode(bind=x, peers=[y for y in (a, b) if y != x], device="cpu", **_QUIET)
             for x in (a, b)]
    for n in nodes:
        n.open()
    try:
        node = nodes[1]
        idx = node.holder.create_index_if_not_exists("i")
        v = idx.create_field_if_not_exists("f").create_view_if_not_exists("standard")
        shard = next(s for s in range(16) if not node.cluster.owns_shard(node.id, "i", s))
        v.create_fragment_if_not_exists(shard).set_bit(1, shard * SHARD_WIDTH + 5)
        node.cluster.topology_version += 1  # a ring adopted by a discovery pull
        assert node.clean_holder() == 0 and v.fragment(shard) is not None
        time.sleep(0.5)  # the retry the first sight scheduled
        assert v.fragment(shard) is None
        v.create_fragment_if_not_exists(shard).set_bit(1, shard * SHARD_WIDTH + 5)
        node._schedule_clean()  # a commit's broadcast
        assert node.clean_holder() == 0 and v.fragment(shard) is not None
        time.sleep(0.5)
        assert v.fragment(shard) is None
    finally:
        for n in nodes:
            n.close()


def test_stale_broadcast_cannot_roll_back_topology():
    lc = LocalCluster(3, replica_n=1, device="cpu")
    a = lc[0]
    ghost = [n.to_json() for n in a.cluster.nodes]
    a.cluster.nodes = [n for n in a.cluster.nodes if n.id != "node2"]
    a.cluster.topology_version = 2
    apply_cluster_status(a.cluster, ghost, version=1)
    assert a.cluster.node_by_id("node2") is None and a.cluster.topology_version == 2
    apply_cluster_status(a.cluster, ghost, version=2)
    assert a.cluster.node_by_id("node2") is None
    apply_cluster_status(a.cluster, [n.to_json() for n in a.cluster.nodes], version=3)
    assert a.cluster.topology_version == 3


def test_serve_through_resize_reads_and_writes(monkeypatch):
    lc = LocalCluster(2, device="cpu")
    cols = seed(lc)
    stats = MemoryStats()
    member = _boot_joiner(lc)
    for cn in lc.nodes:
        cn.cluster.stats = stats
    orig = LocalClient.send_import_stream
    mid = []

    def spy(self, node, reqs, chunked=False, qos_class=None):
        reqs = list(reqs)
        if not mid:
            sh = reqs[0]["shard"]
            mid.append(lc.query("i", "Count(Row(f=1))", cache=False))
            lc.query("i", f"Set({sh * SHARD_WIDTH + 123}, f=1)")
            mig = lc[0].cluster.migration
            assert mig is not None
            snap = job.snapshot()
            assert snap["state"] == "RUNNING" and snap["shards"]["inFlight"] >= 1
            assert member.id in mig.snapshot()["newNodes"]
        return orig(self, node, reqs, chunked=chunked, qos_class=qos_class)

    monkeypatch.setattr(LocalClient, "send_import_stream", spy)
    job = ResizeJob(lc[0].cluster, lc[0].holder, lc.client)
    assert job.run(_old_ring(lc) + [member]) == "DONE"
    assert mid == [[len(cols)]]
    for node in range(3):
        assert lc.query("i", "Count(Row(f=1))", node=node, cache=False) == [len(cols) + 1]
    assert stats.counter_value("cluster.resize.shardsMigrated") >= 1
    assert stats.counter_value("cluster.resize.bytesStreamed") > 0
    assert stats.counter_value("cluster.resize.dualWrites") >= 1
    assert stats.timing_count("cluster.resize.cutover") >= 1


def test_resize_push_goes_in_bounded_batches(monkeypatch):
    """A target asks each source for at most PUSH_BATCH_FRAGMENTS fragments
    a push, so no synchronous relay outlives the socket timeout however
    much a source holds; the grown ring answers the same."""
    from pilosa_tpu_torch.cluster import resize

    monkeypatch.setattr(resize, "PUSH_BATCH_FRAGMENTS", 2)
    lc = LocalCluster(2, device="cpu")
    cols = seed(lc, n_shards=12)
    pushes = []
    orig = LocalClient.send_message

    def spy(self, node, message):
        if message.get("type") == "resize-push":
            pushes.append(len(message["sources"]))
        return orig(self, node, message)

    monkeypatch.setattr(LocalClient, "send_message", spy)
    member = _boot_joiner(lc)
    assert ResizeJob(lc[0].cluster, lc[0].holder, lc.client).run(
        _old_ring(lc) + [member]) == "DONE"
    assert max(pushes) == 2 and sum(pushes) >= 3
    for node in range(3):
        assert lc.query("i", "Count(Row(f=1))", node=node, cache=False) == [len(cols)]


def test_abort_mid_stream_leaves_ring_routable_then_resume(monkeypatch):
    monkeypatch.setattr(Fragment, "TRANSFER_CHUNK_BITS", 2048)
    lc = LocalCluster(2, device="cpu")
    cols = seed(lc)
    member = _boot_joiner(lc)
    new_view = Cluster("x", _old_ring(lc) + [member], replica_n=1)
    big = next(s for s in range(6) if new_view.shard_nodes("i", s)[0].id == member.id)
    rng = np.random.default_rng(1)
    owner = lc[0].cluster.shard_nodes("i", big)[0]
    lc.client.peers[owner.id].handle_import_request(
        "i", "f", rows=np.zeros(12_000, np.uint64),
        cols=rng.integers(0, SHARD_WIDTH, 12_000).astype(np.uint64) + np.uint64(big * SHARD_WIDTH))
    expect = lc.query("i", "Count(Row(f=0))", cache=False)
    job = ResizeJob(lc[0].cluster, lc[0].holder, lc.client)
    orig = LocalClient.send_import_stream
    torn = []

    def spy(self, node, reqs, chunked=False, qos_class=None):
        reqs = list(reqs)
        if not torn:
            torn.append(node.id)
            assert len(reqs) > 2  # the fragment went in several chunks
            orig(self, node, reqs[:len(reqs) // 2], chunked=chunked, qos_class=qos_class)
            job.abort()
            raise ConnectionError("stream torn down by abort")
        return orig(self, node, reqs, chunked=chunked, qos_class=qos_class)

    monkeypatch.setattr(LocalClient, "send_import_stream", spy)
    assert job.run(_old_ring(lc) + [member]) == "ABORTED"
    assert len(lc[0].cluster.nodes) == 2
    assert all(cn.cluster.migration is None for cn in lc.nodes)
    for node in range(2):
        assert lc.query("i", "Count(Row(f=1))", node=node, cache=False) == [len(cols)]
        assert lc.query("i", "Count(Row(f=0))", node=node, cache=False) == expect
    job2 = ResizeJob(lc[0].cluster, lc[0].holder, lc.client)
    assert job2.run(_old_ring(lc) + [member]) == "DONE"
    for node in range(3):
        assert lc.query("i", "Count(Row(f=1))", node=node, cache=False) == [len(cols)]
        assert lc.query("i", "Count(Row(f=0))", node=node, cache=False) == expect


def test_topology_version_survives_restart(tmp_path):
    a, b = (f"127.0.0.1:{p}" for p in _free_ports(2))
    d0 = str(tmp_path / "n0")
    n0 = ServerNode(bind=a, peers=[b], data_dir=d0, device="cpu", **_QUIET)
    n0.open()
    try:
        n0.cluster.topology_version = 7
        n0.cluster.replica_n = 2
        n0.cluster.notify_topology()
        doc = json.load(open(os.path.join(d0, "topology.json")))
        assert doc["version"] == 7 and doc["replicaN"] == 2
        n0.cluster.topology_version = 5  # a straggling older saver loses
        n0.cluster.notify_topology()
        assert json.load(open(os.path.join(d0, "topology.json")))["version"] == 7
        n0.cluster.topology_version = 7
    finally:
        n0.close()
    reborn = ServerNode(bind=a, peers=[b], data_dir=d0, device="cpu", **_QUIET)
    reborn.open()
    try:
        assert reborn.cluster.topology_version == 7 and reborn.cluster.replica_n == 2
    finally:
        reborn.close()


# -- join and remove-node over HTTP -------------------------------------------

def _json_post(base: str, path: str, body: str, timeout=30):
    r = urllib.request.Request(base + path, data=body.encode(), method="POST")
    return json.loads(urllib.request.urlopen(r, timeout=timeout).read() or b"{}")


def _status(addr: str) -> dict:
    return json.loads(urllib.request.urlopen(f"http://{addr}/status", timeout=10).read())


def test_http_join_then_remove_node(tmp_path):
    """A fresh ``--join`` node grows a running two-node cluster over HTTP
    (its data dir gets ``topology.json``), the old owners' cleaners unlink
    the files of the shards that moved, every node answers the whole index,
    then ``POST /cluster/resize/remove-node`` shrinks it back: the removed
    node sits in REMOVED with its gate closed, and a non-coordinator refuses
    a removal by naming the coordinator."""
    addrs = sorted(f"127.0.0.1:{p}" for p in _free_ports(3))
    dirs = [str(tmp_path / f"n{i}") for i in range(3)]
    nodes = [ServerNode(bind=a, peers=[x for x in addrs[:2] if x != a], replica_n=2,
                        device="cpu", data_dir=dirs[i], **_QUIET)
             for i, a in enumerate(addrs[:2])]
    for n in nodes:
        n.open()
    joiner = None
    try:
        base = nodes[0].address
        _json_post(base, "/index/i", "{}")
        _json_post(base, "/index/i/field/f", "{}")
        cols = [s * SHARD_WIDTH for s in range(10)]
        for c in cols:
            _json_post(base, "/index/i/query", f"Set({c}, f=1)")
        for n in nodes:
            n.store.flush()
        joiner = ServerNode(bind=addrs[2], join=addrs[1], device="cpu", data_dir=dirs[2],
                            **_QUIET)
        joiner.open()
        deadline = time.time() + 30
        while time.time() < deadline and len(joiner.cluster.nodes) != 3:
            time.sleep(0.1)
        assert len(joiner.cluster.nodes) == 3
        assert _status(addrs[0])["nodes"] and len(_status(addrs[0])["nodes"]) == 3
        topo = json.load(open(os.path.join(dirs[2], "topology.json")))
        assert sorted(n["id"] for n in topo["nodes"]) == addrs
        assert topo["version"] == 1 and topo["replicaN"] == 2
        deadline = time.time() + 30
        while True:  # the commit broadcast lands just before the job's DONE
            resize = json.loads(urllib.request.urlopen(base + "/debug/resize",
                                                       timeout=10).read())
            if resize["job"]["state"] != "RUNNING" or time.time() > deadline:
                break
            time.sleep(0.05)
        assert resize["job"]["state"] == "DONE" and resize["migration"] is None

        def stale_files(node):
            vdir = os.path.join(node.data_dir, "i", "f", "standard")
            out = []
            for fn in (os.listdir(vdir) if os.path.isdir(vdir) else []):
                shard = int(fn.split(".")[0])
                if not any(m.id == node.id for m in node.cluster.shard_nodes("i", shard)):
                    out.append(fn)
            return out

        deadline = time.time() + 10
        while time.time() < deadline and any(stale_files(n) for n in nodes):
            time.sleep(0.1)
        assert not [f for n in nodes for f in stale_files(n)]
        assert any(not any(m.id == n.id for m in nodes[0].cluster.shard_nodes("i", s))
                   for n in nodes for s in range(10)), "the join moved nothing"
        for n in nodes + [joiner]:
            assert _json_post(n.address, "/index/i/query", "Count(Row(f=1))") == \
                {"results": [len(cols)]}

        coord = next(n["id"] for n in _status(addrs[0])["nodes"] if n["isCoordinator"])
        victim = addrs[2]
        non_coord = next(a for a in addrs if a != coord)
        with pytest.raises(urllib.error.HTTPError) as e:
            _json_post(f"http://{non_coord}", "/cluster/resize/remove-node",
                       json.dumps({"id": victim}))
        assert coord in e.value.read().decode()
        _json_post(f"http://{coord}", "/cluster/resize/remove-node",
                   json.dumps({"id": victim}), timeout=60)
        assert len(_status(addrs[0])["nodes"]) == 2
        assert _status(victim)["state"] == "REMOVED"
        with pytest.raises(urllib.error.HTTPError) as e:
            _json_post(f"http://{victim}", "/index/i/query", "Count(Row(f=1))")
        assert e.value.code in (400, 405, 409, 503)
        for n in nodes:
            assert _json_post(n.address, "/index/i/query", "Count(Row(f=1))") == \
                {"results": [len(cols)]}
    finally:
        for n in nodes + ([joiner] if joiner else []):
            n.close()


# -- faults the port fixes where it departs from the JAX package ---------------

def test_restarted_member_answers_whole_before_its_first_tick(tmp_path):
    """A member restarted on its data dir merges its peers' schema and shard
    availability before it serves (ROADMAP.md Queue 3, F1): its first bodies,
    with every ticker off, hold the shards created while it was down, equal
    to a numpy oracle. The JAX node serves first and merges on its first
    anti-entropy tick, so its first bodies miss those shards."""
    addrs = sorted(f"127.0.0.1:{p}" for p in _free_ports(3))
    dirs = [str(tmp_path / f"n{i}") for i in range(3)]

    def boot(i):
        n = ServerNode(bind=addrs[i], peers=[a for a in addrs if a != addrs[i]],
                       device="cpu", data_dir=dirs[i], **_QUIET)
        n.open()
        return n

    nodes = [boot(i) for i in range(3)]
    rng = np.random.default_rng(SEED)
    want = set()
    try:
        base = nodes[0].address
        _json_post(base, "/index/i", "{}")
        _json_post(base, "/index/i/field/f", "{}")

        def write(shards):
            for s in shards:
                cols = (s * SHARD_WIDTH + rng.choice(SHARD_WIDTH, 5, replace=False)).tolist()
                _json_post(base, "/index/i/query", " ".join(f"Set({c}, f=1)" for c in cols))
                want.update(cols)

        write(range(3))
        victim = nodes.pop()
        victim.close()
        # Shards the victim does not own, created while it is down.
        later = [s for s in range(3, 40)
                 if all(n.id != victim.id for n in nodes[0].cluster.shard_nodes("i", s))][:6]
        assert len(later) == 6
        write(later)
        nodes.append(boot(2))
        oracle = sorted(want)
        got = _json_post(nodes[2].address, "/index/i/query?noCache=true", "Row(f=1)")
        assert got == {"results": [{"attrs": {}, "columns": oracle}]}
        assert _json_post(nodes[2].address, "/index/i/query?noCache=true",
                          "Count(Row(f=1))") == {"results": [len(oracle)]}
    finally:
        for n in nodes:
            n.close()


def test_dual_write_before_the_instruction_does_not_fail_the_grow(monkeypatch):
    """The resize-begin broadcast carries the schema (ROADMAP.md Queue 3,
    F2), so a write fanned out after it and before the joiner's instruction
    lands on a joiner that booted with no schema, and the grow commits.
    Every node's bodies then equal a numpy oracle. The JAX begin carries no
    schema: the dual write finds no index on the joiner and fails the job."""
    from pilosa_tpu_torch.cluster import resize

    lc = LocalCluster(2, device="cpu")
    cols = seed(lc)
    node_id = "node2"
    member = Node(id=node_id, uri=URI(port=10132))
    c = Cluster(node_id, _old_ring(lc) + [member], replica_n=1, client=lc.client)
    c.set_state(STATE_STARTING)
    joiner = ClusterNode(node_id, c, device="cpu")  # no schema yet
    lc.client.register(node_id, joiner)
    lc.nodes.append(joiner)
    orig = resize.fragment_sources
    written = []

    def between(old_view, new_view, frags):
        s = next(s for s in range(64)
                 if [n.id for n in new_view.shard_nodes("i", s)] == [node_id])
        col = s * SHARD_WIDTH + 77
        assert lc.query("i", f"Set({col}, f=1)") == [True]
        written.append(col)
        return orig(old_view, new_view, frags)

    monkeypatch.setattr(resize, "fragment_sources", between)
    job = ResizeJob(lc[0].cluster, lc[0].holder, lc.client)
    assert job.run(_old_ring(lc) + [member]) == "DONE"
    assert len(written) == 1
    oracle = sorted(set(cols) | set(written))
    for node in range(3):
        assert [result_to_json(r) for r in lc.query("i", "Row(f=1)", node=node, cache=False)] \
            == [{"attrs": {}, "columns": oracle}]
        assert lc.query("i", "Count(Row(f=1))", node=node, cache=False) == [len(oracle)]
