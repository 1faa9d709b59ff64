"""Chaos faults in the port (pilosa_tpu_torch/cluster/faults.py, the HTTP
client's partition gate and ``POST /internal/fault`` on a node started
with ``chaos_faults``) against the JAX package's: the fault table's
snapshots and errors, the route's bodies against a JAX node's, a
partitioned link failing the port's outbound RPCs, and the drills of
tests/test_partition.py that the elastic cluster adds (directional pair
faults, a fenced scrub, a fenced coordinator refusing a resize)."""

import json
import socket
import time
import urllib.error
import urllib.request

import pytest

from pilosa_tpu.cluster.faults import PartitionFaults as JPartitionFaults
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu_torch.cluster import Node
from pilosa_tpu_torch.cluster.faults import PartitionFaults
from pilosa_tpu_torch.cluster.harness import LocalCluster
from pilosa_tpu_torch.cluster.resize import ResizeJob
from pilosa_tpu_torch.cluster.scrub import Scrubber
from pilosa_tpu_torch.obs.stats import MemoryStats
from pilosa_tpu_torch.server.node import ServerNode


def test_fault_table_matches_jax():
    j, t = JPartitionFaults(), PartitionFaults()
    for peer, mode, delay in (("a", "drop", 0.0), ("b", "timeout", 0.01), ("c", "timeout", 99.0)):
        j.set_fault(peer, mode=mode, delay_s=delay)
        t.set_fault(peer, mode=mode, delay_s=delay)
    assert t.snapshot() == j.snapshot() and len(t) == len(j) == 3
    for peer in ("a", "b"):
        with pytest.raises(ConnectionError) as want:
            j.check(peer)
        with pytest.raises(ConnectionError) as got:
            t.check(peer)
        assert str(got.value) == str(want.value)
    t.check("z")
    with pytest.raises(ValueError):
        t.set_fault("a", mode="flaky")
    j.clear("a")
    t.clear("a")
    assert t.snapshot() == j.snapshot() and not t.blocked("a") and t.blocked("b")
    t.clear()
    assert len(t) == 0


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _call(port, method, path, body=None):
    data = json.dumps(body).encode() if isinstance(body, dict) else body
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


_QUIET = dict(anti_entropy_interval=0.0, check_nodes_interval=0.0, scrub_interval=0.0)


def test_fault_route_matches_jax():
    """``POST /internal/fault`` on two-node clusters of each package: the
    slow-query lever, a partition of one link, the heal, the membership
    view, and the route's absence without ``chaos_faults``."""
    addrs = [[f"127.0.0.1:{p}" for p in sorted(_free_ports(2))] for _ in range(2)]
    jn = [JServerNode(bind=a, peers=[x for x in addrs[0] if x != a], use_planner=False,
                      chaos_faults=True, ingest_transpose="off", **_QUIET) for a in addrs[0]]
    tn = [ServerNode(bind=a, peers=[x for x in addrs[1] if x != a], device="cpu",
                     chaos_faults=True, **_QUIET) for a in addrs[1]]
    plain = ServerNode(bind="127.0.0.1:0", device="cpu", **_QUIET)
    for n in jn + tn + [plain]:
        n.open()
    try:
        def both(body, path="/internal/fault", method="POST"):
            out = []
            for nodes, ring in ((jn, addrs[0]), (tn, addrs[1])):
                st, doc = _call(nodes[0].port, method, path, body)
                # Peer ids are addresses: name the peer by its ring position.
                out.append((st, json.loads(json.dumps(doc).replace(ring[1], "PEER"))))
            assert out[1] == out[0]
            return out[1]

        assert both({"slowMs": 30}) == (200, {"slowMs": 30.0, "partition": {}})
        t0 = time.perf_counter()
        assert _call(tn[0].port, "POST", "/index/x/query", b"Count(Row(f=1))")[0] == 404
        assert time.perf_counter() - t0 >= 0.03
        assert both({"slowMs": 0})[1]["slowMs"] == 0.0
        body = both({"partition": {"peers": [], "mode": "timeout", "delayMs": 5}})
        assert body == (200, {"slowMs": 0.0, "partition": {}})
        for nodes, ring in ((jn, addrs[0]), (tn, addrs[1])):
            st, doc = _call(nodes[0].port, "POST", "/internal/fault",
                            {"partition": {"peers": [ring[1]], "mode": "drop"}})
            assert st == 200 and doc["partition"] == {ring[1]: {"mode": "drop", "delayS": 0.0}}
        for nodes, ring in ((jn, addrs[0]), (tn, addrs[1])):
            memb = _call(nodes[0].port, "GET", "/debug/membership")[1]
            assert memb["injectedFaults"] == {ring[1]: {"mode": "drop", "delayS": 0.0}}
        # The cut link fails the port node's outbound RPCs.
        peer = tn[0].cluster.node_by_id(addrs[1][1])
        with pytest.raises(ConnectionError, match="partition fault"):
            tn[0].cluster.client.nodes(peer)
        assert both({"healPartition": True}) == (200, {"slowMs": 0.0, "partition": {}})
        tn[0].cluster.client.nodes(peer)
        assert both({"partition": {"peers": ["x"], "mode": "bogus"}})[0] == 400
        assert _call(plain.port, "POST", "/internal/fault", {"slowMs": 1})[0] == 404
    finally:
        for n in jn + tn + [plain]:
            n.close()


# -- tests/test_partition.py drills on the port ---------------------------------

def test_partition_pair_faults_are_directional():
    lc = LocalCluster(3, replica_n=2, device="cpu")
    lc.block_link("node0", "node2")
    n0_view_of_2 = lc[0].cluster.node_by_id("node2")
    n2_view_of_0 = lc[2].cluster.node_by_id("node0")
    with pytest.raises(ConnectionError):
        lc[0].cluster.client.probe(n0_view_of_2)
    lc[2].cluster.client.probe(n2_view_of_0)
    lc.heal_partition()
    lc[0].cluster.client.probe(n0_view_of_2)


def test_resize_job_refuses_to_run_while_fenced():
    lc = LocalCluster(3, replica_n=2, device="cpu")
    coord = lc[0]
    coord.cluster.fenced = True
    job = ResizeJob(coord.cluster, coord.holder, coord.cluster.client)
    new_ring = [Node(id=n.id, uri=n.uri, is_coordinator=n.is_coordinator)
                for n in coord.cluster.nodes]
    assert job.run(new_ring) == "FAILED"
    assert coord.cluster.migration is None


def test_scrub_fence_preserves_dirty_marks_and_refuses_push_repair():
    class _StubQuarantine:
        @staticmethod
        def keys():
            return []

        @staticmethod
        def get(key):
            return None

    class _StubStore:
        quarantine = _StubQuarantine()

        @staticmethod
        def _all_keys():
            return []

    lc = LocalCluster(3, replica_n=2, device="cpu")
    a = lc[0]
    stats = MemoryStats()
    scr = Scrubber(a.holder, a.cluster, a.cluster.client, _StubStore(), stats=stats)
    a.cluster.dirty_shards.mark("pt", 0)
    a.cluster.fenced = True
    scr.scrub_pass()
    assert ("pt", 0) in a.cluster.dirty_shards.peek()
    assert scr._scrub_fragment(("pt", "f", "standard", 0)) is False
    assert stats.counter_value("integrity.scrubFenced") == 1
    a.cluster.fenced = False
    lc.create_index("pt")
    lc.create_field("pt", "f")
    scr.scrub_pass()
    assert ("pt", 0) not in a.cluster.dirty_shards.peek()


def test_heal_after_partition_converges_by_anti_entropy():
    """A write the minority missed while partitioned is repaired by one
    anti-entropy pass once the link heals."""
    from pilosa_tpu_torch.cluster.sync import HolderSyncer

    lc = LocalCluster(3, replica_n=3, device="cpu")
    lc.create_index("pt")
    lc.create_field("pt", "f")
    lc.partition([2])
    lc.down("node2")
    lc.query("pt", "Set(7, f=1)")
    lc.up("node2")
    lc.heal_partition()
    missed = lc[2].holder.fragment("pt", "f", "standard", 0)
    assert missed is None or not missed.contains(1, 7)
    assert HolderSyncer(lc[0].holder, lc[0].cluster, lc.client).sync_holder() >= 1
    assert lc[2].holder.fragment("pt", "f", "standard", 0).contains(1, 7)
