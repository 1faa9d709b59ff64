"""Three port ServerNodes with ``peers`` on loopback against a JAX
three-node cluster on the same data: every query's HTTP body through each
node as coordinator byte for byte the JAX cluster's, remote legs with
``?remote=true`` (JSON envelope and PTF1 frames), replicated writes read
back after a node is gone, the liveness sweep, and the 503 clauses for an
unavailable shard and a fenced node."""

import http.client
import json
import socket

import numpy as np
import pytest

from pilosa_tpu.cluster.resize import check_nodes as j_check_nodes
from pilosa_tpu.exec.ingest_transpose import set_mode as j_transpose_mode
from pilosa_tpu.server import wire as jwire
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.server import wire as twire
from pilosa_tpu_torch.server.node import ServerNode as TServerNode

N_SHARDS = 8
SEED = 23


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _boot(make, n: int, replica_n: int) -> list:
    """n nodes in ring order (by address, as each ring sorts its members),
    so the k-th node of two clusters owns the same shards."""
    addrs = sorted(f"127.0.0.1:{p}" for p in _free_ports(n))
    nodes = [make(a, [x for x in addrs if x != a], replica_n) for a in addrs]
    for node in nodes:
        node.open()
    return nodes


def _port(addr, peers, replica_n):
    return TServerNode(bind=addr, peers=peers, replica_n=replica_n, device="cpu",
                       anti_entropy_interval=0.0, check_nodes_interval=0.0,
                       scrub_interval=0.0)


def _jax(addr, peers, replica_n):
    # No MeshPlanner: three JAX nodes in one process would run their
    # programs' collectives over the one virtual CPU mesh at once, which
    # XLA's in-process communicator does not survive. The per-shard
    # executor gives the same answers.
    return JServerNode(bind=addr, peers=peers, replica_n=replica_n, use_planner=False,
                       anti_entropy_interval=0.0, check_nodes_interval=0.0,
                       scrub_interval=0.0, ingest_transpose="off")


def _kill(nodes, k: int) -> None:
    """Close node k as a killed process would go: its listener and, on every
    other node, the pooled keep-alive sockets to it (a closed node's handler
    threads would still answer on those)."""
    nodes[k].close()
    for i, node in enumerate(nodes):
        if i != k and not node._closed:
            node.cluster.client.close()


def call(node, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", node.port, timeout=60)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read(), r.headers
    finally:
        conn.close()


def _load(nodes) -> None:
    """Schema and data through node 0 (the coordinator routes each shard's
    batch to its owners)."""
    rng = np.random.default_rng(SEED)
    total = N_SHARDS * SHARD_WIDTH
    c = nodes[0]
    for path, opts in (("/index/i", None), ("/index/i/field/f", None),
                       ("/index/i/field/g", None),
                       ("/index/i/field/v", {"type": "int", "min": -100, "max": 5000})):
        assert call(c, "POST", path, {"options": opts} if opts else None)[0] == 200
    for f in ("f", "g"):
        req = {"rowIDs": rng.integers(0, 6, 4000).tolist(),
               "columnIDs": rng.integers(0, total, 4000).tolist()}
        assert call(c, "POST", f"/index/i/field/{f}/import", req)[0] == 200
    cols = np.unique(rng.integers(0, total, 2000))
    req = {"columnIDs": cols.tolist(), "values": rng.integers(-50, 4000, len(cols)).tolist()}
    assert call(c, "POST", "/index/i/field/v/import", req)[0] == 200
    # one shard's bits as a roaring body (row 7 of shard 3)
    from pilosa_tpu_torch import native
    pos = np.arange(0, SHARD_WIDTH, 97, dtype=np.uint64) + np.uint64(7 * SHARD_WIDTH)
    body = native.encode_roaring(pos)
    assert call(c, "POST", "/index/i/field/f/import-roaring/3", body)[0] == 200


@pytest.fixture(scope="module")
def clusters():
    j_transpose_mode("off")
    tn, jn = _boot(_port, 3, 2), _boot(_jax, 3, 2)
    _load(tn)
    _load(jn)
    yield tn, jn
    for node in tn + jn:
        node.close()
    j_transpose_mode("auto")


QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Row(f=7)",
    "Union(Row(f=2), Row(g=3))",
    "TopN(f, n=4)",
    "TopN(g, Row(f=1), n=3)",
    "Rows(f)",
    "GroupBy(Rows(f), Rows(g))",
    "Sum(field=v) Min(field=v) Max(Row(f=2), field=v)",
    "Count(Distinct(field=v))",
    "SimilarTopN(g, Row(f=1), n=3)",
    "Options(Row(f=1), shards=[1, 5])",
]


@pytest.mark.parametrize("query", QUERIES)
def test_bodies_match_the_jax_cluster(clusters, query):
    tn, jn = clusters
    for i in range(3):
        got = call(tn[i], "POST", "/index/i/query?noCache=true", query)[:2]
        want = call(jn[i], "POST", "/index/i/query?noCache=true", query)[:2]
        assert got == want, (query, i)
        assert got[0] == 200


def test_every_node_holds_the_schema_and_its_shards(clusters):
    tn, jn = clusters
    for t, j in zip(tn, jn):
        assert call(t, "GET", "/schema")[1] == call(j, "GET", "/schema")[1]
        assert call(t, "GET", "/internal/nodes")[0] == 200
    for s in range(N_SHARDS):
        path = f"/internal/fragment/nodes?index=i&shard={s}"
        owners = [n["id"] for n in json.loads(call(tn[1], "GET", path)[1])]
        assert len(owners) == 2
        for node in tn:
            frag = node.holder.fragment("i", "f", "standard", s)
            assert (frag is not None) == (node.id in owners), (s, node.id)


@pytest.mark.parametrize("accept", ["", twire.FRAMES_CONTENT_TYPE, twire.FRAMES_ACCEPT_V2])
def test_remote_leg(clusters, accept):
    """A remote leg (``?remote=true&shards=``) answers the tagged JSON
    envelope, or PTF1 frames v1/v2 by Accept, equal to a JAX node's but
    for each node's own shard-epoch counters."""
    tn, jn = clusters
    q = "Row(f=1) Count(Row(g=2)) TopN(f, n=2) Rows(g) Sum(field=v)"
    path = "/index/i/query?remote=true&shards=0,1,2,3,4,5,6,7"
    got = call(tn[0], "POST", path, q, {"Accept": accept})
    want = call(jn[0], "POST", path, q, {"Accept": accept})
    assert got[0] == want[0] == 200
    assert got[2]["Content-Type"] == want[2]["Content-Type"]
    if accept:
        (tr, th), (jr, jh) = twire.decode_frames_meta(got[1]), jwire.decode_frames_meta(want[1])
        assert set(th.pop("shardEpochs")) == set(jh.pop("shardEpochs"))
        assert th == jh
        assert json.dumps([twire.encode_result(r) for r in tr]) == \
            json.dumps([jwire.encode_result(r) for r in jr])
    else:
        t_doc, j_doc = json.loads(got[1]), json.loads(want[1])
        assert set(t_doc.pop("shardEpochs")) == set(j_doc.pop("shardEpochs"))
        assert t_doc == j_doc


def test_wire_counters_and_mux(clusters):
    tn, _ = clusters
    call(tn[0], "POST", "/index/i/query?noCache=true", "Row(f=1)")
    client = tn[0].cluster.client
    assert client._channels and not client._mux_unsupported
    doc = json.loads(call(tn[0], "GET", "/debug/vars")[1])
    assert doc["counters"]["cluster.wireBytesIn"] > 0


def test_writes_fail_over_and_read_back(clusters):
    """Set and Clear through a coordinator reach both replicas; with one
    node closed, every query through a live coordinator fails over and
    reads them back; the liveness sweep then marks it DOWN."""
    tn, jn = clusters
    col = 2 * SHARD_WIDTH + 12345
    for nodes in (tn, jn):
        st, body, _ = call(nodes[1], "POST", "/index/i/query", f"Set({col}, f=5) Clear({col}, f=9)")
        assert st == 200
    before = {q: call(tn[0], "POST", "/index/i/query?noCache=true", q)[1] for q in QUERIES}
    _kill(tn, 2)
    _kill(jn, 2)
    for q in QUERIES:
        for i in (0, 1):
            got = call(tn[i], "POST", "/index/i/query?noCache=true", q)[:2]
            assert got == (200, before[q]), (q, i)
    row = json.loads(call(tn[1], "POST", "/index/i/query?noCache=true", "Row(f=5)")[1])
    assert col in row["results"][0]["columns"]
    tn[0].check_nodes()
    doc = json.loads(call(tn[0], "GET", "/debug/membership")[1])
    states = {p["id"]: p["state"] for p in doc["peers"]}
    assert states[tn[2].id] == "DOWN" and doc["state"] == "DEGRADED"
    assert not doc["fenced"]
    j_check_nodes(jn[0].cluster, jn[0].cluster.client)
    for q in QUERIES:
        got = call(tn[0], "POST", "/index/i/query?noCache=true", q)[:2]
        want = call(jn[0], "POST", "/index/i/query?noCache=true", q)[:2]
        assert got == want == (200, before[q]), q


def test_503_for_an_unavailable_shard_and_a_fenced_node():
    """With one owner a shard (replica 1), a query whose shards lost their
    owner answers 503 (ShardUnavailableError, Retry-After 1) before the
    sweep notices, as the JAX cluster does; after it, the node has lost a
    shard's every copy (STARTING: 405); a node that reaches no majority
    answers 503 (fenced, Retry-After 5)."""
    j_transpose_mode("off")
    tn, jn = _boot(_port, 3, 1), _boot(_jax, 3, 1)
    try:
        owners = {tn[0].cluster.shard_nodes("i", s)[0].id for s in range(N_SHARDS)}
        gone = 2 if tn[2].id in owners else 1  # a node that owns a shard
        for nodes in (tn, jn):
            _load(nodes)
            _kill(nodes, gone)
        got = call(tn[0], "POST", "/index/i/query", "Count(Row(f=1))")
        want = call(jn[0], "POST", "/index/i/query", "Count(Row(f=1))")
        assert got[:2] == want[:2] and got[0] == 503
        assert got[2]["Retry-After"] == want[2]["Retry-After"] == "1"
        tn[0].check_nodes()
        j_check_nodes(jn[0].cluster, jn[0].cluster.client)
        got = call(tn[0], "POST", "/index/i/query", "Count(Row(f=1))")
        want = call(jn[0], "POST", "/index/i/query", "Count(Row(f=1))")
        assert got[:2] == want[:2] and got[0] == 405
        for nodes in (tn, jn):
            _kill(nodes, 3 - gone)
        tn[0].check_nodes()
        j_check_nodes(jn[0].cluster, jn[0].cluster.client)
        got = call(tn[0], "POST", "/index/i/query", "Count(Row(f=1))")
        want = call(jn[0], "POST", "/index/i/query", "Count(Row(f=1))")
        assert got[:2] == want[:2] and got[0] == 503
        assert got[2]["Retry-After"] == want[2]["Retry-After"] == "5"
        assert json.loads(call(tn[0], "GET", "/debug/membership")[1])["fenced"]
    finally:
        for node in (tn[0], jn[0]):
            node.close()
        j_transpose_mode("auto")


def test_unported_cluster_messages_answer_501(clusters):
    """The resize and join messages answered 501 until the elastic half of
    the cluster slice; now a resize-begin installs the same migration
    table on a port node as on a JAX node (``GET /debug/resize``), its
    resize-end drops it, and a join for a member already in the ring
    answers as the JAX node does (the committed topology re-sent)."""
    tn, jn = clusters
    ring = {"t": [n.to_json() for n in tn[0].cluster.nodes],
            "j": [n.to_json() for n in jn[0].cluster.nodes]}
    got = {}
    for side, nodes in (("t", tn), ("j", jn)):
        msg = {"type": "resize-begin", "job": "resize-x", "nodes": ring[side],
               "coordinator": ring[side][0], "replicaN": 2}
        steps = [call(nodes[0], "GET", "/debug/resize"),
                 call(nodes[0], "POST", "/internal/cluster/message", msg),
                 call(nodes[0], "GET", "/debug/resize"),
                 call(nodes[0], "POST", "/internal/cluster/message",
                      {"type": "resize-end", "job": "resize-x"}),
                 call(nodes[0], "GET", "/debug/resize"),
                 call(nodes[0], "POST", "/internal/cluster/message",
                      {"type": "node-join", "addr": nodes[1].id})]
        got[side] = [(st, json.loads(body.decode().replace(
            nodes[0].id, "A").replace(nodes[1].id, "B").replace(nodes[2].id, "C")))
            for st, body, _ in steps]
    assert got["t"] == got["j"]
    assert [st for st, _ in got["t"]] == [200] * 6
    assert got["t"][2][1]["migration"]["newNodes"] == ["A", "B", "C"]
    assert got["t"][4][1] == {"job": None, "migration": None}
