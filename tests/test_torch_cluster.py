"""The port's cluster layer (pilosa_tpu_torch/cluster/) against the JAX
package's: the serving cases of tests/test_cluster.py on the port's
``LocalCluster`` -- placement vectors, fan-out through every node as
coordinator, replicated writes, attr broadcast, failover with and without
replicas, the event pipeline, cache invalidation across nodes, the state
gate, schema fan-out, an asymmetric partition, deadlines and cancel, and a
down replica marked dirty. Each parametrized query is held to the JAX
``LocalCluster`` and to a single port node on the same seeded data."""

import time

import numpy as np
import pytest

from pilosa_tpu.cluster import placement as j_placement
from pilosa_tpu.cluster.harness import LocalCluster as JLocalCluster
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.exec.result import result_to_json as j_json
from pilosa_tpu_torch.cluster import Cluster, Node, fnv1a64, jump_hash, partition
from pilosa_tpu_torch.cluster.cluster import (
    STATE_NORMAL,
    STATE_RESIZING,
    STATE_STARTING,
    ShardUnavailableError,
)
from pilosa_tpu_torch.cluster.harness import LocalCluster
from pilosa_tpu_torch.cluster.resize import check_nodes
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.errors import ApiMethodNotAllowedError
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.obs.stats import MemoryStats
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.qos import deadline as qdl
from pilosa_tpu_torch.server.api import API

N_SHARDS = 6
SEED = 5


# -- placement math --------------------------------------------------------

def test_fnv1a64_vectors():
    assert fnv1a64(b"") == 0xCBF29CE484222325
    assert fnv1a64(b"a") == 0xAF63DC4C8601EC8C
    assert fnv1a64(b"foobar") == 0x85944171F73967E8


def test_placement_matches_jax():
    """jump_hash and partition name the same buckets as the JAX package's
    (and so the same owners for the same ring)."""
    rng = np.random.default_rng(SEED)
    for key in list(rng.integers(0, 2**63, 200)) + [0, 1, 2**64 - 1]:
        for n in (1, 2, 3, 8, 100):
            assert jump_hash(int(key), n) == j_placement.jump_hash(int(key), n)
    for index in ("i", "bench", "a-much-longer-index-name"):
        for shard in range(300):
            assert partition(index, shard) == j_placement.partition(index, shard)
    moved = sum(jump_hash(k, 8) != jump_hash(k, 9) for k in range(1000))
    assert moved < 1000 * 0.25


def test_shard_nodes_replicas():
    nodes = [Node(id=f"n{i}") for i in range(4)]
    c = Cluster("n0", nodes, replica_n=2)
    owners = c.shard_nodes("i", 0)
    assert len({n.id for n in owners}) == 2
    c2 = Cluster("n3", [Node(id=f"n{i}") for i in range(4)], replica_n=2)
    assert [n.id for n in c2.shard_nodes("i", 0)] == [n.id for n in owners]
    with pytest.raises(ShardUnavailableError):
        Cluster("n0", [Node(id="n0")]).shards_by_node([], "i", [0])


# -- multi-node execution, held to the JAX cluster and a single node --------

def _data(seed=SEED):
    rng = np.random.default_rng(seed)
    total = N_SHARDS * SHARD_WIDTH
    bits = {f: (rng.integers(0, 5, 3000), rng.integers(0, total, 3000)) for f in ("f", "g")}
    vcols = np.unique(rng.integers(0, total, 1500))
    vals = rng.integers(-50, 4000, len(vcols))
    return bits, (vcols, vals)


def _seed(lc, field_options, data, replicated: bool):
    """Schema on every node, and each shard's bits on its owners (every
    owner when ``replicated``, else the first), as a routed import puts
    them."""
    bits, (vcols, vals) = data
    lc.create_index("i")
    for f in ("f", "g"):
        lc.create_field("i", f)
    lc.create_field("i", "v", field_options(type="int", min=-100, max=5000))
    owners = lc[0].cluster
    for shard in range(N_SHARDS):
        targets = owners.shard_nodes("i", shard)
        for node in (targets if replicated else targets[:1]):
            h = lc.client.peers[node.id].holder
            for f, (rows, cols) in bits.items():
                m = cols // SHARD_WIDTH == shard
                h.field("i", f).import_bits(rows[m], cols[m])
            m = vcols // SHARD_WIDTH == shard
            h.field("i", "v").import_values(vcols[m], vals[m])
            h.index("i").add_existence(np.concatenate(
                [bits["f"][1], bits["g"][1], vcols])[np.concatenate(
                    [bits["f"][1], bits["g"][1], vcols]) // SHARD_WIDTH == shard])


def _single_node(data):
    h = Holder(device="cpu")
    idx = h.create_index("i")
    bits, (vcols, vals) = data
    for f, (rows, cols) in bits.items():
        idx.create_field(f).import_bits(rows, cols)
    idx.create_field("v", FieldOptions(type="int", min=-100, max=5000)).import_values(vcols, vals)
    idx.add_existence(np.concatenate([bits["f"][1], bits["g"][1], vcols]))
    return Executor(h, planner=Planner(h))


# MinRow/MaxRow are left out: their count is the first fold's of the row
# (ValCount/Pair tie rule), and a cluster folds legs as they complete, in
# both packages.
CLUSTER_QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=0), Row(g=3)))",
    "Row(f=2)",
    "Union(Row(f=1), Row(g=4))",
    "TopN(f, n=3)",
    "TopN(f, Row(g=1), n=2)",
    "Rows(f)",
    "GroupBy(Rows(f), Rows(g))",
    "Sum(field=v)",
    "Min(Row(f=1), field=v)",
    "Max(field=v)",
    "Count(Xor(Row(f=1), Row(g=1)))",
    "Count(Distinct(field=v))",
    "Count(Distinct(Row(f=2), field=v, threshold=10))",
    "SimilarTopN(f, Row(g=1), n=3)",
    "Not(Row(f=1))",
    "Options(Row(f=3), shards=[0, 2])",
]


@pytest.fixture(scope="module", params=["plain", "planner"])
def clusters(request):
    """(port cluster, JAX cluster, single port node) on the same data: the
    port's nodes without a planner, or each with its own planner."""
    data = _data()
    factory = None if request.param == "plain" else (lambda i: (lambda h: Planner(h)))
    t = LocalCluster(3, replica_n=2, device="cpu", planner_factory=factory)
    j = JLocalCluster(3, replica_n=2)
    _seed(t, FieldOptions, data, replicated=True)
    _seed(j, JFieldOptions, data, replicated=True)
    return t, j, _single_node(data)


@pytest.mark.parametrize("query", CLUSTER_QUERIES)
def test_cluster_matches_jax_cluster_and_single_node(clusters, query):
    t, j, single = clusters
    want = [result_to_json(r) for r in single.execute("i", query)]
    for node in range(3):
        got = [result_to_json(r) for r in t.query("i", query, node=node, cache=False)]
        jgot = [j_json(r) for r in j.query("i", query, node=node, cache=False)]
        assert got == jgot == want, (query, node)


def test_replicated_write_fanout():
    lc = LocalCluster(3, replica_n=2, device="cpu")
    lc.create_index("i")
    lc.create_field("i", "f")
    assert lc.query("i", "Set(5, f=1)") == [True]
    owners = [n.id for n in lc[0].cluster.shard_nodes("i", 0)]
    for cn in lc.nodes:
        frag = cn.holder.fragment("i", "f", "standard", 0)
        assert (frag is not None and frag.contains(1, 5)) == (cn.id in owners), cn.id
    assert lc.query("i", "Clear(5, f=1)", node=2) == [True]
    for cn in lc.nodes:
        frag = cn.holder.fragment("i", "f", "standard", 0)
        assert frag is None or not frag.contains(1, 5), cn.id


def test_attr_broadcast():
    lc = LocalCluster(3, device="cpu")
    lc.create_index("i")
    lc.create_field("i", "f")
    lc.query("i", 'SetRowAttrs(f, 1, color="red")')
    lc.query("i", "SetColumnAttrs(7, size=3)", node=1)
    for cn in lc.nodes:
        assert cn.holder.field("i", "f").row_attr_store.attrs(1) == {"color": "red"}
        assert cn.holder.index("i").column_attr_store.attrs(7) == {"size": 3}


def test_failover_with_replicas():
    """A node goes down; reads fail over to replicas (executor.go:2492)."""
    lc = LocalCluster(3, replica_n=2, device="cpu")
    lc.create_index("i")
    lc.create_field("i", "f")
    cols = [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3, 5 * SHARD_WIDTH + 9]
    for c in cols:
        lc.query("i", f"Set({c}, f=7)")
    assert lc.query("i", "Count(Row(f=7))") == [4]
    lc.client.down.add("node1")  # dead, but not yet noticed: legs fail over
    assert lc.query("i", "Count(Row(f=7))", node=0, cache=False) == [4]
    assert list(lc.query("i", "Row(f=7)", node=2, cache=False)[0].columns()) == cols
    lc.client.down.discard("node1")
    lc.down("node1")
    assert lc.query("i", "Count(Row(f=7))", node=0, cache=False) == [4]
    assert lc[0].cluster.state == "DEGRADED"
    lc.up("node1")
    assert lc[0].cluster.state == "NORMAL"


def test_failover_without_replicas_fails():
    lc = LocalCluster(3, replica_n=1, device="cpu")
    lc.create_index("i")
    lc.create_field("i", "f")
    for s in range(N_SHARDS):
        lc.query("i", f"Set({s * SHARD_WIDTH}, f=1)")
    lc.down("node1")
    owned_by_down = [s for s in range(N_SHARDS)
                     if lc[0].cluster.shard_nodes("i", s)[0].id == "node1"]
    assert owned_by_down
    with pytest.raises(ShardUnavailableError):
        lc.query("i", "Count(Row(f=1))", node=0)


def test_node_event_pipeline():
    """NodeEvents flow from membership changes and the failure detector to
    subscribers (reference event.go:18-31)."""
    lc = LocalCluster(3, replica_n=2, device="cpu")
    c0 = lc[0].cluster
    events = []
    c0.subscribe(events.append)
    lc.client.down.add("node1")
    check_nodes(c0, lc.client)
    lc.client.down.discard("node1")
    check_nodes(c0, lc.client)
    assert [(e.type, e.node_id, e.state) for e in events] == [
        ("update", "node1", "DOWN"), ("update", "node1", "READY")]
    c0.node_join(Node(id="nodeX"))
    assert events[-1].type == "join" and events[-1].node_id == "nodeX"
    c0.node_leave("nodeX")
    assert events[-1].type == "leave"


def test_cross_node_invalidation_of_coordinator_cache():
    """A write through node B invalidates node A's cached read through the
    index-dirty broadcast, and B's epochs reach A's remote-epoch table."""
    lc = LocalCluster(3, replica_n=1, device="cpu")
    lc.create_index("inv")
    lc.create_field("inv", "f")
    lc.query("inv", "Set(1, f=1)")
    assert lc.query("inv", "Count(Row(f=1))", node=0) == [1]
    assert lc.query("inv", "Count(Row(f=1))", node=0) == [1]  # a cache hit
    cl = lc[0].cluster
    shard = next(s for s in range(32) if cl.shard_nodes("inv", s)[0].id != "node0")
    lc.query("inv", f"Set({shard * SHARD_WIDTH + 7}, f=1)", node=1)
    lc[1].dirty.flush_now()
    owner = cl.shard_nodes("inv", shard)[0].id
    lc[int(owner[-1])].dirty.flush_now()
    deadline = time.time() + 2.0
    while time.time() < deadline and lc.query("inv", "Count(Row(f=1))", node=0) != [2]:
        time.sleep(0.02)
    assert lc.query("inv", "Count(Row(f=1))", node=0) == [2]
    assert lc[0].executor.remote_epochs.snapshot()["entries"] > 0


def test_dirty_broadcast_coalesces():
    """A write burst sends a few broadcasts a window, not one a write."""
    lc = LocalCluster(2, device="cpu")
    lc.create_index("burst")
    lc.create_field("burst", "f")
    sent = []
    orig = lc.client.send_message

    def counting(node, message):
        if message.get("type") == "index-dirty":
            sent.append(message)
        return orig(node, message)

    lc.client.send_message = counting
    for i in range(200):
        lc[0].executor.execute("burst", f"Set({i}, f=1)")
    lc[0].dirty.flush_now()
    assert 1 <= len(sent) <= 8, len(sent)


def test_api_gated_by_cluster_state():
    """Reference api.go:99-125: queries, imports and schema changes are
    refused while RESIZING or STARTING; status and schema stay readable;
    a remote leg (internal) reads on through STARTING."""
    lc = LocalCluster(2, device="cpu")
    a = lc[0]
    api = API(a.holder, a.executor, cluster=a.cluster)
    api.create_index("gate")
    api.create_field("gate", "f")
    for state in (STATE_RESIZING, STATE_STARTING):
        a.cluster.set_state(state)
        for blocked in (
                lambda: api.query("gate", "Count(Row(f=1))"),
                lambda: api.create_index("gate2"),
                lambda: api.delete_index("gate"),
                lambda: api.create_field("gate", "g"),
                lambda: api.import_bits("gate", "f", [1], [2]),
                lambda: api.apply_schema([])):
            with pytest.raises(ApiMethodNotAllowedError):
                blocked()
        assert api.status()["state"] == state
        api.schema()
    assert api.query("gate", "Count(Row(f=1))", remote=True,
                     shards=[0])["results"] == [{"t": "scalar", "v": 0}]
    a.cluster.set_state(STATE_NORMAL)
    api.query("gate", "Count(Row(f=1))")


def test_liveness_sweep_cannot_reopen_resizing_gate():
    lc = LocalCluster(3, device="cpu")
    a = lc[0]
    a.cluster.set_state(STATE_RESIZING)
    check_nodes(a.cluster, lc.client)
    assert a.cluster.state == STATE_RESIZING


def test_resize_messages_are_not_ported():
    """The resize and topology messages were refused until the elastic
    half of the cluster slice; now the harness applies them: a cluster
    state, a resize-begin's migration table and its resize-end, a newer
    committed topology, and a grow through ``add_node``."""
    lc = LocalCluster(2, device="cpu")
    peer = lc[0].cluster.nodes[1]
    b = lc[1].cluster
    lc.client.send_message(peer, {"type": "cluster-state", "state": STATE_RESIZING})
    assert b.state == STATE_RESIZING
    lc.client.send_message(peer, {"type": "cluster-state", "state": STATE_NORMAL})
    assert b.state == STATE_NORMAL
    ring = [n.to_json() for n in b.nodes]
    lc.client.send_message(peer, {"type": "resize-begin", "job": "j1", "nodes": ring,
                                  "coordinator": ring[0]})
    assert b.migration is not None and b.migration.snapshot()["job"] == "j1"
    lc.client.send_message(peer, {"type": "resize-end", "job": "j1"})
    assert b.migration is None
    lc.client.send_message(peer, {"type": "cluster-status", "nodes": ring, "version": 3})
    assert b.topology_version == 3
    cn = lc.add_node()
    assert [n.id for n in lc[0].cluster.nodes] == ["node0", "node1", cn.id]


def test_apply_schema_fans_out_cluster_wide():
    lc = LocalCluster(3, device="cpu")
    api = API(lc[0].holder, lc[0].executor, cluster=lc[0].cluster)
    api.apply_schema([{"name": "rep", "options": {},
                       "fields": [{"name": "f", "options": {"type": "set"}}]}])
    for i in range(3):
        idx = lc[i].holder.index("rep")
        assert idx is not None and idx.field("f") is not None, f"node {i}"
    api2 = API(lc[1].holder, lc[1].executor, cluster=lc[1].cluster)
    api2.apply_schema([{"name": "solo", "options": {}, "fields": []}], remote=True)
    assert lc[1].holder.index("solo") is not None
    assert lc[0].holder.index("solo") is None


def test_asymmetric_partition_does_not_mark_node_down():
    """SWIM-style indirect probes: a peer this node cannot reach but
    others can is partitioned from us, not dead; when it really dies the
    sweep marks it DOWN. The harness's pair faults cut the one link."""
    lc = LocalCluster(3, replica_n=2, device="cpu")
    a = lc[0]
    events = []
    a.cluster.subscribe(events.append)
    lc.block_link(0, 2)
    assert check_nodes(a.cluster, a.cluster.client, discover=False) == []
    assert a.cluster.node_by_id("node2").state != "DOWN"
    assert a.cluster.state == STATE_NORMAL and events == []
    assert a.cluster.membership_log["node2"]["indirect"] == {"node1": True}
    lc.client.down.add("node2")
    assert "node2" in check_nodes(a.cluster, a.cluster.client, discover=False)
    assert a.cluster.node_by_id("node2").state == "DOWN"


def test_partition_fences_the_minority():
    """A node that reaches no majority fences itself: client queries
    refused, remote legs still served; healing lifts the fence."""
    from pilosa_tpu_torch.errors import ClusterFencedError

    lc = LocalCluster(3, replica_n=2, device="cpu")
    lc.create_index("i")
    lc.create_field("i", "f")
    lc.partition([2])
    lc.check_all_nodes()
    minority = lc[2]
    assert minority.cluster.fenced and not lc[0].cluster.fenced
    api = API(minority.holder, minority.executor, cluster=minority.cluster)
    with pytest.raises(ClusterFencedError):
        api.query("i", "Count(Row(f=1))")
    api.query("i", "Count(Row(f=1))", remote=True, shards=[0])
    lc.heal_partition()
    lc.check_all_nodes()
    assert not minority.cluster.fenced


def test_expired_deadline_cancels_fanout_no_partial_results():
    lc = LocalCluster(3, device="cpu")
    _seed(lc, FieldOptions, _data(), replicated=False)
    remote_calls = []
    orig = lc.client.query_node

    def recording(node, index, query, shards, remote=True):
        remote_calls.append(node.id)
        return orig(node, index, query, shards, remote)

    lc.client.query_node = recording
    tok = qdl.set_current_deadline(qdl.Deadline(timeout=-1))
    try:
        with pytest.raises(qdl.DeadlineExceededError):
            lc.query("i", "Count(Row(f=1))", cache=False)
    finally:
        qdl.reset_current_deadline(tok)
        lc.client.query_node = orig
    assert remote_calls == []


def test_cancel_stops_failover_retry_wave():
    lc = LocalCluster(2, replica_n=2, device="cpu")
    lc.create_index("i")
    lc.create_field("i", "f")
    rng = np.random.default_rng(SEED)
    rows, cols = rng.integers(0, 4, 2000), rng.integers(0, 4 * SHARD_WIDTH, 2000)
    for cn in lc.nodes:
        cn.holder.field("i", "f").import_bits(rows, cols)
    want = lc.query("i", "Count(Row(f=1))", cache=False)
    orig = lc.client.query_node
    calls = []

    def failing_once(node, index, query, shards, remote=True):
        calls.append(node.id)
        if len(calls) == 1:
            raise ConnectionError(f"node {node.id} is down")
        return orig(node, index, query, shards, remote)

    lc.client.query_node = failing_once
    try:
        assert lc.query("i", "Count(Row(f=1))", cache=False) == want
    finally:
        lc.client.query_node = orig
    dl = qdl.Deadline()

    def failing_cancelled(node, index, query, shards, remote=True):
        dl.cancel()
        raise ConnectionError(f"node {node.id} is down")

    lc.client.query_node = failing_cancelled
    tok = qdl.set_current_deadline(dl)
    try:
        with pytest.raises(qdl.DeadlineExceededError):
            lc.query("i", "Count(Row(f=1))", cache=False)
    finally:
        qdl.reset_current_deadline(tok)
        lc.client.query_node = orig


def test_deadline_rederived_on_remote_legs():
    lc = LocalCluster(3, device="cpu")
    data = _data()
    _seed(lc, FieldOptions, data, replicated=False)
    seen = []
    for cn in lc.nodes[1:]:
        orig_handle = cn.handle_query

        def spying(index, query, shards, remote, _orig=orig_handle):
            seen.append(qdl.current_deadline())
            return _orig(index, query, shards, remote)

        cn.handle_query = spying
    coordinator_dl = qdl.Deadline(timeout=60)
    tok = qdl.set_current_deadline(coordinator_dl)
    try:
        got = lc.query("i", "Count(Row(f=1))", cache=False)
    finally:
        qdl.reset_current_deadline(tok)
    assert got == _single_node(data).execute("i", "Count(Row(f=1))")
    assert seen
    for dl in seen:
        assert dl is not None and dl is not coordinator_dl
        assert dl.expires_at == pytest.approx(coordinator_dl.expires_at)


def test_write_fanout_down_replica_counted_and_marked_dirty():
    lc = LocalCluster(2, replica_n=2, device="cpu")
    lc.create_index("i")
    lc.create_field("i", "f")
    stats = lc[0].cluster.stats = MemoryStats()
    lc.down("node1")
    lc.query("i", "Set(3, f=1)")
    assert stats.counter_value("cluster.replica_write_skipped") == 1
    assert ("i", 0) in lc[0].cluster.dirty_shards.drain()
    lc.up("node1")
    lc.query("i", "Set(4, f=1)")
    assert stats.counter_value("cluster.replica_write_skipped") == 1
    assert len(lc[0].cluster.dirty_shards) == 0


def test_keys_on_a_cluster_are_not_ported():
    """Keyed queries on a cluster raised NotPortedError until translate
    sync was ported; now the coordinator allocates for every node and a
    key names one id through each."""
    lc = LocalCluster(2, device="cpu")
    lc.create_index("k")
    lc.create_field("k", "f", FieldOptions(keys=True))
    assert lc.query("k", 'Row(f="a")')[0].columns().tolist() == []
    lc.query("k", 'Set(3, f="a")', node=1)
    for node in range(2):
        assert lc.query("k", 'Row(f="a")', node=node)[0].columns().tolist() == [3]
    assert lc[1].translator("k", "f", ["a", "b"]) == lc[0].translator("k", "f", ["a", "b"])
