"""Keys on a cluster in the port (pilosa_tpu_torch/cluster/translate_sync.py
and the executor's and API's translator hook) against the JAX package's:
ids a keyed cluster gives the same allocation sequence through different
nodes equal the JAX cluster's, keyed query bodies equal the JAX cluster's,
the six drills of tests/test_translate_replication.py on the port, and a
replica's device key plane (``PILOSA_TPU_TRANSLATE_PLANES=on``) answering
the coordinator's ids after ``sync_translation``, stale or not, never a
wrong one."""

import json
import socket
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cluster.harness import LocalCluster as JLocalCluster
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.index import IndexOptions as JIndexOptions
from pilosa_tpu.exec.result import result_to_json as j_json
from pilosa_tpu_torch.cluster.harness import LocalCluster
from pilosa_tpu_torch.cluster.translate_sync import sync_translation
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.exec import keyplane
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.server.node import ServerNode

SEED = 53


def _mk_keyed_cluster(n=3, planner=False):
    lc = LocalCluster(n, device="cpu",
                      planner_factory=(lambda i: (lambda h: Planner(h))) if planner else None)
    lc.create_index("k", IndexOptions(keys=True))
    lc.create_field("k", "f", FieldOptions(keys=True))
    return lc


def _mk_jax_keyed_cluster(n=3):
    lc = JLocalCluster(n)
    lc.create_index("k", JIndexOptions(keys=True))
    lc.create_field("k", "f", JFieldOptions(keys=True))
    return lc


def test_ids_match_jax_for_the_same_allocation_sequence():
    rng = np.random.default_rng(SEED)
    seq = [(int(rng.integers(0, 3)), None if rng.random() < 0.4 else "f",
            [f"key{int(x)}" for x in rng.integers(0, 400, int(rng.integers(1, 40)))])
           for _ in range(60)]
    tl, jl = _mk_keyed_cluster(), _mk_jax_keyed_cluster()
    for node, field, keys in seq:
        got = tl.nodes[node].translator("k", field, keys)
        assert got == jl.nodes[node].translator("k", field, keys)
    assert tl.sync_translation() == jl.sync_translation()
    for node in range(3):
        for field in (None, "f"):
            t_store = (tl[node].holder.index("k").translate_store if field is None
                       else tl[node].holder.field("k", field).translate_store)
            j_store = (jl[node].holder.index("k").translate_store if field is None
                       else jl[node].holder.field("k", field).translate_store)
            assert t_store.entries_since(0) == j_store.entries_since(0)


KEYED_QUERIES = ['Count(Row(f="r1"))', 'Row(f="r2")', 'Count(Union(Row(f="r1"), Row(f="r3")))',
                 'TopN(f, n=3)', 'Rows(f)']


def test_keyed_bodies_match_jax_through_every_node():
    rng = np.random.default_rng(SEED + 1)
    writes = [(int(rng.integers(0, 3)), f'Set("c{int(c)}", f="r{int(r)}")')
              for c, r in zip(rng.integers(0, 200, 120), rng.integers(0, 5, 120))]
    tl, jl = _mk_keyed_cluster(planner=True), _mk_jax_keyed_cluster()
    for node, q in writes:
        assert tl.nodes[node].executor.execute("k", q) == \
            jl.nodes[node].executor.execute("k", q)
    for node in range(3):
        for q in KEYED_QUERIES:
            got = result_to_json(tl.query("k", q, node=node, cache=False))
            assert got == j_json(jl.query("k", q, node=node, cache=False)), (node, q)


# -- tests/test_translate_replication.py on the port ---------------------------

def test_same_key_same_id_any_node():
    lc = _mk_keyed_cluster()
    ids = [lc.nodes[i].translator("k", "f", ["alpha", "beta"]) for i in range(3)]
    assert ids[0] == ids[1] == ids[2]
    cids = [lc.nodes[i].translator("k", None, ["c1", "c2"]) for i in range(3)]
    assert cids[0] == cids[1] == cids[2]
    a = lc.nodes[1].translator("k", "f", ["gamma"])[0]
    b = lc.nodes[2].translator("k", "f", ["delta"])[0]
    assert a != b


def test_query_via_any_node_consistent():
    lc = _mk_keyed_cluster()
    lc.nodes[1].executor.execute("k", 'Set("c1", f="r1")')
    lc.nodes[2].executor.execute("k", 'Set("c2", f="r1")')
    lc.nodes[0].executor.execute("k", 'Set("c3", f="r2")')
    for i in range(3):
        assert lc.nodes[i].executor.execute("k", 'Count(Row(f="r1"))') == [2]
        assert lc.nodes[i].executor.execute("k", 'Count(Row(f="r2"))') == [1]


def test_reverse_translation_after_sync():
    lc = _mk_keyed_cluster()
    lc.nodes[1].executor.execute("k", 'Set("c9", f="r9")')
    lc.sync_translation()
    for cn in lc.nodes:
        idx = cn.holder.index("k")
        f = idx.field("f")
        rid = f.translate_store.translate_key("r9", create=False)
        cid = idx.translate_store.translate_key("c9", create=False)
        assert rid is not None and cid is not None
        assert f.translate_store.translate_id(rid) == "r9"
        assert idx.translate_store.translate_id(cid) == "c9"
    (row,) = lc.nodes[2].executor.execute("k", 'Row(f="r9")')
    assert row.keys == ["c9"]


def test_coordinator_down_existing_keys_still_resolve():
    lc = _mk_keyed_cluster()
    lc.nodes[1].translator("k", "f", ["seen"])
    lc.down("node0")
    assert lc.nodes[1].translator("k", "f", ["seen"]) is not None
    with pytest.raises(ConnectionError):
        lc.nodes[1].translator("k", "f", ["never-seen"])


def test_http_cluster_translation():
    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    addrs = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    nodes = [ServerNode(bind=a, peers=[x for x in addrs if x != a], device="cpu",
                        anti_entropy_interval=0.0, check_nodes_interval=0.0)
             for a in addrs]
    for n in nodes:
        n.open()
    try:
        coord, other = min(addrs), max(addrs)
        coord_node = next(n for n in nodes if n.id == coord)
        other_node = next(n for n in nodes if n.id == other)

        def post(addr, path, body=""):
            r = urllib.request.Request(f"http://{addr}{path}", data=body.encode(),
                                       method="POST")
            return json.loads(urllib.request.urlopen(r, timeout=10).read() or b"{}")

        post(other, "/index/k", json.dumps({"options": {"keys": True}}))
        post(other, "/index/k/field/f", json.dumps({"options": {"keys": True}}))
        post(other, "/index/k/query", 'Set("c1", f="r1")')
        post(coord, "/index/k/query", 'Set("c2", f="r1")')
        # An import by keys through the replica allocates on the coordinator.
        post(other, "/index/k/field/f/import",
             json.dumps({"rowKeys": ["r2", "r2"], "columnKeys": ["c1", "c3"]}))
        for addr in addrs:
            assert post(addr, "/index/k/query", 'Count(Row(f="r1"))') == {"results": [2]}
            assert post(addr, "/index/k/query", 'Count(Row(f="r2"))') == {"results": [2]}
        f_coord = coord_node.holder.index("k").field("f")
        f_other = other_node.holder.index("k").field("f")
        rid = f_coord.translate_store.translate_key("r1", create=False)
        assert rid is not None
        assert f_other.translate_store.translate_key("r1", create=False) == rid
        coord_node.api.translate_keys("k", "f", ["coord-only"])
        applied = sync_translation(other_node.holder, other_node.cluster,
                                   other_node.cluster.client)
        assert applied >= 1
        assert f_other.translate_store.translate_key("coord-only", create=False) == \
            f_coord.translate_store.translate_key("coord-only", create=False)
    finally:
        for n in nodes:
            n.close()


def test_watermark_pull_fills_gaps():
    coord = TranslateStore()
    for k in ("a", "b", "c", "d"):
        coord.translate_key(k)
    replica = TranslateStore()
    replica.apply_entries([(4, "d")])
    assert replica.max_id() == 4
    assert replica.replication_watermark() == 0
    replica.apply_entries(coord.entries_since(replica.replication_watermark()))
    for k in ("a", "b", "c", "d"):
        assert replica.translate_key(k, create=False) == coord.translate_key(k, create=False)
    assert replica.replication_watermark() == 4


# -- a replica's device key plane ---------------------------------------------

def test_replica_key_plane_answers_the_coordinators_ids(monkeypatch):
    """Under ``on`` the replica's plane is built from its synced store and
    rebuilt in line when stale; every id it gives is the coordinator's, and
    a key only the coordinator knows goes to the coordinator (a plane miss,
    never a local allocation)."""
    monkeypatch.setenv("PILOSA_TPU_TRANSLATE_PLANES", "on")
    assert keyplane.mode() == "on"
    lc = _mk_keyed_cluster(2, planner=True)
    keys = [f"row{i}" for i in range(300)]
    coord_ids = lc[0].translator("k", "f", keys)
    assert lc.sync_translation() == len(keys)
    replica = lc[1]
    idx = replica.holder.index("k")
    store = idx.field("f").translate_store
    assert replica.executor.keyplanes.lookup(idx, "f", store, keys) == coord_ids
    batches = replica.executor.keyplanes.device_batches
    union = "Count(Union(" + ", ".join(f'Row(f="{k}")' for k in keys) + "))"
    assert replica.executor.execute("k", union) == [0]
    assert replica.executor.keyplanes.device_batches > batches
    # The coordinator allocates more; the replica's plane is stale until it
    # syncs, and the new keys reach it through the coordinator.
    more = [f"row{i}" for i in range(300, 600)]
    more_ids = lc[0].translator("k", "f", more)
    assert replica.executor._resolve_keys(idx, idx.field("f"), keys + more) == \
        coord_ids + more_ids
    lc.sync_translation()
    assert replica.executor.keyplanes.lookup(idx, "f", store, keys + more) == \
        coord_ids + more_ids
    assert lc[0].translator("k", "f", ["row1", "row599"]) == [coord_ids[1], more_ids[-1]]
