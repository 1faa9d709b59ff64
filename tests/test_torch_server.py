"""The port's HTTP edge against the JAX node's, over real sockets.

A JAX ``ServerNode`` (planner on) and a port ``ServerNode(device="cpu")``
boot side by side. The same schema goes into both over HTTP, and the same
seeded bits and values through ``POST /index/i/field/{f}/import``: 3
shards, dense and sparse rows (tests/test_torch_executor.py's data) and
three int fields (tests/test_torch_bsi.py's). Then every read query of
both files, Set/Clear followed by reads, the schema and export routes and
the 404/409/400 error cases must answer with equal statuses and
byte-identical bodies. The QoS statuses (504, 503 + Retry-After), inline
profiles, metrics, the routes the port answers 501, the traffic
harness's ``AttachedTarget`` and 8 concurrent clients are checked too.

The JAX node pins its value import to the host path: rows its device
transpose adopts are read-only, and a later ``Set`` on them fails inside
the JAX package.
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pilosa_tpu import cli as j_cli
from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.exec import ingest_transpose as j_ingest_transpose
from pilosa_tpu.loadgen.target import AttachedTarget
from pilosa_tpu.server.httpd import _build_routes as j_build_routes
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu_torch import cli
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.server import ServerNode as TServerNode
from pilosa_tpu_torch.server.httpd import _build_routes as t_build_routes
from test_torch_bsi import INT_FIELDS
from test_torch_bsi import QUERIES as BSI_QUERIES
from test_torch_bsi import _filter_bits, _values
from test_torch_executor import READ_QUERIES, _bits

ROOT = Path(__file__).resolve().parent.parent
SEED = 5


class Client:
    """One keep-alive HTTP/1.1 connection."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def __call__(self, method: str, path: str, body=None, headers=None):
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
        self.conn.request(method, path, body=body, headers=headers or {})
        r = self.conn.getresponse()
        return r.status, r.read(), r.headers

    def close(self):
        self.conn.close()


def _load(client: Client) -> None:
    """Schema and data over HTTP, identically into either node."""
    bits = _bits(SEED)
    values = _values(SEED)
    fcols = np.concatenate([_filter_bits(SEED), values["v"][0][::3]])
    assert client("POST", "/index/i")[0] == 200
    for field in ("f", "g"):
        assert client("POST", f"/index/i/field/{field}")[0] == 200
    for name, (lo, hi) in INT_FIELDS.items():
        opts = {"options": {"type": "int", "min": int(lo), "max": int(hi)}}
        assert client("POST", f"/index/i/field/{name}", opts)[0] == 200
    for field, (rows, cols) in bits.items():
        req = {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()}
        assert client("POST", f"/index/i/field/{field}/import", req)[0] == 200
    req = {"rowIDs": [1] * len(fcols), "columnIDs": fcols.tolist()}
    assert client("POST", "/index/i/field/f/import", req)[0] == 200
    for name, (cols, vals) in values.items():
        req = {"columnIDs": cols.tolist(), "values": vals.tolist()}
        assert client("POST", f"/index/i/field/{name}/import", req)[0] == 200


@pytest.fixture(scope="module")
def nodes():
    """(JAX node, port node, JAX client, port client), loaded."""
    j_ingest_transpose.set_mode("off")
    jn = JServerNode(bind="127.0.0.1:0", ingest_transpose="off")
    tn = TServerNode(bind="127.0.0.1:0", device="cpu")
    jn.open()
    tn.open()
    jc, tc = Client(jn.port), Client(tn.port)
    _load(jc)
    _load(tc)
    yield jn, tn, jc, tc
    jc.close()
    tc.close()
    jn.close()
    tn.close()
    j_ingest_transpose.set_mode("auto")


def _same(nodes, method, path, body=None, headers=None):
    """Both nodes' (status, body); asserts they are equal and returns them."""
    _, _, jc, tc = nodes
    want = jc(method, path, body, headers)[:2]
    got = tc(method, path, body, headers)[:2]
    assert got == want
    return want


@pytest.mark.parametrize("query", READ_QUERIES + BSI_QUERIES)
def test_query_parity(nodes, query):
    status, body = _same(nodes, "POST", "/index/i/query", query)
    assert status == 200, body


@pytest.mark.parametrize("path", [
    "/schema", "/index", "/index/i", "/status", "/info", "/version",
    "/internal/shards/max", "/index/i/field/f/views", "/index/i/field/v/views",
])
def test_get_parity(nodes, path):
    status, body = _same(nodes, "GET", path)
    assert status == 200, body


def test_schema_shape(nodes):
    """The schema holds both field types with the JAX package's key order
    (IndexOptions, then FieldOptions by type)."""
    _, _, _, tc = nodes
    doc = json.loads(tc("GET", "/schema")[1])
    (idx,) = doc["indexes"]
    assert list(idx) == ["name", "options", "fields"]
    by_name = {f["name"]: f["options"] for f in idx["fields"]}
    assert list(by_name["f"]) == ["type", "cacheType", "cacheSize", "keys"]
    assert list(by_name["v"]) == ["type", "base", "bitDepth", "min", "max", "keys"]


@pytest.mark.parametrize("field", ["f", "g", "v", "_exists"])
@pytest.mark.parametrize("shard", [0, 1, 2])
def test_export_parity(nodes, field, shard):
    status, body = _same(nodes, "GET",
                         f"/export?index=i&field={field}&shard={shard}")
    if field == "v":  # no standard view
        assert status == 404
    else:
        assert status == 200 and body.count(b"\n") > 0


ERROR_CASES = [
    ("POST", "/index/i", None, 409),
    ("POST", "/index/i/field/f", None, 409),
    ("GET", "/index/nope", None, 404),
    ("DELETE", "/index/nope", None, 404),
    ("DELETE", "/index/i/field/nope", None, 404),
    ("POST", "/index/nope/field/f", None, 404),
    ("POST", "/index/nope/query", "Row(f=0)", 404),
    ("POST", "/index/i/query", "Row(nope=0)", 404),
    ("POST", "/index/i/query", "Count(Row(nope=1))", 404),
    ("POST", "/index/i/field/nope/import", {"rowIDs": [1], "columnIDs": [1]}, 404),
    ("GET", "/index/i/field/nope/views", None, 404),
    ("GET", "/export?index=i&field=f&shard=99", None, 404),
    ("GET", "/no/such/route", None, 404),
    ("POST", "/index/i/query", "Row(f=0", 400),
    ("POST", "/index/i/query", "Bogus(f=0)", 400),
    ("POST", "/index/i/query", "Count(Row(f=0), Row(g=0))", 400),
    ("POST", "/index/i/query", "Sum(Row(f=1))", 400),
    ("POST", "/index/i/query", "Row(f > 3)", 400),
    ("POST", "/index/Bad", None, 400),
    ("POST", "/index/i/field/Bad", None, 400),
    ("POST", "/index/i/field/bad", {"options": {"type": "int", "min": 5, "max": 1}}, 400),
    ("POST", "/index/i/field/f/import", {"bogus": [1]}, 400),
    ("POST", "/index/i/field/v/import", {"columnIDs": [1], "values": [5000]}, 400),
    ("POST", "/index/i/field/v/import", {"columnIDs": [1], "values": [-5000]}, 400),
    ("GET", "/internal/fragment/nodes?index=i", None, 400),
]


@pytest.mark.parametrize("method,path,body,status", ERROR_CASES,
                         ids=[f"{m} {p} {b}" for m, p, b, _ in ERROR_CASES])
def test_error_parity(nodes, method, path, body, status):
    got_status, got_body = _same(nodes, method, path, body)
    assert got_status == status, got_body
    assert "error" in json.loads(got_body)


def test_writes_then_reads(nodes):
    """Set/Clear over HTTP on a second index, then reads: the same
    answers, byte for byte, on both nodes."""
    _, _, jc, tc = nodes
    bits = _bits(SEED + 1)
    for c in (jc, tc):
        assert c("POST", "/index/w")[0] == 200
        for field in ("f", "g"):
            assert c("POST", f"/index/w/field/{field}")[0] == 200
        assert c("POST", "/index/w/field/v",
                 {"options": {"type": "int", "min": -1100, "max": 1000}})[0] == 200
        rows, cols = bits["f"]
        assert c("POST", "/index/w/field/f/import",
                 {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})[0] == 200
    c2 = 2 * SHARD_WIDTH + 17
    writes = (f"Set(5, f=7) Set(5, f=7) Set({c2}, f=7) Set(9, g=5) "
              f"Clear(5, f=7) Clear(5, f=7) Clear(11, f=8) Set({c2}, f=8) "
              f"Set({c2}, f=0) Clear(3, g=0) Set(5, v=7) Set(5, v=-7) "
              f"Set({c2}, v=1000) Clear(5, v=0)")
    reads = ("Row(f=7) Count(Row(f=8)) Count(Row(g=5)) Count(Row(f=0)) "
             "TopN(f, n=3) TopN(f, Row(g=5), n=3) Sum(field=v) Min(field=v) "
             "Max(field=v) Count(Row(v > 0))")
    for q in (reads, writes, reads, writes, reads):
        status, body = _same(nodes, "POST", "/index/w/query", q)
        assert status == 200, body
    for i in range(3):  # a write per request, each read back at once
        _same(nodes, "POST", "/index/w/query", f"Set({100 + i}, f=9)")
        status, body = _same(nodes, "POST", "/index/w/query", "Count(Row(f=9))")
        assert json.loads(body) == {"results": [i + 1]}
    _same(nodes, "GET", "/export?index=w&field=f&shard=2")
    _same(nodes, "GET", "/index/w")
    # Field and view deletion: a recreated field starts empty.
    _same(nodes, "DELETE", "/index/w/field/v/view/bsig_v")
    _same(nodes, "POST", "/index/w/query", "Sum(field=v)")
    _same(nodes, "DELETE", "/index/w/field/g")
    _same(nodes, "POST", "/index/w/field/g")
    _same(nodes, "POST", "/index/w/query", "Count(Row(g=0)) Count(Row(g=5))")
    _same(nodes, "DELETE", "/index/w")
    _same(nodes, "GET", "/schema")


def test_recreated_field_reads_its_own_bits(nodes):
    """A field deleted and recreated over HTTP, then loaded with one import
    like the first one (so its fragments reach the same generations): the
    planner must not serve the old field's cached stacks. (The JAX node's
    MeshPlanner does, and answers 4 here: a reference fault, ROADMAP.md
    Queue 3, so this checks the port against the bits alone.)"""
    _, _, _, tc = nodes

    def load(cols):
        assert tc("POST", "/index/d/field/f")[0] == 200
        assert tc("POST", "/index/d/field/f/import",
                  {"rowIDs": [1] * len(cols), "columnIDs": cols})[0] == 200

    assert tc("POST", "/index/d")[0] == 200
    load([1, 2, 3, SHARD_WIDTH + 1])
    q = "Count(Row(f=1)) Count(Intersect(Row(f=1), Row(f=1)))"
    assert tc("POST", "/index/d/query", q)[1] == b'{"results": [4, 4]}\n'
    assert tc("DELETE", "/index/d/field/f")[0] == 200
    load([7, SHARD_WIDTH + 2])
    assert tc("POST", "/index/d/query", q)[1] == b'{"results": [2, 2]}\n'
    assert tc("DELETE", "/index/d")[0] == 200


def test_api_status_and_hosts(nodes):
    jn, tn, _, _ = nodes
    assert tn.api.status() == jn.api.status()
    assert tn.api.hosts() == jn.api.hosts()


def test_post_schema_parity(nodes):
    """A schema dump applied to both nodes (new index, a new field on an
    existing one) reads back the same."""
    _, _, jc, _ = nodes
    doc = json.loads(jc("GET", "/schema")[1])
    (idx,) = [i for i in doc["indexes"] if i["name"] == "i"]
    copy = dict(idx, name="s")
    extra = {"name": "i", "options": idx["options"],
             "fields": [{"name": "z", "options": {"type": "int", "min": -5, "max": 9}}]}
    status, _ = _same(nodes, "POST", "/schema", {"indexes": [copy, extra]})
    assert status == 200
    _same(nodes, "GET", "/index/s")
    _same(nodes, "GET", "/index/i")
    for path in ("/index/s", "/index/i/field/z"):
        assert _same(nodes, "DELETE", path)[0] == 200


def test_expired_deadline_is_504(nodes):
    _, _, jc, tc = nodes
    hdr = {"X-Deadline": f"{time.time() - 1:.6f}"}
    for c in (jc, tc):
        status, body, _ = c("POST", "/index/i/query", "Count(Row(f=0))", hdr)
        assert (status, json.loads(body)) == (504, {"error": "query deadline exceeded"})


def test_deadline_mid_query_stops_between_steps(nodes, monkeypatch):
    """A deadline that expires during the first call stops the query at
    the next step: 504, not the first call's partial result."""
    _, tn, _, tc = nodes
    ex = tn.executor
    real = ex._execute_call

    def slow_call(*args, **kwargs):
        out = real(*args, **kwargs)
        time.sleep(0.3)
        return out

    monkeypatch.setattr(ex, "_execute_call", slow_call)
    hdr = {"X-Deadline": f"{time.time() + 0.15:.6f}"}
    status, body, _ = tc("POST", "/index/i/query", "Count(Row(f=0)) Count(Row(g=0))", hdr)
    assert status == 504, body


def test_profile_inline_has_the_same_keys(nodes):
    _, _, jc, tc = nodes
    docs = []
    for c in (jc, tc):
        status, body, _ = c("POST", "/index/i/query?profile=true",
                            "Count(Intersect(Row(f=0), Row(g=0)))")
        assert status == 200
        docs.append(json.loads(body))
    assert docs[0]["results"] == docs[1]["results"]
    assert set(docs[0]["profile"]) == set(docs[1]["profile"])


@pytest.mark.parametrize("path", ["/metrics", "/debug/vars", "/debug/queries",
                                  "/debug/slow-queries", "/debug/overload",
                                  "/debug/threads", "/debug/profile?seconds=0.1"])
def test_observability_routes_answer(nodes, path):
    _, _, jc, tc = nodes
    for c in (jc, tc):
        status, body, _ = c("GET", path)
        assert status == 200 and body
    if path == "/metrics":
        assert 'pilosa_qos_service_seconds_count{class="interactive"}' in body.decode()
    if path in ("/debug/overload", "/debug/slow-queries", "/debug/queries"):
        assert (set(json.loads(jc("GET", path)[1]))
                == set(json.loads(body)))


def test_fragment_nodes_names_this_node(nodes):
    _, tn, _, tc = nodes
    status, body, _ = tc("GET", "/internal/fragment/nodes?index=i&shard=1")
    assert status == 200
    assert json.loads(body) == [{"id": tn.id, "uri": {
        "scheme": "http", "host": "127.0.0.1", "port": tn.port},
        "isCoordinator": True}]


def test_routes_mirror_the_jax_table(nodes):
    """Same patterns, methods and order as the JAX node's table (its
    streaming import route is matched ahead of the table there)."""
    jn, tn, _, _ = nodes
    j = [(p.pattern, sorted(m)) for p, m in j_build_routes(jn.api)]
    t = [(p.pattern, sorted(m)) for p, m in t_build_routes(tn.api)]
    assert t == j


def _served(path: str) -> bool:
    return path in {
        "/", "/index", "/index/{index}/query", "/index/{index}/field/{field}/import",
        "/index/{index}/field/{field}/views", "/index/{index}/field/{field}/view/{view}",
        "/index/{index}/field/{field}", "/index/{index}", "/export", "/schema",
        "/status", "/info", "/version", "/metrics", "/debug/vars",
        "/debug/queries/{trace}", "/debug/queries", "/debug/slow-queries",
        "/debug/overload", "/debug/threads", "/debug/profile",
        "/recalculate-caches", "/internal/fragment/nodes", "/internal/shards/max",
        "/index/{index}/field/{field}/import-roaring/{shard}", "/debug/quarantine",
        "/debug/heap", "/debug/cache", "/internal/attr/blocks", "/internal/attr/data",
        "/debug/device", "/backup", "/backup/status", "/restore", "/restore/status",
        "/internal/backup/keys", "/internal/backup/fragment", "/debug/backup",
        "/debug/translate", "/internal/translate/keys", "/internal/translate/entries",
        *_CLUSTER_ROUTES}


#: the cluster's serving routes: 501 until the cluster slice (ROADMAP.md
#: Queue 1 item 6a), served since.
_CLUSTER_ROUTES = {
    "/debug/membership", "/internal/availability", "/internal/cluster/message",
    "/internal/index/{index}/field/{field}/remote-available-shards/{shard}",
    "/internal/import", "/internal/nodes", "/internal/probe", "/internal/query-mux"}


def _cluster_routes():
    """(method, concrete path) of every cluster serving route."""
    jn_api = type("A", (), {"chaos_faults": False})()
    out = []
    for p, methods in j_build_routes(jn_api):
        path = re.sub(r"\(\?P<(\w+)>[^)]*\)", r"{\1}", p.pattern[1:-1])
        if path in _CLUSTER_ROUTES:
            concrete = re.sub(r"\{\w+\}", "3", path)
            out += [(m, concrete) for m in sorted(methods)]
    return out


def _unported_routes():
    """(method, concrete path) of every route the port answered 501 until
    the elastic half of the cluster slice (resize, fragment block sync and
    the PTS1 import stream)."""
    jn_api = type("A", (), {"chaos_faults": False})()
    out = []
    for p, methods in j_build_routes(jn_api):
        path = re.sub(r"\(\?P<(\w+)>[^)]*\)", r"{\1}", p.pattern[1:-1])
        if _served(path):
            continue
        concrete = re.sub(r"\{\w+\}", "3", path)
        out += [(m, concrete) for m in sorted(methods)]
    return out + [("POST", "/internal/import-stream")]


def _keyed_index(nodes) -> None:
    """Index ``kx`` (keyed) with keyed set field ``kf`` in both nodes, bits
    imported by row and column keys (idempotent: a second call's creates
    answer 409 on both nodes alike)."""
    _same(nodes, "POST", "/index/kx", {"options": {"keys": True}})
    _same(nodes, "POST", "/index/kx/field/kf", {"options": {"keys": True}})
    rng = np.random.default_rng(SEED)
    req = {"rowKeys": [f"r{i}" for i in rng.integers(0, 20, 500)],
           "columnKeys": [f"c{i}" for i in rng.integers(0, 300, 500)]}
    assert _same(nodes, "POST", "/index/kx/field/kf/import", req)[0] == 200


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/debug/translate", None),
    ("POST", "/internal/translate/keys", {"index": "kx", "field": "kf",
                                          "keys": ["r3", "new-row", "r7"]}),
    ("GET", "/internal/translate/entries?index=kx&field=kf&after=5", None),
    ("GET", "/internal/translate/entries?index=kx&after=0", None),
    ("POST", "/index/kx/query", 'Count(Row(kf="r1")) TopN(kf, n=4) Row(kf="r2")'),
])
def test_translate_routes_parity(nodes, method, path, body):
    """The key-translation routes answered 501 until the keys-and-sketches
    slice; now their bodies equal the JAX node's on the same keyed data."""
    _keyed_index(nodes)
    status, got = _same(nodes, method, path, body)
    assert status == 200, got


@pytest.mark.parametrize("method,path", _cluster_routes())
def test_cluster_routes_serve(nodes, method, path):
    """The cluster's serving routes answered 501 until the cluster slice;
    on a standalone node they now answer as the JAX node's do, status and
    body (a standalone node's membership, availability and nodes, a
    malformed mux envelope's 400, a routed import without an index)."""
    jn, tn, _, _ = nodes
    got = []
    for port in (jn.port, tn.port):
        # Fresh connections: a malformed stream's 400 closes its connection.
        client = Client(port)
        try:
            got.append(client(method, path, b"{}" if method == "POST" else None)[:2])
        finally:
            client.close()
    assert got[1] == got[0]
    assert got[1][0] != 501, got[1]


@pytest.mark.parametrize("method,path", _unported_routes())
def test_unported_routes_answer_501(nodes, method, path):
    """These routes answered 501 until the elastic cluster was ported; on a
    standalone node they now answer as the JAX node's do, status and body
    (the resize state at rest, a standalone node refusing a removal, a
    malformed block request, a malformed import stream's 400)."""
    jn, tn, _, _ = nodes
    got = []
    for port in (jn.port, tn.port):
        # Fresh connections: a malformed stream's 400 closes its connection.
        client = Client(port)
        try:
            got.append(client(method, path, b"{}" if method == "POST" else None)[:2])
        finally:
            client.close()
    assert got[1] == got[0]
    assert got[1][0] != 501, got[1]


def test_unported_query_features_answer_501(nodes):
    """Remote legs (ROADMAP.md Queue 1 item 6a), MinRow, GroupBy and time
    fields (item 4a), and keys and sketches (item 5) answered 501 until
    their slices and now answer as the JAX node does, byte for byte: a
    remote leg's tagged JSON envelope, Count(Distinct) and SimilarTopN
    over the loaded data, a keyed index created over HTTP, a time field
    created on an index of its own, bits imported with timestamps, a
    window read."""
    _, _, jc, tc = nodes
    for q in ("Row(f=0)", "Count(Row(f=1)) TopN(f, n=3) Sum(field=v)"):
        # Each node stamps its own shard-epoch counters (the packages bump
        # them at different points): the same shards, any values.
        path = "/index/i/query?remote=true&shards=0,1"
        (js, jb, _), (ts, tb, _) = jc("POST", path, q), tc("POST", path, q)
        want, got = json.loads(jb), json.loads(tb)
        assert js == ts == 200, tb
        assert set(got.pop("shardEpochs")) == set(want.pop("shardEpochs")) == {"0", "1"}
        assert got == want
    for q in ("Count(Distinct(field=v))", "Count(Distinct(Row(f=1), field=v))",
              "SimilarTopN(f, Row(g=0), n=3)"):
        status, body = _same(nodes, "POST", "/index/i/query", q)
        assert status == 200, (q, body)
    assert _same(nodes, "POST", "/index/k", {"options": {"keys": True}})[0] == 200
    for path, q in (("/index/i/query", "MinRow(field=f)"),
                    ("/index/i/query?columnAttrs=true", "GroupBy(Rows(f))")):
        status, body = _same(nodes, "POST", path, q)
        assert status == 200, (path, q, body)
    assert _same(nodes, "POST", "/index/tq")[0] == 200
    status, body = _same(nodes, "POST", "/index/tq/field/t",
                         {"options": {"type": "time", "timeQuantum": "YMD"}})
    assert status == 200, body
    stamps = [1577836800 + 86400 * d for d in range(40)]  # 2020-01-01 on
    req = {"rowIDs": [0] * 40, "columnIDs": list(range(0, 4000, 100)),
           "timestamps": stamps}
    assert _same(nodes, "POST", "/index/tq/field/t/import", req)[0] == 200
    status, body = _same(nodes, "POST", "/index/tq/query",
                         "Row(t=0, from='2020-01-05T00:00', to='2020-02-03T00:00')")
    assert status == 200 and len(json.loads(body)["results"][0]["columns"]) == 29
    assert _same(nodes, "DELETE", "/index/tq")[0] == 200


def test_recalculate_and_exclude_columns(nodes):
    _same(nodes, "POST", "/recalculate-caches")
    status, body = _same(nodes, "POST", "/index/i/query?excludeColumns=true",
                         "Row(f=0) Count(Row(f=0))")
    assert json.loads(body)["results"][0] == {"attrs": {}, "columns": []}


def test_shed_is_503_with_retry_after():
    """One slot, no queue, the slot held: both nodes shed with 503 and
    the same Retry-After."""
    jn = JServerNode(bind="127.0.0.1:0", use_planner=False,
                     qos_max_concurrent=1, qos_max_queue=0)
    tn = TServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False,
                     qos_max_concurrent=1, qos_max_queue=0)
    answers = []
    try:
        for n in (jn, tn):
            n.open()
            c = Client(n.port)
            assert c("POST", "/index/i")[0] == 200
            assert c("POST", "/index/i/field/f")[0] == 200
            n.qos.acquire("interactive")
            try:
                status, body, headers = c("POST", "/index/i/query", "Count(Row(f=0))")
            finally:
                n.qos.release()
            answers.append((status, body, headers["Retry-After"]))
            assert c("POST", "/index/i/query", "Count(Row(f=0))")[:2] == (
                200, b'{"results": [0]}\n')
            c.close()
    finally:
        jn.close()
        tn.close()
    assert answers[0] == answers[1]
    assert answers[1][0] == 503 and int(answers[1][2]) >= 1


def test_attached_target_drives_the_port():
    """The traffic harness's HTTP target works on a port node unchanged,
    its trace id resolving to the retained profile."""
    tn = TServerNode(bind="127.0.0.1:0", device="cpu")
    tn.open()
    try:
        _drive_attached(tn)
    finally:
        tn.close()


def _drive_attached(tn):
    t = AttachedTarget([tn.address])
    t.create_index("lg")
    t.create_field("lg", "f")
    t.create_field("lg", "v", {"type": "int", "min": 0, "max": 1000})
    t.import_bits("lg", "f", [1, 1, 2], [10, SHARD_WIDTH + 3, 10])
    t.import_stream([{"index": "lg", "field": "v", "columnIDs": [10, 11],
                      "values": [5, 7]}])
    out = t.query("lg", "Count(Row(f=1))", qos_class="batch", tenant="t1",
                  trace_id="feedc0de")
    assert (out.status, out.code) == ("ok", 200)
    assert t.query("lg", "Row(f=").code == 400
    assert t.query("nope", "Row(f=1)").code == 404
    assert t.resolve_profile("feedc0de")["traceId"] == "feedc0de"
    assert "pilosa_qos_service_seconds_count" in t.metrics_text()
    assert "counters" in t.debug_vars()
    assert tn.api.query("lg", "Count(Row(f=1)) Sum(field=v)") == {
        "results": [2, {"value": 12, "count": 2}]}


CONCURRENT_QUERIES = [
    "Count(Intersect(Row(f=0), Row(g=0)))",
    "TopN(f, Row(g=0), n=5)",
    "Sum(Row(f=1), field=v)",
    "Count(Row(v > 5))",
    "Union(Row(f=3), Row(g=1))",
    "Min(field=x)",
]


def test_eight_clients_agree_with_serial(nodes):
    _, tn, _, tc = nodes
    serial = {q: tc("POST", "/index/i/query", q)[:2] for q in CONCURRENT_QUERIES}
    errors = []

    def client(k):
        c = Client(tn.port)
        try:
            for i in range(12):
                q = CONCURRENT_QUERIES[(k + i) % len(CONCURRENT_QUERIES)]
                got = c("POST", "/index/i/query", q)[:2]
                if got != serial[q]:
                    errors.append((q, got))
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    _join_all(threads)
    assert not errors


def test_writes_racing_reads_see_the_epoch():
    """Clients writing new bits while others read the count: every reader
    sees a count that never falls (within a query and across its queries),
    and the final count is every write.
    The planner's cached stacks revalidate on the index epoch."""
    tn = TServerNode(bind="127.0.0.1:0", device="cpu")
    tn.open()
    try:
        c = Client(tn.port)
        for path in ("/index/r", "/index/r/field/f"):
            assert c("POST", path)[0] == 200
        q = "Count(Row(f=9)) Count(Intersect(Row(f=9), Row(f=9)))"
        n_writers, per_writer = 4, 15
        errors, done = [], threading.Event()

        def writer(k):
            wc = Client(tn.port)
            for i in range(per_writer):
                col = (k * per_writer + i) * (SHARD_WIDTH // 7)
                if wc("POST", "/index/r/query", f"Set({col}, f=9)")[:2] != (
                        200, b'{"results": [true]}\n'):
                    errors.append(("write", k, i))
            wc.close()

        def reader():
            rc, last = Client(tn.port), 0
            while not done.is_set():
                # The second call runs after the first, so it may see more.
                a, b = json.loads(rc("POST", "/index/r/query", q)[1])["results"]
                if not last <= a <= b:
                    errors.append(("read", last, a, b))
                last = b
            rc.close()

        readers = [threading.Thread(target=reader) for _ in range(4)]
        writers = [threading.Thread(target=writer, args=(k,)) for k in range(n_writers)]
        for t in readers + writers:
            t.start()
        _join_all(writers)
        done.set()
        _join_all(readers)
        assert not errors
        assert json.loads(c("POST", "/index/r/query", q)[1])["results"] == [
            n_writers * per_writer] * 2
        c.close()
    finally:
        tn.close()


def _join_all(threads, timeout=120.0):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_misses_share_one_build():
    """8 queries missing the same cold stack at once: one build, one
    upload, one tensor for all; a failed build lets a waiter build."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.parallel import Planner

    h = Holder(device="cpu")
    h.create_index("i").create_field("f").import_bits([1, 1], [3, SHARD_WIDTH + 5])
    planner, idx = Planner(h), h.index("i")
    builds, out = [], []
    fail = [True]

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        if fail[0]:
            fail[0] = False
            raise RuntimeError("first build fails")
        return torch.zeros(2, 4, dtype=torch.int32)

    def query():
        try:
            out.append(planner._cached(idx, "f", "standard", 1, (0, 1), build))
        except RuntimeError:
            out.append(None)

    threads = [threading.Thread(target=query) for _ in range(8)]
    for t in threads:
        t.start()
    _join_all(threads)
    assert len(builds) == 2 and planner.uploads == 1
    assert out.count(None) == 1
    assert len({id(t) for t in out if t is not None}) == 1


def test_launch_counts_exact_under_threads():
    """8 threads counting launches with the interpreter switching threads
    every microsecond: a lost increment would show."""
    kernels.reset_launches()

    def bump():
        for _ in range(20000):
            kernels._count_launch("pair_count")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.LAUNCHES["pair_count"] == 8 * 20000
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())


def test_node_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TServerNode(bind="127.0.0.1:0")
    with pytest.raises(RuntimeError):
        cli.main(["server", "--bind", "127.0.0.1:0"])


@pytest.mark.parametrize("argv", [
    ["--chaos-faults"],
    ["--join", "127.0.0.1:1"],
    ["--scrub-interval", "1"],
    ["--trace-endpoint", "http://127.0.0.1:1"],
    ["--ingest-max-inflight-mb", "64"],
])
def test_cli_refuses_unported_flags(monkeypatch, argv):
    """The flags the CLI refused until their features were ported (the
    elastic cluster's, then ``--trace-endpoint``) reach ServerNode with the
    values the JAX CLI gives its node."""
    from pilosa_tpu.server import node as j_node_mod
    from pilosa_tpu_torch.server import node as t_node_mod

    keys = ("chaos_faults", "join", "scrub_interval", "ingest_max_inflight_mb",
            "anti_entropy_interval", "trace_endpoint")
    for k in keys:
        monkeypatch.delenv(f"PILOSA_TPU_{k.upper()}", raising=False)

    def node_kwargs(cli_mod, node_mod, argv):
        seen = {}

        class Stop(Exception):
            pass

        def fake(**kw):
            seen.update(kw)
            raise Stop()

        monkeypatch.setattr(node_mod, "ServerNode", fake)
        with pytest.raises(Stop):
            cli_mod.main(["server", *argv])
        return {k: seen[k] for k in keys}

    got = node_kwargs(cli, t_node_mod, ["--device", "cpu", *argv])
    assert got == node_kwargs(j_cli, j_node_mod, argv)


@pytest.mark.parametrize("argv,kwargs", [
    (["--backup-interval", "1"], {"backup_interval": 1.0}),
    (["--archive-url", "x"], {"archive_url": "x"}),
    (["--backup-full-every", "3"], {"backup_full_every": 3}),
    (["--backup-keep-chains", "5"], {"backup_keep_chains": 5}),
    (["--ingest-transpose", "on"], {"ingest_transpose": "on"}),
    (["--translate-planes", "on"], {"translate_planes": "on"}),
    (["--sketch-precision", "10"], {"sketch_precision": 10}),
    (["--sketch-exact-threshold", "7"], {"sketch_exact_threshold": 7}),
    (["--peers", "127.0.0.1:1,127.0.0.1:2", "--replica-n", "2"],
     {"peers": ["127.0.0.1:1", "127.0.0.1:2"], "replica_n": 2}),
    (["--breaker-threshold", "3", "--breaker-cooldown", "2.5"],
     {"breaker_threshold": 3, "breaker_cooldown": 2.5}),
    (["--hedge", "off", "--hedge-delay-ms", "7", "--hedge-budget-pct", "9"],
     {"hedge": False, "hedge_delay_ms": 7.0, "hedge_budget_pct": 9.0}),
    (["--fence-stale-reads"], {"fence_stale_reads": True}),
    (["--device-reduce", "on", "--multiplex", "off"],
     {"device_reduce": "on", "multiplex": False}),
    (["--tls-ca-cert", "ca.pem", "--tls-skip-verify"],
     {"tls_ca_cert": "ca.pem", "tls_skip_verify": True}),
])
def test_cli_accepts_ported_flags(monkeypatch, argv, kwargs):
    """The backup flags, ``--ingest-transpose`` and the keys-and-sketches
    flags (refused until that slice) reach ServerNode with the values the
    JAX CLI gives its node."""
    from pilosa_tpu.server import node as j_node_mod
    from pilosa_tpu_torch.server import node as t_node_mod

    for k in kwargs:
        monkeypatch.delenv(f"PILOSA_TPU_{k.upper()}", raising=False)

    def node_kwargs(cli_mod, node_mod, argv):
        seen = {}

        class Stop(Exception):
            pass

        def fake(**kw):
            seen.update(kw)
            raise Stop()

        monkeypatch.setattr(node_mod, "ServerNode", fake)
        with pytest.raises(Stop):
            cli_mod.main(["server", *argv])
        return {k: seen[k] for k in kwargs}

    got = node_kwargs(cli, t_node_mod, ["--device", "cpu", *argv])
    assert got == kwargs == node_kwargs(j_cli, j_node_mod, argv)


def test_cli_server_runs_and_stops():
    """``python -m pilosa_tpu_torch.cli server --device cpu`` serves until
    SIGTERM and exits 0."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PILOSA_TPU_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--device", "cpu",
         "--bind", "127.0.0.1:0"],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        m = re.search(r"serving at http://127\.0\.0\.1:(\d+) on cpu", line)
        assert m, line
        c = Client(int(m.group(1)))
        assert c("POST", "/index/i")[0] == 200
        assert c("POST", "/index/i/query", "Count(Row(f=0))")[0] == 404
        c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
