"""The persistence half of the HTTP edge, against the JAX node's.

A JAX ``ServerNode`` and a port ``ServerNode(device="cpu")``, each with
its own ``data_dir``, take the same schema, the same ``import-roaring``
bodies (one per field and shard) and the same JSON value import; both are
closed (flushed) and reopened on their dirs, and every parity query must
then answer byte-identically on both, with the same ``/debug/heap`` shape.
A corrupted snapshot gives byte-identical ``/debug/quarantine`` and 503
bodies (the quarantine clock frozen, the data dir at the same path).
"""

import http.client
import json
import shutil
import tracemalloc

import numpy as np
import pytest

from pilosa_tpu import native as j_native
from pilosa_tpu.exec import ingest_transpose as j_ingest_transpose
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu.storage import quarantine as j_quarantine
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.server import ServerNode as TServerNode
from pilosa_tpu_torch.storage import quarantine as t_quarantine
from pilosa_tpu_torch.storage.faults import corrupt_file

N_SHARDS = 3
SEED = 13

QUERIES = [
    "Row(f=1)",
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Union(Row(f=3), Row(g=2))",
    "TopN(g, Row(f=1), n=4)",
    "TopN(f, n=3)",
    "Sum(field=v)",
    "Min(Row(f=1), field=v)",
    "Max(field=v)",
    "Count(Row(v > 100))",
    "Row(-50 <= v <= 50)",
]


class Client:
    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def __call__(self, method, path, body=None):
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
        self.conn.request(method, path, body=body)
        r = self.conn.getresponse()
        return r.status, r.read()

    def close(self):
        self.conn.close()


def _bodies():
    """(field, shard, roaring body) for every fragment of f and g: f row 1
    dense in shard 0, rows 1-4 sparse elsewhere; g rows 0-5."""
    rng = np.random.default_rng(SEED)
    out = []
    for field, n_rows in (("f", 5), ("g", 6)):
        for shard in range(N_SHARDS):
            n = 40000 if (field, shard) == ("f", 0) else 2000
            rows = rng.integers(1 if field == "f" else 0, n_rows, n).astype(np.uint64)
            if n == 40000:
                rows[:] = 1
            local = rng.integers(0, SHARD_WIDTH, n).astype(np.uint64)
            pos = np.unique(rows * np.uint64(SHARD_WIDTH) + local)
            out.append((field, shard, j_native.encode_roaring(pos)))
    return out


def _load(c: Client) -> list:
    """Schema, roaring imports and a value import; returns the statuses
    and bodies of every write."""
    out = [c("POST", "/index/i"), c("POST", "/index/i/field/f"),
           c("POST", "/index/i/field/g"),
           c("POST", "/index/i/field/v",
             {"options": {"type": "int", "min": -1000, "max": 1000}})]
    for field, shard, body in _bodies():
        out.append(c("POST", f"/index/i/field/{field}/import-roaring/{shard}", body))
    rng = np.random.default_rng(SEED + 1)
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, 3000, replace=False)
    vals = rng.integers(-1000, 1001, 3000)
    out.append(c("POST", "/index/i/field/v/import",
                 {"columnIDs": cols.tolist(), "values": vals.tolist()}))
    # a clear through the same route, and the error answers
    field, shard, body = _bodies()[4]
    out.append(c("POST", f"/index/i/field/{field}/import-roaring/{shard}?clear=true",
                 j_native.encode_roaring(j_native.decode_roaring(body)[:100])))
    out.append(c("POST", "/index/i/field/nope/import-roaring/0", body))
    out.append(c("POST", "/index/nope/field/f/import-roaring/0", body))
    out.append(c("POST", "/index/i/field/f/import-roaring/0", b"\xff" * 8))
    return out


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """(JAX node, port node, their clients, the load answers), loaded over
    HTTP, closed and reopened on their data dirs."""
    j_ingest_transpose.set_mode("off")
    base = tmp_path_factory.mktemp("persist")
    jd, td = str(base / "jax"), str(base / "port")

    def boot():
        jn = JServerNode(bind="127.0.0.1:0", ingest_transpose="off",
                         data_dir=jd, scrub_interval=0)
        tn = TServerNode(bind="127.0.0.1:0", device="cpu", data_dir=td)
        jn.open()
        tn.open()
        return jn, tn

    jn, tn = boot()
    jc, tc = Client(jn.port), Client(tn.port)
    loads = (_load(jc), _load(tc))
    jc.close()
    tc.close()
    jn.close()
    tn.close()
    jn, tn = boot()
    jc, tc = Client(jn.port), Client(tn.port)
    yield jn, tn, jc, tc, loads
    jc.close()
    tc.close()
    jn.close()
    tn.close()
    j_ingest_transpose.set_mode("auto")


def test_import_roaring_answers_match(nodes):
    """Every write answered alike: 200s, then 404 (field), 404 (index),
    400 (a body that is not roaring), byte for byte."""
    *_, (j_loads, t_loads) = nodes
    assert t_loads == j_loads
    assert [s for s, _ in t_loads[-3:]] == [404, 404, 400]
    assert all(s == 200 for s, _ in t_loads[:-3])


@pytest.mark.parametrize("query", QUERIES)
def test_reopened_query_parity(nodes, query):
    _, _, jc, tc, _ = nodes
    want = jc("POST", "/index/i/query", query)
    got = tc("POST", "/index/i/query", query)
    assert got == want
    assert got[0] == 200, got


@pytest.mark.parametrize("path", ["/schema", "/internal/shards/max",
                                  "/index/i/field/v/views", "/debug/quarantine"])
def test_reopened_get_parity(nodes, path):
    _, _, jc, tc, _ = nodes
    want = jc("GET", path)
    assert tc("GET", path) == want
    assert want[0] == 200


def test_export_after_reopen(nodes):
    _, _, jc, tc, _ = nodes
    for shard in range(N_SHARDS):
        path = f"/export?index=i&field=g&shard={shard}"
        assert tc("GET", path) == jc("GET", path)


def test_debug_heap_same_keys(nodes):
    """The same keys as the JAX node's /debug/heap, in both tracemalloc
    states, and equal per-index host-row accounting after the reload."""
    _, _, jc, tc, _ = nodes
    was_tracing = tracemalloc.is_tracing()
    try:
        tracemalloc.stop()
        j0 = json.loads(jc("GET", "/debug/heap?top=5")[1])  # starts tracing
        tracemalloc.stop()
        t0 = json.loads(tc("GET", "/debug/heap?top=5")[1])
        j1 = json.loads(jc("GET", "/debug/heap?top=5")[1])
        t1 = json.loads(tc("GET", "/debug/heap?top=5")[1])
    finally:
        if not was_tracing:
            tracemalloc.stop()
    for j, t in ((j0, t0), (j1, t1)):
        assert sorted(t) == sorted(j)
        assert sorted(t["tracemalloc"]) == sorted(j["tracemalloc"])
        assert sorted(t["native_pool"]) == sorted(j["native_pool"])
    assert t0["tracemalloc"]["tracing"] == "started"
    assert t1["tracemalloc"]["tracing"] == "on" and len(t1["tracemalloc"]["top"]) <= 5
    assert t1["host_rows"] == j1["host_rows"]
    assert t1["host_rows"]["i"]["fragments"] == 3 * N_SHARDS + N_SHARDS


class _FrozenClock:
    @staticmethod
    def time():
        return 1_700_000_000.0


def test_quarantine_and_503_bodies_match(tmp_path, monkeypatch):
    """The same corrupted data dir, at the same path, in a JAX node and
    then a port node: /debug/quarantine, the 503 of a query over the
    shard, and a query that avoids it answer byte for byte alike."""
    monkeypatch.setattr(j_quarantine, "time", _FrozenClock)
    monkeypatch.setattr(t_quarantine, "time", _FrozenClock)
    template = str(tmp_path / "template")
    n = TServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False,
                    data_dir=template)
    n.open()
    c = Client(n.port)
    for path in ("/index/i", "/index/i/field/f"):
        c("POST", path)
    c("POST", "/index/i/query", f"Set(3, f=1) Set({SHARD_WIDTH + 4}, f=1)")
    c.close()
    n.close()
    corrupt_file(f"{template}/i/f/standard/1.snap", "bitflip")

    run = str(tmp_path / "run")
    answers = []
    for make in (lambda: JServerNode(bind="127.0.0.1:0", use_planner=False,
                                     data_dir=run, scrub_interval=0),
                 lambda: TServerNode(bind="127.0.0.1:0", device="cpu",
                                     use_planner=False, data_dir=run)):
        shutil.copytree(template, run)
        node = make()
        node.open()
        c = Client(node.port)
        try:
            answers.append([c("GET", "/debug/quarantine"),
                            c("POST", "/index/i/query", "Count(Row(f=1))"),
                            c("POST", "/index/i/query?shards=0", "Row(f=1)")])
        finally:
            c.close()
            node.close()
            shutil.rmtree(run)
    assert answers[1] == answers[0]
    quarantine, corrupt, other = answers[1]
    assert json.loads(quarantine[1])["count"] == 1
    assert corrupt[0] == 503 and b"quarantined" in corrupt[1]
    assert other == (200, b'{"results": [{"attrs": {}, "columns": [3]}]}\n')


def test_schema_is_durable_before_the_first_flush(tmp_path):
    """A node that dies before it ever flushed: the port wrote schema.json
    when the index and field were created, so a reopened store finds the
    field and replays its WAL. The JAX node writes the schema only when it
    flushes or deletes, so the same acknowledged bits are lost there
    (reference fault, ROADMAP.md Queue 3)."""
    from pilosa_tpu.core import Holder as JHolder
    from pilosa_tpu.storage.diskstore import DiskStore as JDiskStore
    from pilosa_tpu_torch.core import Holder as THolder
    from pilosa_tpu_torch.storage import DiskStore as TDiskStore

    found = {}
    for pkg, make, holder, store_cls in (
            ("jax", lambda d: JServerNode(bind="127.0.0.1:0", use_planner=False,
                                          data_dir=d, scrub_interval=0),
             JHolder, JDiskStore),
            ("port", lambda d: TServerNode(bind="127.0.0.1:0", device="cpu",
                                           use_planner=False, data_dir=d),
             lambda: THolder(device="cpu"), TDiskStore)):
        d = str(tmp_path / pkg)
        node = make(d)
        node.open()
        c = Client(node.port)
        for path in ("/index/i", "/index/i/field/f"):
            assert c("POST", path)[0] == 200
        assert c("POST", "/index/i/query", "Set(5, f=1)")[0] == 200
        c.close()
        # The process dies here: nothing flushed, the WAL record written.
        h = holder()
        store = store_cls(d, h)
        store.open()
        frag = h.fragment("i", "f", "standard", 0)
        found[pkg] = frag is not None and frag.contains(1, 5)
        store.close()
        node.close()
    assert found == {"jax": False, "port": True}
