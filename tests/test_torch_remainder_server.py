"""The executor remainder over HTTP, and in data dirs, against the JAX
package.

- A JAX ``ServerNode`` and a port ``ServerNode(device="cpu")`` take the
  same schema and bits over HTTP (imports add the existence row), then the
  same request sequence: ``Not``/``Shift``/``Rows``/``Options`` reads,
  ``SetRowAttrs``/``SetColumnAttrs``/``Store``/``ClearRow`` writes, Row
  bodies with their attrs, ``?columnAttrs=true``, ``?excludeRowAttrs=
  true``, ``Options(columnAttrs=true)``, ``GET /debug/cache`` and
  ``/internal/attr/blocks`` and ``/internal/attr/data``: equal statuses
  and byte-identical bodies.
- A data dir written through either package's executor after ``Store``,
  ``ClearRow`` and ``SetRowAttrs`` reopens in the other with byte-equal
  rows and attrs.
"""

import json
import os
import shutil

import pytest

from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import ingest_transpose as j_ingest_transpose
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu.storage.diskstore import DiskStore as JDiskStore
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.server import ServerNode as TServerNode
from pilosa_tpu_torch.storage import DiskStore as TDiskStore
from test_torch_executor import _bits
from test_torch_server import Client

SEED = 9

#: (method, path, body) in order; every step is compared on both nodes.
STEPS = [
    ("POST", "/index/i/query", "Count(Not(Row(f=0)))"),
    ("POST", "/index/i/query", "Not(Union(Row(f=4), Row(g=1)))"),
    ("POST", "/index/i/query", "Count(Intersect(Shift(Row(f=0), n=33), Row(g=0)))"),
    ("POST", "/index/i/query", "Shift(Row(f=5), n=40)"),
    ("POST", "/index/i/query", "Count(Intersect(Row(f=0), Row(f=1), Row(g=0)))"),
    ("POST", "/index/i/query", "Rows(f) Rows(f, limit=2) Rows(g, previous=0)"),
    ("POST", "/index/i/query", "Options(Rows(f), shards=[1])"),
    ("POST", "/index/i/query", "Options(Count(Row(f=0)), shards=[0, 2])"),
    ("POST", "/index/i/query", "TopN(f, Row(g=0), n=4, tanimotoThreshold=1)"),
    ("POST", "/index/i/query",
     'SetRowAttrs(f, 3, color="blue", weight=3) SetRowAttrs(f, 4, color="red")'),
    ("POST", "/index/i/query",
     f'SetColumnAttrs(9, name="bob") SetColumnAttrs({SHARD_WIDTH + 2}, n=1)'),
    ("POST", "/index/i/query", "Row(f=3) Row(f=4) Count(Row(f=3))"),
    ("POST", "/index/i/query?excludeRowAttrs=true", "Row(f=3)"),
    ("POST", "/index/i/query?columnAttrs=true", "Row(f=3) Union(Row(f=5), Row(g=1))"),
    ("POST", "/index/i/query", "Options(Row(f=5), columnAttrs=true)"),
    ("POST", "/index/i/query", 'TopN(f, n=3, attrName="color", attrValues=["red"])'),
    ("POST", "/index/i/query", "Store(Intersect(Row(f=0), Row(g=0)), f=7)"),
    ("POST", "/index/i/query", "Count(Row(f=7)) Rows(f)"),
    ("POST", "/index/i/query", "ClearRow(f=7) ClearRow(f=7) Count(Row(f=7))"),
    ("POST", "/index/i/query", "Store(Row(v > 0), v=1)"),
    ("POST", "/index/i/query", "Count(Row(f=0)) Count(Row(f=0))"),
    ("POST", "/index/i/query?noCache=true", "Count(Row(f=0))"),
    ("GET", "/debug/cache", None),
    ("GET", "/internal/attr/blocks?index=i&field=f", None),
    ("GET", "/internal/attr/blocks?index=i", None),
    ("GET", "/internal/attr/data?index=i&field=f&block=0", None),
    ("GET", f"/internal/attr/data?index=i&block={(SHARD_WIDTH + 2) // 100}", None),
    ("GET", "/internal/attr/blocks?index=nope", None),
    ("GET", "/internal/attr/blocks?index=i&field=nope", None),
]


@pytest.fixture(scope="module")
def nodes():
    """(JAX client, port client), each node loaded over HTTP."""
    j_ingest_transpose.set_mode("off")
    jn = JServerNode(bind="127.0.0.1:0", ingest_transpose="off")
    tn = TServerNode(bind="127.0.0.1:0", device="cpu")
    jn.open()
    tn.open()
    clients = [Client(jn.port), Client(tn.port)]
    for c in clients:
        assert c("POST", "/index/i")[0] == 200
        for field in ("f", "g"):
            assert c("POST", f"/index/i/field/{field}")[0] == 200
        assert c("POST", "/index/i/field/v",
                 {"options": {"type": "int", "min": -10, "max": 10}})[0] == 200
        for field, (rows, cols) in _bits(SEED).items():
            req = {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()}
            assert c("POST", f"/index/i/field/{field}/import", req)[0] == 200
    yield clients
    for c in clients:
        c.close()
    jn.close()
    tn.close()
    j_ingest_transpose.set_mode("auto")


def test_request_sequence_is_byte_identical(nodes):
    jc, tc = nodes
    for method, path, body in STEPS:
        want = jc(method, path, body)[:2]
        got = tc(method, path, body)[:2]
        assert got == want, (method, path, body)
        if "nope" not in path and "v > 0" not in (body or ""):
            assert want[0] == 200, (path, want)


def test_debug_cache_when_disabled():
    jn = JServerNode(bind="127.0.0.1:0", use_planner=False, result_cache_mb=0)
    tn = TServerNode(bind="127.0.0.1:0", device="cpu", use_planner=False,
                     result_cache_mb=0)
    jn.open()
    tn.open()
    try:
        jc, tc = Client(jn.port), Client(tn.port)
        assert tc("GET", "/debug/cache")[:2] == jc("GET", "/debug/cache")[:2] == (
            200, b'{"enabled": false}\n')
        assert tn.executor.result_cache is None
        jc.close()
        tc.close()
    finally:
        jn.close()
        tn.close()


WRITES = ('SetRowAttrs(f, 2, color="blue") SetColumnAttrs(3, n=1) '
          'Store(Intersect(Row(f=0), Row(g=0)), f=7) ClearRow(f=5) '
          f'Store(Row(g=1), g=9) ClearRow(g=9) Set({SHARD_WIDTH + 3}, g=9)')


def _write(pkg: str, d: str, crash_tail: bool = False):
    """The executor writes of WRITES through one package's DiskStore,
    after the executor tests' bits (snapshotted); then closed (snapshots
    again) or, with ``crash_tail``, left in the WAL."""
    if pkg == "jax":
        h, store_cls, ex_cls = JHolder(), JDiskStore, JExecutor
    else:
        h, store_cls = THolder(device="cpu"), TDiskStore
        ex_cls = lambda h: TExecutor(h, planner=Planner(h))  # noqa: E731
    store = store_cls(d, h)
    store.open()
    idx = h.create_index("i")
    for field, (rows, cols) in _bits(SEED).items():
        idx.create_field(field).import_bits(rows, cols)
    store.flush()
    assert ex_cls(h).execute("i", WRITES)[:6] == [None, None, True, True, True, True]
    if crash_tail:
        store.save_schema()
        for idx in h.indexes.values():  # attrs persist with the flush
            idx.column_attr_store.save()
            for f in idx.fields.values():
                f.row_attr_store.save()
    else:
        store.close()


def _rows_and_attrs(h) -> dict:
    out = {}
    for fname, f in h.index("i").fields.items():
        out[(fname, "attrs")] = {r: f.row_attr_store.attrs(r) for r in range(12)}
        for vname, v in f.views.items():
            for shard, frag in v.fragments.items():
                for rid in sorted(frag.rows):
                    out[(fname, vname, shard, rid)] = frag.row_words(rid).tobytes()
    out["columns"] = {c: h.index("i").column_attr_store.attrs(c) for c in range(5)}
    return out


def _files(root: str, ext: str) -> dict:
    out = {}
    for r, _, fs in os.walk(root):
        for fn in fs:
            if fn.endswith(ext):
                p = os.path.join(r, fn)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_store_and_clear_row_log_the_same_wal(tmp_path):
    """Store's setRow and ClearRow's removeBatch records, byte for byte."""
    d = {pkg: str(tmp_path / pkg) for pkg in ("jax", "port")}
    for pkg in d:
        _write(pkg, d[pkg], crash_tail=True)
    wals = {pkg: _files(d[pkg], ".wal") for pkg in d}
    assert wals["jax"] == wals["port"]
    assert sum(len(b) > 0 for b in wals["port"].values()) >= 6


@pytest.mark.parametrize("crash_tail", [False, True], ids=["closed", "wal"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_data_dir_after_writes_crosses_packages(tmp_path, writer, reader,
                                                crash_tail):
    src = str(tmp_path / "src")
    _write(writer, src, crash_tail)
    got = {}
    for pkg in (writer, reader):
        d = str(tmp_path / pkg)
        shutil.copytree(src, d)
        h = JHolder() if pkg == "jax" else THolder(device="cpu")
        store = (JDiskStore if pkg == "jax" else TDiskStore)(d, h)
        store.open()
        got[pkg] = _rows_and_attrs(h)
        store.close()
    assert got[reader] == got[writer]
    assert got[reader][("f", "attrs")][2] == {"color": "blue"}
    assert got[reader]["columns"][3] == {"n": 1}
    assert os.path.exists(os.path.join(src, "i", "f", "row_attrs.jsonl"))


def test_warmup_replays_the_observed_traffic(tmp_path):
    """A node with a data dir saves the query shapes its planner saw to
    warmup.json at close; the next boot's warmup replays them."""
    d = str(tmp_path / "data")
    tn = TServerNode(bind="127.0.0.1:0", device="cpu", data_dir=d)
    tn.open()
    c = Client(tn.port)
    for path in ("/index/i", "/index/i/field/f", "/index/i/field/g"):
        assert c("POST", path)[0] == 200
    c("POST", "/index/i/query", f"Set(3, f=1) Set(3, g=2) Set({SHARD_WIDTH}, f=1)")
    q = "Count(Intersect(Row(f=1), Row(g=2), Not(Row(f=2))))"
    assert c("POST", "/index/i/query", q)[1] == b'{"results": [1]}\n'
    c.close()
    tn.close()
    with open(os.path.join(d, "warmup.json")) as fh:
        saved = json.load(fh)
    assert [e["query"] for e in saved["entries"]] == [q]
    tn = TServerNode(bind="127.0.0.1:0", device="cpu", data_dir=d,
                     qos_warmup="count", qos_warmup_shards="1,2")
    tn.open()
    try:
        assert tn.warmup.done.wait(120)
        assert tn.warmup.errors == 0 and tn.warmup.replayed == 1
        assert tn.warmup.queries_run == 2 * 6 + 1
        assert not tn.executor.planner._plan_cache  # scratch plans dropped
    finally:
        tn.close()


def test_cli_takes_the_executor_flags(monkeypatch):
    """The flags of the executor remainder reach ServerNode."""
    from pilosa_tpu_torch import cli
    from pilosa_tpu_torch.server import node as node_mod

    seen = {}

    class Stop(Exception):
        pass

    def fake(**kw):
        seen.update(kw)
        raise Stop()

    monkeypatch.setattr(node_mod, "ServerNode", fake)
    with pytest.raises(Stop):
        cli.main(["server", "--device", "cpu", "--qos-warmup", "count",
                  "--qos-warmup-shards", "1,4", "--plan-buckets", "none",
                  "--result-cache-mb", "0", "--result-cache-ttl", "2.5",
                  "--dispatch-fuse", "off"])
    assert {k: seen[k] for k in ("qos_warmup", "qos_warmup_shards", "plan_buckets",
                                 "result_cache_mb", "result_cache_ttl",
                                 "dispatch_fuse")} == {
        "qos_warmup": "count", "qos_warmup_shards": "1,4", "plan_buckets": "none",
        "result_cache_mb": 0, "result_cache_ttl": 2.5, "dispatch_fuse": "off"}
