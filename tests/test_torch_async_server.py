"""The async path at the port's HTTP edge and CLI, against the JAX node.

- ``GET /debug/device`` answers the JAX node's key set (the residency
  classes the port does not build read zero);
- ``/debug/vars`` carries the planner's launch counters
  (``planner.dispatchCount``, ``dispatchCoalesced``,
  ``coalesceBatchWidth``) and the prefetch counters;
- the five flags ``--dispatch-coalesce``, ``--dispatch-coalesce-us``,
  ``--inline-transfer``, ``--prefetch``, ``--compile-cache-dir`` and their
  TOML keys reach ``ServerNode`` as the JAX CLI's do;
- 8 concurrent clients: with ``dispatch_coalesce="off"`` every body is
  byte-identical to the JAX node's and the launches (the planner's
  dispatch count) equal the serial sum; with ``"auto"`` the bodies are
  the same and the launches at most the serial sum.
"""

import json
import threading

import pytest

from pilosa_tpu import cli as j_cli
from pilosa_tpu.exec import ingest_transpose as j_ingest_transpose
from pilosa_tpu.server import node as j_node_mod
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu_torch import cli as t_cli
from pilosa_tpu_torch.parallel import coalesce
from pilosa_tpu_torch.server import ServerNode as TServerNode
from pilosa_tpu_torch.server import node as t_node_mod
from test_torch_server import Client, _load

#: the concurrent mix: a Count, a BSI aggregate, a filtered TopN, repeated
#: and varied so same-plan waves form.
MIX = ["Count(Intersect(Row(f=1), Row(g=2)))", "Count(Intersect(Row(f=3), Row(g=1)))",
       "Count(Row(f=2))", "Sum(Row(f=1), field=v)", "TopN(f, Row(g=2), n=3)",
       "Count(Union(Row(f=1), Row(g=1), Row(f=4)))"]
PATH = "/index/i/query?noCache=true"


@pytest.fixture(scope="module")
def nodes():
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
    coalesce.set_mode("auto")


def _keys(doc, prefix=""):
    """Every key path of a JSON object, histogram buckets aside."""
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and not k.endswith("_hist"):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_debug_device_has_the_jax_keys(nodes):
    jn, tn, jc, tc = nodes
    for c in (jc, tc):
        assert c("POST", PATH, "Count(Row(f=1))")[0] == 200
    js, jbody, _ = jc("GET", "/debug/device")
    ts, tbody, _ = tc("GET", "/debug/device")
    assert js == ts == 200
    jdoc, tdoc = json.loads(jbody), json.loads(tbody)
    # The port's own key beside the JAX node's: kernel launch counts.
    port_only = {k for k in _keys(tdoc) if k.split(".")[0] == "launches"}
    assert port_only >= {"launches", "launches.pair_count"}
    assert _keys(tdoc) - port_only == _keys(jdoc)
    assert tdoc["enabled"] is True and tdoc["dispatches"] >= 1
    assert set(tdoc["class_bytes"]) == set(jdoc["class_bytes"])
    assert tdoc["class_bytes"]["packed"] == 0
    assert tdoc["class_bytes"]["dense"] == tdoc["bytes"]


def test_debug_vars_carry_the_planner_counters(nodes):
    jn, tn, jc, tc = nodes
    for _ in range(2):
        assert tc("POST", PATH, "Count(Row(g=1))")[0] == 200
    doc = json.loads(tc("GET", "/debug/vars")[1])
    assert doc["counters"]["planner.dispatchCount"] >= 2
    assert "planner.coalesceBatchWidth" in doc["gauges"]
    assert any(k.startswith("planner.prefetch") for k in doc["counters"])
    jdoc = json.loads(jc("GET", "/debug/vars")[1])
    assert "planner.dispatchCount" in jdoc["counters"]


_FLAGS = ["--dispatch-coalesce", "off", "--dispatch-coalesce-us", "75",
          "--inline-transfer", "on", "--prefetch", "off",
          "--compile-cache-dir", "/nowhere/cache"]
_TOML = ('dispatch-coalesce = "on"\ndispatch-coalesce-us = 20.0\n'
         'inline-transfer = "off"\nprefetch = "off"\n'
         'compile-cache-dir = "/nowhere/toml-cache"\n')
_KNOBS = ("dispatch_coalesce", "dispatch_coalesce_us", "inline_transfer", "prefetch",
          "compile_cache_dir")


def _node_kwargs(cli_mod, node_mod, monkeypatch, argv):
    seen = {}

    class Stop(Exception):
        pass

    def fake(**kw):
        seen.update(kw)
        raise Stop()

    monkeypatch.setattr(node_mod, "ServerNode", fake)
    with pytest.raises(Stop):
        cli_mod.main(["server", *argv])
    return {k: seen[k] for k in _KNOBS}


@pytest.mark.parametrize("how", ["flags", "toml", "defaults"])
def test_cli_takes_the_async_flags(monkeypatch, tmp_path, how):
    """The five knobs reach ServerNode from flags and from TOML keys with
    the JAX CLI's values and defaults."""
    for k in _KNOBS:
        monkeypatch.delenv(f"PILOSA_TPU_{k.upper()}", raising=False)
    argv = {"flags": _FLAGS, "defaults": []}.get(how)
    if argv is None:
        cfg = tmp_path / "node.toml"
        cfg.write_text(_TOML)
        argv = ["--config", str(cfg)]
    got = _node_kwargs(t_cli, t_node_mod, monkeypatch, ["--device", "cpu", *argv])
    want = _node_kwargs(j_cli, j_node_mod, monkeypatch, argv)
    assert got == want
    if how == "flags":
        assert got == {"dispatch_coalesce": "off", "dispatch_coalesce_us": 75.0,
                       "inline_transfer": "on", "prefetch": "off",
                       "compile_cache_dir": "/nowhere/cache"}


def _serial(tc, tn):
    """Each mix query's body and dispatch count, run alone."""
    out = {}
    planner = tn.executor.planner
    for q in MIX:
        d0 = planner.dispatches
        status, body, _ = tc("POST", PATH, q)
        assert status == 200, body
        out[q] = (body, planner.dispatches - d0)
    return out


def _clients(port, n_clients, per_client):
    """Bodies by query from ``n_clients`` threads on their own connections."""
    got, lock = [], threading.Lock()

    def run(k):
        c = Client(port)
        try:
            for i in range(per_client):
                q = MIX[(k + i) % len(MIX)]
                status, body, _ = c("POST", PATH, q)
                with lock:
                    got.append((q, status, body))
        finally:
            c.close()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return got


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_concurrent_clients_coalesce_modes(nodes, mode):
    jn, tn, jc, tc = nodes
    serial = _serial(tc, tn)
    for q in MIX:
        assert serial[q][0] == jc("POST", PATH, q)[1], q
    coalesce.set_mode(mode)
    planner = tn.executor.planner
    d0 = planner.dispatches
    got = _clients(tn.port, 8, 6)
    launched = planner.dispatches - d0
    want = sum(serial[q][1] for q, _, _ in got)
    assert len(got) == 48
    for q, status, body in got:
        assert status == 200 and body == serial[q][0], q
    if mode == "off":
        assert launched == want
    else:
        assert launched <= want
