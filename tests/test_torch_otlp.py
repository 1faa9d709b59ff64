"""The port's OTLP/HTTP trace exporter (pilosa_tpu_torch/obs/otlp.py)
against the JAX package's: the same payload, byte for byte, for the same
spans; a collector double receiving batches with their structure and
parentage; a collector that is down never raising (tests/test_obs.py's
cases); and ``trace_endpoint`` on port nodes: one cluster query's spans on
the coordinator and the peer leg arrive under one trace id."""

import http.server
import json
import os
import socket
import threading
import time
import urllib.request

import pytest

from pilosa_tpu.obs import tracing as j_tracing
from pilosa_tpu.obs.otlp import OTLPTracer as JOTLPTracer
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.obs import NopTracer, get_tracer, set_tracer, tracing
from pilosa_tpu_torch.obs.otlp import OTLPTracer
from pilosa_tpu_torch.server.node import ServerNode


class Collector:
    """An OTLP/HTTP collector double on loopback: keeps each POSTed body."""

    def __init__(self):
        self.received: list[dict] = []
        received = self.received

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                received.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_port}/v1/traces"

    def spans(self) -> list[dict]:
        return [(rs["resource"]["attributes"][0]["value"]["stringValue"], s)
                for batch in self.received for rs in batch["resourceSpans"]
                for ss in rs["scopeSpans"] for s in ss["spans"]]

    def close(self):
        self.srv.shutdown()


@pytest.fixture
def collector():
    c = Collector()
    yield c
    c.close()


def _spans(tracer_cls, endpoint):
    tr = tracer_cls(endpoint=endpoint, service_name="test-node", flush_interval=60.0)
    parent = tr.start_span("Executor.Execute")
    parent.set_tag("index", "i")
    parent.set_tag("shards", 16)
    child = tr.start_span("planner.count", parent_id=parent.span_id)
    child.finish()
    parent.finish()
    return tr


def test_payload_matches_jax_for_the_same_spans(monkeypatch, collector):
    """Span ids and clocks pinned: both exporters POST the same bytes."""
    bodies = []
    for cls in (JOTLPTracer, OTLPTracer):
        ids = iter(bytes([i]) * 8 for i in range(1, 100))
        clock = iter(range(1_000, 100_000, 7))
        monkeypatch.setattr(os, "urandom", lambda n: next(ids)[:n])
        monkeypatch.setattr(time, "time_ns", lambda: next(clock))
        toks = [(t, t.set_current_trace("trace-7")) for t in (j_tracing, tracing)]
        try:
            tr = _spans(cls, collector.url)
        finally:
            for t, tok in toks:
                t.reset_current_trace(tok)
        monkeypatch.undo()
        bodies.append(tr._payload(tr._buf))
        tr.flush()
        assert tr.exported == 2 and tr.dropped == 0
        tr.close()
    assert bodies[0] == bodies[1]
    assert collector.received[0] == collector.received[1] == json.loads(bodies[1])


def test_exporter_against_collector_double(collector):
    tr = _spans(OTLPTracer, collector.url)
    tr.flush()
    assert tr.exported == 2 and tr.dropped == 0
    (batch,) = collector.received
    rs = batch["resourceSpans"][0]
    assert rs["resource"]["attributes"][0] == {"key": "service.name",
                                               "value": {"stringValue": "test-node"}}
    by_name = {s["name"]: s for s in rs["scopeSpans"][0]["spans"]}
    assert set(by_name) == {"Executor.Execute", "planner.count"}
    p, c = by_name["Executor.Execute"], by_name["planner.count"]
    assert c["parentSpanId"] == p["spanId"]
    assert len(p["traceId"]) == 32 and len(p["spanId"]) == 16
    assert int(p["endTimeUnixNano"]) >= int(p["startTimeUnixNano"])
    assert {"key": "index", "value": {"stringValue": "i"}} in p["attributes"]
    tr.close()


@pytest.mark.parametrize("cls", [JOTLPTracer, OTLPTracer], ids=["jax", "port"])
def test_collector_down_never_raises(cls):
    tr = cls(endpoint="http://127.0.0.1:1/v1/traces", flush_interval=60.0, timeout=0.5)
    tr.start_span("x").finish()
    tr.flush()  # collector unreachable: drop, don't raise
    assert (tr.exported, tr.dropped) == (0, 1)
    tr.close()


def test_batch_fills_and_flushes_on_its_own(collector):
    tr = OTLPTracer(endpoint=collector.url, batch_size=4, flush_interval=60.0)
    for i in range(9):
        tr.start_span(f"s{i}").finish()
    assert tr.exported == 8 and len(collector.received) == 2
    tr.close()
    assert tr.exported == 9 and len(collector.received) == 3


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_cluster_query_spans_share_one_trace_id(collector):
    """Two port nodes with ``trace_endpoint``: a Count through the first
    fans a leg out to the second, and the collector receives the
    coordinator's call span, its remote-leg span and the peer's call span
    under one trace id, with the exporter uninstalled at close."""
    addrs = sorted(f"127.0.0.1:{p}" for p in _free_ports(2))
    nodes = [ServerNode(bind=a, peers=[x for x in addrs if x != a], device="cpu",
                        use_planner=False, anti_entropy_interval=0.0,
                        check_nodes_interval=0.0, scrub_interval=0.0,
                        trace_endpoint=collector.url) for a in addrs]
    for n in nodes:
        n.open()
    try:
        assert isinstance(get_tracer(), OTLPTracer)

        def post(path, body=""):
            r = urllib.request.Request(nodes[0].address + path, data=body.encode(),
                                       method="POST")
            return json.loads(urllib.request.urlopen(r, timeout=30).read() or b"{}")

        post("/index/t")
        post("/index/t/field/f")
        for s in range(16):
            post("/index/t/query", f"Set({s * SHARD_WIDTH}, f=1)")
        for n in nodes:
            n.tracer.flush()
        collector.received.clear()
        assert post("/index/t/query?noCache=true", "Count(Row(f=1))") == {"results": [16]}
        for n in nodes:
            n.tracer.flush()
        spans = [s for _, s in collector.spans()]
        legs = [s for s in spans if s["name"] == "cluster.remoteLeg"]
        calls = [s for s in spans if s["name"] == "Executor.executeCount"]
        assert len(legs) >= 1 and len(calls) >= 2
        assert {s["traceId"] for s in legs + calls} == {legs[0]["traceId"]}
        assert {"key": "node", "value": {"stringValue": nodes[1].id}} in legs[0]["attributes"]
    finally:
        for n in nodes:
            n.close()
    assert isinstance(get_tracer(), NopTracer)
    set_tracer(NopTracer())
