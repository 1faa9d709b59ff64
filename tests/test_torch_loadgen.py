"""The port's loadgen (pilosa_tpu_torch/loadgen/) against the JAX package's:
arrival schedules, zipf weights and picks, and every built-in scenario's op
sequence equal for the same seed; scenario dicts and SLO reports round-trip
between the two packages; ``scripts/slo_gate.py`` on a report of the port;
the ``smoke`` scenario end to end on a ``ManagedTarget`` of port nodes on
the CPU, gated against ``scripts/slo_baselines/smoke.json``; and the
exemplar trace id resolving from any node of a three-node port cluster
(tests/test_loadgen.py's cross-node case)."""

import importlib.util
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.loadgen import OpenLoopArrivals as JOpenLoopArrivals
from pilosa_tpu.loadgen import Scenario as JScenario
from pilosa_tpu.loadgen import ZipfPicker as JZipfPicker
from pilosa_tpu.loadgen import validate_report as j_validate_report
from pilosa_tpu.loadgen import zipf_weights as j_zipf_weights
from pilosa_tpu.loadgen.engine import build_ops as j_build_ops
from pilosa_tpu.loadgen.scenarios import SCENARIOS as J_SCENARIOS
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.loadgen import (
    IngestLeg,
    OpenLoopArrivals,
    QueryLeg,
    Scenario,
    ZipfPicker,
    run_scenario,
    validate_report,
    zipf_weights,
)
from pilosa_tpu_torch.loadgen.engine import build_ops
from pilosa_tpu_torch.loadgen.scenarios import SCENARIOS, get_scenario
from pilosa_tpu_torch.loadgen.target import ManagedTarget, QueryOutcome
from pilosa_tpu_torch.obs import tracing

ROOT = Path(__file__).resolve().parent.parent


def _gate():
    spec = importlib.util.spec_from_file_location("slo_gate", ROOT / "scripts" / "slo_gate.py")
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    return gate


def _tiny(cls=Scenario, leg=QueryLeg, **over):
    kw = dict(name="tiny", seed=5, duration_s=1.5, rate=40.0, nodes=1, shards=2, rows=8,
              density=0.002, tenants=4, tenant_s=1.1,
              legs=[leg(name="dash", weight=3.0, kind="dashboard", qos_class="interactive",
                        population=8),
                    leg(name="adhoc", weight=1.0, kind="adhoc", qos_class="batch",
                        population=16, no_cache=True)],
              max_workers=64, warmup_queries=0)
    kw.update(over)
    return cls(**kw)


# -- the seeded schedules, against the JAX package ----------------------------

@pytest.mark.parametrize("process,cv", [("poisson", 1.0), ("gamma", 2.0), ("uniform", 1.0)])
@pytest.mark.parametrize("seed", [3, 9, 97])
def test_arrival_schedule_matches_jax(process, cv, seed):
    kw = dict(rate=250.0, duration_s=3.0, process=process, cv=cv, seed=seed)
    got = OpenLoopArrivals(**kw).schedule()
    np.testing.assert_array_equal(got, JOpenLoopArrivals(**kw).schedule())
    assert len(got) > 100 and np.all(np.diff(got) >= 0)


@pytest.mark.parametrize("kw", [dict(rate=0.0, duration_s=1.0), dict(rate=1.0, duration_s=-1.0),
                                dict(rate=1.0, duration_s=1.0, process="closed"),
                                dict(rate=1.0, duration_s=1.0, process="gamma", cv=0.0)])
def test_arrival_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JOpenLoopArrivals(**kw)
    with pytest.raises(ValueError) as got:
        OpenLoopArrivals(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,s", [(1, 1.1), (16, 1.2), (32, 1.3), (512, 0.9)])
def test_zipf_weights_and_picks_match_jax(n, s):
    np.testing.assert_array_equal(zipf_weights(n, s), j_zipf_weights(n, s))
    rng, jrng = np.random.default_rng(17), np.random.default_rng(17)
    picker, jpicker = ZipfPicker(n, s), JZipfPicker(n, s)
    assert [picker.pick(rng) for _ in range(2000)] == [jpicker.pick(jrng) for _ in range(2000)]


@pytest.mark.parametrize("name", sorted(J_SCENARIOS))
def test_builtin_scenarios_and_op_sequences_match_jax(name):
    """Every built-in scenario: the same dict, and the same op sequence
    (offset, leg, class, tenant, index, PQL) for its seed."""
    assert sorted(SCENARIOS) == sorted(J_SCENARIOS)
    sc, jsc = get_scenario(name), J_SCENARIOS[name]()
    assert sc.to_dict() == jsc.to_dict()
    got = [(o.offset, o.leg, o.kind, o.qos_class, o.tenant, o.index, o.pql, o.no_cache)
           for o in build_ops(sc)]
    want = [(o.offset, o.leg, o.kind, o.qos_class, o.tenant, o.index, o.pql, o.no_cache)
            for o in j_build_ops(jsc)]
    assert got == want and got


def test_scenario_dict_roundtrips_across_packages():
    from pilosa_tpu.loadgen import IngestLeg as JIngestLeg
    from pilosa_tpu.loadgen import QueryLeg as JQueryLeg
    sc = _tiny(ingest=IngestLeg(duty=0.4, shards=1, per_shard=100))
    jsc = _tiny(JScenario, JQueryLeg, ingest=JIngestLeg(duty=0.4, shards=1, per_shard=100))
    doc = json.loads(json.dumps(sc.to_dict()))
    assert doc == jsc.to_dict()
    assert Scenario.from_dict(doc) == sc
    assert JScenario.from_dict(doc).to_dict() == doc
    assert Scenario.from_dict(jsc.to_dict()) == sc
    assert build_ops(Scenario.from_dict(doc)) == build_ops(sc)


# -- reports and the gate -------------------------------------------------------

class _FakeTarget:
    """A target answering every query ok after ``service_s``, with no live
    node behind it (the report's ring-exemplar fallback fails fast)."""

    def __init__(self, service_s: float):
        self.service_s = service_s
        self.mode = "fake"
        self.base_urls = ["http://127.0.0.1:9"]
        self.started = 0
        self._lock = threading.Lock()

    def create_index(self, *a, **k): pass
    def create_field(self, *a, **k): pass
    def import_bits(self, *a, **k): pass
    def import_stream(self, reqs): return len(reqs)
    def metrics_text(self, node=0): return ""
    def debug_vars(self, node=0): return {}
    def resolve_profile(self, tid, node=0): return None
    def close(self): pass

    def query(self, index, pql, **kw):
        with self._lock:
            self.started += 1
        time.sleep(self.service_s)
        return QueryOutcome("ok", 200)


def test_report_schema_roundtrips_across_packages():
    """A port report passes both packages' schema checks, round-trips through
    JSON, and a damaged copy draws the same errors from both."""
    rep = run_scenario(_tiny(), target=_FakeTarget(0.001))
    assert validate_report(rep) == [] == j_validate_report(rep)
    rt = json.loads(json.dumps(rep))
    assert rt == rep and validate_report(rt) == []
    bad = json.loads(json.dumps(rep))
    del bad["rates"]["shed"]
    bad["perClass"]["interactive"]["client"]["p99Ms"] = "fast"
    bad["schemaVersion"] = 999
    errs = validate_report(bad)
    assert errs == j_validate_report(bad)
    assert any("rates.shed" in e for e in errs) and any("p99Ms" in e for e in errs)
    assert any("schemaVersion" in e for e in errs)


def test_open_loop_dispatch_holds_the_schedule():
    """Open loop on the port's engine: every scheduled arrival dispatches on
    time though none completes for half a second, and latency counts from
    the scheduled arrival."""
    sc = _tiny(max_workers=96)
    fake = _FakeTarget(0.5)
    rep = run_scenario(sc, target=fake)
    assert rep["arrivals"]["dispatched"] == rep["arrivals"]["scheduled"] == fake.started
    assert rep["arrivals"]["maxLagMs"] < 400
    for cls in rep["perClass"].values():
        assert cls["client"]["p50Ms"] >= 450


def test_slo_gate_on_a_port_report(tmp_path):
    """scripts/slo_gate.py reads a port report: passing and failing checks,
    and its exit code through the command line."""
    gate = _gate()
    rep = run_scenario(_tiny(), target=_FakeTarget(0.001))
    n = rep["arrivals"]["dispatched"]
    assert gate.run_check(rep, {"path": "arrivals.dispatched", "min": n}) is None
    assert gate.run_check(rep, {"path": "arrivals.dispatched", "min": n + 1}) is not None
    assert gate.run_check(rep, {"path": "perClass.interactive.errorRate", "max": 0}) is None
    assert gate.run_check(rep, {"path": "exemplars", "minLen": 1}) is not None
    report = tmp_path / "rep.json"
    report.write_text(json.dumps(rep))
    for checks, rc in (([{"path": "arrivals.dispatched", "min": 1}], 0),
                       ([{"path": "rates.shed", "min": 1}], 1)):
        base = tmp_path / "base.json"
        base.write_text(json.dumps({"scenario": "tiny", "checks": checks}))
        out = subprocess.run([sys.executable, str(ROOT / "scripts" / "slo_gate.py"),
                              str(report), str(base)], capture_output=True, text=True,
                             timeout=60)
        assert out.returncode == rc, out.stdout + out.stderr


# -- end to end on port nodes -----------------------------------------------------

def test_smoke_scenario_passes_its_slo_gate(tmp_path):
    """``python -m pilosa_tpu_torch.loadgen smoke --device cpu``: one managed
    port node runs the whole smoke scenario (every query kind, a keyed leg,
    a trickle ingest), and its report passes scripts/slo_gate.py against the
    unchanged scripts/slo_baselines/smoke.json."""
    out = tmp_path / "smoke.json"
    run = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch.loadgen", "smoke",
                          "--device", "cpu", "--quiet", "--out", str(out)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    rep = json.loads(out.read_text())
    assert rep["target"] == {"mode": "managed", "nodes": 1}
    assert validate_report(rep) == []
    gate = subprocess.run([sys.executable, str(ROOT / "scripts" / "slo_gate.py"), str(out),
                           str(ROOT / "scripts" / "slo_baselines" / "smoke.json")],
                          capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stdout + gate.stderr


def test_scenario_end_to_end_on_a_managed_port_node():
    sc = _tiny(duration_s=2.5, rate=30.0, shards=2, density=0.003, warmup_queries=4,
               ingest=IngestLeg(duty=0.3, shards=1, per_shard=2_000))
    rep = run_scenario(sc, device="cpu")
    assert rep["target"]["mode"] == "managed"
    inter = rep["perClass"]["interactive"]
    assert inter["counts"]["ok"] > 10 and inter["client"]["count"] > 10
    assert rep["legs"]["dash"]["count"] > 0 and rep["legs"]["adhoc"]["count"] > 0
    assert rep["cache"]["hits"] + rep["cache"]["misses"] > 0
    assert rep["ingest"]["batches"] >= 1 and rep["ingest"]["errors"] == 0
    assert rep["exemplars"] and rep["exemplars"][0]["traceId"]
    assert isinstance(rep["exemplars"][0]["profile"], dict)


def test_managed_target_runs_port_nodes_where_asked():
    """ManagedTarget boots the port's ServerNodes, on the card by default
    (the card's absence raises here), on the CPU when asked."""
    import torch

    from pilosa_tpu_torch.server.node import ServerNode
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ManagedTarget(n_nodes=1)
    t = ManagedTarget(n_nodes=1, device="cpu")
    try:
        assert isinstance(t.nodes[0], ServerNode)
        assert t.nodes[0].holder.device == torch.device("cpu")
    finally:
        t.close()


def test_exemplar_profile_resolves_from_any_node():
    """A fanned-out query's profile is retained on the coordinator's ring
    only; /debug/queries/<trace-id> on ANY port node resolves it (one-hop
    peer fan-out) with its remote legs, and ?local=true never fans out."""
    t = ManagedTarget(n_nodes=3, replica_n=1, device="cpu")
    try:
        t.create_index("xn")
        t.create_field("xn", "f")
        rng = np.random.default_rng(2)
        want = 0
        for s in range(6):
            cols = s * SHARD_WIDTH + rng.integers(0, SHARD_WIDTH, 500).astype(np.uint64)
            rows = rng.integers(0, 4, 500).astype(np.uint64)
            t.import_bits("xn", "f", rows, cols)
            want += len(np.unique(cols[rows == 1]))
        tid = tracing.new_trace_id()
        out = t.query("xn", "Count(Row(f=1))", trace_id=tid, no_cache=True)
        assert out.status == "ok"
        for node in range(3):
            prof = t.resolve_profile(tid, node=node)
            assert prof is not None and prof.get("traceId") == tid, node
        assert t.resolve_profile(tid, node=1).get("remoteLegs")
        misses = 0
        for node in range(3):
            try:
                urllib.request.urlopen(f"{t.base_urls[node]}/debug/queries/{tid}?local=true",
                                       timeout=10).read()
            except urllib.error.HTTPError as e:
                assert e.code == 404
                misses += 1
        assert misses == 2
        body = json.loads(t._post(f"{t.base_urls[2]}/index/xn/query?noCache=true",
                                  "Count(Row(f=1))"))
        assert body == {"results": [want]}
    finally:
        t.close()


def test_managed_import_stream_lands_on_each_shards_owners(tmp_path):
    """ManagedTarget's PTS1 stream reaches every owner of each shard (the
    JAX harness streams every shard to node 0 alone, so the DR drill's
    recovery check found node 0's stray copies in the archive and none on
    the owners): after the DR drill's dataset, each member holds exactly
    the value fragments it owns, and Sum and Count of the values through
    every member equal a single node's."""
    from pilosa_tpu_torch.loadgen.engine import setup_dataset

    sc = get_scenario("dr_drill")
    queries = ["Sum(field=v)", "Count(Row(v > 0))", "Count(Row(f=1))"]
    single = ManagedTarget(n_nodes=1, device="cpu")
    try:
        setup_dataset(sc, single)
        want = [json.loads(single._post(f"{single.base_urls[0]}/index/mix/query?noCache=true",
                                        q)) for q in queries]
    finally:
        single.close()
    t = ManagedTarget(n_nodes=3, replica_n=2, device="cpu", data_root=str(tmp_path))
    try:
        setup_dataset(sc, t)
        for n in t.nodes:
            owned = {s for s in range(sc.shards)
                     if n.id in [m.id for m in n.cluster.shard_nodes("mix", s)]}
            held = {k[3] for k in n.store.all_fragment_keys() if k[:2] == ("mix", "v")}
            assert held == owned, n.id
        for base in t.base_urls:
            got = [json.loads(t._post(f"{base}/index/mix/query?noCache=true", q))
                   for q in queries]
            assert got == want, base
    finally:
        t.close()
