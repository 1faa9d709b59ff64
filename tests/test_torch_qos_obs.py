"""The port's copies of the QoS and observability modules against the JAX
package's, on the same inputs: the admission order under weighted
classes, Prometheus text of the same recorded stats, histogram quantiles,
deadline and trace header round trips, tenant quotas, the adaptive limit,
the slow-query log and the profile ring."""

import threading
import time

import pytest

from pilosa_tpu import obs as jobs
from pilosa_tpu import qos as jqos
from pilosa_tpu.cache import tenant as jtenant
from pilosa_tpu.cluster import node as jnode
from pilosa_tpu.obs import tracing as jtracing
from pilosa_tpu_torch import obs as tobs
from pilosa_tpu_torch import qos as tqos
from pilosa_tpu_torch.cache import tenant as ttenant
from pilosa_tpu_torch.cluster import node as tnode
from pilosa_tpu_torch.obs import tracing as ttracing

PACKAGES = [(jqos, jobs), (tqos, tobs)]


def _grant_order(qos, classes, weights=None):
    """Classes in the order a 1-slot controller grants them to waiters
    queued one by one in ``classes`` order, each holding its slot until
    the next grant is read."""
    ctl = qos.AdmissionController(max_concurrent=1, max_queue=len(classes),
                                  weights=weights, internal_reserve=0)
    ctl.acquire("interactive")  # the slot everyone queues behind
    order, granted = [], threading.Semaphore(0)
    go = [threading.Event() for _ in classes]

    def waiter(i, cls):
        ctl.acquire(cls)
        order.append(cls)
        granted.release()
        go[i].wait()
        ctl.release()

    threads = []
    for i, cls in enumerate(classes):
        t = threading.Thread(target=waiter, args=(i, cls))
        t.start()
        threads.append(t)
        while ctl.snapshot()["queuedTotal"] < i + 1:
            time.sleep(0.001)
    ctl.release()
    by_class = {c: [i for i, k in enumerate(classes) if k == c] for c in set(classes)}
    for _ in classes:
        assert granted.acquire(timeout=10)
        cls = order[-1]
        go[by_class[cls].pop(0)].set()
    for t in threads:
        t.join()
    return order, ctl.snapshot()


@pytest.mark.parametrize("weights", [None, {"interactive": 3, "batch": 2}])
def test_admission_order_matches(weights):
    classes = ["batch"] * 5 + ["interactive"] * 6 + ["internal"] * 3 + ["batch", "x"]
    (j_order, j_snap), (t_order, t_snap) = (
        _grant_order(qos, classes, weights) for qos, _ in PACKAGES)
    assert t_order == j_order
    assert t_snap == j_snap
    assert sorted(j_order) == sorted(classes)
    # the weighted round-robin interleaves the classes
    assert j_order[:5] != sorted(j_order[:5])


@pytest.mark.parametrize("qos,_obs", PACKAGES, ids=["jax", "port"])
def test_shed_and_class_names(qos, _obs):
    ctl = qos.AdmissionController(max_concurrent=1, max_queue=0)
    ctl.acquire("batch")
    with pytest.raises(qos.QueryShedError) as e:
        ctl.acquire("interactive")
    assert e.value.retry_after == 1.0
    ctl.release()
    assert [qos.normalize_class(c) for c in ("BATCH", "", "x", "internal")] == [
        "batch", "interactive", "interactive", "internal"]
    assert qos.normalize_class("batch", remote=True) == "internal"


def _record(obs):
    stats = obs.MemoryStats()
    stats.count("qos.admitted")
    stats.with_tags("class:interactive").count("qos.admitted", 3)
    stats.with_tags("class:batch", "node:a").count("qos.shed", 2)
    stats.gauge("qos.queueDepth", 4.0)
    stats.with_tags("class:interactive").gauge("qos.queueDepth", 1.5)
    for i, s in enumerate((0.00005, 0.0002, 0.0011, 0.003, 0.04, 0.5, 2.0, 30.0, 0.0011)):
        stats.with_tags(f"class:{'batch' if i % 3 else 'interactive'}").timing(
            "qos.serviceSeconds", s)
    stats.timing("planner.uploadSeconds", 0.25)
    return stats


def test_prometheus_text_byte_equal():
    texts = [obs.prometheus_text(_record(obs)) for _, obs in PACKAGES]
    assert texts[1] == texts[0]
    assert 'pilosa_qos_service_seconds_count{class="interactive"} 3' in texts[1]


def test_stats_accessors_match():
    (js, ts) = (_record(obs) for _, obs in PACKAGES)
    for name, tags in (("qos.serviceSeconds", ("class:batch",)),
                       ("qos.serviceSeconds", ("class:interactive",)),
                       ("planner.uploadSeconds", ())):
        assert ts.timing_count(name, *tags) == js.timing_count(name, *tags)
        assert ts.timing_sum(name, *tags) == js.timing_sum(name, *tags)
        for q in (0.5, 0.9, 0.99):
            assert ts.timing_quantile(name, q, *tags) == js.timing_quantile(name, q, *tags)
    assert ts.counter_value("qos.shed", "node:a", "class:batch") == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_quantiles_match(seed):
    import numpy as np
    vals = np.random.default_rng(seed).lognormal(-6, 2.5, 500).tolist()
    hs = []
    for _, obs in PACKAGES:
        h = obs.LogHistogram()
        for i, v in enumerate(vals):
            h.observe(v, trace_id=f"t{i}" if i % 7 == 0 else None)
        hs.append(h)
    j, t = hs
    assert t.bucket_items() == j.bucket_items()
    assert t.count == j.count and t.sum == j.sum
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert t.quantile(q) == j.quantile(q)
    assert t.p99_bucket_index() == j.p99_bucket_index()
    assert [t.exemplar(i) for i in range(len(t.bucket_items()))] == \
        [j.exemplar(i) for i in range(len(j.bucket_items()))]


def test_deadline_header_round_trip():
    """A deadline injected by either package is re-derived by the other
    with the same expiry; an expired one raises in both."""
    for (src, _), (dst, _) in ((PACKAGES[0], PACKAGES[1]), (PACKAGES[1], PACKAGES[0])):
        dl = src.Deadline(timeout=30.0)
        token = src.set_current_deadline(dl)
        try:
            headers = src.inject_http_headers({})
        finally:
            src.reset_current_deadline(token)
        assert list(headers) == [dst.DEADLINE_HEADER] == ["X-Deadline"]
        got = dst.extract_http_headers(headers)
        assert abs(got.expires_at - dl.expires_at) < 1e-6
        assert dst.extract_http_headers({"X-Deadline": "garbage"}) is None
        assert dst.extract_http_headers({}) is None
        token = dst.set_current_deadline(dst.Deadline(timeout=-1.0))
        try:
            with pytest.raises(dst.DeadlineExceededError, match="query deadline exceeded"):
                dst.check_current()
        finally:
            dst.reset_current_deadline(token)
        dst.check_current()  # no deadline: no-op


def test_trace_header_round_trip():
    for src, dst in ((jtracing, ttracing), (ttracing, jtracing)):
        token = src.set_current_trace("abc-1")
        try:
            headers = src.inject_http_headers({})
        finally:
            src.reset_current_trace(token)
        assert headers == {"X-Pilosa-Trace-Id": "abc-1"}
        assert dst.extract_http_headers(headers) == "abc-1"


def test_tenant_contextvar():
    for mod in (jtenant, ttenant):
        assert mod.current_tenant() == ""
        token = mod.set_current_tenant("acme")
        assert mod.current_tenant() == "acme"
        mod.reset_current_tenant(token)
        assert mod.current_tenant() == ""


def test_tenant_quotas_match():
    """Same token-bucket decisions and Retry-After hints on a fake clock."""
    outcomes = []
    for qos, _ in PACKAGES:
        now = [100.0]
        q = qos.TenantQuotas(rate_per_s=2.0, burst=3.0, clock=lambda now=now: now[0])
        seq = []
        for step, tenant in enumerate("aaaaabbabaaaa"):
            now[0] += 0.1 * (step % 3)
            try:
                q.check(tenant)
                seq.append((tenant, "ok"))
            except qos.QuotaExceededError as e:
                seq.append((tenant, round(e.retry_after, 9)))
        outcomes.append((seq, q.snapshot()))
    assert outcomes[1] == outcomes[0]


def test_adaptive_limit_matches():
    limits = []
    for qos, _ in PACKAGES:
        lim = qos.AdaptiveLimit(ceiling=16, window=8)
        seq = []
        for i in range(200):
            wait = 0.0 if i < 80 else 0.05 * (i % 5)
            service = 0.01 if i < 120 else 0.04
            lim.observe(wait, service)
            seq.append(lim.limit)
        limits.append((seq, lim.snapshot()))
    assert limits[1] == limits[0]


def test_slow_log_and_profile_ring_match():
    outs = []
    for qos, obs in PACKAGES:
        log = qos.SlowQueryLog(threshold_ms=10.0, capacity=3)
        for i, ms in enumerate((5.0, 11.0, 50.0, 12.0, 9.9, 100.0)):
            log.observe("i", f"Count(Row(f={i}))", ms, qos_class="interactive",
                        trace_id=f"t{i}")
        entries = [{k: v for k, v in e.items() if k not in ("at", "time", "ts")}
                   for e in log.entries()]
        ring = obs.ProfileRing(capacity=2)
        for i, ms in enumerate((3.0, 1.0, 7.0, 2.0)):
            ring.record({"traceId": f"t{i}", "timings": {"totalMs": ms}})
        outs.append((entries, log.total, [d["traceId"] for d in ring.snapshot()],
                     ring.get("t0"), len(ring)))
    assert outs[1] == outs[0]


def test_query_profile_document_keys():
    docs = []
    for _, obs in PACKAGES:
        p = obs.QueryProfile("t1", query="Count(Row(f=1))", index="i", node="n",
                             qos_class="interactive")
        p.add_ms("parseMs", 0.5)
        p.add_dispatch(2, 0.25)
        p.bump("retries")
        doc = p.finish()
        doc["timings"].pop("totalMs")
        docs.append(doc)
    assert docs[1] == docs[0]


def test_node_json_round_trip():
    for src, dst in ((jnode, tnode), (tnode, jnode)):
        n = src.Node(id="h:1", uri=src.URI(scheme="https", host="h", port=1),
                     is_coordinator=True)
        back = dst.Node.from_json(n.to_json())
        assert back.to_json() == n.to_json()
        assert str(back.uri) == "https://h:1"
