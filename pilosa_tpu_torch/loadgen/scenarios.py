"""Built-in scenarios.

The port's copy of pilosa_tpu/loadgen/scenarios.py.

Several of these re-express bench.py silos as legs of the one engine:
``dashboard_storm`` is the dispatch-storm + cache-churn pair,
``overload`` is the slow-peer breaker/hedge drill, ``ingest_under_query``
is the interactive-p99-under-PTS1-stream drill, and ``elastic`` is the
query-through-resize drill -- each formerly its own hand-rolled
bench loop, now a scenario config on shared machinery.

``smoke``/``smoke3`` are the CI pair: short, seeded, deterministic
op sequences (see ``engine.build_ops``) sized to finish in ~30 s
total on a CPU-only runner.
"""

from __future__ import annotations

from pilosa_tpu_torch.loadgen.scenario import (ChaosAction, IngestLeg, QueryLeg,
                                         Scenario)


def _mixed_legs(keyed: bool = True) -> list[QueryLeg]:
    legs = [
        QueryLeg(name="dashboard", weight=5.0, kind="dashboard",
                 qos_class="interactive", population=16, zipf_s=1.2),
        QueryLeg(name="adhoc", weight=2.0, kind="adhoc",
                 qos_class="batch", population=64, zipf_s=0.8,
                 no_cache=True),
        QueryLeg(name="bsi_agg", weight=2.0, kind="bsi",
                 qos_class="batch", population=16, zipf_s=1.0),
        QueryLeg(name="topn", weight=1.0, kind="topn",
                 qos_class="interactive", population=8, zipf_s=1.0),
        QueryLeg(name="distinct", weight=1.0, kind="distinct",
                 qos_class="batch", population=16, zipf_s=1.0),
        QueryLeg(name="similar", weight=1.0, kind="similar",
                 qos_class="interactive", population=8, zipf_s=1.0),
    ]
    if keyed:
        legs.append(QueryLeg(name="keyed", weight=1.0, kind="keyed",
                             qos_class="interactive", population=32,
                             zipf_s=1.1))
    return legs


def smoke() -> Scenario:
    """CI single-node leg: every query kind plus a trickle ingest."""
    return Scenario(
        name="smoke", seed=42, duration_s=8.0, rate=40.0,
        nodes=1, shards=4, rows=48, density=0.005,
        tenants=8, tenant_s=1.2,
        legs=_mixed_legs(keyed=True),
        ingest=IngestLeg(duty=0.3, shards=2, per_shard=10_000),
        node_opts={"qos_max_concurrent": 8},
    )


def smoke3() -> Scenario:
    """CI 3-node leg: mixed traffic over fan-out, one mid-run gray
    failure (slow peer) that heals -- breakers and hedging must show
    up in the rates, and the p99 exemplar must resolve cross-node."""
    return Scenario(
        name="smoke3", seed=42, duration_s=8.0, rate=25.0,
        nodes=3, replica_n=2, shards=6, rows=48, density=0.004,
        tenants=8, tenant_s=1.2,
        legs=_mixed_legs(keyed=False),
        chaos=[ChaosAction(at_s=3.0, action="slow_peer", node=1, value=150.0),
               ChaosAction(at_s=5.5, action="heal_peer", node=1)],
        node_opts={"qos_max_concurrent": 8,
                   "breaker_threshold": 3, "breaker_cooldown": 1.0,
                   "hedge": True, "hedge_delay_ms": 60.0,
                   "hedge_budget_pct": 20.0},
    )


def mixed() -> Scenario:
    """The flagship: a minute of full mixed traffic on 3 nodes."""
    return Scenario(
        name="mixed", seed=7, duration_s=60.0, rate=120.0,
        nodes=3, replica_n=2, shards=8, rows=64, density=0.01,
        tenants=32, tenant_s=1.2,
        legs=_mixed_legs(keyed=True),
        ingest=IngestLeg(duty=0.5, shards=4, per_shard=50_000),
        node_opts={"qos_max_concurrent": 16, "qos_tenant_rate": 64.0,
                   "qos_tenant_burst": 128.0,
                   "breaker_threshold": 5, "hedge": True,
                   "hedge_delay_ms": 50.0},
        max_workers=128,
    )


def dashboard_storm() -> Scenario:
    """bench_dispatch + bench_cache re-expressed: a hot repeated
    dashboard panel (dispatch coalescing, result-cache hits) with a
    churn trickle invalidating shards underneath it."""
    return Scenario(
        name="dashboard_storm", seed=11, duration_s=20.0, rate=300.0,
        process="gamma", cv=2.0,   # bursty, the coalescer's diet
        nodes=1, shards=4, rows=32, density=0.01,
        tenants=4, tenant_s=1.5,
        legs=[QueryLeg(name="dashboard", weight=8.0, kind="dashboard",
                       qos_class="interactive", population=5, zipf_s=1.0),
              QueryLeg(name="topn", weight=1.0, kind="topn",
                       qos_class="interactive", population=4)],
        ingest=IngestLeg(duty=0.2, shards=1, per_shard=5_000),
        max_workers=128,
    )


def overload() -> Scenario:
    """bench_overload re-expressed: oversubscribed arrival rate into a
    3-node cluster with one gray-failing peer; admission, breakers,
    and hedging carry the run (shed is expected, errors are not)."""
    return Scenario(
        name="overload", seed=13, duration_s=20.0, rate=150.0,
        nodes=3, replica_n=2, shards=6, rows=48, density=0.008,
        tenants=16, tenant_s=1.1,
        legs=[QueryLeg(name="dashboard", weight=3.0, kind="dashboard",
                       qos_class="interactive", population=16),
              QueryLeg(name="adhoc", weight=2.0, kind="adhoc",
                       qos_class="batch", population=64, no_cache=True)],
        # slow > deadline: legs via node1 breach, feed its breaker, and
        # hedged replicas must win -- mirrors the old bench's 0.6s slow
        # peer against a 0.5s deadline.
        chaos=[ChaosAction(at_s=5.0, action="slow_peer", node=1, value=600.0),
               ChaosAction(at_s=14.0, action="heal_peer", node=1)],
        node_opts={"qos_max_concurrent": 4, "qos_max_queue": 8,
                   "qos_default_deadline": 0.5,
                   "breaker_threshold": 3, "breaker_cooldown": 1.0,
                   "hedge": True, "hedge_delay_ms": 50.0,
                   "hedge_budget_pct": 20.0},
        max_workers=96,
    )


def ingest_under_query() -> Scenario:
    """bench_ingest's under-load half re-expressed: a near-saturating
    PTS1 stream (duty 0.9) with an interactive dashboard leg whose p99
    is the number that matters."""
    return Scenario(
        name="ingest_under_query", seed=23, duration_s=20.0, rate=50.0,
        nodes=1, shards=8, rows=32, density=0.005,
        tenants=8, tenant_s=1.1,
        legs=[QueryLeg(name="dashboard", weight=4.0, kind="dashboard",
                       qos_class="interactive", population=8),
              QueryLeg(name="bsi_agg", weight=1.0, kind="bsi",
                       qos_class="batch", population=8)],
        ingest=IngestLeg(duty=0.9, shards=8, per_shard=100_000),
        node_opts={"qos_max_concurrent": 8, "ingest_max_inflight_mb": 64},
    )


def elastic() -> Scenario:
    """bench_elastic re-expressed: steady mixed traffic while a node
    joins mid-run and another is removed later -- queries must serve
    through both cutovers."""
    return Scenario(
        name="elastic", seed=31, duration_s=24.0, rate=40.0,
        nodes=2, replica_n=2, shards=6, rows=48, density=0.005,
        tenants=8, tenant_s=1.1,
        legs=[QueryLeg(name="dashboard", weight=3.0, kind="dashboard",
                       qos_class="interactive", population=16),
              QueryLeg(name="bsi_agg", weight=1.0, kind="bsi",
                       qos_class="batch", population=8)],
        chaos=[ChaosAction(at_s=6.0, action="add_node"),
               ChaosAction(at_s=16.0, action="remove_node", node=1)],
        node_opts={"qos_max_concurrent": 8},
    )


def dr_drill() -> Scenario:
    """Unattended disaster recovery under fire: mixed traffic with a
    trickle ingest while every node runs a backup scheduler against a
    fault-injected object store (≥10% of archive requests 503, plus
    torn uploads). Mid-run a gray failure comes and goes, a forced
    backup cycle lands, and then one member is resized out and its
    data dir destroyed. The run must keep zero failed queries; the
    engine's DR epilogue then restores the archive into a fresh
    recovery cluster, proves bit-equivalence fragment by fragment, and
    proves every backup retention left listed still restores."""
    return Scenario(
        name="dr_drill", seed=97, duration_s=16.0, rate=30.0,
        nodes=3, replica_n=2, shards=4, rows=32, density=0.004,
        tenants=8, tenant_s=1.2,
        legs=[QueryLeg(name="dashboard", weight=4.0, kind="dashboard",
                       qos_class="interactive", population=16),
              QueryLeg(name="adhoc", weight=2.0, kind="adhoc",
                       qos_class="batch", population=32, no_cache=True),
              QueryLeg(name="bsi_agg", weight=1.0, kind="bsi",
                       qos_class="batch", population=8)],
        ingest=IngestLeg(duty=0.25, shards=2, per_shard=8_000),
        chaos=[ChaosAction(at_s=2.5, action="slow_peer", node=1,
                           value=120.0),
               ChaosAction(at_s=5.0, action="heal_peer", node=1),
               ChaosAction(at_s=6.0, action="dr_backup"),
               ChaosAction(at_s=8.5, action="dr_destroy_data", node=2),
               ChaosAction(at_s=12.0, action="dr_backup")],
        dr={"failRate": 0.15, "intervalS": 4.0, "fullEvery": 1,
            "keepChains": 1, "recoveryNodes": 2, "tornUploads": 2},
        node_opts={"qos_max_concurrent": 8},
    )


def partition_drill() -> Scenario:
    """Split-brain under traffic: five nodes, replica 3, steady mixed
    load while the network is cut three ways in sequence -- a 2-node
    minority island (the majority keeps serving, the minority fences
    and 503s), a cut that strands the COORDINATOR in the minority (its
    backup scheduler must suspend the duty: skipped-fenced, not a
    second capture racing the majority), and an asymmetric one-way
    link (the isolated node fences itself; nobody false-positives it
    DOWN because indirect probes still reach it). Each cut heals
    before the next. The engine's partition epilogue then proves every
    node un-fenced, forces a repair pass, and requires every
    fragment's replicas to be bit-identical -- a healed split that
    leaves divergent replicas fails the drill."""
    return Scenario(
        name="partition_drill", seed=61, duration_s=18.0, rate=25.0,
        nodes=5, replica_n=3, shards=6, rows=32, density=0.004,
        tenants=10, tenant_s=1.2,
        legs=[QueryLeg(name="dashboard", weight=4.0, kind="dashboard",
                       qos_class="interactive", population=16),
              QueryLeg(name="adhoc", weight=2.0, kind="adhoc",
                       qos_class="batch", population=32, no_cache=True),
              QueryLeg(name="bsi_agg", weight=1.0, kind="bsi",
                       qos_class="batch", population=8)],
        chaos=[ChaosAction(at_s=2.5, action="partition", group=[3, 4]),
               ChaosAction(at_s=6.5, action="heal_partition"),
               ChaosAction(at_s=8.5, action="partition", group=[0, 1],
                           mode="timeout", value=150.0),
               ChaosAction(at_s=12.0, action="heal_partition"),
               ChaosAction(at_s=13.0, action="partition", group=[1],
                           mode="oneway"),
               ChaosAction(at_s=15.5, action="heal_partition")],
        # The failure detector must actually sweep (fencing hangs off
        # it); breakers + short deadlines keep majority-side legs into
        # the dead island from stalling the client pool; the 0.5s
        # backup cadence guarantees scheduler ticks land inside the
        # coordinator's fenced window even after detection latency
        # (the engine supplies a directory archive when backups are on
        # and the scenario has partitions).
        node_opts={"qos_max_concurrent": 8,
                   "check_nodes_interval": 0.5,
                   "anti_entropy_interval": 4.0,
                   "breaker_threshold": 3, "breaker_cooldown": 1.0,
                   "backup_interval": 0.5, "backup_full_every": 1,
                   "backup_keep_chains": 2},
    )


SCENARIOS = {
    "smoke": smoke,
    "smoke3": smoke3,
    "mixed": mixed,
    "dashboard_storm": dashboard_storm,
    "overload": overload,
    "ingest_under_query": ingest_under_query,
    "elastic": elastic,
    "dr_drill": dr_drill,
    "partition_drill": partition_drill,
}


def get_scenario(name: str) -> "Scenario":
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have: {', '.join(sorted(SCENARIOS))})") from None
