"""Scenario engine: schedule → live HTTP traffic → SLO report.

The port's copy of pilosa_tpu/loadgen/engine.py.

The run is deterministic up to the wire: the arrival schedule AND the
full op sequence (leg, tenant, query text per arrival) are drawn from
the scenario seed before the first request fires (``build_ops``).
Execution never feeds back into arrivals -- a worker-pool submission
happens at the scheduled offset whether or not earlier ops finished,
and latency is measured FROM THE SCHEDULED ARRIVAL, so server queue
buildup and load-generator lag both land in the tail where an SLO can see
them.

Latencies accumulate in a MemoryStats registry (bounded LogHistograms
with trace-id exemplars), never in private lists; the report reads
them back through ``timing_quantile`` and resolves tail exemplars
into full cost profiles via ``/debug/queries/<trace-id>``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.loadgen.arrival import OpenLoopArrivals
from pilosa_tpu_torch.loadgen.mix import WorkloadMix, ZipfPicker
from pilosa_tpu_torch.loadgen.report import (SCHEMA_VERSION, PromHistogram,
                                       parse_prom_histograms, tail_exemplars,
                                       validate_report)
from pilosa_tpu_torch.loadgen.scenario import Scenario
from pilosa_tpu_torch.loadgen.target import ManagedTarget
from pilosa_tpu_torch.obs import tracing

#: the index every scenario drives (plus INDEX_KEYED for keyed legs)
INDEX = "mix"
INDEX_KEYED = "mixk"

#: service-latency histogram each node exports per QoS class
_SERVER_HIST = "pilosa_qos_service_seconds"


@dataclass(frozen=True)
class Op:
    """One precomputed request: everything but the wire."""

    offset: float      # seconds from run start
    leg: str
    kind: str
    qos_class: str
    tenant: int
    index: str
    pql: str
    no_cache: bool


def _leg_query(leg, rank: int, rng: np.random.Generator,
               sc: Scenario) -> tuple[str, str]:
    """(index, pql) for one sampled op. ``rank`` is the zipf-picked
    member of the leg's query population; extra randomness (the ad-hoc
    second operand) comes from the shared op rng so the sequence stays
    seed-deterministic."""
    n_rows = sc.rows
    if leg.kind == "dashboard":
        return INDEX, f"Count(Row(f={rank % n_rows}))"
    if leg.kind == "adhoc":
        a = rank % n_rows
        b = int(rng.integers(0, n_rows))
        return INDEX, f"Count(Intersect(Row(f={a}), Row(f={b})))"
    if leg.kind == "bsi":
        span = 100_000
        lo = -span + (2 * span * (rank % leg.population)) // leg.population
        return INDEX, f"Sum(Row(v > {lo}), field=v)"
    if leg.kind == "topn":
        if rank % 2:
            return INDEX, f"TopN(f, Row(f={rank % n_rows}), n=10)"
        return INDEX, "TopN(f, n=10)"
    if leg.kind == "distinct":
        if rank % 2:
            return INDEX, (f"Count(Distinct(Row(f={rank % n_rows}), "
                           "field=v))")
        return INDEX, "Count(Distinct(field=v))"
    if leg.kind == "similar":
        return INDEX, f"SimilarTopN(f, Row(f={rank % n_rows}), n=10)"
    # keyed
    return INDEX_KEYED, f'Count(Row(kf="k{rank % leg.population}"))'


def build_ops(sc: Scenario) -> list[Op]:
    """The full deterministic op sequence for a scenario: same
    scenario dict + same seed → identical list, computed without
    touching any target (the open-loop contract, testable offline)."""
    schedule = OpenLoopArrivals(rate=sc.rate, duration_s=sc.duration_s,
                                process=sc.process, cv=sc.cv,
                                seed=sc.seed).schedule()
    mix = WorkloadMix([(leg.name, leg.weight) for leg in sc.legs],
                      n_tenants=sc.tenants, tenant_s=sc.tenant_s)
    pickers = {leg.name: ZipfPicker(leg.population, leg.zipf_s)
               for leg in sc.legs}
    legs = {leg.name: leg for leg in sc.legs}
    rng = np.random.default_rng(sc.seed ^ 0x5EED)
    ops = []
    for off in schedule:
        name, tenant = mix.sample(rng)
        leg = legs[name]
        index, pql = _leg_query(leg, pickers[name].pick(rng), rng, sc)
        ops.append(Op(offset=float(off), leg=name, kind=leg.kind,
                      qos_class=leg.qos_class, tenant=tenant,
                      index=index, pql=pql, no_cache=leg.no_cache))
    return ops


# -- dataset -------------------------------------------------------------


def _bsi_reqs(sc: Scenario, field: str, shards: int, per_shard: int,
              rng: np.random.Generator,
              lo: int = -100_000, hi: int = 100_000) -> list[dict]:
    reqs = []
    for s in range(shards):
        cols = (s * SHARD_WIDTH
                + rng.choice(SHARD_WIDTH, per_shard,
                             replace=False).astype(np.uint64))
        vals = rng.integers(lo, hi, per_shard)
        reqs.append({"kind": "field", "index": INDEX, "field": field,
                     "shard": s, "rowIDs": None, "columnIDs": cols,
                     "values": vals, "clear": False})
    return reqs


def setup_dataset(sc: Scenario, target) -> None:
    """Create schema + seed data. Deterministic from the scenario seed
    (setup rng is independent of the op-sequence rng)."""
    rng = np.random.default_rng(sc.seed ^ 0xDA7A)
    target.create_index(INDEX)
    target.create_field(INDEX, "f")
    target.create_field(INDEX, "v", {"type": "int",
                                     "min": -100_000, "max": 100_000})
    per_shard = max(64, int(sc.density * SHARD_WIDTH))
    for s in range(sc.shards):
        cols = (s * SHARD_WIDTH
                + rng.choice(SHARD_WIDTH, per_shard,
                             replace=False).astype(np.uint64))
        # zipf-ish row popularity so TopN and dashboards see real skew
        rows = (np.abs(rng.standard_cauchy(per_shard)) * 4).astype(
            np.uint64) % sc.rows
        target.import_bits(INDEX, "f", rows, cols)
    target.import_stream(_bsi_reqs(sc, "v", sc.shards,
                                   min(per_shard, 20_000), rng))
    if any(leg.kind == "keyed" for leg in sc.legs):
        target.create_index(INDEX_KEYED, {"keys": True})
        target.create_field(INDEX_KEYED, "kf", {"keys": True})
        pop = max(leg.population for leg in sc.legs if leg.kind == "keyed")
        sets = [f'Set("c{int(rng.integers(0, 512))}", kf="k{k}")'
                for k in range(pop) for _ in range(4)]
        for i in range(0, len(sets), 64):
            target.query(INDEX_KEYED, "".join(sets[i:i + 64]),
                         qos_class="batch")
    if sc.ingest is not None:
        for t in (0, 1):
            target.create_field(INDEX, f"bg{t}",
                                {"type": "int",
                                 "min": sc.ingest.value_min,
                                 "max": sc.ingest.value_max})


# -- background legs -----------------------------------------------------


def _ingest_loop(sc: Scenario, target, stop: threading.Event,
                 totals: dict) -> None:
    """Stream PTS1 batches at the configured duty cycle."""
    leg = sc.ingest
    rng = np.random.default_rng(sc.seed ^ 0x16e5)
    reqs = _bsi_reqs(sc, "bg0", leg.shards, leg.per_shard, rng,
                     leg.value_min, leg.value_max)
    t = 0
    while not stop.is_set():
        batch = [dict(r, field=f"bg{t % 2}") for r in reqs]
        t0 = time.perf_counter()
        try:
            target.import_stream(batch)
        except Exception:
            totals["errors"] += 1
            if stop.wait(0.2):
                break
            continue
        dt = time.perf_counter() - t0
        totals["vals"] += leg.shards * leg.per_shard
        totals["seconds"] += dt
        totals["batches"] += 1
        t += 1
        if leg.duty < 1.0 and dt > 0:
            stop.wait(dt * (1.0 - leg.duty) / leg.duty)


def _chaos_loop(sc: Scenario, target, stop: threading.Event,
                t0: float, applied: list) -> None:
    for act in sorted(sc.chaos, key=lambda a: a.at_s):
        while not stop.is_set():
            delay = act.at_s - (time.perf_counter() - t0)
            if delay <= 0:
                break
            if stop.wait(min(delay, 0.1)):
                return
        if stop.is_set():
            return
        if act.action == "slow_peer":
            ok = target.slow_peer(act.node, act.value)
        elif act.action == "heal_peer":
            ok = target.heal_peer(act.node)
        elif act.action == "add_node":
            ok = target.add_node()
        elif act.action == "dr_backup":
            ok = target.dr_backup()
        elif act.action == "dr_destroy_data":
            ok = target.dr_destroy_data(act.node)
        elif act.action == "partition":
            ok = target.partition(act.group, act.mode, act.value)
        elif act.action == "heal_partition":
            ok = target.heal_partition()
        else:
            ok = target.remove_node(act.node)
        applied.append({"atS": act.at_s, "action": act.action,
                        "node": act.node, "value": act.value,
                        "group": list(act.group), "mode": act.mode,
                        "ok": ok})


# -- DR drill ------------------------------------------------------------


def _dr_setup(sc: Scenario) -> dict:
    """Boot the drill's fault-injected object store and derive the
    node opts that point every node's backup scheduler at it."""
    import tempfile

    from pilosa_tpu_torch.backup.faults import FakeObjectServer
    cfg = dict(sc.dr or {})
    srv = FakeObjectServer(seed=sc.seed)
    srv.fail_rate = float(cfg.get("failRate", 0.15))
    srv.torn_next_put = int(cfg.get("tornUploads", 2))
    url = srv.url(bucket="drill")
    return {
        "srv": srv, "url": url, "cfg": cfg,
        "data_root": tempfile.mkdtemp(prefix="loadgen-dr-"),
        "node_opts": {
            "backup_interval": float(cfg.get("intervalS", 3.0)),
            "archive_url": url,
            "backup_full_every": int(cfg.get("fullEvery", 1)),
            "backup_keep_chains": int(cfg.get("keepChains", 1)),
        },
    }


def _dr_epilogue(sc: Scenario, target, env: dict) -> dict:
    """After the storm: final capture, restore into a fresh recovery
    cluster, prove bit-equivalence, and prove every backup retention
    left listed is still restorable. Returns the report's numeric
    ``dr`` section."""
    import shutil
    import tempfile

    from pilosa_tpu_torch.backup import BackupError, open_archive, preflight_restore
    srv, url = env["srv"], env["url"]
    # One forced cycle captures the post-run state, so the recovery
    # cluster has an exact target to be measured against.
    dr: dict = {"finalBackupOk": 1 if target.dr_backup() else 0}

    names = ("backup.scheduler.runs", "backup.scheduler.failed",
             "backup.scheduler.skipped", "backup.retention.pruned",
             "archive.retries", "archive.bytesOut", "archive.bytesIn")
    sums = dict.fromkeys(names, 0.0)
    for i in range(len(target.base_urls)):
        try:
            dvars = target.debug_vars(i)
        except Exception:
            continue
        for n in names:
            sums[n] += _counter_sum(dvars, n)
    dr["backupRuns"] = int(sums["backup.scheduler.runs"])
    dr["backupFailed"] = int(sums["backup.scheduler.failed"])
    dr["backupSkipped"] = int(sums["backup.scheduler.skipped"])
    dr["retentionPruned"] = int(sums["backup.retention.pruned"])
    dr["archiveRetries"] = int(sums["archive.retries"])
    dr["archiveBytesOut"] = int(sums["archive.bytesOut"])
    dr["archiveBytesIn"] = int(sums["archive.bytesIn"])
    dr["faultsInjected"] = srv.injected
    dr["tornUploads"] = srv.torn

    live = target.fragment_digest()
    rec_root = tempfile.mkdtemp(prefix="loadgen-dr-rec-")
    rec = ManagedTarget(n_nodes=int(env["cfg"].get("recoveryNodes", 2)),
                        replica_n=sc.replica_n,
                        node_opts=dict(sc.node_opts), data_root=rec_root,
                        device=env["device"])
    try:
        rec._post(rec.base_urls[0] + "/restore",
                  json.dumps({"archive": url}))
        deadline = time.time() + 120
        st = {}
        while time.time() < deadline:
            try:
                st = json.loads(rec._get(rec.base_urls[0]
                                         + "/restore/status"))
            except Exception:
                st = {}
            if st.get("state") in ("done", "failed"):
                break
            time.sleep(0.2)
        dr["restoreDone"] = 1 if st.get("state") == "done" else 0
        recovered = rec.fragment_digest()
        dr["restoredFragments"] = len(recovered)
        # Bit-equivalence, key by key: every restored replica's digest
        # must be one the live cluster holds for that fragment (the
        # backup captured exactly one healthy replica's bytes), and no
        # fragment may appear on one side only.
        mismatched = 0
        for k in set(live) | set(recovered):
            lv, rv = live.get(k), recovered.get(k)
            if lv is None or rv is None or not rv <= lv:
                mismatched += 1
        dr["mismatchedFragments"] = mismatched
    finally:
        rec.close()
        shutil.rmtree(rec_root, ignore_errors=True)

    # Retention's standing invariant, re-proved from the outside: every
    # backup the archive still lists passes a restore preflight.
    arch = open_archive(url)
    try:
        ids = arch.list_backups()
        unrestorable = 0
        for bid in ids:
            try:
                preflight_restore(arch, arch.read_manifest(bid))
            except BackupError:
                unrestorable += 1
        dr["survivingBackups"] = len(ids)
        dr["unrestorableBackups"] = unrestorable
    finally:
        arch.close()
    return dr


# -- partition drill -----------------------------------------------------


def _partition_epilogue(sc: Scenario, target) -> dict:
    """After a split-brain drill: heal whatever is still cut, drive
    failure-detector sweeps until every node un-fences, force a repair
    pass, and prove the replicas converged bit-identically. Returns
    the report's numeric ``partition`` section."""
    healed = target.heal_partition()
    nodes = getattr(target, "nodes", None)   # managed mode only

    def sweep():
        if nodes is None:
            return
        from pilosa_tpu_torch.cluster.resize import check_nodes
        for n in nodes:
            if n.cluster is None:
                continue
            try:
                check_nodes(n.cluster, n.cluster.client, retries=1,
                            discover=False)
            except Exception:
                pass

    still_fenced = len(target.base_urls)
    deadline = time.time() + 30.0
    while time.time() < deadline:
        sweep()
        still_fenced = 0
        for i in range(len(target.base_urls)):
            try:
                doc = json.loads(target._get(
                    target.base_urls[i] + "/debug/membership"))
            except Exception:
                still_fenced += 1
                continue
            if doc.get("fenced"):
                still_fenced += 1
        if still_fenced == 0:
            break
        time.sleep(0.3)

    out: dict = {"healedOk": 1 if healed else 0,
                 "stillFenced": still_fenced}

    names = ("cluster.fenced", "cluster.unfenced",
             "cluster.staleTokenRejected", "cluster.nodeDown",
             "cluster.nodeUp", "backup.scheduler.skippedFenced")
    sums = dict.fromkeys(names, 0.0)
    for i in range(len(target.base_urls)):
        try:
            dvars = target.debug_vars(i)
        except Exception:
            continue
        for n in names:
            sums[n] += _counter_sum(dvars, n)
    out["fencedTransitions"] = int(sums["cluster.fenced"])
    out["unfencedTransitions"] = int(sums["cluster.unfenced"])
    out["staleTokenRejected"] = int(sums["cluster.staleTokenRejected"])
    out["nodeDownEvents"] = int(sums["cluster.nodeDown"])
    out["nodeUpEvents"] = int(sums["cluster.nodeUp"])
    out["schedulerSkippedFenced"] = int(
        sums["backup.scheduler.skippedFenced"])

    # Convergence: after the repair passes every fragment's replicas
    # must hold bit-identical content -- a healed partition that leaves
    # divergent replicas is the drill's core failure mode.
    if nodes is not None:
        for _ in range(2):
            for n in nodes:
                try:
                    n._sync_schema()
                    if n.syncer is not None:
                        n.syncer.sync_holder()
                except Exception:
                    pass
        digests = target.fragment_digest()
        out["fragments"] = len(digests)
        out["mismatchedFragments"] = sum(
            1 for d in digests.values() if len(d) > 1)
    return out


def _translate_epilogue(sc: Scenario, target) -> dict:
    """After a run with a keyed leg: per-node key-plane counters from
    ``/debug/translate`` plus the cross-node translation-agreement
    check (every node's store for the keyed index reports the same
    maxId once traffic stops -- diverging ids is THE keyed-cluster
    failure mode). Returns the report's numeric ``translate`` section."""
    names = ("planes", "builds", "deviceBatches", "deviceKeys",
             "collisionHits", "staleServed", "rebuildsScheduled")
    sums = dict.fromkeys(names, 0)
    coord_max = 0
    replica_max: list[int] = []
    watermarks: list[int] = []
    nodes_seen = 0
    for i in range(len(target.base_urls)):
        try:
            doc = json.loads(target._get(
                target.base_urls[i] + "/debug/translate"))
        except Exception:
            continue
        nodes_seen += 1
        p = doc.get("planes") or {}
        for n in names:
            sums[n] += int(p.get(n, 0))
        ks = (doc.get("stores") or {}).get(f"{INDEX_KEYED}/kf")
        if ks is not None:
            mid = int(ks.get("maxId", 0))
            if doc.get("coordinator"):
                coord_max = max(coord_max, mid)
            else:
                replica_max.append(mid)
            watermarks.append(int(ks.get("watermark", 0)))
    out: dict = {"nodesReporting": nodes_seen}
    for n in names:
        out[n] = sums[n]
    # Replicas only hold the mappings their traffic touched, so maxId
    # may trail the coordinator -- but no node may be AHEAD of it
    # (local allocation on a replica is how stores diverge).
    out["keyedMaxId"] = max([coord_max] + replica_max)
    out["replicaAheadOfCoordinator"] = (
        1 if coord_max and replica_max
        and max(replica_max) > coord_max else 0)
    out["keyedWatermarkMin"] = min(watermarks) if watermarks else 0
    return out


# -- counters ------------------------------------------------------------


def _counter_sum(dvars: dict, name: str) -> float:
    """Sum a counter across its tag expansions ('qos.shed' matches both
    "qos.shed" and "qos.shed['class:interactive']")."""
    return sum(v for k, v in dvars.get("counters", {}).items()
               if k == name or k.startswith(name + "["))


def _cluster_counters(target) -> dict:
    names = ("qos.shed", "qos.quotaRejected", "qos.deadlineMiss",
             "cluster.hedgeFired", "cluster.hedgeWon",
             "cluster.breakerOpen", "cache.hits", "cache.misses")
    out = dict.fromkeys(names, 0.0)
    for i in range(len(target.base_urls)):
        try:
            dvars = target.debug_vars(i)
        except Exception:
            continue
        for n in names:
            out[n] += _counter_sum(dvars, n)
    return out


def _server_class_hists(target) -> dict[str, PromHistogram]:
    """Per-QoS-class service-latency histograms merged across nodes."""
    merged: dict[str, PromHistogram] = {}
    for i in range(len(target.base_urls)):
        try:
            text = target.metrics_text(i)
        except Exception:
            continue
        for key, h in parse_prom_histograms(text, _SERVER_HIST).items():
            cls = dict(key).get("class", "")
            if not cls:
                continue
            m = merged.setdefault(cls, PromHistogram())
            if not m.buckets:
                m.buckets = list(h.buckets)
            else:
                m.buckets = [(le, c0 + c1) for (le, c0), (_, c1)
                             in zip(m.buckets, h.buckets)]
            m.exemplars.extend(h.exemplars)
    return merged


# -- the run -------------------------------------------------------------


def run_scenario(sc: Scenario, target=None, out: str | None = None,
                 verbose: bool = False, device: str = "cuda") -> dict:
    """Drive one scenario and return (and optionally write) its SLO
    report. When ``target`` is None a ManagedTarget is booted from the
    scenario's cluster shape on ``device`` (the card unless the caller
    asks for the CPU) and torn down after."""
    from pilosa_tpu_torch.obs.stats import MemoryStats

    owned = target is None
    dr_env = None
    has_partition = any(a.action in ("partition", "heal_partition")
                        for a in sc.chaos)
    part_root = None
    if sc.dr is not None:
        if not owned:
            raise ValueError("a DR drill scenario needs a managed "
                             "target (it owns the nodes it destroys)")
        dr_env = _dr_setup(sc)
        dr_env["device"] = device
    if owned:
        node_opts = dict(sc.node_opts)
        if dr_env is not None:
            node_opts.update(dr_env["node_opts"])
        elif has_partition:
            # Partition drills need durable nodes (the epilogue's
            # fragment-digest convergence check reads the stores) and,
            # when the scenario enables scheduled backups, a shared
            # directory archive for the coordinator to capture into.
            import tempfile
            part_root = tempfile.mkdtemp(prefix="loadgen-partition-")
            if float(node_opts.get("backup_interval", 0.0) or 0.0) > 0:
                node_opts.setdefault(
                    "archive_url", os.path.join(part_root, "archive"))
        target = ManagedTarget(
            n_nodes=sc.nodes, replica_n=sc.replica_n,
            node_opts=node_opts,
            data_root=(dr_env["data_root"] if dr_env else part_root),
            device=device)
    stats = MemoryStats()
    ops = build_ops(sc)
    try:
        setup_dataset(sc, target)

        # compile/cache warmup: one quiet pass over each leg's shape
        for op in ops[:sc.warmup_queries]:
            target.query(op.index, op.pql, qos_class=op.qos_class,
                         tenant=f"t{op.tenant}", no_cache=op.no_cache)

        before = _cluster_counters(target)
        stop = threading.Event()
        threads = []
        ingest_totals = {"vals": 0, "seconds": 0.0, "batches": 0,
                         "errors": 0}
        chaos_applied: list[dict] = []
        t0 = time.perf_counter()
        if sc.ingest is not None:
            threads.append(threading.Thread(
                target=_ingest_loop, args=(sc, target, stop, ingest_totals),
                name="loadgen-ingest", daemon=True))
        if sc.chaos:
            threads.append(threading.Thread(
                target=_chaos_loop, args=(sc, target, stop, t0, chaos_applied),
                name="loadgen-chaos", daemon=True))
        for t in threads:
            t.start()

        max_lag = 0.0

        def do_op(op: Op) -> None:
            tid = tracing.new_trace_id()
            out_ = target.query(op.index, op.pql, qos_class=op.qos_class,
                                tenant=f"t{op.tenant}", trace_id=tid,
                                no_cache=op.no_cache,
                                node=op.tenant % len(target.base_urls))
            # Latency from the SCHEDULED arrival: generator lag and server
            # queueing both count -- that's the open-loop point.
            lat = (time.perf_counter() - t0) - op.offset
            tok = tracing.set_current_trace(tid)
            try:
                stats.with_tags(f"class:{op.qos_class}").timing(
                    "loadgen.latencySeconds", lat)
                stats.with_tags(f"leg:{op.leg}").timing(
                    "loadgen.legSeconds", lat)
            finally:
                tracing.reset_current_trace(tok)
            stats.with_tags(f"class:{op.qos_class}").count(
                f"loadgen.{out_.status}")
            stats.with_tags(f"leg:{op.leg}").count(
                f"loadgen.leg.{out_.status}")

        dispatched = 0
        with ThreadPoolExecutor(max_workers=sc.max_workers) as pool:
            futs = []
            for op in ops:
                delay = op.offset - (time.perf_counter() - t0)
                if delay > 0:
                    time.sleep(delay)
                else:
                    max_lag = max(max_lag, -delay)
                futs.append(pool.submit(do_op, op))
                dispatched += 1
            for f in futs:
                f.result()
        elapsed = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=30)
        after = _cluster_counters(target)

        part_section = (_partition_epilogue(sc, target)
                        if has_partition else None)
        dr_section = (_dr_epilogue(sc, target, dr_env)
                      if dr_env is not None else None)
        translate_section = (_translate_epilogue(sc, target)
                             if any(leg.kind == "keyed" for leg in sc.legs)
                             else None)
        report = _build_report(sc, target, stats, ops, elapsed, dispatched,
                               max_lag, before, after, ingest_totals,
                               chaos_applied, dr_section, part_section,
                               translate_section)
    finally:
        if owned:
            target.close()
        if dr_env is not None:
            import shutil
            dr_env["srv"].close()
            shutil.rmtree(dr_env["data_root"], ignore_errors=True)
        if part_root is not None:
            import shutil
            shutil.rmtree(part_root, ignore_errors=True)
    errs = validate_report(report)
    if errs:
        raise RuntimeError(f"SLO report failed its own schema: {errs}")
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    if verbose:
        print(json.dumps(report, indent=2, sort_keys=True))
    return report


def _build_report(sc: Scenario, target, stats, ops, elapsed, dispatched,
                  max_lag, before, after, ingest_totals, chaos_applied,
                  dr=None, partition=None, translate=None):
    delta = {k: after[k] - before[k] for k in after}
    server_hists = _server_class_hists(target)

    def ms(x: float) -> float:
        return round(x * 1000.0, 3)

    per_class: dict[str, dict] = {}
    for cls in sorted({op.qos_class for op in ops}):
        tag = f"class:{cls}"
        counts = {s: int(stats.counter_value(f"loadgen.{s}", tag))
                  for s in ("ok", "shed", "quota", "deadline", "error")}
        n = sum(counts.values())
        sh = server_hists.get(cls)
        per_class[cls] = {
            "client": {
                "count": stats.timing_count("loadgen.latencySeconds", tag),
                "p50Ms": ms(stats.timing_quantile(
                    "loadgen.latencySeconds", 0.50, tag)),
                "p99Ms": ms(stats.timing_quantile(
                    "loadgen.latencySeconds", 0.99, tag)),
                "p999Ms": ms(stats.timing_quantile(
                    "loadgen.latencySeconds", 0.999, tag)),
            },
            "server": None if sh is None else {
                "count": sh.count,
                "p50Ms": ms(sh.quantile(0.50)),
                "p99Ms": ms(sh.quantile(0.99)),
                "p999Ms": ms(sh.quantile(0.999)),
            },
            "counts": counts,
            "shedRate": round(counts["shed"] / n, 4) if n else 0.0,
            "errorRate": round(counts["error"] / n, 4) if n else 0.0,
        }

    legs: dict[str, dict] = {}
    for leg in sc.legs:
        tag = f"leg:{leg.name}"
        legs[leg.name] = {
            "count": stats.timing_count("loadgen.legSeconds", tag),
            "p50Ms": ms(stats.timing_quantile("loadgen.legSeconds",
                                              0.50, tag)),
            "p99Ms": ms(stats.timing_quantile("loadgen.legSeconds",
                                              0.99, tag)),
            "p999Ms": ms(stats.timing_quantile("loadgen.legSeconds",
                                               0.999, tag)),
            "errors": int(stats.counter_value("loadgen.leg.error", tag)),
        }

    hits, misses = delta["cache.hits"], delta["cache.misses"]
    looked = hits + misses

    # Exemplars: the engine's own p99+ tail first (client-observed
    # budget-blowers), then trace ids the servers exported on their
    # /metrics p99 buckets. Resolution goes through /debug/queries --
    # any node answers thanks to the cross-node fan-out. The ring's
    # slowest-retained entry is the fallback so a report always links
    # at least one profile.
    candidates: list[tuple[str, float, str]] = []
    for (name, tags), h in sorted(stats.timings.items()):
        if name != "loadgen.latencySeconds":
            continue
        for tid, val in tail_exemplars(h)[:3]:
            candidates.append((tid, val, f"client:{','.join(tags)}"))
    for cls, sh in sorted(server_hists.items()):
        for tid, val in sh.exemplars[-3:]:
            candidates.append((tid, val, f"server:class:{cls}"))
    exemplars, seen = [], set()
    for tid, val, source in candidates:
        if tid in seen or len(exemplars) >= 3:
            continue
        seen.add(tid)
        prof = target.resolve_profile(tid)
        if prof is not None:
            exemplars.append({"traceId": tid, "latencyMs": ms(val),
                              "source": source, "profile": prof})
    if not exemplars:
        try:
            import urllib.request
            listing = json.loads(urllib.request.urlopen(
                target.base_urls[0] + "/debug/queries", timeout=10).read())
            for doc in listing.get("queries", [])[:1]:
                exemplars.append({
                    "traceId": doc.get("traceId", ""),
                    "latencyMs": doc.get("timings", {}).get("totalMs", 0.0),
                    "source": "ring", "profile": doc})
        except Exception:
            pass

    return {
        "schemaVersion": SCHEMA_VERSION,
        "scenario": sc.to_dict(),
        "target": {"mode": target.mode, "nodes": len(target.base_urls)},
        "arrivals": {
            "process": sc.process,
            "rateTarget": sc.rate,
            "rateAchieved": round(dispatched / elapsed, 2) if elapsed else 0.0,
            "scheduled": len(ops),
            "dispatched": dispatched,
            "maxLagMs": ms(max_lag),
        },
        "perClass": per_class,
        "legs": legs,
        "rates": {
            "shed": delta["qos.shed"],
            "quota": delta["qos.quotaRejected"],
            "deadlineMiss": delta["qos.deadlineMiss"],
            "hedgeFired": delta["cluster.hedgeFired"],
            "hedgeWon": delta["cluster.hedgeWon"],
            "breakerOpens": delta["cluster.breakerOpen"],
        },
        "cache": {
            "hits": hits,
            "misses": misses,
            "hitRatio": round(hits / looked, 4) if looked else 0.0,
        },
        "ingest": None if sc.ingest is None else {
            "vals": ingest_totals["vals"],
            "seconds": round(ingest_totals["seconds"], 3),
            "batches": ingest_totals["batches"],
            "errors": ingest_totals["errors"],
            "mvalsPerS": round(
                ingest_totals["vals"] / ingest_totals["seconds"] / 1e6, 3)
                if ingest_totals["seconds"] else 0.0,
        },
        "chaos": chaos_applied,
        "dr": (None if dr is None else dict(
            dr, failedQueries=int(sum(per_class[c]["counts"]["error"]
                                      for c in per_class)))),
        "partition": (None if partition is None else dict(
            partition,
            failedQueries=int(sum(per_class[c]["counts"]["error"]
                                  for c in per_class)))),
        "translate": translate,
        "exemplars": exemplars,
    }
