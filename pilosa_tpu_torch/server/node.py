"""ServerNode — one pilosa_tpu_torch node, standalone or one member of a
cluster.

The port's counterpart of pilosa_tpu/server/node.py: Holder (on the card by default) + Executor (+ Planner) + API +
HTTPServer, with the QoS front (admission gate, default deadline,
slow-query log, adaptive limit, tenant quotas, kernel warmup), the
result cache, the query-profile ring, the runtime gauges and, with
``data_dir``, the ``storage.DiskStore`` that logs every write, snapshots
and reloads the data dir at boot (and ``warmup.json``, the query shapes
the planner saw, for the next boot's warmup to replay), and the planner's
async path: same-plan dispatch coalescing, inline transfer resolution,
packed residency, the residency prefetcher and the kernel build cache,
the device value transpose's knob (``ingest_transpose``), and backup and
restore: ``POST /backup`` and ``/restore`` drive a ``BackupWriter`` or a
``RestoreJob`` off the request thread, and ``backup_interval`` with
``archive_url`` starts the unattended ``BackupScheduler``.

With ``peers`` the node is one member of a static cluster: a ``Cluster``
over ``HTTPInternalClient`` (``replica_n`` owners a shard, per-peer
circuit breakers, hedged reads, the PTM1 peer channel, TLS client
options), create-shard and index-dirty broadcasts, the liveness sweep
(``cluster.resize.check_nodes``) with quorum fencing, the coordinator's
device reduce (``device_reduce``), coordinator-primary key translation,
the anti-entropy ticker (schema and availability pull, translation pull,
block-checksum repair, the holder cleaner), the serve-through resize
(``join`` to grow, ``POST /cluster/resize/remove-node`` to shrink) with
``topology.json`` in the data dir, the scrubber (``scrub_interval``), the
PTS1 import stream's byte budget (``ingest_max_inflight_mb``) and, with
``chaos_faults``, ``POST /internal/fault``. ``POST /backup`` and
``/restore`` on a member capture the whole cluster and restore across it
(``backup_interval`` runs the scheduler on the coordinator only), and
``trace_endpoint`` exports the node's spans to an OTLP/HTTP collector.
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time

import torch

from pilosa_tpu_torch.cluster.cluster import STATE_NORMAL, Cluster
from pilosa_tpu_torch.cluster.event import EVENT_UPDATE
from pilosa_tpu_torch.cluster.harness import handle_cluster_message
from pilosa_tpu_torch.cluster.node import URI, Node
from pilosa_tpu_torch.cache.result_cache import ResultCache
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.device import resolve_device
from pilosa_tpu_torch.exec import device_reduce as _device_reduce
from pilosa_tpu_torch.exec import fuse as _dispatch_fuse
from pilosa_tpu_torch.exec import ingest_transpose as _ingest_transpose
from pilosa_tpu_torch import sketch as _sketch
from pilosa_tpu_torch.exec import keyplane as _keyplane
from pilosa_tpu_torch.exec import residency as _residency
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.obs import MemoryStats, ProfileRing
from pilosa_tpu_torch.obs.logger import StandardLogger
from pilosa_tpu_torch.obs.runtime import RuntimeMonitor
from pilosa_tpu_torch.parallel import Planner, compile_cache
from pilosa_tpu_torch.parallel import batcher as _transfer_batcher
from pilosa_tpu_torch.parallel import coalesce as _dispatch_coalesce
from pilosa_tpu_torch.parallel import prefetch as _prefetch
from pilosa_tpu_torch.qos import (
    AdaptiveLimit,
    AdmissionController,
    IngestGate,
    SlowQueryLog,
    TenantQuotas,
    WarmupService,
)
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.httpclient import HTTPInternalClient
from pilosa_tpu_torch.server.httpd import HTTPServer


class ServerNode:
    """A runnable node (reference ``pilosa server``, cmd/server.go:64).
    ``device`` defaults to ``cuda`` and raises without a card, as
    ``Holder`` does; ``device="cpu"`` runs the kernels' plain versions on
    the CPU. ``data_dir`` opens (or creates) a data dir before the node
    serves; ``close()`` flushes it. ``peers`` ("host:port" each) makes it
    a member of a cluster with those nodes; ``join`` ("host:port" of a
    running member) asks that cluster's coordinator to grow the ring by
    this node."""

    #: seconds between import-pool top-up checks.
    POOL_TOPUP_INTERVAL = 30.0
    #: repair cadence, seconds (the JAX node's default: repair is on, so a
    #: restarted member converges with no operator action).
    DEFAULT_ANTI_ENTROPY_INTERVAL = 10.0
    #: background scrub cadence, seconds: re-verify on-disk snapshot CRCs
    #: and repair quarantined fragments from replica consensus.
    DEFAULT_SCRUB_INTERVAL = 60.0
    #: liveness sweep cadence, seconds (reference confirmNodeDown).
    DEFAULT_CHECK_NODES_INTERVAL = 5.0
    #: membership push/pull piggybacks on every Nth liveness sweep.
    DISCOVER_EVERY_N_SWEEPS = 5

    def __init__(self, bind: str = "127.0.0.1:10101",
                 device: str | torch.device | None = "cuda",
                 use_planner: bool = True,
                 peers: list[str] | None = None,
                 replica_n: int = 1,
                 check_nodes_interval: float | None = None,
                 breaker_threshold: int = 0,
                 breaker_cooldown: float = 5.0,
                 hedge: bool = False,
                 hedge_delay_ms: float = 0.0,
                 hedge_budget_pct: float = 5.0,
                 fence_stale_reads: bool = False,
                 device_reduce: str = "auto",
                 multiplex: bool = True,
                 tls_ca_cert: str | None = None,
                 tls_skip_verify: bool | None = None,
                 tls_cert: str | None = None,
                 tls_key: str | None = None,
                 backup_interval: float = 0.0,
                 archive_url: str | None = None,
                 backup_full_every: int = 8,
                 backup_keep_chains: int = 2,
                 qos_max_concurrent: int = 0,
                 qos_max_queue: int = 64,
                 qos_internal_reserve: int = 4,
                 qos_class_weights: dict[str, int] | None = None,
                 qos_default_deadline: float = 0.0,
                 qos_slow_query_ms: float = 500.0,
                 qos_adaptive: bool = False,
                 qos_tenant_rate: float = 0.0,
                 qos_tenant_burst: float = 0.0,
                 profile_ring_n: int = 64,
                 profile_queries: bool = True,
                 data_dir: str | None = None,
                 max_op_n: int | None = None,
                 quarantine_keep_n: int = 0,
                 wal_group_commit_ms: float = 0.0,
                 import_pool_mb: int = 0,
                 qos_warmup: str = "",
                 qos_warmup_shards: str = "1,8,32",
                 plan_buckets: str = "pow2",
                 result_cache_mb: int = 64,
                 result_cache_ttl: float = 0.0,
                 dispatch_fuse: str = "auto",
                 dispatch_coalesce: str = "auto",
                 dispatch_coalesce_us: float = 150.0,
                 inline_transfer: str = "auto",
                 residency_packed: str = "auto",
                 prefetch: str = "on",
                 ingest_transpose: str = "auto",
                 translate_planes: str = "auto",
                 sketch_precision: int = 12,
                 sketch_exact_threshold: int = 1024,
                 compile_cache_dir: str | None = None,
                 anti_entropy_interval: float | None = None,
                 scrub_interval: float | None = None,
                 join: str | None = None,
                 chaos_faults: bool = False,
                 ingest_max_inflight_mb: int = 0,
                 trace_endpoint: str | None = None):
        host, _, port = bind.partition(":")
        self.host, self.port = host or "127.0.0.1", int(port or 10101)
        # The node's identity is its address, as its ring entry's is (an
        # ephemeral port resolves it again once the listener binds).
        self.id = f"{self.host}:{self.port}"
        self.stats = MemoryStats()
        self.logger = StandardLogger()
        self.tracer = None
        if trace_endpoint:
            # Spans from this node stream to the OTLP collector at the
            # given endpoint (the JAX node's exporter, obs/otlp.py).
            from pilosa_tpu_torch.obs import OTLPTracer, set_tracer
            self.tracer = OTLPTracer(endpoint=trace_endpoint,
                                     service_name=f"pilosa-tpu:{self.id}")
            set_tracer(self.tracer)
        self._closed = False
        self._backup_interval = float(backup_interval or 0.0)
        self._archive_url = archive_url
        self._backup_full_every = int(backup_full_every)
        self._backup_keep_chains = int(backup_keep_chains)
        self.backup_scheduler = None
        self.backup_archive = None
        self._backup_timer = None
        # Membership: the boot peer list, each "host:port" a Node; the
        # node's id is its address, as its ring entry's is. A TLS node
        # assumes a uniformly TLS cluster: every peer gets https.
        scheme = "https" if tls_cert else "http"
        self._scheme = scheme
        #: address of a running member to join on open(): the coordinator
        #: runs a ResizeJob and broadcasts the new topology back here.
        self.join_addr = join
        if (peers or join) and self.port == 0:
            # The ring names each member by its address: an ephemeral
            # port would leave this node outside its own ring.
            raise ValueError("a cluster member needs a fixed bind port")
        members = []
        for i, addr in enumerate(sorted(set((peers or []) + [f"{self.host}:{self.port}"]))):
            h, _, p = addr.partition(":")
            members.append(Node(id=addr, uri=URI(scheme=scheme, host=h, port=int(p)),
                                is_coordinator=(i == 0 and join is None)))
        self.cluster = None
        self.dirty = None
        index_listener = None
        if len(members) > 1 or join is not None:
            client = HTTPInternalClient(ca_cert=tls_ca_cert,
                                        skip_verify=tls_skip_verify,
                                        device=str(resolve_device(device)))
            client.stats = self.stats
            client.multiplex = bool(multiplex)
            self.cluster = Cluster(local_id=f"{self.host}:{self.port}",
                                   nodes=members, replica_n=replica_n,
                                   client=client)
            self.cluster.stats = self.stats
            self.cluster.set_state(STATE_NORMAL)
            if join is not None:
                # A fresh joiner owns no topology: below version 0, so even
                # a cluster still on its boot ring can hand it its status
                # through the strictly-newer adoption gate (a persisted
                # topology, a restarted joiner's, overrides this below).
                self.cluster.topology_version = -1
            from pilosa_tpu_torch.cluster.dirty import DirtyBroadcaster
            self.dirty = DirtyBroadcaster(self.cluster)
            index_listener = self.dirty.attach
        self.holder = Holder(device=device, index_listener=index_listener,
                             fragment_listener=self._broadcast_shard)
        self.data_dir = data_dir
        # The kernel build cache: None/"" resolves to <data dir>/compile-cache
        # (nodes without a data dir build under build/kernels/), "off"
        # disables it (reference node.py:175-190).
        if not compile_cache_dir:
            compile_cache_dir = (os.path.join(data_dir, "compile-cache")
                                 if data_dir else "")
        self.compile_cache_dir = ("" if compile_cache_dir == "off"
                                  else compile_cache_dir)
        planner = None
        if use_planner:
            if self.compile_cache_dir:
                compile_cache.enable(self.compile_cache_dir)
            planner = Planner(self.holder, bucket_policy=plan_buckets,
                              stats=self.stats,
                              coalesce_window_us=dispatch_coalesce_us)
        # Plan-keyed result cache: byte-bounded, tenant-partitioned;
        # <= 0 MB disables it (every query then runs).
        self.result_cache = None
        if result_cache_mb > 0:
            self.result_cache = ResultCache(max_bytes=int(result_cache_mb) << 20,
                                            ttl=result_cache_ttl,
                                            stats=self.stats)
        self.executor = Executor(self.holder, planner=planner,
                                 stats=self.stats,
                                 result_cache=self.result_cache,
                                 cluster=self.cluster)
        # Partial fusion of mixed trees (exec/fuse.py), same-plan dispatch
        # coalescing, inline transfer resolution, packed leaf stacks
        # (exec/residency.py) and the async miss path;
        # PILOSA_TPU_DISPATCH_FUSE / _DISPATCH_COALESCE / _INLINE_TRANSFER /
        # _RESIDENCY_PACKED / _PREFETCH override per run. The device BSI
        # plane transpose of bulk value imports (exec/ingest_transpose);
        # PILOSA_TPU_INGEST_TRANSPOSE overrides.
        _ingest_transpose.set_mode(ingest_transpose)
        _dispatch_fuse.set_mode(dispatch_fuse)
        _dispatch_coalesce.set_mode(dispatch_coalesce)
        _transfer_batcher.set_inline_mode(inline_transfer)
        _residency.set_mode(residency_packed)
        _prefetch.set_mode(prefetch)
        # Device key planes (exec/keyplane) and the approximate-analytics
        # knobs (sketch); PILOSA_TPU_TRANSLATE_PLANES /
        # _SKETCH_PRECISION / _SKETCH_EXACT_THRESHOLD override per run.
        _keyplane.set_mode(translate_planes)
        _sketch.set_precision(sketch_precision)
        _sketch.set_exact_threshold(sketch_exact_threshold)
        # The coordinator's device fold of remote bitmap legs
        # (exec/device_reduce); PILOSA_TPU_DEVICE_REDUCE overrides.
        _device_reduce.set_mode(device_reduce)
        self._qos_warmup = qos_warmup
        self._qos_warmup_shards = qos_warmup_shards
        self.warmup = None
        self.api = API(self.holder, self.executor, cluster=self.cluster)
        # Hooks of the /internal routes.
        self.api.message_handler = self.handle_message
        self.api.import_handler = self.handle_internal_import
        self.api.resize_handler = self.resize
        self.api.chaos_faults = bool(chaos_faults)
        # In-flight byte budget of the /internal/import-stream pipeline
        # (0 = unbounded): trips 429 + Retry-After, never queues.
        self.ingest_gate = IngestGate(max_inflight_bytes=int(ingest_max_inflight_mb) << 20)
        self.api.ingest_gate = self.ingest_gate
        self.syncer = None
        self.scrubber = None
        self._sync_timer = None
        self._scrub_timer = None
        #: one resize job at a time (reference cluster.go:1447).
        self._resize_gate = threading.Lock()
        #: (topology version, monotonic time from which the cleaner may
        #: drop fragments under it).
        self._clean_lock = threading.Lock()
        self._clean_ring = (0, 0.0)
        self._anti_entropy_interval = (self.DEFAULT_ANTI_ENTROPY_INTERVAL
                                       if anti_entropy_interval is None
                                       else anti_entropy_interval)
        self._scrub_interval = (self.DEFAULT_SCRUB_INTERVAL
                                if scrub_interval is None else scrub_interval)
        self._check_timer = None
        self._check_nodes_interval = (self.DEFAULT_CHECK_NODES_INTERVAL
                                      if check_nodes_interval is None
                                      else check_nodes_interval)
        self._sweep_n = 0
        if self.cluster is not None:
            # Remote legs report their shard-epoch vectors here, the
            # cross-node half of the coordinator's cache stamps.
            self.cluster.epoch_sink = self.executor.remote_epochs.observe
            self.cluster.fence_stale_reads = bool(fence_stale_reads)
            self.cluster.on_unfence = self._on_unfence
            self.cluster.subscribe(self._on_node_event)
            # The chaos partition table is always there; only the
            # chaos-gated /internal/fault route can arm it.
            from pilosa_tpu_torch.cluster.faults import PartitionFaults
            self.cluster.client.faults = PartitionFaults()
            from pilosa_tpu_torch.cluster.sync import HolderSyncer
            self.syncer = HolderSyncer(self.holder, self.cluster, self.cluster.client)
            # Coordinator-primary key allocation (translate.go:93): every
            # keyed allocation routes to the coordinator.
            from pilosa_tpu_torch.cluster.translate_sync import ClusterKeyTranslator
            translator = ClusterKeyTranslator(self.holder, self.cluster,
                                              self.cluster.client)
            self.executor.translator = translator
            self.api.translator = translator
            # Overload plumbing on the inter-node path: per-peer circuit
            # breakers in the transport, hedged read legs in map_reduce.
            if breaker_threshold > 0:
                from pilosa_tpu_torch.cluster.breaker import BreakerRegistry
                self.cluster.client.breakers = BreakerRegistry(
                    threshold=breaker_threshold, cooldown=breaker_cooldown,
                    stats=self.stats)
            if hedge and replica_n > 1:
                from pilosa_tpu_torch.cluster.breaker import HedgePolicy
                self.cluster.hedge = HedgePolicy(
                    delay_s=hedge_delay_ms / 1000.0,
                    budget_pct=hedge_budget_pct, stats=self.stats)
        if data_dir:
            from pilosa_tpu_torch.storage.diskstore import DiskStore
            kw = {} if max_op_n is None else {"max_op_n": max_op_n}
            self.store = DiskStore(data_dir, self.holder, stats=self.stats,
                                   quarantine_keep_n=quarantine_keep_n,
                                   wal_group_window=wal_group_commit_ms / 1000.0,
                                   **kw)
            self.store.open()
        else:
            self.store = None
        self.api.store = self.store
        if self.store is not None:
            from pilosa_tpu_torch.cluster.scrub import route_quarantined_to_replicas
            if self.cluster is not None:
                self._wire_topology_persistence(data_dir)
                # Placement must not hand quarantined shards to this node:
                # their reads go to replicas.
                self.cluster.blocked_shards_fn = self.store.quarantine.blocked_shards
                route_quarantined_to_replicas(self.holder, self.cluster,
                                              self.store, stats=self.stats)
        self._import_pool_mb = int(import_pool_mb)
        self._pool_stop = threading.Event()
        self.runtime_monitor = None
        # QoS front: max_concurrent=0 (the constructor default) leaves the
        # gate open — metrics and slow log only.
        adaptive = None
        if qos_adaptive and qos_max_concurrent > 0:
            # qos_max_concurrent becomes the ceiling; the operative limit
            # is measured.
            adaptive = AdaptiveLimit(ceiling=qos_max_concurrent,
                                     stats=self.stats)
        self.qos = AdmissionController(
            max_concurrent=qos_max_concurrent,
            max_queue=qos_max_queue,
            internal_reserve=qos_internal_reserve,
            weights=qos_class_weights,
            default_deadline=qos_default_deadline,
            stats=self.stats,
            slow_log=SlowQueryLog(threshold_ms=qos_slow_query_ms,
                                  stats=self.stats),
            adaptive=adaptive)
        self.api.qos = self.qos
        if self.store is not None:
            from pilosa_tpu_torch.cluster.scrub import Scrubber
            self.scrubber = Scrubber(
                self.holder, self.cluster,
                self.cluster.client if self.cluster is not None else None,
                self.store, stats=self.stats, logger=self.logger,
                admission=self.qos)
        # Slowest-N query profiles at /debug/queries; profile_queries=False
        # limits profiling to explicit ?profile=true requests.
        self.profile_ring = (ProfileRing(capacity=profile_ring_n)
                             if profile_ring_n > 0 else None)
        self.api.profile_ring = self.profile_ring
        self.api.profile_default = bool(profile_queries)
        # Per-tenant token buckets above class admission (429, not 503).
        self.quotas = None
        if qos_tenant_rate > 0:
            self.quotas = TenantQuotas(rate_per_s=qos_tenant_rate,
                                       burst=qos_tenant_burst or None,
                                       stats=self.stats)
        self.api.quotas = self.quotas
        self.http = HTTPServer(self.api, self.host, self.port,
                               tls_cert=tls_cert, tls_key=tls_key)
        self.port = self.http.port
        self.id = f"{self.host}:{self.port}"
        # Built after the listener resolves an ephemeral port, so
        # /internal/fragment/nodes advertises an address a client can dial.
        self.api.local_node = Node(
            id=self.id, uri=URI(scheme=scheme, host=self.host, port=self.port),
            is_coordinator=True)
        # Backup/restore hooks (POST /backup, /restore). One run of
        # each at a time; jobs run off the request thread and
        # /backup/status, /restore/status read their live progress.
        self._backup_gate = threading.Lock()
        self._restore_gate = threading.Lock()
        self._backup_writer = None
        self._restore_job = None
        if self.store is not None:
            self.api.backup_handler = self.handle_backup
            self.api.backup_status_handler = self.backup_status
            self.api.restore_handler = self.handle_restore
            self.api.restore_status_handler = self.restore_status
        self.api.backup_debug_handler = self.backup_debug

    def _wire_topology_persistence(self, data_dir: str) -> None:
        """Durable topology (reference .topology file, cluster.go:1657):
        every committed nodes/version change is written to
        topology.json, and boot resumes from it. Without this, a
        restarted coordinator's in-memory version resets to 0, its next
        commit broadcasts "version 1", and every peer holding a higher
        version silently rejects the committed ring as stale — a forked
        cluster."""
        path = os.path.join(data_dir, "topology.json")
        save_lock = threading.Lock()
        last_saved = [-1]

        def save() -> None:
            with self.cluster._lock:
                doc = {"version": self.cluster.topology_version,
                       "replicaN": self.cluster.replica_n,
                       "partitionN": self.cluster.partition_n,
                       "nodes": [n.to_json() for n in self.cluster.nodes]}
            # Serialize + version-guard the replace: two concurrent
            # savers (a status RPC and a sweep) must not interleave
            # writes in one tmp, and the one holding the OLDER snapshot
            # must not win the replace — a restart would restore the
            # older ring and fork the cluster (the bug this file
            # exists to prevent). Same pattern as DiskStore.save_schema.
            with save_lock:
                if doc["version"] < last_saved[0]:
                    return
                tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                os.replace(tmp, path)
                last_saved[0] = doc["version"]

        self.cluster.save_hook = save
        # Sweep tmps a crashed saver stranded (see DiskStore.open).
        try:
            for fn in os.listdir(data_dir):
                if fn.startswith("topology.json.") and fn.endswith(".tmp"):
                    os.remove(os.path.join(data_dir, fn))
        except OSError:
            pass
        try:
            with open(path) as f:
                doc = json.load(f)
            version = int(doc.get("version", 0))
            saved = [Node.from_json(n) for n in doc.get("nodes", [])]
        except Exception:
            # Best-effort restore: a torn/hand-edited file must fall
            # back to the boot peer list, never crash the boot.
            return
        if version <= self.cluster.topology_version or not saved:
            return
        if not any(n.id == self.id for n in saved):
            # The durable ring excludes US: we were removed while down.
            # Keep the boot list; rejoining is the operator's call.
            return
        self.cluster.nodes = sorted(saved, key=lambda n: n.id)
        self.cluster.topology_version = version
        # Settings adopted from broadcasts are part of the ring: a
        # restart that reverted to boot-config replicaN would compute
        # different placement and the cleaner would GC live replicas.
        if doc.get("replicaN"):
            self.cluster.replica_n = int(doc["replicaN"])
        if doc.get("partitionN"):
            self.cluster.partition_n = int(doc["partitionN"])
        last_saved[0] = version

    def open(self) -> None:
        merge = None
        if self.cluster is not None and self.join_addr is None:
            # A member (re)starting into a running cluster merges its
            # peers' schema and shard availability as soon as it serves,
            # and holds its queries until then: a query through it must
            # not miss the shards created while it was down. The JAX node
            # first merges on its anti-entropy tick, one interval after it
            # serves (ROADMAP.md Queue 3, F1). The merge runs off this
            # thread, so members booting together (each one serving before
            # it asks the others) never wait on each other.
            merged = threading.Event()
            self.api.peers_merged = merged

            def merge_peers():
                try:
                    self._sync_schema()
                finally:
                    merged.set()
            merge = merge_peers
        self.http.serve_background()
        if merge is not None:
            threading.Thread(target=merge, name="peer-merge", daemon=True).start()
        if self._import_pool_mb > 0:
            # Fault the codec's import buffer pool off the serving path,
            # then keep it topped up: dense imports adopt pool-backed
            # blocks as fragment storage, draining the free list.
            def _warm(mb: int = self._import_pool_mb) -> None:
                from pilosa_tpu_torch import native
                target = mb << 20
                native.pool_reserve(target)
                while not self._pool_stop.wait(self.POOL_TOPUP_INTERVAL):
                    stats = native.pool_stats()
                    if stats is None:
                        return
                    deficit = target - stats["free_bytes"]
                    if deficit > target // 2:
                        native.pool_reserve(deficit)
            threading.Thread(target=_warm, daemon=True,
                             name="pool-warm").start()
        if (self._backup_interval > 0 and self._archive_url
                and self.store is not None):
            from pilosa_tpu_torch.backup import BackupScheduler, open_archive
            self.backup_archive = open_archive(self._archive_url, stats=self.stats)
            self.backup_scheduler = BackupScheduler(
                holder=self.holder, cluster=self.cluster,
                client=(self.cluster.client
                        if self.cluster is not None else None),
                store=self.store, archive=self.backup_archive,
                interval=self._backup_interval, node_id=self.id,
                stats=self.stats, logger=self.logger, admission=self.qos,
                full_every=self._backup_full_every,
                keep_chains=self._backup_keep_chains)
            self._schedule_backup()
        if self.join_addr is not None:
            self._send_join()
        if self.syncer is not None and self._anti_entropy_interval > 0:
            self._schedule_sync()
        if self.cluster is not None and self._check_nodes_interval > 0:
            self._schedule_check_nodes()
        if self.scrubber is not None and self._scrub_interval > 0:
            self._schedule_scrub()
        self.runtime_monitor = RuntimeMonitor(self.stats,
                                              self.executor.planner,
                                              qos=self.qos)
        self.runtime_monitor.start()
        if self._qos_warmup and self.executor.planner is not None:
            # Build the CUDA sources and launch the canonical shapes in
            # the background; node start never waits on nvcc.
            kinds = [k.strip() for k in self._qos_warmup.split(",")
                     if k.strip()]
            shard_counts = [int(x) for x in str(self._qos_warmup_shards).split(",")
                            if x.strip()]
            observed, observed_schema = self._load_observed_traffic()
            self.warmup = WarmupService(self.executor.planner, kinds=kinds,
                                        shard_counts=shard_counts,
                                        observed=observed,
                                        observed_schema=observed_schema,
                                        stats=self.stats)
            self.warmup.start()

    def close(self) -> None:
        self._closed = True
        self._pool_stop.set()
        if self.tracer is not None:
            from pilosa_tpu_torch.obs import NopTracer, get_tracer, set_tracer
            if get_tracer() is self.tracer:
                set_tracer(NopTracer())  # don't leave a closed exporter
            self.tracer.close()
        if self.dirty is not None:
            self.dirty.close()
        if self.cluster is not None:
            self.cluster.close()
            self.cluster.client.close()
        self.http.close()
        for timer in (self._sync_timer, self._check_timer, self._scrub_timer):
            if timer is not None:
                timer.cancel()
        if self._backup_timer is not None:
            self._backup_timer.cancel()
        if self.backup_archive is not None:
            try:
                self.backup_archive.close()
            except Exception:
                pass
        if self.runtime_monitor is not None:
            self.runtime_monitor.close()
        if self.warmup is not None:
            self.warmup.close()
        self._save_observed_traffic()
        if self.executor.planner is not None:
            self.executor.planner.close()
        if self.store is not None:
            self.store.close()

    def _schedule_backup(self) -> None:
        """Tick the scheduler at half the backup interval (jittered); its
        own due/backoff gating makes extra ticks free."""
        def tick():
            try:
                if self._backup_gate.acquire(blocking=False):
                    try:
                        self.backup_scheduler.tick()
                    finally:
                        self._backup_gate.release()
            except Exception as e:
                # scheduler.tick never raises; belt and braces.
                self.stats.count("node.timerTickError")
                self.logger.printf("%s timer tick failed: %s: %s", "backup",
                                   type(e).__name__, e)
            finally:
                if not self._closed:
                    self._schedule_backup()
        delay = max(0.05, self._backup_interval / 2.0) * random.uniform(0.8, 1.2)
        self._backup_timer = threading.Timer(delay, tick)
        self._backup_timer.daemon = True
        self._backup_timer.start()

    # -- cluster (reference node.py:587-1171) -------------------------------

    #: join announcement retry schedule (seconds between attempts);
    #: after JOIN_RETRIES fast attempts the announcer drops to the slow
    #: cadence but never stops (a solo joiner has no other path in).
    JOIN_RETRY_DELAY = 1.0
    JOIN_RETRIES = 30
    JOIN_SLOW_RETRY_DELAY = 5.0

    def _send_join(self) -> None:
        """Announce to a running member in the background, retrying —
        the seed may still be booting (the reference's gossip join
        retries the same way, gossip/gossip.go:65). The member forwards
        to the coordinator, which resizes us in and broadcasts the
        topology back (cluster.go:1796)."""
        h, _, p = self.join_addr.partition(":")
        seed = Node(id=self.join_addr,
                    uri=URI(scheme=self._scheme, host=h, port=int(p)))

        def announce():
            attempts = 0
            while not self._closed:
                # Success = this node appears in the ring (the topology
                # broadcast landed), NOT merely a delivered announce —
                # the coordinator's resize runs asynchronously and can
                # fail after accepting.
                if len(self.cluster.nodes) > 1:
                    return
                try:
                    self.cluster.client.send_message(
                        seed, {"type": "node-join", "addr": self.id})
                except Exception:
                    # A paused/overloaded seed times out (OSError, not
                    # ConnectionError); ANY failure here must not kill
                    # the announce thread — it is a solo joiner's only
                    # path into the ring.
                    pass
                attempts += 1
                if attempts == self.JOIN_RETRIES:
                    # Never give up outright: a solo joiner has no peers
                    # to discover the ring through, so announcing IS its
                    # only path in (the seed may be mid-resize, paused,
                    # or restarting for minutes). Drop to a slow cadence
                    # and warn.
                    print(f"join: cluster at {self.join_addr} did not "
                          f"admit us after {self.JOIN_RETRIES} attempts; "
                          f"retrying every "
                          f"{self.JOIN_SLOW_RETRY_DELAY:.0f}s",
                          file=sys.stderr)
                time.sleep(self.JOIN_RETRY_DELAY
                           if attempts < self.JOIN_RETRIES
                           else self.JOIN_SLOW_RETRY_DELAY)

        t = threading.Thread(target=announce, name="join-announce",
                             daemon=True)
        t.start()

    def _jitter(self, interval: float) -> float:
        return interval * random.uniform(0.8, 1.2)

    def _timer_tick_error(self, timer: str, err: BaseException) -> None:
        """A background sweep blew up: the tick survives (the next one
        retries), but the failure is counted and logged."""
        self.stats.count("node.timerTickError")
        self.logger.printf("%s timer tick failed: %s: %s",
                           timer, type(err).__name__, err)

    def check_nodes(self) -> list[str]:
        """One liveness sweep (the timer's body): probe every peer, mark
        the unreachable DOWN and the returned READY, and fence this node
        without a quorum. Returns the ids whose state changed."""
        from pilosa_tpu_torch.cluster.resize import check_nodes
        self._sweep_n += 1
        changed = check_nodes(self.cluster, self.cluster.client,
                              discover=self._sweep_n % self.DISCOVER_EVERY_N_SWEEPS == 0)
        if changed:
            self.stats.count("checkNodesChanged", len(changed))
        return changed

    def _schedule_check_nodes(self) -> None:
        def tick():
            try:
                self.check_nodes()
            except Exception as e:
                # A dead failure detector is the worst silent failure:
                # DOWN peers never get marked, writes hang on them.
                self._timer_tick_error("check-nodes", e)
            finally:
                if not self._closed:
                    self._schedule_check_nodes()
        self._check_timer = threading.Timer(self._jitter(self._check_nodes_interval), tick)
        self._check_timer.daemon = True
        self._check_timer.start()

    def _on_unfence(self) -> None:
        """Fence lifted (the liveness sweep sees a majority again):
        this node just rejoined from a minority partition, so its data
        AND caches may be behind the majority's writes. Kick an
        immediate dirty-sync — schema adoption + fragment anti-entropy
        — and flush epoch-validated result caches, off the sweep
        thread (same shape as the READY-event repair)."""
        if self._closed:
            return
        self.logger.printf("quorum regained: un-fenced, starting "
                           "rejoin dirty-sync")

        def resync():
            try:
                for iname in self.holder.index_names():
                    idx = self.holder.index(iname)
                    if idx is not None:
                        # Local caches validated against pre-partition
                        # epochs would serve stale reads until the next
                        # write; bump first so repaired bits are seen.
                        idx.epoch.bump(notify=False)
                if self.cluster is not None:
                    self._sync_schema()
                if self.syncer is not None:
                    self.syncer.sync_holder()
            except Exception:
                pass  # the anti-entropy ticker retries
        threading.Thread(target=resync, name="unfence-resync",
                         daemon=True).start()

    def _on_node_event(self, ev) -> None:
        """NodeEvent consumer (reference ReceiveEvent, cluster.go:1754):
        count the stream, and when a peer comes BACK, kick an immediate
        repair pass instead of waiting out the anti-entropy ticker."""
        self.stats.with_tags(f"event:{ev.type}").count("nodeEvents")
        if (ev.type == EVENT_UPDATE and ev.state == "READY"
                and self.syncer is not None and not self._closed):
            def repair():
                try:
                    self._sync_schema()
                    self.syncer.sync_holder()
                except Exception:
                    pass  # ticker retries
            threading.Thread(target=repair, name="event-repair",
                             daemon=True).start()
        if (ev.type == EVENT_UPDATE and ev.state == "READY"
                and self.cluster is not None and not self._closed):
            # A rejoined peer missed every index-dirty broadcast while
            # it was (or merely LOOKED) down — its epoch-validated
            # result caches would serve stale reads until the next
            # write. Push it a full invalidation sweep; and flush our
            # own caches too, since the asymmetric case (it was serving
            # writes we never heard about) leaves OUR caches stale.
            def invalidate(node_id=ev.node_id):
                node = self.cluster.node_by_id(node_id)
                for iname in self.holder.index_names():
                    idx = self.holder.index(iname)
                    if idx is not None:
                        idx.epoch.bump(notify=False)
                    if node is None:
                        continue
                    try:
                        self.cluster.client.send_message(
                            node, {"type": "index-dirty", "index": iname})
                    except (ConnectionError, RuntimeError, LookupError):
                        pass  # next sweep's READY flap retries
            threading.Thread(target=invalidate, name="rejoin-invalidate",
                             daemon=True).start()

    def _sync_schema(self) -> None:
        """Adopt any peer schema this node is missing (a restarted
        member without its data dir re-learns indexes/fields before the
        fragment syncer can repair their bits) AND merge peers' shard
        availability — the additive half of the reference's NodeStatus
        merge (server.go:640: schema + availableShards). Without the
        availability half, a node that missed create-shard broadcasts
        while down answers queries without those shards forever (found
        by the chaos soak: permanent undercounts after rejoin)."""
        for node in self.cluster.nodes:
            if node.id == self.id or node.state == "DOWN":
                continue
            try:
                self.holder.apply_schema(self.cluster.client.schema(node))
            except (ConnectionError, RuntimeError, LookupError, KeyError):
                continue
            try:
                avail = self.cluster.client.availability(node)
                for index, fields in (avail or {}).items():
                    idx = self.holder.index(index)
                    if idx is None:
                        continue
                    for field, shards in fields.items():
                        f = idx.field(field)
                        if f is not None and shards:
                            f.add_remote_available_shards(shards)
            except (ConnectionError, RuntimeError, LookupError, KeyError,
                    AttributeError):
                continue

    def _schedule_sync(self) -> None:
        def tick():
            try:
                from pilosa_tpu_torch.cluster.translate_sync import sync_translation
                self._sync_schema()
                applied = sync_translation(self.holder, self.cluster,
                                           self.cluster.client)
                repaired = self.syncer.sync_holder()
                self.clean_holder()  # ownership GC backstop
                if applied:
                    self.stats.count("antiEntropyTranslateApplied", applied)
                if repaired:
                    self.stats.count("antiEntropyRepaired", repaired)
                self.stats.count("antiEntropyPasses")
            except Exception as e:
                # Next tick retries; repairs must never kill the node —
                # but the failure must be visible, not swallowed.
                self._timer_tick_error("anti-entropy", e)
            finally:
                if not self._closed:
                    self._schedule_sync()
        self._sync_timer = threading.Timer(
            self._jitter(self._anti_entropy_interval), tick)
        self._sync_timer.daemon = True
        self._sync_timer.start()

    def _schedule_scrub(self) -> None:
        def tick():
            try:
                res = self.scrubber.scrub_pass()
                if res.get("mismatch"):
                    self.stats.count("integrity.scrubMismatchFragments",
                                     res["mismatch"])
            except Exception as e:
                # Next tick retries; the scrub must never kill the node.
                self._timer_tick_error("scrub", e)
            finally:
                if not self._closed:
                    self._schedule_scrub()
        self._scrub_timer = threading.Timer(
            self._jitter(self._scrub_interval), tick)
        self._scrub_timer.daemon = True
        self._scrub_timer.start()

    def _broadcast_shard(self, index: str, field: str, view: str, shard: int):
        """A new local fragment: tell every live peer (CreateShardMessage,
        view.go:263-304) so their shard maps stay complete."""
        if self.cluster is None:
            return
        msg = {"type": "create-shard", "index": index, "field": field,
               "shard": shard}
        for node in self.cluster.nodes:
            if node.id == self.cluster.local_id or node.state == "DOWN":
                continue
            try:
                self.cluster.client.send_message(node, msg)
            except (ConnectionError, RuntimeError):
                pass

    def handle_message(self, message: dict) -> None:
        """POST /internal/cluster/message: schema, availability, index-dirty,
        resize, topology and join messages (reference receiveMessage,
        server.go:569-663)."""
        t = message.get("type")
        if t == "resize-instruction" and self.cluster is not None:
            from pilosa_tpu_torch.cluster.resize import handle_resize_instruction
            handle_resize_instruction(self.holder, self.cluster.client,
                                      self.cluster, message, self.id)
        elif t == "resize-instruction-complete":
            from pilosa_tpu_torch.cluster.resize import deliver_completion
            deliver_completion(message)
        elif t == "index-dirty":
            if (self.cluster is not None
                    and not self.cluster.check_fencing_token(message)):
                return  # stale coordinator's dirty coordination
            from pilosa_tpu_torch.cluster.dirty import apply_index_dirty
            apply_index_dirty(self.holder, message,
                              self.executor.remote_epochs)
        elif t == "cluster-status" and self.cluster is not None:
            from pilosa_tpu_torch.cluster.resize import apply_cluster_status
            apply_cluster_status(self.cluster, message["nodes"],
                                 holder=self.holder,
                                 availability=message.get("availability"),
                                 replica_n=message.get("replicaN"),
                                 partition_n=message.get("partitionN"),
                                 version=message.get("version"))
            # Topology changed: GC fragments this node no longer owns
            # (holderCleaner, holder.go:1126), once the grace has passed.
            self._schedule_clean()
        elif t == "cluster-state" and self.cluster is not None:
            from pilosa_tpu_torch.cluster.resize import apply_cluster_state
            apply_cluster_state(self.cluster, message["state"])
        elif t == "resize-begin" and self.cluster is not None:
            from pilosa_tpu_torch.cluster.resize import apply_resize_begin
            apply_resize_begin(self.cluster, message, holder=self.holder)
        elif t == "resize-end" and self.cluster is not None:
            from pilosa_tpu_torch.cluster.resize import apply_resize_end
            apply_resize_end(self.cluster, message)
        elif t == "resize-push" and self.cluster is not None:
            from pilosa_tpu_torch.cluster.resize import handle_resize_push
            return handle_resize_push(self.holder, self.cluster.client,
                                      self.cluster, message)
        elif t == "resize-shard-cutover":
            from pilosa_tpu_torch.cluster.resize import deliver_cutover
            deliver_cutover(message, self.cluster)
        elif t == "resize-dual-write-failed":
            from pilosa_tpu_torch.cluster.resize import deliver_dual_write_failed
            deliver_dual_write_failed(message)
        elif t in ("delete-index", "delete-field", "delete-view"):
            # Apply to the holder (shared handler), then unlink the
            # on-disk tree: a peer that kept the stale files would
            # resurrect the deleted data into a recreated same-name
            # index/field/view on restart.
            handle_cluster_message(self.holder, message)
            if self.store is not None:
                prefix = [message["index"]]
                if t != "delete-index":
                    prefix.append(message["field"])
                if t == "delete-view":
                    prefix.append(message["view"])
                self.store.delete_subtree_files(*prefix)
        elif t == "node-join" and self.cluster is not None:
            self.handle_join(message["addr"])
        else:
            handle_cluster_message(self.holder, message)
            if t in ("create-index", "create-field") and self.store is not None:
                self.store.save_schema()

    def handle_join(self, addr: str) -> str:
        """A node announced itself. Non-coordinators forward; the
        coordinator runs the add-resize (stream fragments, then commit +
        broadcast the topology — the joiner learns the ring from the
        cluster-status broadcast). Reference: eventReceiver -> nodeJoin
        -> resize job (gossip/gossip.go:364, cluster.go:1796)."""
        coord = self.cluster.coordinator()
        if coord is not None and coord.id == addr:
            # The flagged coordinator is announcing itself as a JOINER:
            # its process restarted without cluster state, so the node
            # every peer would forward this join to is precisely the one
            # that cannot handle it (found by the chaos soak — a
            # leaderless wedge where the solo ex-coordinator announced
            # into a ring that kept forwarding the announce back to it).
            # Deterministic handover: the first surviving member acts,
            # takes the flag, and the commit broadcast carries it.
            survivors = sorted(
                (n for n in self.cluster.nodes if n.id != addr),
                key=lambda n: (n.state == "DOWN", n.id))  # live first
            if not survivors:
                raise RuntimeError(
                    "no surviving member to take over the join")
            coord = survivors[0]
            if coord.id == self.id:
                # The handover is a TOPOLOGY CHANGE, not a local note:
                # bump the version, persist, and broadcast, or peers
                # (whose strictly-newer gate rejects same-version
                # views) would keep forwarding joins to the stateless
                # ex-coordinator and a restart would restore its flag
                # from the old topology.json.
                with self.cluster._lock:
                    for n in self.cluster.nodes:
                        n.is_coordinator = (n.id == self.id)
                    self.cluster.topology_version += 1
                    status = {"type": "cluster-status",
                              "nodes": [n.to_json()
                                        for n in self.cluster.nodes],
                              "replicaN": self.cluster.replica_n,
                              "partitionN": self.cluster.partition_n,
                              "version": self.cluster.topology_version}
                self.cluster.notify_topology()
                for n in self.cluster.nodes:
                    if n.id != self.id and n.state != "DOWN":
                        try:
                            self.cluster.client.send_message(n, status)
                        except Exception:
                            pass  # discovery pulls converge them later
                coord = self.cluster.node_by_id(self.id)
        if coord is None:
            raise RuntimeError("no coordinator to handle join")
        if coord.id != self.id:
            self.cluster.client.send_message(
                coord, {"type": "node-join", "addr": addr})
            return "FORWARDED"
        member = self.cluster.node_by_id(addr)
        if member is not None:
            # Idempotent re-admission: a joiner that is already in OUR
            # ring but keeps announcing missed the commit broadcast (it
            # is sitting solo, and a solo node has no peers to discover
            # the ring through). Re-send the committed topology so a
            # lost commit can never wedge a member outside the ring it
            # belongs to (found by the chaos soak, seed 104).
            from pilosa_tpu_torch.cluster.resize import holder_availability
            status = {"type": "cluster-status",
                      "nodes": [n.to_json() for n in self.cluster.nodes],
                      "replicaN": self.cluster.replica_n,
                      "partitionN": self.cluster.partition_n,
                      "version": self.cluster.topology_version,
                      "availability": holder_availability(self.holder)}
            try:
                self.cluster.client.send_message(member, status)
            except (ConnectionError, RuntimeError):
                pass
            return "ALREADY_MEMBER"
        # Run the (possibly long) data-moving resize OFF the request
        # thread: the joiner's announce would otherwise time out on big
        # transfers and its retry would race a second job. The gate
        # makes duplicate/overlapping announces no-ops.
        if self._resize_gate.locked():
            return "RESIZING"

        def run():
            try:
                self.resize("add", addr=addr)
            except (RuntimeError, ConnectionError, ValueError):
                pass  # joiner keeps announcing; next attempt retries

        threading.Thread(target=run, name="join-resize",
                         daemon=True).start()
        return "STARTED"

    def resize(self, action: str, node_id: str | None = None,
               addr: str | None = None) -> str:
        """Coordinator-driven membership change (api.go RemoveNode :1220;
        node addition = reference's join-triggered resize). ONE job at a
        time (the reference's single-job state machine,
        cluster.go:1447): a second request while one runs is rejected."""
        if self.cluster is None:
            raise RuntimeError("standalone node cannot resize")
        # Resizes RUN on the flagged coordinator: the stuck-RESIZING
        # recovery heuristic consults the coordinator's state as the
        # resize authority, so a job running anywhere else would make
        # that heuristic (a) never recover if this node died mid-job,
        # or (b) falsely reopen peer gates while the job lives.
        # Non-coordinators REFUSE with the coordinator's address, like
        # the reference (cluster.go:1870) — forwarding fire-and-forget
        # would hide failures from the operator, and divergent
        # coordinator views could ping-pong the message forever.
        coord = self.cluster.coordinator()
        if coord is not None and coord.id != self.id:
            raise RuntimeError(
                "node removal requests are only valid on the coordinator "
                f"node: {coord.id}")
        from pilosa_tpu_torch.cluster.resize import ResizeJob
        new_nodes = [Node(id=n.id, uri=n.uri, is_coordinator=n.is_coordinator)
                     for n in self.cluster.nodes]
        if action == "remove":
            new_nodes = [n for n in new_nodes if n.id != node_id]
            if new_nodes and not any(n.is_coordinator for n in new_nodes):
                # Never commit a leaderless ring (joins would have no
                # authority to land on): hand the flag to this node —
                # the one running the job — else the first LIVE
                # survivor (a dead coordinator would route every
                # join/resize at a corpse).
                keep = next(
                    (n for n in new_nodes if n.id == self.id),
                    min(new_nodes,
                        key=lambda n: (n.state == "DOWN", n.id)))
                keep.is_coordinator = True
        elif action == "add":
            h, _, p = (addr or "").partition(":")
            new_nodes.append(Node(id=addr,
                                  uri=URI(scheme=self._scheme,
                                          host=h, port=int(p))))
        else:
            raise ValueError(f"unknown resize action {action!r}")
        if not self._resize_gate.acquire(blocking=False):
            raise RuntimeError("resize already in progress")
        try:
            job = ResizeJob(self.cluster, self.holder, self.cluster.client,
                            store=self.store)
            job.cleaner = self._schedule_clean
            self.api.resize_job = job
            return job.run(new_nodes)
        finally:
            self._resize_gate.release()

    #: seconds a newly adopted ring stands before this node's cleaner drops
    #: what it no longer owns. Peers adopt a commit one broadcast apart, and
    #: a query planned under the old ring can still send a leg here for a
    #: shard that moved away: until the grace has passed, the fragment
    #: answers it. (The JAX node cleans at once, and such a read misses
    #: the shard: ROADMAP.md Queue 3.)
    CLEANER_GRACE_S = 5.0

    def _schedule_clean(self) -> None:
        """A ring was just adopted: run the cleaner once it has stood
        CLEANER_GRACE_S."""
        with self._clean_lock:
            self._clean_ring = (self.cluster.topology_version,
                                time.monotonic() + self.CLEANER_GRACE_S)
        self._clean_later()

    def _clean_later(self) -> None:
        timer = threading.Timer(self.CLEANER_GRACE_S + 0.05, self.clean_holder)
        timer.daemon = True
        timer.start()

    def clean_holder(self) -> int:
        """holderCleaner (holder.go:1126): drop fragments this node no
        longer owns; also runs as an anti-entropy backstop. Nothing is
        dropped until the ring has stood CLEANER_GRACE_S unchanged."""
        if self.cluster is None:
            return 0
        now = time.monotonic()
        with self._clean_lock:
            version = self.cluster.topology_version
            fresh = version != self._clean_ring[0]
            if fresh:  # a ring adopted without _schedule_clean (a discovery pull)
                self._clean_ring = (version, now + self.CLEANER_GRACE_S)
            early = now < self._clean_ring[1]
        if early:
            if fresh:
                self._clean_later()
            return 0
        from pilosa_tpu_torch.cluster.cleaner import clean_holder
        try:
            n = clean_holder(self.holder, self.cluster, store=self.store)
        except Exception:
            return 0  # GC must never take down the node
        if n:
            self.stats.count("holderCleanerRemoved", n)
        return n

    def handle_internal_import(self, req: dict) -> None:
        """/internal/import payloads: a routed field import (a shard's
        batch for this owner), or a fragment-level one. Gated by the
        cluster's state as the public import is, with internal=True:
        peer-forwarded writes land even on a fenced receiver."""
        from pilosa_tpu_torch.core.field import parse_stamps
        self.api._validate("import", internal=True)
        index, field = req["index"], req["field"]
        f = self.holder.field(index, field)
        if f is None:
            raise LookupError(f"field not found: {index}/{field}")
        clear = req.get("clear", False)
        if req.get("kind") == "fragment":
            frag = f.create_view_if_not_exists(req["view"]).create_fragment_if_not_exists(
                req["shard"])
            frag.bulk_import(req["rowIDs"], req["columnIDs"], clear=clear)
        elif req.get("values") is not None:
            f.import_values(req["columnIDs"], req["values"], clear=clear)
            self.holder.index(index).add_existence(req["columnIDs"])
        else:
            ts = req.get("timestamps")
            f.import_bits(req["rowIDs"], req["columnIDs"],
                          parse_stamps(ts) if ts is not None else None, clear=clear)
            self.holder.index(index).add_existence(req["columnIDs"])

    # -- backup / restore (reference node.py:1175-1285) --------------------

    def handle_backup(self, req: dict) -> dict:
        """POST /backup: start a cluster backup into the archive named in
        the request (directory path or object-store URL); returns the
        backup id immediately (poll /backup/status)."""
        from pilosa_tpu_torch.backup import (
            BackupError,
            BackupWriter,
            new_backup_id,
            open_archive,
        )
        req = req or {}
        root = req.get("archive")
        if not root:
            raise BackupError("backup: 'archive' (directory path or URL) is required")
        parent = req.get("parent") or None
        archive = open_archive(root, stats=self.stats)
        if parent and not archive.has_manifest(parent):
            raise BackupError(f"backup: parent {parent!r} not found in archive")
        if not self._backup_gate.acquire(blocking=False):
            raise BackupError("backup already in progress")
        backup_id = new_backup_id("incremental" if parent else "full")
        writer = BackupWriter(
            self.holder, self.cluster,
            self.cluster.client if self.cluster is not None else None,
            self.store, archive, stats=self.stats, admission=self.qos)
        writer.progress = {"state": "starting", "id": backup_id}
        self._backup_writer = writer

        def run():
            try:
                writer.run(backup_id=backup_id, parent=parent)
            except Exception:
                pass  # progress carries state=failed + the error text
            finally:
                self._backup_gate.release()

        threading.Thread(target=run, name="backup", daemon=True).start()
        return {"id": backup_id, "state": "started"}

    def backup_status(self) -> dict:
        w = self._backup_writer
        return dict(w.progress) if w is not None else {"state": "idle"}

    def handle_restore(self, req: dict) -> dict:
        """POST /restore: rebuild the backed-up indexes onto THIS cluster
        (any size) from the archive; returns immediately (poll
        /restore/status). ``id`` defaults to the newest complete backup;
        ``pitrOps`` caps WAL replay for point-in-time recovery."""
        from pilosa_tpu_torch.backup import (
            BackupError,
            RestoreJob,
            open_archive,
            select_backup_at,
        )
        req = req or {}
        root = req.get("archive")
        if not root:
            raise BackupError("restore: 'archive' (directory path or URL) is required")
        archive = open_archive(root, stats=self.stats)
        backup_id = req.get("id")
        if not backup_id:
            m = select_backup_at(archive, time.time())
            if m is None:
                raise BackupError("restore: no complete backup in archive")
            backup_id = m["id"]
        elif not archive.has_manifest(backup_id):
            raise BackupError(f"restore: backup {backup_id!r} not found in archive")
        pitr = req.get("pitrOps")
        if not self._restore_gate.acquire(blocking=False):
            raise BackupError("restore already in progress")
        job = RestoreJob(self.holder, self.cluster,
                         self.cluster.client if self.cluster is not None else None,
                         archive, backup_id, store=self.store, stats=self.stats,
                         force=bool(req.get("force")),
                         pitr_ops=int(pitr) if pitr is not None else None)
        job.progress = {"state": "starting", "id": backup_id}
        self._restore_job = job

        def run():
            try:
                job.run()
            except Exception:
                pass  # progress carries state=failed + the error text
            finally:
                self._restore_gate.release()

        threading.Thread(target=run, name="restore", daemon=True).start()
        return {"id": backup_id, "state": "started"}

    def restore_status(self) -> dict:
        j = self._restore_job
        return dict(j.progress) if j is not None else {"state": "idle"}

    def backup_debug(self) -> dict:
        """GET /debug/backup: the scheduler's health document, or a stub
        when unattended backups aren't configured on this node."""
        if self.backup_scheduler is None:
            return {"enabled": False}
        doc = self.backup_scheduler.status()
        doc["enabled"] = True
        doc["archive"] = self._archive_url
        return doc

    # -- warmup from observed traffic (reference node.py:1286-1322) --------

    def _save_observed_traffic(self) -> None:
        """Persist the planner's observed query shapes and the schema they
        run against to ``<data dir>/warmup.json``: best effort."""
        planner = self.executor.planner
        if not self.data_dir or planner is None:
            return
        observed = planner.observed_traffic()
        if not observed:
            return
        path = os.path.join(self.data_dir, "warmup.json")
        try:
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"version": 1, "entries": observed,
                           "schema": self.holder.schema()}, f)
            os.replace(tmp, path)
        except OSError:
            pass  # warmup hints never block shutdown

    def _load_observed_traffic(self) -> tuple[list, list]:
        if not self.data_dir:
            return [], []
        try:
            with open(os.path.join(self.data_dir, "warmup.json")) as f:
                doc = json.load(f)
            return list(doc.get("entries", [])), list(doc.get("schema", []))
        except (OSError, ValueError):
            return [], []

    @property
    def address(self) -> str:
        return self.http.address
