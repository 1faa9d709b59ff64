"""ServerNode — one standalone pilosa_tpu_torch node.

The port's counterpart of pilosa_tpu/server/node.py for a node with no
peers: Holder (on the card by default) + Executor (+ Planner) + API +
HTTPServer, with the QoS front (admission gate, default deadline,
slow-query log, adaptive limit, tenant quotas), the query-profile ring,
the runtime gauges and, with ``data_dir``, the ``storage.DiskStore`` that
logs every write, snapshots and reloads the data dir at boot. Peers,
joins, backups, scrubs and the other background sweeps come with later
slices (ROADMAP.md Queue 1: backup and restore; cluster and operations).
"""

from __future__ import annotations

import threading

import torch

from pilosa_tpu_torch.cluster.node import URI, Node
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.obs import MemoryStats, ProfileRing
from pilosa_tpu_torch.obs.runtime import RuntimeMonitor
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.qos import (
    AdaptiveLimit,
    AdmissionController,
    SlowQueryLog,
    TenantQuotas,
)
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.httpd import HTTPServer


class ServerNode:
    """A runnable standalone node (reference ``pilosa server``,
    cmd/server.go:64). ``device`` defaults to ``cuda`` and raises without
    a card, as ``Holder`` does; ``device="cpu"`` runs the kernels' plain
    versions on the CPU. ``data_dir`` opens (or creates) a data dir
    before the node serves; ``close()`` flushes it."""

    #: seconds between import-pool top-up checks.
    POOL_TOPUP_INTERVAL = 30.0

    def __init__(self, bind: str = "127.0.0.1:10101",
                 device: str | torch.device | None = "cuda",
                 use_planner: bool = True,
                 tls_cert: str | None = None,
                 tls_key: str | None = None,
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
                 import_pool_mb: int = 0):
        host, _, port = bind.partition(":")
        self.host, self.port = host or "127.0.0.1", int(port or 10101)
        self.stats = MemoryStats()
        self.holder = Holder(device=device)
        planner = Planner(self.holder) if use_planner else None
        self.executor = Executor(self.holder, planner=planner,
                                 stats=self.stats)
        self.api = API(self.holder, self.executor)
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
            id=self.id, uri=URI(scheme="https" if tls_cert else "http",
                                host=self.host, port=self.port),
            is_coordinator=True)

    def open(self) -> None:
        self.http.serve_background()
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
        self.runtime_monitor = RuntimeMonitor(self.stats,
                                              self.executor.planner,
                                              qos=self.qos)
        self.runtime_monitor.start()

    def close(self) -> None:
        self._pool_stop.set()
        self.http.close()
        if self.runtime_monitor is not None:
            self.runtime_monitor.close()
        if self.store is not None:
            self.store.close()

    @property
    def address(self) -> str:
        return self.http.address
