"""ServerNode — one standalone pilosa_tpu_torch node.

The port's counterpart of pilosa_tpu/server/node.py for a node with no
peers: Holder (on the card by default) + Executor (+ Planner) + API +
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
``archive_url`` starts the unattended ``BackupScheduler``. Peers, joins,
scrubs and the other background sweeps come with a later slice
(ROADMAP.md Queue 1: cluster and operations).
"""

from __future__ import annotations

import json
import os
import random
import threading

import torch

from pilosa_tpu_torch.cluster.node import URI, Node
from pilosa_tpu_torch.cache.result_cache import ResultCache
from pilosa_tpu_torch.core.holder import Holder
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
    SlowQueryLog,
    TenantQuotas,
    WarmupService,
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
                 compile_cache_dir: str | None = None):
        host, _, port = bind.partition(":")
        self.host, self.port = host or "127.0.0.1", int(port or 10101)
        self.stats = MemoryStats()
        self.logger = StandardLogger()
        self._closed = False
        self._backup_interval = float(backup_interval or 0.0)
        self._archive_url = archive_url
        self._backup_full_every = int(backup_full_every)
        self._backup_keep_chains = int(backup_keep_chains)
        self.backup_scheduler = None
        self.backup_archive = None
        self._backup_timer = None
        self.holder = Holder(device=device)
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
                                 result_cache=self.result_cache)
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
        self._qos_warmup = qos_warmup
        self._qos_warmup_shards = qos_warmup_shards
        self.warmup = None
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
        if (self._backup_interval > 0 and self._archive_url
                and self.store is not None):
            from pilosa_tpu_torch.backup import BackupScheduler, open_archive
            self.backup_archive = open_archive(self._archive_url, stats=self.stats)
            self.backup_scheduler = BackupScheduler(
                holder=self.holder, cluster=None, client=None,
                store=self.store, archive=self.backup_archive,
                interval=self._backup_interval,
                stats=self.stats, logger=self.logger, admission=self.qos,
                full_every=self._backup_full_every,
                keep_chains=self._backup_keep_chains)
            self._schedule_backup()
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
        self.http.close()
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

    # -- backup / restore (reference node.py:1175-1285) --------------------

    def handle_backup(self, req: dict) -> dict:
        """POST /backup: start a backup into the archive named in the
        request (directory path or object-store URL); returns the backup
        id immediately (poll /backup/status)."""
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
        writer = BackupWriter(self.holder, None, None, self.store, archive,
                              stats=self.stats, admission=self.qos)
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
        """POST /restore: rebuild the backed-up indexes onto this node from
        the archive; returns immediately (poll /restore/status). ``id``
        defaults to the newest complete backup; ``pitrOps`` caps WAL
        replay for point-in-time recovery."""
        import time as _time

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
            m = select_backup_at(archive, _time.time())
            if m is None:
                raise BackupError("restore: no complete backup in archive")
            backup_id = m["id"]
        elif not archive.has_manifest(backup_id):
            raise BackupError(f"restore: backup {backup_id!r} not found in archive")
        pitr = req.get("pitrOps")
        if not self._restore_gate.acquire(blocking=False):
            raise BackupError("restore already in progress")
        job = RestoreJob(self.holder, None, None, archive, backup_id,
                         store=self.store, stats=self.stats,
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
