"""Runtime monitor: periodic host + device health gauges (the port's copy
of pilosa_tpu/obs/runtime.py, with the same gauge names).

Reference: server.go:812-855 (monitorRuntime: goroutines, heap, GC,
open FDs via gcnotify/ + gopsutil/). The gauge that matters most on this
architecture is device memory: the planner's device-resident stack-cache
occupancy against its budget, and the CUDA caching allocator's own
numbers for the holder's device (none on the CPU).
"""

from __future__ import annotations

import os
import threading

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def collect_runtime_gauges(stats, planner=None,
                           probe_device: bool = True, qos=None) -> dict:
    """One sweep of gauges into ``stats``; returns them for callers that
    surface the snapshot directly (the /info route, tests)."""
    out: dict[str, float] = {}

    out["threads"] = float(threading.active_count())
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        out["rssBytes"] = float(int(parts[1]) * _PAGE)
        out["vmsBytes"] = float(int(parts[0]) * _PAGE)
    except (OSError, IndexError, ValueError):
        pass
    try:
        out["openFDs"] = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass

    if planner is not None:
        # Stack-cache device occupancy vs its budget — the eviction system
        # works silently; this is how an operator sees pressure.
        snap = planner.cache_stats()
        out["plannerCacheBytes"] = float(snap["bytes"])
        out["plannerCacheBudgetBytes"] = float(snap["budget_bytes"])
        out["plannerCacheEntries"] = float(snap["entries"])
        out["plannerCacheEvictions"] = float(snap.get("evictions", 0))
        # Dispatch accounting, kept under the JAX package's gauge names;
        # the port has no coalescer yet, so both stay 0.
        out["plannerDispatches"] = float(snap.get("dispatches", 0))
        out["plannerDispatchesCoalesced"] = float(
            snap.get("dispatches_coalesced", 0))

    dev = getattr(planner, "device", None)
    if probe_device and dev is not None and dev.type == "cuda":
        # The caching allocator's numbers for the holder's card; a CPU
        # node has none.
        import torch
        out["device_bytes_in_use"] = float(torch.cuda.memory_allocated(dev))
        out["device_peak_bytes_in_use"] = float(
            torch.cuda.max_memory_allocated(dev))
        out["device_bytes_limit"] = float(torch.cuda.mem_get_info(dev)[1])

    # Import buffer-pool health (native recycled page pool): an
    # operator watching freeBytes fall toward zero is watching imports
    # head back to cold first-touch fault cost — the signal to raise
    # import-pool-mb (the top-up loop covers steady drain).
    from pilosa_tpu_torch import native
    pool = native.pool_stats()
    if pool is not None:
        out["poolFreeBytes"] = float(pool["free_bytes"])
        out["poolLimitBytes"] = float(pool["limit_bytes"])
        out["poolFreshMmaps"] = float(pool["fresh_mmaps"])
        out["poolRecycledAllocs"] = float(pool["recycled_allocs"])

    if qos is not None:
        # Admission pressure: queue depth / in-flight per class, plus
        # lifetime shed and deadline-miss totals. The per-class splits
        # go out as tagged qos.* gauges via export_gauges.
        try:
            snap = qos.snapshot()
            out["qosActive"] = float(snap["active"])
            out["qosQueueDepth"] = float(snap["queuedTotal"])
            out["qosShedTotal"] = float(snap["shed"])
            out["qosDeadlineMissTotal"] = float(snap["deadlineMiss"])
            qos.export_gauges(stats)
        except Exception:
            pass  # monitoring must never kill the node

    for name, value in out.items():
        stats.gauge(f"runtime.{name}", value)
    return out


class RuntimeMonitor:
    """Jittered ticker around collect_runtime_gauges (the monitorRuntime
    loop)."""

    DEFAULT_INTERVAL = 30.0

    def __init__(self, stats, planner=None,
                 interval: float = DEFAULT_INTERVAL, qos=None):
        self.stats = stats
        self.planner = planner
        self.qos = qos
        self.interval = interval
        self._timer: threading.Timer | None = None
        self._closed = False
        self._lock = threading.Lock()

    def start(self) -> None:
        if self.interval <= 0:
            return
        # Host-side sweep inline (cheap, includes planner cache stats);
        # the device-memory probe waits for the first background tick so
        # ServerNode.open() never blocks on backend init.
        collect_runtime_gauges(self.stats, self.planner,
                               probe_device=False, qos=self.qos)
        self._schedule()

    def _schedule(self) -> None:
        import random

        def tick():
            try:
                collect_runtime_gauges(self.stats, self.planner,
                                       qos=self.qos)
            except Exception:
                pass  # monitoring must never kill the node
            finally:
                self._schedule()

        # close() races tick(): take the lock so a timer can never be
        # installed after close() cancelled the previous one.
        with self._lock:
            if self._closed:
                return
            self._timer = threading.Timer(
                self.interval * random.uniform(0.8, 1.2), tick)
            self._timer.daemon = True
            self._timer.start()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._timer is not None:
                self._timer.cancel()
