"""Slow-query log: a bounded ring of the most recent queries that blew
past the latency threshold, surfaced at ``/debug/slow-queries`` and as a
``qos.slowQueries`` counter.

The port's copy of pilosa_tpu/qos/slowlog.py.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

logger = logging.getLogger("pilosa_tpu_torch.qos")

DEFAULT_THRESHOLD_MS = 500.0
DEFAULT_CAPACITY = 128
_QUERY_SNIPPET = 512


class SlowQueryLog:
    def __init__(self, threshold_ms: float = DEFAULT_THRESHOLD_MS,
                 capacity: int = DEFAULT_CAPACITY, stats=None):
        self.threshold_ms = float(threshold_ms)
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._stats = stats
        self._total = 0

    def observe(self, index: str, query: str, duration_ms: float,
                qos_class: str = "", status: str = "ok",
                fused_steps: int = 0, trace_id: str = "") -> None:
        if duration_ms < self.threshold_ms:
            return
        entry = {
            "ts": time.time(),
            "index": index,
            "query": (query or "")[:_QUERY_SNIPPET],
            "durationMs": round(float(duration_ms), 3),
            "class": qos_class,
            "status": status,
            # plan-tree steps that ran fused inside device programs —
            # distinguishes a one-program query from a stepped one when
            # triaging a slow entry (exec/fuse.py).
            "fusedSteps": int(fused_steps),
        }
        if trace_id:
            # A slow entry links to its retained cost breakdown: the
            # profile ring keeps the slowest N, and slow-log qualifiers
            # are exactly the queries it retains.
            entry["traceId"] = trace_id
            entry["profile"] = f"/debug/queries/{trace_id}"
        with self._lock:
            self._ring.append(entry)
            self._total += 1
        if self._stats is not None:
            self._stats.count("qos.slowQueries", 1)
        logger.warning("slow query (%.1fms, class=%s, status=%s) on %r: %s",
                       duration_ms, qos_class, status, index, entry["query"])

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    @property
    def total(self) -> int:
        with self._lock:
            return self._total
