"""Byte-accounted, tenant-partitioned LRU for query results.

The port's copy of pilosa_tpu/cache/result_cache.py (Row results here hold
int32 device tensors or uint32 numpy words; both report ``nbytes``).

Entries are (stamp, results) pairs; a stamp is whatever hashable value
the executor derives from the epochs the plan depends on. Lookup
recomputes the current stamp and compares — a mismatch IS the
invalidation (the stale entry is dropped on sight), so writes never
walk the cache.

Partitioning: each tenant owns an LRU ordered dict with its own byte
account. Eviction under global pressure is fair-share: an inserting
tenant whose partition exceeds max_bytes / active_partitions evicts its
own LRU tail; a tenant under its fair share evicts from the largest
partition instead. A heavy dashboard tenant therefore churns its own
entries while a light tenant's working set survives.

Size estimation: Row results hold per-shard dense uint32 blocks
(device or host); their ``nbytes`` dominate. Everything else is small
typed records estimated by shallow footprint. Estimates are recorded at
insert time and used symmetrically at eviction, so the account can't
drift even where the estimate is rough.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any

from pilosa_tpu_torch.config import WORDS_PER_SHARD
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec.result import GroupCount, Pair, RowIdentifiers, ValCount

#: fixed per-entry bookkeeping charge (key tuple, entry record, dict slot).
ENTRY_OVERHEAD = 256


def _result_size(r: Any) -> int:
    if isinstance(r, Row):
        n = 96
        for seg in r.segments.values():
            n += int(getattr(seg, "nbytes", WORDS_PER_SHARD * 4)) + 64
        if r.attrs:
            n += 64 * len(r.attrs)
        if r.keys:
            n += 48 * len(r.keys)
        return n
    if isinstance(r, (ValCount, Pair)):
        return 72
    if isinstance(r, RowIdentifiers):
        return 64 + 8 * len(r.rows) + 48 * len(r.keys)
    if isinstance(r, GroupCount):
        return 48 + 72 * len(r.group)
    if isinstance(r, list):
        return 56 + sum(_result_size(x) for x in r)
    if isinstance(r, dict):
        return 64 + 64 * len(r)
    return 32  # bool / int / None


def estimate_result_size(results: list) -> int:
    """Bytes one cached result list is charged for."""
    return ENTRY_OVERHEAD + sum(_result_size(r) for r in results)


class ResultCache:
    """Plan-signature keyed result store (see module docstring)."""

    def __init__(self, max_bytes: int = 64 << 20, ttl: float = 0.0,
                 stats=None, clock=time.monotonic):
        self.max_bytes = int(max_bytes)
        #: seconds an entry may serve after insert; 0 disables the
        #: backstop. TTL exists for the cross-node staleness window (a
        #: lost index-dirty broadcast), not as the primary invalidation.
        self.ttl = float(ttl)
        self.stats = stats
        self._clock = clock
        self._lock = threading.Lock()
        #: tenant -> key -> (stamp, results, size, inserted_at)
        self._parts: dict[str, OrderedDict] = {}
        self._part_bytes: dict[str, int] = {}
        self._total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- lookup / insert ---------------------------------------------------

    def get(self, tenant: str, key: tuple, stamp) -> list | None:
        with self._lock:
            part = self._parts.get(tenant)
            entry = part.get(key) if part is not None else None
            if entry is not None:
                expired = (self.ttl > 0.0
                           and self._clock() - entry[3] > self.ttl)
                if entry[0] == stamp and not expired:
                    part.move_to_end(key)
                    self.hits += 1
                    if self.stats is not None:
                        self.stats.count("cache.hits")
                    return list(entry[1])
                # Stale stamp or TTL: the entry can never serve again —
                # reclaim its bytes now instead of waiting for LRU churn.
                self._remove_locked(tenant, key)
            self.misses += 1
        if self.stats is not None:
            self.stats.count("cache.misses")
        return None

    def put(self, tenant: str, key: tuple, stamp, results: list) -> None:
        size = estimate_result_size(results)
        if size > self.max_bytes:
            return  # one oversized result must not flush everyone else
        with self._lock:
            # Replace-then-ensure, in that order: removing the old entry
            # can delete a partition that held nothing else, so the
            # partition must be (re)created after, never before.
            self._remove_locked(tenant, key)
            part = self._parts.get(tenant)
            if part is None:
                part = self._parts[tenant] = OrderedDict()
                self._part_bytes[tenant] = 0
            part[key] = (stamp, list(results), size, self._clock())
            self._part_bytes[tenant] += size
            self._total_bytes += size
            while self._total_bytes > self.max_bytes:
                victim = self._victim_tenant_locked(tenant)
                if victim is None:
                    break
                vpart = self._parts[victim]
                vkey = next(iter(vpart))
                if victim == tenant and vkey == key:
                    break  # never evict the entry being inserted
                self._remove_locked(victim, vkey)
                self.evictions += 1
                if self.stats is not None:
                    self.stats.count("cache.evictions")
        if self.stats is not None:
            self.stats.gauge("cache.bytes", self._total_bytes)

    # -- internals ---------------------------------------------------------

    def _remove_locked(self, tenant: str, key: tuple) -> None:
        part = self._parts.get(tenant)
        if part is None:
            return
        entry = part.pop(key, None)
        if entry is None:
            return
        self._part_bytes[tenant] -= entry[2]
        self._total_bytes -= entry[2]
        if not part:
            del self._parts[tenant]
            del self._part_bytes[tenant]

    def _victim_tenant_locked(self, inserter: str) -> str | None:
        """Fair-share eviction: the inserter pays from its own tail when
        over its share of the budget; otherwise the largest partition
        does."""
        if not self._parts:
            return None
        fair = self.max_bytes // max(1, len(self._parts))
        if self._part_bytes.get(inserter, 0) > fair:
            return inserter
        return max(self._part_bytes, key=self._part_bytes.get)

    # -- maintenance / observability ---------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._parts.clear()
            self._part_bytes.clear()
            self._total_bytes = 0
        if self.stats is not None:
            self.stats.gauge("cache.bytes", 0)

    @property
    def total_bytes(self) -> int:
        return self._total_bytes

    def snapshot(self) -> dict:
        """One JSON-able view for /debug/cache and /debug/overload."""
        with self._lock:
            tenants = {
                t or "(default)": {"bytes": self._part_bytes[t],
                                   "entries": len(part)}
                for t, part in self._parts.items()
            }
            return {
                "bytes": self._total_bytes,
                "maxBytes": self.max_bytes,
                "ttlSeconds": self.ttl,
                "entries": sum(len(p) for p in self._parts.values()),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "tenants": tenants,
            }
