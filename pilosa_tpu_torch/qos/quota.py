"""Per-tenant token-bucket quotas on top of class-based admission.

Class-based admission (interactive/batch/internal) bounds *aggregate*
pressure, but one tenant's batch flood can still consume the entire
batch share. This layer meters per tenant — keyed by API key when the
client sends ``X-API-Key``, else by index name — before the request
ever reaches the admission queue. A quota rejection is **429 +
Retry-After** (the caller is over *its* limit; slowing down fixes it),
deliberately distinct from the 503 shed (the *node* is over its limit;
retrying elsewhere fixes it).

The port's copy of pilosa_tpu/qos/quota.py.
"""

from __future__ import annotations

import threading
import time

#: Bound the tenant table: buckets are tiny, but an attacker spraying
#: synthetic API keys must not grow node memory without bound. Eviction
#: drops the stalest bucket, which for a full bucket is a free refill —
#: acceptable: quotas are a fairness device, not a security boundary.
MAX_TENANTS = 4096


class QuotaExceededError(RuntimeError):
    """Tenant exhausted its token bucket. Maps to HTTP 429."""

    def __init__(self, tenant: str, retry_after: float):
        super().__init__(
            f"tenant {tenant!r} over its request quota; "
            f"retry in {retry_after:.1f}s")
        self.tenant = tenant
        self.retry_after = retry_after


class TenantQuotas:
    """Token bucket per tenant: ``rate_per_s`` sustained, ``burst`` peak."""

    def __init__(self, rate_per_s: float, burst: float | None = None,
                 clock=time.monotonic, stats=None):
        if rate_per_s <= 0:
            raise ValueError("quota rate must be > 0")
        self.rate = float(rate_per_s)
        self.burst = float(burst) if burst else max(1.0, 2.0 * self.rate)
        self.clock = clock
        self.stats = stats
        # tenant -> [tokens, last_refill]; dict order doubles as LRU
        # (re-inserted on every touch).
        self._buckets: dict[str, list[float]] = {}
        self._rejected = 0
        self._lock = threading.Lock()

    def check(self, tenant: str) -> None:
        """Take one token for ``tenant`` or raise QuotaExceededError."""
        if not tenant:
            return
        now = self.clock()
        with self._lock:
            bucket = self._buckets.pop(tenant, None)
            if bucket is None:
                bucket = [self.burst, now]
            else:
                tokens, updated = bucket
                bucket = [min(self.burst,
                              tokens + (now - updated) * self.rate), now]
            if len(self._buckets) >= MAX_TENANTS:
                self._buckets.pop(next(iter(self._buckets)))
            if bucket[0] < 1.0:
                self._buckets[tenant] = bucket
                self._rejected += 1
                if self.stats is not None:
                    self.stats.with_tags(
                        f"tenant:{tenant}").count("qos.quotaRejected", 1)
                retry_after = max(0.1, (1.0 - bucket[0]) / self.rate)
                raise QuotaExceededError(tenant, retry_after)
            bucket[0] -= 1.0
            self._buckets[tenant] = bucket

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ratePerS": self.rate,
                "burst": self.burst,
                "tenants": len(self._buckets),
                "rejected": self._rejected,
                "tokens": {t: round(b[0], 2)
                           for t, b in list(self._buckets.items())[-16:]},
            }
