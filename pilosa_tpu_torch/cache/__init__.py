"""Plan-keyed result cache with epoch invalidation, and the request-scoped
tenant it partitions by.

The port's counterpart of pilosa_tpu/cache/: read-only query results
keyed by a canonical plan signature and validated by mutation-epoch stamps,
so invalidation is a compare at lookup time.

- signature:    canonical plan text + cache key construction
- result_cache: byte-accounted LRU partitioned per tenant, TTL backstop
- tenant:       request-scoped tenant identity (X-API-Key or index)
- remote:       shard epochs observed from remote query legs and peers'
                index-dirty broadcasts (a cluster coordinator's stamps)
"""

from pilosa_tpu_torch.cache.remote import RemoteEpochTable
from pilosa_tpu_torch.cache.result_cache import ResultCache, estimate_result_size
from pilosa_tpu_torch.cache.signature import cache_key, plan_signature
from pilosa_tpu_torch.cache.tenant import (
    current_tenant,
    reset_current_tenant,
    set_current_tenant,
)

__all__ = [
    "RemoteEpochTable",
    "ResultCache",
    "cache_key",
    "estimate_result_size",
    "plan_signature",
    "current_tenant",
    "reset_current_tenant",
    "set_current_tenant",
]
