"""Request-scoped tenant identity for cache partitioning.

The HTTP layer sets the tenant around each query — the same identity
the QoS quota table keys on (X-API-Key, falling back to the index
name) — so the result cache can give every tenant its own partition:
one tenant's working set cannot evict another's. Internal traffic
(remote legs, maintenance) runs under the default "" tenant.

The port's copy of pilosa_tpu/cache/tenant.py.
"""

from __future__ import annotations

import contextvars

_tenant: contextvars.ContextVar[str] = contextvars.ContextVar(
    "pilosa_tpu_torch_tenant", default="")


def current_tenant() -> str:
    return _tenant.get()


def set_current_tenant(tenant: str | None) -> contextvars.Token:
    return _tenant.set(tenant or "")


def reset_current_tenant(token: contextvars.Token) -> None:
    _tenant.reset(token)
