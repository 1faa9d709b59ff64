"""Canonical plan signatures for result-cache keys.

The port's copy of pilosa_tpu/cache/signature.py. Two query strings that
parse to the same call tree share one cache entry: whitespace, argument
order and formatting differences are erased by rendering the PARSED tree
back to text (``Call.__str__`` emits children first, then args in sorted
order, with one canonical value format). The canonical text is memoized on
the Query object itself, which the executor's parse cache shares across
repeats of the same string. (The JAX package also resolves the sketch
calls' server-default literals here; those calls come with ROADMAP.md
Queue 1: keys and sketches.)
"""

from __future__ import annotations

from collections.abc import Iterable
from typing import Any


def plan_signature(query: Any) -> str:
    """Canonical text of a parsed ``pql.ast.Query``."""
    sig: str | None = getattr(query, "_plan_signature", None)
    if sig is None:
        sig = ";".join(str(c) for c in query.calls)
        try:
            query._plan_signature = sig
        except AttributeError:
            pass  # slotted/frozen query object: just recompute next time
    return sig


def cache_key(idx: Any, query: Any, shards: Iterable[int],
              opt: Any) -> tuple[object, ...]:
    """Full result-cache key: identity of the index instance (epoch
    counters restart on delete/recreate), the canonical plan, the shard
    set the plan runs over, and every ExecOptions flag that changes the
    result's SHAPE (attrs/columns inclusion). Freshness lives in the
    entry's stamp, not the key, so a stale entry is found (and replaced
    in place) rather than leaking alongside a fresh one. A standalone
    port node runs no remote legs, so the JAX key's ``remote`` flag is
    always false here and left out."""
    return (idx.name, idx.instance_id, plan_signature(query),
            tuple(shards), opt.exclude_row_attrs, opt.exclude_columns,
            opt.column_attrs)
