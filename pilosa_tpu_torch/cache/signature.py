"""Canonical plan signatures for result-cache keys.

The port's copy of pilosa_tpu/cache/signature.py. Two query strings that
parse to the same call tree share one cache entry: whitespace, argument
order and formatting differences are erased by rendering the PARSED tree
back to text (``Call.__str__`` emits children first, then args in sorted
order, with one canonical value format). The canonical text is memoized on
the Query object itself, which the executor's parse cache shares across
repeats of the same string. The sketch calls' omitted literals resolve
to the server's current defaults first, so a query that leaves them out
and one that spells the defaults out share one entry.
"""

from __future__ import annotations

from collections.abc import Iterable
from typing import Any

#: sketch calls resolve OMITTED keyword literals against server-level
#: defaults at execute time, so `Count(Distinct(field=v))` and
#: `Count(Distinct(field=v, precision=12))` (under default precision
#: 12) are the same plan and must share one cache entry. The canonical
#: text injects the resolved defaults before rendering.
_SKETCH_CALLS = ("Distinct", "SimilarTopN")


def _sketch_defaults(name: str) -> dict:
    from pilosa_tpu_torch import sketch as _sketch
    if name == "Distinct":
        return {"precision": _sketch.precision(),
                "threshold": _sketch.exact_threshold()}
    return {"n": _sketch.DEFAULT_SIMILAR_N, "metric": "jaccard"}


def _has_sketch_call(c: Any) -> bool:
    return c.name in _SKETCH_CALLS or any(_has_sketch_call(ch)
                                          for ch in c.children)


def _canonical_call(c: Any) -> Any:
    """The call with sketch-call defaults resolved (a clone -- parsed
    trees are shared across threads), or the original untouched."""
    if not _has_sketch_call(c):
        return c
    cc = c.clone()

    def fill(node: Any) -> None:
        if node.name in _SKETCH_CALLS:
            for k, v in _sketch_defaults(node.name).items():
                node.args.setdefault(k, v)
        for ch in node.children:
            fill(ch)

    fill(cc)
    return cc


def plan_signature(query: Any) -> str:
    """Canonical text of a parsed ``pql.ast.Query``."""
    sig: str | None = getattr(query, "_plan_signature", None)
    if sig is None:
        calls = [_canonical_call(c) for c in query.calls]
        sig = ";".join(str(c) for c in calls)
        if any(cc is not c for cc, c in zip(calls, query.calls)):
            # The signature bakes in CURRENT server defaults -- don't
            # memoize, a knob change must re-key the plan.
            return sig
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
    in place) rather than leaking alongside a fresh one. A remote leg
    caches its raw partials under its own key (``opt.remote``)."""
    return (idx.name, idx.instance_id, plan_signature(query),
            tuple(shards), opt.remote, opt.exclude_row_attrs,
            opt.exclude_columns, opt.column_attrs)
