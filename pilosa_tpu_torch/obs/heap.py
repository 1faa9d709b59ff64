"""Heap / memory observability (the port's copy of pilosa_tpu/obs/heap.py).

The reference exposes Go pprof heap at /debug/pprof (http/handler.go:
281); an operator can always answer "where did the RAM go".  This
node's memory lives in four places the Python allocator can't see as
one number: Python objects (tracemalloc), the native recycled page pool
(roaring_codec pool_stats, through pilosa_tpu_torch.native), the
planner's budgeted device stack cache, and the per-index host rows
(sparse position arrays / dense word blocks / pending buffers).
``heap_stats`` gathers all four into one JSON for the ``/debug/heap``
route.

tracemalloc is started lazily on the first call (it has ~2x allocation
overhead while tracing, so it is not on by default); the first snapshot
therefore covers allocations made after that call.
"""

from __future__ import annotations

import tracemalloc
from typing import Any


def _host_row_bytes(hr) -> int:
    n = 0
    if hr.positions is not None:
        n += hr.positions.nbytes
    if hr.dense is not None:
        n += hr.dense.nbytes
    pending = getattr(hr, "_pending", None)
    if pending:
        n += 8 * len(pending)  # buffered positions (set of ints)
    return n


def holder_heap(holder) -> dict[str, Any]:
    """Per-index host-side row memory: {index: {bytes, fragments, rows,
    dense_rows}} plus totals."""
    out: dict[str, Any] = {}
    for iname in holder.index_names():
        idx = holder.index(iname)
        if idx is None:
            continue
        ib = frags = rows = dense = 0
        # list() snapshots: concurrent imports mutate these dicts and a
        # live iterator would raise mid-walk (same lockless-reader
        # discipline as fragment.py's contains/rows_list).
        for f in list(idx.fields.values()):
            for v in list(f.views.values()):
                for frag in list(v.fragments.values()):
                    frags += 1
                    for hr in list(frag.rows.values()):
                        rows += 1
                        if hr.is_dense:
                            dense += 1
                        ib += _host_row_bytes(hr)
        out[iname] = {"host_row_bytes": ib, "fragments": frags,
                      "rows": rows, "dense_rows": dense}
    return out


def tracemalloc_top(n: int = 25) -> dict[str, Any]:
    """Top-N allocation sites by retained bytes; starts tracing on the
    first call (stats accumulate from then on)."""
    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return {"tracing": "started",
                "note": "tracemalloc started now; allocation sites appear "
                        "from the next call on"}
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")
    traced_current, traced_peak = tracemalloc.get_traced_memory()
    return {
        "tracing": "on",
        "traced_current_bytes": traced_current,
        "traced_peak_bytes": traced_peak,
        "top": [{"site": str(s.traceback[0]) if s.traceback else "?",
                 "bytes": s.size, "count": s.count}
                for s in stats[:n]],
    }


def heap_stats(holder, planner=None, top_n: int = 25) -> dict[str, Any]:
    """One answer to "where did the RAM go" (see module doc)."""
    from pilosa_tpu_torch import native

    out: dict[str, Any] = {
        "tracemalloc": tracemalloc_top(top_n),
        "native_pool": native.pool_stats() or {"available": False},
        "host_rows": holder_heap(holder),
    }
    if planner is not None and hasattr(planner, "cache_stats"):
        out["planner_cache"] = planner.cache_stats()
    try:  # process-level ground truth, when the platform offers it
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS:", "VmHWM:")):
                    key = line.split(":")[0].lower()
                    out[f"{key}_kib"] = int(line.split()[1])
    except OSError:
        pass
    return out
