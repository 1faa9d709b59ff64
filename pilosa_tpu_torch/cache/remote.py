"""Per-(index, shard) mutation epochs observed from remote query legs.

A coordinator-cached entry for a plan spanning nodes is provably
consistent only if the cache can tell when any REMOTE shard mutated.
Two signals feed this table:

- every internal wire response carries the serving node's shard-epoch
  vector, read on that node BEFORE its leg executes (so the reported
  epoch is at most as fresh as the data in the result — a write landing
  mid-leg raises the next report and invalidates);
- ``index-dirty`` broadcasts carry the sender's vector for the shards
  it mutated.

Stamps embed ``rows_for(index, shards)`` tuples and compare by
equality: any change — a higher epoch, a different owning node after a
resize, a shard appearing for the first time — misses, which is always
safe (worst case one recompute). Epochs from different nodes are
sequence positions in DIFFERENT counters, so they are never compared
across nodes — the (node, epoch) pair itself is the value.

The port's copy of pilosa_tpu/cache/remote.py.
"""

from __future__ import annotations

import threading
from typing import Iterable


class RemoteEpochTable:
    """Thread-safe (index, shard) -> (node_id, epoch) observations."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: dict[tuple[str, int], tuple[str, int]] = {}

    def observe(self, index: str, node_id: str,
                epochs: dict | None) -> None:
        """Record a node's report of its shard epochs. Same-node reports
        keep the max (legs race; an older report must not roll back a
        newer one); a different node overwrites (ownership moved)."""
        if not epochs:
            return
        with self._lock:
            for s, e in epochs.items():
                key = (index, int(s))
                cur = self._rows.get(key)
                if (cur is not None and cur[0] == node_id
                        and cur[1] >= int(e)):
                    continue
                self._rows[key] = (node_id, int(e))

    def rows_for(self, index: str, shards: Iterable[int]) -> tuple:
        """The remote component of a cache stamp: every observation we
        hold for the plan's shards, as a hashable tuple."""
        with self._lock:
            get = self._rows.get
            out = []
            for s in shards:
                row = get((index, int(s)))
                if row is not None:
                    out.append((int(s), row[0], row[1]))
            return tuple(out)

    def forget_index(self, index: str) -> None:
        """Drop an index's observations (delete/recreate)."""
        with self._lock:
            for key in [k for k in self._rows if k[0] == index]:
                del self._rows[key]

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._rows)}
