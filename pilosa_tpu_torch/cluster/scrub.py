"""The scrubber's dirty-shard set.

The port's copy of the ``DirtyShards`` class of pilosa_tpu/cluster/scrub.py:
the write fan-out marks a shard here when it skipped a DOWN replica, so
the scrubber checks it first. The scrubber itself (disk re-verification,
repair from replica consensus) and the load-time routing of quarantined
shards to replicas answer ``NotPortedError`` (ROADMAP.md Queue 1: cluster
and operations).
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch.errors import SLICE_CLUSTER, NotPortedError


class DirtyShards:
    """Thread-safe set of (index, shard) the scrubber should check first
    — fed by write_fanout when a DOWN replica missed a write."""

    def __init__(self):
        self._shards: set[tuple] = set()
        self._lock = threading.Lock()

    def mark(self, index: str, shard: int) -> None:
        with self._lock:
            self._shards.add((index, shard))

    def drain(self) -> set[tuple]:
        with self._lock:
            out, self._shards = self._shards, set()
            return out

    def peek(self) -> set[tuple]:
        """Non-destructive view (the backup coordinator consults the set
        without stealing the scrubber's work)."""
        with self._lock:
            return set(self._shards)

    def __len__(self) -> int:
        with self._lock:
            return len(self._shards)


def route_quarantined_to_replicas(holder, cluster, store,
                                  stats=None, logger=None) -> int:
    raise NotPortedError("routing quarantined shards to replicas",
                         SLICE_CLUSTER)


class Scrubber:
    def __init__(self, *args, **kwargs):
        raise NotPortedError("the scrubber", SLICE_CLUSTER)
