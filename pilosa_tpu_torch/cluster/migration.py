"""Per-shard migration bookkeeping for serve-through resize.

While a ResizeJob runs, the OLD ring stays fully authoritative:
``Cluster.nodes`` never changes until the single cluster-status commit
broadcast flips every peer to the new topology at once. This table is
the only thing that knows a resize is in flight. It records

- the NEW ring (as its own placement view), so every write fanned out
  under the old ring can ALSO be applied to the shard's future owners
  ("dual-apply") — by the time the commit lands, each moved shard's new
  copy is complete and current, so the flip is safe without ever
  closing the API;
- which shards' new owners already hold a verified, epoch-current copy
  ("cut over"), which makes those owners eligible as extra READ
  candidates (replica-aware read scaling) before the commit.

Because the old ring is authoritative throughout, abandoning a
migration at ANY point — abort, coordinator crash, dual-write failure —
is just dropping this table: no shard was ever routed away from its old
owner, so nothing needs to be rolled back (the holder cleaner GCs the
orphaned partial copies after the next committed topology).

Every member of the old ring (and every joiner) installs a table from
the coordinator's ``resize-begin`` broadcast and drops it on
``resize-end`` or on adopting the commit (resize.apply_cluster_status).

The port's copy of pilosa_tpu/cluster/migration.py (host code: nothing here
touches the device).
"""

from __future__ import annotations

import itertools
import threading

from pilosa_tpu_torch.cluster.node import Node

#: distinguishes successive tables installed on one Cluster object, so
#: anything memoized against a table can tell "same job, new attempt".
_GEN = itertools.count(1)


class MigrationTable:
    def __init__(self, job_id: str, coordinator: dict,
                 nodes: list[Node], replica_n: int, partition_n: int):
        from pilosa_tpu_torch.cluster.cluster import Cluster
        self.job_id = job_id
        #: coordinator node json (id + uri) — resolvable even by a
        #: joiner whose membership view doesn't include the ring yet.
        self.coordinator = dict(coordinator or {})
        #: the new ring as a placement-only Cluster view: shard_nodes on
        #: it answers "who owns this shard AFTER the commit" (memoized
        #: there, so dual_targets stays cheap on the write path). A
        #: placement view, never a routing target by itself.
        self.new_view = Cluster(
            "_migration",
            [Node(id=n.id, uri=n.uri) for n in nodes],
            replica_n=replica_n, partition_n=partition_n)
        self.generation = next(_GEN)
        self._lock = threading.Lock()
        self._cutover: set[tuple[str, int]] = set()
        #: bumped on every cutover; read-spread candidacy derives from
        #: it without re-walking the set.
        self.gen = 0

    @classmethod
    def from_message(cls, cluster, message: dict) -> "MigrationTable":
        """Build from a resize-begin broadcast (peer side)."""
        return cls(
            job_id=message["job"],
            coordinator=message.get("coordinator") or {},
            nodes=[Node.from_json(n) for n in message["nodes"]],
            replica_n=int(message.get("replicaN") or cluster.replica_n),
            partition_n=int(message.get("partitionN")
                            or cluster.partition_n))

    def dual_targets(self, cluster, index: str, shard: int) -> list[Node]:
        """Nodes that will own (index, shard) after the commit but do
        not own it under the old ring — computed on the fly so shards
        CREATED mid-resize dual-apply too, not just the ones inventoried
        when the job started."""
        old_ids = {n.id for n in cluster.shard_nodes(index, shard)}
        return [n for n in self.new_view.shard_nodes(index, shard)
                if n.id not in old_ids]

    def mark_cutover(self, index: str, shard: int) -> None:
        with self._lock:
            self._cutover.add((index, int(shard)))
            self.gen += 1

    def is_cutover(self, index: str, shard: int) -> bool:
        with self._lock:
            return (index, int(shard)) in self._cutover

    def snapshot(self) -> dict:
        with self._lock:
            cut = sorted(self._cutover)
        return {
            "job": self.job_id,
            "coordinator": self.coordinator.get("id", ""),
            "newNodes": [n.id for n in self.new_view.nodes],
            "replicaN": self.new_view.replica_n,
            "cutoverShards": len(cut),
            "cutover": [{"index": i, "shard": s} for i, s in cut[:256]],
        }
