"""holderCleaner — post-resize data GC.

Reference: holder.go:1126-1190 (``holderCleaner.CleanHolder`` walks
indexes/fields/shards and deletes fragments the node no longer owns
under the current topology). Without it, a node that lost partitions in
a resize keeps serving disk forever, and — worse — stale bits become
live again if ownership ever maps back to it: anti-entropy repairs
ADD missing bits but never removes extra ones, so the stale fragment
would win.

Runs after every topology adoption (ServerNode/ClusterNode hook it into
the cluster-status path) and from the anti-entropy ticker as a backstop.

The port's copy of pilosa_tpu/cluster/cleaner.py (host code: nothing here
touches the device).
"""

from __future__ import annotations


def clean_holder(holder, cluster, store=None) -> int:
    """Delete every local fragment whose shard this node does not own
    under ``cluster``'s current topology. Returns fragments removed.

    The shard is recorded in ``remote_available_shards`` so query
    routing still counts it (its new owners serve it); with a DiskStore
    attached the snapshot + WAL files are unlinked too.
    """
    if cluster is None or len(cluster.nodes) <= 1:
        return 0
    # Serve-through resize keeps cluster.state NORMAL, so the state
    # check below no longer fences an in-flight migration: the
    # migration table IS the in-flight signal. apply_cluster_status
    # drops the table before adopting the new topology, so the
    # commit-time clean still runs.
    if getattr(cluster, "migration", None) is not None:
        return 0
    # NEVER GC mid-resize (or while membership is unsettled): ownership
    # computed under the OLD ring would delete fragments a resize
    # target just streamed in for its NEW-ring shards — permanent data
    # loss once the old owner is removed. The commit path cleans after
    # the state returns to steady (reference runs the cleaner from the
    # normal-state ticker only, holder.go:1126).
    from pilosa_tpu_torch.cluster.cluster import STATE_DEGRADED, STATE_NORMAL
    if cluster.state not in (STATE_NORMAL, STATE_DEGRADED):
        return 0
    local = cluster.local_id
    removed = 0
    for iname in holder.index_names():
        idx = holder.index(iname)
        idx_removed = 0
        for fname, f in list(idx.fields.items()):
            for vname, v in list(f.views.items()):
                for shard in sorted(v.available_shards()):
                    owners = cluster.shard_nodes(iname, shard)
                    if any(n.id == local for n in owners):
                        continue
                    if not v.delete_fragment(shard):
                        continue
                    f.add_remote_available_shards([shard])
                    if store is not None:
                        store.delete_fragment_files(
                            (iname, fname, vname, shard))
                    idx_removed += 1
        if idx_removed:
            # Cached results/plans may reference the dropped fragments.
            idx.epoch.bump()
            removed += idx_removed
    return removed
