"""Anti-entropy: replica repair by checksummed block diff + majority merge.

Reference: holder.go holderSyncer.SyncHolder (:911) → fragment syncer
(fragment.go:2861) → mergeBlock (fragment.go:1875-1993). Blocks are
100-row checksums (Fragment.checksum_blocks); differing blocks are merged
bit-by-bit with majority consensus (ties → set) and diffs pushed back to
replicas.

The k-way roaring iterators of the reference become numpy set ops over
position-encoded (row*SHARD_WIDTH + col) pair arrays — same consensus,
vectorized.

The port's copy of pilosa_tpu/cluster/sync.py (host code: nothing here
touches the device).
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.core.holder import Holder


def merge_block(local_pairs: tuple[np.ndarray, np.ndarray],
                remote_pairs: list[tuple[np.ndarray, np.ndarray]],
                include_local: bool = True):
    """Consensus-merge one block. Pairs are (row_ids, ABSOLUTE column_ids).

    Returns (local_sets, local_clears, remote_diffs) where remote_diffs is
    a list of (sets, clears) per remote node; each sets/clears is a
    (rows, cols) pair. majorityN = (n+1)//2 over all participants — an
    even split keeps the bit (fragment.go:1917).

    ``include_local=False`` excludes the local copy from the vote (its
    diffs are still computed): the scrubber uses this to repair a
    fragment whose local data is quarantined-corrupt — evidence of
    corruption means the local bits must not outvote healthy replicas.
    """
    all_pairs = [local_pairs] + list(remote_pairs)
    n = len(all_pairs)
    majority_n = (n + 1) // 2

    # Structured (row, col) pairs — overflow-proof for the full uint64
    # row/column domain (no positional packing).
    pair_dt = np.dtype([("r", "<u8"), ("c", "<u8")])

    def encode(rows, cols):
        a = np.empty(len(rows), dtype=pair_dt)
        a["r"] = np.asarray(rows, dtype=np.uint64)
        a["c"] = np.asarray(cols, dtype=np.uint64)
        return np.unique(a)

    encoded = [encode(r, c) for r, c in all_pairs]
    if not any(len(e) for e in encoded):
        empty = (np.empty(0, np.uint64), np.empty(0, np.uint64))
        return (empty, empty), [(empty, empty) for _ in remote_pairs]
    universe = np.unique(np.concatenate(encoded))

    presence = np.zeros((n, len(universe)), dtype=np.int32)
    for i, e in enumerate(encoded):
        if len(e):
            idx = np.searchsorted(universe, e)
            presence[i, idx] = 1
    if include_local:
        keep = presence.sum(axis=0) >= majority_n
    else:
        majority_n = (len(remote_pairs) + 1) // 2
        keep = presence[1:].sum(axis=0) >= max(majority_n, 1)

    def decode(mask):
        sel = universe[mask]
        return (sel["r"].astype(np.uint64), sel["c"].astype(np.uint64))

    def diffs(i):
        has = presence[i].astype(bool)
        return decode(keep & ~has), decode(~keep & has)

    local_sets, local_clears = diffs(0)
    remote = [diffs(i + 1) for i in range(len(remote_pairs))]
    return (local_sets, local_clears), remote


class HolderSyncer:
    """Reference holderSyncer (holder.go:895): walk the schema, sync every
    owned fragment against its replicas."""

    def __init__(self, holder: Holder, cluster, client):
        self.holder = holder
        self.cluster = cluster
        self.client = client

    def sync_holder(self) -> int:
        """Returns the number of fragments + attr stores repaired."""
        repaired = 0
        for index_name in self.holder.index_names():
            idx = self.holder.index(index_name)
            # Attr stores first, like the reference's syncIndex/syncField
            # order (holder.go:975-1067): column attrs, then per-field
            # row attrs — attrs replicate everywhere, not per shard.
            if self._sync_attrs(index_name, None, idx.column_attr_store):
                repaired += 1
            for field_name, f in sorted(idx.fields.items()):
                if self._sync_attrs(index_name, field_name, f.row_attr_store):
                    repaired += 1
                for view_name, v in sorted(f.views.items()):
                    for shard in sorted(v.fragments):
                        if not self.cluster.owns_shard(
                                self.cluster.local_id, index_name, shard):
                            continue
                        if self._sync_fragment(index_name, field_name,
                                               view_name, shard):
                            repaired += 1
        return repaired

    def _sync_attrs(self, index_name: str, field_name: str | None,
                    store) -> bool:
        """Pull-repair one attr store against every live peer: blocks
        whose checksums differ are fetched and merged locally (reference
        syncIndex -> AttrStore.Blocks -> ColumnAttrDiff -> SetBulkAttrs,
        holder.go:975-1067). Each node repairs itself; mutual convergence
        comes from every node running its own syncer."""
        changed = False
        mine = store.blocks()
        for node in self.cluster.nodes:
            if node.id == self.cluster.local_id or node.state == "DOWN":
                continue
            try:
                theirs = self.client.attr_blocks(node, index_name, field_name)
            except (ConnectionError, LookupError):
                continue
            for b in store.diff_blocks(mine, theirs):
                try:
                    data = self.client.attr_block_data(node, index_name,
                                                       field_name, b)
                except (ConnectionError, LookupError):
                    continue
                if data:
                    store.set_bulk_attrs(data)
                    changed = True
            if changed:
                mine = store.blocks()
        return changed

    def _replicas(self, index_name: str, shard: int):
        return [n for n in self.cluster.shard_nodes(index_name, shard)
                if n.id != self.cluster.local_id and n.state != "DOWN"]

    def _sync_fragment(self, index_name, field_name, view_name, shard) -> bool:
        frag = self.holder.fragment(index_name, field_name, view_name, shard)
        if frag is None:
            return False
        replicas = self._replicas(index_name, shard)
        if not replicas:
            return False

        local_blocks = frag.checksum_blocks()
        peer_blocks = []
        live = []
        for node in replicas:
            try:
                peer_blocks.append(self.client.fragment_blocks(
                    node, index_name, field_name, view_name, shard))
                live.append(node)
            except LookupError:
                # Replica lacks the fragment entirely: empty block set —
                # every local block diffs and gets pushed.
                peer_blocks.append({})
                live.append(node)
            except ConnectionError:
                continue
        if not live:
            return False

        block_ids = set(local_blocks)
        for pb in peer_blocks:
            block_ids |= set(pb)
        idx = self.holder.index(index_name)
        epoch = idx.epoch if idx is not None else None
        changed = False
        for b in sorted(block_ids):
            if all(pb.get(b) == local_blocks.get(b) for pb in peer_blocks):
                continue
            # Read-merge-write guard: a write that lands between reading
            # this block and applying the merged plan would be UNDONE by
            # the plan (a freshly cleared bit still in the stale read
            # gets resurrected on every copy). Snapshot the index's
            # mutation epoch with the read; a bump during the merge
            # invalidates the plan for this block — next pass replans.
            e0 = epoch.value if epoch is not None else None
            local_pairs = frag.block_data(b)
            remote_pairs, reachable = [], []
            empty = (np.empty(0, np.uint64), np.empty(0, np.uint64))
            for node in live:
                try:
                    remote_pairs.append(self.client.fragment_block_data(
                        node, index_name, field_name, view_name, shard, b))
                    reachable.append(node)
                except LookupError:
                    remote_pairs.append(empty)
                    reachable.append(node)
                except ConnectionError:
                    continue  # peer died mid-sync: merge with the rest
            if not reachable:
                continue
            (lsets, lclears), remote_diffs = merge_block(local_pairs, remote_pairs)
            if e0 is not None and epoch.value != e0:
                continue  # a write raced this merge: stale plan, replan
            if len(lsets[0]):
                frag.bulk_import(lsets[0].tolist(), lsets[1].tolist())
                changed = True
            if len(lclears[0]):
                frag.bulk_import(lclears[0].tolist(), lclears[1].tolist(),
                                 clear=True)
                changed = True
            for node, (rsets, rclears) in zip(reachable, remote_diffs):
                try:
                    if len(rsets[0]):
                        self.client.import_bits(
                            node, index_name, field_name, view_name, shard,
                            rsets[0].tolist(), rsets[1].tolist(), False)
                        changed = True
                    if len(rclears[0]):
                        self.client.import_bits(
                            node, index_name, field_name, view_name, shard,
                            rclears[0].tolist(), rclears[1].tolist(), True)
                        changed = True
                except (ConnectionError, LookupError):
                    continue  # next sync pass retries this peer
        return changed
