"""Background scrubber: disk re-verification + self-healing repair.

Anti-entropy (cluster/sync.py) converges replicas that DIVERGED; the
scrubber closes the remaining integrity gap — bits that went wrong at
rest.  Each pass, rate-limited through the QoS internal class so user
queries always win:

1. repairs quarantined fragments from replica consensus — the local copy
   is EXCLUDED from the majority vote (``merge_block(include_local=
   False)``) because evidence of corruption forfeits its franchise —
   then re-snapshots and releases the quarantine entry;
2. priority-checks shards the write fan-out marked dirty (a DOWN replica
   skipped a write there);
3. walks the on-disk snapshots re-verifying their footers, so latent
   bit rot is caught between restarts, not at the next crash.

``route_quarantined_to_replicas`` is the load-time half: on a cluster
node, a quarantined shard's local copy is dropped and reads route to
replicas (the holderCleaner idiom: delete local fragment +
add_remote_available_shards) until the scrubber repairs it.

The port's copy of pilosa_tpu/cluster/scrub.py (host code).
"""

from __future__ import annotations

import threading

import numpy as np

from pilosa_tpu_torch.cluster.sync import merge_block
from pilosa_tpu_torch.qos.admission import CLASS_INTERNAL, QueryShedError
from pilosa_tpu_torch.storage.quarantine import (
    STATE_DEGRADED,
    STATE_ROUTED,
)


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
    """Drop quarantined local fragments whose shard has a live replica;
    reads then route there (cleaner.py's re-ownership idiom). Returns
    the number of shards routed."""
    routed = 0
    for key in store.quarantine.keys():
        index, field, view, shard = key
        replicas = [n for n in cluster.shard_nodes(index, shard)
                    if n.id != cluster.local_id and n.state != "DOWN"]
        if not replicas:
            continue  # standalone / all peers down: keep salvaged data
        idx = holder.index(index)
        f = idx.field(field) if idx is not None else None
        v = f.views.get(view) if f is not None else None
        if v is not None:
            v.delete_fragment(shard)
        if f is not None:
            f.add_remote_available_shards([shard])
        store.quarantine.set_state(key, STATE_ROUTED)
        routed += 1
        if stats is not None:
            stats.count("integrity.routed")
        if logger is not None:
            logger.printf("integrity: routing %s/%s/%s/%d to replicas",
                          index, field, view, shard)
    return routed


class Scrubber:
    """One pass = repair quarantined + check dirty + re-verify disk."""

    def __init__(self, holder, cluster, client, store,
                 stats=None, logger=None, admission=None):
        self.holder = holder
        self.cluster = cluster
        self.client = client
        self.store = store
        self.stats = stats
        self.logger = logger
        #: QoS gate: every fragment's work admits as CLASS_INTERNAL so a
        #: scrub never starves interactive queries.
        self.admission = admission

    # -- helpers -----------------------------------------------------------

    def _count(self, name: str, value: int = 1) -> None:
        if self.stats is not None:
            self.stats.count(name, value)

    def _log(self, fmt: str, *args) -> None:
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    def _admitted(self, fn):
        """Run ``fn`` under the internal QoS class; shed = skip (the
        next pass retries)."""
        if self.admission is None:
            return fn()
        try:
            with self.admission.admit(CLASS_INTERNAL):
                return fn()
        except QueryShedError:
            self._count("integrity.scrubShed")
            return None

    def _replicas(self, index: str, shard: int):
        if self.cluster is None:
            return []
        return [n for n in self.cluster.shard_nodes(index, shard)
                if n.id != self.cluster.local_id and n.state != "DOWN"]

    def _owns(self, index: str, shard: int) -> bool:
        """Whether this node is a CURRENT owner of the shard. A resize
        can strip ownership between a dirty mark (or a quarantine entry)
        and the scrub pass that services it; repairing — and above all
        push_remote-ing — a stale former-owner copy would resurrect bits
        the real owners have since cleared. Stale fragments are the
        holderCleaner's to delete, not ours to propagate."""
        if self.cluster is None:
            return True
        return any(n.id == self.cluster.local_id
                   for n in self.cluster.shard_nodes(index, shard))

    # -- pass --------------------------------------------------------------

    def scrub_pass(self) -> dict:
        """Returns counts: {"repaired", "released", "mismatch", "bad"}."""
        self._count("integrity.scrubPasses")
        out = {"repaired": 0, "released": 0, "mismatch": 0, "bad": 0}
        for key in self.store.quarantine.keys():
            res = self._admitted(lambda k=key: self._repair_quarantined(k))
            if res:
                out["repaired"] += 1
                out["released"] += 1
        # While fenced, leave the dirty marks in place instead of
        # draining them into scrubs that the fencing gate below will
        # refuse — they are the rejoin repair's worklist.
        dirty = (self.cluster.dirty_shards.drain()
                 if self.cluster is not None
                 and not getattr(self.cluster, "fenced", False) else set())
        for index, shard in sorted(dirty):
            idx = self.holder.index(index)
            if idx is None:
                continue
            for fname, f in sorted(idx.fields.items()):
                for vname, v in sorted(f.views.items()):
                    if shard not in v.fragments:
                        continue
                    key = (index, fname, vname, shard)
                    if self._admitted(
                            lambda k=key: self._scrub_fragment(k)):
                        out["mismatch"] += 1
        for key in list(self.store._all_keys()):
            if self.store.quarantine.get(key) is not None:
                continue  # already being handled above
            status = self._admitted(
                lambda k=key: self.store.verify_snapshot(k))
            if status == "bad":
                out["bad"] += 1
                self._count("integrity.scrubBad")
                self._log("scrub: snapshot failed re-verification: %s",
                          "/".join(str(p) for p in key))
                # Re-snapshot from the (still healthy) in-memory
                # fragment: memory is the truth the bad file diverged
                # from.
                self.store.snapshot_fragment(key)
        return out

    def _scrub_fragment(self, key: tuple) -> bool:
        """Anti-entropy-style targeted check of one fragment against its
        replicas (majority vote INCLUDING the local copy — no corruption
        evidence here, just a suspected missed write)."""
        index, field, view, shard = key
        # Fencing gate: push-repair from a fenced minority would
        # overwrite the majority's newer writes with our stale copy the
        # moment the partition heals enough to reach one replica. A
        # fenced node keeps its dirty marks and repairs after rejoin.
        if self.cluster is not None and getattr(self.cluster, "fenced",
                                                False):
            self._count("integrity.scrubFenced")
            return False
        if not self._owns(index, shard):
            return False
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            return False
        replicas = self._replicas(index, shard)
        if not replicas:
            return False
        # push_remote: the dirty mark means a REPLICA missed a write —
        # repairing only the local copy would leave the lag in place
        # until the next full anti-entropy sweep.
        changed = self._merge_with_replicas(frag, key, replicas,
                                            include_local=True,
                                            push_remote=True)
        if changed:
            self._count("integrity.scrubMismatch")
        return changed

    def _repair_quarantined(self, key: tuple) -> bool:
        """Rebuild one quarantined fragment from replica consensus, then
        re-snapshot and release. Returns True when released."""
        index, field, view, shard = key
        entry = self.store.quarantine.get(key)
        if entry is None:
            return False
        if not self._owns(index, shard):
            return False  # no longer ours: the cleaner GCs, we don't heal
        replicas = self._replicas(index, shard)
        if not replicas:
            if entry["state"] == STATE_DEGRADED:
                # Standalone salvage: the WAL-replayed partial state is
                # the best truth there is; persist it and move on.
                self.store.snapshot_fragment(key)
                if self.store.verify_snapshot(key) == "ok":
                    self.store.quarantine.release(key)
                    self.store.prune_quarantine_evidence(key)
                    return True
            return False
        idx = self.holder.index(index)
        f = idx.field(field) if idx is not None else None
        if f is None:
            return False
        v = f.create_view_if_not_exists(view)
        # Recreating the fragment re-claims local ownership (field.py
        # drops the shard from remote_available_shards on creation).
        frag = v.create_fragment_if_not_exists(shard)
        ok = self._merge_with_replicas(
            frag, key, replicas,
            # Quarantined local data must not outvote healthy replicas.
            include_local=(entry["state"] == STATE_DEGRADED))
        if ok is None:
            return False  # no replica reachable: retry next pass
        # The fragment now holds replica consensus: flip to degraded so
        # the snapshot guard lets the clean re-snapshot through.
        self.store.quarantine.set_state(key, STATE_DEGRADED)
        self.store.snapshot_fragment(key)
        if self.store.verify_snapshot(key) != "ok":
            return False
        self._count("integrity.repaired")
        self._log("scrub: repaired %s/%s/%s/%d from %d replica(s)",
                  index, field, view, shard, len(replicas))
        self.store.quarantine.release(key)
        self.store.prune_quarantine_evidence(key)
        return True

    def _merge_with_replicas(self, frag, key: tuple, replicas,
                             include_local: bool,
                             push_remote: bool = False) -> bool | None:
        """Block-level consensus merge of ``frag`` against ``replicas``.
        Returns changed-ness, or None when no replica was reachable."""
        index, field, view, shard = key
        local_blocks = frag.checksum_blocks()
        peer_blocks, live = [], []
        for node in replicas:
            try:
                peer_blocks.append(self.client.fragment_blocks(
                    node, index, field, view, shard))
                live.append(node)
            except LookupError:
                peer_blocks.append({})
                live.append(node)
            except ConnectionError:
                continue
        if not live:
            return None
        block_ids = set(local_blocks)
        for pb in peer_blocks:
            block_ids |= set(pb)
        idx = self.holder.index(index)
        epoch = idx.epoch if idx is not None else None
        changed = False
        raced = False
        for b in sorted(block_ids):
            if (include_local
                    and all(pb.get(b) == local_blocks.get(b)
                            for pb in peer_blocks)):
                continue
            # Same read-merge-write guard as HolderSyncer: a write
            # landing while this block's plan is in flight must not be
            # undone by the stale plan (resurrection). See sync.py.
            e0 = epoch.value if epoch is not None else None
            local_pairs = frag.block_data(b)
            remote_pairs, reachable = [], []
            empty = (np.empty(0, np.uint64), np.empty(0, np.uint64))
            for node in live:
                try:
                    remote_pairs.append(self.client.fragment_block_data(
                        node, index, field, view, shard, b))
                    reachable.append(node)
                except LookupError:
                    remote_pairs.append(empty)
                    reachable.append(node)
                except ConnectionError:
                    continue
            if not reachable:
                continue
            (lsets, lclears), remote_diffs = merge_block(
                local_pairs, remote_pairs, include_local=include_local)
            if e0 is not None and epoch.value != e0:
                raced = True  # a write raced this merge: stale plan
                continue
            if len(lsets[0]):
                frag.bulk_import(lsets[0].tolist(), lsets[1].tolist())
                changed = True
            if len(lclears[0]):
                frag.bulk_import(lclears[0].tolist(), lclears[1].tolist(),
                                 clear=True)
                changed = True
            if not push_remote:
                continue  # quarantine repair: anti-entropy pushes those
            for node, (rsets, rclears) in zip(reachable, remote_diffs):
                try:
                    if len(rsets[0]):
                        self.client.import_bits(
                            node, index, field, view, shard,
                            rsets[0].tolist(), rsets[1].tolist(), False)
                        changed = True
                    if len(rclears[0]):
                        self.client.import_bits(
                            node, index, field, view, shard,
                            rclears[0].tolist(), rclears[1].tolist(), True)
                        changed = True
                except (ConnectionError, LookupError):
                    continue  # next pass retries this peer
        # A raced block means the merge plan was PARTIAL: a repair
        # caller must not snapshot-and-release on it — retry next pass.
        return None if raced else changed
