"""Cluster-wide key translation: coordinator-primary allocation + replica
entry streaming.

Reference: translate.go:93 (MultiTranslateEntryReader — replicas stream
entries from the primary), holder.go:785-878 (the replication loop), and
http/translator.go. Without this, every node allocates ids independently
and keyed indexes silently diverge across the cluster (two clients
hitting two nodes get conflicting key→id maps).

Two pieces:
- ``ClusterKeyTranslator`` — the Executor/API allocation hook: the
  coordinator allocates locally; every other node RPCs
  ``/internal/translate/keys`` on the coordinator and applies the
  returned (id, key) entries to its local store so reverse (id→key)
  lookups work for everything it has seen.
- ``sync_translation`` — the anti-entropy pull (holder.go:821-878
  analog): non-coordinators fetch ``entries_since(local max id)`` for
  every index/field store from the coordinator, catching up mappings
  allocated by queries that never touched this node.

The port's copy of pilosa_tpu/cluster/translate_sync.py (host code: nothing here
touches the device).
"""

from __future__ import annotations

from pilosa_tpu_torch.core.holder import Holder


def _store(holder: Holder, index: str, field: str | None):
    idx = holder.index(index)
    if idx is None:
        raise LookupError(f"index not found: {index!r}")
    if field is None:
        return idx.translate_store
    f = idx.field(field)
    if f is None:
        raise LookupError(f"field not found: {index}/{field}")
    return f.translate_store


class ClusterKeyTranslator:
    """(index, field|None, keys) -> ids, with the coordinator as the sole
    id authority."""

    def __init__(self, holder: Holder, cluster, client):
        self.holder = holder
        self.cluster = cluster
        self.client = client

    def __call__(self, index: str, field: str | None,
                 keys: list[str]) -> list[int]:
        keys = list(keys)
        store = _store(self.holder, index, field)
        coord = self.cluster.coordinator()
        if coord is None or coord.id == self.cluster.local_id:
            # One batched allocation: one lock, one epoch bump.
            return store.translate_keys(keys)
        # Replica-local read path: every key already in the synced local
        # store (anything at or below the replication watermark, plus
        # entries applied by earlier lookups) resolves from the lock-free
        # snapshot with ZERO coordinator traffic; only the misses — the
        # keys that may need allocation — travel, in ONE batched RPC per
        # call instead of one round-trip per key.
        ids = store.translate_keys(keys, create=False)
        missing = [i for i, v in enumerate(ids) if v is None]
        if not missing:
            return ids
        # Coordinator unreachable: serve what the replica knows, but
        # never allocate locally (that is how stores diverge) — with
        # unresolved keys the error propagates.
        sub = [keys[i] for i in missing]
        got = self.client.translate_keys(coord, index, field, sub)
        store.apply_entries(zip(got, sub))
        for i, v in zip(missing, got):
            ids[i] = v
        return ids


def translate_entries(holder: Holder, index: str, field: str | None,
                      after_id: int) -> list[tuple[int, str]]:
    """Server-side handler body for /internal/translate/entries."""
    return _store(holder, index, field).entries_since(after_id)


def sync_translation(holder: Holder, cluster, client) -> int:
    """Pull missing entries from the coordinator for every store; returns
    the number of entries applied. No-op on the coordinator itself."""
    coord = cluster.coordinator()
    if coord is None or coord.id == cluster.local_id:
        return 0
    applied = 0
    for index_name in holder.index_names():
        idx = holder.index(index_name)
        targets = [(index_name, None, idx.translate_store)]
        targets += [(index_name, fname, f.translate_store)
                    for fname, f in sorted(idx.fields.items())]
        for iname, fname, store in targets:
            try:
                # Pull from the contiguous watermark, NOT max_id():
                # apply_entries advances _next past ids this replica never
                # saw, so max_id() can skip over coordinator entries.
                entries = client.translate_entries(
                    coord, iname, fname, store.replication_watermark())
            except (ConnectionError, LookupError):
                continue
            if entries:
                store.apply_entries(entries)
                applied += len(entries)
    return applied
