"""Cross-node result-cache invalidation.

The executor's result cache is validated by the index mutation epoch,
which only local writes bump — so cluster-mode coordinator caching needs
peers to learn about each other's writes. Every local epoch bump marks
the index dirty here; marks are coalesced per index inside a small
trailing window and broadcast as ``index-dirty`` control messages, and
the receiving node bumps its own epoch WITHOUT re-notifying (no echo
storm). Consistency is the reference's: eventual across nodes (there is
no cross-node read-your-writes either way — a remote write is visible
only after its owner applied it), with staleness bounded by
window + one control-message delivery.

Reference analog: the cache-invalidation role of NodeStatus/broadcast
messages (broadcast.go:55-72); the reference sidesteps the problem by
having no coordinator result cache at all — here the cache is the system
answer to a device link whose per-sync latency dwarfs compute, so
invalidation has to exist.

The port's copy of pilosa_tpu/cluster/dirty.py.
"""

from __future__ import annotations

import threading
import time


class DirtyBroadcaster:
    """Coalescing per-index ``index-dirty`` fan-out."""

    #: trailing coalesce window (seconds): a write burst sends at most
    #: one broadcast per index per window, plus one trailing flush.
    DEFAULT_WINDOW = 0.05

    def __init__(self, cluster, window: float | None = None):
        self.cluster = cluster
        self.window = self.DEFAULT_WINDOW if window is None else window
        self._lock = threading.Lock()
        self._last_sent: dict[str, float] = {}
        #: index -> shard set mutated since the last flush; None means an
        #: index-wide (shardless) bump happened and the broadcast must
        #: floor-bump the whole index on peers.
        self._pending: dict[str, set[int] | None] = {}
        #: index -> its Epoch, for reading shard vectors at flush time.
        self._epochs: dict[str, object] = {}
        self._timer: threading.Timer | None = None
        self._closed = False

    def attach(self, idx) -> None:
        """Subscribe to an index's data epoch (Holder.index_listener)."""
        self._epochs[idx.name] = idx.epoch
        idx.epoch.subscribe(
            lambda shard=None, name=idx.name: self.mark(name, shard))

    def mark(self, index_name: str, shard: int | None = None) -> None:
        """A local write bumped this index's epoch (for ``shard``, or
        index-wide when None)."""
        if self._closed:
            return
        now = time.monotonic()
        with self._lock:
            if self._closed:  # re-check under the lock: close() races
                return
            if index_name in self._pending:
                # A flush is already scheduled: just widen its payload.
                cur = self._pending[index_name]
                if cur is not None:
                    if shard is None:
                        self._pending[index_name] = None
                    else:
                        cur.add(int(shard))
                return
            last = self._last_sent.get(index_name, -1e9)
            if now - last >= self.window:
                self._last_sent[index_name] = now
                delay = 0.0
            else:
                delay = (last + self.window) - now
            self._pending[index_name] = (None if shard is None
                                         else {int(shard)})
            self._schedule(delay)

    def _schedule(self, delay: float) -> None:
        # One timer at a time; sends always happen OFF the write path
        # (a write must never block on N-1 peer RPCs).
        if self._timer is not None:
            return  # the live timer flushes everything pending
        t = threading.Timer(delay, self._flush)
        t.daemon = True
        self._timer = t
        t.start()

    def _flush(self) -> None:
        with self._lock:
            pending = dict(self._pending)
            self._pending.clear()
            self._timer = None
            now = time.monotonic()
            for n in pending:
                self._last_sent[n] = now
        for name in sorted(pending):
            shards = pending[name]
            msg = {"type": "index-dirty", "index": name,
                   "sender": self.cluster.local_id,
                   # Receivers drop dirty coordination from a sender
                   # whose topology view is stale (deposed coordinator
                   # still flushing across a healed partition).
                   "fencingToken": self.cluster.fencing_token()}
            if shards is not None:
                # Shard detail lets peers bump ONLY the mutated shards
                # (their plans elsewhere keep cached results), and the
                # sender's epoch vector gives their coordinator caches an
                # exact cross-node stamp. A peer that ignores the extra
                # keys still floor-bumps — wire-compatible both ways.
                sl = sorted(shards)
                msg["shards"] = sl
                ep = self._epochs.get(name)
                if ep is not None:
                    msg["shardEpochs"] = {str(s): ep.shard_epoch(s)
                                          for s in sl}
            for node in self.cluster.nodes:
                if node.id == self.cluster.local_id or node.state == "DOWN":
                    continue
                try:
                    self.cluster.client.send_message(node, msg)
                except (ConnectionError, RuntimeError, LookupError):
                    pass  # peer down: its cache rebuilds via epoch on rejoin

    def flush_now(self) -> None:
        """Synchronous flush (tests / shutdown)."""
        self._flush()

    def close(self) -> None:
        # Refuse NEW marks first, THEN flush: the reverse order lets a
        # mark racing close slip into _pending after the final flush
        # snapshots it — accepted but never broadcast.
        self._closed = True
        with self._lock:
            t, self._timer = self._timer, None
        if t is not None:
            t.cancel()
        self._flush()


def apply_index_dirty(holder, message: dict, remote_epochs=None) -> None:
    """Receiver side: bump the local epoch without re-notifying —
    per-shard when the message carries shard detail, index-wide floor
    otherwise (legacy senders). The sender's shard-epoch vector, when
    present, feeds the executor's RemoteEpochTable so coordinator cache
    stamps track the writer's exact position."""
    name = message.get("index", "")
    idx = holder.index(name)
    if idx is None:
        return
    shards = message.get("shards")
    if shards:
        idx.epoch.bump_shards(shards, notify=False)
    else:
        idx.epoch.bump(notify=False)
    sender = message.get("sender")
    epochs = message.get("shardEpochs")
    if remote_epochs is not None and sender and epochs:
        remote_epochs.observe(name, sender,
                              {int(s): int(e) for s, e in epochs.items()})
