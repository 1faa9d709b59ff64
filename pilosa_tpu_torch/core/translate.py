"""Key translation: string key <-> uint64 id, per index and per field.

The port's copy of pilosa_tpu/core/translate.py: the same store, the same
snapshot rule and the same framed ``translate.jsonl`` file, so a data dir
crosses between the packages. Reference: translate.go (TranslateStore :35, in-memory impl :220) and
boltdb/translate.go:48 (sequence-allocated ids starting at 1, with a
primary/replica streaming protocol handled at the cluster layer).

Concurrency model (the lock-free read path):

The maps ``_fwd``/``_rev`` and the id-ordered entry log ``_log`` are
*published immutable snapshots*: mutators build new containers under
``_lock`` and rebind the attributes; they never mutate a published
container in place. Readers do one attribute load plus a ``dict.get``
— no lock — and see either the old snapshot or the new one, both
internally consistent. Mappings are append-only (an id, once
allocated, never changes meaning on the allocation path), so a stale
snapshot is *correct but incomplete*: a reader can miss a brand-new
key, never see a wrong id.

``version`` counts snapshot publications. Derived read structures
(the device key planes in ``exec/keyplane.py``) record the version
they were built from and rebuild when it moves. Readers that pair a
version with a snapshot must read ``version`` FIRST: racing a publish
then yields an *older* version with possibly newer dicts, which only
causes a redundant rebuild — the reverse order could stamp a stale
snapshot as current.

Batched mutators (``translate_keys``, ``apply_entries``) take the lock
at most once per batch and bump the index epoch at most once per
batch. The per-key epoch storm of the original implementation
invalidated the result cache once per new key on keyed ingest.
"""

from __future__ import annotations

import json
import os
import threading
from bisect import bisect_right
from operator import itemgetter

from pilosa_tpu_torch.errors import TranslateStoreReadOnlyError
from pilosa_tpu_torch.obs.logger import StandardLogger
from pilosa_tpu_torch.storage.integrity import (
    LineCorruptError,
    frame_line,
    parse_line,
)

_logger = StandardLogger()

_entry_id = itemgetter(0)


class TranslateStore:
    """Monotonic id allocator with forward and reverse maps."""

    def __init__(self, path: str | None = None, read_only: bool = False,
                 epoch=None):
        self.path = path
        self.read_only = read_only
        #: index mutation Epoch, bumped whenever a NEW mapping lands.
        #: Cached query results embed translated keys (and the
        #: ``str(id)`` fallback for ids with no mapping yet), so a
        #: mapping arriving after a result was cached must invalidate it
        #: — this was a silent mutating path before the result cache
        #: keyed on it. Index-wide (floor) bump: keys aren't per-shard.
        self.epoch = epoch
        #: snapshot publication counter (see module docstring). Device
        #: key planes compare against this to decide on a rebuild.
        self.version = 0
        self._fwd: dict[str, int] = {}
        self._rev: dict[int, str] = {}
        #: id-ascending ``(id, key)`` entry log, published immutable
        #: alongside the maps. ``entries_since`` bisects it so replica
        #: pulls are O(delta), not O(store).
        self._log: list[tuple[int, str]] = []
        self._next = 1  # ids start at 1 (boltdb/translate.go sequence)
        #: contiguous replication watermark: highest id W such that every
        #: id in [1, W] is present. apply_entries may skip ids allocated
        #: on the coordinator by other writers, so replica pulls resume
        #: from here, not max_id() (which _next races ahead of).
        self._watermark = 0
        #: integrity counters from the last _load (operator-facing).
        self.corrupt_lines = 0
        self.unverified_lines = 0
        self._lock = threading.RLock()
        if path and os.path.exists(path):
            self._load()

    # -- read path (lock-free snapshot loads) ------------------------------

    def translate_key(self, key: str, create: bool = True) -> int | None:
        return self.translate_keys((key,), create)[0]

    def translate_id(self, id_: int) -> str | None:
        return self._rev.get(id_)

    def translate_ids(self, ids) -> list[str | None]:
        rev = self._rev  # one snapshot for the whole batch
        return [rev.get(i) for i in ids]

    def snapshot(self) -> tuple[int, dict[str, int], dict[int, str]]:
        """``(version, fwd, rev)`` for derived read structures.

        The dicts are published snapshots — treat them as immutable.
        ``version`` is read first so a racing publish can only make the
        triple conservative (older version, possibly newer dicts).
        """
        v = self.version
        return v, self._fwd, self._rev

    def max_id(self) -> int:
        with self._lock:
            return self._next - 1

    def replication_watermark(self) -> int:
        """Highest id up to which the store is gap-free — the safe
        ``entries_since`` cursor for replica pulls."""
        with self._lock:
            w = self._watermark
            rev = self._rev
            while (w + 1) in rev:
                w += 1
            self._watermark = w
            return w

    # -- write path (one lock acquisition, one epoch bump per batch) -------

    def translate_keys(self, keys, create: bool = True) -> list[int | None]:
        keys = list(keys)
        fwd = self._fwd  # lock-free fast path over one snapshot
        ids = [fwd.get(k) for k in keys]
        if not create or None not in ids:
            return ids
        if self.read_only:
            raise TranslateStoreReadOnlyError()
        allocated = False
        with self._lock:
            fwd = dict(self._fwd)
            rev = dict(self._rev)
            log = self._log
            appended: list[tuple[int, str]] = []
            for pos, key in enumerate(keys):
                if ids[pos] is not None:
                    continue
                id_ = fwd.get(key)  # re-check: may have landed since
                if id_ is None:
                    id_ = self._next
                    self._next += 1
                    fwd[key] = id_
                    rev[id_] = key
                    appended.append((id_, key))
                    allocated = True
                ids[pos] = id_
            if allocated:
                self.version += 1
                self._fwd = fwd
                self._rev = rev
                self._log = log + appended  # local ids are ascending
        if allocated and self.epoch is not None:
            self.epoch.bump()  # local allocation
        return ids

    # -- replication feed (cluster layer streams entries id-ascending) -----

    def entries_since(self, after_id: int) -> list[tuple[int, str]]:
        log = self._log  # published snapshot, lock-free
        return log[bisect_right(log, after_id, key=_entry_id):]

    def apply_entries(self, entries) -> None:
        entries = list(entries)
        if not entries:
            return
        applied = False
        with self._lock:
            fwd = dict(self._fwd)
            rev = dict(self._rev)
            log = list(self._log)
            needs_sort = False
            rebuild_log = False
            for id_, key in entries:
                id_ = int(id_)
                cur = rev.get(id_)
                if cur != key:
                    applied = True
                    if cur is None:
                        # Remote ids may interleave with local ones, so
                        # appends can land out of order — note it and
                        # restore id order once, after the loop.
                        if log and id_ <= log[-1][0]:
                            needs_sort = True
                        log.append((id_, key))
                    else:
                        rebuild_log = True  # id re-keyed: entry replaced
                fwd[key] = id_
                rev[id_] = key
                self._next = max(self._next, id_ + 1)
            if applied:
                if rebuild_log:
                    log = sorted(rev.items())
                elif needs_sort:
                    log.sort(key=_entry_id)
                self.version += 1
                self._fwd = fwd
                self._rev = rev
                self._log = log
        if applied and self.epoch is not None:
            # Replayed entries (a restore, a copy): invalidate local caches.
            # A standalone node has no peers to leave un-notified, so this
            # is the one bump the JAX store makes with notify=False.
            self.epoch.bump()

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.rstrip("\n")
                if not line.strip():
                    continue
                try:
                    payload, verified = parse_line(line)
                    id_, key = json.loads(payload)
                except (LineCorruptError, ValueError) as e:
                    # Skip the damaged line, keep the rest of the store:
                    # one flipped bit must not take the whole index's
                    # key translation down.
                    self.corrupt_lines += 1
                    _logger.printf(
                        "translate: skipping corrupt line %d in %s: %s",
                        lineno, self.path, e)
                    continue
                if not verified:
                    self.unverified_lines += 1
                self._fwd[key] = int(id_)
                self._rev[int(id_)] = key
        if self._rev:
            self._next = max(self._rev) + 1
            self._log = sorted(self._rev.items())

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            log = self._log
            tmp = self.path + ".tmp"
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                for id_, key in log:
                    f.write(frame_line(json.dumps([id_, key])) + "\n")
            os.replace(tmp, self.path)
