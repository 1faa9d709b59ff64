"""Corruption quarantine: evidence preservation + degraded routing state
(the port's copy of pilosa_tpu/storage/quarantine.py).

A durable artifact that fails verification at load (snapshot footer CRC,
mid-file WAL corruption) is renamed to ``<name>.quarantine`` — never
deleted, the operator may want the evidence — and its fragment key is
registered here.  The registry is the single source of truth for what a
node may NOT serve locally:

- ``degraded``   — the fragment serves partial local data (WAL-only
                   replay after a corrupt snapshot); legal only when no
                   replica can serve the full truth (standalone nodes).
- ``routed``     — a cluster peer owns a clean replica; the local copy
                   was dropped and queries must not land here (see
                   ``cluster.scrub.route_quarantined_to_replicas``).
- ``unavailable``— no local data survives (snapshot corrupt AND the WAL
                   empty) and no replica is known; queries over the
                   shard fail with ``ShardCorruptError`` instead of
                   silently serving zeros.

Entries leave the registry only through ``release`` — after the scrubber
has repaired the fragment from replica consensus and a clean checksummed
snapshot is back on disk.
"""

from __future__ import annotations

import os
import threading
import time

from pilosa_tpu_torch.errors import PilosaError

#: entry states
STATE_DEGRADED = "degraded"
STATE_ROUTED = "routed"
STATE_UNAVAILABLE = "unavailable"

#: states under which the local node must not serve the shard
BLOCKED_STATES = (STATE_ROUTED, STATE_UNAVAILABLE)


class ShardCorruptError(PilosaError):
    """Distinct from ShardUnavailableError (a membership problem): the
    shard's local data is quarantined and no clean replica is reachable."""

    message = "shard data quarantined: no clean copy available"


class QuarantineRegistry:
    """Tracks quarantined fragment keys and their preserved files."""

    def __init__(self, stats=None, logger=None):
        self._stats = stats
        self._logger = logger
        self._entries: dict[tuple, dict] = {}
        self._lock = threading.Lock()

    # -- intake ------------------------------------------------------------

    def quarantine_file(self, key: tuple, path: str, reason: str,
                        state: str = STATE_UNAVAILABLE) -> str | None:
        """Rename ``path`` aside (never delete) and register ``key``.
        Returns the quarantined path, or None when the rename failed.

        Repeat quarantines of the same file take numbered suffixes
        (``.quarantine.1``, ``.quarantine.2`` …) so later evidence never
        clobbers earlier evidence; the store's ``--quarantine-keep-n``
        pruner is what bounds the accumulation."""
        qpath = path + ".quarantine"
        n = 0
        while os.path.exists(qpath):
            n += 1
            qpath = f"{path}.quarantine.{n}"
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = None
        with self._lock:
            e = self._entries.setdefault(key, {
                "key": key, "files": [], "reasons": [],
                "state": state, "since": time.time(),
            })
            if qpath is not None:
                e["files"].append(qpath)
            e["reasons"].append(reason)
            # Never upgrade: unavailable beats degraded.
            if state == STATE_UNAVAILABLE or e["state"] == STATE_UNAVAILABLE:
                e["state"] = STATE_UNAVAILABLE
        if self._stats is not None:
            self._stats.count("integrity.quarantined")
        if self._logger is not None:
            self._logger.printf(
                "integrity: quarantined %s (%s): %s",
                "/".join(str(p) for p in key), state, reason)
        return qpath

    def set_state(self, key: tuple, state: str) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e["state"] = state

    def release(self, key: tuple) -> bool:
        """Drop the entry after a verified repair + clean re-snapshot.
        The ``*.quarantine`` files stay on disk."""
        with self._lock:
            e = self._entries.pop(key, None)
        if e is None:
            return False
        if self._stats is not None:
            self._stats.count("integrity.released")
        if self._logger is not None:
            self._logger.printf("integrity: released %s after repair",
                                "/".join(str(p) for p in key))
        return True

    # -- queries -----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: tuple) -> dict | None:
        with self._lock:
            e = self._entries.get(key)
            return dict(e) if e is not None else None

    def keys(self) -> list[tuple]:
        with self._lock:
            return sorted(self._entries)

    def entries(self) -> list[dict]:
        """JSON-able view for /debug/quarantine and `check`."""
        with self._lock:
            out = []
            for (index, field, view, shard), e in sorted(
                    self._entries.items()):
                out.append({"index": index, "field": field, "view": view,
                            "shard": shard, "state": e["state"],
                            "files": list(e["files"]),
                            "reasons": list(e["reasons"]),
                            "since": e["since"]})
            return out

    def blocked_shards(self, index: str) -> set[int]:
        """Shards of ``index`` the local node must not serve."""
        with self._lock:
            return {k[3] for k, e in self._entries.items()
                    if k[0] == index and e["state"] in BLOCKED_STATES}
