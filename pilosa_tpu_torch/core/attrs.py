"""Attribute storage: arbitrary k/v metadata on rows and columns.

The port's copy of pilosa_tpu/core/attrs.py. Reference: attr.go
(AttrStore :34, AttrBlocks/Diff :80-110) with the boltdb implementation
(boltdb/attrstore.go). Here: an in-memory dict with optional JSON-lines
persistence (durability handled by the holder's snapshot cycle), plus the
same 100-id checksummed block protocol used by anti-entropy sync
(``GET /internal/attr/blocks`` and ``/internal/attr/data``).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any

from pilosa_tpu_torch.obs.logger import StandardLogger
from pilosa_tpu_torch.storage.integrity import (
    LineCorruptError,
    frame_line,
    parse_line,
)

#: ids per checksum block (reference attrBlockSize attr.go:28).
ATTR_BLOCK_SIZE = 100

_logger = StandardLogger()


class AttrStore:
    """id -> {attr: value} with checksummed blocks for replica diffing."""

    def __init__(self, path: str | None = None, epoch=None):
        self.path = path
        #: index mutation epoch (core.index.Epoch): attr writes change
        #: query results (Row attrs, TopN attr filters), so they must
        #: invalidate epoch-stamped result caches too.
        self.epoch = epoch
        self._attrs: dict[int, dict[str, Any]] = {}
        #: integrity counters from the last _load (operator-facing).
        self.corrupt_lines = 0
        self.unverified_lines = 0
        self._lock = threading.RLock()
        if path and os.path.exists(path):
            self._load()

    # -- kv ----------------------------------------------------------------

    def attrs(self, id_: int) -> dict[str, Any]:
        with self._lock:
            return dict(self._attrs.get(id_, {}))

    def set_attrs(self, id_: int, attrs: dict[str, Any]) -> None:
        """Merge semantics: None deletes a key (reference attr.go SetAttrs)."""
        with self._lock:
            cur = self._attrs.setdefault(id_, {})
            for k, v in attrs.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v
            if not cur:
                del self._attrs[id_]
            if self.epoch is not None:
                self.epoch.bump()

    def set_bulk_attrs(self, attrs_by_id: dict[int, dict[str, Any]]) -> None:
        with self._lock:
            for id_, attrs in attrs_by_id.items():
                self.set_attrs(id_, attrs)

    def ids(self) -> list[int]:
        with self._lock:
            return sorted(self._attrs)

    # -- anti-entropy blocks (reference attr.go:80-110) --------------------

    def blocks(self) -> list[tuple[int, bytes]]:
        """[(block_id, checksum)] over ATTR_BLOCK_SIZE-id blocks."""
        with self._lock:
            out: dict[int, hashlib._Hash] = {}
            for id_ in sorted(self._attrs):
                b = id_ // ATTR_BLOCK_SIZE
                h = out.get(b)
                if h is None:
                    h = out[b] = hashlib.blake2b(digest_size=16)
                h.update(json.dumps([id_, self._attrs[id_]], sort_keys=True).encode())
            return [(b, h.digest()) for b, h in sorted(out.items())]

    def block_data(self, block: int) -> dict[int, dict[str, Any]]:
        with self._lock:
            lo, hi = block * ATTR_BLOCK_SIZE, (block + 1) * ATTR_BLOCK_SIZE
            return {i: dict(a) for i, a in self._attrs.items() if lo <= i < hi}

    @staticmethod
    def diff_blocks(mine: list[tuple[int, bytes]],
                    theirs: list[tuple[int, bytes]]) -> list[int]:
        """Block ids present/differing in theirs vs mine (attr.go Diff)."""
        m = dict(mine)
        return sorted(b for b, sum_ in theirs if m.get(b) != sum_)

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.rstrip("\n")
                if not line.strip():
                    continue
                try:
                    payload, verified = parse_line(line)
                    id_, attrs = json.loads(payload)
                except (LineCorruptError, ValueError) as e:
                    self.corrupt_lines += 1
                    _logger.printf(
                        "attrs: skipping corrupt line %d in %s: %s",
                        lineno, self.path, e)
                    continue
                if not verified:
                    self.unverified_lines += 1
                self._attrs[int(id_)] = attrs

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            tmp = self.path + ".tmp"
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                for id_ in sorted(self._attrs):
                    f.write(frame_line(json.dumps([id_, self._attrs[id_]]))
                            + "\n")
            os.replace(tmp, self.path)
