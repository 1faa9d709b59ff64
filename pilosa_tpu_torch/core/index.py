"""Index — a container of fields plus the existence field.

The port's counterpart of pilosa_tpu/core/index.py. Reference: index.go
(struct :37, createField :416, DeleteField :471, AvailableShards :292) and
holder.go:46 (existence field ``_exists``). A keyed index
(``keys=True``) translates column keys through its ``translate_store``
(core/translate.py); the column-attr and translate stores persist with the
data dir.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from pilosa_tpu_torch.config import EXISTENCE_FIELD_NAME
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.field import Field, FieldOptions
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.errors import (
    FieldExistsError,
    FieldNotFoundError,
    validate_name,
)


@dataclass
class IndexOptions:
    """Reference IndexOptions (index.go:910)."""

    keys: bool = False
    track_existence: bool = True

    def to_json(self) -> dict:
        return {"keys": self.keys, "trackExistence": self.track_existence}

    @classmethod
    def from_json(cls, d: dict) -> "IndexOptions":
        return cls(keys=d.get("keys", False),
                   track_existence=d.get("trackExistence", True))


class Epoch:
    """Monotonic mutation counter for one index, with per-shard grain.

    Bumped by every fragment/attr mutation anywhere under the index; the
    planner's leaf-stack cache and the executor's result cache validate
    with ONE epoch compare instead of walking per-fragment generations,
    and walk them only when the epoch moved.

    Shard grain (the JAX package's): a bump that knows which shard
    mutated records that shard's position in the global sequence, so a
    plan touching shards S stamps itself with ``max_shard_epoch(S)`` --
    writes to shards outside S advance ``value`` but leave that max
    unchanged. A shardless ``bump()`` (attrs, field and view changes)
    raises the floor under every shard instead.

    Listeners (cluster mode) turn local bumps into index-dirty broadcasts
    so peer nodes can invalidate their coordinator result caches; they
    are called ``fn(shard)`` with the mutated shard, or ``None`` for an
    index-wide bump. A bump a peer's broadcast triggers passes
    ``notify=False``, so it is never broadcast back."""

    __slots__ = ("_value", "_floor", "_shards", "_lock", "_listeners")

    def __init__(self):
        self._value = 0
        #: every shard's epoch is at least this (index-wide bumps land here).
        self._floor = 0
        #: shard -> sequence position of its last shard-tagged bump.
        self._shards: dict[int, int] = {}
        self._lock = threading.Lock()
        self._listeners: list = []

    def bump(self, shard: int | None = None, notify: bool = True) -> None:
        with self._lock:
            self._value += 1
            if shard is None:
                self._floor = self._value
                self._shards.clear()  # all <= floor now: drop the detail
            else:
                self._shards[shard] = self._value
        if notify:
            for fn in list(self._listeners):
                try:
                    fn(shard)
                except Exception:
                    pass  # observers never break the write path

    def bump_shards(self, shards: Iterable[int], notify: bool = True) -> None:
        """One sequence increment covering a whole shard batch (bulk
        imports: one cache invalidation and one dirty broadcast per batch,
        not one per shard)."""
        shards = [int(s) for s in shards]
        if not shards:
            return
        with self._lock:
            self._value += 1
            for s in shards:
                self._shards[s] = self._value
        if notify:
            for fn in list(self._listeners):
                for s in shards:
                    try:
                        fn(s)
                    except Exception:
                        pass

    def subscribe(self, fn) -> None:
        self._listeners.append(fn)

    @property
    def value(self) -> int:
        return self._value

    def shard_epoch(self, shard: int) -> int:
        with self._lock:
            return max(self._shards.get(shard, 0), self._floor)

    def max_shard_epoch(self, shards: Iterable[int]) -> int:
        """Stamp for a plan touching ``shards``: strictly increases when
        any of them mutates, holds still when only other shards do."""
        with self._lock:
            m = self._floor
            get = self._shards.get
            for s in shards:
                v = get(s, 0)
                if v > m:
                    m = v
            return m

    def shard_vector(self, shards: Iterable[int]) -> dict[int, int]:
        """Per-shard epochs for the wire (remote legs report theirs so the
        coordinator can stamp cross-node cache entries)."""
        with self._lock:
            floor = self._floor
            get = self._shards.get
            return {int(s): max(get(int(s), 0), floor) for s in shards}


_instance_counter = itertools.count(1)


class Index:
    """Reference Index (index.go:37)."""

    def __init__(self, name: str, device: torch.device,
                 options: IndexOptions | None = None, op_writer_factory=None,
                 fragment_listener=None):
        validate_name(name)
        self.name = name
        self.device = device
        #: process-unique identity: a deleted-and-recreated index restarts
        #: its epoch, so caches keyed on (name, epoch) also key on this.
        self.instance_id = next(_instance_counter)
        self.options = options or IndexOptions()
        self.op_writer_factory = op_writer_factory
        self.fragment_listener = fragment_listener
        self.epoch = Epoch()
        #: bumped on structural changes (field create/delete, BSI bit-depth
        #: growth): prepared plans bake field structure, so the planner's
        #: plan cache and the result cache key on it beside the data epoch.
        self.schema_epoch = Epoch()
        #: column attrs (SetColumnAttrs, ?columnAttrs=true): a file store
        #: on a node with a data dir.
        self.column_attr_store = AttrStore(epoch=self.epoch)
        #: column key <-> id (a keyed index's columns).
        self.translate_store = TranslateStore(epoch=self.epoch)
        #: (epoch stamp, frozenset) memo for available_shards().
        self._avail_shards_cache: tuple | None = None
        self.fields: dict[str, Field] = {}
        self._lock = threading.RLock()
        if self.options.track_existence:
            self.fields[EXISTENCE_FIELD_NAME] = Field(
                self.name, EXISTENCE_FIELD_NAME, device,
                FieldOptions(cache_type="none", cache_size=0), epoch=self.epoch,
                op_writer_factory=op_writer_factory,
                schema_epoch=self.schema_epoch, fragment_listener=fragment_listener)

    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def existence_field(self) -> Field | None:
        return self.fields.get(EXISTENCE_FIELD_NAME)

    def public_fields(self) -> list[Field]:
        return [f for n, f in sorted(self.fields.items())
                if n != EXISTENCE_FIELD_NAME]

    def create_field(self, name: str, options: FieldOptions | None = None) -> Field:
        with self._lock:
            if name in self.fields:
                raise FieldExistsError()
            f = Field(self.name, name, self.device, options, epoch=self.epoch,
                      op_writer_factory=self.op_writer_factory,
                      schema_epoch=self.schema_epoch,
                      fragment_listener=self.fragment_listener)
            self.fields[name] = f
            self.epoch.bump()
            self.schema_epoch.bump()
            return f

    def create_field_if_not_exists(self, name: str,
                                   options: FieldOptions | None = None) -> Field:
        with self._lock:
            return self.fields.get(name) or self.create_field(name, options)

    def delete_field(self, name: str) -> None:
        with self._lock:
            if name not in self.fields:
                raise FieldNotFoundError()
            del self.fields[name]
            self.epoch.bump()
            self.schema_epoch.bump()

    def add_existence(self, column_ids: Iterable[int]) -> None:
        """Mark columns existing (reference executeSet's existence write,
        executor.go:2096)."""
        ef = self.existence_field()
        if ef is None:
            return
        cols = np.asarray(list(column_ids), dtype=np.uint64)
        ef.import_bits(np.zeros(len(cols), dtype=np.uint64), cols)

    def available_shards(self) -> set[int]:
        """Union over fields (reference index.go:292), memoized on the
        epoch: any write or field change invalidates."""
        stamp = self.epoch.value
        cached = self._avail_shards_cache
        if cached is not None and cached[0] == stamp:
            return set(cached[1])
        out: set[int] = set()
        for f in self.fields.values():
            out |= f.available_shards()
        out = out or {0}
        self._avail_shards_cache = (stamp, frozenset(out))
        return out

    def info(self) -> dict:
        return {
            "name": self.name,
            "options": self.options.to_json(),
            "fields": [f.info() for f in self.public_fields()],
        }

    def __repr__(self):
        return f"Index({self.name} fields={sorted(self.fields)})"
