"""Index — a container of fields plus the existence field.

The port's counterpart of pilosa_tpu/core/index.py. Reference: index.go
(struct :37, createField :416, DeleteField :471, AvailableShards :292) and
holder.go:46 (existence field ``_exists``). Keyed indexes raise
``NotPortedError``; the column-attr store persists with the data dir, and
the queries that use it come with a later slice.
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
from pilosa_tpu_torch.errors import (
    SLICE_KEYS,
    FieldExistsError,
    FieldNotFoundError,
    NotPortedError,
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
    """Monotonic mutation counter for one index.

    Bumped by every fragment mutation anywhere under the index; the
    planner's leaf-stack cache validates with ONE epoch compare instead of
    walking per-fragment generations, and walks them only when the epoch
    moved. (The JAX package's per-shard grain and listeners serve its
    result cache and cluster broadcasts, which later slices port.)"""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self._value += 1

    @property
    def value(self) -> int:
        return self._value


_instance_counter = itertools.count(1)


class Index:
    """Reference Index (index.go:37)."""

    def __init__(self, name: str, device: torch.device,
                 options: IndexOptions | None = None, op_writer_factory=None):
        validate_name(name)
        self.name = name
        self.device = device
        #: process-unique identity: a deleted-and-recreated index restarts
        #: its epoch, so caches keyed on (name, epoch) also key on this.
        self.instance_id = next(_instance_counter)
        self.options = options or IndexOptions()
        if self.options.keys:
            raise NotPortedError("a keyed index", SLICE_KEYS)
        self.op_writer_factory = op_writer_factory
        self.epoch = Epoch()
        #: column attrs: a file store on a node with a data dir, carried
        #: through unchanged (the attr queries are not ported yet).
        self.column_attr_store = AttrStore(epoch=self.epoch)
        #: (epoch stamp, frozenset) memo for available_shards().
        self._avail_shards_cache: tuple | None = None
        self.fields: dict[str, Field] = {}
        self._lock = threading.RLock()
        if self.options.track_existence:
            self.fields[EXISTENCE_FIELD_NAME] = Field(
                self.name, EXISTENCE_FIELD_NAME, device,
                FieldOptions(cache_type="none", cache_size=0), epoch=self.epoch,
                op_writer_factory=op_writer_factory)

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
                      op_writer_factory=self.op_writer_factory)
            self.fields[name] = f
            self.epoch.bump()
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
