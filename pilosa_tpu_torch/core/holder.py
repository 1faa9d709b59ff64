"""Holder — the root registry of all indexes on a node, and the owner of
the device every index, field, fragment and planner under it uses.

The port's counterpart of pilosa_tpu/core/holder.py. Reference: holder.go
(struct :50, Schema/applySchema :284/:327, fragment accessor :496).
"""

from __future__ import annotations

import threading

import torch

from pilosa_tpu_torch.core.field import Field, FieldOptions
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.index import Index, IndexOptions
from pilosa_tpu_torch.device import resolve_device
from pilosa_tpu_torch.errors import IndexExistsError, IndexNotFoundError


class Holder:
    """Reference Holder (holder.go:50). ``device`` defaults to ``cuda`` and
    raises when there is no card; pass ``device="cpu"`` for the CPU."""

    def __init__(self, device: str | torch.device | None = None,
                 op_writer_factory=None, index_listener=None,
                 fragment_listener=None):
        self.device = resolve_device(device)
        self.indexes: dict[str, Index] = {}
        #: factory(index, field, view, shard) -> the fragment's WAL hook,
        #: set by storage.DiskStore.open() before the schema loads.
        self.op_writer_factory = op_writer_factory
        #: called with each newly created Index (cluster mode wires the
        #: cross-node dirty broadcaster to its epoch here).
        self.index_listener = index_listener
        #: called (index, field, view, shard) for each new fragment (cluster
        #: mode broadcasts create-shard so every node's shard map stays
        #: complete).
        self.fragment_listener = fragment_listener
        #: the store's QuarantineRegistry once a DiskStore opened; the
        #: executor refuses shards it blocks.
        self.quarantine = None
        self._lock = threading.RLock()

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def index_or_raise(self, name: str) -> Index:
        idx = self.indexes.get(name)
        if idx is None:
            raise IndexNotFoundError(f"index not found: {name!r}")
        return idx

    def create_index(self, name: str, options: IndexOptions | None = None) -> Index:
        with self._lock:
            if name in self.indexes:
                raise IndexExistsError()
            idx = Index(name, self.device, options,
                        op_writer_factory=self.op_writer_factory,
                        fragment_listener=self.fragment_listener)
            self.indexes[name] = idx
            if self.index_listener is not None:
                self.index_listener(idx)
            return idx

    def create_index_if_not_exists(self, name: str,
                                   options: IndexOptions | None = None) -> Index:
        with self._lock:
            return self.indexes.get(name) or self.create_index(name, options)

    def delete_index(self, name: str) -> None:
        with self._lock:
            if name not in self.indexes:
                raise IndexNotFoundError()
            del self.indexes[name]

    def field(self, index: str, field: str) -> Field | None:
        idx = self.index(index)
        return idx.field(field) if idx else None

    def fragment(self, index: str, field: str, view: str, shard: int) -> Fragment | None:
        f = self.field(index, field)
        if f is None:
            return None
        v = f.view(view)
        return v.fragment(shard) if v else None

    # -- schema (reference holder.go:284 Schema, :327 applySchema) ---------

    def schema(self) -> list[dict]:
        return [idx.info() for _, idx in sorted(self.indexes.items())]

    def apply_schema(self, schema: list[dict]) -> None:
        """Create any missing indexes/fields described by a schema dump."""
        for idx_info in schema:
            idx = self.create_index_if_not_exists(
                idx_info["name"], IndexOptions.from_json(idx_info.get("options", {})))
            for f_info in idx_info.get("fields", []):
                idx.create_field_if_not_exists(
                    f_info["name"], FieldOptions.from_json(f_info.get("options", {})))

    def index_names(self) -> list[str]:
        return sorted(self.indexes)

    def __repr__(self):
        return f"Holder(device={self.device}, indexes={sorted(self.indexes)})"
