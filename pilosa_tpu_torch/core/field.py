"""Field — a set field: rows of bits over columns, in the standard view.

The port's counterpart of pilosa_tpu/core/field.py, set-field subset.
Reference: field.go (FieldOptions :1419, SetBit :927, ClearBit :967,
Import :1204). Int (BSI), time, mutex and bool fields and keyed fields
raise ``NotPortedError`` naming the slice of ROADMAP.md that ports them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch.config import (
    DEFAULT_CACHE_SIZE,
    EXISTENCE_FIELD_NAME,
    SHARD_WIDTH,
)
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD, View
from pilosa_tpu_torch.errors import (
    SLICE_BSI,
    SLICE_KEYS,
    InvalidCacheTypeError,
    InvalidFieldTypeError,
    NotPortedError,
    validate_name,
)

FIELD_TYPE_SET = "set"
_KNOWN_TYPES = ("set", "int", "time", "mutex", "bool")

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"

_VALID_CACHE_TYPES = {CACHE_TYPE_RANKED, CACHE_TYPE_LRU, CACHE_TYPE_NONE}


@dataclass
class FieldOptions:
    """Reference FieldOptions (field.go:1419), the set-field options."""

    type: str = FIELD_TYPE_SET
    cache_type: str = CACHE_TYPE_RANKED
    cache_size: int = DEFAULT_CACHE_SIZE
    keys: bool = False


class Field:
    """Set field (reference Field field.go:65)."""

    def __init__(self, index: str, name: str, device: torch.device,
                 options: FieldOptions | None = None, epoch=None):
        # The internal existence field is the one reserved name allowed to
        # bypass validation (reference index.go:336).
        if name != EXISTENCE_FIELD_NAME:
            validate_name(name)
        self.index = index
        self.name = name
        self.device = device
        self.options = options or FieldOptions()
        self._validate_options()
        self.epoch = epoch
        self.views: dict[str, View] = {}
        self._lock = threading.RLock()

    def _validate_options(self):
        o = self.options
        if o.type not in _KNOWN_TYPES:
            raise InvalidFieldTypeError(f"invalid field type: {o.type!r}")
        if o.type != FIELD_TYPE_SET:
            raise NotPortedError(f"a {o.type} field", SLICE_BSI)
        if o.cache_type not in _VALID_CACHE_TYPES:
            raise InvalidCacheTypeError(f"invalid cache type: {o.cache_type!r}")
        if o.keys:
            raise NotPortedError("a keyed field", SLICE_KEYS)

    def view(self, name: str) -> View | None:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            v = self.views.get(name)
            if v is None:
                v = View(self.index, self.name, name, self.device,
                         cache_type=self.options.cache_type,
                         cache_size=self.options.cache_size, epoch=self.epoch)
                self.views[name] = v
            return v

    def available_shards(self) -> set[int]:
        out: set[int] = set()
        for v in self.views.values():
            out |= v.available_shards()
        return out

    # -- bit ops -----------------------------------------------------------

    def set_bit(self, row_id: int, column_id: int) -> bool:
        return self.create_view_if_not_exists(VIEW_STANDARD).set_bit(
            row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        v = self.view(VIEW_STANDARD)
        return v.clear_bit(row_id, column_id) if v else False

    def row(self, row_id: int) -> Row:
        """Cross-shard row of the standard view."""
        v = self.view(VIEW_STANDARD)
        if v is None:
            return Row()
        return Row({shard: frag.device_row(row_id)
                    for shard, frag in sorted(v.fragments.items())})

    # -- bulk import -------------------------------------------------------

    def import_bits(self, row_ids, column_ids, clear: bool = False) -> None:
        """Reference Field.Import (field.go:1204): group bits by shard, then
        bulk-import per fragment. The by-shard split is one stable integer
        argsort and a boundary scan, not a per-bit Python loop; each shard
        slice reaches its fragment (row, pos)-sorted."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        if len(row_ids) != len(column_ids):
            raise ValueError("row/column length mismatch")
        if len(row_ids) == 0:
            return
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        cols = column_ids.astype(np.int64, copy=False)
        rows = row_ids.astype(np.int64, copy=False)
        exp = SHARD_WIDTH.bit_length() - 1
        shards = (cols >> exp).astype(np.int32)
        local = (cols & (SHARD_WIDTH - 1)).astype(np.uint32)
        order = np.argsort(shards, kind="stable")  # radix on int32
        shards = shards[order]
        rows = rows[order]
        local = local[order]
        cut = np.flatnonzero(shards[1:] != shards[:-1]) + 1
        bounds = np.concatenate(([0], cut, [len(shards)]))
        for i in range(len(bounds) - 1):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            frag = view.create_fragment_if_not_exists(int(shards[lo]))
            seg_rows, seg_local = rows[lo:hi], local[lo:hi]
            sub = np.lexsort((seg_local, seg_rows))
            frag.bulk_import_sorted_local(seg_rows[sub], seg_local[sub],
                                          clear=clear)

    def __repr__(self):
        return f"Field({self.index}/{self.name} type={self.options.type})"
