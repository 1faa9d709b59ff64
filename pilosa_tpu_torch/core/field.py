"""Field — a set field (rows of bits over columns, in the standard view) or
an int field (bit-sliced integers in the ``bsig_<field>`` view).

The port's counterpart of pilosa_tpu/core/field.py, set and int fields.
Reference: field.go (FieldOptions :1419, deleteView :889, SetBit :927,
ClearBit :967, SetValue :1075, Sum/Min/Max/Range :1121-1201, Import :1204,
importValue :1285, bsiGroup :1561-1643). Time, mutex and bool fields and
keyed fields raise ``NotPortedError`` naming the slice of ROADMAP.md that
ports them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from pilosa_tpu_torch import native
from pilosa_tpu_torch.config import (
    DEFAULT_CACHE_SIZE,
    EXISTENCE_FIELD_NAME,
    SHARD_WIDTH,
    WORDS_PER_SHARD,
)
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD, View, view_bsi_name
from pilosa_tpu_torch.errors import (
    SLICE_FIELDS,
    SLICE_KEYS,
    BSIGroupNotFoundError,
    BSIGroupValueTooHighError,
    BSIGroupValueTooLowError,
    InvalidBSIGroupRangeError,
    InvalidCacheTypeError,
    InvalidFieldTypeError,
    NotPortedError,
    validate_name,
)
from pilosa_tpu_torch.pql import ast as pql_ast

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
_KNOWN_TYPES = ("set", "int", "time", "mutex", "bool")

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"

_VALID_CACHE_TYPES = {CACHE_TYPE_RANKED, CACHE_TYPE_LRU, CACHE_TYPE_NONE}


def bit_depth_uint(v: int) -> int:
    """Bits to store unsigned v (reference bitDepth field.go:1663)."""
    for i in range(63):
        if v < (1 << i):
            return i
    return 63


def bit_depth_int(v: int) -> int:
    return bit_depth_uint(-v if v < 0 else v)


def bsi_base(min_: int, max_: int) -> int:
    """Reference bsiBase (field.go:1551)."""
    if min_ > 0:
        return min_
    if max_ < 0:
        return max_
    return 0


@dataclass
class FieldOptions:
    """Reference FieldOptions (field.go:1419), the set- and int-field
    options."""

    type: str = FIELD_TYPE_SET
    cache_type: str = CACHE_TYPE_RANKED
    cache_size: int = DEFAULT_CACHE_SIZE
    min: int = 0
    max: int = 0
    base: int = 0
    bit_depth: int = 0
    keys: bool = False

    def to_json(self) -> dict:
        """Type-dependent shape (reference FieldOptions.MarshalJSON)."""
        if self.type == FIELD_TYPE_INT:
            return {"type": self.type, "base": self.base,
                    "bitDepth": self.bit_depth, "min": self.min,
                    "max": self.max, "keys": self.keys}
        return {"type": self.type, "cacheType": self.cache_type,
                "cacheSize": self.cache_size, "keys": self.keys}

    @classmethod
    def from_json(cls, d: dict) -> "FieldOptions":
        """The JSON options of ``POST /index/{i}/field/{f}``. Time views
        (``timeQuantum``, ``noStandardView``) come with a later slice."""
        if d.get("timeQuantum") or d.get("noStandardView"):
            raise NotPortedError("a field with time views", SLICE_FIELDS)
        return cls(
            type=d.get("type", FIELD_TYPE_SET),
            cache_type=d.get("cacheType", CACHE_TYPE_RANKED),
            cache_size=d.get("cacheSize", DEFAULT_CACHE_SIZE),
            min=d.get("min", 0), max=d.get("max", 0),
            base=d.get("base", 0), bit_depth=d.get("bitDepth", 0),
            keys=d.get("keys", False),
        )


@dataclass
class BSIGroup:
    """Reference bsiGroup (field.go:1561)."""

    name: str
    min: int = 0
    max: int = 0
    base: int = 0
    bit_depth: int = 0

    def bit_depth_min(self) -> int:
        return self.base - (1 << self.bit_depth) + 1

    def bit_depth_max(self) -> int:
        return self.base + (1 << self.bit_depth) - 1

    def base_value(self, op: str, value: int) -> tuple[int, bool]:
        """(base-relative value, out_of_range) — reference baseValue
        (field.go:1583), including the GT/LT clamp quirks."""
        min_, max_ = self.bit_depth_min(), self.bit_depth_max()
        base_value = 0
        if op in (pql_ast.GT, pql_ast.GTE):
            if value > max_:
                return 0, True
            elif value > min_:
                base_value = value - self.base
        elif op in (pql_ast.LT, pql_ast.LTE):
            if value < min_:
                return 0, True
            elif value > max_:
                base_value = max_ - self.base
            else:
                base_value = value - self.base
        elif op in (pql_ast.EQ, pql_ast.NEQ):
            if value < min_ or value > max_:
                return 0, True
            base_value = value - self.base
        return base_value, False

    def base_value_between(self, lo: int, hi: int) -> tuple[int, int, bool]:
        min_, max_ = self.bit_depth_min(), self.bit_depth_max()
        if hi < min_ or lo > max_:
            return 0, 0, True
        lo = max(lo, min_)
        hi = min(hi, max_)
        return lo - self.base, hi - self.base, False


def op_name(op: str) -> str:
    """PQL condition operator -> the fragment's range op name."""
    return {
        pql_ast.EQ: "eq", pql_ast.NEQ: "neq",
        pql_ast.LT: "lt", pql_ast.LTE: "lte",
        pql_ast.GT: "gt", pql_ast.GTE: "gte",
    }[op]


class Field:
    """Set or int field (reference Field field.go:65)."""

    def __init__(self, index: str, name: str, device: torch.device,
                 options: FieldOptions | None = None, epoch=None,
                 op_writer_factory: Callable | None = None,
                 schema_epoch=None):
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
        #: the index's structure epoch: bumped where plans bake this
        #: field's structure (view deletion, bit-depth growth).
        self.schema_epoch = schema_epoch
        self.op_writer_factory = op_writer_factory
        self.views: dict[str, View] = {}
        #: row attrs (SetRowAttrs, attached to Row results, TopN attrName):
        #: a file store on a node with a data dir.
        self.row_attr_store = AttrStore(epoch=epoch)
        self._lock = threading.RLock()

        self.bsi_group: BSIGroup | None = None
        if self.options.type == FIELD_TYPE_INT:
            o = self.options
            o.base = o.base or bsi_base(o.min, o.max)
            o.bit_depth = o.bit_depth or max(bit_depth_int(o.min - o.base),
                                             bit_depth_int(o.max - o.base))
            self.bsi_group = BSIGroup(name=self.name, min=o.min, max=o.max,
                                      base=o.base, bit_depth=o.bit_depth)

    def _validate_options(self):
        o = self.options
        if o.type not in _KNOWN_TYPES:
            raise InvalidFieldTypeError(f"invalid field type: {o.type!r}")
        if o.type not in (FIELD_TYPE_SET, FIELD_TYPE_INT):
            raise NotPortedError(f"a {o.type} field", SLICE_FIELDS)
        if o.cache_type not in _VALID_CACHE_TYPES:
            raise InvalidCacheTypeError(f"invalid cache type: {o.cache_type!r}")
        if o.type == FIELD_TYPE_INT and o.min > o.max:
            raise InvalidBSIGroupRangeError()
        if o.keys:
            raise NotPortedError("a keyed field", SLICE_KEYS)

    @property
    def field_type(self) -> str:
        return self.options.type

    def view(self, name: str) -> View | None:
        return self.views.get(name)

    def view_names(self) -> list[str]:
        return sorted(self.views)

    def delete_view(self, name: str) -> list[int]:
        """Drop one view and its fragments (reference Field.deleteView,
        field.go:889). Returns the shards the view held; a missing view is
        a no-op."""
        with self._lock:
            v = self.views.pop(name, None)
            if v is None:
                return []
            shards = sorted(v.fragments)
        if self.epoch is not None:
            self.epoch.bump()
        if self.schema_epoch is not None:
            self.schema_epoch.bump()
        return shards

    def create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            v = self.views.get(name)
            if v is None:
                v = View(self.index, self.name, name, self.device,
                         cache_type=self.options.cache_type,
                         cache_size=self.options.cache_size, epoch=self.epoch,
                         op_writer_factory=self.op_writer_factory)
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

    # -- BSI value ops -----------------------------------------------------

    def _require_bsi(self) -> BSIGroup:
        if self.bsi_group is None:
            raise BSIGroupNotFoundError()
        return self.bsi_group

    def _grow_bit_depth(self, required: int) -> None:
        """Widen the group to ``required`` magnitude bits. The planner's
        plane cube is keyed on the depth, so a deeper field reads a new
        cube."""
        bsig = self.bsi_group
        if required > bsig.bit_depth:
            bsig.bit_depth = required
            self.options.bit_depth = required
            if self.schema_epoch is not None:  # plans bake the depth
                self.schema_epoch.bump()

    def bsi_view(self) -> View | None:
        return self.view(view_bsi_name(self.name))

    def set_value(self, column_id: int, value: int) -> bool:
        """Reference SetValue (field.go:1075): validate range, grow bit
        depth, store base-relative sign-magnitude."""
        bsig = self._require_bsi()
        if value < bsig.min:
            raise BSIGroupValueTooLowError()
        if value > bsig.max:
            raise BSIGroupValueTooHighError()
        base_value = value - bsig.base
        self._grow_bit_depth(bit_depth_int(base_value))
        v = self.create_view_if_not_exists(view_bsi_name(self.name))
        return v.set_value(column_id, bsig.bit_depth, base_value)

    def value(self, column_id: int) -> tuple[int, bool]:
        bsig = self._require_bsi()
        v = self.bsi_view()
        if v is None:
            return 0, False
        val, exists = v.value(column_id, bsig.bit_depth)
        if not exists:
            return 0, False
        return val + bsig.base, True

    def sum(self, filter_row: Row | None = None) -> tuple[int, int]:
        """(sum, count) — base-adjusted (field.go:1121)."""
        bsig = self._require_bsi()
        v = self.bsi_view()
        if v is None:
            return 0, 0
        s, c = v.sum(filter_row, bsig.bit_depth)
        return s + c * bsig.base, c

    def min(self, filter_row: Row | None = None) -> tuple[int, int]:
        bsig = self._require_bsi()
        v = self.bsi_view()
        if v is None:
            return 0, 0
        m, c = v.min(filter_row, bsig.bit_depth)
        if c == 0:
            return 0, 0
        return m + bsig.base, c

    def max(self, filter_row: Row | None = None) -> tuple[int, int]:
        bsig = self._require_bsi()
        v = self.bsi_view()
        if v is None:
            return 0, 0
        m, c = v.max(filter_row, bsig.bit_depth)
        if c == 0:
            return 0, 0
        return m + bsig.base, c

    def range(self, op: str, predicate: int) -> Row:
        """Comparison query over values (reference Field.Range :1178)."""
        bsig = self._require_bsi()
        if predicate < bsig.min or predicate > bsig.max:
            return Row()  # out of the configured range: the reference's nil row
        v = self.bsi_view()
        if v is None:
            return Row()
        base_value, out_of_range = bsig.base_value(op, predicate)
        if out_of_range:
            return Row()
        return v.range_op(op_name(op), bsig.bit_depth, base_value)

    def range_between(self, pmin: int, pmax: int) -> Row:
        bsig = self._require_bsi()
        v = self.bsi_view()
        if v is None:
            return Row()
        lo, hi, out_of_range = bsig.base_value_between(pmin, pmax)
        if out_of_range:
            return Row()
        return v.range_between(bsig.bit_depth, lo, hi)

    def not_null(self) -> Row:
        """Columns with any value set (reference notNull via rangeOp)."""
        v = self.bsi_view()
        if v is None:
            return Row()
        out = Row()
        for frag in v.fragments.values():
            out = out.union(frag.not_null())
        return out

    # -- bulk import -------------------------------------------------------

    def import_bits(self, row_ids, column_ids, clear: bool = False) -> None:
        """Reference Field.Import (field.go:1204): group bits by shard, then
        bulk-import per fragment. A large batch of few rows takes the
        native scatter (``_scatter_import``); otherwise, and without the
        native codec, the by-shard split is one stable integer argsort and
        a boundary scan, and each shard slice reaches its fragment
        (row, pos)-sorted. Either path writes the JAX package's WAL
        records for the same batch."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        if len(row_ids) != len(column_ids):
            raise ValueError("row/column length mismatch")
        if len(row_ids) == 0:
            return
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        if (not clear and len(row_ids) >= 65536
                and self._scatter_import(view, row_ids, column_ids)):
            return
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

    #: the scatter import applies when the batch has at most this many
    #: distinct rows (each row costs one O(n) mask + one scatter).
    _SCATTER_MAX_ROWS = 8
    #: refuse to allocate more than this much dense block buffer per row.
    _SCATTER_MAX_BYTES = 1 << 30

    def _scatter_import(self, view: View, row_ids: np.ndarray,
                        column_ids: np.ndarray) -> bool:
        """Sort-free bulk import for batches of few rows (the bulk-load
        shape; the JAX package's ``Field._scatter_import``): one native
        O(n) pass scatters each row's columns into dense per-shard blocks,
        which the fragments adopt or OR in. Returns False, with nothing
        changed, when the shape does not fit (many distinct rows, a huge
        shard span, no native codec)."""
        if not native.available():
            return False
        distinct = np.unique(row_ids[:4096])
        if len(distinct) > self._SCATTER_MAX_ROWS:
            return False
        if len(distinct) == 1:
            # Single-row batch: a min/max scan proves coverage without a
            # mask array.
            rid = int(distinct[0])
            if int(row_ids.min()) != rid or int(row_ids.max()) != rid:
                return False
            masks: list = [None]
        else:
            masks = [row_ids == rid for rid in distinct.tolist()]
            if int(sum(m.sum() for m in masks)) != len(row_ids):
                return False  # the sample missed rows
        exp = SHARD_WIDTH.bit_length() - 1
        n_shards = (int(column_ids.max()) >> exp) + 1
        if n_shards * WORDS_PER_SHARD * 4 > self._SCATTER_MAX_BYTES:
            return False
        touched_shards: set[int] = set()
        try:
            for rid, mask in zip(distinct.tolist(), masks):
                blocks, touched, counts = native.scatter_row_blocks(
                    column_ids if mask is None else column_ids[mask],
                    exp, n_shards, WORDS_PER_SHARD)
                shards = np.flatnonzero(touched)
                # Dense batches hand fragments VIEWS into the buffer (the
                # slices are disjoint); sparse ones copy, so a few live
                # rows cannot pin a huge base array.
                adopt = len(shards) * WORDS_PER_SHARD * 4 * 2 >= blocks.nbytes
                for shard in shards.tolist():
                    frag = view.create_fragment_if_not_exists(int(shard))
                    row = blocks[shard] if adopt else blocks[shard].copy()
                    frag.merge_row_words(int(rid), row,
                                         bit_count=int(counts[shard]),
                                         bump_epoch=False)
                    touched_shards.add(int(shard))
        finally:
            # ONE index-epoch bump for the whole batch, also when a later
            # row fails after earlier rows merged; shard-tagged, so cached
            # results over other shards stay valid.
            if touched_shards and self.epoch is not None:
                self.epoch.bump_shards(sorted(touched_shards))
        return True

    def import_roaring(self, shard: int, data: bytes, view: str = VIEW_STANDARD,
                       clear: bool = False) -> int:
        """Reference Field.importRoaring (field.go:1374): a serialized
        roaring bitmap of one shard's pos-encoded bits into one view."""
        v = self.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(shard)
        return frag.import_roaring(data, clear=clear)

    def import_values(self, column_ids, values, clear: bool = False) -> None:
        """Reference importValue (field.go:1285): validates the range, grows
        the bit depth once for the batch, then splits the batch by shard
        with one stable integer argsort. (The JAX package's native
        sort-free value scatter for fresh views writes the same planes; it
        is ROADMAP.md Queue 1 item 4.)"""
        bsig = self._require_bsi()
        values_arr = np.asarray(values, dtype=np.int64)
        if not clear and len(values_arr):
            lo, hi = int(values_arr.min()), int(values_arr.max())
            if lo < bsig.min:
                raise BSIGroupValueTooLowError()
            if hi > bsig.max:
                raise BSIGroupValueTooHighError()
            self._grow_bit_depth(max(bit_depth_int(lo - bsig.base),
                                     bit_depth_int(hi - bsig.base)))
        view = self.create_view_if_not_exists(view_bsi_name(self.name))
        cols = np.asarray(column_ids)
        if len(cols) == 0:
            return
        vals = values_arr if bsig.base == 0 else values_arr - bsig.base
        cols = cols.astype(np.int64, copy=False)
        exp = SHARD_WIDTH.bit_length() - 1
        shards = (cols >> exp).astype(np.int32)
        order = np.argsort(shards, kind="stable")  # radix on int32
        cols, vals, shards = cols[order], vals[order], shards[order]
        cut = np.flatnonzero(shards[1:] != shards[:-1]) + 1
        bounds = np.concatenate(([0], cut, [len(shards)]))
        for i in range(len(bounds) - 1):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            frag = view.create_fragment_if_not_exists(int(shards[lo]))
            frag.import_values(cols[lo:hi], vals[lo:hi], bsig.bit_depth,
                               clear=clear)

    def info(self) -> dict:
        return {"name": self.name, "options": self.options.to_json()}

    def __repr__(self):
        return f"Field({self.index}/{self.name} type={self.options.type})"
