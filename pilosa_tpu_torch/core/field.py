"""Field — a typed container of views.

The port's counterpart of pilosa_tpu/core/field.py. Reference: field.go
(types :56-62, FieldOptions :1419, deleteView :889, SetBit :927, ClearBit
:967, SetValue :1075, Sum/Min/Max/Range :1121-1201, Import :1204,
importValue :1285, bsiGroup :1561-1643).

Types:
- ``set``   — rows of bits over columns, in the standard view;
- ``int``   — bit-sliced integers in the ``bsig_<field>`` view;
- ``time``  — a set field whose timestamped bits also land in the time
  views of its quantum (``standard_YYYY[MM[DD[HH]]]``);
- ``mutex`` — a set field with at most one row per column;
- ``bool``  — a mutex field over rows 0 (false) and 1 (true).

A keyed field (``keys=True``) translates row keys through its
``translate_store`` (core/translate.py).
"""

from __future__ import annotations

import datetime as dt
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from pilosa_tpu_torch import native
from pilosa_tpu_torch.config import (
    DEFAULT_CACHE_SIZE,
    DENSE_CUTOFF,
    EXISTENCE_FIELD_NAME,
    SHARD_WIDTH,
    WORDS_PER_SHARD,
)
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD, View, is_time_view, view_bsi_name
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.errors import (
    BSIGroupNotFoundError,
    BSIGroupValueTooHighError,
    BSIGroupValueTooLowError,
    InvalidBSIGroupRangeError,
    InvalidCacheTypeError,
    InvalidFieldTypeError,
    validate_name,
)
from pilosa_tpu_torch.pql import ast as pql_ast

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
FIELD_TYPE_TIME = "time"
FIELD_TYPE_MUTEX = "mutex"
FIELD_TYPE_BOOL = "bool"
_KNOWN_TYPES = (FIELD_TYPE_SET, FIELD_TYPE_INT, FIELD_TYPE_TIME,
                FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL)

#: numpy datetime64 unit of each time-quantum letter.
_NP_UNITS = {"Y": "Y", "M": "M", "D": "D", "H": "h"}

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
    """Reference FieldOptions (field.go:1419)."""

    type: str = FIELD_TYPE_SET
    cache_type: str = CACHE_TYPE_RANKED
    cache_size: int = DEFAULT_CACHE_SIZE
    min: int = 0
    max: int = 0
    base: int = 0
    bit_depth: int = 0
    time_quantum: str = ""
    keys: bool = False
    no_standard_view: bool = False

    def to_json(self) -> dict:
        """Type-dependent shape (reference FieldOptions.MarshalJSON)."""
        if self.type == FIELD_TYPE_INT:
            return {"type": self.type, "base": self.base,
                    "bitDepth": self.bit_depth, "min": self.min,
                    "max": self.max, "keys": self.keys}
        if self.type == FIELD_TYPE_TIME:
            return {"type": self.type, "timeQuantum": self.time_quantum,
                    "keys": self.keys, "noStandardView": self.no_standard_view}
        if self.type == FIELD_TYPE_BOOL:
            return {"type": self.type}
        return {"type": self.type, "cacheType": self.cache_type,
                "cacheSize": self.cache_size, "keys": self.keys}

    @classmethod
    def from_json(cls, d: dict) -> "FieldOptions":
        """The JSON options of ``POST /index/{i}/field/{f}``."""
        return cls(
            type=d.get("type", FIELD_TYPE_SET),
            cache_type=d.get("cacheType", CACHE_TYPE_RANKED),
            cache_size=d.get("cacheSize", DEFAULT_CACHE_SIZE),
            min=d.get("min", 0), max=d.get("max", 0),
            base=d.get("base", 0), bit_depth=d.get("bitDepth", 0),
            time_quantum=d.get("timeQuantum", ""),
            keys=d.get("keys", False),
            no_standard_view=d.get("noStandardView", False),
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
    """Typed view container (reference Field field.go:65)."""

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
        #: row key <-> id (a keyed field's rows).
        self.translate_store = TranslateStore(epoch=epoch)
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
        if o.cache_type not in _VALID_CACHE_TYPES:
            raise InvalidCacheTypeError(f"invalid cache type: {o.cache_type!r}")
        if o.type == FIELD_TYPE_INT and o.min > o.max:
            raise InvalidBSIGroupRangeError()
        if o.type == FIELD_TYPE_TIME:
            tq.validate_quantum(o.time_quantum)

    @property
    def field_type(self) -> str:
        return self.options.type

    @property
    def keys(self) -> bool:
        return self.options.keys

    def uses_mutex(self) -> bool:
        return self.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL)

    def time_quantum(self) -> str:
        return self.options.time_quantum

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
                         op_writer_factory=self.op_writer_factory,
                         mutex=self.uses_mutex())
                self.views[name] = v
            return v

    def available_shards(self) -> set[int]:
        out: set[int] = set()
        for v in self.views.values():
            out |= v.available_shards()
        return out

    # -- bit ops -----------------------------------------------------------

    def set_bit(self, row_id: int, column_id: int,
                timestamp: dt.datetime | None = None) -> bool:
        """Fan the bit to the standard view and, with a timestamp, to the
        time views of the quantum (reference SetBit :927)."""
        changed = False
        if not self.options.no_standard_view:
            changed |= self.create_view_if_not_exists(VIEW_STANDARD).set_bit(
                row_id, column_id)
        if timestamp is not None:
            q = self.time_quantum()
            if not q:
                raise ValueError("timestamp set on field without time quantum")
            for name in tq.views_by_time(VIEW_STANDARD, timestamp, q):
                changed |= self.create_view_if_not_exists(name).set_bit(
                    row_id, column_id)
        return changed

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        """Clear from the standard view and every time view (reference
        ClearBit :967-1009 walks every view of the field)."""
        changed = False
        for name, v in list(self.views.items()):
            if name == VIEW_STANDARD or is_time_view(name):
                changed |= v.clear_bit(row_id, column_id)
        return changed

    @staticmethod
    def _view_row(v: View | None, row_id: int) -> Row:
        if v is None:
            return Row()
        return Row({shard: frag.device_row(row_id)
                    for shard, frag in sorted(v.fragments.items())})

    def row(self, row_id: int) -> Row:
        """Cross-shard row of the standard view."""
        return self._view_row(self.view(VIEW_STANDARD), row_id)

    def row_time(self, row_id: int, t_from: dt.datetime | None,
                 t_to: dt.datetime | None) -> Row:
        """Union of the time views covering [from, to) (executor Range/Row
        with from/to, executor.go:1490-1528); an open bound is clamped to
        the time views that exist."""
        q = self.time_quantum()
        if not q:
            raise ValueError(f"field {self.name} has no time quantum")
        if t_from is None or t_to is None:
            lo, hi = self._time_view_bounds()
            if lo is None:
                return Row()
            t_from = t_from or lo
            t_to = t_to or hi
        out = Row()
        for name in tq.views_by_time_range(VIEW_STANDARD, t_from, t_to, q):
            v = self.view(name)
            if v is not None:
                out = out.union(self._view_row(v, row_id))
        return out

    def _time_view_bounds(self) -> tuple[dt.datetime | None, dt.datetime | None]:
        """(earliest start, latest end) covered by the existing time
        views."""
        spans = []
        for name in self.views:
            if not is_time_view(name):
                continue
            stamp = name[len(VIEW_STANDARD) + 1:]
            fmt, step = {
                4: ("%Y", "y"), 6: ("%Y%m", "m"),
                8: ("%Y%m%d", "d"), 10: ("%Y%m%d%H", "h"),
            }.get(len(stamp), (None, None))
            if fmt is None:
                continue
            try:
                t0 = dt.datetime.strptime(stamp, fmt)
            except ValueError:
                continue
            if step == "y":
                t1 = t0.replace(year=t0.year + 1)
            elif step == "m":
                t1 = tq._add_month_norm(t0)
            elif step == "d":
                t1 = t0 + dt.timedelta(days=1)
            else:
                t1 = t0 + dt.timedelta(hours=1)
            spans.append((t0, t1))
        if not spans:
            return None, None
        return min(s for s, _ in spans), max(e for _, e in spans)

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

    def import_bits(self, row_ids, column_ids, timestamps=None,
                    clear: bool = False) -> None:
        """Reference Field.Import (field.go:1204): group bits by view and
        shard, then bulk-import per fragment. ``timestamps`` (datetimes or
        None per bit, or a numpy datetime64 array with NaT for none) send
        each stamped bit to its time views as well; the JAX package pairs
        bits and stamps with ``zip``, so the shorter of the two bounds the
        batch, and here too."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        if len(row_ids) != len(column_ids):
            raise ValueError("row/column length mismatch")
        std = None if self.options.no_standard_view else VIEW_STANDARD
        if timestamps is None:
            self._import_view_bits(std, row_ids, column_ids, clear)
            return
        stamps = as_stamps(timestamps)
        n = min(len(row_ids), len(stamps))
        row_ids, column_ids, stamps = row_ids[:n], column_ids[:n], stamps[:n]
        has = ~np.isnat(stamps)
        q = self.time_quantum()
        if has.any() and not q:
            raise ValueError("timestamps require a time quantum")
        self._import_view_bits(std, row_ids, column_ids, clear)
        sel = np.flatnonzero(has)
        for unit in q:
            keys = stamps[sel].astype(f"datetime64[{_NP_UNITS[unit]}]")
            uniq, inv = np.unique(keys, return_inverse=True)
            order = np.argsort(inv, kind="stable")  # batch order per view
            bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
            for k, key in enumerate(uniq):
                name = tq.view_by_time_unit(
                    VIEW_STANDARD, key.astype("datetime64[s]").astype(dt.datetime),
                    unit)
                part = sel[order[bounds[k]:bounds[k + 1]]]
                self._import_view_bits(name, row_ids[part], column_ids[part],
                                       clear)

    def _import_view_bits(self, view_name: str | None, row_ids: np.ndarray,
                          column_ids: np.ndarray, clear: bool) -> None:
        """One view's bit batch by shard. A large batch of few rows takes
        the native scatter (``_scatter_import``); otherwise, and without
        the native codec, the by-shard split is one stable integer argsort
        and a boundary scan, and each shard slice reaches its fragment
        (row, pos)-sorted -- or, on a mutex or bool field, in batch order
        through ``bulk_import_mutex``, where the last write per column
        wins. Either path writes the JAX package's WAL records for the
        same batch."""
        if view_name is None or len(row_ids) == 0:
            return
        view = self.create_view_if_not_exists(view_name)
        mutex = self.uses_mutex() and not clear
        if (not clear and not mutex and len(row_ids) >= 65536
                and self._scatter_import(view, row_ids, column_ids)):
            return
        cols = column_ids.astype(np.int64, copy=False)
        rows = row_ids.astype(np.int64, copy=False)
        exp = SHARD_WIDTH.bit_length() - 1
        shards = (cols >> exp).astype(np.int32)
        local = (cols & (SHARD_WIDTH - 1)).astype(np.uint32)
        if mutex:  # batch order within a shard: the last write wins
            order = np.argsort(shards, kind="stable")  # radix on int32
        else:  # (shard, row, pos): each shard's slice arrives sorted
            order = np.lexsort((local, rows, shards))
        shards = shards[order]
        rows = rows[order]
        local = local[order]
        cut = np.flatnonzero(shards[1:] != shards[:-1]) + 1
        bounds = np.concatenate(([0], cut, [len(shards)])).tolist()
        touched = shards[bounds[:-1]].tolist()
        try:
            for i, shard in enumerate(touched):
                lo, hi = bounds[i], bounds[i + 1]
                frag = view.create_fragment_if_not_exists(shard, bump_epoch=False)
                if mutex:
                    base = np.uint64(shard * SHARD_WIDTH)
                    frag.bulk_import_mutex(rows[lo:hi],
                                           local[lo:hi].astype(np.uint64) + base)
                else:
                    frag.bulk_import_sorted_local(rows[lo:hi], local[lo:hi],
                                                  clear=clear, bump_epoch=False)
        finally:
            # ONE epoch bump for the batch's shards (their fragments were
            # made and written without one), also when a shard fails.
            if self.epoch is not None:
                self.epoch.bump_shards(touched)

    #: the scatter import applies when the batch has at most this many
    #: distinct rows (each row costs one O(n) mask + one scatter).
    _SCATTER_MAX_ROWS = 8
    #: refuse to allocate more than this much dense block buffer for one
    #: row's scatter, or for one value scatter's planes (the JAX guard).
    _SCATTER_MAX_BYTES = 1 << 30
    #: and take the scatter only for at least this many bits per shard of
    #: the batch's span: each row's buffer is a whole block per shard,
    #: scanned again to land, so a sparse batch (a time field's daily
    #: view: about a hundred bits a shard) costs a block per shard and bit
    #: run. The JAX package scatters any batch of 65536 bits or more; the
    #: rows that land are equal either way, and the WAL groups them per
    #: shard here instead of per row and shard. ``chip_smoke.py
    #: --import-rule`` times both rules on one host.
    _SCATTER_MIN_BITS_PER_SHARD = 1024

    def _scatter_import(self, view: View, row_ids: np.ndarray,
                        column_ids: np.ndarray) -> bool:
        """Sort-free bulk import for batches of few rows (the bulk-load
        shape; the JAX package's ``Field._scatter_import``): one native
        O(n) pass scatters each row's columns into dense per-shard blocks,
        which the fragments adopt or OR in. Returns False, with nothing
        changed, when the shape does not fit (many distinct rows, a huge
        or sparse shard span, no native codec)."""
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
        if (n_shards * WORDS_PER_SHARD * 4 > self._SCATTER_MAX_BYTES
                or len(row_ids) < n_shards * self._SCATTER_MIN_BITS_PER_SHARD):
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
        the bit depth once for the batch, then lands a bulk load of 65,536
        values or more into a fresh view with the native sort-free scatter
        (``_scatter_import_values``, the JAX package's rule), and anything
        else by shard, split with one stable integer argsort, through
        ``Fragment.import_values``."""
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
        if (not clear and len(cols) >= 65536
                and self._scatter_import_values(view, cols, vals, bsig)):
            return
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

    def _scatter_import_values(self, view: View, cols: np.ndarray,
                               vals: np.ndarray, bsig) -> bool:
        """Sort-free BSI bulk import (the JAX package's
        ``Field._scatter_import_values``): one native pass decomposes the
        (column, value) pairs into every shard's plane blocks at once.
        Only for a FRESH view (no values anywhere), where last-write-wins
        needs no plane clears, and under the buffer guard; returns False,
        with nothing changed, otherwise or without the native codec."""
        from pilosa_tpu_torch.core.fragment import BSI_OFFSET_BIT
        if not native.available():
            return False
        if any(frag.rows for frag in view.fragments.values()):
            return False
        exp = SHARD_WIDTH.bit_length() - 1
        n_shards = (int(cols.max()) >> exp) + 1
        depth = bsig.bit_depth
        if n_shards * (depth + 2) * WORDS_PER_SHARD * 4 > self._SCATTER_MAX_BYTES:
            return False
        # Last-write-wins for duplicated columns happens inside the native
        # pass (the exists plane is the seen-set on a fresh view).
        out = native.scatter_bsi_blocks(cols, vals, exp, depth, n_shards,
                                        WORDS_PER_SHARD)
        if out is None:
            return False
        blocks, touched, counts = out
        # Only non-empty planes are adopted: a batch whose values light few
        # planes copies rather than pin the whole buffer. Sparse planes stay
        # dense while any plane of the batch does (that one pins the buffer
        # regardless, so positions would cost a scan and free nothing).
        used = int(np.count_nonzero(counts)) * WORDS_PER_SHARD * 4
        adopt = used * 2 >= blocks.nbytes
        pinned = adopt and int(counts.max()) > DENSE_CUTOFF // 2
        touched_shards: set[int] = set()
        try:
            for shard in np.flatnonzero(touched).tolist():
                frag = view.create_fragment_if_not_exists(int(shard))
                for r in range(depth + 2):
                    n_bits = int(counts[shard][r])
                    if n_bits == 0:
                        continue
                    # Per-shard plane order: exists, sign, magnitude planes
                    # (BSI row ids 0, 1, 2 + i).
                    row_id = r if r < 2 else BSI_OFFSET_BIT + (r - 2)
                    row = blocks[shard][r] if adopt else blocks[shard][r].copy()
                    frag.merge_row_words(row_id, row, bit_count=n_bits,
                                         bump_epoch=False, prefer_dense=pinned)
                    touched_shards.add(int(shard))
        finally:
            # ONE index-epoch bump for the batch, also when a later plane
            # fails after earlier ones merged.
            if touched_shards and self.epoch is not None:
                self.epoch.bump_shards(sorted(touched_shards))
        return True

    def info(self) -> dict:
        return {"name": self.name, "options": self.options.to_json()}


#: the epoch seconds Python's datetime holds (years 1 to 9999).
_EPOCH_MIN, _EPOCH_MAX = -62135596800, 253402300799


def parse_stamps(timestamps) -> np.ndarray:
    """An import's timestamps (reference API.Import: epoch seconds or
    ``TIME_FORMAT`` strings, a falsy one for none) as ``as_stamps`` gives
    them; the JAX API parses them one by one with ``parse_time``, and a
    batch of integers here takes one numpy conversion to the same
    seconds."""
    vals = list(timestamps)
    ints = np.asarray(vals) if vals else np.empty(0, dtype=np.int64)
    if ints.dtype.kind in "iub" and (not len(ints) or (
            int(ints.min()) >= _EPOCH_MIN and int(ints.max()) <= _EPOCH_MAX)):
        ints = ints.astype(np.int64)
        out = ints.astype("datetime64[s]")
        out[ints == 0] = np.datetime64("NaT")
        return out
    return as_stamps([tq.parse_time(t) if t else None for t in vals])


def as_stamps(timestamps) -> np.ndarray:
    """Timestamps as a numpy datetime64[s] array, NaT where a bit has none:
    a datetime64 array as it is, else one datetime (naive, or its wall
    clock, as ``strftime`` reads it) or None per bit."""
    if isinstance(timestamps, np.ndarray) and timestamps.dtype.kind == "M":
        return timestamps.astype("datetime64[s]")
    return np.array([None if t is None else t.replace(tzinfo=None)
                     for t in timestamps], dtype="datetime64[s]")

    def __repr__(self):
        return f"Field({self.index}/{self.name} type={self.options.type})"
