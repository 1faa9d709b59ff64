"""View — one slice of a field, holding fragments keyed by shard.

The port's counterpart of pilosa_tpu/core/view.py: the ``standard`` view
and ``bsig_<field>`` BSI views (time views come with a later slice,
ROADMAP.md Queue 1). Reference: view.go (names :36-44,
CreateFragmentIfNotExists :263, setBit :367, setValue/sum/min/max/rangeOp
:380-473).
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

from pilosa_tpu_torch.config import DEFAULT_CACHE_SIZE, SHARD_WIDTH
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.row import Row

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"


def view_bsi_name(field: str) -> str:
    return VIEW_BSI_PREFIX + field


class View:
    """Container of per-shard fragments for one layout of one field."""

    def __init__(self, index: str, field: str, name: str, device: torch.device,
                 cache_type: str = "ranked", cache_size: int = DEFAULT_CACHE_SIZE,
                 epoch=None, op_writer_factory: Callable | None = None):
        self.index = index
        self.field = field
        self.name = name
        self.device = device
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.epoch = epoch
        #: factory(index, field, view, shard) -> op_writer for WAL wiring.
        self.op_writer_factory = op_writer_factory
        self.fragments: dict[int, Fragment] = {}
        self._lock = threading.RLock()

    def fragment(self, shard: int) -> Fragment | None:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                op_writer = (self.op_writer_factory(self.index, self.field,
                                                    self.name, shard)
                             if self.op_writer_factory else None)
                frag = Fragment(self.index, self.field, self.name, shard,
                                self.device, cache_type=self.cache_type,
                                cache_size=self.cache_size, epoch=self.epoch,
                                op_writer=op_writer)
                self.fragments[shard] = frag
                # Registration changes the shard set even with zero bits;
                # the index's available_shards() memo keys on the epoch.
                if self.epoch is not None:
                    self.epoch.bump(shard=shard)
            return frag

    def available_shards(self) -> set[int]:
        return set(self.fragments)

    def set_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SHARD_WIDTH)
        return frag.set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.fragment(column_id // SHARD_WIDTH)
        return frag.clear_bit(row_id, column_id) if frag else False

    # -- BSI ---------------------------------------------------------------

    def set_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SHARD_WIDTH)
        return frag.set_value(column_id, bit_depth, value)

    def value(self, column_id: int, bit_depth: int) -> tuple[int, bool]:
        frag = self.fragment(column_id // SHARD_WIDTH)
        if frag is None:
            return 0, False
        return frag.value(column_id, bit_depth)

    def sum(self, filter_row: Row | None, bit_depth: int) -> tuple[int, int]:
        total = cnt = 0
        for frag in self.fragments.values():
            s, c = frag.sum(filter_row, bit_depth)
            total += s
            cnt += c
        return total, cnt

    def min(self, filter_row: Row | None, bit_depth: int) -> tuple[int, int]:
        """Smallest value over the fragments; the counts of fragments that
        tie add up (the executor's fold keeps the first one instead)."""
        best = None
        cnt = 0
        for frag in self.fragments.values():
            v, c = frag.min(filter_row, bit_depth)
            if c == 0:
                continue
            if best is None or v < best:
                best, cnt = v, c
            elif v == best:
                cnt += c
        return (best, cnt) if best is not None else (0, 0)

    def max(self, filter_row: Row | None, bit_depth: int) -> tuple[int, int]:
        best = None
        cnt = 0
        for frag in self.fragments.values():
            v, c = frag.max(filter_row, bit_depth)
            if c == 0:
                continue
            if best is None or v > best:
                best, cnt = v, c
            elif v == best:
                cnt += c
        return (best, cnt) if best is not None else (0, 0)

    def range_op(self, op: str, bit_depth: int, predicate: int) -> Row:
        out = Row()
        for frag in self.fragments.values():
            out = out.union(frag.range_op(op, bit_depth, predicate))
        return out

    def range_between(self, bit_depth: int, pmin: int, pmax: int) -> Row:
        out = Row()
        for frag in self.fragments.values():
            out = out.union(frag.range_between(bit_depth, pmin, pmax))
        return out

    def __repr__(self):
        return f"View({self.index}/{self.field}/{self.name} shards={sorted(self.fragments)})"
