"""Row — the cross-shard query result algebra.

The port's counterpart of pilosa_tpu/core/row.py. Reference: row.go (Row
:27, rowSegment :332, Union k-way merge :153, Intersect :107, Difference
:198, Xor :133). A Row maps shard -> one dense block of ``WORDS_PER_SHARD``
words: an int32 bit-pattern tensor on the holder's device (fragment rows,
planner results), or uint32 numpy words (``Row.from_columns``), which move
to the device when they meet a tensor. Chained set algebra stays on the
device; only ``columns()`` and ``count()`` bring anything back to the host.

Ops return new Rows and never write a segment in place, so a segment may
be shared with a fragment's device cache.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.ops import bitops, kernels


def _pair(sa, sb):
    """Bring two segments to one form: tensors on the device of whichever
    is a tensor (numpy words are uploaded), or both numpy."""
    if isinstance(sa, torch.Tensor):
        if not isinstance(sb, torch.Tensor):
            sb = bitops.to_device_words(sb, sa.device)
        return sa, sb
    if isinstance(sb, torch.Tensor):
        return bitops.to_device_words(sa, sb.device), sb
    return np.asarray(sa, dtype=np.uint32), np.asarray(sb, dtype=np.uint32)


class Row:
    """Set of column IDs spanning shards, plus result attrs and, on a keyed
    index, the columns' keys (set by the executor on results)."""

    __slots__ = ("segments", "attrs", "keys")

    def __init__(self, segments: dict[int, object] | None = None, attrs=None, keys=None):
        #: shard -> [W] block (int32 tensor, or uint32 numpy words)
        self.segments: dict[int, object] = dict(segments or {})
        self.attrs = attrs or {}
        self.keys = keys or []

    @classmethod
    def from_columns(cls, columns: Iterable[int]) -> "Row":
        cols = np.asarray(sorted(set(int(c) for c in columns)), dtype=np.uint64)
        shards = (cols // SHARD_WIDTH).astype(np.int64)
        segs = {}
        for shard in np.unique(shards):
            local = cols[shards == shard] % SHARD_WIDTH
            segs[int(shard)] = bitops.positions_to_words(local)
        return cls(segs)

    def segment(self, shard: int):
        return self.segments.get(shard)

    def shards(self) -> list[int]:
        return sorted(self.segments)

    # -- algebra ----------------------------------------------------------

    def intersect(self, other: "Row") -> "Row":
        out = {}
        for shard in set(self.segments) & set(other.segments):
            out[shard] = bitops.b_and(*_pair(self.segments[shard],
                                             other.segments[shard]))
        return Row(out)

    def union(self, *others: "Row") -> "Row":
        """k-way union (reference row.go:153 merges segment lists by shard)."""
        by_shard: dict[int, list] = {}
        for r in (self,) + others:
            for shard, seg in r.segments.items():
                by_shard.setdefault(shard, []).append(seg)
        out = {}
        for shard, segs in by_shard.items():
            acc = segs[0]
            for s in segs[1:]:
                acc = bitops.b_or(*_pair(acc, s))
            out[shard] = acc
        return Row(out)

    def difference(self, *others: "Row") -> "Row":
        out = dict(self.segments)
        for other in others:
            for shard, seg in other.segments.items():
                if shard in out:
                    out[shard] = bitops.b_andnot(*_pair(out[shard], seg))
        return Row(out)

    def xor(self, other: "Row") -> "Row":
        out = {}
        a, b = self.segments, other.segments
        for shard in set(a) | set(b):
            if shard in a and shard in b:
                out[shard] = bitops.b_xor(*_pair(a[shard], b[shard]))
            else:
                out[shard] = a[shard] if shard in a else b[shard]
        return Row(out)

    def shift(self, n: int = 1) -> "Row":
        """Per-shard shift toward higher columns (reference Row.Shift,
        row.go:217, under executeShiftShard): bits do not carry across
        shard boundaries. Device segments go through the ``shift_left``
        kernel, numpy words through its host half; ``n < 0`` raises for a
        Row with segments, as the JAX package's does."""
        out = {}
        for shard, seg in self.segments.items():
            if isinstance(seg, torch.Tensor):
                out[shard] = kernels.shift_left(seg, n)
            else:
                out[shard] = bitops.np_shift_left(seg, n)
        return Row(out)

    # -- reductions --------------------------------------------------------

    def count(self) -> int:
        """Set bits over every shard: device segments go through the
        row_counts kernel, each per-shard int32 widened before the sum."""
        total = 0
        for seg in self.segments.values():
            if isinstance(seg, np.ndarray):
                total += bitops.np_count(seg)
            else:
                total += int(kernels.row_counts(seg))
        return total

    def is_empty(self) -> bool:
        """True when no shard holds a set bit (reference Row.IsEmpty,
        the JAX package's ``Row.is_empty``)."""
        return self.count() == 0

    def columns(self) -> np.ndarray:
        """Materialize sorted absolute column IDs (host sync point)."""
        parts = [bitops.columns_of(self.segments[shard], base=shard * SHARD_WIDTH)
                 for shard in self.shards()]
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Row):
            return NotImplemented
        return np.array_equal(self.columns(), other.columns())

    def __repr__(self) -> str:
        cols = self.columns()
        head = ", ".join(str(c) for c in cols[:8])
        more = "..." if len(cols) > 8 else ""
        return f"Row([{head}{more}] n={len(cols)})"

    def to_json(self) -> dict:
        """Reference Row.MarshalJSON shape (row.go:302): attrs + columns."""
        out = {"attrs": self.attrs, "columns": [int(c) for c in self.columns()]}
        if self.keys:
            out["keys"] = self.keys
        return out
