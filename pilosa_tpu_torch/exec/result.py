"""Query result types and their wire (JSON) shapes: rows (with their
attrs), counts, TopN and MinRow/MaxRow pairs, Sum/Min/Max value counts,
GroupBy group counts and ``Rows`` row ids.

The port's counterpart of pilosa_tpu/exec/result.py. Reference:
executor.go (ValCount :2380, Pair pilosa.go, GroupCount :1153-1186,
RowIdentifiers :1026) and the JSON encoding in http/handler.go / row.go
MarshalJSON.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from pilosa_tpu_torch.core.row import Row


@dataclass
class ValCount:
    """(value, count) aggregate result (reference ValCount)."""

    val: int = 0
    count: int = 0

    def add(self, o: "ValCount") -> "ValCount":
        return ValCount(self.val + o.val, self.count + o.count)

    def smaller(self, o: "ValCount") -> "ValCount":
        """Min-merge (reference ValCount.smaller): a zero-count side loses,
        and on a tie the receiver's count stands (counts do not add)."""
        if self.count == 0 or (o.count != 0 and o.val < self.val):
            return o
        return self

    def larger(self, o: "ValCount") -> "ValCount":
        if self.count == 0 or (o.count != 0 and o.val > self.val):
            return o
        return self

    def to_json(self) -> dict:
        return {"value": self.val, "count": self.count}


@dataclass
class Pair:
    """(row id, count) for TopN and MinRow/MaxRow (reference Pair)."""

    id: int = 0
    count: int = 0

    def to_json(self) -> dict:
        return {"id": self.id, "count": self.count}


def merge_pairs(a: list[Pair], b: list[Pair]) -> list[Pair]:
    """Sum counts by id (reference Pairs.Add)."""
    acc: dict[int, int] = {}
    for p in a + b:
        acc[p.id] = acc.get(p.id, 0) + p.count
    return [Pair(id=i, count=c) for i, c in acc.items()]


def sort_pairs(pairs: list[Pair]) -> list[Pair]:
    """Count desc, then id asc (reference Pairs sort order)."""
    return sorted(pairs, key=lambda p: (-p.count, p.id))


@dataclass
class FieldRow:
    """One (field, row) of a GroupBy group (reference FieldRow :1154); row
    keys come with keyed fields (ROADMAP.md Queue 1: keys and sketches)."""

    field: str
    row_id: int = 0

    def to_json(self) -> dict:
        return {"field": self.field, "rowID": self.row_id}


@dataclass
class GroupCount:
    """One GroupBy result row (reference GroupCount :1190)."""

    group: list[FieldRow]
    count: int = 0

    def compare_key(self) -> tuple:
        return tuple(fr.row_id for fr in self.group)

    def to_json(self) -> dict:
        return {"group": [fr.to_json() for fr in self.group], "count": self.count}


def merge_group_counts(a: list[GroupCount], b: list[GroupCount],
                       limit: int) -> list[GroupCount]:
    """Sorted merge summing equal groups (reference mergeGroupCounts
    :1196). Never mutates its inputs: a shard's list may be a cached
    result; equal keys produce a fresh GroupCount."""
    limit = min(limit, len(a) + len(b))
    out: list[GroupCount] = []
    i = j = 0
    while i < len(a) and j < len(b) and len(out) < limit:
        ka, kb = a[i].compare_key(), b[j].compare_key()
        if ka < kb:
            out.append(a[i])
            i += 1
        elif ka == kb:
            out.append(GroupCount(group=a[i].group,
                                  count=a[i].count + b[j].count))
            i += 1
            j += 1
        else:
            out.append(b[j])
            j += 1
    while i < len(a) and len(out) < limit:
        out.append(a[i])
        i += 1
    while j < len(b) and len(out) < limit:
        out.append(b[j])
        j += 1
    return out


@dataclass
class RowIdentifiers:
    """Rows() result (reference RowIdentifiers :1026); row keys come with
    keyed fields (ROADMAP.md Queue 1: keys and sketches)."""

    rows: list[int] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"rows": self.rows}


def merge_row_ids(a: list[int], b: list[int], limit: int) -> list[int]:
    """Sorted unique merge with limit (reference RowIDs.merge :1040)."""
    out: list[int] = []
    i = j = 0
    while i < len(a) and j < len(b) and len(out) < limit:
        if a[i] < b[j]:
            out.append(a[i])
            i += 1
        elif a[i] > b[j]:
            out.append(b[j])
            j += 1
        else:
            out.append(a[i])
            i += 1
            j += 1
    while i < len(a) and len(out) < limit:
        out.append(a[i])
        i += 1
    while j < len(b) and len(out) < limit:
        out.append(b[j])
        j += 1
    return out


def result_to_json(result: Any) -> Any:
    """Serialize any executor result to the reference's response JSON."""
    if isinstance(result, (Row, Pair, ValCount, RowIdentifiers, GroupCount)):
        return result.to_json()
    if isinstance(result, list):
        return [result_to_json(r) for r in result]
    if isinstance(result, bool) or isinstance(result, int) or result is None:
        return result
    if isinstance(result, dict):
        return result
    raise TypeError(f"unserializable result {type(result)}")
