"""Query result types and their wire (JSON) shapes: rows, counts, TopN
pairs and Sum/Min/Max value counts.

The port's counterpart of pilosa_tpu/exec/result.py. Reference:
executor.go (ValCount :2380, Pair pilosa.go) and the JSON encoding in
http/handler.go / row.go MarshalJSON.
"""

from __future__ import annotations

from dataclasses import dataclass
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
    """(row id, count) for TopN (reference Pair)."""

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


def result_to_json(result: Any) -> Any:
    """Serialize any executor result to the reference's response JSON."""
    if isinstance(result, (Row, Pair, ValCount)):
        return result.to_json()
    if isinstance(result, list):
        return [result_to_json(r) for r in result]
    if isinstance(result, bool) or isinstance(result, int) or result is None:
        return result
    raise TypeError(f"unserializable result {type(result)}")
