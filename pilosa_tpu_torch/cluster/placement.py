"""Shard → partition → node placement (pure functions).

Reference: cluster.go partition (:871-880: FNV-1a over index name + 8-byte
big-endian shard, mod partitionN) and jmphasher (:948-959: Jump Consistent
Hash, Lamping & Veach 2014). Same math → same placement as the reference
for identical node orderings, which keeps cross-implementation tests and
migration straightforward.

The port's copy of pilosa_tpu/cluster/placement.py.
"""

from __future__ import annotations

from pilosa_tpu_torch.config import DEFAULT_PARTITION_N

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def partition(index: str, shard: int, partition_n: int = DEFAULT_PARTITION_N) -> int:
    """Reference cluster.partition (cluster.go:871)."""
    data = index.encode() + shard.to_bytes(8, "big")
    return fnv1a64(data) % partition_n


def jump_hash(key: int, n: int) -> int:
    """Jump Consistent Hash: key -> bucket in [0, n) (cluster.go:948)."""
    b, j = -1, 0
    key &= _MASK64
    while j < n:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK64
        j = int((b + 1) * ((1 << 31) / ((key >> 33) + 1)))
    return b
