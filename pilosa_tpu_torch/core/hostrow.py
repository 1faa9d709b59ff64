"""Host-side row storage: sparse positions at rest, dense words when hot.

The port's copy of pilosa_tpu/core/hostrow.py. The dense/sparse
conversions of the reload and scatter-import paths go through the native
codec (``pilosa_tpu_torch.native``), which falls back to numpy.

This replaces roaring's array/bitmap/run container adaptivity
(roaring/container_stash.go:39, conversions roaring.go:2599-2878) with a
two-state scheme chosen for the host/device split: rows live on the
host as sorted uint64 position arrays (cheap mutation, tiny for sparse
rows) and flip to dense uint32 word blocks past DENSE_CUTOFF — the dense
block being exactly the device layout the count kernels consume, so upload
is a straight copy, no re-encode.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch import native
from pilosa_tpu_torch.config import DENSE_CUTOFF, WORDS_PER_SHARD
from pilosa_tpu_torch.ops import bitops


#: Single-bit adds buffer in a Python set and merge into the sorted array
#: in batches, so a tight Set() loop costs O(1) amortized per bit instead
#: of one O(n) np.insert each (the reference bounds its array containers
#: at 4096; ours reach DENSE_CUTOFF, where per-bit memmove would sting).
_PENDING_FLUSH = 256


class HostRow:
    """One bitmap row (2^20 columns) of one fragment, host resident."""

    __slots__ = ("positions", "dense", "n", "_pending")

    def __init__(self):
        self.positions: np.ndarray | None = np.empty(0, dtype=np.uint64)
        self.dense: np.ndarray | None = None
        self.n: int = 0  # set-bit count, maintained incrementally
        self._pending: set[int] = set()  # adds not yet merged into positions

    # -- state ------------------------------------------------------------

    @property
    def is_dense(self) -> bool:
        return self.dense is not None

    def _maybe_densify(self) -> None:
        if self.positions is not None and len(self.positions) > DENSE_CUTOFF:
            self.dense = native.positions_to_words(self.positions, WORDS_PER_SHARD)
            self.positions = None

    def _flush(self) -> None:
        """Merge buffered single-bit adds into the sorted position array.

        Only called with the owning fragment's lock held (all mutators and
        flushing readers take it). Ordering matters for LOCKLESS readers
        (Fragment.contains / rows_list peek at ``positions``/``_pending``
        without the lock): the merged array is published before the
        pending set is cleared, so a concurrent reader sees every bit in
        at least one of the two."""
        if not self._pending:
            return
        fresh = np.fromiter(self._pending, dtype=np.uint64,
                            count=len(self._pending))
        self.positions = np.sort(np.concatenate((self.positions, fresh)))
        self._pending.clear()
        self._maybe_densify()

    # -- mutation ---------------------------------------------------------

    def add(self, pos: int) -> bool:
        """Set one bit; True if changed. pos is shard-relative."""
        if self.dense is not None:
            if bitops.np_set_bit(self.dense, pos):
                self.n += 1
                return True
            return False
        if pos in self._pending:
            return False
        i = np.searchsorted(self.positions, pos)
        if i < len(self.positions) and self.positions[i] == pos:
            return False
        self._pending.add(int(pos))
        self.n += 1
        if len(self._pending) >= _PENDING_FLUSH or self.n > DENSE_CUTOFF:
            self._flush()
        return True

    def remove(self, pos: int) -> bool:
        if self.dense is not None:
            if bitops.np_clear_bit(self.dense, pos):
                self.n -= 1
                return True
            return False
        if pos in self._pending:
            self._pending.discard(int(pos))
            self.n -= 1
            return True
        i = np.searchsorted(self.positions, pos)
        if i < len(self.positions) and self.positions[i] == pos:
            self.positions = np.delete(self.positions, i)
            self.n -= 1
            return True
        return False

    def add_many(self, positions: np.ndarray) -> int:
        """Bulk-or of positions in any order, duplicates allowed; returns
        the number of new bits (reference importPositions,
        fragment.go:2053)."""
        return self.add_many_sorted_unique(
            np.unique(np.asarray(positions, dtype=np.uint64)))

    def remove_many(self, positions: np.ndarray) -> int:
        """Bulk clear of positions in any order; returns the bits
        removed."""
        return self.remove_many_sorted_unique(
            np.unique(np.asarray(positions, dtype=np.uint64)))

    def add_many_sorted_unique(self, positions: np.ndarray) -> int:
        """add_many for input already sorted and deduplicated (the bulk
        import path): skips the O(n log n) re-unique, takes a direct
        assignment when the row is empty, and counts changed bits from
        touched words only instead of re-popcounting the whole block."""
        self._flush()
        n_new = len(positions)
        if n_new == 0:
            return 0
        pos64 = positions.astype(np.uint64)
        if self.dense is None:
            if self.n == 0:
                self.positions = pos64
                self.n = n_new
                self._maybe_densify()
                return n_new
            if n_new + len(self.positions) <= DENSE_CUTOFF:
                merged = np.union1d(self.positions, pos64)
                changed = len(merged) - len(self.positions)
                self.positions = merged
                self.n = len(merged)
                return changed
            self.dense = native.positions_to_words(self.positions, WORDS_PER_SHARD)
            self.positions = None
        word_idx = (pos64 >> np.uint64(5)).astype(np.int64)
        bit = np.left_shift(np.uint32(1),
                            (pos64 & np.uint64(31)).astype(np.uint32))
        touched = np.unique(word_idx)  # sorted input -> cheap
        before = bitops.np_count(self.dense[touched])
        np.bitwise_or.at(self.dense, word_idx, bit)
        after = bitops.np_count(self.dense[touched])
        self.n += after - before
        return after - before

    def remove_many_sorted_unique(self, positions: np.ndarray) -> int:
        """remove_many for sorted-unique input; same savings as the add
        twin."""
        self._flush()
        if len(positions) == 0:
            return 0
        pos64 = positions.astype(np.uint64)
        if self.dense is not None:
            word_idx = (pos64 >> np.uint64(5)).astype(np.int64)
            bit = np.left_shift(np.uint32(1),
                                (pos64 & np.uint64(31)).astype(np.uint32))
            touched = np.unique(word_idx)
            before = bitops.np_count(self.dense[touched])
            np.bitwise_and.at(self.dense, word_idx, ~bit)
            after = bitops.np_count(self.dense[touched])
            self.n += after - before
            return before - after
        kept = np.setdiff1d(self.positions, pos64, assume_unique=True)
        removed = len(self.positions) - len(kept)
        self.positions = kept
        self.n = len(kept)
        return removed

    # -- reads ------------------------------------------------------------

    def contains(self, pos: int) -> bool:
        if self.dense is not None:
            return bitops.np_get_bit(self.dense, pos)
        if pos in self._pending:
            return True
        i = np.searchsorted(self.positions, pos)
        return i < len(self.positions) and self.positions[i] == pos

    def count(self) -> int:
        return self.n

    def to_words(self) -> np.ndarray:
        """Dense uint32[W] block (the device upload format). Copy-safe."""
        if self.dense is not None:
            return self.dense.copy()
        self._flush()
        return native.positions_to_words(self.positions, WORDS_PER_SHARD)

    def to_positions(self) -> np.ndarray:
        if self.dense is not None:
            return native.words_to_positions(self.dense)
        self._flush()
        return self.positions.copy()

    @classmethod
    def from_positions(cls, positions: np.ndarray) -> "HostRow":
        """A row from shard-relative positions in any order, duplicates
        allowed (a snapshot's or a setRow record's); strictly ascending
        input, what the writers produce, skips the sort."""
        r = cls()
        positions = np.asarray(positions, dtype=np.uint64)
        if len(positions) > 1 and not (positions[1:] > positions[:-1]).all():
            positions = np.unique(positions)
        if len(positions) > DENSE_CUTOFF:
            r.dense = native.positions_to_words(positions, WORDS_PER_SHARD)
            r.positions = None
        else:
            r.positions = positions
        r.n = len(positions)
        return r

    def merge_words(self, words: np.ndarray) -> int:
        """OR a dense word block into this row; returns bits added. The
        scatter-import path's merge step (its blocks arrive unsorted and
        whole, so position-level merging would just re-derive this)."""
        self._flush()
        base = self.dense if self.dense is not None \
            else native.positions_to_words(self.positions, WORDS_PER_SHARD)
        merged = np.bitwise_or(base, words)
        n = native.popcount_words(merged)
        # The bulk paths keep moderately-sparse rows dense (half the
        # usual cutoff): below DENSE_CUTOFF the position form saves
        # little memory and the conversion walk dominates import time.
        if n > DENSE_CUTOFF // 2:
            self.dense = merged
            self.positions = None
        else:
            self.positions = native.words_to_positions(merged)
            self.dense = None
        added = n - self.n
        self.n = n
        return added

    @classmethod
    def adopt_words(cls, words: np.ndarray, n: int | None = None,
                    prefer_dense: bool = False) -> "HostRow":
        """Build a row AROUND a freshly-scattered dense block (the caller
        gives up ownership: no copy for dense rows). prefer_dense skips
        the sparse conversion even for near-empty rows, right when
        ``words`` is a view whose backing chunk stays pinned by sibling
        rows regardless."""
        r = cls()
        if n is None:
            n = native.popcount_words(words)
        if prefer_dense or n > DENSE_CUTOFF // 2:  # see merge_words
            r.dense = words
            r.positions = None
        else:
            r.positions = native.words_to_positions(words)
        r.n = n
        return r

    @classmethod
    def from_words(cls, words: np.ndarray) -> "HostRow":
        r = cls()
        n = native.popcount_words(words)
        if n > DENSE_CUTOFF:
            r.dense = np.array(words, dtype=np.uint32)
            r.positions = None
        else:
            r.positions = native.words_to_positions(words)
        r.n = n
        return r
