"""Fragment — one (field, view, shard) bitmap matrix: set rows and BSI values.

The port's counterpart of pilosa_tpu/core/fragment.py. Reference:
fragment.go (struct :100, setBit/clearBit :645/:729, row :602, top :1570,
bulkImport :1997, BSI values :897-1536, importValue :2205).

Design split, as in the JAX package:
- **Host truth**: ``rows[row_id] -> HostRow`` — sparse positions at rest,
  dense past cutoff. Mutations are host ops.
- **Device cache**: dense int32 bit-pattern blocks uploaded lazily per row
  / per row stack to ``self.device``, invalidated by a generation counter.
  Query math (set algebra, popcounts) runs on the device over these blocks.
- **Row-count vector**: per-row popcounts maintained on the host; TopN
  without a filter reads it directly (the reference's rankCache,
  cache.go:136, made exact).

A BSI fragment keeps a bit-sliced integer per column in rows: exists, sign,
then magnitude bits (``BSI_*`` below). Every mutation calls the WAL hook
``op_writer(op, rows, cols)`` with the JAX fragment's records, in its
order, with absolute column ids and numpy arrays (storage/diskstore.py
binds it); roaring import/export goes through the native codec. A mutex
or bool fragment keeps at most one row bit per column: a set clears the
column's other row first (the reference's mutex vector,
fragment.go:3094-3164). Block checksums belong to a later slice of the
port (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Iterable

import numpy as np
import torch

from pilosa_tpu_torch import native
from pilosa_tpu_torch.config import DEFAULT_CACHE_SIZE, SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.core.hostrow import HostRow
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.errors import QueryError
from pilosa_tpu_torch.ops import bitops, kernels
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.pql import Call

# BSI row layout, reference fragment.go:87-93.
BSI_EXISTS_BIT = 0
BSI_SIGN_BIT = 1
BSI_OFFSET_BIT = 2

#: Row-group tiling: streaming count paths materialize at most this many
#: rows on the device at once, so TopN over huge fields runs in O(tile)
#: device memory instead of O(rows) — the reference's analog is
#: per-container iteration (fragment.go:1570-1740).
ROW_TILE = 512
#: Row sets at or below this size use the cached whole-stack fast path
#: (repeat queries hit device-resident blocks with zero re-upload).
STACK_CACHE_MAX_ROWS = 1024
#: With ``reuse=True``, up to this many streamed tiles stay device-resident
#: so repeated sweeps over the same row set skip re-materialization; larger
#: sets fall back to pure streaming.
MAX_RESIDENT_TILES = 8


_instance_counter = itertools.count(1)

class Fragment:
    """One shard of one view of one field."""

    def __init__(self, index: str, field: str, view: str, shard: int,
                 device: torch.device, cache_type: str = "ranked",
                 cache_size: int = DEFAULT_CACHE_SIZE, epoch=None,
                 op_writer: Callable | None = None, mutex: bool = False):
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        #: where device rows and stacks live (carried down from the Holder).
        self.device = device
        self.cache_type = cache_type
        self.cache_size = cache_size
        #: index-level Epoch (core.index): bumped on every mutation so
        #: index-wide caches (planner leaf stacks) validate in O(1).
        self.epoch = epoch
        #: WAL hook: called as op_writer(op, rows, cols) on mutation.
        self.op_writer = op_writer
        #: mutex semantics: at most one row bit per column (reference
        #: mutexVector fragment.go:3094; bool fields use rows 0/1).
        self.mutex = mutex

        #: process-unique identity: a fragment of a deleted and recreated
        #: field or view restarts its generation, so caches validated by
        #: generation also compare this.
        self.instance_id = next(_instance_counter)
        self.rows: dict[int, HostRow] = {}
        self.generation = 0
        #: generation-stamped (gen, ids, counts) — see row_counts().
        self._count_cache: tuple | None = None
        #: generation-stamped (gen, ids, counts) sorted by count desc.
        self._top_cache: tuple | None = None
        #: generation-stamped concatenated sparse-row index.
        self._sparse_cache: tuple | None = None
        #: generation-stamped mutex column vector (gen, positions, rows):
        #: every column holding a bit, ascending, and the row that holds
        #: it -- the JAX fragment's ``_col_row`` map as two sorted arrays.
        #: Every mutation moves the generation, so no bulk path can leave
        #: it stale.
        self._col_vec: tuple | None = None
        self._lock = threading.RLock()
        # device caches: row_id -> (gen, Tensor[W]); key -> (gen, ids, Tensor[n, W])
        self._dev_rows: dict[int, tuple[int, torch.Tensor]] = {}
        self._dev_stacks: dict[object, tuple[int, tuple, torch.Tensor]] = {}

    # -- position encoding -------------------------------------------------

    def _local(self, column_id: int) -> int:
        lo = self.shard * SHARD_WIDTH
        if not (lo <= column_id < lo + SHARD_WIDTH):
            raise ValueError(f"column:{column_id} out of bounds")
        return column_id - lo

    # -- mutation ----------------------------------------------------------

    def _invalidate(self, bump_epoch: bool = True) -> None:
        self.generation += 1
        if bump_epoch and self.epoch is not None:
            # Shard-tagged: cached results of plans over other shards
            # stay valid (Epoch.max_shard_epoch).
            self.epoch.bump(shard=self.shard)
        # Stale device blocks would never be re-hit (generation mismatch)
        # but would pin device memory; drop them eagerly.
        self._dev_rows.clear()
        self._dev_stacks.clear()

    def set_bit(self, row_id: int, column_id: int) -> bool:
        with self._lock:
            pos = self._local(column_id)
            if self.mutex:
                # Unset any other row's bit for this column first
                # (reference handleMutex fragment.go:3094-3164).
                existing = self.row_for_column(column_id)
                if existing is not None and existing != row_id:
                    self.clear_bit(existing, column_id)
            hr = self.rows.get(row_id)
            if hr is None:
                hr = self.rows[row_id] = HostRow()
            changed = hr.add(pos)
            if changed:
                self._invalidate()
                if self.op_writer:
                    self.op_writer("add", [row_id], [column_id])
            return changed

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        with self._lock:
            pos = self._local(column_id)
            hr = self.rows.get(row_id)
            if hr is None:
                return False
            changed = hr.remove(pos)
            if changed:
                self._invalidate()
                if self.op_writer:
                    self.op_writer("remove", [row_id], [column_id])
            return changed

    def clear_row(self, row_id: int) -> bool:
        """Drop one row (reference clearRow, under ClearRow): True when it
        held bits, logged as one ``removeBatch`` of its columns."""
        with self._lock:
            hr = self.rows.pop(row_id, None)
            if hr is None or hr.count() == 0:
                return False
            self._invalidate()
            if self.op_writer:
                cols = hr.to_positions() + np.uint64(self.shard * SHARD_WIDTH)
                self.op_writer("removeBatch",
                               np.full(len(cols), row_id, dtype=np.uint64), cols)
            return True

    def set_row(self, row: Row, row_id: int) -> bool:
        """Replace one row with this shard's segment of ``row`` (zeros
        without one) -- reference setRow, under Store -- logged as one
        ``setRow`` record."""
        seg = row.segment(self.shard)
        words = (bitops.to_host_words(seg).copy() if seg is not None
                 else bitops.np_zero_row())
        self.set_row_words(row_id, words)
        return True

    def bulk_import(self, row_ids: np.ndarray, column_ids: np.ndarray,
                    clear: bool = False) -> int:
        """Batched set/clear of absolute columns in any order (reference
        bulkImport fragment.go:1997): the WAL replay's and the roaring
        import's entry. Sorts by (row, pos) and takes the pre-sorted
        path; the WAL record holds the arrays as given, as the JAX
        fragment's does. Returns the number of changed bits."""
        with self._lock:
            row_ids = np.asarray(row_ids, dtype=np.uint64)
            column_ids = np.asarray(column_ids, dtype=np.uint64)
            if len(row_ids) != len(column_ids):
                raise ValueError("row/column length mismatch")
            if len(row_ids) == 0:
                return 0
            local = column_ids - np.uint64(self.shard * SHARD_WIDTH)
            if (local >= SHARD_WIDTH).any():
                raise ValueError("column out of shard bounds")
            rows = row_ids.astype(np.int64)
            local = local.astype(np.uint32)
            if len(rows) > 1 and not _is_sorted_pairs(rows, local):
                order = np.lexsort((local, rows))
                rows, local = rows[order], local[order]
            changed = self._import_sorted_local(rows, local, clear)
            if changed:
                self._invalidate()
                if self.op_writer:
                    self.op_writer("removeBatch" if clear else "addBatch",
                                   row_ids, column_ids)
            return changed

    def bulk_import_sorted_local(self, row_ids: np.ndarray,
                                 local: np.ndarray, clear: bool = False,
                                 bump_epoch: bool = True) -> int:
        """Bulk set/clear of shard-relative positions PRE-SORTED by
        (row, pos) — the core of the import path (reference
        importPositions fragment.go:2053). Boundary-scans row groups,
        dedupes each group's sorted positions with one diff pass, and
        hands them to HostRow without any further sort. A caller landing
        many fragments passes ``bump_epoch=False`` and bumps the index
        epoch once for their shards."""
        with self._lock:
            if len(row_ids) == 0:
                return 0
            row_ids = np.asarray(row_ids, dtype=np.int64)
            local = np.asarray(local, dtype=np.uint32)
            changed = self._import_sorted_local(row_ids, local, clear)
            if changed:
                self._invalidate(bump_epoch=bump_epoch)
                if self.op_writer:
                    base = np.uint64(self.shard * SHARD_WIDTH)
                    self.op_writer("removeBatch" if clear else "addBatch",
                                   row_ids.astype(np.uint64),
                                   local.astype(np.uint64) + base)
            return changed

    def _import_sorted_local(self, row_ids: np.ndarray, local: np.ndarray,
                             clear: bool) -> int:
        """The row-group walk of the bulk paths, under the caller's lock;
        returns the changed bits and leaves invalidation and the WAL
        record to the caller."""
        n = len(row_ids)
        cut = np.flatnonzero(row_ids[1:] != row_ids[:-1]) + 1
        bounds = np.concatenate(([0], cut, [n]))
        changed = 0
        for i in range(len(bounds) - 1):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            rid = int(row_ids[lo])
            seg = local[lo:hi]
            if hi - lo > 1:  # drop duplicate positions (sorted input)
                keep = np.empty(hi - lo, dtype=bool)
                keep[0] = True
                np.not_equal(seg[1:], seg[:-1], out=keep[1:])
                if not keep.all():
                    seg = seg[keep]
            hr = self.rows.get(rid)
            if hr is None:
                if clear:
                    continue
                hr = self.rows[rid] = HostRow()
            if clear:
                changed += hr.remove_many_sorted_unique(seg)
            else:
                changed += hr.add_many_sorted_unique(seg)
        return changed

    def set_row_words(self, row_id: int, words: np.ndarray) -> None:
        """Replace one row with a dense uint32 word block (the data
        hand-over of pilosa_tpu_torch.interop), logged as one ``setRow``
        record as the JAX fragment's ``set_row`` is, so the row survives
        a restart."""
        words = np.asarray(words, dtype=np.uint32)
        if words.shape != (WORDS_PER_SHARD,):
            raise ValueError(f"row words must have shape ({WORDS_PER_SHARD},), "
                             f"got {words.shape}")
        with self._lock:
            self.rows[row_id] = HostRow.from_words(words)
            self._invalidate()
            if self.op_writer:
                cols = (native.words_to_positions(words)
                        + np.uint64(self.shard * SHARD_WIDTH))
                self.op_writer("setRow", np.asarray([row_id], dtype=np.uint64),
                               cols)

    def merge_row_words(self, row_id: int, words: np.ndarray,
                        bit_count: int | None = None,
                        bump_epoch: bool = True,
                        prefer_dense: bool = False) -> int:
        """Merge a freshly-scattered dense word block into one row: the
        landing half of the native bulk-import scatter (reference
        importRoaringBits' container merge, roaring.go:1511). ``words``
        ownership transfers to the fragment; returns bits added. Bulk
        callers landing many rows pass bump_epoch=False and bump the
        index epoch once at the end, and prefer_dense=True when ``words``
        is a view of a scatter buffer that sibling rows keep pinned
        anyway."""
        with self._lock:
            if bit_count is None:
                bit_count = native.popcount_words(words)
            if bit_count == 0:
                return 0
            hr = self.rows.get(row_id)
            if hr is None or hr.n == 0:
                self.rows[row_id] = HostRow.adopt_words(words, bit_count,
                                                        prefer_dense=prefer_dense)
                changed = bit_count
            else:
                changed = hr.merge_words(words)
            if changed:
                self._invalidate(bump_epoch=bump_epoch)
                if self.op_writer:
                    pos = native.words_to_positions(words)
                    base = np.uint64(self.shard * SHARD_WIDTH)
                    self.op_writer("addBatch",
                                   np.full(len(pos), row_id, dtype=np.uint64),
                                   pos + base)
            return changed

    def bulk_import_mutex(self, row_ids, column_ids) -> int:
        """Mutex-field import: setting (row, col) clears any other row's
        bit in that column, and the last write per column wins (reference
        bulkImportMutex fragment.go:2108). Vectorised over the column
        vector; the clears and sets, and their WAL records, come in the
        JAX fragment's order: the batch's distinct columns in order of
        first appearance, grouped by row in order of first appearance."""
        with self._lock:
            rows = np.asarray(row_ids, dtype=np.uint64).reshape(-1)
            cols = np.asarray(column_ids, dtype=np.uint64).reshape(-1)
            if len(rows) != len(cols):
                raise ValueError("row/column length mismatch")
            if len(rows) == 0:
                return 0
            lo = np.uint64(self.shard * SHARD_WIDTH)
            bad = (cols < lo) | (cols >= lo + np.uint64(SHARD_WIDTH))
            if bad.any():
                raise ValueError(f"column:{int(cols[np.argmax(bad)])} out of bounds")
            local = cols - lo
            n = len(local)
            # Each distinct column's first and last write from one stable
            # sort: the columns in order of first appearance, each with
            # the row its last write names.
            o = np.argsort(local, kind="stable")
            sl = local[o]
            head = np.ones(n, dtype=bool)
            np.not_equal(sl[1:], sl[:-1], out=head[1:])
            starts = np.flatnonzero(head)
            last = o[np.append(starts[1:], n) - 1]
            by_first = np.argsort(o[starts])
            d_pos = sl[starts][by_first]
            d_row = rows[last[by_first]].astype(np.int64)
            v_pos, v_row = self._mutex_vector()
            cur = np.full(len(d_pos), -1, dtype=np.int64)
            if len(v_pos):
                at = np.minimum(np.searchsorted(v_pos, d_pos), len(v_pos) - 1)
                hit = v_pos[at] == d_pos
                cur[hit] = v_row[at[hit]]
            steal = (cur >= 0) & (cur != d_row)
            changed = 0
            for rid, lpos in _groups_in_order(cur[steal], d_pos[steal]):
                changed += self.rows[rid].remove_many(lpos)
                if self.op_writer:
                    self.op_writer("removeBatch",
                                   np.full(len(lpos), rid, dtype=np.uint64),
                                   lpos + lo)
            for rid, lpos in _groups_in_order(d_row, d_pos):
                hr = self.rows.get(rid)
                if hr is None:
                    hr = self.rows[rid] = HostRow()
                added = hr.add_many(lpos)
                changed += added
                if added and self.op_writer:
                    self.op_writer("addBatch",
                                   np.full(len(lpos), rid, dtype=np.uint64),
                                   lpos + lo)
            if changed:
                self._invalidate()
            return changed

    def _mutex_vector(self) -> tuple[np.ndarray, np.ndarray]:
        """(positions, rows): every column holding a bit, ascending, and
        its row; where several rows hold one column (data imported by a
        path that does not enforce the mutex), the highest row id, as the
        JAX fragment's map keeps it. Cached per generation."""
        with self._lock:
            ent = self._col_vec
            if ent is not None and ent[0] == self.generation:
                return ent[1], ent[2]
            pos_parts, row_parts = [], []
            for rid in sorted(self.rows):
                p = self.rows[rid].to_positions()
                if len(p):
                    pos_parts.append(p)
                    row_parts.append(np.full(len(p), rid, dtype=np.int64))
            if pos_parts:
                pos = np.concatenate(pos_parts)
                rws = np.concatenate(row_parts)
                o = np.argsort(pos, kind="stable")
                pos, rws = pos[o], rws[o]
                last = np.ones(len(pos), dtype=bool)
                last[:-1] = pos[1:] != pos[:-1]
                pos, rws = pos[last], rws[last]
            else:
                pos = np.empty(0, dtype=np.uint64)
                rws = np.empty(0, dtype=np.int64)
            self._col_vec = (self.generation, pos, rws)
            return pos, rws

    def row_for_column(self, column_id: int) -> int | None:
        """Which row holds this column's bit, if any (the mutex vector's
        Get, fragment.go:3117): the highest such row id. Reads the column
        vector while it is current, else asks each row, so a run of
        single-bit sets does not rebuild the vector per set."""
        pos = self._local(column_id)
        with self._lock:
            ent = self._col_vec
            if ent is not None and ent[0] == self.generation:
                v_pos, v_row = ent[1], ent[2]
                i = int(np.searchsorted(v_pos, pos))
                if i < len(v_pos) and int(v_pos[i]) == pos:
                    return int(v_row[i])
                return None
            held = [rid for rid, hr in self.rows.items() if hr.contains(pos)]
            return max(held) if held else None

    def import_roaring(self, data: bytes, clear: bool = False) -> int:
        """Merge a serialized roaring bitmap of pos-encoded bits
        (pos = row*ShardWidth + col_local, fragment.go:3090) into this
        fragment (reference importRoaring fragment.go:2255 ->
        ImportRoaringBits roaring.go:1511). Returns the changed-bit count.
        Decoded positions ascend, so the rows and columns reach the bulk
        path already (row, pos)-sorted."""
        positions = native.decode_roaring(data)
        if len(positions) == 0:
            return 0
        rows = positions // np.uint64(SHARD_WIDTH)
        cols = positions % np.uint64(SHARD_WIDTH) + np.uint64(self.shard * SHARD_WIDTH)
        return self.bulk_import(rows, cols, clear=clear)

    def to_roaring(self) -> bytes:
        """Every bit of the fragment in the reference's pos-encoded
        roaring format (the fragment-data transfer format,
        fragment.go:2436): the body of ``import-roaring``."""
        parts = [pos + np.uint64(rid * SHARD_WIDTH)
                 for rid, pos in self.rows_snapshot()]
        positions = (np.concatenate(parts) if parts
                     else np.empty(0, dtype=np.uint64))
        return native.encode_roaring(positions)

    # -- reads -------------------------------------------------------------

    def contains(self, row_id: int, column_id: int) -> bool:
        hr = self.rows.get(row_id)
        return hr is not None and hr.contains(self._local(column_id))

    def row_ids(self) -> list[int]:
        return sorted(self.rows)

    def rows_snapshot(self) -> list[tuple[int, np.ndarray]]:
        """Atomic [(row_id, positions)] snapshot of every row, sorted by
        id: the shard-relative sorted positions, for ``GET /export``."""
        with self._lock:
            return [(rid, self.rows[rid].to_positions())
                    for rid in sorted(self.rows)]

    def rows_list(self, start_row: int = 0, column: int | None = None,
                  limit: int | None = None,
                  among: Iterable[int] | None = None) -> list[int]:
        """Ids of the rows holding bits, ascending from ``start_row``,
        optionally only rows with a bit in ``column`` and/or in the
        ``among`` set, at most ``limit`` (reference rows + rowFilters,
        fragment.go:2618-2724)."""
        allowed = set(among) if among is not None else None
        out = []
        for r in sorted(self.rows):
            if r < start_row or self.rows[r].n == 0:
                continue
            if allowed is not None and r not in allowed:
                continue
            if column is not None and not self.rows[r].contains(self._local(column)):
                continue
            out.append(r)
            if limit is not None and len(out) >= limit:
                break
        return out

    def row_words(self, row_id: int) -> np.ndarray:
        """Host dense uint32 block for one row (zeros if absent). Locked:
        the materialization may flush pending adds (hostrow._flush)."""
        with self._lock:
            hr = self.rows.get(row_id)
            if hr is None:
                return bitops.np_zero_row()
            return hr.to_words()

    def row_cardinality(self, row_id: int) -> int:
        """Set-bit count of one row, O(1) (HostRow keeps it as it changes);
        0 for an absent row (reference pilosa_tpu/core/fragment.py :433).
        Lockless, as ``contains``: the planner reads it per shard to choose
        a stack's representation class, and a count off by a concurrent
        write's few bits changes which class is chosen, never an answer."""
        hr = self.rows.get(row_id)
        return 0 if hr is None else hr.count()

    def row_upload(self, row_id: int):
        """Cheapest faithful host form for a device upload (reference
        pilosa_tpu/core/fragment.py row_upload :443): ``("dense",
        uint32[W])`` or ``("sparse", uint64[positions])``, positions sorted
        and deduped. Sparse rows let the planner ship ~12 B COO words per
        set word instead of the 128 KiB dense block."""
        with self._lock:
            hr = self.rows.get(row_id)
            if hr is None:
                return ("sparse", np.empty(0, dtype=np.uint64))
            if hr.is_dense:
                return ("dense", hr.dense.copy())
            hr._flush()
            if hr.dense is not None:  # flush may densify
                return ("dense", hr.dense.copy())
            return ("sparse", hr.positions.copy())

    def device_row(self, row_id: int) -> torch.Tensor:
        """Device block for one row, cached until next mutation."""
        with self._lock:
            ent = self._dev_rows.get(row_id)
            if ent is not None and ent[0] == self.generation:
                return ent[1]
            arr = bitops.to_device_words(self.row_words(row_id), self.device)
            self._dev_rows[row_id] = (self.generation, arr)
            return arr

    def device_stack(self, row_ids: tuple[int, ...], key: object = None) -> torch.Tensor:
        """[len(row_ids), W] device block stack; cached by key until
        mutation. This is the unit the count kernels consume."""
        key = key if key is not None else row_ids
        with self._lock:
            ent = self._dev_stacks.get(key)
            if ent is not None and ent[0] == self.generation and ent[1] == row_ids:
                return ent[2]
            mat = np.zeros((len(row_ids), WORDS_PER_SHARD), dtype=np.uint32)
            for i, r in enumerate(row_ids):
                mat[i] = self.row_words(r)
            arr = bitops.to_device_words(mat, self.device)
            self._dev_stacks[key] = (self.generation, row_ids, arr)
            return arr

    def row(self, row_id: int) -> Row:
        """Row result for one bitmap row (reference fragment.row :602)."""
        return Row({self.shard: self.device_row(row_id)})

    def intersection_counts(self, row_ids, seg: torch.Tensor,
                            reuse: bool = False) -> np.ndarray:
        """popcount(row & seg) for each row id — the exact-count engine
        behind TopN, GroupBy's per-shard last level and MinRow/MaxRow with
        a filter. Resolves every device part in one transfer; ``reuse``
        as in ``intersection_counts_async``."""
        out, parts = self.intersection_counts_async(row_ids, seg, reuse=reuse)
        resolve_counts([(out, slots, dev) for slots, dev in parts])
        return out

    def intersection_counts_async(self, row_ids, seg: torch.Tensor,
                                  reuse: bool = False,
                                  seg_host: np.ndarray | None = None,
                                  defer: bool = False):
        """Two-tier counts, matching the storage split: returns (counts,
        parts) where ``counts`` already holds the host-tier (sparse)
        results and ``parts`` is [(slot_indices, device_counts), ...] —
        kernels launched but not synced, so a caller sweeping many
        fragments resolves every part in one transfer.

        SPARSE rows (position arrays) are counted on the host by
        vectorized membership against one host copy of the filter — the
        analog of roaring's array-container intersection (roaring.go:3121).
        DENSE rows go to the device through ``pair_count``: small sets ride
        the cached stack, large ones stream fixed [ROW_TILE, W] tiles with
        zero pad rows (which count 0), so device memory is O(tile).

        ``reuse=True`` keeps up to MAX_RESIDENT_TILES streamed tiles
        device-resident (generation-checked). ``seg_host`` is the filter's
        uint32 host copy when the caller already has one. ``defer=True``
        launches nothing: ``parts`` is then [(slot_indices, tile, seg),
        ...], for a caller that counts many fragments' tiles in one
        batched launch.

        The lock spans the whole sweep, so the counts reflect one atomic
        fragment state (the reference's fragment.top holds f.mu for its
        whole walk, fragment.go:1570); the tiles it takes are that state's,
        so their counts launch after it, outside the lock."""
        ids_arr = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        if not len(ids_arr):
            return np.empty(0, dtype=np.int64), []
        out = np.zeros(len(ids_arr), dtype=np.int64)
        tiles: list[tuple[np.ndarray, torch.Tensor]] = []
        with self._lock:
            s_ids, concat, starts, lens, d_ids = self._sparse_index()
            if len(s_ids):
                at = np.searchsorted(s_ids, ids_arr)
                at_c = np.minimum(at, len(s_ids) - 1)
                is_sparse = s_ids[at_c] == ids_arr
            else:
                at_c = np.zeros(len(ids_arr), dtype=np.int64)
                is_sparse = np.zeros(len(ids_arr), dtype=bool)
            # Dense rows by one search of the cached dense ids; an absent or
            # empty row is neither, and its count stays 0.
            if len(d_ids):
                d_at = np.minimum(np.searchsorted(d_ids, ids_arr), len(d_ids) - 1)
                dense_slots = np.flatnonzero((d_ids[d_at] == ids_arr) & ~is_sparse)
            else:
                dense_slots = np.empty(0, dtype=np.int64)
            dense_ids = ids_arr[dense_slots].tolist()

            sparse_slots = np.flatnonzero(is_sparse)
            if len(sparse_slots):
                if seg_host is None:
                    seg_host = bitops.to_host_words(seg)
                sel = at_c[sparse_slots]
                if len(sel) == len(s_ids) and np.array_equal(
                        sel, np.arange(len(s_ids))):
                    pos = concat            # whole-index sweep: no gather
                    offsets = starts
                else:
                    l_sel = lens[sel]
                    s_sel = starts[sel]
                    total = int(l_sel.sum())
                    # Ragged gather without a per-row loop: ones with
                    # jumps at group heads, cumsum = flat indices.
                    step = np.ones(total, dtype=np.int64)
                    head = np.zeros(len(l_sel), dtype=np.int64)
                    np.cumsum(l_sel[:-1], out=head[1:])
                    step[head[0]] = s_sel[0]
                    if len(l_sel) > 1:
                        step[head[1:]] = (s_sel[1:] - s_sel[:-1]
                                          - l_sel[:-1] + 1)
                    pos = concat[np.cumsum(step)]
                    offsets = head
                word = (pos >> np.uint64(5)).astype(np.int64)
                bit = np.left_shift(
                    np.uint32(1), (pos & np.uint64(31)).astype(np.uint32))
                hits = ((seg_host[word] & bit) != 0).astype(np.int64)
                # All lens > 0, so every reduceat offset is < len(hits).
                out[sparse_slots] = np.add.reduceat(hits, offsets)

            if dense_ids:
                if len(dense_ids) <= STACK_CACHE_MAX_ROWS:
                    tiles.append((np.asarray(dense_slots, dtype=np.int64),
                                  self.device_stack(tuple(dense_ids))))
                else:
                    n_tiles = (len(dense_ids) + ROW_TILE - 1) // ROW_TILE
                    cache_tiles = reuse and n_tiles <= MAX_RESIDENT_TILES
                    # Fixed tile shape (zero-padded tail). Tile keys are
                    # positional ("ic_tile", lo), NOT id-set-keyed, so a
                    # fragment never pins more than MAX_RESIDENT_TILES
                    # tiles: a different id set replaces them
                    # (device_stack verifies stored ids).
                    dense_slots_a = np.asarray(dense_slots, dtype=np.int64)
                    for lo in range(0, len(dense_ids), ROW_TILE):
                        chunk = dense_ids[lo:lo + ROW_TILE]
                        if cache_tiles:
                            arr = self.device_stack(tuple(chunk),
                                                    key=("ic_tile", lo))
                        else:
                            # A fresh tile per launch: the kernel runs
                            # asynchronously, so a reused host buffer
                            # could change under a pending copy.
                            mat = np.zeros((ROW_TILE, WORDS_PER_SHARD),
                                           dtype=np.uint32)
                            for i, r in enumerate(chunk):
                                mat[i] = self.row_words(r)
                            arr = bitops.to_device_words(mat, self.device)
                        tiles.append((dense_slots_a[lo:lo + len(chunk)], arr))
        if defer:
            return out, [(slots, arr, seg) for slots, arr in tiles]
        return out, [(slots, kernels.pair_count(arr, seg, "and")) for slots, arr in tiles]

    def _sparse_index(self):
        """(row_ids, concat_positions, starts, lens) over every non-empty
        SPARSE row, and the sorted ids of the DENSE rows, cached per
        generation — one build per mutation, then every TopN sweep is pure
        vectorized numpy. Caller must hold the fragment lock."""
        if self._sparse_cache is not None and \
                self._sparse_cache[0] == self.generation:
            return self._sparse_cache[1:]
        ids: list[int] = []
        dense: list[int] = []
        bufs: list[np.ndarray] = []
        for rid in sorted(self.rows):
            hr = self.rows[rid]
            if hr.is_dense:
                dense.append(rid)
                continue
            if hr.n == 0:
                continue
            hr._flush()
            if hr.is_dense:  # the flush densified it
                dense.append(rid)
                continue
            ids.append(rid)
            bufs.append(hr.positions)  # no copy: generation guards reuse
        ids_a = np.asarray(ids, dtype=np.int64)
        dense_a = np.asarray(dense, dtype=np.int64)
        lens = np.fromiter((len(b) for b in bufs), dtype=np.int64,
                           count=len(bufs))
        concat = (np.concatenate(bufs) if bufs
                  else np.empty(0, dtype=np.uint64))
        starts = np.zeros(len(lens), dtype=np.int64)
        if len(lens) > 1:
            np.cumsum(lens[:-1], out=starts[1:])
        self._sparse_cache = (self.generation, ids_a, concat, starts, lens, dense_a)
        return ids_a, concat, starts, lens, dense_a

    def row_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """(row_ids, counts), cached per generation — the exact
        replacement for the reference's rankCache (cache.go:136)."""
        with self._lock:
            if self._count_cache is not None and \
                    self._count_cache[0] == self.generation:
                return self._count_cache[1], self._count_cache[2]
            ids = np.asarray(sorted(self.rows), dtype=np.uint64)
            counts = np.asarray([self.rows[int(i)].count() for i in ids],
                                dtype=np.int64)
            self._count_cache = (self.generation, ids, counts)
            return ids, counts

    def top_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, counts) sorted by count desc then id asc, cached per
        generation."""
        with self._lock:
            if self._top_cache is not None and \
                    self._top_cache[0] == self.generation:
                return self._top_cache[1], self._top_cache[2]
            ids, counts = self.row_counts()
            order = np.lexsort((ids, -counts))
            ids, counts = ids[order], counts[order]
            self._top_cache = (self.generation, ids, counts)
            return ids, counts

    def _filter_seg(self, filter_row: Row | None) -> torch.Tensor:
        """The filter's block for this shard: all ones without a filter,
        zeros where the filter has no segment here."""
        if filter_row is None:
            return torch.full((WORDS_PER_SHARD,), -1, dtype=torch.int32,
                              device=self.device)
        seg = filter_row.segment(self.shard)
        if seg is None:
            return torch.zeros(WORDS_PER_SHARD, dtype=torch.int32,
                               device=self.device)
        if isinstance(seg, torch.Tensor):
            return seg
        return bitops.to_device_words(seg, self.device)

    # -- MinRow / MaxRow ---------------------------------------------------

    def _filtered_row_counts(self, filter_row: Row | None) -> tuple[list[int], np.ndarray]:
        """(row ids, counts [AND filter]): one batched device count with a
        filter, the host counters without one."""
        ids = self.rows_list()
        if not ids:
            return ids, np.empty(0, dtype=np.int64)
        if filter_row is None:
            return ids, np.asarray([self.rows[r].count() for r in ids],
                                   dtype=np.int64)
        seg = filter_row.segment(self.shard)
        if seg is None:
            return ids, np.zeros(len(ids), dtype=np.int64)
        if not isinstance(seg, torch.Tensor):
            seg = bitops.to_device_words(seg, self.device)
        return ids, self.intersection_counts(ids, seg)

    def min_row(self, filter_row: Row | None = None) -> tuple[int, int]:
        """(smallest row id with a bit [in the filter], its count), or
        (0, 0) (reference minRow fragment.go:1232)."""
        ids, counts = self._filtered_row_counts(filter_row)
        for rid, cnt in zip(ids, counts.tolist()):
            if cnt > 0:
                return rid, int(cnt)
        return 0, 0

    def max_row(self, filter_row: Row | None = None) -> tuple[int, int]:
        """(largest row id with a bit [in the filter], its count), or
        (0, 0) (reference maxRow fragment.go:1253)."""
        ids, counts = self._filtered_row_counts(filter_row)
        for rid, cnt in zip(reversed(ids), reversed(counts.tolist())):
            if cnt > 0:
                return rid, int(cnt)
        return 0, 0

    # -- BSI ---------------------------------------------------------------

    def _bsi_stacks(self, bit_depth: int):
        """(exists [W], sign [W], bits [depth, W]) device blocks."""
        ids = tuple(range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + bit_depth))
        bits = self.device_stack(ids, key=("bsi", bit_depth))
        return self.device_row(BSI_EXISTS_BIT), self.device_row(BSI_SIGN_BIT), bits

    def set_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        """Sign-magnitude BSI write (reference setValueBase fragment.go:939)."""
        with self._lock:
            gen_before = self.generation
            changed = self.set_bit(BSI_EXISTS_BIT, column_id)
            if value < 0:
                changed |= self.set_bit(BSI_SIGN_BIT, column_id)
            else:
                changed |= self.clear_bit(BSI_SIGN_BIT, column_id)
            mag = abs(value)
            for i in range(bit_depth):
                if (mag >> i) & 1:
                    changed |= self.set_bit(BSI_OFFSET_BIT + i, column_id)
                else:
                    changed |= self.clear_bit(BSI_OFFSET_BIT + i, column_id)
            if changed:
                self._observe_values(np.asarray([self._local(column_id)], dtype=np.int64),
                                     np.asarray([value], dtype=np.int64), gen_before)
            return changed

    def _observe_values(self, local: np.ndarray, values: np.ndarray,
                        gen_before: int) -> None:
        """Point-overwrite the sketch planes cached on this fragment with
        values just written (``sketch/store.observe_values``); a fragment
        that never served a Count(Distinct) has none and skips it."""
        if getattr(self, "_hll_planes", None) or getattr(self, "_hll_regs", None):
            from pilosa_tpu_torch.sketch import store as sketch_store
            sketch_store.observe_values(self, local, values, gen_before,
                                        self.generation)

    def value(self, column_id: int, bit_depth: int) -> tuple[int, bool]:
        """(value, exists) — reference fragment.value (fragment.go:897)."""
        with self._lock:
            if not self.contains(BSI_EXISTS_BIT, column_id):
                return 0, False
            mag = 0
            for i in range(bit_depth):
                if self.contains(BSI_OFFSET_BIT + i, column_id):
                    mag |= 1 << i
            return (-mag if self.contains(BSI_SIGN_BIT, column_id) else mag), True

    def import_values(self, column_ids, values, bit_depth: int,
                      clear: bool = False) -> None:
        """Batched BSI write (reference importValue fragment.go:2205),
        vectorized by bit plane: the batch becomes ONE bulk clear + ONE bulk
        set across the exists/sign/magnitude rows, fed through the
        pre-sorted bulk path. Last write per column wins, like sequential
        writes. The two bulk passes log the WAL records of the JAX
        fragment's host path, which the device transpose
        (``_emit_value_wal``) also writes: one ``removeBatch`` of every
        (plane, column) bit off in the new values, then one ``addBatch``
        of every bit on, each only when its pass changed bits. Under
        ``exec/ingest_transpose.py``'s mode the batch's planes come from
        one ``plane_scatter`` on the fragment's device instead
        (``_import_values_device``), with equal rows and WAL bytes."""
        cols = np.asarray(column_ids, dtype=np.int64)
        if len(cols) == 0:
            return
        local_all = (cols & (SHARD_WIDTH - 1)).astype(np.uint32)
        if clear:
            o = np.argsort(local_all, kind="stable")
            self.bulk_import_sorted_local(
                np.full(len(cols), BSI_EXISTS_BIT, dtype=np.int64),
                local_all[o], clear=True)
            # A clear un-exists columns -- not a point overwrite of the
            # sketch planes, so they go wholesale.
            if getattr(self, "_hll_planes", None) or getattr(self, "_hll_regs", None):
                from pilosa_tpu_torch.sketch import store as sketch_store
                sketch_store.invalidate(self)
            return
        vals = np.asarray(values, dtype=np.int64)
        # Keep the LAST occurrence of each duplicated column.
        local_u, idx = np.unique(local_all[::-1], return_index=True)
        vals_u = vals[::-1][idx]
        from pilosa_tpu_torch.exec import ingest_transpose
        if ingest_transpose.use_device(len(local_u) * (bit_depth + 2), self.device):
            with self._lock:
                gen_before = self.generation
                self._import_values_device(local_u, vals_u, bit_depth)
                if self.generation != gen_before:
                    self._observe_values(local_u.astype(np.int64), vals_u, gen_before)
            return
        neg = vals_u < 0
        mag = np.abs(vals_u).astype(np.uint64)
        set_rows, set_cols = [], []
        clr_rows, clr_cols = [], []

        def _add(bucket_r, bucket_c, row_id, mask):
            n = int(mask.sum())
            if n:
                bucket_r.append(np.full(n, row_id, dtype=np.int64))
                bucket_c.append(local_u[mask])

        _add(set_rows, set_cols, BSI_EXISTS_BIT, np.ones(len(local_u), dtype=bool))
        _add(set_rows, set_cols, BSI_SIGN_BIT, neg)
        _add(clr_rows, clr_cols, BSI_SIGN_BIT, ~neg)
        for i in range(bit_depth):
            on = ((mag >> np.uint64(i)) & np.uint64(1)) == 1
            _add(set_rows, set_cols, BSI_OFFSET_BIT + i, on)
            _add(clr_rows, clr_cols, BSI_OFFSET_BIT + i, ~on)
        with self._lock:  # one atomic overwrite, clears before sets
            gen_before = self.generation
            # Plane buckets are row-ascending with sorted positions inside
            # each (local_u is sorted): already (row, pos)-sorted.
            if clr_rows:
                self.bulk_import_sorted_local(np.concatenate(clr_rows),
                                              np.concatenate(clr_cols), clear=True)
            if set_rows:
                self.bulk_import_sorted_local(np.concatenate(set_rows),
                                              np.concatenate(set_cols))
            if self.generation != gen_before:
                self._observe_values(local_u.astype(np.int64), vals_u, gen_before)

    def _import_values_device(self, local_u: np.ndarray, vals_u: np.ndarray,
                              bit_depth: int) -> None:
        """Device half of import_values: one ``plane_scatter`` yields the
        full ``[depth + 2, W]`` plane image of the deduplicated batch,
        merged here with word ops. Bit-identical to the host plane loop:
        row 0 doubles as the written-column mask, so ``(old & ~mask) |
        new`` is exactly clear-then-set per column (exists only ever ORs
        in: columns are never un-existed). Empty rows adopt their plane
        of the image, which the transpose hands over writable, so later
        writes to them go through (the JAX package's adopted rows are
        read-only views of a device array)."""
        from pilosa_tpu_torch.exec import ingest_transpose
        planes = ingest_transpose.transpose_planes(local_u, vals_u, bit_depth,
                                                   self.device)
        notmask = np.invert(planes[0])
        plane_ids = [BSI_EXISTS_BIT, BSI_SIGN_BIT] + list(
            range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + bit_depth))
        with self._lock:
            added = removed = 0
            for j, rid in enumerate(plane_ids):
                set_w = planes[j]
                hr = self.rows.get(rid)
                if hr is None or hr.n == 0:
                    a = int(bitops.np_count(set_w))
                    if a == 0:
                        continue
                    # set_w is a view of the shared plane image: siblings
                    # pin the block anyway, so keep it dense in place.
                    self.rows[rid] = HostRow.adopt_words(set_w, a, prefer_dense=True)
                    added += a
                    continue
                old = hr.to_words()
                if rid == BSI_EXISTS_BIT:
                    new = np.bitwise_or(old, set_w)
                else:
                    new = np.bitwise_or(np.bitwise_and(old, notmask), set_w)
                a = int(bitops.np_count(np.bitwise_and(new, np.invert(old))))
                r = int(bitops.np_count(np.bitwise_and(old, np.invert(new))))
                if a == 0 and r == 0:
                    continue
                self.rows[rid] = HostRow.adopt_words(new, hr.n + a - r,
                                                     prefer_dense=True)
                added += a
                removed += r
            if added or removed:
                self._invalidate()
                if self.op_writer:
                    self._emit_value_wal(local_u, vals_u, bit_depth, removed, added)

    def _emit_value_wal(self, local_u: np.ndarray, vals_u: np.ndarray,
                        bit_depth: int, removed: int, added: int) -> None:
        """The host path's WAL framing for a device value import: one
        removeBatch of every (plane, column) whose bit is off in the new
        values, then one addBatch of every on bit -- the full request
        arrays bulk_import_sorted_local logs, gated the same way (a record
        only when its pass changed bits)."""
        neg = vals_u < 0
        mag = np.abs(vals_u).astype(np.uint64)
        set_rows, set_cols = [], []
        clr_rows, clr_cols = [], []

        def _add(bucket_r, bucket_c, row_id, mask):
            n = int(mask.sum())
            if n:
                bucket_r.append(np.full(n, row_id, dtype=np.uint64))
                bucket_c.append(local_u[mask].astype(np.uint64))

        _add(set_rows, set_cols, BSI_EXISTS_BIT, np.ones(len(local_u), dtype=bool))
        _add(set_rows, set_cols, BSI_SIGN_BIT, neg)
        _add(clr_rows, clr_cols, BSI_SIGN_BIT, ~neg)
        for i in range(bit_depth):
            on = ((mag >> np.uint64(i)) & np.uint64(1)) == 1
            _add(set_rows, set_cols, BSI_OFFSET_BIT + i, on)
            _add(clr_rows, clr_cols, BSI_OFFSET_BIT + i, ~on)
        base = np.uint64(self.shard * SHARD_WIDTH)
        if removed and clr_rows:
            self.op_writer("removeBatch", np.concatenate(clr_rows),
                           np.concatenate(clr_cols) + base)
        if added and set_rows:
            self.op_writer("addBatch", np.concatenate(set_rows),
                           np.concatenate(set_cols) + base)

    def sum(self, filter_row: Row | None, bit_depth: int) -> tuple[int, int]:
        """(sum, count) — reference fragment.sum (fragment.go:1111)."""
        exists, sign, bits = self._bsi_stacks(bit_depth)
        return bsi_ops.host_sum(exists, sign, bits, self._filter_seg(filter_row),
                                bit_depth)

    def min(self, filter_row: Row | None, bit_depth: int) -> tuple[int, int]:
        exists, sign, bits = self._bsi_stacks(bit_depth)
        return bsi_ops.host_min(exists, sign, bits, self._filter_seg(filter_row),
                                bit_depth)

    def max(self, filter_row: Row | None, bit_depth: int) -> tuple[int, int]:
        exists, sign, bits = self._bsi_stacks(bit_depth)
        return bsi_ops.host_max(exists, sign, bits, self._filter_seg(filter_row),
                                bit_depth)

    def range_op(self, op: str, bit_depth: int, predicate: int) -> Row:
        """op in {eq, neq, lt, lte, gt, gte} (reference rangeOp :1274)."""
        exists, sign, bits = self._bsi_stacks(bit_depth)
        if op == "eq":
            seg = bsi_ops.range_eq(exists, sign, bits, predicate, bit_depth)
        elif op == "neq":
            seg = bsi_ops.range_neq(exists, sign, bits, predicate, bit_depth)
        elif op in ("lt", "lte"):
            seg = bsi_ops.range_lt(exists, sign, bits, predicate, bit_depth,
                                   op == "lte")
        elif op in ("gt", "gte"):
            seg = bsi_ops.range_gt(exists, sign, bits, predicate, bit_depth,
                                   op == "gte")
        else:
            raise ValueError(f"invalid range op {op!r}")
        return Row({self.shard: seg})

    def range_between(self, bit_depth: int, pmin: int, pmax: int) -> Row:
        exists, sign, bits = self._bsi_stacks(bit_depth)
        return Row({self.shard: bsi_ops.range_between(exists, sign, bits, pmin,
                                                      pmax, bit_depth)})

    def not_null(self) -> Row:
        return self.row(BSI_EXISTS_BIT)

    # -- TopN --------------------------------------------------------------

    def top(self, n: int = 0, src: Row | None = None,
            row_ids: Iterable[int] | None = None) -> list[tuple[int, int]]:
        """Top rows by count, optionally filtered to rows intersecting src
        or an explicit row-id set. Exact (device intersection counts), not
        cache-approximate like the reference (fragment.go:1570).
        Returns [(row_id, count)] sorted by count desc, id asc."""
        presorted = False
        if row_ids is not None:
            ids = np.asarray(sorted(set(int(r) for r in row_ids)), dtype=np.uint64)
            if len(ids) == 0:
                return []
            if src is not None:
                counts = self.intersection_counts(ids, self._filter_seg(src))
            else:
                counts = np.asarray(
                    [self.rows[int(i)].count() if int(i) in self.rows else 0
                     for i in ids], dtype=np.int64)
        else:
            if src is not None:
                ids = np.asarray(sorted(self.rows), dtype=np.uint64)
                if len(ids) == 0:
                    return []
                counts = self.intersection_counts(ids, self._filter_seg(src))
            else:
                ids, counts = self.top_counts()  # cached sorted order
                if len(ids) == 0:
                    return []
                presorted = True
        if presorted:
            keep = counts > 0
            ids, counts = ids[keep], counts[keep]
            limit = n if n > 0 else len(ids)
            return [(int(r), int(cnt))
                    for r, cnt in zip(ids[:limit].tolist(),
                                      counts[:limit].tolist())]
        order = np.lexsort((ids, -counts))
        pairs = [(int(ids[i]), int(counts[i])) for i in order if counts[i] > 0]
        if n > 0:
            pairs = pairs[:n]
        return pairs

    # -- stats -------------------------------------------------------------

    def bit_count(self) -> int:
        return sum(hr.count() for hr in self.rows.values())

    def __repr__(self):
        return (f"Fragment({self.index}/{self.field}/{self.view}/{self.shard} "
                f"rows={len(self.rows)} bits={self.bit_count()})")


def _groups_in_order(keys: np.ndarray, vals: np.ndarray):
    """(key, vals of that key) for each distinct key in order of first
    appearance, each group's values in their order in ``vals``."""
    if not len(keys):
        return
    uniq, first = np.unique(keys, return_index=True)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    grp = rank[np.searchsorted(uniq, keys)]
    o = np.argsort(grp, kind="stable")
    bounds = np.searchsorted(grp[o], np.arange(len(uniq) + 1))
    for g in range(len(uniq)):
        sel = o[bounds[g]:bounds[g + 1]]
        yield int(keys[sel[0]]), vals[sel]


def _is_sorted_pairs(rows: np.ndarray, local: np.ndarray) -> bool:
    """True when (rows, local) ascend lexicographically."""
    dr = np.diff(rows)
    if (dr < 0).any():
        return False
    same = dr == 0
    return not (same & (local[1:] < local[:-1])).any()


def resolve_counts(parts: list[tuple[np.ndarray, np.ndarray, torch.Tensor]],
                   host: np.ndarray | None = None) -> None:
    """For each (counts, slots, device_counts) of ``parts`` — the device
    halves of any number of intersection_counts_async calls — write
    ``counts[slots] = device_counts[:len(slots)]``, with ONE device->host
    copy for all of them (the count tensors are concatenated on the device
    first). ``host``: that concatenation already on the host (the
    planner brings it through its batcher)."""
    if not parts:
        return
    if host is None:
        host = torch.cat([dev.reshape(-1) for _, _, dev in parts]).cpu().numpy()
    at = 0
    for counts, slots, dev in parts:
        counts[slots] = host[at:at + len(slots)]
        at += dev.numel()


def row_id_arg(c: Call, field_name: str) -> int:
    """The row id of ``Row(field=...)``/``Set``/``Clear``; ``true``/``false``
    is sugar for rows 1/0 (reference executeRowShard, executor.go:1441)."""
    val = c.args.get(field_name)
    if isinstance(val, bool):
        return 1 if val else 0
    row_id, ok = c.uint_arg(field_name)
    if not ok:
        raise QueryError(f"{c.name}() must specify row")
    return row_id
