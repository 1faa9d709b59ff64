"""DiskStore — the durability engine bound to a Holder.

The port's counterpart of pilosa_tpu/storage/diskstore.py: the same
layout, snapshot format and WAL records, so a data dir written by either
package opens in the other with equal rows, attr stores and translate
stores (``translate.jsonl``, the framed lines of core/translate.py, read
and written by both). One difference: ``flush()`` snapshots and ``open()``
reloads fragments on a small thread pool (zlib and the numpy sorts
release the interpreter lock).

Reference: holder.go Open (:137, data-dir walk → Index.Open → Field.Open
→ view.open → fragment.Open with mmap + op-log replay), the background
snapshot queue (fragment.go:187-239, holder.go:163: depth-100 queue, 2
workers), snapshot write (fragment.go:2337-2393: temp file + rename),
and per-object meta persistence (.meta / .available.shards / attr and
translate stores).

Layout under ``data_dir``::

    schema.json
    <index>/column_attrs.jsonl
    <index>/translate.jsonl
    <index>/<field>/row_attrs.jsonl
    <index>/<field>/translate.jsonl
    <index>/<field>/<view>/<shard>.snap   # npz: row ids + positions
    <index>/<field>/<view>/<shard>.wal    # binary op log
"""

from __future__ import annotations

import glob
import io
import json
import os
import queue
import shutil
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pilosa_tpu_torch.config import MAX_OP_N, SHARD_WIDTH
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.core.hostrow import HostRow
from pilosa_tpu_torch.obs.logger import StandardLogger
from pilosa_tpu_torch.obs.stats import NopStats
from pilosa_tpu_torch.storage.integrity import (
    SnapshotCorruptError,
    snapshot_footer,
    split_snapshot,
)
from pilosa_tpu_torch.storage.quarantine import (
    BLOCKED_STATES,
    STATE_DEGRADED,
    STATE_UNAVAILABLE,
    QuarantineRegistry,
)
from pilosa_tpu_torch.storage.wal import (
    OP_ADD,
    OP_CLEAR_ROW,
    OP_REMOVE,
    OP_SET_ROW,
    WalReader,
    WalWriter,
    scan_wal,
)

#: threads that snapshot fragments in flush() and reload them in open().
IO_WORKERS = min(8, os.cpu_count() or 1)


def read_snapshot(path: str):
    """Read + verify one snapshot file.

    Returns ``(arrays, meta, status)`` with status one of ``"ok"``
    (framed, CRC verified), ``"legacy"`` (pre-footer file, unverified),
    or ``"bad"`` (corrupt — arrays is None and meta carries the error).
    """
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        return None, {"error": str(e)}, "bad"
    try:
        payload, meta = split_snapshot(data)
    except SnapshotCorruptError as e:
        return None, {"error": str(e)}, "bad"
    try:
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in ("row_ids", "offsets", "positions")}
    except Exception as e:
        return None, {"error": f"unreadable payload: {e}"}, "bad"
    return arrays, meta, ("ok" if meta is not None else "legacy")


class DiskStore:
    """Snapshot + WAL persistence for every fragment of a holder."""

    def __init__(self, data_dir: str, holder: Holder,
                 max_op_n: int = MAX_OP_N, snapshot_workers: int = 2,
                 fsync_appends: bool = False, stats=None, logger=None,
                 quarantine_keep_n: int = 0, wal_group_window: float = 0.0):
        self.data_dir = data_dir
        self.holder = holder
        self.max_op_n = max_op_n
        #: group-commit flush window (seconds) handed to every WalWriter;
        #: only meaningful with fsync_appends (see wal.WalWriter).
        self.wal_group_window = wal_group_window
        #: cap on accumulated ``*.quarantine`` evidence files per
        #: fragment, pruned oldest-first after a successful scrub repair;
        #: 0 keeps everything (the historical behaviour).
        self.quarantine_keep_n = quarantine_keep_n
        #: fsync every WAL record (strict durability; default matches the
        #: reference's buffered op-log writes).
        self.fsync_appends = fsync_appends
        self.stats = stats if stats is not None else NopStats()
        self.logger = logger if logger is not None else StandardLogger()
        self.quarantine = QuarantineRegistry(stats=self.stats,
                                             logger=self.logger)
        os.makedirs(data_dir, exist_ok=True)
        self._writers: dict[tuple, WalWriter] = {}
        #: tombstones: fragments the holderCleaner removed. A snapshot
        #: worker racing the deletion must not resurrect their files;
        #: re-creating the fragment (re-ownership) clears the tombstone
        #: via _op_writer_factory.
        self._deleted: set[tuple] = set()
        self._lock = threading.Lock()
        self._schema_lock = threading.Lock()
        # Background snapshot queue (holder.go:163: depth 100, 2 workers).
        self._snap_q: "queue.Queue[tuple | None]" = queue.Queue(maxsize=100)
        self._snap_pending: set[tuple] = set()
        self._workers = [threading.Thread(target=self._snapshot_worker,
                                          daemon=True)
                         for _ in range(snapshot_workers)]

    # -- paths -------------------------------------------------------------

    def _frag_dir(self, index: str, field: str, view: str) -> str:
        return os.path.join(self.data_dir, index, field, view)

    def _snap_path(self, key: tuple) -> str:
        index, field, view, shard = key
        return os.path.join(self._frag_dir(index, field, view), f"{shard}.snap")

    def _wal_path(self, key: tuple) -> str:
        index, field, view, shard = key
        return os.path.join(self._frag_dir(index, field, view), f"{shard}.wal")

    # -- open / reload (holder.go:137) -------------------------------------

    def open(self) -> None:
        _raise_open_file_limit()
        self.holder.op_writer_factory = self._op_writer_factory
        # Let the executor consult the quarantine without a store import
        # cycle (exec checks getattr(holder, "quarantine", None)).
        self.holder.quarantine = self.quarantine
        # Finish any deletion a crash interrupted: subtrees are detached
        # by rename before their slow recursive unlink.
        for fn in os.listdir(self.data_dir):
            if fn.startswith(".trash-"):
                shutil.rmtree(os.path.join(self.data_dir, fn),
                              ignore_errors=True)
            elif fn.startswith("schema.json.") and fn.endswith(".tmp"):
                # A crash between tmp write and replace strands a
                # uniquely-named tmp; sweep them or they accumulate.
                try:
                    os.remove(os.path.join(self.data_dir, fn))
                except OSError:
                    pass
        schema_path = os.path.join(self.data_dir, "schema.json")
        if os.path.exists(schema_path):
            with open(schema_path) as f:
                self.holder.apply_schema(json.load(f))
        self._attach_stores()
        self._load_fragments()
        for w in self._workers:
            w.start()

    def _attach_stores(self) -> None:
        """Swap in path-backed attr and translate stores (boltdb/ analog).
        Every swapped-in store keeps the index's mutation epoch: attr and
        key-translation writes on a durable node must invalidate
        epoch-stamped caches exactly like they do on a memory node."""
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            idir = os.path.join(self.data_dir, iname)
            idx.column_attr_store = AttrStore(
                os.path.join(idir, "column_attrs.jsonl"), epoch=idx.epoch)
            idx.translate_store = TranslateStore(
                os.path.join(idir, "translate.jsonl"), epoch=idx.epoch)
            for fname, f in idx.fields.items():
                fdir = os.path.join(idir, fname)
                f.row_attr_store = AttrStore(
                    os.path.join(fdir, "row_attrs.jsonl"), epoch=idx.epoch)
                f.translate_store = TranslateStore(
                    os.path.join(fdir, "translate.jsonl"), epoch=idx.epoch)

    def _load_fragments(self) -> None:
        """Walk the data dir; rebuild fragments from snapshot + WAL. The
        walk creates every fragment in order; the reloads then run on
        IO_WORKERS threads, one fragment each."""
        todo = []
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            idir = os.path.join(self.data_dir, iname)
            if not os.path.isdir(idir):
                continue
            for fname, f in list(idx.fields.items()):
                fdir = os.path.join(idir, fname)
                if not os.path.isdir(fdir):
                    continue
                for view_name in sorted(os.listdir(fdir)):
                    vdir = os.path.join(fdir, view_name)
                    if not os.path.isdir(vdir):
                        continue
                    shards = set()
                    for fn in os.listdir(vdir):
                        if fn.endswith((".snap", ".wal")):
                            shards.add(int(fn.rsplit(".", 1)[0]))
                    if not shards:
                        # An EMPTY view dir is deletion debris (a racing
                        # snapshot's makedirs after delete_subtree_files'
                        # rmtree); recreating the view from it would
                        # resurrect a deleted view in the schema.
                        continue
                    view = f.create_view_if_not_exists(view_name)
                    for shard in sorted(shards):
                        frag = view.create_fragment_if_not_exists(shard)
                        todo.append((frag, (iname, fname, view_name, shard)))
        with ThreadPoolExecutor(max_workers=IO_WORKERS) as pool:
            for fut in [pool.submit(self._load_fragment, frag, key)
                        for frag, key in todo]:
                fut.result()

    def _load_fragment(self, frag, key: tuple) -> None:
        saved_writer = frag.op_writer
        frag.op_writer = None  # don't re-log replayed ops
        snap_corrupt = False
        wal_corrupt = False
        replayed = 0
        try:
            snap = self._snap_path(key)
            if os.path.exists(snap):
                arrays, meta, status = read_snapshot(snap)
                if status == "bad":
                    snap_corrupt = True
                    self.stats.count("integrity.snapshotCorrupt")
                    self.quarantine.quarantine_file(
                        key, snap, reason=f"snapshot: {meta['error']}")
                else:
                    if status == "legacy":
                        self.stats.count("integrity.snapshotUnverified")
                    row_ids = arrays["row_ids"]
                    offsets = arrays["offsets"]
                    positions = arrays["positions"]
                    for i, rid in enumerate(row_ids.tolist()):
                        lo, hi = int(offsets[i]), int(offsets[i + 1])
                        frag.rows[rid] = HostRow.from_positions(
                            positions[lo:hi])
                    frag._invalidate()
            wal_path = self._wal_path(key)
            wal_info = scan_wal(wal_path)
            wal_corrupt = wal_info["corrupt"]
            # WAL columns are absolute; snapshot positions and setRow rows
            # are shard-relative, so setRow replay subtracts the base.
            base = frag.shard * SHARD_WIDTH
            # Replay the valid prefix BEFORE any quarantine rename below
            # — the prefix ops live only in this file.
            for code, rows, cols in WalReader(wal_path):
                replayed += 1
                if code == OP_ADD:
                    frag.bulk_import(rows, cols)
                elif code == OP_REMOVE:
                    frag.bulk_import(rows, cols, clear=True)
                elif code == OP_SET_ROW:
                    rid = int(rows[0]) if len(rows) else 0
                    frag.rows[rid] = HostRow.from_positions(
                        (cols - np.uint64(base)))
                    frag._invalidate()
                elif code == OP_CLEAR_ROW:
                    rid = int(rows[0]) if len(rows) else 0
                    frag.rows.pop(rid, None)
                    frag._invalidate()
            if wal_corrupt:
                # Mid-file damage: every op past the damage point is
                # silently gone, so the replayed state is NOT the full
                # acknowledged history — unlike a torn tail, which is
                # the normal crash shape and stays un-quarantined.
                self.stats.count("integrity.walCorrupt")
                self.quarantine.quarantine_file(
                    key, wal_path,
                    reason="wal: corrupt record mid-file "
                           f"({wal_info['ops']} ops salvaged)",
                    state=STATE_DEGRADED)
        finally:
            frag.op_writer = saved_writer
        if snap_corrupt or wal_corrupt:
            # Final serving state: any salvaged data (snapshot or WAL
            # prefix) leaves the fragment degraded-but-servable on a
            # standalone node; no data at all makes the shard
            # unavailable until a replica or repair steps in.
            has_data = replayed > 0 or (wal_corrupt and not snap_corrupt)
            self.quarantine.set_state(
                key, STATE_DEGRADED if has_data else STATE_UNAVAILABLE)
            if snap_corrupt and replayed > 0:
                self.stats.count("integrity.walReplayFallback")
            # The surviving state exists only in memory now (the bad
            # files were renamed aside): persist it as soon as the
            # snapshot workers start.
            self._enqueue_snapshot(key)

    # -- WAL wiring --------------------------------------------------------

    def _op_writer_factory(self, index: str, field: str, view: str,
                           shard: int):
        key = (index, field, view, shard)
        with self._lock:
            self._deleted.discard(key)  # fragment (re)created: live again

        def op_writer(op: str, rows, cols):
            w = self._writer(key)
            if w is None:
                return  # fragment GC'd; orphan writes must not recreate
                # the WAL file (stale bits would replay on restart)
            if op == "setRow":
                w.append("setRow", rows[:1], cols)
            else:
                w.append(op, rows, cols)
            if w.op_n > self.max_op_n:
                self._enqueue_snapshot(key)
        return op_writer

    def _writer(self, key: tuple) -> WalWriter | None:
        with self._lock:
            if key in self._deleted:
                return None
            w = self._writers.get(key)
            if w is None:
                w = self._writers[key] = WalWriter(
                    self._wal_path(key), fsync_appends=self.fsync_appends,
                    group_window=self.wal_group_window)
            return w

    def wal_fsyncs(self) -> int:
        """Total fsync() calls across every live WAL writer (the
        group-commit amortization gauge)."""
        with self._lock:
            return sum(w.fsyncs for w in self._writers.values())

    def delete_fragment_files(self, key: tuple) -> None:
        """Remove a fragment's snapshot + WAL (holderCleaner's disk
        half, holder.go:1170): tombstone the key, close its writer,
        unlink both files — all under the store lock so a racing
        snapshot worker can neither resurrect the files nor re-register
        a writer (its publish step re-checks the tombstone under the
        same lock)."""
        with self._lock:
            self._deleted.add(key)
            w = self._writers.pop(key, None)
            self._snap_pending.discard(key)
            if w is not None:
                w.close()
            for path in (self._snap_path(key), self._wal_path(key)):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
            index, field, view, _ = key
            try:
                _fsync_dir(self._frag_dir(index, field, view))
            except OSError:
                pass

    def delete_subtree_files(self, index: str, field: str | None = None,
                             view: str | None = None) -> None:
        """Disk half of index/field/view deletion: tombstone and unlink
        every fragment under the prefix, then remove its directory.
        Without this, deleting a field and recreating the name would
        RESURRECT the deleted data on the next restart (the reloader is
        schema-driven and would find the stale .snap/.wal files).
        Reference: Index.DeleteField/deleteView remove the path trees
        (field.go:905, index.go:471)."""
        prefix = tuple(p for p in (index, field, view) if p is not None)
        plen = len(prefix)
        subdir = os.path.join(self.data_dir, *prefix)
        # Enumerate on-disk keys OUTSIDE the lock (the walk can be
        # slow); only the tombstone/writer bookkeeping needs mutual
        # exclusion. The holder entries are already gone, so no new
        # writers appear for the prefix while we walk — and any
        # straggler is caught by the snapshot identity check.
        disk_keys: set[tuple] = set()
        if os.path.isdir(subdir):
            for root, _dirs, files in os.walk(subdir):
                rel = os.path.relpath(root, self.data_dir)
                parts = tuple(rel.split(os.sep))
                if len(parts) != 3:  # index/field/view level only
                    continue
                for fn in files:
                    if fn.endswith((".snap", ".wal")):
                        disk_keys.add(parts + (int(fn.rsplit(".", 1)[0]),))
        trash = None
        with self._lock:
            keys = {k for k in self._writers if k[:plen] == prefix}
            keys |= {k for k in self._snap_pending if k[:plen] == prefix}
            keys |= disk_keys
            for key in keys:
                self._deleted.add(key)
                self._snap_pending.discard(key)
                w = self._writers.pop(key, None)
                if w is not None:
                    w.close()
            # Atomically detach the subtree INSIDE the lock (a rename is
            # O(1)); the slow recursive unlink happens outside it. A
            # same-name recreation racing the deletion then lands in a
            # FRESH directory instead of the doomed one — an rmtree of
            # the live path could silently destroy the recreated
            # field's brand-new WAL/snapshot files.
            if os.path.isdir(subdir):
                trash = os.path.join(
                    self.data_dir, f".trash-{uuid.uuid4().hex}")
                try:
                    os.rename(subdir, trash)
                except OSError:
                    trash = None  # fall back to in-place rmtree below
        if trash is not None:
            shutil.rmtree(trash, ignore_errors=True)
        else:
            shutil.rmtree(subdir, ignore_errors=True)
        self.save_schema()

    # -- snapshots (fragment.go:187-239, :2337-2393) -----------------------

    def _enqueue_snapshot(self, key: tuple) -> None:
        with self._lock:
            if key in self._snap_pending:
                return
            self._snap_pending.add(key)
        try:
            self._snap_q.put_nowait(key)
        except queue.Full:
            with self._lock:
                self._snap_pending.discard(key)

    def _snapshot_worker(self) -> None:
        while True:
            key = self._snap_q.get()
            if key is None:
                return
            try:
                self.snapshot_fragment(key)
            except Exception:
                # A failed snapshot (ENOSPC, I/O error) must not kill
                # the worker: the WAL still holds every op, the next
                # trigger retries, and close() relies on live workers
                # to drain the queue.
                pass
            finally:
                with self._lock:
                    self._snap_pending.discard(key)

    def snapshot_fragment(self, key: tuple) -> None:
        """Write <shard>.snap.tmp, fsync-rename, truncate the WAL."""
        index, field, view, shard = key
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            return  # deleted (cleaner / delete-field): nothing to write
        e = self.quarantine.get(key)
        if e is not None and e["state"] in BLOCKED_STATES:
            # A blocked fragment's memory is NOT the truth (empty or
            # partial); snapshotting it would launder the corruption
            # into a "clean" file a restart then trusts. The scrubber
            # flips the state to degraded after repairing, then
            # snapshots and releases.
            return
        with frag._lock:
            snap_rows = frag.rows_snapshot()
            row_ids = np.asarray([r for r, _ in snap_rows], dtype=np.uint64)
            parts = [p for _, p in snap_rows]
            offsets = np.zeros(len(parts) + 1, dtype=np.int64)
            for i, p in enumerate(parts):
                offsets[i + 1] = offsets[i] + len(p)
            positions = (np.concatenate(parts) if parts
                         else np.empty(0, np.uint64))
            path = self._snap_path(key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            buf = io.BytesIO()
            np.savez_compressed(buf, row_ids=row_ids, offsets=offsets,
                                positions=positions)
            payload = buf.getvalue()
            with open(tmp, "wb") as fh:
                fh.write(payload)
                fh.write(snapshot_footer(payload, rows=len(row_ids),
                                         bits=len(positions)))
                fh.flush()
                os.fsync(fh.fileno())
            # Publish under the store lock, mutually exclusive with the
            # deleters' tombstone-and-unlink. Abort on fragment
            # IDENTITY, not just the tombstone: if the holder's current
            # fragment is no longer the object we snapshotted, a
            # deletion (and possibly a same-name recreation) happened
            # mid-write and publishing would resurrect dead data. If it
            # IS still the live object, any tombstone left from a prior
            # same-key generation is stale — the recreated fragment is
            # legitimately persisting — so clear it.
            with self._lock:
                if self.holder.fragment(index, field, view, shard) is not frag:
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
                    return
                self._deleted.discard(key)
                os.replace(tmp, path)
            # The slow directory fsync runs OUTSIDE the store lock — it
            # would otherwise stall every concurrent WAL append (all go
            # through _writer() on the same lock) for a disk flush. The
            # outer FRAGMENT lock is still held, so no append to THIS
            # fragment can land before the truncate below.
            _fsync_dir(os.path.dirname(path))
            with self._lock:
                if self.holder.fragment(index, field, view, shard) is not frag:
                    # Deleted between publish and fsync: the subtree
                    # rename already carried our file away; nothing to
                    # truncate (the writer was closed by the deleter).
                    return
                # Snapshot is durable; only now may the WAL be
                # discarded. The outer fragment lock keeps the WAL
                # truncation atomic with the snapshot (no append may
                # land between them).
                w = self._writers.get(key)
                if w is None:
                    w = self._writers[key] = WalWriter(
                        self._wal_path(key),
                        fsync_appends=self.fsync_appends)
                # Truncate INSIDE the store lock: a racing
                # delete_fragment_files would otherwise close this
                # writer between fetch and truncate.
                w.truncate()

    def snapshot_all(self) -> None:
        """Snapshot every fragment, IO_WORKERS at a time."""
        with ThreadPoolExecutor(max_workers=IO_WORKERS) as pool:
            for fut in [pool.submit(self.snapshot_fragment, key)
                        for key in list(self._all_keys())]:
                fut.result()

    def verify_snapshot(self, key: tuple) -> str:
        """Re-verify one on-disk snapshot without loading it into the
        holder (scrubber's disk walk). Returns "ok" / "legacy" / "bad"
        / "missing"."""
        path = self._snap_path(key)
        if not os.path.exists(path):
            return "missing"
        _arrays, _meta, status = read_snapshot(path)
        return status

    def _all_keys(self):
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            for fname, f in idx.fields.items():
                for vname, v in f.views.items():
                    for shard in v.fragments:
                        yield (iname, fname, vname, shard)

    def all_fragment_keys(self) -> list[tuple]:
        """Every (index, field, view, shard) this node holds — the
        public enumeration the backup coordinator walks."""
        return sorted(self._all_keys())

    def prune_quarantine_evidence(self, key: tuple) -> int:
        """Enforce ``quarantine_keep_n`` on one fragment's accumulated
        ``*.quarantine`` evidence files, oldest (by mtime) first. Called
        after a successful scrub repair — while an entry is still open
        the evidence is live forensics and is never touched. Returns the
        number of files removed; 0 when unlimited (keep_n == 0)."""
        if self.quarantine_keep_n <= 0:
            return 0
        files = []
        for base in (self._snap_path(key), self._wal_path(key)):
            files.extend(glob.glob(glob.escape(base) + ".quarantine*"))
        excess = len(files) - self.quarantine_keep_n
        if excess <= 0:
            return 0
        files.sort(key=lambda p: (os.path.getmtime(p), p))
        pruned = 0
        for path in files[:excess]:
            try:
                os.remove(path)
                pruned += 1
            except OSError:
                continue
        if pruned:
            self.stats.count("integrity.evidencePruned", pruned)
            self.logger.printf(
                "integrity: pruned %d quarantine evidence file(s) for "
                "%s (keep-n=%d)", pruned,
                "/".join(str(p) for p in key), self.quarantine_keep_n)
        return pruned

    # -- flush / close -----------------------------------------------------

    def save_schema(self) -> None:
        path = os.path.join(self.data_dir, "schema.json")
        # Serialize snapshot+replace: two concurrent savers could
        # otherwise interleave so the one holding the OLDER holder
        # snapshot wins the replace, resurrecting a just-deleted field
        # in schema.json. The unique tmp name guards a crashed saver's
        # leftovers (swept at open) from being replaced mid-write.
        with self._schema_lock:
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump(self.holder.schema(), f)
            os.replace(tmp, path)

    def flush(self) -> None:
        self.save_schema()
        self._attach_paths_for_new_objects()
        self.snapshot_all()
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            idx.column_attr_store.save()
            idx.translate_store.save()
            for f in idx.fields.values():
                f.row_attr_store.save()
                f.translate_store.save()

    def _attach_paths_for_new_objects(self) -> None:
        """Objects created after open() need their stores path-bound. The
        fresh path-bound AttrStore takes the SAME live dict the old store
        held, so its contents do not change; a translate store keeps its
        object and gains the path."""
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            idir = os.path.join(self.data_dir, iname)
            if idx.column_attr_store.path is None:
                store = AttrStore(os.path.join(idir, "column_attrs.jsonl"),
                                  epoch=idx.epoch)
                store._attrs = idx.column_attr_store._attrs
                idx.column_attr_store = store
            if idx.translate_store.path is None:
                idx.translate_store.path = os.path.join(idir, "translate.jsonl")
            for fname, f in idx.fields.items():
                fdir = os.path.join(idir, fname)
                if f.row_attr_store.path is None:
                    store = AttrStore(os.path.join(fdir, "row_attrs.jsonl"),
                                      epoch=idx.epoch)
                    store._attrs = f.row_attr_store._attrs
                    f.row_attr_store = store
                if f.translate_store.path is None:
                    f.translate_store.path = os.path.join(fdir, "translate.jsonl")

    def close(self) -> None:
        # Stop the snapshot workers and WAIT for them: a worker
        # mid-snapshot would otherwise keep truncating WALs after the
        # writers below are closed (and after the data dir is handed to
        # a successor process). Workers catch their own exceptions, so
        # sentinels land once the queue drains; the timeouts below are
        # backstops, not the plan.
        for _ in self._workers:
            try:
                self._snap_q.put(None, timeout=35)
            except queue.Full:
                break
        for t in self._workers:
            t.join(timeout=30)
        if any(t.is_alive() for t in self._workers):
            # A straggler is still snapshotting: leave the writers OPEN
            # so its lock-held snapshot+truncate stays valid, and warn —
            # closing them under it could lose acknowledged ops.
            self.logger.printf("diskstore.close: snapshot worker still "
                               "running; leaving WAL writers open")
            self.flush()
            return
        self.flush()
        with self._lock:
            for w in self._writers.values():
                w.close()
            self._writers.clear()


def _raise_open_file_limit() -> None:
    """Every fragment keeps its WAL open: lift the soft open-file limit to
    the hard one, as a data dir of thousands of fragments needs."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard == resource.RLIM_INFINITY or soft < hard:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
        except (ValueError, OSError):
            pass  # keep the soft limit


def _fsync_dir(path: str) -> None:
    """Make a rename durable by fsyncing the containing directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)

