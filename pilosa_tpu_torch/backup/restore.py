"""RestoreJob -- manifest-driven cluster rebuild + point-in-time recovery.

The port's counterpart of pilosa_tpu/backup/restore.py. Restore runs on
one node of the TARGET cluster (any node; whichever received
``/restore``). The manifest is a complete logical file list, so the
target's size is free to differ from the source's: every fragment is
resharded through the target's own placement (``cluster.shard_nodes``)
and pushed to each current owner -- local fragments are rebuilt in place
(writing through the WAL so the restore itself is durable), remote ones
ship over the internal import RPC. A single node (``cluster=None``) owns
every shard.

Fragment state is reconstructed LOCALLY from the archived pair before
any import: apply the snapshot's row arrays, then replay the WAL segment
with full op semantics (set_row/clear_row REPLACE rows -- feeding raw WAL
ops to a bit-import would corrupt them), and only then flatten to
(row, column) pairs. ``pitr_ops`` caps that replay at an op offset,
which is point-in-time recovery: same base snapshot, shorter history.

Failure is atomic: if any fragment cannot reach a single live owner, or
any archived file fails its CRC, the job deletes everything it created
(locally and on every live peer) and raises -- a half-restored index must
never become visible as if it were whole.

Key-translation files restore into the indexes' and fields' translate
stores (``apply_entries``), attr files into the attr stores, as in the JAX
package.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pilosa_tpu_torch.backup.archive import (
    BackupError,
    KIND_ATTRS,
    KIND_SNAP,
    KIND_TRANSLATE,
    KIND_WAL,
    file_crc,
    resolve_files,
)
from pilosa_tpu_torch.storage.diskstore import IO_WORKERS
from pilosa_tpu_torch.storage.integrity import (
    LineCorruptError,
    SnapshotCorruptError,
    parse_line,
    split_snapshot,
)
from pilosa_tpu_torch.storage.wal import (
    OP_ADD,
    OP_CLEAR_ROW,
    OP_REMOVE,
    OP_SET_ROW,
    iter_wal_records,
)


#: fragments a restore rebuilds and imports at once.
RESTORE_WORKERS = IO_WORKERS


def _distinct(x: np.ndarray) -> np.ndarray:
    """``np.unique`` of a 1-D array by a sort and a neighbour mask (numpy's
    own unique is far slower on some hosts' numpy; ROADMAP.md item 20)."""
    x = np.sort(x)
    return x[np.concatenate(([True], x[1:] != x[:-1]))] if len(x) else x


def rebuild_fragment(snap_bytes: bytes | None, wal_bytes: bytes | None,
                     shard: int, pitr_ops: int | None = None):
    """Reconstruct a fragment's final bitmap from its archived pair.

    Returns ``(row_ids, column_ids)`` as uint64 arrays (absolute columns,
    sorted by row, then column) plus the number of WAL ops applied.
    ``pitr_ops`` stops the replay after that many ops -- the
    point-in-time knob. The JAX package's ``rebuild_fragment`` replays
    into Python sets and gives lists; this one keeps each row as a sorted
    array of distinct positions and applies each record with numpy set
    operations, with the same result (``tests/test_torch_backup.py``
    holds the two to each other on every op code)."""
    from pilosa_tpu_torch.config import SHARD_WIDTH
    base = shard * SHARD_WIDTH
    rows: dict[int, np.ndarray] = {}
    if snap_bytes is not None:
        import io
        payload, _meta = split_snapshot(snap_bytes)
        with np.load(io.BytesIO(payload)) as z:
            row_ids = z["row_ids"]
            offsets = z["offsets"]
            positions = z["positions"].astype(np.int64)
        for i, rid in enumerate(row_ids.tolist()):
            pos = positions[int(offsets[i]):int(offsets[i + 1])]
            # Snapshots hold each row sorted and distinct: a check is
            # cheaper than the sort np.unique would do.
            rows[rid] = pos if np.all(pos[1:] > pos[:-1]) else _distinct(pos)
    applied = 0
    if wal_bytes:
        for code, r, c in iter_wal_records(wal_bytes):
            if pitr_ops is not None and applied >= pitr_ops:
                break
            applied += 1
            local = c.astype(np.int64) - base
            if code in (OP_ADD, OP_REMOVE):
                n = min(len(r), len(c))
                order = np.argsort(r[:n], kind="stable")
                rs, cs = r[:n][order], local[:n][order]
                cut = np.flatnonzero(rs[1:] != rs[:-1]) + 1
                for lo, hi in zip(np.concatenate(([0], cut)).tolist(),
                                  np.concatenate((cut, [n])).tolist()):
                    if lo == hi:
                        continue
                    rid, cols = int(rs[lo]), cs[lo:hi]
                    cur = rows.get(rid)
                    if code == OP_ADD:
                        rows[rid] = _distinct(cols if cur is None
                                              else np.concatenate((cur, cols)))
                    elif cur is not None:
                        rows[rid] = cur[~np.isin(cur, cols)]
            elif code == OP_SET_ROW:
                rid = int(r[0]) if len(r) else 0
                rows[rid] = _distinct(local)
            elif code == OP_CLEAR_ROW:
                rid = int(r[0]) if len(r) else 0
                rows.pop(rid, None)
    kept = [rid for rid in sorted(rows) if len(rows[rid])]
    if not kept:
        empty = np.empty(0, dtype=np.uint64)
        return empty, empty.copy(), applied
    out_rows = np.concatenate([np.full(len(rows[rid]), rid, dtype=np.uint64)
                               for rid in kept])
    out_cols = (np.concatenate([rows[rid] for rid in kept]) + base).astype(np.uint64)
    return out_rows, out_cols, applied


def preflight_restore(archive, manifest: dict,
                      crc_samples: int = 4) -> dict:
    """Validate a manifest's FULL restore plan against the archive
    before anything touches a data dir: every ``stored_in`` ref must
    exist (an incremental leans on ancestors a bad prune could have
    taken), and a deterministic spread of entries is read back and
    CRC-checked. Failure names the missing or damaged object, so a
    pruned-or-torn chain dies here — fast — instead of mid-restore.

    Also the retention layer's verify-before-prune pass: a survivor
    that fails this must abort the prune."""
    files = resolve_files(manifest)
    missing = [(e["stored_in"], e["path"]) for e in files.values()
               if not archive.exists(e["stored_in"], e["path"])]
    if missing:
        sid, path = missing[0]
        raise BackupError(
            f"restore preflight: backup {manifest['id']!r} needs "
            f"{len(missing)} object(s) the archive no longer has, "
            f"first: {sid}/{path}")
    ordered = [files[p] for p in sorted(files)]
    if crc_samples <= 0 or not ordered:
        sampled = []
    elif crc_samples >= len(ordered):
        sampled = ordered
    else:
        # Deterministic spread across the sorted plan (always includes
        # the first and last entries).
        step = (len(ordered) - 1) / (crc_samples - 1) if crc_samples > 1 \
            else len(ordered)
        sampled = [ordered[int(i * step)] for i in range(crc_samples)]
    for entry in sampled:
        data = archive.read(entry["stored_in"], entry["path"])
        if file_crc(data) != entry.get("crc"):
            raise BackupError(
                f"restore preflight: backup {manifest['id']!r}: CRC "
                f"mismatch on {entry['stored_in']}/{entry['path']}")
    return {"checked": len(files), "crcChecked": len(sampled)}


def select_backup_at(archive, timestamp: float) -> dict | None:
    """Latest complete backup captured at or before ``timestamp`` — the
    coarse half of PITR (pick the base archive by time, then ``pitr_ops``
    refines within its WAL segments)."""
    best = None
    for bid in archive.list_backups():
        try:
            m = archive.read_manifest(bid)
        except BackupError:
            continue  # incomplete/damaged: not a restore candidate
        if m.get("created", 0) <= timestamp:
            if best is None or m["created"] > best["created"]:
                best = m
    return best


class RestoreJob:
    """One restore run; ``progress`` is live for /restore/status."""

    def __init__(self, holder, cluster, client, archive, backup_id: str,
                 store=None, stats=None, logger=None, force: bool = False,
                 pitr_ops: int | None = None, on_fragment=None):
        self.holder = holder
        self.cluster = cluster
        self.client = client
        self.archive = archive
        self.backup_id = backup_id
        self.store = store
        self.stats = stats
        self.logger = logger
        self.force = force
        self.pitr_ops = pitr_ops
        #: test hook: called with each fragment key just before its
        #: fan-out (the chaos drill kills a node from here).
        self.on_fragment = on_fragment
        self.progress: dict = {"state": "idle"}
        self._lock = threading.Lock()

    # -- helpers -----------------------------------------------------------

    def _count(self, name: str, value: int = 1) -> None:
        if self.stats is not None:
            self.stats.count(name, value)

    def _log(self, fmt: str, *args) -> None:
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    def _read(self, entry: dict) -> bytes:
        data = self.archive.read(entry["stored_in"], entry["path"])
        if file_crc(data) != entry.get("crc"):
            raise BackupError(
                f"archive damage: CRC mismatch reading {entry['path']} "
                f"from backup {entry['stored_in']!r}")
        return data

    def _live_peers(self):
        if self.cluster is None:
            return []
        return [n for n in self.cluster.nodes
                if n.id != self.cluster.local_id and n.state != "DOWN"]

    # -- local/remote import --------------------------------------------------

    def _import_local(self, index, field, view, shard, rows, cols):
        f = self.holder.field(index, field)
        if f is None:
            raise LookupError(f"field not found: {index}/{field}")
        v = f.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(shard)
        frag.bulk_import(rows, cols)

    def _push_fragment(self, key: tuple, rows, cols) -> None:
        """Import one rebuilt fragment into every CURRENT owner under the
        target placement. A DOWN owner is skipped and the shard marked
        dirty (the scrubber heals it when the node returns) -- but zero
        reachable owners aborts the whole job."""
        index, field, view, shard = key
        delivered = 0
        skipped = 0
        if self.cluster is None:
            self._import_local(index, field, view, shard, rows, cols)
            delivered += 1
        else:
            for node in self.cluster.shard_nodes(index, shard):
                if node.state == "DOWN":
                    skipped += 1
                    continue
                try:
                    if node.id == self.cluster.local_id:
                        self._import_local(index, field, view, shard,
                                           rows, cols)
                    else:
                        self.client.import_bits(node, index, field, view,
                                                shard, rows, cols, False)
                    delivered += 1
                except (ConnectionError, OSError, RuntimeError):
                    skipped += 1
        if delivered == 0:
            raise BackupError(
                f"restore: no live owner reachable for "
                f"{index}/{field}/{view}/{shard}")
        if skipped and self.cluster is not None:
            self.cluster.dirty_shards.mark(index, shard)
            self._count("restore.replicasSkipped", skipped)

    # -- meta stores --------------------------------------------------------

    def _apply_meta(self, entry: dict, data: bytes) -> None:
        lines = [ln for ln in data.decode().splitlines() if ln]
        payloads = []
        for ln in lines:
            try:
                payload, _verified = parse_line(ln)
            except LineCorruptError as e:
                raise BackupError(
                    f"archive damage: bad line in {entry['path']}") from e
            payloads.append(json.loads(payload))
        idx = self.holder.index(entry["index"])
        if idx is None:
            return
        target = idx if entry.get("field") is None \
            else idx.field(entry["field"])
        if target is None:
            return
        if entry["kind"] == KIND_TRANSLATE:
            target.translate_store.apply_entries([(int(i), k) for i, k in payloads])
        elif entry["kind"] == KIND_ATTRS:
            store = (idx.column_attr_store if entry.get("field") is None
                     else target.row_attr_store)
            store.set_bulk_attrs({int(i): a for i, a in payloads})

    # -- rollback -----------------------------------------------------------

    def _rollback(self, index_names: list[str]) -> None:
        """All-or-nothing: tear the half-restored indexes back out of
        every live node so no partially-visible index survives."""
        for name in index_names:
            if self.holder.index(name) is not None:
                try:
                    self.holder.delete_index(name)
                except Exception:
                    pass
            if self.store is not None:
                try:
                    self.store.delete_subtree_files(name)
                except Exception:
                    pass
            for node in self._live_peers():
                try:
                    self.client.send_message(
                        node, {"type": "delete-index", "index": name})
                except (ConnectionError, RuntimeError, OSError):
                    pass  # that peer is gone; its cleaner converges later
        self._count("restore.rollbacks")
        self._log("restore: rolled back %s", ",".join(index_names))

    # -- run ----------------------------------------------------------------

    def run(self) -> dict:
        """Run the restore; ``progress`` ends ``done`` or ``failed``. (The
        JAX job leaves ``starting`` in place when it fails before its
        fragment loop -- an index it would clobber, a failed preflight --
        so a client polling /restore/status waits forever; ROADMAP.md
        Queue 3.)"""
        try:
            return self._run()
        except BaseException as e:
            with self._lock:
                if self.progress.get("state") != "failed":
                    self.progress = dict(self.progress, state="failed", error=str(e))
            raise

    def _run(self) -> dict:
        t0 = time.perf_counter()
        manifest = self.archive.read_manifest(self.backup_id)
        files = resolve_files(manifest)
        schema = manifest.get("schema", [])
        index_names = [i["name"] for i in schema]

        conflicting = [n for n in index_names
                       if self.holder.index(n) is not None]
        if conflicting and not self.force:
            raise BackupError(
                f"restore would clobber existing index(es) "
                f"{conflicting}: pass force to overwrite")
        # Preflight the whole plan BEFORE touching any data dir (ours
        # or a conflicting index we're about to force-drop): a broken
        # chain must fail here, not as a mid-restore rollback.
        preflight_restore(self.archive, manifest)
        self._count("restore.preflights")
        for name in conflicting:
            # force: drop the live index everywhere before rebuilding.
            self.holder.delete_index(name)
            if self.store is not None:
                self.store.delete_subtree_files(name)
            for node in self._live_peers():
                try:
                    self.client.send_message(
                        node, {"type": "delete-index", "index": name})
                except (ConnectionError, RuntimeError, OSError):
                    pass

        # Group the fragment entries: one (snap?, wal?) pair per key.
        frags: dict[tuple, dict] = {}
        meta_entries = []
        for entry in files.values():
            if entry["kind"] in (KIND_SNAP, KIND_WAL):
                key = (entry["index"], entry["field"], entry["view"],
                       int(entry["shard"]))
                frags.setdefault(key, {})[entry["kind"]] = entry
            elif entry["kind"] in (KIND_TRANSLATE, KIND_ATTRS):
                meta_entries.append(entry)

        with self._lock:
            self.progress = {"state": "running", "id": self.backup_id,
                             "totalFragments": len(frags),
                             "doneFragments": 0, "bytes": 0,
                             "pitrOps": self.pitr_ops}
        restored_bytes = 0

        def restore_fragment(key: tuple) -> None:
            nonlocal restored_bytes
            pair = frags[key]
            snap = self._read(pair["snap"]) if "snap" in pair else None
            wal = self._read(pair["wal"]) if "wal" in pair else None
            try:
                rows, cols, _applied = rebuild_fragment(
                    snap, wal, key[3], pitr_ops=self.pitr_ops)
            except SnapshotCorruptError as e:
                raise BackupError(
                    f"archive damage: bad snapshot for {key}") from e
            if self.on_fragment is not None:
                self.on_fragment(key)
            if len(rows):
                self._push_fragment(key, rows, cols)
            self._count("restore.fragments")
            with self._lock:
                restored_bytes += (len(snap) if snap else 0) + (len(wal) if wal else 0)
                self.progress["doneFragments"] += 1
                self.progress["bytes"] = restored_bytes

        try:
            # Schema first, everywhere: imports land in existing fields.
            self.holder.apply_schema(schema)
            for node in self._live_peers():
                self.client.post_schema(node, schema)

            # Fragments are independent: RESTORE_WORKERS at a time (reads,
            # zlib, CRCs and numpy release the interpreter lock). The JAX
            # job takes them one by one; the rows are the same. The first
            # failure cancels what has not started.
            with ThreadPoolExecutor(max_workers=RESTORE_WORKERS) as pool:
                futures = [pool.submit(restore_fragment, key) for key in sorted(frags)]
                try:
                    for fut in futures:
                        fut.result()
                except BaseException:
                    for fut in futures:
                        fut.cancel()
                    raise

            for entry in meta_entries:
                self._apply_meta(entry, self._read(entry))
        except BaseException as e:
            self._rollback(index_names)
            with self._lock:
                self.progress = dict(self.progress, state="failed",
                                     error=str(e))
            self._count("restore.failures")
            raise

        if self.store is not None:
            # Persist the restored schema + meta stores now; fragments
            # already went through the WAL on their way in.
            self.store.flush()
        seconds = time.perf_counter() - t0
        with self._lock:
            self.progress = dict(self.progress, state="done",
                                 seconds=round(seconds, 3))
        self._count("restore.runs")
        self._count("restore.bytes", restored_bytes)
        if self.stats is not None:
            self.stats.timing("restore.seconds", seconds)
            if seconds > 0:
                self.stats.gauge("restore.bytesPerSec",
                                 restored_bytes / seconds)
        self._log("restore %s: %d fragments, %d bytes in %.2fs",
                  self.backup_id, len(frags), restored_bytes, seconds)
        return {"id": self.backup_id, "fragments": len(frags),
                "bytes": restored_bytes, "indexes": index_names,
                "seconds": seconds}
