"""BackupWriter -- full + incremental capture of one node.

The port's counterpart of pilosa_tpu/backup/writer.py, on a single node
(the JAX package's ``cluster=None`` path). For every fragment key of the
node's DiskStore it captures the on-disk pair -- CRC-verified ``.snap`` +
the WAL segment's valid prefix -- exactly once. A quarantined or
corrupt-on-read copy fails the run, so a backup never launders damage
into the archive.

Snapshots are NOT forced before capture: the archived (snap, wal) pair
reproduces the live state exactly (that is the load-path contract), and
keeping the WAL segment is what makes point-in-time recovery possible --
a forced snapshot would truncate the very history PITR replays.

Incremental mode captures only what changed since the parent manifest:
an index whose mutation epoch stands still (same process incarnation)
is skipped wholesale, and everything else is compared file by file by
CRC, so an unchanged snapshot with a grown WAL ships just the WAL
segment.

Every fragment's work is admitted under the QoS internal class, so a
backup never starves user queries. A writer given a cluster answers
``NotPortedError`` (ROADMAP.md Queue 1: cluster and operations).
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.backup.archive import (
    ArchiveStore,
    BackupError,
    KIND_ATTRS,
    KIND_SCHEMA,
    KIND_SNAP,
    KIND_TRANSLATE,
    KIND_WAL,
    FORMAT_VERSION,
    file_crc,
    fragment_rel_path,
    meta_rel_path,
    new_backup_id,
    resolve_files,
)
from pilosa_tpu_torch.errors import SLICE_CLUSTER, NotPortedError
from pilosa_tpu_torch.qos.admission import CLASS_INTERNAL, QueryShedError
from pilosa_tpu_torch.storage.integrity import SnapshotCorruptError, split_snapshot
from pilosa_tpu_torch.storage.quarantine import ShardCorruptError
from pilosa_tpu_torch.storage.wal import scan_wal

#: shed-retry schedule for the per-fragment admission gate: a backup
#: must not skip shards (unlike the scrubber, whose next pass retries),
#: so it backs off and re-admits before giving up on the whole run.
ADMIT_RETRIES = 40
ADMIT_RETRY_DELAY = 0.05


def capture_fragment(store, key: tuple) -> dict:
    """Read one fragment's durable pair from a node's DiskStore.

    Returns ``{"snap": bytes|None, "wal": bytes|None, "ops": int}``.
    Raises ``ShardCorruptError`` when the local copy is quarantined or
    fails verification on read and
    ``LookupError`` when the fragment has no durable files at all."""
    if store.quarantine.get(key) is not None:
        # Any quarantine state — routed, unavailable, even degraded —
        # means this copy is not the full acknowledged truth.
        raise ShardCorruptError()
    import os
    snap_path = store._snap_path(key)
    wal_path = store._wal_path(key)
    snap = None
    if os.path.exists(snap_path):
        with open(snap_path, "rb") as f:
            snap = f.read()
        try:
            split_snapshot(snap)  # CRC-verify before the bytes ship
        except SnapshotCorruptError as e:
            raise ShardCorruptError() from e
    wal = None
    ops = 0
    info = scan_wal(wal_path)
    if info["corrupt"]:
        raise ShardCorruptError()
    if info["total_bytes"]:
        with open(wal_path, "rb") as f:
            # Only the valid prefix ships: a torn tail is the normal
            # crash shape and replay would truncate it anyway.
            wal = f.read(info["valid_bytes"])
        ops = info["ops"]
    if snap is None and wal is None:
        raise LookupError(f"no durable files for {key}")
    return {"snap": snap, "wal": wal, "ops": ops}


class BackupWriter:
    """Drives one backup run; ``progress`` is live for /backup/status."""

    def __init__(self, holder, cluster, client, store,
                 archive: ArchiveStore, stats=None, logger=None,
                 admission=None):
        if cluster is not None:
            raise NotPortedError("a backup across a cluster", SLICE_CLUSTER)
        self.holder = holder
        self.store = store
        self.archive = archive
        self.stats = stats
        self.logger = logger
        self.admission = admission
        self.progress: dict = {"state": "idle"}
        self._lock = threading.Lock()

    # -- helpers -----------------------------------------------------------

    def _count(self, name: str, value: int = 1) -> None:
        if self.stats is not None:
            self.stats.count(name, value)

    def _log(self, fmt: str, *args) -> None:
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    def _admitted(self, fn):
        if self.admission is None:
            return fn()
        for attempt in range(ADMIT_RETRIES):
            try:
                with self.admission.admit(CLASS_INTERNAL):
                    return fn()
            except QueryShedError:
                self._count("backup.shedRetries")
                time.sleep(ADMIT_RETRY_DELAY * (attempt + 1))
        raise BackupError("backup shed by admission control: node "
                          "overloaded, retry later")

    # -- capture -----------------------------------------------------------

    def _capture(self, key: tuple) -> dict | None:
        """One fragment's pair from the local store; None when the
        fragment has no durable files (deleted mid-backup)."""
        index, field, view, shard = key
        try:
            pair = capture_fragment(self.store, key)
        except ShardCorruptError:
            self._count("backup.skippedQuarantined")
            self._log("backup: %s/%s/%s/%d unhealthy on local", index, field,
                      view, shard)
            raise BackupError(
                f"no healthy copy of {index}/{field}/{view}/{shard} "
                "reachable: backup would be incomplete") from None
        except LookupError:
            return None
        pair["source"] = "local"
        return pair

    # -- meta stores -------------------------------------------------------

    def _meta_files(self) -> list[tuple[str, str, str, str | None, bytes]]:
        """[(rel_path, kind, index, field, jsonl bytes)] for every
        non-empty translate and attr store, serialized from the in-memory
        truth with the same checksummed line frames the data dir uses."""
        import json as _json

        from pilosa_tpu_torch.storage.integrity import frame_line

        out = []

        def jsonl(pairs) -> bytes:
            return "".join(frame_line(_json.dumps(p)) + "\n"
                           for p in pairs).encode()

        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            entries = idx.translate_store.entries_since(0)
            if entries:
                out.append((meta_rel_path(iname, None, "translate.jsonl"),
                            KIND_TRANSLATE, iname, None,
                            jsonl([[i, k] for i, k in entries])))
            attrs = idx.column_attr_store
            ids = attrs.ids()
            if ids:
                out.append((meta_rel_path(iname, None, "column_attrs.jsonl"),
                            KIND_ATTRS, iname, None,
                            jsonl([[i, attrs.attrs(i)] for i in ids])))
            for fname, f in sorted(idx.fields.items()):
                entries = f.translate_store.entries_since(0)
                if entries:
                    out.append((meta_rel_path(iname, fname, "translate.jsonl"),
                                KIND_TRANSLATE, iname, fname,
                                jsonl([[i, k] for i, k in entries])))
                ids = f.row_attr_store.ids()
                if ids:
                    out.append((meta_rel_path(iname, fname,
                                              "row_attrs.jsonl"),
                                KIND_ATTRS, iname, fname,
                                jsonl([[i, f.row_attr_store.attrs(i)]
                                       for i in ids])))
        return out

    # -- run ---------------------------------------------------------------

    def run(self, backup_id: str | None = None,
            parent: str | None = None) -> dict:
        """Capture one backup; returns the manifest. ``parent`` makes it
        incremental against that manifest (which must be restorable from
        the same archive root)."""
        kind = "incremental" if parent else "full"
        backup_id = backup_id or new_backup_id(kind)
        t0 = time.perf_counter()
        parent_manifest = None
        parent_files: dict[str, dict] = {}
        if parent:
            parent_manifest = self.archive.read_manifest(parent)
            parent_files = resolve_files(parent_manifest)

        keys = self._admitted(self.store.all_fragment_keys)

        # Epoch fast path: an index whose (instance, epoch) pair matches
        # the parent's had no mutation since that capture — reference
        # its fragment files wholesale. instance_id pins the comparison
        # to one process incarnation: epochs restart at 0 across
        # restarts.
        epochs = {}
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            epochs[iname] = {"instance": idx.instance_id,
                             "epoch": idx.epoch.value,
                             "schemaEpoch": idx.schema_epoch.value}
        unchanged_indexes = set()
        if parent_manifest is not None:
            for iname, stamp in epochs.items():
                if parent_manifest.get("epochs", {}).get(iname) == stamp:
                    unchanged_indexes.add(iname)

        with self._lock:
            self.progress = {"state": "running", "id": backup_id,
                             "kind": kind, "totalFragments": len(keys),
                             "doneFragments": 0, "files": 0, "bytes": 0,
                             "unchanged": 0}
        files: list[dict] = []
        stored_bytes = 0

        def store_file(rel: str, kind_: str, data: bytes, **extra) -> dict:
            nonlocal stored_bytes
            crc = file_crc(data)
            pe = parent_files.get(rel)
            entry = {"path": rel, "kind": kind_, "crc": crc,
                     "size": len(data), **extra}
            if pe is not None and pe.get("crc") == crc:
                entry["stored_in"] = pe.get("stored_in", parent)
                self.progress["unchanged"] += 1
                self._count("backup.skippedUnchanged")
            else:
                self.archive.write(backup_id, rel, data)
                stored_bytes += len(data)
                self.progress["files"] += 1
                self.progress["bytes"] = stored_bytes
            return entry

        try:
            for key in keys:
                index, field, view, shard = key
                if index in unchanged_indexes:
                    for ext in ("snap", "wal"):
                        rel = fragment_rel_path(index, field, view, shard,
                                                ext)
                        pe = parent_files.get(rel)
                        if pe is not None:
                            files.append(dict(pe))
                            self.progress["unchanged"] += 1
                    self.progress["doneFragments"] += 1
                    continue
                pair = self._admitted(lambda k=key: self._capture(k))
                if pair is None:
                    self.progress["doneFragments"] += 1
                    continue
                base = {"index": index, "field": field, "view": view,
                        "shard": shard, "source": pair["source"]}
                if pair["snap"] is not None:
                    files.append(store_file(
                        fragment_rel_path(index, field, view, shard,
                                          "snap"),
                        KIND_SNAP, pair["snap"], **base))
                if pair["wal"] is not None:
                    files.append(store_file(
                        fragment_rel_path(index, field, view, shard,
                                          "wal"),
                        KIND_WAL, pair["wal"], ops=pair["ops"], **base))
                self._count("backup.fragments")
                self.progress["doneFragments"] += 1

            for rel, kind_, iname, fname, data in self._meta_files():
                files.append(store_file(rel, kind_, data, index=iname,
                                        field=fname))

            import json as _json
            schema = self.holder.schema()
            files.append(store_file("schema.json", KIND_SCHEMA,
                                    _json.dumps(schema).encode()))

            manifest = {
                "format": FORMAT_VERSION,
                "id": backup_id,
                "parent": parent,
                "kind": kind,
                "created": time.time(),
                "cluster": {"nodes": 1, "replicaN": 1},
                "epochs": epochs,
                "schema": schema,
                "files": files,
            }
            # Manifest last: its presence marks the backup complete.
            self.archive.write_manifest(backup_id, manifest)
        except BaseException as e:
            with self._lock:
                self.progress = dict(self.progress, state="failed",
                                     error=str(e))
            self._count("backup.failures")
            raise

        seconds = time.perf_counter() - t0
        with self._lock:
            self.progress = dict(self.progress, state="done",
                                 seconds=round(seconds, 3))
        self._count("backup.runs")
        self._count("backup.files", self.progress["files"])
        self._count("backup.bytes", stored_bytes)
        if self.stats is not None:
            self.stats.timing("backup.seconds", seconds)
            self.stats.gauge("backup.lastSuccess", time.time())
            if seconds > 0:
                self.stats.gauge("backup.bytesPerSec",
                                 stored_bytes / seconds)
        self._log("backup %s (%s): %d fragments, %d files, %d bytes "
                  "stored (%d unchanged) in %.2fs", backup_id, kind,
                  len(keys), self.progress["files"], stored_bytes,
                  self.progress["unchanged"], seconds)
        return manifest
