"""BackupWriter -- cluster-consistent full + incremental capture.

The port's counterpart of pilosa_tpu/backup/writer.py. One node drives the
backup (whichever received ``/backup`` -- any node works; the data plane
is symmetric). For every fragment key known anywhere in the cluster it
captures the on-disk pair -- CRC-verified ``.snap`` + the WAL segment's
valid prefix -- exactly once, from the first healthy owner: the local
store when this node owns the shard, a peer via the internal backup RPC
(``backup_keys``/``backup_fragment``) otherwise. A quarantined or
corrupt-on-read copy fails over to the next replica, so a backup never
launders damage into the archive. A single node (``cluster=None``) is its
own only owner.

Snapshots are NOT forced before capture: the archived (snap, wal) pair
reproduces the live state exactly (that is the load-path contract), and
keeping the WAL segment is what makes point-in-time recovery possible --
a forced snapshot would truncate the very history PITR replays.

Incremental mode captures only what changed since the parent manifest:
an index whose mutation epoch stands still (same process incarnation)
is skipped wholesale -- except shards the write fan-out marked dirty --
and everything else is compared file by file by CRC, so an unchanged
snapshot with a grown WAL ships just the WAL segment.

Every fragment's work is admitted under the QoS internal class, the
same gate the scrubber uses, so a backup never starves user queries.
Fragments are captured CAPTURE_WORKERS at a time (the JAX writer takes
them one by one); the manifest is the same.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

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
from pilosa_tpu_torch.qos.admission import CLASS_INTERNAL, QueryShedError
from pilosa_tpu_torch.storage.diskstore import IO_WORKERS
from pilosa_tpu_torch.storage.integrity import SnapshotCorruptError, split_snapshot
from pilosa_tpu_torch.storage.quarantine import ShardCorruptError
from pilosa_tpu_torch.storage.wal import scan_wal

#: shed-retry schedule for the per-fragment admission gate: a backup
#: must not skip shards (unlike the scrubber, whose next pass retries),
#: so it backs off and re-admits before giving up on the whole run.
ADMIT_RETRIES = 40
ADMIT_RETRY_DELAY = 0.05
#: fragments a backup captures and stores at once.
CAPTURE_WORKERS = IO_WORKERS


def capture_fragment(store, key: tuple) -> dict:
    """Read one fragment's durable pair from a node's DiskStore.

    Returns ``{"snap": bytes|None, "wal": bytes|None, "ops": int}``.
    Raises ``ShardCorruptError`` when the local copy is quarantined or
    fails verification on read (the caller fails over to a replica) and
    ``LookupError`` when the fragment has no durable files at all."""
    if store.quarantine.get(key) is not None:
        # Any quarantine state -- routed, unavailable, even degraded --
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
        self.holder = holder
        self.cluster = cluster
        self.client = client
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

    def _local_id(self) -> str | None:
        return self.cluster.local_id if self.cluster is not None else None

    def _live_peers(self):
        if self.cluster is None:
            return []
        return [n for n in self.cluster.nodes
                if n.id != self.cluster.local_id and n.state != "DOWN"]

    # -- enumeration -------------------------------------------------------

    def _all_keys(self) -> dict[tuple, list]:
        """Every fragment key known cluster-wide -> nodes listing it
        (local node first when present)."""
        keys: dict[tuple, list] = {}
        for key in self.store.all_fragment_keys():
            keys.setdefault(key, []).append(None)  # None = local
        for node in self._live_peers():
            try:
                listed = self.client.backup_keys(node)
            except (ConnectionError, RuntimeError, OSError):
                self._count("backup.nodesUnreachable")
                self._log("backup: cannot list fragments on %s", node.id)
                continue
            for item in listed:
                keys.setdefault(tuple(item[:3]) + (int(item[3]),),
                                []).append(node)
        return keys

    def _candidates(self, key: tuple, listers: list):
        """Capture order: owners under current placement (local first),
        then any non-owner that listed the key (stale former owners
        still hold restorable bytes)."""
        index, _field, _view, shard = key
        out, seen = [], set()

        def add(node):
            nid = node.id if node is not None else None
            if nid not in seen:
                seen.add(nid)
                out.append(node)

        if self.cluster is not None:
            for n in self.cluster.shard_nodes(index, shard):
                if n.state == "DOWN":
                    continue
                add(None if n.id == self.cluster.local_id else n)
        else:
            add(None)
        for n in listers:
            add(n)
        return out

    # -- capture -----------------------------------------------------------

    def _capture(self, key: tuple, listers: list) -> dict | None:
        """Fetch one fragment from the first healthy candidate; None
        when the fragment vanished everywhere (deleted mid-backup)."""
        index, field, view, shard = key
        found = False
        for node in self._candidates(key, listers):
            try:
                if node is None:
                    pair = capture_fragment(self.store, key)
                else:
                    raw = self.client.backup_fragment(node, index, field,
                                                      view, shard)
                    pair = {"snap": raw.get("snap"), "wal": raw.get("wal"),
                            "ops": int(raw.get("ops") or 0)}
                    self._count("backup.fragmentsRemote")
                pair["source"] = node.id if node is not None \
                    else (self._local_id() or "local")
                return pair
            except ShardCorruptError:
                found = True
                self._count("backup.skippedQuarantined")
                self._log("backup: %s/%s/%s/%d unhealthy on %s, trying "
                          "next replica", index, field, view, shard,
                          node.id if node is not None else "local")
            except LookupError:
                continue
            except (ConnectionError, OSError, RuntimeError):
                found = True
                self._count("backup.fetchErrors")
        if found:
            raise BackupError(
                f"no healthy copy of {index}/{field}/{view}/{shard} "
                "reachable: backup would be incomplete")
        return None  # listed nowhere anymore: deleted mid-backup

    # -- meta stores -------------------------------------------------------

    def _meta_files(self) -> list[tuple[str, str, str, str | None, bytes]]:
        """[(rel_path, kind, index, field, jsonl bytes)] for every
        non-empty translate/attr store, serialized from the in-memory
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
                    out.append((meta_rel_path(iname, fname,
                                              "translate.jsonl"),
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

        keys = self._admitted(self._all_keys)
        dirty = set()
        if self.cluster is not None:
            dirty = self.cluster.dirty_shards.peek()

        # Epoch fast path: an index whose (instance, epoch) pair matches
        # the parent's had no mutation since that capture -- reference
        # its fragment files wholesale, except dirty shards (a DOWN
        # replica missed a write there; re-capture settles which copy
        # the archive trusts). instance_id pins the comparison to one
        # process incarnation: epochs restart at 0 across restarts.
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
                with self._lock:
                    self.progress["unchanged"] += 1
                self._count("backup.skippedUnchanged")
            else:
                self.archive.write(backup_id, rel, data)
                with self._lock:
                    stored_bytes += len(data)
                    self.progress["files"] += 1
                    self.progress["bytes"] = stored_bytes
            return entry

        def fragment_files(key: tuple) -> list[dict]:
            """One fragment key's manifest entries, in snap, wal order."""
            index, field, view, shard = key
            out = []
            if (index in unchanged_indexes
                    and (index, shard) not in dirty):
                for ext in ("snap", "wal"):
                    rel = fragment_rel_path(index, field, view, shard, ext)
                    pe = parent_files.get(rel)
                    if pe is not None:
                        out.append(dict(pe))
                        with self._lock:
                            self.progress["unchanged"] += 1
                with self._lock:
                    self.progress["doneFragments"] += 1
                return out
            pair = self._admitted(lambda: self._capture(key, keys[key]))
            if pair is not None:
                base = {"index": index, "field": field, "view": view,
                        "shard": shard, "source": pair["source"]}
                if pair["snap"] is not None:
                    out.append(store_file(
                        fragment_rel_path(index, field, view, shard, "snap"),
                        KIND_SNAP, pair["snap"], **base))
                if pair["wal"] is not None:
                    out.append(store_file(
                        fragment_rel_path(index, field, view, shard, "wal"),
                        KIND_WAL, pair["wal"], ops=pair["ops"], **base))
                self._count("backup.fragments")
            with self._lock:
                self.progress["doneFragments"] += 1
            return out

        try:
            # Fragments are independent: CAPTURE_WORKERS at a time (peer
            # fetches, file reads, CRCs and archive writes overlap). The
            # JAX writer takes them one by one; the manifest lists the same
            # entries in the same key order. The first failure cancels what
            # has not started.
            with ThreadPoolExecutor(max_workers=CAPTURE_WORKERS) as pool:
                futures = [pool.submit(fragment_files, key) for key in sorted(keys)]
                try:
                    for fut in futures:
                        files.extend(fut.result())
                except BaseException:
                    for fut in futures:
                        fut.cancel()
                    raise

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
                "cluster": {
                    "nodes": (len(self.cluster.nodes)
                              if self.cluster is not None else 1),
                    "replicaN": (self.cluster.replica_n
                                 if self.cluster is not None else 1),
                },
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
