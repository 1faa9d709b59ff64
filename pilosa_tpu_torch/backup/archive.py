"""Archive layout + the ArchiveStore backend interface.

The port's counterpart of pilosa_tpu/backup/archive.py, the same module.

An archive root holds any number of backups, each a directory named by
its backup id::

    <root>/<backup_id>/manifest.json        # written LAST: its presence
                                            # marks the backup complete
    <root>/<backup_id>/schema.json
    <root>/<backup_id>/data/<index>/<field>/<view>/<shard>.snap
    <root>/<backup_id>/data/<index>/<field>/<view>/<shard>.wal
    <root>/<backup_id>/data/<index>/translate.jsonl
    <root>/<backup_id>/data/<index>/column_attrs.jsonl
    <root>/<backup_id>/data/<index>/<field>/translate.jsonl
    <root>/<backup_id>/data/<index>/<field>/row_attrs.jsonl

The manifest records every logical file of the cluster state at capture
time; an incremental backup stores bytes only for files that changed
since the parent and points unchanged entries at the ancestor that
holds them (``stored_in``), so a single manifest is always a complete,
self-describing restore plan — no chain walk at restore time.

``ArchiveStore`` is deliberately tiny (write/read/exists/list) so an
object-store backend can slot in behind the same BackupWriter/
RestoreJob; ``LocalDirArchive`` is the local-directory implementation.
"""

from __future__ import annotations

import json
import os
import time
import uuid
import zlib

from pilosa_tpu_torch.errors import PilosaError

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1

#: file kinds a manifest entry may carry
KIND_SNAP = "snap"
KIND_WAL = "wal"
KIND_TRANSLATE = "translate"
KIND_ATTRS = "attrs"
KIND_SCHEMA = "schema"


class BackupError(PilosaError):
    message = "backup/restore error"


def file_crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def new_backup_id(kind: str = "full") -> str:
    """Sortable, collision-free id: UTC timestamp + kind + nonce."""
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    return f"{stamp}-{kind}-{uuid.uuid4().hex[:8]}"


class ArchiveStore:
    """Backend interface: a flat (backup_id, rel_path) -> bytes store."""

    def write(self, backup_id: str, rel_path: str, data: bytes) -> None:
        raise NotImplementedError

    def read(self, backup_id: str, rel_path: str) -> bytes:
        raise NotImplementedError

    def exists(self, backup_id: str, rel_path: str) -> bool:
        raise NotImplementedError

    def list_backups(self) -> list[str]:
        raise NotImplementedError

    def delete(self, backup_id: str, rel_path: str) -> None:
        """Remove one object (missing is not an error)."""
        raise NotImplementedError

    def delete_backup(self, backup_id: str) -> None:
        """Remove a whole backup, manifest first — the backup must drop
        out of ``list_backups`` before any payload byte goes, so a
        crash mid-delete leaves only complete, restorable listings.
        Retention pruning is the only caller."""
        raise NotImplementedError

    # -- manifest helpers (shared across backends) -------------------------

    def write_manifest(self, backup_id: str, manifest: dict) -> None:
        self.write(backup_id, MANIFEST_NAME,
                   json.dumps(manifest, indent=1).encode())

    def read_manifest(self, backup_id: str) -> dict:
        try:
            doc = json.loads(self.read(backup_id, MANIFEST_NAME))
        except (OSError, ValueError) as e:
            raise BackupError(
                f"backup {backup_id!r}: unreadable manifest "
                f"(incomplete or damaged archive): {e}") from e
        if doc.get("format") != FORMAT_VERSION:
            raise BackupError(
                f"backup {backup_id!r}: unsupported manifest format "
                f"{doc.get('format')!r} (this build reads "
                f"{FORMAT_VERSION})")
        return doc

    def has_manifest(self, backup_id: str) -> bool:
        return self.exists(backup_id, MANIFEST_NAME)


class LocalDirArchive(ArchiveStore):
    """Local-directory backend with the durable-write discipline of the
    data dir: unique tmp name + fsync + rename, so a crash mid-backup
    never leaves a file the verifier would half-trust — and the manifest
    is written last, so a backup without one is simply incomplete."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, backup_id: str, rel_path: str) -> str:
        # Ids and paths come from manifests and operators: confine the
        # id to the root and the path to that backup's directory (a
        # hostile manifest must not write or read through "..").
        root = os.path.normpath(self.root)
        base = os.path.normpath(os.path.join(root, backup_id))
        p = os.path.normpath(os.path.join(base, rel_path))
        if (not base.startswith(root + os.sep)
                or not p.startswith(base + os.sep)):
            raise BackupError(f"archive path escapes root: "
                              f"{backup_id!r}/{rel_path!r}")
        return p

    def write(self, backup_id: str, rel_path: str, data: bytes) -> None:
        path = self._path(backup_id, rel_path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def read(self, backup_id: str, rel_path: str) -> bytes:
        with open(self._path(backup_id, rel_path), "rb") as f:
            return f.read()

    def exists(self, backup_id: str, rel_path: str) -> bool:
        return os.path.exists(self._path(backup_id, rel_path))

    def list_backups(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isfile(
                          os.path.join(self.root, d, MANIFEST_NAME)))

    def delete(self, backup_id: str, rel_path: str) -> None:
        try:
            os.remove(self._path(backup_id, rel_path))
        except FileNotFoundError:
            pass

    def delete_backup(self, backup_id: str) -> None:
        import shutil
        base = self._path(backup_id, MANIFEST_NAME)
        self.delete(backup_id, MANIFEST_NAME)  # unlist before payloads go
        shutil.rmtree(os.path.dirname(base), ignore_errors=True)


def fragment_rel_path(index: str, field: str, view: str, shard: int,
                      ext: str) -> str:
    return f"data/{index}/{field}/{view}/{shard}.{ext}"


def meta_rel_path(index: str, field: str | None, name: str) -> str:
    if field is None:
        return f"data/{index}/{name}"
    return f"data/{index}/{field}/{name}"


def resolve_files(manifest: dict) -> dict[str, dict]:
    """path -> entry map of a manifest's complete logical file set.

    Every entry carries ``stored_in`` (the backup id whose archive holds
    the bytes — this backup for captured files, an ancestor for
    incremental refs), so callers read each file with one lookup."""
    out = {}
    for e in manifest.get("files", []):
        entry = dict(e)
        entry.setdefault("stored_in", manifest["id"])
        out[entry["path"]] = entry
    return out
