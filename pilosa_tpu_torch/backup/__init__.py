"""Backup, restore, and point-in-time recovery on a single node.

The port's counterpart of pilosa_tpu/backup/: archives of every
fragment's CRC-verified snapshot + WAL segment plus schema and attr
stores, written through a small ``ArchiveStore`` interface
(``LocalDirArchive`` for a directory, ``ObjectArchiveStore`` for an
S3-compatible object store), in the JAX package's archive format, so an
archive written by either package restores into the other.

- ``BackupWriter``   -- full + incremental capture of the node's data
  dir, rate-limited through the QoS internal class.
- ``BackupScheduler``-- unattended periodic incrementals (epoch fast
  path, failure backoff) plus the keep-N-full-chains retention pruner
  (``retention.prune_archive``).
- ``RestoreJob``     -- manifest-driven rebuild, preflighted against the
  archive before it touches a data dir, CRC-verified on ingest, atomic
  (all-or-nothing per restore).
- ``verify_archive`` -- offline archive check (manifest completeness,
  per-file CRCs, snapshot footers, WAL chain continuity).

Each runs the JAX package's ``cluster=None`` path, translate stores
included. Capture and restore across a cluster answer ``NotPortedError``
(ROADMAP.md Queue 1: cluster and operations).
"""

from .archive import (
    ArchiveStore,
    BackupError,
    LocalDirArchive,
    MANIFEST_NAME,
    new_backup_id,
    resolve_files,
)
from .objstore import ObjectArchiveStore, open_archive, parse_archive_url
from .restore import RestoreJob, preflight_restore, select_backup_at
from .retention import plan_prune, prune_archive
from .scheduler import BackupScheduler
from .verify import verify_archive
from .writer import BackupWriter, capture_fragment

__all__ = [
    "ArchiveStore",
    "BackupError",
    "BackupScheduler",
    "BackupWriter",
    "LocalDirArchive",
    "MANIFEST_NAME",
    "ObjectArchiveStore",
    "RestoreJob",
    "capture_fragment",
    "new_backup_id",
    "open_archive",
    "parse_archive_url",
    "plan_prune",
    "preflight_restore",
    "prune_archive",
    "resolve_files",
    "select_backup_at",
    "verify_archive",
]
