"""Offline archive verification — ``cmd_check --archive`` / ``backup-verify``.

The port's counterpart of pilosa_tpu/backup/verify.py, the same module.

Walks one backup (or every backup under a root) without touching a live
cluster: manifest present and well-formed, parent chain resolvable,
every listed file present in the archive that claims to hold it, every
whole-file CRC intact, every snapshot footer verified, every WAL segment
a clean op chain (no mid-file corruption, op count matching the
manifest), every jsonl line frame valid. Exit-1 material for the CLI:
damage found here is damage a restore would hit at the worst moment.
"""

from __future__ import annotations

import json

from pilosa_tpu_torch.backup.archive import (
    ArchiveStore,
    BackupError,
    KIND_ATTRS,
    KIND_SNAP,
    KIND_TRANSLATE,
    KIND_WAL,
    file_crc,
    resolve_files,
)
from pilosa_tpu_torch.storage.integrity import (
    LineCorruptError,
    SnapshotCorruptError,
    parse_line,
    split_snapshot,
)


def _verify_wal_bytes(data: bytes) -> dict:
    """scan_wal's contract over in-memory bytes: archived segments hold
    only valid records (the writer ships the valid prefix), so ANY
    trailing garbage — torn or mid-file — is archive damage."""
    from pilosa_tpu_torch.storage.wal import iter_wal_records
    ops = 0
    consumed = 0
    from pilosa_tpu_torch.storage.wal import _HEADER
    off = 0
    for _code, rows, cols in iter_wal_records(data):
        ops += 1
        off += _HEADER.size + 8 * (len(rows) + len(cols))
    consumed = off
    return {"ops": ops, "clean": consumed == len(data)}


def verify_backup(store: ArchiveStore, backup_id: str) -> dict:
    """Verify one backup; returns {"ok", "problems", "checked"}."""
    problems: list[str] = []
    checked = 0
    try:
        manifest = store.read_manifest(backup_id)
    except BackupError as e:
        return {"ok": False, "problems": [str(e)], "checked": 0}

    # Parent chain: every ancestor an incremental references must still
    # be a complete backup, or its referenced bytes are gone.
    seen = {backup_id}
    parent = manifest.get("parent")
    while parent:
        if parent in seen:
            problems.append(f"parent chain loop at {parent!r}")
            break
        seen.add(parent)
        if not store.has_manifest(parent):
            problems.append(f"missing parent backup {parent!r}")
            break
        parent = store.read_manifest(parent).get("parent")

    for path, entry in sorted(resolve_files(manifest).items()):
        checked += 1
        holder_id = entry["stored_in"]
        if not store.exists(holder_id, path):
            problems.append(f"{path}: missing from backup {holder_id!r}")
            continue
        data = store.read(holder_id, path)
        if entry.get("size") is not None and len(data) != entry["size"]:
            problems.append(f"{path}: size mismatch (manifest "
                            f"{entry['size']}, file {len(data)})")
        if file_crc(data) != entry.get("crc"):
            problems.append(f"{path}: file CRC mismatch")
            continue  # deeper checks would just re-report the damage
        kind = entry.get("kind")
        if kind == KIND_SNAP:
            try:
                _payload, meta = split_snapshot(data)
                if meta is None:
                    problems.append(f"{path}: snapshot has no footer")
            except SnapshotCorruptError as e:
                problems.append(f"{path}: {e}")
        elif kind == KIND_WAL:
            info = _verify_wal_bytes(data)
            if not info["clean"]:
                problems.append(f"{path}: WAL chain broken (trailing "
                                "bytes fail record verification)")
            elif (entry.get("ops") is not None
                    and info["ops"] != entry["ops"]):
                problems.append(f"{path}: WAL op count mismatch "
                                f"(manifest {entry['ops']}, "
                                f"file {info['ops']})")
        elif kind in (KIND_TRANSLATE, KIND_ATTRS):
            for i, ln in enumerate(data.decode().splitlines()):
                if not ln:
                    continue
                try:
                    payload, _verified = parse_line(ln)
                    json.loads(payload)
                except (LineCorruptError, ValueError) as e:
                    problems.append(f"{path}: line {i + 1}: {e}")
    return {"ok": not problems, "problems": problems, "checked": checked}


def verify_archive(root, backup_id: str | None = None) -> dict:
    """Verify one backup, or every backup under an archive root.

    ``root`` is a directory path, an object-store URL, or an
    ArchiveStore. Returns ``{"ok", "problems", "checked", "backups"}``
    with problems prefixed by backup id when scanning the whole root."""
    from pilosa_tpu_torch.backup.objstore import open_archive
    store = root if isinstance(root, ArchiveStore) else open_archive(root)
    if backup_id is not None:
        out = verify_backup(store, backup_id)
        out["backups"] = 1
        return out
    ids = store.list_backups()
    problems: list[str] = []
    checked = 0
    for bid in ids:
        res = verify_backup(store, bid)
        problems.extend(f"{bid}: {p}" for p in res["problems"])
        checked += res["checked"]
    if not ids:
        problems.append("no complete backups found in archive root")
    return {"ok": not problems, "problems": problems, "checked": checked,
            "backups": len(ids)}
