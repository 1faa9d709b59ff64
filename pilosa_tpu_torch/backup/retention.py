"""Retention — keep-N-full-chains pruning with a crash-safe journal.

The port's counterpart of pilosa_tpu/backup/retention.py, the same module.

An unattended scheduler fills the archive forever; retention is the
half that empties it, and it is the ONLY code allowed to delete from an
archive, so it is built around one invariant:

    at every instant — including mid-crash — every backup that
    ``list_backups`` returns is fully restorable.

Mechanics, in order:

1. **Plan.** Backups group into chains by following ``parent`` links to
   their full; the newest ``keep_chains`` chains survive, older chains
   are victims.
2. **Prove.** A victim is only deletable if no *surviving* manifest's
   ``stored_in`` refs reach it (an incremental references the ancestor
   that physically holds its unchanged bytes). Anything still
   referenced is kept, whatever the chain math said.
3. **Verify before prune.** Every survivor passes a restore preflight
   (all refs present, CRC spot-checks) BEFORE anything is deleted —
   deleting from an archive whose survivors are already damaged only
   destroys evidence.
4. **Journal, then delete.** The victim list lands in a journal object
   first; each victim's manifest is deleted before its payloads (so it
   drops out of listings while still whole); a crash mid-prune leaves
   either intact listed backups or unlisted orphans that the next
   prune run sweeps by replaying the journal.
"""

from __future__ import annotations

import json
import time

from pilosa_tpu_torch.backup.archive import (
    ArchiveStore,
    BackupError,
    resolve_files,
)
from pilosa_tpu_torch.backup.restore import preflight_restore

#: pseudo backup id holding the prune journal. It never carries a
#: manifest, so no backend ever lists it as a backup.
JOURNAL_ID = "_prune"
JOURNAL_NAME = "journal.json"


def plan_prune(archive: ArchiveStore, keep_chains: int) -> dict:
    """The prune decision, decided but not executed: which backups are
    victims, which survive, and why — so tests (and operators via
    /debug/backup) can audit the reachability proof separately from
    the deletes."""
    ids = archive.list_backups()
    manifests = {bid: archive.read_manifest(bid) for bid in ids}

    def root_of(bid: str) -> str:
        seen = {bid}
        cur = bid
        while True:
            parent = manifests[cur].get("parent")
            if not parent or parent not in manifests or parent in seen:
                return cur
            seen.add(parent)
            cur = parent

    roots = {bid: root_of(bid) for bid in ids}
    chain_order = sorted({r for r in roots.values()},
                         key=lambda r: (manifests[r].get("created", 0), r))
    kept_roots = set(chain_order[-keep_chains:]) if keep_chains > 0 \
        else set(chain_order)
    victims = [bid for bid in ids if roots[bid] not in kept_roots]
    survivors = [bid for bid in ids if roots[bid] in kept_roots]

    # The proof: union every survivor's stored_in refs; a victim any
    # survivor still reaches is NOT deletable, whatever chain it's in.
    referenced: set[str] = set(survivors)
    for bid in survivors:
        for entry in resolve_files(manifests[bid]).values():
            referenced.add(entry["stored_in"])
    still_referenced = [v for v in victims if v in referenced]
    victims = [v for v in victims if v not in referenced]
    return {"victims": victims, "survivors": survivors,
            "stillReferenced": still_referenced, "manifests": manifests}


def _replay_journal(archive: ArchiveStore, stats, logger) -> int:
    """Finish a crashed prune: its victims are already journaled (and
    possibly half-deleted); deleting them again is idempotent."""
    if not archive.exists(JOURNAL_ID, JOURNAL_NAME):
        return 0
    try:
        journal = json.loads(archive.read(JOURNAL_ID, JOURNAL_NAME))
    except (ValueError, BackupError, OSError):
        archive.delete(JOURNAL_ID, JOURNAL_NAME)
        return 0
    resumed = 0
    if journal.get("state") == "pruning":
        for bid in journal.get("victims", []):
            archive.delete_backup(bid)
            resumed += 1
        if resumed and logger is not None:
            logger.printf("backup retention: resumed crashed prune "
                          "(%d victim(s) swept)", resumed)
        if resumed and stats is not None:
            stats.count("backup.retention.resumed", resumed)
    archive.delete(JOURNAL_ID, JOURNAL_NAME)
    return resumed


def prune_archive(archive: ArchiveStore, keep_chains: int,
                  stats=None, logger=None, fence=None) -> dict:
    """Apply the keep-N-full-chains policy. Returns a summary dict;
    ``aborted`` is set (and nothing was deleted) when a survivor
    failed its pre-prune verification, or when the ``fence`` gate
    (a callable; the scheduler passes its quorum-fence check) says a
    partitioned minority must not delete from a shared archive a
    majority-side successor may be writing to."""
    if fence is not None and fence():
        if stats is not None:
            stats.count("backup.retention.fenced")
        if logger is not None:
            logger.printf("backup retention: skipped while fenced")
        return {"pruned": 0, "victims": [], "survivors": 0,
                "stillReferenced": [], "resumed": 0, "aborted": "fenced"}
    resumed = _replay_journal(archive, stats, logger)
    plan = plan_prune(archive, keep_chains)
    victims, survivors = plan["victims"], plan["survivors"]
    summary = {"pruned": 0, "victims": victims,
               "survivors": len(survivors),
               "stillReferenced": plan["stillReferenced"],
               "resumed": resumed, "aborted": None}
    if plan["stillReferenced"] and logger is not None:
        logger.printf("backup retention: keeping %s: still referenced "
                      "by a surviving manifest",
                      ",".join(plan["stillReferenced"]))
    if not victims:
        return summary

    # Verify-before-prune: every survivor must be restorable NOW.
    for bid in survivors:
        try:
            preflight_restore(archive, plan["manifests"][bid],
                              crc_samples=2)
        except BackupError as e:
            summary["aborted"] = f"survivor {bid} failed preflight: {e}"
            if stats is not None:
                stats.count("backup.retention.aborts")
            if logger is not None:
                logger.printf("backup retention ABORTED: %s",
                              summary["aborted"])
            return summary

    archive.write(JOURNAL_ID, JOURNAL_NAME, json.dumps({
        "state": "pruning", "victims": victims,
        "keep": survivors, "startedEpoch": time.time()}).encode())
    for bid in victims:
        archive.delete_backup(bid)
        summary["pruned"] += 1
    archive.delete(JOURNAL_ID, JOURNAL_NAME)
    if stats is not None:
        stats.count("backup.retention.pruned", summary["pruned"])
    if logger is not None:
        logger.printf("backup retention: pruned %d superseded backup(s) "
                      "(%s), %d surviving", summary["pruned"],
                      ",".join(victims), len(survivors))
    return summary


__all__ = ["JOURNAL_ID", "JOURNAL_NAME", "plan_prune", "prune_archive"]
