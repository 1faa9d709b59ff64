"""Test-only fault injection: deterministic file corruption (the port's
copy of pilosa_tpu/storage/faults.py).

Models the disk-corruption classes of Bairavasundaram et al. ("An
Analysis of Data Corruption in the Storage Stack"): silent bit flips,
truncation (lost writes at the tail), and whole-file loss.  Used by the
crash-recovery tests and the chaos soak's corruption action; production
code never imports this module.
"""

from __future__ import annotations

import os
import random

from pilosa_tpu_torch.storage.diskstore import DiskStore

FAULT_MODES = ("bitflip", "truncate", "unlink")


def corrupt_file(path: str, mode: str = "bitflip",
                 rng: random.Random | None = None) -> None:
    """Damage ``path`` in place. ``bitflip`` flips one bit mid-file,
    ``truncate`` cuts the tail, ``unlink`` removes the file."""
    rng = rng or random.Random(0)
    if mode == "unlink":
        os.remove(path)
        return
    size = os.path.getsize(path)
    if mode == "truncate":
        # Cut into the tail: for a framed snapshot this lands mid-footer
        # (the crash shape split_snapshot must flag, not misread as
        # legacy); for a WAL it tears the last record.
        keep = max(0, size - rng.randrange(1, 24))
        with open(path, "r+b") as f:
            f.truncate(keep)
        return
    if mode == "bitflip":
        if size == 0:
            return
        off = rng.randrange(size)
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ (1 << rng.randrange(8))]))
        return
    raise ValueError(f"unknown fault mode {mode!r}")


class FaultyDiskStore(DiskStore):
    """DiskStore whose next snapshot publish is followed by injected
    corruption of the published file — the "disk lied after the fsync"
    scenario recovery tests need to stage without racing real writers."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        #: next fault mode to inject, or None (one-shot; tests re-arm).
        self.fault_next_snapshot: str | None = None
        self.faults_injected = 0
        self._fault_rng = random.Random(42)

    def snapshot_fragment(self, key: tuple) -> None:
        super().snapshot_fragment(key)
        mode, self.fault_next_snapshot = self.fault_next_snapshot, None
        if mode is None:
            return
        path = self._snap_path(key)
        if os.path.exists(path):
            corrupt_file(path, mode, rng=self._fault_rng)
            self.faults_injected += 1
