"""Durability: per-fragment snapshot + WAL, schema and attr persistence,
holder reload, integrity framing + corruption quarantine.

The port's counterpart of pilosa_tpu/storage/, reading and writing the
same data dir byte for byte. Reference: the op-log + snapshot cycle
(roaring.go:4650-4790 op records, fragment.go:84 MaxOpN, :2296
enqueueSnapshot, :2337-2393 snapshot temp + rename; holder.go:137 Open
walks the data dir). The WAL is a binary record stream per fragment and
snapshots are compressed position arrays: the host-side truth the device
stacks are rebuilt from on boot.

Exports resolve lazily (PEP 562): core.attrs imports the integrity
framing from this package, and an eager diskstore import here would
close the cycle diskstore -> core.attrs -> storage.
"""

_EXPORTS = {
    "DiskStore": "pilosa_tpu_torch.storage.diskstore",
    "read_snapshot": "pilosa_tpu_torch.storage.diskstore",
    "WalReader": "pilosa_tpu_torch.storage.wal",
    "WalWriter": "pilosa_tpu_torch.storage.wal",
    "scan_wal": "pilosa_tpu_torch.storage.wal",
    "SnapshotCorruptError": "pilosa_tpu_torch.storage.integrity",
    "LineCorruptError": "pilosa_tpu_torch.storage.integrity",
    "snapshot_footer": "pilosa_tpu_torch.storage.integrity",
    "split_snapshot": "pilosa_tpu_torch.storage.integrity",
    "frame_line": "pilosa_tpu_torch.storage.integrity",
    "parse_line": "pilosa_tpu_torch.storage.integrity",
    "QuarantineRegistry": "pilosa_tpu_torch.storage.quarantine",
    "ShardCorruptError": "pilosa_tpu_torch.storage.quarantine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
