"""Binary write-ahead log, one file per fragment (the port's copy of
pilosa_tpu/storage/wal.py: the same record format, byte for byte).

Reference: the op-log appended to each fragment's data file
(roaring.go:4650 opType add/remove/addBatch/removeBatch, op.WriteTo
:4694 with per-op checksum, replayed on open via op.apply :4671).

Record format (little-endian):
  magic   u16 = 0x504C ("PL")
  op      u8   (1=add 2=remove 3=set_row 4=clear_row)
  n_rows  u32
  n_cols  u32
  crc32   u32  of the payload
  payload n_rows*u64 rows ++ n_cols*u64 cols
Row and column counts are independent so one-row ops (set_row/clear_row)
keep their row id even with zero columns. Torn tails (crash mid-append)
are detected by magic/crc and truncated, exactly the recovery contract
of the reference's checksummed ops.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib

import numpy as np

_MAGIC = 0x504C
_HEADER = struct.Struct("<HBIII")

OP_ADD = 1
OP_REMOVE = 2
OP_SET_ROW = 3
OP_CLEAR_ROW = 4

_OP_CODES = {"add": OP_ADD, "addBatch": OP_ADD,
             "remove": OP_REMOVE, "removeBatch": OP_REMOVE,
             "setRow": OP_SET_ROW, "clearRow": OP_CLEAR_ROW}


class WalWriter:
    """Appender with op counting (MaxOpN snapshot trigger).

    ``fsync_appends=False`` (default) matches the reference's op-log
    durability (user+OS buffered writes, crash may lose the tail);
    True fsyncs for strict durability at a write-latency cost.

    ``group_window`` (seconds, used only with ``fsync_appends``) turns
    per-record fsyncs into GROUP COMMIT: concurrent appenders elect a
    leader that sleeps the window, then issues ONE fsync covering every
    record flushed so far; followers just wait for a sync whose sequence
    covers theirs (the leader-drain shape of httpclient's peer channel).
    Appends hit the file in strict sequence order, and an fsync makes a
    strict prefix durable — so crash recovery sees exactly the torn-tail
    semantics of the per-record mode, never a gap.
    """

    def __init__(self, path: str, fsync_appends: bool = False,
                 group_window: float = 0.0):
        self.path = path
        self.fsync_appends = fsync_appends
        self.group_window = group_window
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self.op_n = 0
        #: fsync() calls issued (bench: fsyncs per Mval imported).
        self.fsyncs = 0
        self._lock = threading.Lock()
        self._sync_cv = threading.Condition(self._lock)
        self._seq = 0          # records written + flushed
        self._seq_synced = 0   # records covered by an fsync
        self._flusher_busy = False

    def append(self, op: str, rows, cols) -> None:
        code = _OP_CODES[op]
        r = np.asarray(rows, dtype=np.uint64)
        c = np.asarray(cols, dtype=np.uint64)
        if code in (OP_ADD, OP_REMOVE) and len(r) != len(c):
            raise ValueError("row/col length mismatch in WAL append")
        if code in (OP_SET_ROW, OP_CLEAR_ROW) and len(r) != 1:
            raise ValueError(f"{op} requires exactly one row id")
        payload = r.tobytes() + c.tobytes()
        with self._lock:
            self._f.write(_HEADER.pack(_MAGIC, code, len(r), len(c),
                                       zlib.crc32(payload) & 0xFFFFFFFF))
            self._f.write(payload)
            self._f.flush()
            self.op_n += 1
            self._seq += 1
            my_seq = self._seq
        if self.fsync_appends:
            if self.group_window > 0:
                self._group_sync(my_seq)
            else:
                os.fsync(self._f.fileno())
                with self._lock:
                    self.fsyncs += 1
                    if my_seq > self._seq_synced:
                        self._seq_synced = my_seq

    def _group_sync(self, my_seq: int) -> None:
        """Block until an fsync covers record ``my_seq``, becoming the
        flush leader if none is active."""
        with self._sync_cv:
            while True:
                if self._seq_synced >= my_seq:
                    return
                if not self._flusher_busy:
                    self._flusher_busy = True
                    break
                self._sync_cv.wait()
        # Leader, outside the lock: let concurrent appenders pile onto
        # this commit, then fsync once for all of them.
        if self.group_window > 0:
            time.sleep(self.group_window)
        with self._lock:
            cover = self._seq  # everything written so far is flushed
        try:
            os.fsync(self._f.fileno())
        finally:
            with self._sync_cv:
                self.fsyncs += 1
                if cover > self._seq_synced:
                    self._seq_synced = cover
                self._flusher_busy = False
                self._sync_cv.notify_all()

    def sync(self) -> None:
        """Flush user+OS buffers so appended records survive a crash."""
        with self._lock:
            self._f.flush()
        os.fsync(self._f.fileno())
        with self._lock:
            self.fsyncs += 1
            if self._seq > self._seq_synced:
                self._seq_synced = self._seq

    def truncate(self) -> None:
        """Called after a snapshot subsumes the log (fragment.go:2393).

        Callers must make the snapshot durable (fsync file + dir) BEFORE
        truncating, or a crash in between loses the fragment.
        """
        with self._lock:
            self._f.seek(0)
            self._f.truncate()
            self._f.flush()
            os.fsync(self._f.fileno())
            self.fsyncs += 1
            self.op_n = 0
            # Truncation subsumes every appended record: release any
            # group-commit waiter still parked on an old sequence.
            self._seq_synced = self._seq
            self._sync_cv.notify_all()

    def close(self) -> None:
        self._f.close()


def scan_wal(path: str) -> dict:
    """Integrity scan distinguishing the two failure shapes a replay
    cannot: a TORN TAIL (crash mid-append; the invalid bytes are the
    file's last record and nothing valid follows) and MID-FILE
    CORRUPTION (a damaged record with intact records after it — replay
    silently drops every op past the damage, so the fragment must be
    quarantined, not trusted).

    Returns ``{"ops", "valid_bytes", "total_bytes", "torn", "corrupt"}``.
    """
    if not os.path.exists(path):
        return {"ops": 0, "valid_bytes": 0, "total_bytes": 0,
                "torn": False, "corrupt": False}
    with open(path, "rb") as f:
        data = f.read()

    def _valid_at(off: int) -> int | None:
        """End offset of a valid record starting at ``off``, else None."""
        if off + _HEADER.size > len(data):
            return None
        magic, _code, n_rows, n_cols, crc = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + 8 * (n_rows + n_cols)
        if magic != _MAGIC or end > len(data):
            return None
        if (zlib.crc32(data[off + _HEADER.size:end]) & 0xFFFFFFFF) != crc:
            return None
        return end

    ops = 0
    off = 0
    while True:
        end = _valid_at(off)
        if end is None:
            break
        ops += 1
        off = end
    torn = off < len(data)
    corrupt = False
    if torn:
        # Any valid record past the damage proves mid-file corruption
        # (appends are strictly sequential, so bytes after a real torn
        # tail can only be garbage).
        magic_bytes = _MAGIC.to_bytes(2, "little")
        pos = data.find(magic_bytes, off + 1)
        while pos != -1:
            if _valid_at(pos) is not None:
                corrupt = True
                break
            pos = data.find(magic_bytes, pos + 1)
    return {"ops": ops, "valid_bytes": off, "total_bytes": len(data),
            "torn": torn, "corrupt": corrupt}


def iter_wal_records(data: bytes):
    """Yield ``(code, rows, cols)`` from raw WAL bytes, stopping cleanly
    at a torn tail — the shared decode loop behind WalReader and the
    backup subsystem's archived-segment replay (restore/PITR run it over
    bytes fetched from an archive, where no file path exists)."""
    off = 0
    while off + _HEADER.size <= len(data):
        magic, code, n_rows, n_cols, crc = _HEADER.unpack_from(data, off)
        body_len = 8 * (n_rows + n_cols)
        end = off + _HEADER.size + body_len
        if magic != _MAGIC or end > len(data):
            break  # torn tail
        payload = data[off + _HEADER.size: end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break
        rows = np.frombuffer(payload[: 8 * n_rows], dtype=np.uint64)
        cols = np.frombuffer(payload[8 * n_rows:], dtype=np.uint64)
        yield code, rows, cols
        off = end


class WalReader:
    """Replays records; stops cleanly at a torn tail."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        yield from iter_wal_records(data)
