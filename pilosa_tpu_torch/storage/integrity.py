"""On-disk integrity framing: snapshot footers and checksummed jsonl lines
(the port's copy of pilosa_tpu/storage/integrity.py).

The WAL is checksummed per-op (storage/wal.py), but every other durable
artifact — fragment snapshots, translate/attr jsonl stores — was trusted
blindly at boot: a flipped bit was detected only if ``np.load`` happened
to throw, and otherwise served wrong bits forever.  This module gives
each artifact a verifiable frame:

Snapshot footer (appended after the npz payload)::

    magic    4s  = b"PTSF"
    version  u16
    flags    u16 (reserved)
    crc32    u32 of the payload bytes
    len      u64 payload byte length
    rows     u64 row count       (operator-facing, `check`/`inspect`)
    bits     u64 set-bit count
    magic2   4s  = b"FSTP"

The trailing magic makes a complete footer cheap to detect from the file
tail; the LEADING magic catches the crash/corruption shape a trailing
check alone would miss — a file truncated mid-footer still shows the
leading magic in its tail and is flagged corrupt instead of silently
downgrading to "legacy unframed".  Files with neither magic are legacy
(pre-footer) snapshots: still loadable, but flagged unverified.

Jsonl line frame::

    L1 <payload-byte-len> <crc32-hex8> <payload>

Unframed lines (legacy stores) still parse, flagged unverified; a framed
line whose length or CRC disagrees raises ``LineCorruptError`` so the
loader can skip it with a warning instead of crashing the boot.
"""

from __future__ import annotations

import struct
import zlib

SNAP_MAGIC = b"PTSF"
SNAP_MAGIC_END = b"FSTP"
SNAP_VERSION = 1

_FOOTER_BODY = struct.Struct("<HHIQQQ")
FOOTER_SIZE = len(SNAP_MAGIC) + _FOOTER_BODY.size + len(SNAP_MAGIC_END)

LINE_PREFIX = "L1 "


class SnapshotCorruptError(Exception):
    """A framed snapshot failed verification (CRC/length/torn footer)."""


class LineCorruptError(Exception):
    """A framed jsonl line failed verification."""


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


# -- snapshot footer -------------------------------------------------------

def snapshot_footer(payload: bytes, rows: int, bits: int) -> bytes:
    """Footer bytes for an npz payload about to be published."""
    return (SNAP_MAGIC
            + _FOOTER_BODY.pack(SNAP_VERSION, 0, _crc(payload),
                                len(payload), rows, bits)
            + SNAP_MAGIC_END)


def split_snapshot(data: bytes) -> tuple[bytes, dict | None]:
    """Split raw snapshot file bytes into (payload, meta).

    meta is None for a legacy unframed file.  Raises
    ``SnapshotCorruptError`` when a footer is present but wrong (CRC or
    length mismatch) or torn (leading magic without the trailing one).
    """
    if (len(data) >= FOOTER_SIZE
            and data.endswith(SNAP_MAGIC_END)
            and data[-FOOTER_SIZE:-FOOTER_SIZE + 4] == SNAP_MAGIC):
        version, _flags, crc, plen, rows, bits = _FOOTER_BODY.unpack(
            data[-FOOTER_SIZE + 4:-4])
        payload = data[:-FOOTER_SIZE]
        if plen != len(payload):
            raise SnapshotCorruptError(
                f"footer length mismatch: footer says {plen}, "
                f"file holds {len(payload)}")
        if _crc(payload) != crc:
            raise SnapshotCorruptError(
                f"payload crc mismatch: footer {crc:#010x}, "
                f"payload {_crc(payload):#010x}")
        return payload, {"version": version, "rows": rows, "bits": bits,
                         "crc": crc}
    # A leading magic in the tail without a trailing one is a footer cut
    # mid-write/mid-truncation — corrupt, not legacy.
    if SNAP_MAGIC in data[-(FOOTER_SIZE - 1):]:
        raise SnapshotCorruptError("truncated snapshot footer")
    return data, None


# -- jsonl line frame ------------------------------------------------------

def frame_line(payload: str) -> str:
    """Frame one jsonl payload (no trailing newline)."""
    data = payload.encode("utf-8")
    return f"{LINE_PREFIX}{len(data)} {_crc(data):08x} {payload}"


def parse_line(line: str) -> tuple[str, bool]:
    """(payload, verified). Unframed legacy lines come back unverified;
    a framed line that fails its check raises ``LineCorruptError``."""
    if not line.startswith(LINE_PREFIX):
        return line, False
    parts = line.split(" ", 3)
    if len(parts) != 4:
        raise LineCorruptError("truncated line frame")
    try:
        n = int(parts[1])
        crc = int(parts[2], 16)
    except ValueError as e:
        raise LineCorruptError(f"bad line frame header: {e}") from e
    payload = parts[3]
    data = payload.encode("utf-8")
    if len(data) != n:
        raise LineCorruptError(
            f"line length mismatch: frame says {n}, line holds {len(data)}")
    if _crc(data) != crc:
        raise LineCorruptError(
            f"line crc mismatch: frame {crc:#010x}, payload "
            f"{_crc(data):#010x}")
    return payload, True
