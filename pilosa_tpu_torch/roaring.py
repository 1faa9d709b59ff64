"""Roaring bitmap wire-format codec (Pilosa variant): the port's copy of
pilosa_tpu/roaring.py.

Interop with the reference's serialized bitmaps: the format written by
roaring.go WriteTo (:1046) and shipped by /import-roaring
(api.go:368 → fragment.importRoaring :2255):

  u32  cookie = 12348 | flags<<24       (MagicNumber roaring.go:31)
  u32  containerCount
  per container, 12B interleaved:  u64 key, u16 type, u16 N-1
  per container:                   u32 absolute data offset
  data: array  = N × u16 LE
        bitmap = 1024 × u64 LE
        run    = u16 runCount + runCount × (u16 start, u16 last)

This module is the pure-numpy implementation; pilosa_tpu_torch.native
loads a C++ version of the hot decode/encode loops and falls back to these.
Positions are the 64-bit "pos" encoding (key*2^16 + low16).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 12348
#: official RoaringFormatSpec cookies (reference roaring.go:5310-5313).
OFFICIAL_NO_RUNS = 12346
OFFICIAL_RUNS = 12347
HEADER = struct.Struct("<II")
META = struct.Struct("<QHH")

TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

ARRAY_MAX = 4096
RUN_MAX = 2048
CONTAINER_BITS = 1 << 16


def decode(buf: bytes) -> np.ndarray:
    """Serialized roaring bitmap -> sorted uint64 positions. Accepts the
    pilosa variant (cookie 12348) and the official RoaringFormatSpec
    (12346/12347 — standard 32-bit roaring files)."""
    if len(buf) < HEADER.size:
        raise ValueError("roaring: buffer too small")
    cookie, count = HEADER.unpack_from(buf, 0)
    if cookie & 0xFFFF != MAGIC:
        return decode_official(buf)
    metas = []
    off = HEADER.size
    for _ in range(count):
        key, typ, n1 = META.unpack_from(buf, off)
        metas.append((key, typ, n1 + 1))
        off += META.size
    offsets = np.frombuffer(buf, dtype="<u4", count=count, offset=off)
    out = []
    for (key, typ, n), data_off in zip(metas, offsets.tolist()):
        base = np.uint64(key) * np.uint64(CONTAINER_BITS)
        if typ == TYPE_ARRAY:
            vals = np.frombuffer(buf, dtype="<u2", count=n, offset=data_off)
            out.append(base + vals.astype(np.uint64))
        elif typ == TYPE_BITMAP:
            words = np.frombuffer(buf, dtype="<u8", count=CONTAINER_BITS // 64,
                                  offset=data_off)
            bits = np.unpackbits(
                words.view(np.uint8), bitorder="little")
            out.append(base + np.nonzero(bits)[0].astype(np.uint64))
        elif typ == TYPE_RUN:
            (run_n,) = struct.unpack_from("<H", buf, data_off)
            runs = np.frombuffer(buf, dtype="<u2", count=run_n * 2,
                                 offset=data_off + 2).reshape(-1, 2)
            for start, last in runs.tolist():
                out.append(base + np.arange(start, last + 1, dtype=np.uint64))
        else:
            raise ValueError(f"roaring: unknown container type {typ}")
    if not out:
        return np.empty(0, dtype=np.uint64)
    return np.concatenate(out)


def decode_official(buf: bytes) -> np.ndarray:
    """Official RoaringFormatSpec (32-bit roaring) -> uint64 positions.

    Layout (readOfficialHeader behavior, roaring.go:5316-5374): cookie
    12346 = [u32 cookie][u32 size], 12347 = [u16 cookie | (size-1)<<16]
    [run bitmap]; then size x (u16 key, u16 card-1); an offset header
    unless (runs and size < 4) — without it containers are sequential.
    Containers are typed by cardinality (array < 4096 else bitmap) plus
    the run bitmap; official runs are (start, LENGTH) pairs.
    """
    (cookie,) = struct.unpack_from("<I", buf, 0)
    pos = 4
    run_bitmap = None
    if cookie == OFFICIAL_NO_RUNS:
        if len(buf) < 8:
            raise ValueError("roaring: buffer too small")
        (size,) = struct.unpack_from("<I", buf, 4)
        pos = 8
    elif cookie & 0xFFFF == OFFICIAL_RUNS:
        size = (cookie >> 16) + 1
        rb = (size + 7) // 8
        if pos + rb > len(buf):
            raise ValueError("roaring: run bitmap overruns buffer")
        run_bitmap = np.unpackbits(
            np.frombuffer(buf, dtype=np.uint8, count=rb, offset=pos),
            bitorder="little")
        pos += rb
    else:
        raise ValueError(f"roaring: bad cookie {cookie & 0xFFFF}")
    if size > (1 << 16):
        raise ValueError("roaring: impossible container count")
    hdr = pos
    if pos + 4 * size > len(buf):
        raise ValueError("roaring: descriptive header overruns buffer")
    pos += 4 * size
    offsets = None
    if run_bitmap is None or size >= 4:
        if pos + 4 * size > len(buf):
            raise ValueError("roaring: offset header overruns buffer")
        offsets = np.frombuffer(buf, dtype="<u4", count=size, offset=pos)
        pos += 4 * size
        # Containers are sequential and non-overlapping in the official
        # layout; aliased/decreasing offsets are adversarial (they let a
        # tiny buffer emit unbounded data).
        if len(offsets) and (int(offsets[0]) < pos
                             or (np.diff(offsets.astype(np.int64)) <= 0).any()):
            raise ValueError("roaring: offsets not strictly increasing")
    data_off = pos
    out = []
    emitted = 0
    # Allocation-DoS bound (mirrors the native decoder's): offsets can
    # all alias one payload, so the emitted total — not the buffer size —
    # must be capped before arrays materialize.
    max_emit = len(buf) * 16384 + 65536
    for i in range(size):
        key, n1 = struct.unpack_from("<HH", buf, hdr + 4 * i)
        n = n1 + 1
        base = np.uint64(key) << np.uint64(16)
        is_run = run_bitmap is not None and bool(run_bitmap[i])
        off = int(offsets[i]) if offsets is not None else data_off
        if is_run:
            if off + 2 > len(buf):
                raise ValueError("roaring: run header overruns buffer")
            (run_n,) = struct.unpack_from("<H", buf, off)
            if off + 2 + 4 * run_n > len(buf):
                raise ValueError("roaring: runs overrun buffer")
            runs = np.frombuffer(buf, dtype="<u2", count=run_n * 2,
                                 offset=off + 2).reshape(-1, 2)
            for start, length in runs.tolist():
                if start + length > 0xFFFF:
                    raise ValueError("roaring: run exceeds container")
                emitted += length + 1
                if emitted > max_emit:
                    raise ValueError("roaring: emitted count exceeds bound")
                out.append(base + np.arange(start, start + length + 1,
                                            dtype=np.uint64))
            data_off = off + 2 + 4 * run_n
        elif n <= ARRAY_MAX:
            # <=: official writers keep arrays up to EXACTLY 4096 values
            # (one would decode as 8192 bytes — a bitmap's size — so an
            # off-by-one here misreads valid files silently).
            if off + 2 * n > len(buf):
                raise ValueError("roaring: array overruns buffer")
            vals = np.frombuffer(buf, dtype="<u2", count=n, offset=off)
            emitted += n
            if emitted > max_emit:
                raise ValueError("roaring: emitted count exceeds bound")
            out.append(base + vals.astype(np.uint64))
            data_off = off + 2 * n
        else:
            if off + 8 * (CONTAINER_BITS // 64) > len(buf):
                raise ValueError("roaring: bitmap overruns buffer")
            words = np.frombuffer(buf, dtype="<u8",
                                  count=CONTAINER_BITS // 64, offset=off)
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")
            vals = np.nonzero(bits)[0].astype(np.uint64)
            emitted += len(vals)
            if emitted > max_emit:
                raise ValueError("roaring: emitted count exceeds bound")
            out.append(base + vals)
            data_off = off + 8 * (CONTAINER_BITS // 64)
    if not out:
        return np.empty(0, dtype=np.uint64)
    return np.concatenate(out)


def encode(positions: np.ndarray) -> bytes:
    """Sorted uint64 positions -> serialized roaring bitmap (containers
    chosen by the reference's optimize() economics, roaring.go:2334)."""
    positions = np.asarray(positions, dtype=np.uint64)
    # Strictly-increasing check: sorted-with-duplicates input must also be
    # deduped or container N / run lengths double-count on decode.
    if len(positions) and not (positions[:-1] < positions[1:]).all():
        positions = np.unique(positions)
    keys = (positions >> np.uint64(16)).astype(np.uint64)
    lows = (positions & np.uint64(0xFFFF)).astype(np.uint16)

    containers = []  # (key, type, N, payload_bytes)
    for key in np.unique(keys):
        vals = lows[keys == key]
        n = len(vals)
        # Run detection.
        diffs = np.diff(vals.astype(np.int64))
        breaks = np.nonzero(diffs != 1)[0]
        run_n = len(breaks) + 1
        run_size = 2 + 4 * run_n
        array_size = 2 * n
        bitmap_size = 8 * (CONTAINER_BITS // 64)
        if run_n <= RUN_MAX and run_size < min(array_size, bitmap_size):
            starts = np.concatenate(([0], breaks + 1))
            ends = np.concatenate((breaks, [n - 1]))
            runs = np.empty((run_n, 2), dtype="<u2")
            runs[:, 0] = vals[starts]
            runs[:, 1] = vals[ends]
            payload = struct.pack("<H", run_n) + runs.tobytes()
            containers.append((int(key), TYPE_RUN, n, payload))
        elif n <= ARRAY_MAX:
            containers.append((int(key), TYPE_ARRAY, n,
                               vals.astype("<u2").tobytes()))
        else:
            words = np.zeros(CONTAINER_BITS // 64, dtype="<u8")
            idx = (vals >> 6).astype(np.int64)
            bit = np.left_shift(np.uint64(1), (vals & np.uint16(63)).astype(np.uint64))
            np.bitwise_or.at(words, idx, bit)
            containers.append((int(key), TYPE_BITMAP, n, words.tobytes()))

    head = HEADER.pack(MAGIC, len(containers))
    metas = b"".join(META.pack(k, t, n - 1) for k, t, n, _ in containers)
    data_start = len(head) + len(metas) + 4 * len(containers)
    offsets = []
    off = data_start
    for _, _, _, payload in containers:
        offsets.append(off)
        off += len(payload)
    offs = np.asarray(offsets, dtype="<u4").tobytes()
    return head + metas + offs + b"".join(p for _, _, _, p in containers)
