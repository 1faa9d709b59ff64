"""ctypes bindings for the shared C++ codec (``native/roaring_codec.cpp``).

The port's counterpart of pilosa_tpu/native/__init__.py. The library is
built at first use with ``g++`` from the checkout's own source into
``build/native/``, named by a hash of the source, the flags and the
machine, and loaded with ctypes; nothing is built when a module is
imported. The flags are portable (no ``-march=native``), so a library
carried to another host in a copied tree runs there too, and a library
built elsewhere is never picked up by accident: only the hashed name is
loaded.

This is host code, not a device kernel. Every entry point falls back to
the numpy implementation (``pilosa_tpu_torch.roaring``, ``ops.bitops``)
when there is no compiler or the build fails, as the JAX package does;
``status()`` says which codec runs and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading
import weakref
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "roaring_codec.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_status = "native codec not loaded yet (builds at first use)"


def library_path() -> Path:
    """Where the library for this source, these flags and this machine
    lives once built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(platform.machine().encode())
    return BUILD_DIR / f"roaring_codec-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the codec unless its hashed library exists; the output is
    written under a temporary name and renamed into place."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed: {proc.stderr.strip()[-500:]}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    u64 = np.ctypeslib.ndpointer(np.uint64, flags="C")
    u32 = np.ctypeslib.ndpointer(np.uint32, flags="C")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    c64 = ctypes.c_int64
    sigs = {
        "roaring_decode_count": (c64, [ctypes.c_char_p, c64]),
        "roaring_decode": (c64, [ctypes.c_char_p, c64, u64, c64]),
        "roaring_encode_bound": (c64, [u64, c64]),
        "roaring_encode": (c64, [u64, c64, u8, c64]),
        "positions_to_words": (None, [u64, c64, u32, c64]),
        "words_to_positions": (c64, [u32, c64, u64, c64]),
        "popcount_words": (c64, [u32, c64]),
        "intersection_count_words": (c64, [u32, u32, c64]),
        "scatter_row_blocks": (None, [u64, c64, ctypes.c_int, u32, c64, c64,
                                      u8, i64]),
        "scatter_bsi_blocks": (ctypes.c_int, [u64, i64, c64, ctypes.c_int,
                                              ctypes.c_int, u32, c64, c64, u8,
                                              i64]),
        "pool_alloc": (ctypes.c_void_p, [c64, ctypes.c_int]),
        "pool_free": (None, [ctypes.c_void_p, c64]),
        "pool_reserve": (c64, [c64]),
        "pool_set_limit": (None, [c64]),
        "pool_stats": (None, [i64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, _status
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("PILOSA_TPU_NO_NATIVE") == "1":
            _status = "numpy codec: native disabled by PILOSA_TPU_NO_NATIVE=1"
            return None
        if not SOURCE.exists():
            _status = f"numpy codec: no source at {SOURCE}"
            return None
        try:
            path = _build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                # A library carried over from another host that this one
                # cannot load: build it here once more.
                path.unlink(missing_ok=True)
                lib = ctypes.CDLL(str(_build()))
            _bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _status = f"numpy codec: native build or load failed: {e}"
            return None
        _lib = lib
        _status = (f"native codec {path.relative_to(_ROOT)} "
                   f"(g++ {' '.join(CXX_FLAGS)}, {platform.machine()})")
        return _lib


def available() -> bool:
    return _load() is not None


def status() -> str:
    """Which codec runs, and why (loads the library if not tried yet)."""
    _load()
    return _status


_MADV_HUGEPAGE = 14
_PAGE = 4096
_libc = None


def _advise_huge(arr: np.ndarray) -> None:
    """Opt a large, not-yet-touched buffer into 2 MiB pages (Linux
    MADV_HUGEPAGE); first-touch faults then cost one per 2 MiB instead of
    one per 4 KiB. Best-effort: any failure keeps normal pages."""
    global _libc
    if sys.platform != "linux":
        return
    try:
        if _libc is None:
            _libc = ctypes.CDLL(None, use_errno=True)
        addr = arr.ctypes.data
        a = (addr + _PAGE - 1) & ~(_PAGE - 1)
        e = (addr + arr.nbytes) & ~(_PAGE - 1)
        if e > a:
            _libc.madvise(ctypes.c_void_p(a), ctypes.c_size_t(e - a),
                          ctypes.c_int(_MADV_HUGEPAGE))
    except (OSError, AttributeError):
        pass


def pool_reserve(n_bytes: int) -> int:
    """Pre-fault ``n_bytes`` of the codec's recycled page pool (server
    flag ``--import-pool-mb``), so bulk imports do not pay first-touch
    faults on their block buffers. Returns the bytes reserved (0 without
    the native library)."""
    lib = _load()
    if lib is None or n_bytes <= 0:
        return 0
    return int(lib.pool_reserve(int(n_bytes)))


def pool_set_limit(n_bytes: int) -> None:
    lib = _load()
    if lib is not None:
        lib.pool_set_limit(int(n_bytes))


def pool_stats() -> dict | None:
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(4, dtype=np.int64)
    lib.pool_stats(out)
    return {"free_bytes": int(out[0]), "fresh_mmaps": int(out[1]),
            "recycled_allocs": int(out[2]), "limit_bytes": int(out[3])}


def pool_zeros(shape, dtype=np.uint32) -> np.ndarray | None:
    """np.zeros backed by pool memory; the chunk returns to the pool when
    the array and every view of it are garbage-collected. None when the
    native library or memory is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n_bytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if n_bytes <= 0:
        return None
    ptr = lib.pool_alloc(n_bytes, 1)
    if not ptr:
        return None
    buf = (ctypes.c_uint8 * n_bytes).from_address(ptr)
    fin = weakref.finalize(buf, lib.pool_free, ptr, n_bytes)
    # At interpreter shutdown the pool dies with the process; running the
    # finalizer then could touch a torn-down CDLL.
    fin.atexit = False
    arr = np.frombuffer(buf, dtype=np.uint8, count=n_bytes)
    return arr.view(dtype).reshape(shape)


def decode_roaring(buf: bytes) -> np.ndarray:
    """Serialized roaring bitmap -> sorted uint64 positions."""
    lib = _load()
    if lib is None:
        from pilosa_tpu_torch import roaring
        return roaring.decode(buf)
    n = lib.roaring_decode_count(buf, len(buf))
    if n < 0:
        raise ValueError("roaring: invalid buffer")
    out = np.empty(n, dtype=np.uint64)
    got = lib.roaring_decode(buf, len(buf), out, n)
    if got != n:
        raise ValueError("roaring: decode failed")
    return out


def encode_roaring(positions: np.ndarray) -> bytes:
    """Sorted uint64 positions -> serialized roaring bitmap."""
    positions = np.ascontiguousarray(positions, dtype=np.uint64)
    # The native encoder requires strictly increasing input; duplicates
    # would inflate container N and double-count on decode.
    if len(positions) and not (positions[:-1] < positions[1:]).all():
        positions = np.unique(positions)
    lib = _load()
    if lib is None:
        from pilosa_tpu_torch import roaring
        return roaring.encode(positions)
    cap = lib.roaring_encode_bound(positions, len(positions))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.roaring_encode(positions, len(positions), out, cap)
    if n < 0:
        raise ValueError("roaring: encode failed")
    return out[:n].tobytes()


def positions_to_words(positions: np.ndarray, n_words: int) -> np.ndarray:
    positions = np.ascontiguousarray(positions, dtype=np.uint64)
    lib = _load()
    if lib is None:
        from pilosa_tpu_torch.ops import bitops
        return bitops.positions_to_words(positions, n_words)
    words = np.zeros(n_words, dtype=np.uint32)
    lib.positions_to_words(positions, len(positions), words, n_words)
    return words


def words_to_positions(words: np.ndarray) -> np.ndarray:
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lib = _load()
    if lib is None:
        from pilosa_tpu_torch.ops import bitops
        return bitops.words_to_positions(words)
    n = lib.popcount_words(words, len(words))
    out = np.empty(n, dtype=np.uint64)
    got = lib.words_to_positions(words, len(words), out, n)
    if got != n:
        raise RuntimeError("words_to_positions mismatch")
    return out


def popcount_words(words: np.ndarray) -> int:
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lib = _load()
    if lib is None:
        from pilosa_tpu_torch.ops import bitops
        return bitops.np_count(words)
    return int(lib.popcount_words(words, len(words)))


def intersection_count_words(a: np.ndarray, b: np.ndarray) -> int:
    """popcount(a & b) on the host."""
    a = np.ascontiguousarray(a.reshape(-1), dtype=np.uint32)
    b = np.ascontiguousarray(b.reshape(-1), dtype=np.uint32)
    lib = _load()
    if lib is None:
        from pilosa_tpu_torch.ops import bitops
        return bitops.np_count(a & b)
    return int(lib.intersection_count_words(a, b, len(a)))


def scatter_row_blocks(cols: np.ndarray, exp: int,
                       n_shards: int, words_per_shard: int):
    """Scatter one row's absolute column ids into dense per-shard word
    blocks in a single unsorted pass. Returns (blocks[n_shards, W],
    touched[n_shards] bool, counts[n_shards] int64) or None when the
    native library is missing (callers take the sorted import path)."""
    lib = _load()
    if lib is None:
        return None
    cols = np.ascontiguousarray(cols, dtype=np.uint64)
    blocks = pool_zeros((n_shards, words_per_shard), np.uint32)
    if blocks is None:
        blocks = np.zeros((n_shards, words_per_shard), dtype=np.uint32)
        _advise_huge(blocks)
    touched = np.zeros(n_shards, dtype=np.uint8)
    counts = np.zeros(n_shards, dtype=np.int64)
    lib.scatter_row_blocks(cols, len(cols), exp,
                           blocks.reshape(-1), n_shards, words_per_shard,
                           touched, counts)
    return blocks, touched.astype(bool), counts


def scatter_bsi_blocks(cols: np.ndarray, vals: np.ndarray, exp: int,
                       depth: int, n_shards: int, words_per_shard: int):
    """Scatter (column, value) pairs into dense BSI bit-plane blocks
    ([n_shards, depth+2, W]; per-shard rows: exists, sign, planes) in one
    native pass. Duplicate columns resolve last-write-wins (the codec
    dedupes against the exists plane, which the caller guarantees starts
    empty). Returns (blocks, touched, counts[n_shards, depth+2]) or None
    when the native library is missing or its staging alloc failed
    (callers take the per-fragment import)."""
    lib = _load()
    if lib is None:
        return None
    cols = np.ascontiguousarray(cols, dtype=np.uint64)
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    blocks = pool_zeros((n_shards, depth + 2, words_per_shard), np.uint32)
    if blocks is None:
        blocks = np.zeros((n_shards, depth + 2, words_per_shard), dtype=np.uint32)
        _advise_huge(blocks)
    touched = np.zeros(n_shards, dtype=np.uint8)
    counts = np.zeros((n_shards, depth + 2), dtype=np.int64)
    rc = lib.scatter_bsi_blocks(cols, vals, len(cols), exp, depth,
                                blocks.reshape(-1), n_shards, words_per_shard,
                                touched, counts.reshape(-1))
    if rc != 0:
        return None
    return blocks, touched.astype(bool), counts
