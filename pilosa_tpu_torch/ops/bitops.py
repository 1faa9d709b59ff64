"""Dense bitmap primitives: numpy (host) and torch (device) variants.

The port's counterpart of pilosa_tpu/ops/bitops.py. Replaces the
reference's roaring container kernels (roaring/roaring.go: intersect* :3260,
union* :3482, difference* :4119, xor* :4466, popcount :5291, Count :407). A
bitmap row is a dense vector of ``WORDS_PER_SHARD`` 32-bit words,
LSB-first within each word: column ``c`` lives at word ``c >> 5``, bit
``c & 31``.

Host (``np_*``) functions are a copy of the JAX package's numpy half: the
mutation/import path keeps uint32 words. On the device a word is an
**int32 bit pattern** (``torch.from_numpy(words.view(np.int32))``): torch's
uint32 has ``& | ^`` but not ``~``, ``<<`` or ``>>``, and torch has no
popcount op. ``&``, ``|``, ``^`` and ``~`` act on the bits alike for both
types; ``>>`` on int32 is arithmetic, so any logical shift must mask.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.config import WORD_BITS, WORDS_PER_SHARD

# ---------------------------------------------------------------------------
# Host-side (numpy): positions <-> dense words, single-bit mutation
# ---------------------------------------------------------------------------


def np_zero_row(words: int = WORDS_PER_SHARD) -> np.ndarray:
    return np.zeros(words, dtype=np.uint32)


def positions_to_words(positions: np.ndarray, words: int = WORDS_PER_SHARD) -> np.ndarray:
    """Scatter sorted bit positions into a dense uint32 word block."""
    out = np.zeros(words, dtype=np.uint32)
    if len(positions) == 0:
        return out
    positions = np.asarray(positions, dtype=np.uint64)
    word_idx = (positions >> np.uint64(5)).astype(np.int64)
    bit = np.left_shift(np.uint32(1), (positions & np.uint64(31)).astype(np.uint32))
    np.bitwise_or.at(out, word_idx, bit)
    return out


def words_to_positions(words: np.ndarray) -> np.ndarray:
    """Dense block -> sorted uint64 bit positions (the 'columns' of a row)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    # unpackbits works on uint8 little-end-first per byte with bitorder='little',
    # which matches LSB-first-within-word once viewed as little-endian bytes.
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint64)


def np_get_bit(words: np.ndarray, pos: int) -> bool:
    return bool((int(words[pos >> 5]) >> (pos & 31)) & 1)


def np_set_bit(words: np.ndarray, pos: int) -> bool:
    """Set bit in place; returns True if the bit changed."""
    w, b = pos >> 5, np.uint32(1 << (pos & 31))
    if words[w] & b:
        return False
    words[w] |= b
    return True


def np_clear_bit(words: np.ndarray, pos: int) -> bool:
    w, b = pos >> 5, np.uint32(1 << (pos & 31))
    if not (words[w] & b):
        return False
    words[w] &= ~b
    return True


def np_count(words: np.ndarray) -> int:
    """Set bits of a host word array of any integer type (its words read as
    unsigned, so a signed word's sign bit counts)."""
    return int(np.bitwise_count(words.view(f"u{words.dtype.itemsize}")).sum())


def np_range_mask(start: int, stop: int, words: int = WORDS_PER_SHARD) -> np.ndarray:
    """Dense mask with bits [start, stop) set. Reference: CountRange's
    partial-word handling (roaring.go:438)."""
    out = np.zeros(words, dtype=np.uint32)
    start = max(0, start)
    stop = min(stop, words * WORD_BITS)
    if start >= stop:
        return out
    w0, w1 = start >> 5, (stop - 1) >> 5
    out[w0 : w1 + 1] = np.uint32(0xFFFFFFFF)
    out[w0] &= np.uint32(0xFFFFFFFF) << np.uint32(start & 31)
    tail = stop & 31
    if tail:
        out[w1] &= np.uint32(0xFFFFFFFF) >> np.uint32(32 - tail)
    return out


def np_shift_left(words: np.ndarray, n: int) -> np.ndarray:
    """The host half of pilosa_tpu/ops/bitops.py shift_left (:167): the
    uint32 words of a row shifted toward higher columns by ``n >= 0`` bits
    -- a whole-word roll, then the intra-word shift carrying across word
    boundaries -- bits past the row's end falling off. A new array."""
    if n < 0:
        raise ValueError("shift amount must be non-negative")
    words = np.asarray(words, dtype=np.uint32)
    q, b = divmod(int(n), WORD_BITS)
    w = words.shape[-1]
    out = np.zeros_like(words)
    if q >= w:
        return out
    out[..., q:] = words[..., :w - q]
    if b:
        carry = out >> np.uint32(WORD_BITS - b)
        out <<= np.uint32(b)
        out[..., 1:] |= carry[..., :-1]
    return out


def columns_of(words, base: int = 0) -> np.ndarray:
    """Materialize a dense block (numpy uint32 or int32 tensor) to sorted
    absolute column ids (host)."""
    return words_to_positions(to_host_words(words)) + np.uint64(base)


# ---------------------------------------------------------------------------
# Host <-> device word conversion
# ---------------------------------------------------------------------------


def to_device_words(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 numpy words -> int32 bit-pattern tensor on ``device``. On the
    CPU the tensor shares the numpy buffer; callers hand over a copy."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def to_host_words(words) -> np.ndarray:
    """int32 bit-pattern tensor (or numpy words) -> uint32 numpy words."""
    if isinstance(words, torch.Tensor):
        return words.detach().cpu().contiguous().numpy().view(np.uint32)
    return np.asarray(words, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Device-side (torch): set algebra on int32 bit patterns
# ---------------------------------------------------------------------------


def b_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def b_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def b_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a ^ b


def b_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a AND NOT b — reference Difference (roaring.go:891)."""
    return a & ~b


def popcount_words(a: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 bit patterns, as int32. On the CPU,
    numpy's ``bitwise_count`` over the words as uint32 (no temporaries);
    elsewhere SWAR on int64, so no step depends on how int32 shifts or
    overflows. Both give the same counts."""
    if a.device.type == "cpu" and a.dtype == torch.int32:
        words = a.detach().contiguous().numpy().view(np.uint32)
        return torch.from_numpy(np.bitwise_count(words).astype(np.int32))
    v = a.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return v.to(torch.int32)


def count(a: torch.Tensor) -> torch.Tensor:
    """Total set bits over the last axis, int32 per row: a shard row has at
    most 2^30 bits, so int32 never overflows per row; callers summing
    across shards widen to int64."""
    return popcount_words(a).sum(dim=-1, dtype=torch.int32)
