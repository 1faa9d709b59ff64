"""Bit-sliced integer (BSI) queries on the port's kernels.

The port's counterpart of pilosa_tpu/ops/bsi.py. Reference: fragment.go
rangeEQ/rangeLT/rangeGT/rangeBetween (:1288-1536), sum (:1111), min/max
(:1146-1227). Values are sign-magnitude bit-sliced: row 0 = exists, row 1
= sign, rows 2.. = magnitude bits (fragment.go:91-93).

Magnitude planes arrive as a cube ``bits[depth, ..., W]`` (bit i = weight
2^i at ``bits[i]``) beside ``exists``/``sign``/filter words of shape
``[..., W]``: one shard (``[W]``) or a whole ``[S_pad, W]`` shard stack.
Predicates travel as (lo, hi) 32-bit halves, as in the reference, so depths
up to 63 work.

The unsigned comparator and the min/max descent are the ``bsi_compare`` and
``bsi_minmax`` kernels (``ops/kernels.py``); ``sum_counts`` runs
``row_counts`` and ``pair_count`` (the cube against one class row, a
suffix broadcast). Every entry point takes the plain PyTorch version of
each kernel for CPU tensors and launches the kernel for CUDA tensors. The
*signed* combination branches, the reference's ``pred == -1`` quirks
included, are replicated here with torch bitwise ops.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import bitops, kernels
# The plain lt/eq/gt lanes live beside their kernel in ops/kernels.py.
from pilosa_tpu_torch.ops.kernels import compare_unsigned  # noqa: F401


def split_u64(v: int) -> tuple[int, int]:
    """Unsigned magnitude -> (lo, hi) 32-bit halves."""
    v = int(v)
    return v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF


def _join_u64(lo, hi) -> int:
    """(lo, hi) halves, ints or int32 bit patterns, -> the unsigned value."""
    return ((int(hi) & 0xFFFFFFFF) << 32) | (int(lo) & 0xFFFFFFFF)


def _compare_select(bits, filt, lo: int, hi: int, depth: int, op: str,
                    allow_eq: bool) -> torch.Tensor:
    """Reference _compare_select (:70): the ``bsi_compare`` kernel."""
    return kernels.bsi_compare(bits, filt, lo, hi, depth, op, allow_eq)


def range_lt_unsigned(bits, filt, upred: int, depth: int, allow_eq: bool):
    """{col in filt : mag(col) < (<=) upred} — reference rangeLTUnsigned
    (fragment.go:1357)."""
    return _compare_select(bits, filt, *split_u64(upred), depth, "lt", allow_eq)


def range_gt_unsigned(bits, filt, upred: int, depth: int, allow_eq: bool):
    return _compare_select(bits, filt, *split_u64(upred), depth, "gt", allow_eq)


def range_eq_unsigned(bits, filt, upred: int, depth: int):
    return _compare_select(bits, filt, *split_u64(upred), depth, "eq", True)


# ---------------------------------------------------------------------------
# Signed range ops — exact reference branch structure (fragment.go)
# ---------------------------------------------------------------------------


def range_eq(exists, sign, bits, predicate: int, depth: int):
    """rangeEQ, fragment.go:1288."""
    if predicate < 0:
        return range_eq_unsigned(bits, exists & sign, -predicate, depth)
    return range_eq_unsigned(bits, bitops.b_andnot(exists, sign), predicate, depth)


def range_neq(exists, sign, bits, predicate: int, depth: int):
    """rangeNEQ, fragment.go:1317: exists minus EQ."""
    return bitops.b_andnot(exists, range_eq(exists, sign, bits, predicate, depth))


def _positive_branch(predicate: int, allow_eq: bool) -> bool:
    """The predicate classes that rangeLT/rangeGT treat as non-negative,
    with the strict ``pred == -1`` quirk (fragment.go:1332, :1404)."""
    return (predicate >= 0 and allow_eq) or (predicate >= -1 and not allow_eq)


def range_lt(exists, sign, bits, predicate: int, depth: int, allow_eq: bool):
    """rangeLT, fragment.go:1332 — including the pred==-1 strict quirk."""
    upred = abs(predicate)
    if _positive_branch(predicate, allow_eq):
        # All positives below the predicate, plus every negative.
        pos = range_lt_unsigned(bits, bitops.b_andnot(exists, sign), upred,
                                depth, allow_eq)
        return (exists & sign) | pos
    # Negative predicate: negatives with greater magnitude.
    return range_gt_unsigned(bits, exists & sign, upred, depth, allow_eq)


def range_gt(exists, sign, bits, predicate: int, depth: int, allow_eq: bool):
    """rangeGT, fragment.go:1404."""
    upred = abs(predicate)
    if _positive_branch(predicate, allow_eq):
        return range_gt_unsigned(bits, bitops.b_andnot(exists, sign), upred,
                                 depth, allow_eq)
    # Negative predicate: negatives with smaller magnitude, plus all positives.
    neg = range_lt_unsigned(bits, exists & sign, upred, depth, allow_eq)
    return bitops.b_andnot(exists, sign) | neg


def range_between(exists, sign, bits, pmin: int, pmax: int, depth: int):
    """rangeBetween, fragment.go:1457 (inclusive both ends)."""
    umin, umax = abs(pmin), abs(pmax)
    if pmin >= 0:
        filt = bitops.b_andnot(exists, sign)
        return (range_gt_unsigned(bits, filt, umin, depth, True)
                & range_lt_unsigned(bits, filt, umax, depth, True))
    if pmax < 0:
        # Negative-only: magnitudes between |pmax| and |pmin|.
        filt = exists & sign
        return (range_gt_unsigned(bits, filt, umax, depth, True)
                & range_lt_unsigned(bits, filt, umin, depth, True))
    # Crossing zero: positives <= pmax union negatives with mag <= |pmin|.
    pos = range_lt_unsigned(bits, bitops.b_andnot(exists, sign), umax, depth, True)
    neg = range_lt_unsigned(bits, exists & sign, umin, depth, True)
    return pos | neg


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------


def sum_counts(exists, sign, bits, filt, depth: int):
    """Per-plane positive/negative intersection counts feeding sum():
    (count, pos_counts[depth, ...], neg_counts[depth, ...]) as int32; the
    host weights them by 2^i in Python ints. Reference sum_counts (:182)."""
    consider = exists & filt
    nrow = sign & consider
    prow = bitops.b_andnot(consider, sign)
    cnt = kernels.row_counts(consider)
    pos = kernels.pair_count(bits[:depth], prow, "and")
    neg = kernels.pair_count(bits[:depth], nrow, "and")
    return cnt, pos, neg


def host_sum(exists, sign, bits, filt, depth: int) -> tuple[int, int]:
    """(sum, count) with exact Python-int weighting."""
    cnt, pos, neg = sum_counts(exists, sign, bits, filt, depth)
    pos = [int(x) for x in pos.cpu()]
    neg = [int(x) for x in neg.cpu()]
    total = sum((1 << i) * (pos[i] - neg[i]) for i in range(depth))
    return total, int(cnt)


def _min_unsigned(bits, filt, depth: int):
    """Reference minUnsigned (fragment.go:1173) over every row of ``filt``:
    (lo, hi, count) per row, the ``bsi_minmax`` kernel."""
    return kernels.bsi_minmax(bits, filt, depth, is_max=False)


def _max_unsigned(bits, filt, depth: int):
    """Reference maxUnsigned (fragment.go:1218), like ``_min_unsigned``."""
    return kernels.bsi_minmax(bits, filt, depth, is_max=True)


def host_min(exists, sign, bits, filt, depth: int) -> tuple[int, int]:
    """(min, count) — reference fragment.min (fragment.go:1146): if any
    negatives exist in the filter, min = -maxUnsigned(negatives)."""
    consider = exists & filt
    if int(kernels.row_counts(consider)) == 0:
        return 0, 0
    neg = sign & consider
    if int(kernels.row_counts(neg)) > 0:
        lo, hi, c = _max_unsigned(bits, neg, depth)
        return -_join_u64(lo, hi), int(c)
    lo, hi, c = _min_unsigned(bits, consider, depth)
    return _join_u64(lo, hi), int(c)


def host_max(exists, sign, bits, filt, depth: int) -> tuple[int, int]:
    """(max, count) — reference fragment.max (fragment.go:1189)."""
    consider = exists & filt
    if int(kernels.row_counts(consider)) == 0:
        return 0, 0
    pos = bitops.b_andnot(consider, sign)
    if int(kernels.row_counts(pos)) == 0:
        lo, hi, c = _min_unsigned(bits, consider, depth)
        return -_join_u64(lo, hi), int(c)
    lo, hi, c = _max_unsigned(bits, pos, depth)
    return _join_u64(lo, hi), int(c)
