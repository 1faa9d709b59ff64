"""The port's kernels and their plain PyTorch versions.

- ``pair_count(a, b, op)`` and ``row_counts(a)`` (``csrc/count_kernels.cu``)
  are the counterparts of pilosa_tpu/ops/pallas_kernels.py: int32
  bit-pattern tensors of shape ``[..., W]`` in, int32 per-row counts out.
- ``bsi_compare`` and ``bsi_minmax`` (``csrc/bsi_kernels.cu``) are the
  bit-serial comparator and min/max descent of pilosa_tpu/ops/bsi.py, which
  the JAX package left to XLA's fusion; ``ops/bsi.py`` builds the BSI
  queries on them.
- ``tree_count(leaves, tape)`` and ``shift_left(a, n)``
  (``csrc/tree_kernels.cu``) are the general bitmap-tree evaluator of
  pilosa_tpu/parallel/planner.py (``_eval_node`` + ``bitops.count``) and
  pilosa_tpu/ops/bitops.py's ``shift_left``, both XLA-fused in the JAX
  package: one pass over a postfix op tape of and/or/xor/andnot over
  ``[..., W]`` leaves, per-row counts out and optionally the result plane;
  and the word roll plus carried bit shift of every row.
- ``pair_count_batched``, ``row_counts_batched`` (``csrc/count_kernels.cu``)
  and ``tree_count_batched`` (``csrc/tree_kernels.cu``) run a wave of B
  same-plan count programs as one launch, each slot on its own operands:
  the counterpart of ``jax.vmap`` of the count program in the JAX
  coalescer (pilosa_tpu/parallel/coalesce.py ``_flush_batched``).
  ``tree_count_batched`` reads each distinct leaf of a slot group once:
  ``group_leaves`` makes the plan it runs on.
- ``assemble_stack`` (``csrc/upload_kernels.cu``) builds an ``[S_pad, W]``
  stack on the device from a few dense rows and COO words grouped by row,
  each tile of it built once and written once: the sparse-upload scatter
  of pilosa_tpu/parallel/planner.py ``_assemble_stack``.
- ``group_count(planes, sizes, filt)`` (``csrc/group_kernels.cu``) counts a
  whole GroupBy lattice -- the product of the levels' rows, ``sizes[l]``
  planes at level l -- in one launch: for each group, the popcount of the
  AND of its row at every level (and the filter) over every shard row,
  int64 totals, each plane read once and the lattice walked as a prefix
  tree: the lattice of
  pilosa_tpu/parallel/planner.py ``execute_group_by``, which the JAX
  package runs as one XLA-fused AND and count per group.
- ``packed_count``, ``packed_and_dense_count``, ``packed_pair_count`` and
  ``packed_expand`` (``csrc/packed_kernels.cu``) read and expand the packed
  residency class's ``[S, K]`` int32 index stacks (sorted, distinct
  in-shard positions, padded with ``PACK_SENTINEL``): the kernel variants
  of pilosa_tpu/exec/residency.py, XLA-fused in the JAX package.
  ``packed_count_batched``, ``packed_and_dense_count_batched`` and
  ``packed_pair_count_batched`` count a wave of B same-shape slots in one
  launch (up to ``PACKED_WAVE_SLOTS`` slots a launch), the slot table
  passed by value: ``jax.vmap`` of the packed count program in the JAX
  coalescer. The single count wrappers launch the same kernels over a
  wave of one.
- ``hll_expand``, ``hll_reduce`` and ``similar_count``
  (``csrc/sketch_kernels.cu``) are the sketch functions of
  pilosa_tpu/sketch/kernels.py, XLA-fused in the JAX package: the masked
  register gather of a filtered Count(Distinct) (``[S, 2^20]`` packed
  ``bucket | rho << 18`` plane and ``[S, W]`` filter words in, ``[S, 2^p]``
  uint8 registers out), the register max over shards, and SimilarTopN's
  three totals over an ``[R, S, W]`` row cube, each cube word read once.
- ``plane_lookup`` (``csrc/keyplane_kernels.cu``) is the key plane's
  leftmost binary search of pilosa_tpu/exec/keyplane.py (``_search`` +
  ``plane_lookup``): ``[3, H]`` int32 (hash hi, hash lo, id) plane and
  ``[Q]`` probe hash halves in, ``[Q]`` ids out, MISS (0) where absent;
  the hash lanes compare as unsigned.
- ``scatter_bits`` and ``or_fold`` (``csrc/reduce_kernels.cu``) are the
  coordinator's device reduce of pilosa_tpu/exec/device_reduce.py,
  XLA-fused in the JAX package: a remote Row leg's unique positions
  (segment index, in-shard offset) into an ``[n_segs + 1, W]`` word image
  whose last row is the padding sink, and the OR over K of a ``[B, K, W]``
  stack of contested shards.

On a CUDA tensor each wrapper launches its hand-written kernel (built at
first use, see ``ops/build.py``) or raises; on a CPU tensor it runs the
plain PyTorch version beside it. There is no fall-back from the card to the
plain version.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, so a run can show that its queries went through the
kernels (``reset_launches()`` zeroes the counts). The HTTP edge launches
from many handler threads at once, so the counts change under a lock and
stay exact.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.ops import bitops

#: kernel launches since the last reset_launches(), by wrapper name; read
#: it, and change it only through _count_launch and reset_launches.
LAUNCHES = {"pair_count": 0, "row_counts": 0, "bsi_compare": 0, "bsi_minmax": 0,
            "tree_count": 0, "shift_left": 0, "pair_count_batched": 0,
            "row_counts_batched": 0, "tree_count_batched": 0, "assemble_stack": 0,
            "group_count": 0, "packed_count": 0, "packed_and_dense_count": 0,
            "packed_pair_count": 0, "packed_expand": 0, "packed_count_batched": 0,
            "packed_and_dense_count_batched": 0, "packed_pair_count_batched": 0,
            "plane_scatter": 0, "hll_expand": 0, "hll_reduce": 0,
            "similar_count": 0, "plane_lookup": 0, "scatter_bits": 0,
            "or_fold": 0}
#: leaf records tree_count_batched's launches were given (slots x tape
#: leaves) and the distinct leaves they read (each slot group's once):
#: how much its waves share.
TREE_BATCH_LEAVES = {"records": 0, "distinct": 0}
_launch_lock = threading.Lock()

_OP_CODES = {"and": 0, "or": 1, "xor": 2, "andnot": 3}
_CMP_CODES = {"lt": 0, "gt": 1, "eq": 2}
#: the deepest magnitude cube a (lo, hi) predicate can describe.
MAX_DEPTH = 63

_PLAIN_OPS = {
    "and": bitops.b_and,
    "or": bitops.b_or,
    "xor": bitops.b_xor,
    "andnot": bitops.b_andnot,
}

_VP, _I64, _I32, _U32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
#: C signatures (argtypes, restype i32) by source file and function.
_SIGNATURES = {
    "count_kernels.cu": {
        "pilosa_pair_count": [_VP, _VP, _VP, _I64, _I64, _I64, _I64, _I64, _I64,
                              _I32, _I32, _VP],
        "pilosa_row_counts": [_VP, _VP, _I64, _I64, _I64, _I32, _VP],
        "pilosa_count_batched": [_VP, _VP, _I32, _VP, _I64, _I64, _I32, _I32, _VP],
    },
    "bsi_kernels.cu": {
        "pilosa_bsi_compare": [_VP, _VP, _VP, _I64, _I64, _I32, _U32, _U32, _I32,
                               _I32, _I32, _VP],
        "pilosa_bsi_minmax": [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64,
                              _I32, _I32, _I32, _VP],
    },
    "tree_kernels.cu": {
        "pilosa_tree_count": [_VP, _VP, _VP, _I32, _VP, _I32, _VP, _VP, _I64,
                              _I64, _I32, _VP],
        "pilosa_shift_left": [_VP, _VP, _I64, _I64, _I64, _I64, _I32, _VP],
        "pilosa_tree_count_batched": [_VP, _VP, _I32, _I32, _I32, _I32, _I32, _VP,
                                      _I32, _VP, _I64, _I64, _I32, _VP],
    },
    "upload_kernels.cu": {
        "pilosa_assemble_stack": [_VP, _VP, _I64, _VP, _VP, _VP, _I64, _VP, _I64,
                                  _I64, _VP],
    },
    "group_kernels.cu": {
        "pilosa_group_count": [_VP, _VP, _I32, _VP, _I32, _VP, _I64, _VP, _I64,
                               _I64, _I32, _VP],
    },
    "packed_kernels.cu": {
        "pilosa_packed_expand": [_VP, _VP, _I64, _I64, _I64, _I64, _VP],
        "pilosa_packed_count_batched": [_VP, _VP, _I32, _VP, _I64, _I64, _I32, _VP],
        "pilosa_packed_and_dense_count_batched": [_VP, _VP, _VP, _VP, _I32, _VP, _I64,
                                                  _I64, _I64, _I32, _VP],
        "pilosa_packed_pair_count_batched": [_VP, _VP, _VP, _VP, _I32, _VP, _I64, _I64,
                                             _I64, _I32, _VP],
    },
    "ingest_kernels.cu": {
        "pilosa_plane_scatter": [_VP, _VP, _I64, _I32, _I64, _VP, _VP],
        "pilosa_plane_scatter_groups": [_I32, _I64, _VP, _VP],
    },
    "sketch_kernels.cu": {
        "pilosa_hll_expand": [_VP, _VP, _VP, _I64, _I64, _I32, _VP],
        "pilosa_hll_reduce": [_VP, _VP, _I64, _I64, _VP],
        "pilosa_similar_count": [_VP, _VP, _VP, _I64, _I64, _VP],
    },
    "keyplane_kernels.cu": {
        "pilosa_plane_lookup": [_VP, _I64, _VP, _VP, _VP, _I64, _VP],
    },
    "reduce_kernels.cu": {
        "pilosa_scatter_bits": [_VP, _VP, _I64, _I64, _I64, _VP, _VP],
        "pilosa_or_fold": [_VP, _I64, _I64, _I64, _VP, _VP],
    },
}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for k in TREE_BATCH_LEAVES:
            TREE_BATCH_LEAVES[k] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _library(source: str = "count_kernels.cu") -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        from pilosa_tpu_torch.ops import build
        lib = build.load(source)
        for fn, argtypes in _SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I32
        _libs[source] = lib
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------


def pair_count_plain(a: torch.Tensor, b: torch.Tensor, op: str = "and") -> torch.Tensor:
    """op, then SWAR popcount on int64, then an int32 row sum."""
    return bitops.count(_PLAIN_OPS[op](a, b))


def row_counts_plain(a: torch.Tensor) -> torch.Tensor:
    return bitops.count(a)


def _pred_mask(lo: int, hi: int, i: int) -> int:
    """Predicate bit ``i`` of ``(hi << 32) | lo`` as an int32 word mask:
    0 or -1 (all ones)."""
    return -(((lo >> i) if i < 32 else (hi >> (i - 32))) & 1)


def compare_unsigned(bits: torch.Tensor, lo: int, hi: int, depth: int):
    """(lt, eq, gt) word masks, each of shape ``bits.shape[1:]``: a bit is
    set in ``lt`` iff that column's magnitude over ``bits[:depth]`` is below
    the predicate ``(hi << 32) | lo``, and so on (pilosa_tpu/ops/bsi.py
    compare_unsigned :50)."""
    shape = bits.shape[1:]
    lt = torch.zeros(shape, dtype=torch.int32, device=bits.device)
    gt = torch.zeros_like(lt)
    eq = torch.full_like(lt, -1)
    for i in range(depth - 1, -1, -1):
        row = bits[i]
        pm = _pred_mask(lo, hi, i)
        lt = lt | (eq & ~row & pm)
        gt = gt | (eq & row & ~pm)
        eq = eq & ~(row ^ pm)
    return lt, eq, gt


def bsi_compare_plain(bits: torch.Tensor, filt: torch.Tensor, lo: int, hi: int,
                      depth: int, op: str, allow_eq: bool) -> torch.Tensor:
    """pilosa_tpu/ops/bsi.py _compare_select (:70): lt / gt (with eq when
    ``allow_eq``) / eq of ``compare_unsigned``, AND ``filt``."""
    lt, eq, gt = compare_unsigned(bits, lo, hi, depth)
    if op == "lt":
        out = (lt | eq) if allow_eq else lt
    elif op == "gt":
        out = (gt | eq) if allow_eq else gt
    else:
        out = eq
    return out & filt


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def bsi_minmax_plain(bits: torch.Tensor, filt: torch.Tensor, depth: int,
                     is_max: bool):
    """pilosa_tpu/ops/bsi.py _min_unsigned / _max_unsigned (:208-257) step
    for step: per row of ``filt``, the greedy descent from bit depth-1 to
    0, as (lo, hi, count) int32 tensors of shape ``filt.shape[:-1]`` (lo
    and hi are the answer's 32-bit halves as bit patterns)."""
    lead = filt.shape[:-1]
    lo = torch.zeros(lead, dtype=torch.int64, device=filt.device)
    hi = torch.zeros_like(lo)
    count = torch.zeros(lead, dtype=torch.int32, device=filt.device)
    for i in range(depth - 1, -1, -1):
        cand = (filt & bits[i]) if is_max else (filt & ~bits[i])
        c = bitops.count(cand)
        has = c > 0
        filt = torch.where(has[..., None], cand, filt)
        addbit = (has if is_max else ~has).to(torch.int64)
        if i < 32:
            lo = lo | (addbit << i)
        else:
            hi = hi | (addbit << (i - 32))
        count = torch.where(has, c, bitops.count(filt) if i == 0 else count)
    return _as_int32_bits(lo), _as_int32_bits(hi), count


#: the tree kernel's limits (csrc/tree_kernels.cu): distinct leaves, tape
#: instructions and stack slots of one launch. A longer or deeper tape is
#: cut into sub-tapes whose planes the same kernel writes.
TREE_MAX_LEAVES = 16
TREE_MAX_OPS = 64
TREE_MAX_STACK = 8

_TREE_CODES = {"and": 1, "or": 2, "xor": 3, "andnot": 4}


def _parse_tape(tape, n_leaves: int):
    """A postfix tape -- leaf indices (ints) and op names -- as a tree of
    ``("leaf", i)`` and ``(op, a, b)`` nodes; raises on a malformed tape."""
    stack = []
    for tok in tape:
        if isinstance(tok, str):
            if tok not in _TREE_CODES:
                raise ValueError(f"unknown tape op {tok!r}")
            if len(stack) < 2:
                raise ValueError(f"tape op {tok!r} needs two operands")
            b = stack.pop()
            stack.append((tok, stack.pop(), b))
        else:
            i = int(tok)
            if isinstance(tok, bool) or not 0 <= i < n_leaves:
                raise ValueError(f"tape leaf {tok!r} out of range for "
                                 f"{n_leaves} leaves")
            stack.append(("leaf", i))
    if len(stack) != 1:
        raise ValueError(f"tape leaves {len(stack)} values on the stack, not 1")
    return stack[0]


def _postfix(node) -> list:
    if node[0] == "leaf":
        return [node[1]]
    return _postfix(node[1]) + _postfix(node[2]) + [node[0]]


def _tree_needs(node) -> tuple[int, int, frozenset]:
    """(tape length, stack depth, distinct leaves) of evaluating ``node``."""
    if node[0] == "leaf":
        return 1, 1, frozenset((node[1],))
    na, da, la = _tree_needs(node[1])
    nb, db, lb = _tree_needs(node[2])
    return na + nb + 1, max(da, db + 1), la | lb


def tree_count_plain(leaves, tape, plane: bool = False):
    """The postfix ``tape`` over ``leaves`` (broadcastable ``[..., W]``
    int32 tensors) with torch bitwise ops, then an int32 row popcount:
    counts of the broadcast leading shape, and with ``plane`` also the
    result ``[*lead, W]``."""
    node = _parse_tape(tape, len(leaves))
    lead = torch.broadcast_shapes(*(x.shape[:-1] for x in leaves))

    def ev(n):
        if n[0] == "leaf":
            return leaves[n[1]]
        return _PLAIN_OPS[n[0]](ev(n[1]), ev(n[2]))

    out = ev(node).expand(*lead, leaves[0].shape[-1])
    counts = bitops.count(out)
    return (counts, out.contiguous()) if plane else counts


def shift_left_plain(a: torch.Tensor, n: int) -> torch.Tensor:
    """pilosa_tpu/ops/bitops.py shift_left (:167): every row of ``a``
    shifted toward higher columns by ``n`` bits -- a whole-word roll, then
    the intra-word shift with its carry -- bits past the row's end falling
    off. The shifts run on int64 so no step depends on int32's arithmetic
    right shift."""
    if n < 0:
        raise ValueError("shift amount must be non-negative")
    words, bits = divmod(int(n), bitops.WORD_BITS)
    w = a.shape[-1]
    v = a.to(torch.int64) & 0xFFFFFFFF
    if words >= w:
        return torch.zeros_like(a)
    if words:
        v = torch.cat([torch.zeros_like(v[..., :words]), v[..., :w - words]], dim=-1)
    if bits:
        hi = (v << bits) & 0xFFFFFFFF
        carry = v >> (bitops.WORD_BITS - bits)
        carry = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]], dim=-1)
        v = hi | carry
    return _as_int32_bits(v)


def pair_count_batched_plain(a_slots, b_slots, op: str = "and") -> torch.Tensor:
    """``pair_count_plain`` slot by slot, stacked to ``[B, *lead]``."""
    return torch.stack([pair_count_plain(a, b, op) for a, b in zip(a_slots, b_slots)])


def row_counts_batched_plain(a_slots) -> torch.Tensor:
    """``row_counts_plain`` slot by slot, stacked to ``[B, *lead]``."""
    return torch.stack([row_counts_plain(a) for a in a_slots])


def tree_count_batched_plain(leaf_tables, tape) -> torch.Tensor:
    """``tree_count_plain`` of one tape over each slot's leaves, stacked to
    ``[B, *lead]``."""
    return torch.stack([tree_count_plain(leaves, tape) for leaves in leaf_tables])


def assemble_stack_plain(didx, dmat, ci, cw, cv, s_pad: int) -> torch.Tensor:
    """pilosa_tpu/parallel/planner.py _assemble_stack (:2046): an
    ``[s_pad, W]`` stack of zeros, dense row k stored at row ``didx[k]``,
    then word ``cv[i]`` at ``(ci[i], cw[i])``. Entries outside the rows
    ``[0, s_pad)`` (the padding aims at row ``s_pad``) or the words
    ``[0, W)`` are skipped, as the kernel skips them."""
    words = dmat.shape[-1]
    out = torch.zeros((s_pad, words), dtype=torch.int32, device=dmat.device)
    keep = (didx >= 0) & (didx < s_pad)
    out.index_put_((didx[keep].long(),), dmat[keep])
    keep = (ci >= 0) & (ci < s_pad) & (cw >= 0) & (cw < words)
    out.index_put_((ci[keep].long(), cw[keep].long()), cv[keep])
    return out


#: rows of the last level one plain-version step takes: bounds its
#: [rows, S, W] temporaries.
_GROUP_CHUNK = 8


def group_count_plain(planes, sizes, filt: torch.Tensor | None = None) -> torch.Tensor:
    """pilosa_tpu/parallel/planner.py execute_group_by (:919-978) without
    its zero-count drop, walked as its ``rec`` walks it (:958-971): the
    levels' rows are ``planes`` in level order, ``sizes[l]`` of them at
    level l; each prefix's AND (the filter's first) is carried down to the
    next level, and each group's AND is popcounted per row as int32, the
    rows widened to int64 and summed. int64 ``[prod(sizes)]`` in
    lexicographic group order."""
    planes = list(planes)
    sizes = [int(n) for n in sizes]
    n_groups = math.prod(sizes)
    device = planes[0].device if planes else torch.device("cpu")
    out = torch.zeros(n_groups, dtype=torch.int64, device=device)
    if n_groups == 0:
        return out
    first = np.cumsum([0] + sizes[:-1]).tolist()
    last = len(sizes) - 1

    def rec(level: int, prefix: torch.Tensor | None, g0: int) -> None:
        rows = planes[first[level]:first[level] + sizes[level]]
        if level == last:
            for lo in range(0, len(rows), _GROUP_CHUNK):
                acc = torch.stack(rows[lo:lo + _GROUP_CHUNK])
                if prefix is not None:
                    acc = acc & prefix
                out[g0 + lo:g0 + lo + len(acc)] = bitops.count(acc).to(torch.int64).sum(dim=-1)
            return
        step = math.prod(sizes[level + 1:])
        for r, row in enumerate(rows):
            rec(level + 1, row if prefix is None else prefix & row, g0 + r * step)

    rec(0, filt, 0)
    return out


#: the padding of a packed index stack: one past the last in-shard
#: position, so ``PACK_SENTINEL >> 5`` is the word just past a row
#: (pilosa_tpu/exec/residency.py SENTINEL).
PACK_SENTINEL = SHARD_WIDTH
#: the most entries of b that packed_pair_count stages in shared memory
#: (``kMaxPairEntries`` in csrc/packed_kernels.cu); the planner's widest
#: packed stack has WORDS_PER_SHARD // 2.
PACK_PAIR_MAX_ENTRIES = 32768


def packed_expand_plain(idx: torch.Tensor, words: int = WORDS_PER_SHARD) -> torch.Tensor:
    """pilosa_tpu/exec/residency.py packed_expand (:158-172): each entry
    ``i`` adds ``1 << (i & 31)`` to word ``i >> 5`` of a zeroed ``[S, W+1]``
    stack, the sentinels landing in the trash word W, which is cut off. The
    sums run on int64 and come back as int32 bit patterns; negative entries
    and entries past the trash word are dropped (the planner makes none).
    The add is an OR only where a row's entries are distinct, as they are
    in the planner's stacks."""
    s = idx.shape[0]
    i = idx.to(torch.int64)
    keep = (i >= 0) & ((i >> 5) <= words)
    rows = torch.arange(s, device=idx.device).unsqueeze(-1).expand_as(i)
    base = torch.zeros((s, words + 1), dtype=torch.int64, device=idx.device)
    base.index_put_((rows[keep], (i >> 5)[keep]), (1 << (i & 31))[keep], accumulate=True)
    return _as_int32_bits(base[:, :words] & 0xFFFFFFFF)


def packed_count_plain(idx: torch.Tensor) -> torch.Tensor:
    """residency.py packed_count (:175-177): entries below the sentinel,
    per row."""
    return (idx < PACK_SENTINEL).sum(dim=-1, dtype=torch.int32)


def packed_and_dense_count_plain(idx: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """residency.py packed_and_dense_count (:180-188): per row, bit
    ``i & 31`` of plane word ``clip(i >> 5, 0, W - 1)`` summed over the
    entries ``i`` below the sentinel."""
    valid = idx < PACK_SENTINEL
    w = torch.clamp(idx >> 5, 0, plane.shape[-1] - 1).long()
    words = torch.gather(plane, -1, w)
    bits = (words >> (idx & 31)) & 1
    return (bits * valid.to(torch.int32)).sum(dim=-1, dtype=torch.int32)


def packed_pair_count_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """residency.py packed_pair_count (:191-203): per row, a's entries
    found in b (sorted) by a leftmost search, clipped to b's last entry, and
    an equality test; a's sentinels never count."""
    pos = torch.searchsorted(b.contiguous(), a.contiguous())
    pos = torch.clamp(pos, 0, b.shape[-1] - 1)
    hit = (torch.gather(b, -1, pos) == a) & (a < PACK_SENTINEL)
    return hit.sum(dim=-1, dtype=torch.int32)


def packed_count_batched_plain(slots) -> torch.Tensor:
    """``packed_count_plain`` slot by slot, stacked to ``[B, S]``."""
    return torch.stack([packed_count_plain(x) for x in slots])


def packed_and_dense_count_batched_plain(idx_slots, plane_slots) -> torch.Tensor:
    """``packed_and_dense_count_plain`` slot by slot, stacked to ``[B, S]``."""
    return torch.stack([packed_and_dense_count_plain(x, p)
                        for x, p in zip(idx_slots, plane_slots)])


def packed_pair_count_batched_plain(a_slots, b_slots) -> torch.Tensor:
    """``packed_pair_count_plain`` slot by slot, stacked to ``[B, S]``."""
    return torch.stack([packed_pair_count_plain(a, b) for a, b in zip(a_slots, b_slots)])


def plane_scatter_plain(pos: torch.Tensor, vals: torch.Tensor,
                        bit_depth: int) -> torch.Tensor:
    """pilosa_tpu/exec/ingest_transpose.py _plane_scatter (:115-142): each
    entry adds ``1 << (pos & 31)`` to word ``pos >> 5`` of row 0 (exists),
    of row 1 where its value is negative, and of row 2 + i where bit i of
    its magnitude is set, i < bit_depth, in a zeroed ``[bit_depth + 2, W]``
    image. The sums run on int64 and come back as int32 bit patterns;
    positions outside ``[0, 32 W)`` are dropped. The add is an OR because
    a batch's positions are distinct. The magnitude's bits come from an
    arithmetic shift of ``|v|``, which for INT64_MIN is the pattern of
    2^63, as the unsigned magnitude is."""
    words = WORDS_PER_SHARD
    p = pos.to(torch.int64)
    keep = (p >= 0) & ((p >> 5) < words)
    p, v = p[keep], vals[keep]
    mag = v.abs()
    shifts = torch.arange(bit_depth, dtype=torch.int64, device=pos.device)
    member = torch.cat([torch.ones((1, len(p)), dtype=torch.bool, device=pos.device),
                        (v < 0).unsqueeze(0),
                        ((mag.unsqueeze(0) >> shifts.unsqueeze(1)) & 1) == 1])
    planes = torch.arange(bit_depth + 2, dtype=torch.int64, device=pos.device)
    idx = planes.unsqueeze(1) * words + (p >> 5).unsqueeze(0)
    bits = (1 << (p & 31)).unsqueeze(0).expand_as(idx)
    out = torch.zeros((bit_depth + 2) * words, dtype=torch.int64, device=pos.device)
    out.index_put_((idx[member],), bits[member], accumulate=True)
    return _as_int32_bits(out.view(bit_depth + 2, words))


#: bit layout of a packed sketch plane entry, ``bucket | rho << RHO_SHIFT``
#: (pilosa_tpu_torch/sketch/hll.py); precisions run from 4 to 18.
RHO_SHIFT = 18
BUCKET_MASK = (1 << RHO_SHIFT) - 1
HLL_MIN_P = 4
HLL_MAX_P = 18


def _filter_bits(filt: torch.Tensor) -> torch.Tensor:
    """``[S, W]`` int32 words -> ``[S, 32 W]`` int32 0/1, bit ``c & 31`` of
    word ``c >> 5`` at column ``c`` (bit 31 of a negative word included)."""
    shifts = torch.arange(32, dtype=torch.int32, device=filt.device)
    return ((filt.unsqueeze(-1) >> shifts) & 1).reshape(filt.shape[0], -1)


def hll_expand_plain(packed: torch.Tensor, filt: torch.Tensor, p: int) -> torch.Tensor:
    """pilosa_tpu/sketch/kernels.py hll_expand: for each column whose filter
    bit is set and whose entry is positive (0 is an absent column), the
    register ``entry & BUCKET_MASK`` of its shard takes the max with
    ``entry >> RHO_SHIFT``; empty registers are 0. An entry whose bucket
    is not below ``2^p`` adds nothing (a plane built at precision p has
    none). ``[S, 2^p]`` uint8."""
    rows, m = packed.shape[0], 1 << p
    keep = (_filter_bits(filt) == 1) & (packed > 0) & ((packed & BUCKET_MASK) < m)
    rho = torch.where(keep, packed >> RHO_SHIFT, 0).to(torch.int64)
    seg = ((packed & BUCKET_MASK).to(torch.int64).clamp(max=m - 1)
           + torch.arange(rows, dtype=torch.int64, device=packed.device).unsqueeze(1) * m)
    regs = torch.zeros(rows * m, dtype=torch.int64, device=packed.device)
    regs.scatter_reduce_(0, seg.reshape(-1), rho.reshape(-1), "amax")
    return regs.reshape(rows, m).to(torch.uint8)


def hll_reduce_plain(regs: torch.Tensor) -> torch.Tensor:
    """Register max over the shard axis of an ``[S, m]`` uint8 stack (zero
    rows are the identity): ``[m]`` uint8."""
    out = torch.zeros(regs.shape[1], dtype=torch.uint8, device=regs.device)
    for row in regs:
        out = torch.maximum(out, row)
    return out


def similar_count_plain(cube: torch.Tensor, filt: torch.Tensor):
    """pilosa_tpu/sketch/kernels.py similar_program's three totals over an
    ``[R, S, W]`` cube and an ``[S, W]`` filter: per row popcount(row AND
    filter) and popcount(row), summed over the shards, and popcount(filter);
    int32 ``[R]``, ``[R]``, ``[]``, summed in int32 as the JAX program sums."""
    inter = bitops.count(cube & filt.unsqueeze(0)).sum(dim=-1, dtype=torch.int32)
    selfc = bitops.count(cube).sum(dim=-1, dtype=torch.int32)
    filtc = bitops.count(filt).sum(dtype=torch.int32)
    return inter, selfc, filtc


def _unsigned(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as their uint32 values, in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def plane_lookup_plain(plane: torch.Tensor, probe_hi: torch.Tensor,
                       probe_lo: torch.Tensor) -> torch.Tensor:
    """pilosa_tpu/exec/keyplane.py _search + plane_lookup: the leftmost slot
    whose unsigned (hi, lo) hash is not below the probe's, by a binary
    search of ``bit_length(H)`` steps over the whole batch, then its id
    where the hash matches, else MISS (0). ``[Q]`` int32."""
    h = plane.shape[1]
    hhi, hlo, ids = _unsigned(plane[0]), _unsigned(plane[1]), plane[2]
    phi, plo = _unsigned(probe_hi), _unsigned(probe_lo)
    lo = torch.zeros(phi.shape, dtype=torch.int64, device=plane.device)
    hi = torch.full(phi.shape, h, dtype=torch.int64, device=plane.device)
    for _ in range(max(1, int(h).bit_length())):
        mid = (lo + hi) >> 1
        at = mid.clamp(max=h - 1)
        mhi = hhi[at]
        less = (mhi < phi) | ((mhi == phi) & (hlo[at] < plo))
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    pos = lo.clamp(0, h - 1)
    hit = (hhi[pos] == phi) & (hlo[pos] == plo)
    return torch.where(hit, ids[pos], torch.zeros_like(ids[pos]))


def scatter_bits_plain(seg: torch.Tensor, local: torch.Tensor, n_segs: int,
                       words: int = WORDS_PER_SHARD) -> torch.Tensor:
    """pilosa_tpu/exec/device_reduce.py _scatter_bits: bit ``local & 31`` of
    word ``local >> 5`` of row ``seg`` in an ``[n_segs + 1, words]`` int32
    image, row ``n_segs`` the padding sink. Entries out of range are
    dropped, and a repeated entry sets its bit once (the JAX function's add
    equals this OR on the unique positions it is given)."""
    seg, local = seg.to(torch.int64), local.to(torch.int64)
    keep = (seg >= 0) & (seg <= n_segs) & (local >= 0) & (local < 32 * words)
    flat = torch.unique(seg[keep] * (32 * words) + local[keep])
    img = torch.zeros((n_segs + 1) * words, dtype=torch.int64, device=seg.device)
    img.index_add_(0, flat >> 5, torch.ones_like(flat) << (flat & 31))
    img = torch.where(img >= 2**31, img - 2**32, img)
    return img.to(torch.int32).reshape(n_segs + 1, words)


def or_fold_plain(stack: torch.Tensor) -> torch.Tensor:
    """pilosa_tpu/exec/device_reduce.py _or_fold: ``[B, K, W]`` -> ``[B, W]``,
    the OR over K (zeros for K = 0)."""
    out = torch.zeros((stack.shape[0], stack.shape[2]), dtype=torch.int32,
                      device=stack.device)
    for j in range(stack.shape[1]):
        out = out | stack[:, j]
    return out


# ---------------------------------------------------------------------------
# shape checks shared by both paths
# ---------------------------------------------------------------------------


def _check_words(x: torch.Tensor, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must hold int32 bit patterns, got {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"{name} must have a non-empty word axis, got {tuple(x.shape)}")
    if x.numel() and x.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along its word axis")


def _row_layout(x: torch.Tensor, lead: torch.Size, name: str) -> tuple[int, int]:
    """(word stride between rows, row count) of ``x`` as the kernel walks
    the flattened broadcast leading shape ``lead``: row ``r`` of the walk
    reads row ``r mod rows`` of ``x``. That covers a single row broadcast
    against every row (stride 0) and an operand whose leading shape is a
    proper suffix of ``lead`` (an ``[S, W]`` row against a ``[D, S, W]``
    cube), neither of them materialised. A 2-D operand keeps its own row
    stride (a row sliced out of a stack); a higher-rank one must be
    contiguous. Any other broadcast is refused."""
    rows = math.prod(x.shape[:-1])
    if rows == 1:
        return 0, 1
    core = tuple(x.shape[:-1])
    while core and core[0] == 1:
        core = core[1:]
    if core != tuple(lead[len(lead) - len(core):]):
        raise ValueError(f"{name} of shape {tuple(x.shape)} broadcasts only "
                         f"partially against rows {tuple(lead)}")
    if len(core) == 1:
        return x.stride(-2), rows
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous when it has more than 2 dims")
    return x.shape[-1], rows


def _vec_ok(x: torch.Tensor, stride: int) -> bool:
    """16-byte loads need an aligned first row and a row stride that keeps
    every row aligned."""
    return x.data_ptr() % 16 == 0 and stride % 4 == 0


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the kernels take CPU or CUDA tensors, got {x.device}")


def _check_cube(bits: torch.Tensor, filt: torch.Tensor, depth: int) -> None:
    """``bits`` is a ``[D, *filt.shape]`` cube of magnitude planes with
    ``depth <= D``, both contiguous, on one device."""
    _check_words(filt, "filt")
    _check_words(bits, "bits")
    if bits.dim() != filt.dim() + 1 or bits.shape[1:] != filt.shape:
        raise ValueError(f"bits {tuple(bits.shape)} must be [depth, "
                         f"*{tuple(filt.shape)}]")
    if not 0 <= depth <= min(bits.shape[0], MAX_DEPTH):
        raise ValueError(f"depth {depth} out of range for {bits.shape[0]} planes")
    if bits.device != filt.device:
        raise ValueError(f"operands on different devices: {bits.device}, {filt.device}")
    if not (bits.is_contiguous() and filt.is_contiguous()):
        raise ValueError("bits and filt must be contiguous")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def pair_count(a: torch.Tensor, b: torch.Tensor, op: str = "and") -> torch.Tensor:
    """Fused ``popcount(op(a, b))`` per row over broadcastable ``[..., W]``
    int32 tensors; op in {and, or, xor, andnot}. A ``[W]`` (or any
    single-row) operand is counted against every row of the other, and an
    ``[S, W]`` operand against every ``[S, W]`` slice of a ``[D, S, W]``
    one, in one launch and without copying it. Returns int32 of the
    broadcast leading shape."""
    if op not in _OP_CODES:
        raise ValueError(f"unknown op {op!r}")
    _check_words(a, "a")
    _check_words(b, "b")
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"word axes differ: {a.shape[-1]} vs {b.shape[-1]}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    try:
        lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    except RuntimeError as e:
        raise ValueError(f"shapes do not broadcast: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}") from e
    sa, ra = _row_layout(a, lead, "a")
    sb, rb = _row_layout(b, lead, "b")
    if a.device.type == "cpu":
        return pair_count_plain(a, b, op)
    _require_cuda(a)
    rows, words = math.prod(lead), a.shape[-1]
    out = torch.zeros(rows, dtype=torch.int32, device=a.device)
    if rows == 0:
        return out.reshape(lead)
    vec = _vec_ok(a, sa) and _vec_ok(b, sb)
    with torch.cuda.device(a.device):
        err = _library().pilosa_pair_count(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, words, sa, sb,
            ra, rb, _OP_CODES[op], int(vec), _stream(a.device))
    if err:
        raise RuntimeError(f"pair_count kernel launch failed: CUDA error {err}")
    _count_launch("pair_count")
    return out.reshape(lead)


def row_counts(a: torch.Tensor) -> torch.Tensor:
    """Per-row popcount over ``[..., W]`` int32; int32 of shape ``a.shape[:-1]``."""
    _check_words(a, "a")
    lead = a.shape[:-1]
    sa, _ = _row_layout(a, lead, "a")
    if a.device.type == "cpu":
        return row_counts_plain(a)
    _require_cuda(a)
    rows, words = math.prod(lead), a.shape[-1]
    out = torch.zeros(rows, dtype=torch.int32, device=a.device)
    if rows == 0:
        return out.reshape(lead)
    with torch.cuda.device(a.device):
        err = _library().pilosa_row_counts(
            a.data_ptr(), out.data_ptr(), rows, words, sa, int(_vec_ok(a, sa)),
            _stream(a.device))
    if err:
        raise RuntimeError(f"row_counts kernel launch failed: CUDA error {err}")
    _count_launch("row_counts")
    return out.reshape(lead)


def bsi_compare(bits: torch.Tensor, filt: torch.Tensor, lo: int, hi: int,
                depth: int, op: str, allow_eq: bool = False) -> torch.Tensor:
    """Bit-serial unsigned compare of every column's magnitude over the
    planes ``bits[:depth]`` (``bits`` is ``[D, *filt.shape]``) against the
    predicate ``(hi << 32) | lo``: the lt, gt (either with eq when
    ``allow_eq``) or eq word mask, AND ``filt``. One pass over the planes,
    one output plane."""
    if op not in _CMP_CODES:
        raise ValueError(f"unknown compare op {op!r}")
    if not (0 <= lo < 2**32 and 0 <= hi < 2**32):
        raise ValueError(f"predicate halves must be uint32, got {lo}, {hi}")
    _check_cube(bits, filt, depth)
    if filt.device.type == "cpu":
        return bsi_compare_plain(bits, filt, lo, hi, depth, op, allow_eq)
    _require_cuda(filt)
    out = torch.empty_like(filt)
    n = filt.numel()
    if n == 0:
        return out
    plane = bits.stride(0)
    vec = (n % 4 == 0 and _vec_ok(bits, plane) and _vec_ok(filt, 0)
           and _vec_ok(out, 0))
    with torch.cuda.device(filt.device):
        err = _library("bsi_kernels.cu").pilosa_bsi_compare(
            bits.data_ptr(), filt.data_ptr(), out.data_ptr(), n, plane, depth,
            lo, hi, _CMP_CODES[op], int(allow_eq), int(vec), _stream(filt.device))
    if err:
        raise RuntimeError(f"bsi_compare kernel launch failed: CUDA error {err}")
    _count_launch("bsi_compare")
    return out


#: the widest row whose candidates bsi_minmax keeps in registers.
_MINMAX_REG_WORDS = 32768


def bsi_minmax(bits: torch.Tensor, filt: torch.Tensor, depth: int,
               is_max: bool):
    """Per row of ``filt`` (``[..., W]``), the min (or max) magnitude over
    ``bits[:depth]`` of its columns by the greedy bit-serial descent, as
    (lo, hi, count) int32 tensors of shape ``filt.shape[:-1]``: the
    answer's 32-bit halves as bit patterns and the reference's count."""
    _check_cube(bits, filt, depth)
    if filt.device.type == "cpu":
        return bsi_minmax_plain(bits, filt, depth, is_max)
    _require_cuda(filt)
    lead, words = filt.shape[:-1], filt.shape[-1]
    rows = math.prod(lead)
    lo, hi, count = (torch.empty(rows, dtype=torch.int32, device=filt.device)
                     for _ in range(3))
    if rows == 0:
        return lo.reshape(lead), hi.reshape(lead), count.reshape(lead)
    plane = bits.stride(0)
    reg = (words % 4 == 0 and words <= _MINMAX_REG_WORDS
           and _vec_ok(bits, plane) and _vec_ok(filt, 0))
    scratch = None if reg else filt.clone()  # holds the candidates in place
    with torch.cuda.device(filt.device):
        err = _library("bsi_kernels.cu").pilosa_bsi_minmax(
            bits.data_ptr(), filt.data_ptr(),
            0 if scratch is None else scratch.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), count.data_ptr(), rows, words, plane,
            depth, int(is_max), int(reg), _stream(filt.device))
    if err:
        raise RuntimeError(f"bsi_minmax kernel launch failed: CUDA error {err}")
    _count_launch("bsi_minmax")
    return lo.reshape(lead), hi.reshape(lead), count.reshape(lead)


def _tree_layout(leaves):
    """(lead shape, per-leaf (row stride, rows)) of the tree kernel's
    operands, after the checks pair_count makes."""
    if not leaves:
        raise ValueError("tree_count needs at least one leaf")
    for k, x in enumerate(leaves):
        _check_words(x, f"leaf {k}")
    words, device = leaves[0].shape[-1], leaves[0].device
    for k, x in enumerate(leaves):
        if x.shape[-1] != words:
            raise ValueError(f"word axes differ: leaf {k} has {x.shape[-1]}, "
                             f"leaf 0 {words}")
        if x.device != device:
            raise ValueError(f"leaves on different devices: {x.device}, {device}")
    try:
        lead = torch.broadcast_shapes(*(x.shape[:-1] for x in leaves))
    except RuntimeError as e:
        raise ValueError("leaf shapes do not broadcast: "
                         f"{[tuple(x.shape) for x in leaves]}") from e
    return lead, [_row_layout(x, lead, f"leaf {k}") for k, x in enumerate(leaves)]


def tree_count(leaves, tape, plane: bool = False):
    """Per-row popcount of a bitmap tree given as a postfix ``tape`` over
    ``leaves``: tape tokens are leaf indices (push) and ``"and"``,
    ``"or"``, ``"xor"``, ``"andnot"`` (pop b, pop a, push op(a, b)).
    Leaves are broadcastable ``[..., W]`` int32 tensors -- a ``[W]`` leaf
    is counted against every row of an ``[S, W]`` one without being
    materialised. Returns int32 counts of the broadcast leading shape, and
    with ``plane`` also the tree's result ``[*lead, W]``. One launch reads
    each leaf once and writes no intermediate plane; a tape past the
    kernel's limits (TREE_MAX_*) is cut into sub-tapes whose planes the
    same kernel writes first."""
    lead, layouts = _tree_layout(leaves)
    node = _parse_tape(tape, len(leaves))
    if leaves[0].device.type == "cpu":
        return tree_count_plain(leaves, tape, plane)
    _require_cuda(leaves[0])
    leaves, layouts = list(leaves), list(layouts)
    node = _fit_tree(node, leaves, layouts, lead)
    return _launch_tree(node, leaves, layouts, lead, plane)


def _fits(node) -> bool:
    n, depth, used = _tree_needs(node)
    return (n <= TREE_MAX_OPS and depth <= TREE_MAX_STACK
            and len(used) <= TREE_MAX_LEAVES)


def _fit_tree(node, leaves: list, layouts: list, lead):
    """``node`` cut to the kernel's limits: subtrees that do not fit are
    evaluated to planes (appended to ``leaves``) by the same kernel and
    stand in the tree as leaves."""
    if _fits(node):
        return node
    op, a, b = node
    a = _fit_tree(a, leaves, layouts, lead)
    b = _fit_tree(b, leaves, layouts, lead)
    while not _fits((op, a, b)):
        # Materialise the larger side; two leaves always fit.
        if a[0] != "leaf" and (b[0] == "leaf"
                               or _tree_needs(a)[0] >= _tree_needs(b)[0]):
            a = _materialise(a, leaves, layouts, lead)
        else:
            b = _materialise(b, leaves, layouts, lead)
    return (op, a, b)


def _materialise(node, leaves: list, layouts: list, lead):
    _, out = _launch_tree(node, leaves, layouts, lead, True)
    leaves.append(out)
    layouts.append(_row_layout(out, lead, "plane"))
    return ("leaf", len(leaves) - 1)


def _encode_tape(node) -> tuple[list[int], list[int]]:
    """The tree kernels' instructions for a tree that fits their limits,
    and the leaf indices the kernel's leaf slots read, in slot order (each
    distinct tape leaf once, in tape order)."""
    slots: dict[int, int] = {}  # leaf index -> the kernel's leaf slot
    code, depth = [], 0
    for tok in _postfix(node):
        if isinstance(tok, str):
            depth -= 1
            code.append(_TREE_CODES[tok] | ((depth - 1) << 4))
        else:
            slot = slots.setdefault(tok, len(slots))
            code.append((depth << 4) | (slot << 8))
            depth += 1
    return code, sorted(slots, key=slots.get)


def _launch_tree(node, leaves: list, layouts: list, lead, plane: bool):
    """One tree_count launch of a tape that fits the kernel's limits."""
    code, used = _encode_tape(node)
    device, words = leaves[0].device, leaves[0].shape[-1]
    rows = math.prod(lead)
    counts = torch.zeros(rows, dtype=torch.int32, device=device)
    out = (torch.empty((*lead, words), dtype=torch.int32, device=device)
           if plane else None)
    if rows == 0:
        return (counts.reshape(lead), out) if plane else counts.reshape(lead)
    vec = words % 4 == 0 and all(_vec_ok(leaves[i], layouts[i][0]) for i in used)
    n = len(used)
    with torch.cuda.device(device):
        err = _library("tree_kernels.cu").pilosa_tree_count(
            (ctypes.c_void_p * n)(*(leaves[i].data_ptr() for i in used)),
            (ctypes.c_int64 * n)(*(layouts[i][0] for i in used)),
            (ctypes.c_int64 * n)(*(layouts[i][1] for i in used)),
            n, (ctypes.c_int32 * len(code))(*code), len(code),
            counts.data_ptr(), None if out is None else out.data_ptr(),
            rows, words, int(vec), _stream(device))
    if err:
        raise RuntimeError(f"tree_count kernel launch failed: CUDA error {err}")
    _count_launch("tree_count")
    counts = counts.reshape(lead)
    return (counts, out) if plane else counts


def shift_left(a: torch.Tensor, n: int) -> torch.Tensor:
    """Every row of ``a`` (``[..., W]`` int32) shifted toward higher
    columns by ``n >= 0`` bits, bits past the row's end falling off
    (``n >= 32 W`` gives zeros); a new contiguous tensor of ``a``'s shape.
    Reads and writes each word once."""
    if isinstance(n, bool) or int(n) != n:
        raise TypeError(f"shift amount must be an int, got {n!r}")
    if n < 0:
        raise ValueError("shift amount must be non-negative")
    _check_words(a, "a")
    lead, words = a.shape[:-1], a.shape[-1]
    if a.dim() > 2 and not a.is_contiguous():
        raise ValueError("a must be contiguous when it has more than 2 dims")
    stride = a.stride(0) if a.dim() == 2 else words
    if a.device.type == "cpu":
        return shift_left_plain(a, n)
    _require_cuda(a)
    out = torch.empty((*lead, words), dtype=torch.int32, device=a.device)
    rows = math.prod(lead)
    if rows == 0:
        return out
    q, b = divmod(int(n), bitops.WORD_BITS)
    with torch.cuda.device(a.device):
        err = _library("tree_kernels.cu").pilosa_shift_left(
            a.data_ptr(), out.data_ptr(), rows, words, stride, q, b,
            _stream(a.device))
    if err:
        raise RuntimeError(f"shift_left kernel launch failed: CUDA error {err}")
    _count_launch("shift_left")
    return out


# ---------------------------------------------------------------------------
# batched wrappers: a wave of B same-plan programs as one launch
# ---------------------------------------------------------------------------


def _slots_lead(slots, what: str):
    """The common (lead shape, words, device) of every slot's operands, after
    the single wrapper's checks; raises when the slots disagree."""
    if not slots:
        raise ValueError(f"{what} needs at least one slot")
    for z, x in enumerate(slots):
        _check_words(x, f"{what} slot {z}")
    first = slots[0]
    for z, x in enumerate(slots):
        if x.shape != first.shape or x.device != first.device:
            raise ValueError(f"{what} slot {z} is {tuple(x.shape)} on {x.device}, "
                             f"slot 0 {tuple(first.shape)} on {first.device}")
    return first.shape[:-1], first.shape[-1], first.device


def _batched_out(n_slots: int, lead, device) -> torch.Tensor:
    return torch.zeros((n_slots, math.prod(lead)), dtype=torch.int32, device=device)


def _launch_count_batched(a_slots, b_slots, op: str, lead, words: int, device,
                          name: str) -> torch.Tensor:
    """One pilosa_count_batched launch; b_slots is None for row counts."""
    rows, n = math.prod(lead), len(a_slots)
    out = _batched_out(n, lead, device)
    if rows == 0:
        return out.reshape(n, *lead)
    table, vec = [], words % 4 == 0
    for z, a in enumerate(a_slots):
        sa, ra = _row_layout(a, lead, f"a slot {z}")
        b = a if b_slots is None else b_slots[z]
        sb, rb = _row_layout(b, lead, f"b slot {z}")
        vec = vec and _vec_ok(a, sa) and _vec_ok(b, sb)
        table += [a.data_ptr(), b.data_ptr(), sa, sb, ra, rb]
    dev_table = torch.empty(len(table), dtype=torch.int64, device=device)
    code = 4 if b_slots is None else _OP_CODES[op]  # 4: count a alone
    with torch.cuda.device(device):
        err = _library().pilosa_count_batched(
            (ctypes.c_int64 * len(table))(*table), dev_table.data_ptr(), n,
            out.data_ptr(), rows, words, code, int(vec), _stream(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _count_launch(name)
    return out.reshape(n, *lead)


def pair_count_batched(a_slots, b_slots, op: str = "and") -> torch.Tensor:
    """``pair_count(a_slots[z], b_slots[z], op)`` for every slot z, in one
    launch: ``[B, *lead]`` int32. Every slot's operands have the shapes of
    slot 0's (a slot may share a tensor with another); op is the same for
    every slot, as it is for a wave of one plan."""
    if op not in _OP_CODES:
        raise ValueError(f"unknown op {op!r}")
    if len(a_slots) != len(b_slots):
        raise ValueError(f"{len(a_slots)} a slots against {len(b_slots)} b slots")
    _, words, device = _slots_lead(a_slots, "a")
    _, b_words, b_device = _slots_lead(b_slots, "b")
    if b_words != words:
        raise ValueError(f"word axes differ: {words} vs {b_words}")
    if b_device != device:
        raise ValueError(f"operands on different devices: {device}, {b_device}")
    try:
        lead = torch.broadcast_shapes(a_slots[0].shape[:-1], b_slots[0].shape[:-1])
    except RuntimeError as e:
        raise ValueError(f"shapes do not broadcast: {tuple(a_slots[0].shape)}, "
                         f"{tuple(b_slots[0].shape)}") from e
    for z, (a, b) in enumerate(zip(a_slots, b_slots)):
        _row_layout(a, lead, f"a slot {z}")
        _row_layout(b, lead, f"b slot {z}")
    if device.type == "cpu":
        return pair_count_batched_plain(a_slots, b_slots, op)
    _require_cuda(a_slots[0])
    return _launch_count_batched(a_slots, b_slots, op, lead, words, device,
                                 "pair_count_batched")


def row_counts_batched(a_slots) -> torch.Tensor:
    """``row_counts(a_slots[z])`` for every slot z, in one launch: ``[B,
    *lead]`` int32; every slot has slot 0's shape."""
    lead, words, device = _slots_lead(a_slots, "a")
    for z, a in enumerate(a_slots):
        _row_layout(a, lead, f"a slot {z}")
    if device.type == "cpu":
        return row_counts_batched_plain(a_slots)
    _require_cuda(a_slots[0])
    return _launch_count_batched(a_slots, None, "and", lead, words, device,
                                 "row_counts_batched")


#: A slot group of tree_count_batched holds at most this many slots and
#: distinct leaves: csrc/tree_kernels.cu kMaxGroupSlots and kMaxGroupLeaves
#: (as many leaves as its shared-memory ring stages at its narrowest
#: tile), which its launch checks.
TREE_BATCH_GROUP_SLOTS = 32
TREE_BATCH_GROUP_LEAVES = 32


class LeafGroups(NamedTuple):
    """A wave's leaves deduplicated and its slots grouped (``group_leaves``)."""
    #: the distinct leaf keys, in order of first use
    leaves: list
    #: (slot_lo, slot_hi, indices into ``leaves``): slots [lo, hi) in order
    groups: list
    #: local[z][k]: slot z's tape leaf k as an index into its group's leaves
    local: list


def leaf_keys(leaves, layouts=None) -> list[tuple[int, int, int]]:
    """Each leaf's record as the batched tree kernel reads it: (base
    address, row stride in words, rows), the walk of ``_row_layout`` over
    the leaves' broadcast leading shape."""
    if layouts is None:
        layouts = _tree_layout(leaves)[1]
    return [(x.data_ptr(), *lay) for x, lay in zip(leaves, layouts)]


def group_leaves(keys, max_leaves: int = TREE_BATCH_GROUP_LEAVES,
                 max_slots: int = TREE_BATCH_GROUP_SLOTS) -> LeafGroups:
    """``keys[z][k]`` is slot z's k-th leaf record, ``(base address, row
    stride, rows)``: two records are one leaf only when all three agree, so
    views of one storage at other offsets or strides stay apart, and a
    ``[W]`` leaf every slot pushes is one leaf. The slots are grouped in
    order, a group closing before a slot that would take it past
    ``max_leaves`` distinct leaves or ``max_slots`` slots."""
    index: dict = {}
    groups, local = [], []
    cur: dict = {}  # distinct index -> place in the open group
    lo = 0
    for z, ks in enumerate(keys):
        ids = [index.setdefault(k, len(index)) for k in ks]
        if len(set(ids)) > max_leaves:
            raise ValueError(f"slot {z} has {len(set(ids))} distinct leaves, a group "
                             f"holds {max_leaves}")
        grows = len(set(ids) - cur.keys())
        if z > lo and (len(cur) + grows > max_leaves or z - lo >= max_slots):
            groups.append((lo, z, tuple(cur)))
            cur, lo = {}, z
        for i in ids:
            cur.setdefault(i, len(cur))
        local.append([cur[i] for i in ids])
    if keys:
        groups.append((lo, len(keys), tuple(cur)))
    return LeafGroups(sorted(index, key=index.get), groups, local)


def _batch_table(plan: LeafGroups) -> list[int]:
    """The kernel's tables, flat (csrc/tree_kernels.cu BatchTables)."""
    table = [v for rec in plan.leaves for v in rec]
    at = 0
    for lo, hi, ls in plan.groups:
        table += [lo, hi, at, at + len(ls)]
        at += len(ls)
    for _, _, ls in plan.groups:
        table += ls
    for m in plan.local:
        table += m
    return table


def tree_count_batched(leaf_tables, tape) -> torch.Tensor:
    """One postfix ``tape`` counted over each slot's leaves (``leaf_tables[z]``,
    the leaves of slot z, each slot's k-th leaf of slot 0's k-th leaf's
    shape), in one launch: ``[B, *lead]`` int32 counts. The wave's leaves
    are deduplicated (``group_leaves``): a leaf several slots push is read
    from device memory once per slot group. A tape past the kernel's limits
    is cut as ``tree_count`` cuts it: the subtrees that do not fit become
    planes, written slot by slot by ``tree_count`` launches, and the rest of
    the tape runs batched over them."""
    if not leaf_tables:
        raise ValueError("tree_count_batched needs at least one slot")
    n_leaves = len(leaf_tables[0])
    lead, layouts0 = _tree_layout(leaf_tables[0])
    node = _parse_tape(tape, n_leaves)
    layouts = [layouts0]
    # Each slot's leaves have slot 0's shapes, so slot 0's lead holds for all.
    for z, leaves in enumerate(leaf_tables[1:], 1):
        if len(leaves) != n_leaves:
            raise ValueError(f"slot {z} has {len(leaves)} leaves, slot 0 {n_leaves}")
        lay = []
        for k, (x, x0) in enumerate(zip(leaves, leaf_tables[0])):
            _check_words(x, f"slot {z} leaf {k}")
            if x.shape != x0.shape or x.device != x0.device:
                raise ValueError(f"slot {z} leaf {k} is {tuple(x.shape)} on "
                                 f"{x.device}, slot 0's {tuple(x0.shape)} on "
                                 f"{x0.device}")
            lay.append(_row_layout(x, lead, f"slot {z} leaf {k}"))
        layouts.append(lay)
    device, words = leaf_tables[0][0].device, leaf_tables[0][0].shape[-1]
    if device.type == "cpu":
        return tree_count_batched_plain(leaf_tables, tape)
    _require_cuda(leaf_tables[0][0])
    # Cutting depends only on the tape, so every slot's cut tree is the same
    # node over its own (extended) leaf list.
    leaf_tables = [list(ls) for ls in leaf_tables]
    layouts = [list(lay) for lay in layouts]
    for leaves, lay in zip(leaf_tables, layouts):
        fitted = _fit_tree(node, leaves, lay, lead)
    code, used = _encode_tape(fitted)
    n, rows = len(leaf_tables), math.prod(lead)
    out = _batched_out(n, lead, device)
    if rows == 0:
        return out.reshape(n, *lead)
    vec = words % 4 == 0 and all(_vec_ok(leaves[i], lay[i][0])
                                 for leaves, lay in zip(leaf_tables, layouts) for i in used)
    plan = group_leaves([leaf_keys([leaves[i] for i in used], [lay[i] for i in used])
                         for leaves, lay in zip(leaf_tables, layouts)])
    table = _batch_table(plan)
    n_gleaves = sum(len(g[2]) for g in plan.groups)
    dev_table = torch.empty(len(table), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _library("tree_kernels.cu").pilosa_tree_count_batched(
            (ctypes.c_int64 * len(table))(*table), dev_table.data_ptr(),
            len(plan.leaves), len(plan.groups), n_gleaves, n, len(used),
            (ctypes.c_int32 * len(code))(*code), len(code), out.data_ptr(), rows, words,
            int(vec), _stream(device))
    if err:
        raise RuntimeError(f"tree_count_batched kernel launch failed: CUDA error {err}")
    _count_launch("tree_count_batched")
    with _launch_lock:
        TREE_BATCH_LEAVES["records"] += n * len(used)
        TREE_BATCH_LEAVES["distinct"] += n_gleaves
    return out.reshape(n, *lead)


def assemble_stack(didx: torch.Tensor, dmat: torch.Tensor, ci: torch.Tensor,
                   cw: torch.Tensor, cv: torch.Tensor, s_pad: int) -> torch.Tensor:
    """An ``[s_pad, W]`` stack built on the device from ``d_pad`` dense rows
    (``dmat`` ``[d_pad, W]``, stored at rows ``didx``) and COO words
    (``cv[i]`` at row ``ci[i]``, word ``cw[i]``), zeros elsewhere. All
    int32, one device. The stack is allocated at ``[s_pad, W]`` and every
    word of it written once; there is no trash row.

    The contract the kernel relies on:
    - ``ci`` is non-decreasing: the COO words come grouped by row, rows
      ascending, the padding (aimed at row ``s_pad``) last. Within a row
      the words may come in any order. A block finds its row's words by a
      search of ``ci``, so words of a row out of its group are dropped;
      this wrapper raises on such ``ci`` where it can look without a sync
      (CPU tensors).
    - Entries whose row lies outside ``[0, s_pad)`` or whose word lies
      outside ``[0, W)`` are dropped, never written elsewhere.
    - Real ``(ci, cw)`` pairs are distinct, and so are the real rows of
      ``didx``: two stores of different values to one word would race. A
      row both dense and COO takes its COO words on top of the dense row.
    The planner's sparse upload (``parallel/planner.py`` ``_build_stack``)
    packs its arguments so."""
    for name, x in (("didx", didx), ("ci", ci), ("cw", cw), ("cv", cv)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    _check_words(dmat, "dmat")
    if dmat.dim() != 2 or dmat.shape[0] != didx.shape[0]:
        raise ValueError(f"dmat {tuple(dmat.shape)} must be [len(didx), W]")
    if not (ci.shape == cw.shape == cv.shape):
        raise ValueError("ci, cw and cv must have one length")
    if isinstance(s_pad, bool) or int(s_pad) != s_pad or s_pad < 0:
        raise ValueError(f"s_pad must be a non-negative int, got {s_pad!r}")
    device = dmat.device
    if any(x.device != device for x in (didx, ci, cw, cv)):
        raise ValueError("assemble_stack operands on different devices")
    if device.type == "cpu":
        if bool((ci[1:] < ci[:-1]).any()):
            raise ValueError("ci must be non-decreasing: the COO words grouped by "
                             "row, rows ascending")
        return assemble_stack_plain(didx, dmat, ci, cw, cv, s_pad)
    _require_cuda(dmat)
    if not all(x.is_contiguous() for x in (didx, dmat, ci, cw, cv)):
        raise ValueError("assemble_stack operands must be contiguous")
    if dmat.numel() and dmat.data_ptr() % 16:
        raise ValueError("dmat must be 16-byte aligned")
    words = dmat.shape[-1]
    out = torch.empty((s_pad, words), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = _library("upload_kernels.cu").pilosa_assemble_stack(
            didx.data_ptr(), dmat.data_ptr(), didx.shape[0], ci.data_ptr(),
            cw.data_ptr(), cv.data_ptr(), ci.shape[0], out.data_ptr(), s_pad,
            words, _stream(device))
    if err:
        raise RuntimeError(f"assemble_stack kernel launch failed: CUDA error {err}")
    _count_launch("assemble_stack")
    return out


#: the most levels (GroupBy children) group_count takes
#: (``kMaxLevels`` in csrc/group_kernels.cu).
GROUP_MAX_LEVELS = 16


def _group_sizes(sizes, n_planes: int) -> list[int]:
    """The level sizes of a lattice over ``n_planes`` planes: 1 to
    GROUP_MAX_LEVELS integers, none negative, summing to ``n_planes``."""
    if isinstance(sizes, (torch.Tensor, np.ndarray)):
        sizes = sizes.tolist()
    out = []
    for n in sizes:
        if isinstance(n, bool) or not isinstance(n, (int, np.integer)):
            raise TypeError(f"sizes must hold integers, got {n!r}")
        out.append(int(n))
    if not 1 <= len(out) <= GROUP_MAX_LEVELS:
        raise ValueError(f"group_count takes 1 to at most {GROUP_MAX_LEVELS} levels, "
                         f"got {len(out)}")
    if min(out) < 0:
        raise ValueError(f"sizes must not be negative, got {out}")
    if sum(out) != n_planes:
        raise ValueError(f"sizes {out} must sum to the {n_planes} planes")
    return out


def group_count(planes, sizes, filt: torch.Tensor | None = None) -> torch.Tensor:
    """The counts of a GroupBy lattice in one launch. ``planes`` are the
    levels' ``[S, W]`` int32 rows in level order, ``sizes[l]`` of them at
    level l (1 to GROUP_MAX_LEVELS levels; a level of 0 rows makes no
    group), and ``filt`` an optional ``[S, W]`` filter plane. The lattice is
    the lexicographic product of the levels: returns int64
    ``[prod(sizes)]``, for each group in that order the popcount of the AND
    of its row at every level (and the filter) over all S rows, each row's
    count an int32 widened before the sum. Zero rows (the planner's pow2
    padding) count 0. The kernel (``csrc/group_kernels.cu``) reads each
    plane once and walks the lattice as a prefix tree."""
    planes = list(planes)
    if not planes:
        raise ValueError("group_count needs at least one plane")
    _check_words(planes[0], "plane 0")
    if planes[0].dim() != 2:
        raise ValueError(f"plane 0 must be [S, W], got {tuple(planes[0].shape)}")
    shape, device = planes[0].shape, planes[0].device
    rows, words = shape
    # One pass over the planes (hundreds of them in a wide lattice): the
    # checks, row bases and strides.
    ptrs, strides = [], []
    for k, x in enumerate(planes):
        if not (isinstance(x, torch.Tensor) and x.dtype == torch.int32 and x.shape == shape
                and x.device == device and (x.stride(1) == 1 or rows == 0)):
            _check_words(x, f"plane {k}")
            raise ValueError(f"plane {k} is {tuple(x.shape)} on {x.device}, "
                             f"plane 0 {tuple(shape)} on {device}")
        ptrs.append(x.data_ptr())
        strides.append(x.stride(0))
    if filt is not None:
        _check_words(filt, "filt")
        if filt.shape != planes[0].shape or filt.device != device:
            raise ValueError(f"filt {tuple(filt.shape)} must match the planes "
                             f"{tuple(planes[0].shape)}")
    sizes = _group_sizes(sizes, len(planes))
    if device.type == "cpu":
        return group_count_plain(planes, sizes, filt)
    _require_cuda(planes[0])
    n_groups = math.prod(sizes)
    out = torch.zeros(n_groups, dtype=torch.int64, device=device)
    if n_groups == 0 or rows == 0:
        return out
    vec = (words % 4 == 0 and all(p % 16 == 0 for p in ptrs)
           and all(st % 4 == 0 for st in strides))
    f_stride = 0
    if filt is not None:
        f_stride = filt.stride(0)
        vec = vec and _vec_ok(filt, f_stride)
    table = np.asarray(ptrs + strides, dtype=np.int64)
    level_sizes = np.asarray(sizes, dtype=np.int64)
    dev_table = torch.empty(len(table), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _library("group_kernels.cu").pilosa_group_count(
            table.ctypes.data, dev_table.data_ptr(), len(planes), level_sizes.ctypes.data,
            len(sizes), None if filt is None else filt.data_ptr(), f_stride, out.data_ptr(),
            rows, words, int(vec), _stream(device))
    if err:
        raise RuntimeError(f"group_count kernel launch failed: CUDA error {err}")
    _count_launch("group_count")
    return out


# ---------------------------------------------------------------------------
# the packed residency class's kernels
# ---------------------------------------------------------------------------


def _check_packed(x: torch.Tensor, name: str) -> None:
    """``x`` is an ``[S, K]`` int32 index stack, K > 0, contiguous along K
    (rows may be a slice of a wider stack)."""
    _check_words(x, name)
    if x.dim() != 2:
        raise ValueError(f"{name} must be an [S, K] index stack, got {tuple(x.shape)}")


def packed_count(idx: torch.Tensor) -> torch.Tensor:
    """Per row of an ``[S, K]`` packed stack, its entries below
    PACK_SENTINEL: the set bits of a packed row, never expanded. int32
    ``[S]``. The kernel counts every entry, so it agrees with
    ``packed_count_plain`` on any input."""
    _check_packed(idx, "idx")
    if idx.device.type == "cpu":
        return packed_count_plain(idx)
    _require_cuda(idx)
    return _launch_packed_wave("packed_count", "packed_count", [[idx]], idx.shape[0],
                               (idx.shape[1],), idx.device)[0]


def packed_and_dense_count(idx: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """|packed AND dense| per row: for each entry ``i`` of ``idx``'s row
    below PACK_SENTINEL, bit ``i & 31`` of word ``clip(i >> 5, 0, W - 1)``
    of ``plane``'s row (``[S, K]`` against ``[S, W]``, int32 both). int32
    ``[S]``; equal to the plain version on any input."""
    _check_packed(idx, "idx")
    _check_words(plane, "plane")
    if plane.dim() != 2 or plane.shape[0] != idx.shape[0]:
        raise ValueError(f"plane {tuple(plane.shape)} must be [S, W] with the "
                         f"{idx.shape[0]} rows of idx")
    if idx.device != plane.device:
        raise ValueError(f"operands on different devices: {idx.device}, {plane.device}")
    if idx.device.type == "cpu":
        return packed_and_dense_count_plain(idx, plane)
    _require_cuda(idx)
    return _launch_packed_wave("packed_and_dense_count", "packed_and_dense_count",
                               [[idx], [plane]], idx.shape[0], (idx.shape[1], plane.shape[1]),
                               idx.device)[0]


def packed_pair_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|packed AND packed| per row of ``[S, Ka]`` and ``[S, Kb]`` stacks
    (Ka and Kb may differ): a's entries below PACK_SENTINEL that b's row
    holds, found by a leftmost binary search. b's rows must be sorted (the
    planner's are); at most PACK_PAIR_MAX_ENTRIES entries of b a row on
    the card. int32 ``[S]``."""
    _check_packed(a, "a")
    _check_packed(b, "b")
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must have one row count")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.device.type == "cpu":
        return packed_pair_count_plain(a, b)
    _require_cuda(a)
    if b.shape[1] > PACK_PAIR_MAX_ENTRIES:
        raise ValueError(f"b has {b.shape[1]} entries a row; the kernel stages at "
                         f"most {PACK_PAIR_MAX_ENTRIES}")
    return _launch_packed_wave("packed_pair_count", "packed_pair_count", [[a], [b]],
                               a.shape[0], (a.shape[1], b.shape[1]), a.device)[0]


#: Slots one launch of a packed wave kernel takes (``kWaveSlots`` in
#: csrc/packed_kernels.cu): the coalescer's largest wave
#: (``parallel/coalesce.py`` MAX_BATCH). A longer wave is split into the
#: fewest launches that hold it, each one counted in LAUNCHES.
PACKED_WAVE_SLOTS = 32


def _packed_slots(slots, what: str) -> torch.Tensor:
    """Slot 0 of a wave of ``[S, K]`` int32 stacks, after the single
    wrapper's checks on every slot; every slot must have slot 0's shape
    and device (strides may differ, and slots may share a tensor)."""
    _slots_lead(slots, what)
    _check_packed(slots[0], f"{what} slot 0")
    return slots[0]


def _launch_packed_wave(kernel: str, name: str, operands, rows: int, shape_args,
                        device) -> torch.Tensor:
    """``pilosa_<kernel>_batched`` over a wave (a single call is a wave of
    one), each launch counted as ``name``: each list of ``operands`` passes
    as a host array of the slots' base addresses and one of their row
    strides, by value; ``shape_args`` follow the output. ``[B, rows]``
    int32."""
    n = len(operands[0])
    out = torch.empty((n, rows), dtype=torch.int32, device=device)
    if rows == 0:
        return out
    tables = []
    for slots in operands:
        tables += [(ctypes.c_void_p * n)(*[x.data_ptr() for x in slots]),
                   (ctypes.c_int64 * n)(*[x.stride(0) for x in slots])]
    with torch.cuda.device(device):
        err = getattr(_library("packed_kernels.cu"), f"pilosa_{kernel}_batched")(
            *tables, n, out.data_ptr(), rows, *shape_args, PACK_SENTINEL, _stream(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    for _ in range(-(-n // PACKED_WAVE_SLOTS)):
        _count_launch(name)
    return out


def packed_count_batched(slots) -> torch.Tensor:
    """``packed_count(slots[z])`` for every slot z of a wave: ``[B, S]``
    int32, one launch for up to PACKED_WAVE_SLOTS slots."""
    first = _packed_slots(slots, "idx")
    if first.device.type == "cpu":
        return packed_count_batched_plain(slots)
    _require_cuda(first)
    return _launch_packed_wave("packed_count", "packed_count_batched", [slots], first.shape[0],
                               (first.shape[1],), first.device)


def packed_and_dense_count_batched(idx_slots, plane_slots) -> torch.Tensor:
    """``packed_and_dense_count(idx_slots[z], plane_slots[z])`` for every
    slot z of a wave: ``[B, S]`` int32, one launch for up to
    PACKED_WAVE_SLOTS slots. The slots of a Count wave often push one
    plane (``Intersect(Row(f=k), Row(g=1))`` for several k)."""
    if len(idx_slots) != len(plane_slots):
        raise ValueError(f"{len(idx_slots)} idx slots against {len(plane_slots)} "
                         "plane slots")
    first = _packed_slots(idx_slots, "idx")
    plane = _packed_slots(plane_slots, "plane")
    if plane.shape[0] != first.shape[0]:
        raise ValueError(f"plane {tuple(plane.shape)} must be [S, W] with the "
                         f"{first.shape[0]} rows of idx")
    if first.device != plane.device:
        raise ValueError(f"operands on different devices: {first.device}, {plane.device}")
    if first.device.type == "cpu":
        return packed_and_dense_count_batched_plain(idx_slots, plane_slots)
    _require_cuda(first)
    rows, k = first.shape
    return _launch_packed_wave("packed_and_dense_count", "packed_and_dense_count_batched",
                               [idx_slots, plane_slots], rows, (k, plane.shape[1]),
                               first.device)


def packed_pair_count_batched(a_slots, b_slots) -> torch.Tensor:
    """``packed_pair_count(a_slots[z], b_slots[z])`` for every slot z of a
    wave: ``[B, S]`` int32, one launch for up to PACKED_WAVE_SLOTS slots.
    b's rows must be sorted; at most PACK_PAIR_MAX_ENTRIES entries of b a
    row on the card."""
    if len(a_slots) != len(b_slots):
        raise ValueError(f"{len(a_slots)} a slots against {len(b_slots)} b slots")
    a = _packed_slots(a_slots, "a")
    b = _packed_slots(b_slots, "b")
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must have one row count")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.device.type == "cpu":
        return packed_pair_count_batched_plain(a_slots, b_slots)
    _require_cuda(a)
    if b.shape[1] > PACK_PAIR_MAX_ENTRIES:
        raise ValueError(f"b has {b.shape[1]} entries a row; the kernel stages at "
                         f"most {PACK_PAIR_MAX_ENTRIES}")
    return _launch_packed_wave("packed_pair_count", "packed_pair_count_batched",
                               [a_slots, b_slots], a.shape[0], (a.shape[1], b.shape[1]),
                               a.device)


def packed_expand(idx: torch.Tensor, words: int = WORDS_PER_SHARD) -> torch.Tensor:
    """The ``[S, words]`` int32 dense planes of an ``[S, K]`` packed stack:
    bit ``i & 31`` of word ``i >> 5`` set for each entry ``i`` below
    ``32 * words``; the sentinels set nothing. A row's entries must be
    distinct (the planner's are): the kernel ORs where the JAX function
    adds. Every output word is written once."""
    _check_packed(idx, "idx")
    if isinstance(words, bool) or int(words) != words or words <= 0:
        raise ValueError(f"words must be a positive int, got {words!r}")
    if idx.device.type == "cpu":
        return packed_expand_plain(idx, words)
    _require_cuda(idx)
    rows, k = idx.shape
    out = torch.empty((rows, words), dtype=torch.int32, device=idx.device)
    if rows == 0:
        return out
    with torch.cuda.device(idx.device):
        err = _library("packed_kernels.cu").pilosa_packed_expand(
            idx.data_ptr(), out.data_ptr(), rows, k, idx.stride(0), words,
            _stream(idx.device))
    if err:
        raise RuntimeError(f"packed_expand kernel launch failed: CUDA error {err}")
    _count_launch("packed_expand")
    return out


def plane_scatter(pos: torch.Tensor, vals: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """The ``[bit_depth + 2, W]`` int32 BSI plane image of one shard's
    batch: ``pos`` ``[M]`` int32 distinct in-shard positions, ``vals``
    ``[M]`` int64 values on the same device; row 0 exists, row 1 sign, row
    2 + i magnitude bit i. The kernel ORs where the JAX function adds,
    which agree on distinct positions. On the card it is one launch, and
    the kernel writes every word of the image once (the image is
    allocated, never zeroed); an empty batch launches too."""
    for x, name, dtype in ((pos, "pos", torch.int32), (vals, "vals", torch.int64)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dtype != dtype or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D {dtype} tensor, got {x.dtype} "
                            f"{tuple(x.shape)}")
    if pos.shape != vals.shape or pos.device != vals.device:
        raise ValueError(f"pos {tuple(pos.shape)} on {pos.device} and vals "
                         f"{tuple(vals.shape)} on {vals.device} must match")
    if isinstance(bit_depth, bool) or int(bit_depth) != bit_depth or not (
            0 <= bit_depth <= MAX_DEPTH):
        raise ValueError(f"bit_depth must be an int in [0, {MAX_DEPTH}], got {bit_depth!r}")
    if pos.device.type == "cpu":
        return plane_scatter_plain(pos, vals, bit_depth)
    _require_cuda(pos)
    pos, vals = pos.contiguous(), vals.contiguous()
    out = torch.empty((bit_depth + 2, WORDS_PER_SHARD), dtype=torch.int32,
                      device=pos.device)
    with torch.cuda.device(pos.device):
        err = _library("ingest_kernels.cu").pilosa_plane_scatter(
            pos.data_ptr(), vals.data_ptr(), len(pos), int(bit_depth),
            WORDS_PER_SHARD, out.data_ptr(), _stream(pos.device))
    if err:
        raise RuntimeError(f"plane_scatter kernel launch failed: CUDA error {err}")
    _count_launch("plane_scatter")
    return out


def plane_scatter_groups(bit_depth: int, device: torch.device) -> tuple[int, int]:
    """(clusters, planes a cluster) of ``plane_scatter``'s launch at this
    depth on the CUDA ``device``: the planes split in as many groups as
    the card runs thread-block clusters at once, a cluster each (the last
    may hold fewer). Launches nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"plane_scatter's plane groups are the card's, got {device}")
    groups, per = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _library("ingest_kernels.cu").pilosa_plane_scatter_groups(
            int(bit_depth), WORDS_PER_SHARD, ctypes.byref(groups), ctypes.byref(per))
    if err:
        raise RuntimeError(f"plane_scatter_groups failed: CUDA error {err}")
    return groups.value, per.value


# ---------------------------------------------------------------------------
# the sketch kernels and the key plane's lookup
# ---------------------------------------------------------------------------


def _check_p(p: int) -> int:
    if isinstance(p, bool) or int(p) != p or not HLL_MIN_P <= p <= HLL_MAX_P:
        raise ValueError(f"precision must be an int in [{HLL_MIN_P}, {HLL_MAX_P}], "
                         f"got {p!r}")
    return int(p)


def _aligned(x: torch.Tensor, align: int = 16) -> torch.Tensor:
    """``x`` contiguous, its first element on an ``align``-byte boundary."""
    x = x.contiguous()
    return x if x.data_ptr() % align == 0 else x.clone()


def hll_expand(packed: torch.Tensor, filt: torch.Tensor, p: int) -> torch.Tensor:
    """The ``[S, 2^p]`` uint8 HLL registers of each shard's filtered
    columns: ``packed`` is the ``[S, 32 W]`` int32 plane of ``bucket | rho
    << 18`` entries (0 for an absent column), ``filt`` the ``[S, W]`` int32
    filter words. One launch on the card: a block a shard streams its
    filter through shared memory and gathers only the plane's 16-byte
    spans that hold a filtered column; every output byte is written by the
    kernel (no zero fill ahead of it)."""
    p = _check_p(p)
    _check_words(packed, "packed")
    _check_words(filt, "filt")
    if packed.dim() != 2 or filt.dim() != 2 or packed.shape[0] != filt.shape[0] \
            or packed.shape[1] != 32 * filt.shape[1] or filt.shape[1] % 32:
        raise ValueError(f"packed {tuple(packed.shape)} must be [S, 32 W] against "
                         f"filt {tuple(filt.shape)} [S, W], W a multiple of 32")
    if packed.device != filt.device:
        raise ValueError(f"operands on different devices: {packed.device}, {filt.device}")
    if packed.device.type == "cpu":
        return hll_expand_plain(packed, filt, p)
    _require_cuda(packed)
    rows, words = filt.shape
    out = torch.empty((rows, 1 << p), dtype=torch.uint8, device=packed.device)
    if rows == 0:
        return out
    packed, filt = _aligned(packed), _aligned(filt)  # filt: the kernel's bulk copies
    with torch.cuda.device(packed.device):
        err = _library("sketch_kernels.cu").pilosa_hll_expand(
            packed.data_ptr(), filt.data_ptr(), out.data_ptr(), rows, words, p,
            _stream(packed.device))
    if err:
        raise RuntimeError(f"hll_expand kernel launch failed: CUDA error {err}")
    _count_launch("hll_expand")
    return out


def hll_reduce(regs: torch.Tensor) -> torch.Tensor:
    """Register max over the shard axis: ``[S, m]`` uint8 (m = 2^p, p >= 4)
    -> ``[m]`` uint8; zero rows are the identity. One launch on the card,
    every output word written once."""
    if not isinstance(regs, torch.Tensor):
        raise TypeError(f"regs must be a torch.Tensor, got {type(regs).__name__}")
    if regs.dtype != torch.uint8 or regs.dim() != 2:
        raise TypeError(f"regs must be an [S, m] uint8 tensor, got {regs.dtype} "
                        f"{tuple(regs.shape)}")
    m = regs.shape[1]
    if m < 1 << HLL_MIN_P or m & (m - 1):
        raise ValueError(f"register files must hold 2^p registers, p >= {HLL_MIN_P}; "
                         f"got {m}")
    if regs.device.type == "cpu":
        return hll_reduce_plain(regs)
    _require_cuda(regs)
    if regs.shape[0] == 0:
        return torch.zeros(m, dtype=torch.uint8, device=regs.device)
    out = torch.empty(m, dtype=torch.uint8, device=regs.device)
    regs = _aligned(regs, 4)
    with torch.cuda.device(regs.device):
        err = _library("sketch_kernels.cu").pilosa_hll_reduce(
            regs.data_ptr(), out.data_ptr(), regs.shape[0], m, _stream(regs.device))
    if err:
        raise RuntimeError(f"hll_reduce kernel launch failed: CUDA error {err}")
    _count_launch("hll_reduce")
    return out


def similar_count(cube: torch.Tensor, filt: torch.Tensor):
    """SimilarTopN's totals in one pass over an ``[R, S, W]`` int32 row cube
    and its ``[S, W]`` filter: (inter ``[R]``, selfc ``[R]``, filtc ``[]``),
    int32 -- per row popcount(row AND filter) and popcount(row) summed over
    the shards, and popcount(filter). Each cube word is read once."""
    _check_words(cube, "cube")
    _check_words(filt, "filt")
    if cube.dim() != filt.dim() + 1 or cube.shape[1:] != filt.shape or filt.shape[-1] % 32:
        raise ValueError(f"cube {tuple(cube.shape)} must be [R, *{tuple(filt.shape)}], "
                         "its last axis a multiple of 32 words")
    if cube.device != filt.device:
        raise ValueError(f"operands on different devices: {cube.device}, {filt.device}")
    if cube.device.type == "cpu":
        return similar_count_plain(cube, filt)
    _require_cuda(cube)
    r, n = cube.shape[0], filt.numel()
    out = torch.zeros(2 * r + 1, dtype=torch.int32, device=cube.device)
    if r and n:
        cube, filt = _aligned(cube), _aligned(filt)
        with torch.cuda.device(cube.device):
            err = _library("sketch_kernels.cu").pilosa_similar_count(
                cube.data_ptr(), filt.data_ptr(), out.data_ptr(), r, n, _stream(cube.device))
        if err:
            raise RuntimeError(f"similar_count kernel launch failed: CUDA error {err}")
        _count_launch("similar_count")
    return out[:r], out[r:2 * r], out[2 * r]


def plane_lookup(plane: torch.Tensor, probe_hi: torch.Tensor,
                 probe_lo: torch.Tensor) -> torch.Tensor:
    """Each probe's id in a key plane: ``plane`` ``[3, H]`` int32 (hash hi,
    hash lo, id lanes, sorted by the unsigned 64-bit hash), ``probe_hi`` and
    ``probe_lo`` ``[Q]`` int32 hash halves; ``[Q]`` int32 ids, MISS (0)
    where the hash is absent, the leftmost slot where it repeats. One
    launch on the card, one thread a probe: the plane's top search levels
    from a fence table in each block's shared memory, then interpolated
    reads of whole 32-byte sectors of the high lane."""
    for x, name in ((plane, "plane"), (probe_hi, "probe_hi"), (probe_lo, "probe_lo")):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must hold int32 bit patterns, got {x.dtype}")
    if plane.dim() != 2 or plane.shape[0] != 3 or plane.shape[1] == 0:
        raise ValueError(f"plane must be [3, H] with H > 0, got {tuple(plane.shape)}")
    if probe_hi.dim() != 1 or probe_hi.shape != probe_lo.shape:
        raise ValueError(f"probe halves must be [Q] each, got {tuple(probe_hi.shape)}, "
                         f"{tuple(probe_lo.shape)}")
    if not (plane.device == probe_hi.device == probe_lo.device):
        raise ValueError("plane and probes must lie on one device")
    if plane.device.type == "cpu":
        return plane_lookup_plain(plane, probe_hi, probe_lo)
    _require_cuda(plane)
    q = probe_hi.shape[0]
    out = torch.empty(q, dtype=torch.int32, device=plane.device)
    if q == 0:
        return out
    plane, probe_hi, probe_lo = _aligned(plane), probe_hi.contiguous(), probe_lo.contiguous()
    with torch.cuda.device(plane.device):
        err = _library("keyplane_kernels.cu").pilosa_plane_lookup(
            plane.data_ptr(), plane.shape[1], probe_hi.data_ptr(), probe_lo.data_ptr(),
            out.data_ptr(), q, _stream(plane.device))
    if err:
        raise RuntimeError(f"plane_lookup kernel launch failed: CUDA error {err}")
    _count_launch("plane_lookup")
    return out


# ---------------------------------------------------------------------------
# the coordinator's device reduce
# ---------------------------------------------------------------------------


def scatter_bits(seg: torch.Tensor, local: torch.Tensor, n_segs: int,
                 words: int = WORDS_PER_SHARD) -> torch.Tensor:
    """A remote Row leg's word blocks in one program: ``seg`` and ``local``
    ``[N]`` int32 (segment index, in-shard offset) of unique positions;
    ``[n_segs + 1, words]`` int32 out, bit ``local & 31`` of word
    ``local >> 5`` of row ``seg``, row ``n_segs`` the padding sink, entries
    out of range dropped. On the card the image is zeroed on the stream,
    then one launch ORs each position's bit into its word."""
    for x, name in ((seg, "seg"), (local, "local")):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dtype != torch.int32 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got {x.dtype} "
                            f"{tuple(x.shape)}")
    if seg.shape != local.shape or seg.device != local.device:
        raise ValueError(f"seg {tuple(seg.shape)} on {seg.device} and local "
                         f"{tuple(local.shape)} on {local.device} must match")
    for v, name in ((n_segs, "n_segs"), (words, "words")):
        if isinstance(v, bool) or int(v) != v or v < 0:
            raise ValueError(f"{name} must be a non-negative int, got {v!r}")
    if words == 0:
        raise ValueError("words must be positive")
    if seg.device.type == "cpu":
        return scatter_bits_plain(seg, local, n_segs, words)
    _require_cuda(seg)
    seg, local = seg.contiguous(), local.contiguous()
    out = torch.empty((n_segs + 1, words), dtype=torch.int32, device=seg.device)
    with torch.cuda.device(seg.device):
        err = _library("reduce_kernels.cu").pilosa_scatter_bits(
            seg.data_ptr(), local.data_ptr(), len(seg), int(n_segs), int(words),
            out.data_ptr(), _stream(seg.device))
    if err:
        raise RuntimeError(f"scatter_bits kernel launch failed: CUDA error {err}")
    _count_launch("scatter_bits")
    return out


def or_fold(stack: torch.Tensor) -> torch.Tensor:
    """``[B, K, W]`` int32 -> ``[B, W]``, the OR over K: one launch on the
    card, each input word read once and each output word written once, four
    words a thread (W a multiple of 4: every caller folds whole shards)."""
    _check_words(stack, "stack")
    if stack.dim() != 3 or stack.shape[2] % 4:
        raise ValueError(f"stack must be [B, K, W], W a multiple of 4, got "
                         f"{tuple(stack.shape)}")
    if stack.device.type == "cpu":
        return or_fold_plain(stack)
    _require_cuda(stack)
    b, k, w = stack.shape
    stack = _aligned(stack)  # the kernel's 16-byte loads
    out = torch.empty((b, w), dtype=torch.int32, device=stack.device)
    if k == 0:
        return out.zero_()
    with torch.cuda.device(stack.device):
        err = _library("reduce_kernels.cu").pilosa_or_fold(
            stack.data_ptr(), b, k, w, out.data_ptr(), _stream(stack.device))
    if err:
        raise RuntimeError(f"or_fold kernel launch failed: CUDA error {err}")
    _count_launch("or_fold")
    return out
