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
- ``group_count(planes, table, filt)`` (``csrc/group_kernels.cu``) counts a
  whole GroupBy lattice in one launch: for each group, the popcount of the
  AND of its row at every level (and the filter) over every shard row,
  int64 totals, each distinct plane read once: the lattice of
  pilosa_tpu/parallel/planner.py ``execute_group_by``, which the JAX
  package runs as one XLA-fused AND and count per group.

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

from pilosa_tpu_torch.ops import bitops

#: kernel launches since the last reset_launches(), by wrapper name; read
#: it, and change it only through _count_launch and reset_launches.
LAUNCHES = {"pair_count": 0, "row_counts": 0, "bsi_compare": 0, "bsi_minmax": 0,
            "tree_count": 0, "shift_left": 0, "pair_count_batched": 0,
            "row_counts_batched": 0, "tree_count_batched": 0, "assemble_stack": 0,
            "group_count": 0}
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
        "pilosa_group_count": [_VP, _VP, _I32, _I32, _I32, _VP, _I64, _VP, _I64,
                               _I64, _I32, _VP],
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


#: groups of one plain-version step: bounds its [groups, S, W] temporaries.
_GROUP_CHUNK = 8


def group_count_plain(planes, table: torch.Tensor,
                      filt: torch.Tensor | None = None) -> torch.Tensor:
    """pilosa_tpu/parallel/planner.py execute_group_by (:919-978) without
    its zero-count drop: for each group g, the AND of ``planes[table[g, l]]``
    over the levels l (and ``filt``), popcounted per row as int32, the rows
    widened to int64 and summed. int64 ``[G]``."""
    stack = torch.stack(list(planes))  # [P, S, W]
    idx = table.to(device=stack.device, dtype=torch.int64)
    out = torch.zeros(idx.shape[0], dtype=torch.int64, device=stack.device)
    for lo in range(0, idx.shape[0], _GROUP_CHUNK):
        sel = idx[lo:lo + _GROUP_CHUNK]
        acc = stack[sel[:, 0]]
        for lvl in range(1, sel.shape[1]):
            acc = acc & stack[sel[:, lvl]]
        if filt is not None:
            acc = acc & filt
        out[lo:lo + len(sel)] = bitops.count(acc).to(torch.int64).sum(dim=-1)
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


def group_count(planes, table, filt: torch.Tensor | None = None) -> torch.Tensor:
    """The counts of a GroupBy lattice in one launch: ``planes`` are the
    distinct ``[S, W]`` int32 planes (each level's rows), ``table`` a
    ``[G, L]`` integer tensor (or array) of plane indices, group g's row at
    each level, and ``filt`` an optional ``[S, W]`` filter plane. Returns
    int64 ``[G]``: for each group the popcount of the AND of its planes
    (and the filter) over all S rows, each row's count an int32 widened
    before the sum. Zero rows (the planner's pow2 padding) count 0. The
    kernel reads each distinct plane once (``csrc/group_kernels.cu``);
    ``L`` is at most GROUP_MAX_LEVELS."""
    planes = list(planes)
    if not planes:
        raise ValueError("group_count needs at least one plane")
    for k, x in enumerate(planes):
        _check_words(x, f"plane {k}")
        if x.dim() != 2:
            raise ValueError(f"plane {k} must be [S, W], got {tuple(x.shape)}")
    rows, words = planes[0].shape
    device = planes[0].device
    for k, x in enumerate(planes):
        if x.shape != planes[0].shape or x.device != device:
            raise ValueError(f"plane {k} is {tuple(x.shape)} on {x.device}, "
                             f"plane 0 {tuple(planes[0].shape)} on {device}")
    if filt is not None:
        _check_words(filt, "filt")
        if filt.shape != planes[0].shape or filt.device != device:
            raise ValueError(f"filt {tuple(filt.shape)} must match the planes "
                             f"{tuple(planes[0].shape)}")
    table = torch.as_tensor(table)
    if table.dim() != 2 or table.shape[1] == 0:
        raise ValueError(f"table must be [G, L] with L >= 1, got {tuple(table.shape)}")
    if table.dtype.is_floating_point or table.dtype == torch.bool:
        raise TypeError(f"table must hold integer plane indices, got {table.dtype}")
    if table.shape[1] > GROUP_MAX_LEVELS:
        raise ValueError(f"group_count takes at most {GROUP_MAX_LEVELS} levels, "
                         f"got {table.shape[1]}")
    host = table.cpu().to(torch.int64)
    if host.numel() and (int(host.min()) < 0 or int(host.max()) >= len(planes)):
        raise ValueError(f"table indices must lie in [0, {len(planes)})")
    if device.type == "cpu":
        return group_count_plain(planes, host, filt)
    _require_cuda(planes[0])
    n_groups, levels = host.shape
    out = torch.zeros(n_groups, dtype=torch.int64, device=device)
    if n_groups == 0 or rows == 0:
        return out
    layouts = [(x.stride(0), rows) for x in planes]
    vec = words % 4 == 0 and all(_vec_ok(x, st) for x, (st, _) in zip(planes, layouts))
    f_stride = 0
    if filt is not None:
        f_stride = filt.stride(0)
        vec = vec and _vec_ok(filt, f_stride)
    flat = np.concatenate([
        np.asarray([x.data_ptr() for x in planes], dtype=np.int64),
        np.asarray([st for st, _ in layouts], dtype=np.int64),
        host.numpy().reshape(-1)])
    dev_table = torch.empty(len(flat), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _library("group_kernels.cu").pilosa_group_count(
            flat.ctypes.data, dev_table.data_ptr(), len(planes), n_groups, levels,
            None if filt is None else filt.data_ptr(), f_stride, out.data_ptr(),
            rows, words, int(vec), _stream(device))
    if err:
        raise RuntimeError(f"group_count kernel launch failed: CUDA error {err}")
    _count_launch("group_count")
    return out
