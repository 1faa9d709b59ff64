"""The port's kernels and their plain PyTorch versions.

- ``pair_count(a, b, op)`` and ``row_counts(a)`` (``csrc/count_kernels.cu``)
  are the counterparts of pilosa_tpu/ops/pallas_kernels.py: int32
  bit-pattern tensors of shape ``[..., W]`` in, int32 per-row counts out.
- ``bsi_compare`` and ``bsi_minmax`` (``csrc/bsi_kernels.cu``) are the
  bit-serial comparator and min/max descent of pilosa_tpu/ops/bsi.py, which
  the JAX package left to XLA's fusion; ``ops/bsi.py`` builds the BSI
  queries on them.

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

import torch

from pilosa_tpu_torch.ops import bitops

#: kernel launches since the last reset_launches(), by wrapper name; read
#: it, and change it only through _count_launch and reset_launches.
LAUNCHES = {"pair_count": 0, "row_counts": 0, "bsi_compare": 0, "bsi_minmax": 0}
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
    },
    "bsi_kernels.cu": {
        "pilosa_bsi_compare": [_VP, _VP, _VP, _I64, _I64, _I32, _U32, _U32, _I32,
                               _I32, _I32, _VP],
        "pilosa_bsi_minmax": [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64,
                              _I32, _I32, _I32, _VP],
    },
}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


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
