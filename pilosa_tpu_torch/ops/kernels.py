"""The count kernels: the port's counterpart of pilosa_tpu/ops/pallas_kernels.py.

``pair_count(a, b, op)`` and ``row_counts(a)`` take int32 bit-pattern
tensors of shape ``[..., W]`` and return int32 per-row counts. On a CUDA
tensor each launches its hand-written kernel from
``csrc/count_kernels.cu`` (built at first use, see ``ops/build.py``) or
raises; on a CPU tensor it runs the plain PyTorch version beside it. There
is no fall-back from the card to the plain version.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, so a run can show that its queries went through the
kernels (``reset_launches()`` zeroes the counts).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pilosa_tpu_torch.ops import bitops

#: kernel launches since the last reset_launches(), by wrapper name.
LAUNCHES = {"pair_count": 0, "row_counts": 0}

_OP_CODES = {"and": 0, "or": 1, "xor": 2, "andnot": 3}

_PLAIN_OPS = {
    "and": bitops.b_and,
    "or": bitops.b_or,
    "xor": bitops.b_xor,
    "andnot": bitops.b_andnot,
}

_SOURCE = "count_kernels.cu"
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pilosa_tpu_torch.ops import build
        lib = build.load(_SOURCE)
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pilosa_pair_count.argtypes = [vp, vp, vp, i64, i64, i64, i64,
                                          i32, i32, vp]
        lib.pilosa_pair_count.restype = i32
        lib.pilosa_row_counts.argtypes = [vp, vp, i64, i64, i64, i32, vp]
        lib.pilosa_row_counts.restype = i32
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------


def pair_count_plain(a: torch.Tensor, b: torch.Tensor, op: str = "and") -> torch.Tensor:
    """op, then SWAR popcount on int64, then an int32 row sum."""
    return bitops.count(_PLAIN_OPS[op](a, b))


def row_counts_plain(a: torch.Tensor) -> torch.Tensor:
    return bitops.count(a)


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
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along its word axis")


def _row_stride(x: torch.Tensor, lead: torch.Size, name: str) -> int:
    """Word stride between consecutive rows of ``x`` as the kernel walks
    the flattened leading shape ``lead``: 0 for a single row broadcast
    against every row (never materialised), the real stride for a 2-D
    operand (a row sliced out of a stack keeps its stride), W for a
    contiguous higher-rank operand. Any other layout is refused."""
    if math.prod(x.shape[:-1]) == 1:
        return 0
    if x.shape[:-1] != lead:
        raise ValueError(f"{name} of shape {tuple(x.shape)} broadcasts only "
                         f"partially against rows {tuple(lead)}")
    if x.dim() == 2:
        return x.stride(0)
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous when it has more than 2 dims")
    return x.shape[-1]


def _vec_ok(x: torch.Tensor, stride: int) -> bool:
    """16-byte loads need an aligned first row and a row stride that keeps
    every row aligned."""
    return x.data_ptr() % 16 == 0 and stride % 4 == 0


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"count kernels take CPU or CUDA tensors, got {x.device}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def pair_count(a: torch.Tensor, b: torch.Tensor, op: str = "and") -> torch.Tensor:
    """Fused ``popcount(op(a, b))`` per row over broadcastable ``[..., W]``
    int32 tensors; op in {and, or, xor, andnot}. A ``[W]`` (or any
    single-row) operand is counted against every row of the other without
    being copied. Returns int32 of the broadcast leading shape."""
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
    sa = _row_stride(a, lead, "a")
    sb = _row_stride(b, lead, "b")
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
            _OP_CODES[op], int(vec), _stream(a.device))
    if err:
        raise RuntimeError(f"pair_count kernel launch failed: CUDA error {err}")
    LAUNCHES["pair_count"] += 1
    return out.reshape(lead)


def row_counts(a: torch.Tensor) -> torch.Tensor:
    """Per-row popcount over ``[..., W]`` int32; int32 of shape ``a.shape[:-1]``."""
    _check_words(a, "a")
    lead = a.shape[:-1]
    sa = _row_stride(a, lead, "a")
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
    LAUNCHES["row_counts"] += 1
    return out.reshape(lead)
