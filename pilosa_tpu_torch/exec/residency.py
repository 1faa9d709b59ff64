"""Device residency of the planner's leaf stacks: representation classes.

The port's counterpart of pilosa_tpu/exec/residency.py. A planner leaf
stack has a representation class chosen by measured row cardinality, the
idea of the reference's roaring container taxonomy (roaring.go) carried
to device memory:

* ``dense``  -- the ``[S, W]`` int32 bit-plane stack;
* ``packed`` -- an ``[S, K]`` int32 stack of SORTED, distinct in-shard
  column positions, padded per row with ``SENTINEL`` (SHARD_WIDTH), so a
  low-cardinality row costs ``4 * K`` bytes a shard instead of the 128 KiB
  dense block. K is the pow2 bucket of the largest per-shard cardinality
  of the stack.

``KERNELS`` maps (class, op) to the port's kernel wrappers
(``ops/kernels.py``): a packed Count never expands (``packed_count``), a
2-leaf Intersect counts packed against dense (``packed_and_dense_count``)
or packed against packed (``packed_pair_count``), and every other tree
expands the packed leaf to a dense plane on the device (``packed_expand``)
and runs the dense kernels. The ``hll`` class (sketch/kernels.py: the
packed ``bucket | rho << 18`` planes and register stacks of
Count(Distinct)) expands with the ``hll_expand`` kernel and estimates with
torch ops; the ``keyplane`` class (exec/keyplane.py: the ``[3, H]`` key
planes) counts on the ``plane_lookup`` kernel. Every class has every op,
as in the JAX package.

Selection: ``PILOSA_TPU_RESIDENCY_PACKED`` = ``on`` | ``off`` | ``auto``
(env wins over the server knob's ``set_mode``), as in the JAX package.
``auto`` packs a row only where the packed stack is at least
``AUTO_RATIO`` times smaller than dense; ``on`` packs everything that fits;
rows past ``MAX_PACK_WIDTH`` stay dense in every mode.
"""

from __future__ import annotations

import os

from pilosa_tpu_torch.config import WORDS_PER_SHARD
from pilosa_tpu_torch.exec import keyplane as _keyplane
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.sketch import kernels as sketch_kernels

_MODES = ("on", "off", "auto")
_default_mode = "auto"

#: representation-class names (the JAX package's). REPR_CLASSES is the
#: class table KERNELS pairs with.
DENSE = "dense"
PACKED = "packed"
HLL = "hll"
KEYPLANE = _keyplane.KEYPLANE
REPR_CLASSES = (DENSE, PACKED, HLL, KEYPLANE)

#: padding of packed index stacks: one past the last in-shard column, so
#: ``SENTINEL >> 5`` is the word just past a row. The kernels' constant,
#: so the format has one definition.
SENTINEL = kernels.PACK_SENTINEL

#: the narrowest packed stack (entries): below it the pow2 buckets would
#: multiply stack shapes for no memory won.
MIN_PACK_WIDTH = 8

#: ``auto`` packs only where the packed stack is at least this many times
#: smaller than the dense block (K <= W / AUTO_RATIO).
AUTO_RATIO = 8

#: the ceiling in every mode: past W/2 entries a packed row is no smaller
#: than the dense block (4 B an entry against 4 B a word).
MAX_PACK_WIDTH = WORDS_PER_SHARD // 2


def set_mode(mode: str) -> None:
    """Server-knob default; the PILOSA_TPU_RESIDENCY_PACKED env var takes
    precedence when set."""
    global _default_mode
    if mode not in _MODES:
        raise ValueError(f"residency_packed mode must be one of {_MODES}")
    _default_mode = mode


def mode() -> str:
    m = os.environ.get("PILOSA_TPU_RESIDENCY_PACKED", "").strip().lower()
    return m if m in _MODES else _default_mode


def pack_width(max_bits: int) -> int:
    """Packed stack width (entries) for a row whose largest per-shard
    cardinality is ``max_bits``: the pow2 bucket, at least MIN_PACK_WIDTH."""
    n = max(int(max_bits), MIN_PACK_WIDTH)
    return 1 << (n - 1).bit_length()


def choose_class(max_bits: int) -> str:
    """Representation class for a row stack whose largest per-shard
    cardinality is ``max_bits``, under the current mode; dense for
    high-cardinality rows in every mode."""
    m = mode()
    if m == "off":
        return DENSE
    k = pack_width(max_bits)
    if k > MAX_PACK_WIDTH:
        return DENSE
    if m == "auto" and k > WORDS_PER_SHARD // AUTO_RATIO:
        return DENSE
    return PACKED


def dense_nbytes(s_pad: int) -> int:
    """Device bytes of a dense [s_pad, W] stack."""
    return int(s_pad) * WORDS_PER_SHARD * 4


def packed_nbytes(s_pad: int, k: int) -> int:
    """Device bytes of a packed [s_pad, K] int32 index stack."""
    return int(s_pad) * int(k) * 4


def stack_nbytes(arr) -> int:
    """Resident bytes of any class's device stack: the one number the
    planner's budget accounting uses."""
    return int(arr.numel() * arr.element_size())


def _dense_expand(planes):
    return planes


def _dense_and_count(a, b):
    return kernels.pair_count(a, b, "and")


#: (representation class, op) -> kernel wrapper. Every class in
#: REPR_CLASSES registers every op the dense class has.
KERNELS = {
    (DENSE, "expand"): _dense_expand,
    (DENSE, "count"): kernels.row_counts,
    (DENSE, "and_count"): _dense_and_count,
    (DENSE, "pair_count"): _dense_and_count,
    (PACKED, "expand"): kernels.packed_expand,
    (PACKED, "count"): kernels.packed_count,
    (PACKED, "and_count"): kernels.packed_and_dense_count,
    (PACKED, "pair_count"): kernels.packed_pair_count,
    (HLL, "expand"): kernels.hll_expand,
    (HLL, "count"): sketch_kernels.hll_count,
    (HLL, "and_count"): sketch_kernels.hll_and_count,
    (HLL, "pair_count"): sketch_kernels.hll_pair_count,
    (KEYPLANE, "expand"): _keyplane.plane_expand,
    (KEYPLANE, "count"): _keyplane.plane_count,
    (KEYPLANE, "and_count"): _keyplane.plane_and_count,
    (KEYPLANE, "pair_count"): _keyplane.plane_pair_count,
}


def kernel(klass: str, op: str):
    """The table's kernel for (class, op); an unknown pair raises, so a
    class table / kernel table drift is loud at plan time."""
    try:
        return KERNELS[(klass, op)]
    except KeyError:
        raise KeyError(
            f"no {op!r} kernel registered for representation class "
            f"{klass!r} -- see exec/residency.py KERNELS") from None
