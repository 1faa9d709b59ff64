"""Device residency of the planner's leaf stacks: the dense class.

The port's counterpart of pilosa_tpu/exec/residency.py, dense class only.
The JAX package keeps a leaf stack in one of several representation
classes chosen by row cardinality -- ``dense`` ``[S, W]`` bit planes,
``packed`` sorted index stacks, HLL register planes, key planes. The port
holds every stack dense: ``choose_class`` always answers ``DENSE``, and
the other classes with their kernels come with later slices (ROADMAP.md
Queue 1 items 4 and 5). Their names stay in ``REPR_CLASSES`` so the
per-class byte accounting (``/debug/device``'s ``class_bytes``) has the
JAX node's keys; they read zero.

Knob: ``PILOSA_TPU_RESIDENCY_PACKED`` = ``off`` | ``auto`` (env wins over
``set_mode``), as in the JAX package; ``on`` asks for packed stacks and
raises ``NotPortedError``.
"""

from __future__ import annotations

import os

from pilosa_tpu_torch.config import WORDS_PER_SHARD
from pilosa_tpu_torch.errors import SLICE_FIELDS, NotPortedError

_MODES = ("on", "off", "auto")
_default_mode = "auto"

#: representation-class names (the JAX package's); only DENSE is built.
DENSE = "dense"
PACKED = "packed"
HLL = "hll"
KEYPLANE = "keyplane"
REPR_CLASSES = (DENSE, PACKED, HLL, KEYPLANE)


def _refuse_on(mode: str) -> None:
    if mode == "on":
        raise NotPortedError("packed residency (residency_packed=on)", SLICE_FIELDS)


def set_mode(mode: str) -> None:
    """Server-knob default; the PILOSA_TPU_RESIDENCY_PACKED env var takes
    precedence when set."""
    global _default_mode
    if mode not in _MODES:
        raise ValueError(f"residency_packed mode must be one of {_MODES}")
    _refuse_on(mode)
    _default_mode = mode


def mode() -> str:
    m = os.environ.get("PILOSA_TPU_RESIDENCY_PACKED", "").strip().lower()
    m = m if m in _MODES else _default_mode
    _refuse_on(m)
    return m


def choose_class(max_bits: int) -> str:
    """Representation class for a row stack whose largest per-shard
    cardinality is ``max_bits``: dense, the only class the port builds."""
    mode()
    return DENSE


def dense_nbytes(s_pad: int) -> int:
    """Device bytes of a dense [s_pad, W] stack."""
    return int(s_pad) * WORDS_PER_SHARD * 4


def stack_nbytes(arr) -> int:
    """Resident bytes of a device stack: the one number the planner's
    budget accounting uses."""
    return int(arr.numel() * arr.element_size())
