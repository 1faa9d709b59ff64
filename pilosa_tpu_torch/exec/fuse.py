"""Plan-segment fusion: keep the plannable part of a mixed tree on the card.

The port's counterpart of pilosa_tpu/exec/fuse.py. The planner runs a
pure bitmap tree + Count as one program (one ``tree_count`` launch over
the leaf stacks). A call tree with an unplannable subtree -- a ``Shift``
with a negative ``n``, say -- would fall back to the per-shard host
interpreter for the WHOLE tree; instead the executor lowers the maximal
plannable subtrees to the card and evaluates each unplannable subtree on
the host to a Row that enters the program as a ``__const__`` leaf
(``Executor._fuse_partial``).

Selection: ``PILOSA_TPU_DISPATCH_FUSE`` = ``on`` | ``off`` | ``auto``
(env wins over the server knob's ``set_mode``). In the port ``auto``
fuses every mixed tree: the JAX package's one anti-case (a filtered
aggregate compiled by XLA's CPU backend) has no counterpart here, since
the port's aggregates run as separate kernel launches. ``off`` exists for
the equivalence tests and for bisecting.

This module also carries the per-query fused-step account: every planner
dispatch records how many plan-tree calls its program fused, surfaced as
the ``fusedSteps`` field of query profiles.
"""

from __future__ import annotations

import contextvars
import os

_MODES = ("on", "off", "auto")
_default_mode = "auto"


def set_mode(mode: str) -> None:
    """Server-knob default; the PILOSA_TPU_DISPATCH_FUSE env var (the
    test/operator override) takes precedence when set."""
    global _default_mode
    if mode not in _MODES:
        raise ValueError(f"dispatch_fuse mode must be one of {_MODES}")
    _default_mode = mode


def mode() -> str:
    m = os.environ.get("PILOSA_TPU_DISPATCH_FUSE", "").strip().lower()
    return m if m in _MODES else _default_mode


def enabled() -> bool:
    return mode() != "off"


# -- per-query fused-step accounting ----------------------------------------

#: plan-tree calls executed inside a single device program, accumulated
#: over the current query's dispatches; a contextvar so the value rides the
#: request thread through executor -> planner -> HTTP handler.
_fused_steps: contextvars.ContextVar[int] = contextvars.ContextVar(
    "pilosa_tpu_torch_fused_steps", default=0)


def reset_fused_steps() -> None:
    # A per-query accumulator, zeroed at query entry; its default is also
    # the reset value.
    _fused_steps.set(0)


def add_fused_steps(n: int) -> None:
    if n:
        _fused_steps.set(_fused_steps.get() + int(n))


def fused_steps() -> int:
    return _fused_steps.get()


def call_steps(c) -> int:
    """Number of Call nodes in a plan tree -- the step count a fused
    program absorbs."""
    n = 1
    for ch in getattr(c, "children", ()):
        n += call_steps(ch)
    return n
