"""DispatchCoalescer — run concurrent launches of one plan as one wave.

The port's counterpart of pilosa_tpu/parallel/coalesce.py. Concurrent
queries of one plan signature (the planner's program-cache key) that
arrive within a short window (``--dispatch-coalesce-us``, 150 us by
default) launch together:

* **identical-argument wave** (N callers racing the same query, whose leaf
  stacks are the very same cached device tensors): ONE plain launch of the
  program, its output shared by every caller's post-processing;
* **same-shape wave** (one signature, different leaves): ONE launch of the
  program's batched form -- ``pair_count_batched``, ``row_counts_batched``
  or ``tree_count_batched`` over the B slots' leaf tables, or on the packed
  fast paths ``packed_count_batched``, ``packed_and_dense_count_batched``
  or ``packed_pair_count_batched``, no padding -- and per-slot results
  fanned back out. A wave whose slots' leaves differ
  in shape (one plan over different shard sets) splits into one wave per
  shape. This is where the JAX coalescer
  uses ``jax.vmap`` and cannot batch its Pallas programs; the port's
  kernels take the slots as a table, so any wave width is one launch. A
  program with no batched form (the fused BSI aggregates, and count
  programs whose packed leaves are expanded) launches slot by slot on the
  flusher thread.

Selection: ``PILOSA_TPU_DISPATCH_COALESCE`` = ``on`` | ``off`` | ``auto``
(env wins over ``set_mode``); ``PILOSA_TPU_DISPATCH_COALESCE_US``
overrides the window.

* ``off`` -- every dispatch launches at once, on the caller's thread.
* ``on`` -- every dispatch waits up to the window for batch-mates.
* ``auto`` (default) -- the first dispatch of a plan launches at once;
  while it is in flight, further dispatches of the plan collect into a
  batch that flushes on the window. Solo queries never pay the window.

Results are exact in every mode: a shared wave runs the same program on
the same inputs, and a batched wave runs each slot's own operands through
the same kernel body.

The flusher thread launches kernels for other threads' queries: each
wrapper picks its tensor's device, and the query's profile is captured at
``dispatch()`` time, since the flusher has no query context.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

import torch

from pilosa_tpu_torch.obs import profile as _profile

_MODES = ("on", "off", "auto")

#: sentinel: "read the caller's contextvar" -- distinct from None, which
#: means "profiling is off for this entry" (the flusher passes the profile
#: captured at dispatch() time).
_CTX = object()
_default_mode = "auto"

DEFAULT_WINDOW_US = 150.0

#: widest batch one launch absorbs; later arrivals start a fresh batch.
MAX_BATCH = 32


def set_mode(mode: str) -> None:
    """Server-knob default; the PILOSA_TPU_DISPATCH_COALESCE env var takes
    precedence when set."""
    global _default_mode
    if mode not in _MODES:
        raise ValueError(f"dispatch_coalesce mode must be one of {_MODES}")
    _default_mode = mode


def mode() -> str:
    m = os.environ.get("PILOSA_TPU_DISPATCH_COALESCE", "").strip().lower()
    return m if m in _MODES else _default_mode


def default_window_us() -> float:
    env = os.environ.get("PILOSA_TPU_DISPATCH_COALESCE_US", "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return DEFAULT_WINDOW_US


class _Batch:
    __slots__ = ("key", "fn", "deadline", "entries")

    def __init__(self, key, fn, deadline: float):
        self.key = key
        self.fn = fn
        self.deadline = deadline
        #: (args, post, fut, profile-or-None), the profile captured on the
        #: dispatching thread.
        self.entries: list[tuple[tuple, Callable, Future, Any]] = []


class DispatchCoalescer:
    """Same-plan dispatch batching in front of a planner's launches.

    ``dispatch(fn, args, post)`` is the planner's launch choke point: it
    runs ``fn(*args)`` (at once or as part of a wave), hands the output
    tensor to the planner's TransferBatcher, and resolves the returned
    future to ``post(host_array)``."""

    def __init__(self, planner, window_us: float | None = None):
        self.planner = planner
        self.window_us = (default_window_us() if window_us is None
                          else float(window_us))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: every unflushed batch, FIFO by arrival (keyed by a sequence
        #: number, not the plan key: a full batch stays here until the
        #: flusher takes it, even after a fresh batch opens for the plan).
        self._pending: dict[int, _Batch] = {}
        #: plan key -> the batch still taking entries.
        self._open: dict[Any, _Batch] = {}
        self._seq = 0
        #: per-key launches whose transfer has not landed: the concurrency
        #: signal "auto" batches on.
        self._inflight: dict[Any, int] = {}
        self._thread: threading.Thread | None = None
        self._closed = False
        #: test hook: while held, due batches stay pending.
        self._held = False

    # -- public --------------------------------------------------------

    def dispatch(self, fn, args, post: Callable[[Any], Any],
                 waited: bool = False) -> Future:
        """Launch ``fn(*args)`` (possibly in a wave with same-plan peers)
        and return a Future resolving to ``post(host_output)``. ``waited``:
        the caller calls ``result()`` next (TransferBatcher.submit)."""
        m = mode()
        key = self.planner.fn_key(fn) if m != "off" else None
        if key is None:
            return self._launch_one(None, fn, args, post, waited=waited)
        prof = _profile.current()
        with self._cv:
            if not self._closed:
                batch = self._open.get(key)
                if batch is not None:
                    fut: Future = Future()
                    batch.entries.append((tuple(args), post, fut, prof))
                    if len(batch.entries) >= MAX_BATCH:
                        # Seal: pending until flushed; the next arrival
                        # opens a fresh batch.
                        del self._open[key]
                        self._cv.notify()
                    return fut
                if m == "on" or self._inflight.get(key, 0) > 0:
                    batch = _Batch(key, fn, time.monotonic() + self.window_us * 1e-6)
                    fut = Future()
                    batch.entries.append((tuple(args), post, fut, prof))
                    self._pending[self._seq] = batch
                    self._seq += 1
                    self._open[key] = batch
                    if self._thread is None:
                        self._thread = threading.Thread(
                            target=self._run, name="dispatch-coalescer", daemon=True)
                        self._thread.start()
                    self._cv.notify()
                    return fut
        # "auto" with nothing in flight (or closed): launch now.
        return self._launch_one(key, fn, args, post, waited=waited)

    def queue_depth(self) -> int:
        """Entries sitting in unflushed batches right now."""
        with self._lock:
            return sum(len(b.entries) for b in self._pending.values())

    def hold(self) -> None:
        """Test hook: freeze flushing so a batch can be assembled
        deterministically; pair with release()."""
        with self._cv:
            self._held = True

    def release(self) -> None:
        with self._cv:
            self._held = False
            self._cv.notify()

    def close(self, timeout: float | None = 10.0) -> None:
        """Flush pending batches and stop the flusher thread."""
        with self._cv:
            self._closed = True
            self._held = False
            self._cv.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
        while True:
            with self._cv:
                if not self._pending:
                    self._open.clear()
                    return
                _, batch = self._pending.popitem()
                if self._open.get(batch.key) is batch:
                    del self._open[batch.key]
            self._flush(batch)

    # -- flusher -------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed and not self._pending:
                        return
                    due = None
                    if not self._held:
                        now = time.monotonic()
                        for seq, b in self._pending.items():
                            if (self._closed or b.deadline <= now
                                    or len(b.entries) >= MAX_BATCH):
                                due = seq
                                break
                    if due is not None:
                        batch = self._pending.pop(due)
                        if self._open.get(batch.key) is batch:
                            del self._open[batch.key]
                        break
                    if self._held or not self._pending:
                        self._cv.wait()
                    else:
                        nxt = min(b.deadline for b in self._pending.values())
                        self._cv.wait(max(nxt - time.monotonic(), 0.0) or 1e-5)
            self._flush(batch)

    # -- launch paths --------------------------------------------------

    def _note_inflight(self, key, delta: int) -> None:
        if key is None:
            return
        with self._lock:
            n = self._inflight.get(key, 0) + delta
            if n > 0:
                self._inflight[key] = n
            else:
                self._inflight.pop(key, None)

    def _launch_one(self, key, fn, args, post: Callable, prof=_CTX,
                    waited: bool = False) -> Future:
        """Unbatched launch, the serial path: returns the TransferBatcher
        future itself."""
        planner = self.planner
        if prof is _CTX:
            prof = _profile.current()
        try:
            t0 = time.perf_counter()
            out = fn(*args)
            dev_ms = (time.perf_counter() - t0) * 1e3
        except Exception as e:
            fut: Future = Future()
            fut.set_exception(e)
            return fut
        profs = (prof,) if prof is not None else ()
        planner._record_dispatch(1, dev_ms, profs=profs)
        self._note_inflight(key, +1)

        def conv(host, _p=post, _k=key):
            try:
                return _p(host)
            finally:
                self._note_inflight(_k, -1)

        return planner.batcher.submit(out, conv, profs=profs, waited=waited)

    def _flush(self, batch: _Batch) -> None:
        # One plan over different shard sets gives leaves of different
        # shapes, which no launch takes together: each shape group is a
        # wave of its own, and a group's failure reaches only its futures.
        groups: dict = {}
        for e in batch.entries:
            groups.setdefault(_arg_shapes(e[0]), []).append(e)
        for entries in groups.values():
            if len(entries) == 1:
                args, post, fut, prof = entries[0]
                _chain(self._launch_one(batch.key, batch.fn, args, post,
                                        prof=prof), fut)
                continue
            try:
                self._flush_batched(batch, entries)
            except Exception as e:
                for _, _, fut, _ in entries:
                    if not fut.done():
                        fut.set_exception(e)

    def _flush_batched(self, batch: _Batch, entries: list) -> None:
        """Launch ``entries`` (two or more of ``batch``, their leaves of one
        shape) as one wave."""
        planner = self.planner
        args0 = entries[0][0]
        profs = [e[3] for e in entries]
        t0 = time.perf_counter()
        if all(_args_identical(e[0], args0) for e in entries[1:]):
            # N callers, one plan, the same leaf tensors: one plain launch.
            out = batch.fn(*args0)
            per_slot = False
        else:
            batched = planner.fn_batched(batch.fn)
            if batched is None:
                # No batched form: launch slot by slot on this thread (B
                # launches recorded).
                for args, post, fut, prof in entries:
                    _chain(self._launch_one(batch.key, batch.fn, args, post,
                                            prof=prof), fut)
                return
            out = batched([e[0] for e in entries])  # [B, ...]: one launch
            per_slot = True
        dev_ms = (time.perf_counter() - t0) * 1e3
        planner._record_dispatch(len(entries), dev_ms, profs=profs)
        self._note_inflight(batch.key, +1)

        def conv(host, _k=batch.key):
            try:
                for i, (_, post, fut, _prof) in enumerate(entries):
                    if fut.done():
                        continue
                    try:
                        fut.set_result(post(host[i] if per_slot else host))
                    except Exception as e:
                        fut.set_exception(e)
            finally:
                self._note_inflight(_k, -1)

        planner.batcher.submit(out, conv, profs=[p for p in profs if p is not None])


def _chain(src: Future, dst: Future) -> None:
    def _done(f):
        if dst.done():
            return
        e = f.exception()
        if e is not None:
            dst.set_exception(e)
        else:
            dst.set_result(f.result())
    src.add_done_callback(_done)


def _arg_shapes(a):
    """The shapes of an argument tree's tensors, leaf by leaf (None for any
    other leaf): the slots of one launch agree on them."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape)
    if isinstance(a, (tuple, list)):
        return tuple(_arg_shapes(x) for x in a)
    return None


def _args_identical(a, b) -> bool:
    """True when two argument trees hold the same tensors leaf for leaf
    (identity, an O(leaves) pointer walk) and equal scalars: the case of
    concurrent queries whose leaves came from the planner's stack cache."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_args_identical(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b
