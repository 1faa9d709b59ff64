"""TransferBatcher — pipelined device-to-host delivery of query results.

The port's counterpart of pilosa_tpu/parallel/batcher.py. A query submits
its small result tensor instead of pulling it with a synchronising
``.cpu()``; the copy starts on the submitting thread and a resolver
thread reads the landed copies in FIFO order and resolves each query's
future. Any number of copies are in flight at once, and no query thread
waits on another query's kernels to read its own counts.

On the card, ``submit(t, post)``:

- records an event on the launching thread's current stream, right after
  the kernel that wrote ``t``;
- makes the batcher's copy stream wait on that event (without it the copy
  could read ``t`` before the kernel wrote it);
- copies ``t`` with ``non_blocking=True`` into a pinned host buffer (a copy
  into pageable memory would block the caller), and records a second event
  on the copy stream;
- tells the caching allocator that the copy stream uses ``t``
  (``record_stream``), and keeps a reference to ``t`` until the copy has
  landed, so a dropped output is not handed to another tensor while the
  copy still reads it.

The resolver thread (or the waiting thread itself, when it steals its own
entry) waits on the second event and runs ``post`` on a numpy copy of the
buffer -- the resolver claims an entry only once its copy has landed, so
a waiter that steals never loses its entry to it midway. The buffer goes
back to a pool of pinned buffers, one free list per power-of-two size,
which keeps at most ``PINNED_KEEP`` buffers of a size (one past
``PINNED_KEEP_LARGE`` bytes, a TopN filter's size) and frees the rest; the
planner's stats carry the pooled bytes as ``planner.pinnedPoolBytes``. A
CPU tensor resolves with no stream work.

Inline steals follow the ``inline_transfer`` knob (``on`` | ``off`` |
``auto``; env ``PILOSA_TPU_INLINE_TRANSFER`` wins): ``auto`` steals only
when the waiter's entry is the only one queued.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np
import torch

from pilosa_tpu_torch.obs import profile as _profile
from pilosa_tpu_torch.obs.histogram import WIDTH_BOUNDS, LogHistogram

_INLINE_MODES = ("on", "off", "auto")

#: free pinned buffers kept per size, and per size past PINNED_KEEP_LARGE.
PINNED_KEEP = 4
PINNED_KEEP_LARGE = 1 << 20
_default_inline = "auto"


def set_inline_mode(mode: str) -> None:
    """Server-knob default for inline transfer resolution; the
    PILOSA_TPU_INLINE_TRANSFER env var takes precedence when set."""
    global _default_inline
    if mode not in _INLINE_MODES:
        raise ValueError(f"inline_transfer mode must be one of {_INLINE_MODES}")
    _default_inline = mode


def inline_mode() -> str:
    m = os.environ.get("PILOSA_TPU_INLINE_TRANSFER", "").strip().lower()
    return m if m in _INLINE_MODES else _default_inline


class _StealFuture(Future):
    """A future whose ``result()`` may steal its own queue entry and resolve
    inline on the waiting thread, skipping the hand-off to the resolver
    (governed by the inline_transfer knob)."""

    __slots__ = ("_batcher",)

    def result(self, timeout=None):
        b = self._batcher
        if b is not None:
            self._batcher = None
            b._steal(self)
        return super().result(timeout)


class _Transfer:
    """One queued copy: the source (kept alive until the copy lands), the
    pinned buffer it lands in and the event that says it has."""

    __slots__ = ("src", "host", "done", "fut", "post")

    def __init__(self, src, host, done, fut, post):
        self.src, self.host, self.done = src, host, done
        self.fut, self.post = fut, post


class TransferBatcher:
    """Pipelines many small device-to-host copies behind one resolver."""

    def __init__(self, stats=None):
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._closed = False
        #: waves resolved on the waiter's thread (the knob's observable)
        self.inline_resolved = 0
        #: lifetime wave-width distribution (queue length at each submit),
        #: rendered by /debug/device; observed under _cv.
        self._wave_hist = LogHistogram(bounds=WIDTH_BOUNDS, lock=False)
        #: device -> copy stream; pinned size -> free buffers.
        self._streams: dict = {}
        self._pinned: dict[int, list] = {}
        self._pinned_bytes = 0
        self._pool_lock = threading.Lock()
        self._stats = stats

    # -- public --------------------------------------------------------

    def submit(self, arr, postproc: Callable[[np.ndarray], Any],
               profs=None, waited: bool = False) -> "Future[Any]":
        """Start ``arr``'s copy to the host and return a future resolving to
        ``postproc(host_array)``.

        ``profs``: QueryProfiles to charge this wave to -- passed by the
        coalescer, whose flusher thread has no query context; when omitted,
        the submitting thread's active profile is charged.

        ``waited``: the caller calls ``result()`` on the future next (the
        synchronous query paths). The resolver is then not woken for the
        entry: ``result()`` resolves it on the caller's thread, or wakes the
        resolver when the knob says it may not. Waking a thread that would
        find nothing to do costs a solo query more than its copy."""
        fut: Future = _StealFuture()
        fut._batcher = self
        entry = self._start_copy(arr, fut, postproc)
        closed = False
        with self._cv:
            if self._closed:
                closed = True
            else:
                self._queue.append(entry)
                width = len(self._queue)
                self._wave_hist.observe(width)
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="transfer-batcher", daemon=True)
                    self._thread.start()
                if not waited or width > 1:
                    self._cv.notify()
        if closed:
            # A query racing close resolves on its own thread instead of
            # failing (handler threads can outlive the HTTP listener).
            fut._batcher = None
            self._resolve(entry)
            return fut
        if profs is None:
            p = _profile.current()
            profs = (p,) if p is not None else ()
        for p in profs:
            if p is not None:
                p.add_wave(width)
        return fut

    def queue_depth(self) -> int:
        """Transfers awaiting resolution right now."""
        with self._lock:
            return len(self._queue)

    def debug(self) -> dict:
        """The /debug/device payload's transfer half."""
        with self._lock:
            return {"queue_depth": len(self._queue),
                    "inline_resolved": self.inline_resolved,
                    "wave_width_hist": self._wave_hist.snapshot()}

    def close(self, timeout: float | None = 30.0) -> None:
        """Drain and join: mark closed, wake the resolver and wait for it to
        resolve every transfer already queued; later submits resolve on the
        caller's thread. Safe to call repeatedly and from a resolver
        callback."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    # -- copies ----------------------------------------------------------

    def _copy_stream(self, device):
        s = self._streams.get(device)
        if s is None:
            with self._pool_lock:
                s = self._streams.get(device)
                if s is None:
                    s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    def _take_pinned(self, nbytes: int) -> torch.Tensor:
        size = 1 << max(nbytes - 1, 0).bit_length()
        with self._pool_lock:
            free = self._pinned.get(size)
            if free:
                self._pool_gauge(-size)
                return free.pop()
        return torch.empty(size, dtype=torch.uint8, pin_memory=True)

    def _give_pinned(self, buf: torch.Tensor) -> None:
        size = buf.numel()
        keep = 1 if size > PINNED_KEEP_LARGE else PINNED_KEEP
        with self._pool_lock:
            free = self._pinned.setdefault(size, [])
            if len(free) < keep:
                free.append(buf)
                self._pool_gauge(size)

    def _pool_gauge(self, delta: int) -> None:
        """Under _pool_lock: the pooled pinned bytes moved by ``delta``."""
        self._pinned_bytes += delta
        if self._stats is not None:
            self._stats.gauge("planner.pinnedPoolBytes", self._pinned_bytes)

    def _start_copy(self, arr, fut, post) -> _Transfer:
        if not isinstance(arr, torch.Tensor) or arr.device.type != "cuda":
            return _Transfer(arr, None, None, fut, post)
        src = arr.contiguous()
        device = src.device
        nbytes = src.numel() * src.element_size()
        buf = self._take_pinned(nbytes)
        host = buf[:nbytes].view(src.dtype).view(src.shape)
        with torch.cuda.device(device):
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
            stream = self._copy_stream(device)
            stream.wait_event(ready)
            with torch.cuda.stream(stream):
                host.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            src.record_stream(stream)
        return _Transfer(src, (buf, host), done, fut, post)

    def _resolve(self, e: _Transfer) -> None:
        """Wait for ``e``'s copy, then resolve its future to post(host)."""
        try:
            if e.done is None:
                src = e.src
                host = (src.numpy() if isinstance(src, torch.Tensor)
                        else np.asarray(src))
            else:
                e.done.synchronize()
                buf, view = e.host
                host = view.numpy().copy()
                e.src = e.host = None
                self._give_pinned(buf)
            result = e.post(host)
        except Exception as exc:
            if not e.fut.done():
                e.fut.set_exception(exc)
            return
        if not e.fut.done():
            e.fut.set_result(result)

    def _steal(self, fut: Future) -> None:
        """Remove ``fut``'s own queue entry and resolve it on the calling
        (waiting) thread. No-op when the knob says off, when the resolver
        already claimed the entry, or -- in auto -- when other waves are
        queued (FIFO pipelining beats stealing there)."""
        m = inline_mode()
        entry = None
        with self._cv:
            if m == "off" or (m == "auto" and len(self._queue) != 1):
                self._cv.notify()  # a waited submit left the resolver asleep
                return
            for i, e in enumerate(self._queue):
                if e.fut is fut:
                    del self._queue[i]
                    entry = e
                    break
            if entry is not None:
                self.inline_resolved += 1
        if entry is None:
            return
        p = _profile.current()  # the stealer is the query thread
        if p is not None:
            p.add_inline_steal()
        self._resolve(entry)

    # -- resolver --------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                head = self._queue[0]
            # Wait for the head's copy before claiming it: until it lands,
            # its waiter may still steal it, and a steal that loses the
            # race to this thread would cost the waiter a second hand-off.
            if head.done is not None:
                head.done.synchronize()
            with self._cv:
                if not self._queue or self._queue[0] is not head:
                    continue  # stolen meanwhile
                self._queue.popleft()
            self._resolve(head)
