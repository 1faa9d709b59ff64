"""ResidencyPrefetcher — the planner's pipelined miss path.

The port's counterpart of pilosa_tpu/parallel/prefetch.py. A query whose
leaf stack is not resident used to build and upload it on its own thread
before its kernel could launch. Here the planner peeks a plan's full leaf
set at prepare time and hands every non-resident stack key to this
prefetcher, which builds and uploads on a small worker pool:

* the query thread's later fetch finds the upload landed (a plain cache
  hit) or in flight -- it *waits* on the in-flight event (a ``prefetch
  hit``) instead of starting its own upload (a ``sync miss``). With
  prefetch on, the query path performs no synchronous uploads; the
  oversubscription drill in tests/test_torch_async.py asserts
  ``sync_misses == 0`` while evictions churn.
* the in-flight table dedupes by stack-cache key, so a wave of same-plan
  queries prefetches the union of their leaves, one upload per leaf.
* ``overlap_ms`` reports upload time no query thread waited on, i.e.
  hidden behind other work.

A worker uploads on the planner's upload stream and leaves an event with
the stack; the query that reads the stack makes its own stream wait on
that event before any kernel reads it (planner ``_cached``).

Knob: ``PILOSA_TPU_PREFETCH`` = ``on`` | ``off`` (env wins over the
server knob's ``set_mode``), default on. Workers start at the first
scheduled upload, so an ``off`` node never pays the threads.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable

from pilosa_tpu_torch.obs.histogram import SECONDS_BOUNDS, LogHistogram

_MODES = ("on", "off")
_default_mode = "on"


def set_mode(mode: str) -> None:
    """Server-knob default; the PILOSA_TPU_PREFETCH env var (the
    test/operator override) takes precedence when set."""
    global _default_mode
    if mode not in _MODES:
        raise ValueError(f"prefetch mode must be one of {_MODES}")
    _default_mode = mode


def mode() -> str:
    m = os.environ.get("PILOSA_TPU_PREFETCH", "").strip().lower()
    return m if m in _MODES else _default_mode


class ResidencyPrefetcher:
    """Async stack-upload pool with inflight dedupe, owned by one
    planner. Builds run through the planner's own `_stack_rows`, so
    epoch/generation validation and byte accounting are identical to
    the synchronous path — only the thread changes."""

    MAX_WORKERS = 2
    #: bound on a query thread's wait for an inflight upload; past it
    #: the thread falls back to its own synchronous build (counted).
    WAIT_TIMEOUT_S = 120.0

    def __init__(self, planner, stats=None):
        self.planner = planner
        self.stats = stats
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        #: stack-cache key -> done event; membership IS the dedupe.
        self._inflight: dict[tuple, threading.Event] = {}
        self._queue: "deque[tuple[tuple, Callable[[], object]]]" = deque()
        self._workers: list[threading.Thread] = []
        self._closed = False
        self._tls = threading.local()
        self.scheduled = 0
        self.completed = 0
        self.errors = 0
        #: query-thread misses absorbed by an inflight upload.
        self.hits = 0
        #: query-thread misses that had to upload synchronously — THE
        #: number the prefetch pipeline exists to hold at zero.
        self.sync_misses = 0
        self._waited_s = 0.0
        self._upload_s = 0.0
        self.upload_hist = LogHistogram(bounds=SECONDS_BOUNDS)

    # -- policy ------------------------------------------------------------

    def enabled(self) -> bool:
        return not self._closed and mode() == "on"

    def is_worker(self) -> bool:
        """True on a prefetch worker thread — its builds are the async
        path itself, never synchronous misses (and it must not wait on
        its own inflight entry)."""
        return getattr(self._tls, "worker", False)

    # -- producer side (planner prepare paths) -----------------------------

    def schedule(self, key: tuple, build: Callable[[], object]) -> bool:
        """Queue an async upload for ``key`` unless one is already in
        flight. ``build`` must insert the stack into the planner cache
        itself (it is `_stack_rows` partially applied)."""
        with self._have_work:
            if self._closed or key in self._inflight:
                return False
            self._inflight[key] = threading.Event()
            self._queue.append((key, build))
            self.scheduled += 1
            if len(self._workers) < self.MAX_WORKERS:
                t = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"residency-prefetch-{len(self._workers)}")
                self._workers.append(t)
                t.start()
            self._have_work.notify()
            inflight = len(self._inflight)
        if self.stats is not None:
            self.stats.count("planner.prefetchScheduled", 1)
            self.stats.gauge("planner.prefetchInflight", inflight)
        return True

    # -- consumer side (query threads inside _stack_rows) -------------------

    def wait(self, key: tuple) -> bool:
        """Rendezvous with an inflight upload of ``key``; True if there
        was one and it completed (the caller's miss was a prefetch hit
        — the stack is now in cache)."""
        with self._lock:
            ev = self._inflight.get(key)
        if ev is None:
            return False
        t0 = time.monotonic()
        done = ev.wait(self.WAIT_TIMEOUT_S)
        waited = time.monotonic() - t0
        with self._lock:
            self.hits += 1
            self._waited_s += waited
        if self.stats is not None:
            self.stats.count("planner.prefetchHit", 1)
            self.stats.timing("planner.prefetchWait", waited)
        return done

    def note_sync_miss(self) -> None:
        with self._lock:
            self.sync_misses += 1
        if self.stats is not None:
            self.stats.count("planner.prefetchSyncMiss", 1)

    # -- worker loop --------------------------------------------------------

    def _run(self) -> None:
        self._tls.worker = True
        while True:
            with self._have_work:
                while not self._queue and not self._closed:
                    self._have_work.wait()
                if not self._queue:  # closed and drained
                    return
                key, build = self._queue.popleft()
            t0 = time.monotonic()
            try:
                build()
            except Exception:
                with self._lock:
                    self.errors += 1
            took = time.monotonic() - t0
            self.upload_hist.observe(took)
            with self._have_work:
                self.completed += 1
                self._upload_s += took
                ev = self._inflight.pop(key, None)
            if ev is not None:
                ev.set()
            if self.stats is not None:
                self.stats.timing("planner.prefetchUpload", took)

    # -- observability -------------------------------------------------------

    def debug(self) -> dict:
        """/debug/device payload: pipeline counters plus the
        upload-duration histogram. ``overlap_ms`` is upload wall time
        no query thread was blocked on — the part genuinely hidden
        behind compute."""
        with self._lock:
            out = {
                "mode": mode(),
                "scheduled": self.scheduled,
                "completed": self.completed,
                "inflight": len(self._inflight),
                "queued": len(self._queue),
                "hits": self.hits,
                "sync_misses": self.sync_misses,
                "errors": self.errors,
                "upload_ms": self._upload_s * 1e3,
                "waited_ms": self._waited_s * 1e3,
                "overlap_ms": max(0.0, self._upload_s - self._waited_s) * 1e3,
            }
        out["upload_hist"] = self.upload_hist.snapshot()
        return out

    def close(self) -> None:
        """Stop accepting work, drain the queue, release waiters."""
        with self._have_work:
            self._closed = True
            self._have_work.notify_all()
        for t in self._workers:
            t.join(timeout=5.0)
        with self._lock:
            leftovers = list(self._inflight.values())
            self._inflight.clear()
            self._queue.clear()
        for ev in leftovers:
            ev.set()
