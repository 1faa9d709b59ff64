"""Admission control: weighted priority classes, a bounded wait queue,
and a concurrency gate on query dispatch.

The reference Pilosa bounds executor work with a worker pool
(executor.go:2561); the TPU-native equivalent gates at admission time,
because device dispatch is where oversubscription actually hurts (every
concurrent query pins host staging buffers and competes for the single
device stream). Excess load is shed with ``QueryShedError`` — surfaced
as HTTP 503 + ``Retry-After`` at the edge — rather than queueing
unboundedly.

Scheduling between classes is smooth weighted round-robin over the
non-empty wait queues, so a flood of batch queries cannot starve
interactive ones, and vice versa a steady interactive stream still
leaks batch queries through at the configured ratio.

The internal-sync class gets reserved headroom *above* the public
concurrency limit: remote fan-out legs arriving from a coordinator must
never queue behind the coordinator-held slots that are waiting on them
(the classic distributed admission deadlock).

The port's copy of pilosa_tpu/qos/admission.py.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

from pilosa_tpu_torch.obs import profile as _profile

from .deadline import Deadline, DeadlineExceededError, current_deadline

CLASS_INTERACTIVE = "interactive"
CLASS_BATCH = "batch"
CLASS_INTERNAL = "internal"

QOS_CLASSES = (CLASS_INTERACTIVE, CLASS_BATCH, CLASS_INTERNAL)

DEFAULT_WEIGHTS = {CLASS_INTERACTIVE: 8, CLASS_INTERNAL: 4, CLASS_BATCH: 1}


class QueryShedError(RuntimeError):
    """Admission queue is full — surfaced as HTTP 503 + Retry-After.

    Not a PilosaError: the generic query-error handlers map those to
    400, and a shed is the server's fault, not the client's.
    """

    def __init__(self, message: str = "query shed: admission queue full",
                 retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = float(retry_after)


class IngestBackpressureError(RuntimeError):
    """The bulk-ingest pipeline (WAL append + device upload) is over its
    in-flight budget — surfaced as HTTP 429 + Retry-After (like a tenant
    quota trip: the *request stream* must slow down; the node is fine).
    """

    def __init__(self,
                 message: str = "ingest backpressure: pipeline saturated",
                 retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = float(retry_after)


class IngestGate:
    """In-flight byte budget for bulk import work.

    Stream chunks hold their decoded size while they're being applied
    (decode -> WAL -> device upload); when concurrent holders exceed the
    budget, new chunks are refused with IngestBackpressureError instead
    of queueing — the client gets 429 + Retry-After + how far the
    server got, and resumes. ``max_inflight_bytes=0`` disables the gate.
    A chunk larger than the whole budget is still admitted when the
    pipeline is idle, so an oversized batch degrades to serial progress
    rather than wedging forever.
    """

    def __init__(self, max_inflight_bytes: int = 0):
        self.max_inflight_bytes = int(max_inflight_bytes)
        self._lock = threading.Lock()
        self._inflight = 0
        self._holders = 0
        self.admitted_total = 0
        self.rejected_total = 0

    def _retry_after(self) -> float:
        # One pipeline turn per budget of backlog, clamped like the
        # admission controller's hint.
        if self.max_inflight_bytes <= 0:
            return 1.0
        return min(30.0, max(1.0, self._inflight / self.max_inflight_bytes))

    @contextlib.contextmanager
    def admit(self, nbytes: int):
        if self.max_inflight_bytes <= 0:
            yield
            return
        with self._lock:
            if self._holders and \
                    self._inflight + nbytes > self.max_inflight_bytes:
                self.rejected_total += 1
                raise IngestBackpressureError(
                    retry_after=self._retry_after())
            self._inflight += nbytes
            self._holders += 1
            self.admitted_total += 1
        try:
            yield
        finally:
            with self._lock:
                self._inflight -= nbytes
                self._holders -= 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"inflightBytes": self._inflight,
                    "holders": self._holders,
                    "maxInflightBytes": self.max_inflight_bytes,
                    "admitted": self.admitted_total,
                    "rejected": self.rejected_total}


def normalize_class(name: str | None, remote: bool = False) -> str:
    """Map a client-supplied class name to a known class. Remote legs of
    a fan-out are always internal-sync regardless of what the header
    says — the coordinator already paid the public admission toll."""
    if remote:
        return CLASS_INTERNAL
    name = (name or "").strip().lower()
    return name if name in QOS_CLASSES else CLASS_INTERACTIVE


class _Waiter:
    __slots__ = ("cls", "granted", "abandoned")

    def __init__(self, cls: str):
        self.cls = cls
        self.granted = False
        self.abandoned = False


class AdmissionController:
    """Concurrency gate + bounded per-class wait queues.

    ``max_concurrent=0`` disables the gate entirely (admit() still
    tracks metrics and the slow-query log / default deadline still
    apply), which keeps single-node test servers byte-for-byte on the
    old code path.
    """

    def __init__(self, max_concurrent: int = 0, max_queue: int = 64,
                 weights: dict[str, int] | None = None,
                 internal_reserve: int = 4,
                 default_deadline: float = 0.0,
                 stats=None, slow_log=None, adaptive=None):
        self.max_concurrent = int(max_concurrent)
        #: Optional AdaptiveLimit: when set, the public concurrency
        #: limit is its measured value (max_concurrent is the ceiling).
        self.adaptive = adaptive
        self.max_queue = max(0, int(max_queue))
        self.weights = dict(DEFAULT_WEIGHTS)
        if weights:
            self.weights.update({normalize_class(k): int(v)
                                 for k, v in weights.items()})
        self.internal_reserve = max(0, int(internal_reserve))
        self.default_deadline = float(default_deadline)
        self.slow_log = slow_log
        self._stats = stats
        self._cv = threading.Condition()
        self._active = 0
        self._queues: dict[str, deque[_Waiter]] = {c: deque() for c in QOS_CLASSES}
        # smooth-WRR credit per class (Nginx upstream algorithm)
        self._credit: dict[str, float] = {c: 0.0 for c in QOS_CLASSES}
        self._shed_total = 0
        self._deadline_miss_total = 0
        self._admitted_total = 0

    # -- scheduling ---------------------------------------------------

    def _current_limit(self) -> int:
        if self.adaptive is not None:
            return min(self.max_concurrent, self.adaptive.limit)
        return self.max_concurrent

    def _limit_for(self, cls: str) -> int:
        if cls == CLASS_INTERNAL:
            # The reserve rides above the *ceiling*, not the adaptive
            # value: remote fan-out legs must stay deadlock-free even
            # when the public limit has backed off to its floor.
            return self.max_concurrent + self.internal_reserve
        return self._current_limit()

    def _queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _pick_class(self) -> str | None:
        """Smooth weighted round-robin over non-empty queues that have
        headroom under their class limit. Called with the lock held."""
        eligible = [c for c, q in self._queues.items()
                    if q and self._active < self._limit_for(c)]
        if not eligible:
            return None
        total = 0
        best = None
        for c in eligible:
            w = self.weights.get(c, 1)
            total += w
            self._credit[c] += w
            if best is None or self._credit[c] > self._credit[best]:
                best = c
        self._credit[best] -= total
        return best

    def _grant_next(self) -> None:
        """Hand freed slots to queued waiters. Called with lock held."""
        while True:
            cls = self._pick_class()
            if cls is None:
                return
            w = self._queues[cls].popleft()
            if w.abandoned:
                continue
            w.granted = True
            self._active += 1
            self._cv.notify_all()

    # -- admission ----------------------------------------------------

    def _retry_after(self) -> float:
        # Rough drain estimate: one "generation" of the queue per slot
        # turn; clamp to a 1..30s hint so clients neither hammer nor
        # stay away forever.
        if self.max_concurrent <= 0:
            return 1.0
        depth = self._queued()
        return min(30.0, max(1.0, round(depth / self.max_concurrent + 0.5)))

    def acquire(self, cls: str, deadline: Deadline | None = None) -> None:
        cls = normalize_class(cls)
        if self.max_concurrent <= 0:
            self._count("qos.admitted", cls)
            self._admitted_total += 1
            return
        t0 = time.perf_counter()
        with self._cv:
            if self._active < self._limit_for(cls) and not self._queues[cls]:
                self._active += 1
                self._admit_metrics(cls, t0)
                return
            if self._queued() >= self.max_queue:
                self._shed_total += 1
                self._count("qos.shed", cls)
                raise QueryShedError(retry_after=self._retry_after())
            w = _Waiter(cls)
            self._queues[cls].append(w)
            try:
                while not w.granted:
                    timeout = None
                    if deadline is not None:
                        timeout = deadline.remaining()
                        if deadline.cancelled or \
                                (timeout is not None and timeout <= 0):
                            raise DeadlineExceededError(
                                "deadline expired while queued for admission")
                    self._cv.wait(timeout=timeout)
            except BaseException as e:
                if w.granted:
                    # Granted concurrently with the timeout/interrupt:
                    # the slot is ours, give it back properly.
                    self._active -= 1
                    self._grant_next()
                else:
                    w.abandoned = True
                if isinstance(e, DeadlineExceededError):
                    self._deadline_miss_total += 1
                    self._count("qos.deadlineMiss", cls)
                raise
            self._admit_metrics(cls, t0)

    def release(self) -> None:
        if self.max_concurrent <= 0:
            return
        with self._cv:
            self._active -= 1
            self._grant_next()

    @contextlib.contextmanager
    def admit(self, cls: str, deadline: Deadline | None = None):
        if deadline is None:
            deadline = current_deadline()
        t0 = time.perf_counter()
        self.acquire(cls, deadline)
        t1 = time.perf_counter()
        prof = _profile.current()
        if prof is not None:
            prof.add_ms("admissionWaitMs", (t1 - t0) * 1000.0)
        try:
            yield
        finally:
            self.release()
            # Feed the gradient limit from public classes only: the
            # internal reserve rides above the adaptive limit, so its
            # latency says nothing about the gate this tunes.
            if self.adaptive is not None and self.max_concurrent > 0 \
                    and normalize_class(cls) != CLASS_INTERNAL:
                self.adaptive.observe(t1 - t0, time.perf_counter() - t1)

    # -- observability ------------------------------------------------

    def _count(self, name: str, cls: str) -> None:
        if self._stats is not None:
            self._stats.with_tags(f"class:{cls}").count(name, 1)

    def _admit_metrics(self, cls: str, t0: float) -> None:
        self._admitted_total += 1
        if self._stats is not None:
            sc = self._stats.with_tags(f"class:{cls}")
            sc.count("qos.admitted", 1)
            sc.timing("qos.waitSeconds", time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._cv:
            queued = {c: len(q) for c, q in self._queues.items()}
        out = {
            "active": self._active,
            "queued": queued,
            "queuedTotal": sum(queued.values()),
            "admitted": self._admitted_total,
            "shed": self._shed_total,
            "deadlineMiss": self._deadline_miss_total,
            "maxConcurrent": self.max_concurrent,
            "maxQueue": self.max_queue,
            "limit": self._current_limit(),
        }
        if self.adaptive is not None:
            out["adaptive"] = self.adaptive.snapshot()
        return out

    def export_gauges(self, stats) -> None:
        snap = self.snapshot()
        stats.gauge("qos.active", float(snap["active"]))
        stats.gauge("qos.queueDepth", float(snap["queuedTotal"]))
        if self.adaptive is not None:
            stats.gauge("qos.adaptiveLimit", float(snap["limit"]))
        for c, n in snap["queued"].items():
            stats.with_tags(f"class:{c}").gauge("qos.queueDepth", float(n))
