"""Query deadlines: a cancellation token created at the HTTP edge and
threaded through the executor, planner dispatch, and cluster fan-out.

Reference: the Go executor bounds work with context deadlines flowing
through ``executor.Execute`` (executor.go:113) and every mapReduce hop;
urllib has no context, so the token travels the same way the trace id
does (obs/tracing.py): a contextvar inside one node, and an absolute
``X-Deadline`` epoch timestamp on node-to-node requests which the
receiving node re-derives into a fresh token.

The absolute-timestamp wire format assumes roughly-synchronized clocks
between nodes (NTP-level skew). That is the same trade the reference's
gRPC deadline propagation makes; a skewed clock fails toward running a
query slightly longer or shorter, never toward wrong results.

The port's copy of pilosa_tpu/qos/deadline.py.
"""

from __future__ import annotations

import contextvars
import time


DEADLINE_HEADER = "X-Deadline"


class DeadlineExceededError(RuntimeError):
    """The query's deadline passed (or it was cancelled) — maps to HTTP
    504 at the edge. Deliberately NOT a PilosaError: the 400-family
    handlers must never swallow it as a bad query."""

    def __init__(self, message: str = "query deadline exceeded"):
        super().__init__(message)


class Deadline:
    """Absolute-expiry token, checked between plan steps.

    ``expires_at`` is unix epoch seconds (None = no time limit, only
    explicit cancellation). ``check()`` is the one integration point:
    cheap enough for per-step use, raising DeadlineExceededError once
    the budget is spent so expired queries stop consuming device time.
    """

    __slots__ = ("expires_at", "_cancelled")

    def __init__(self, timeout: float | None = None,
                 expires_at: float | None = None):
        if expires_at is None and timeout is not None:
            expires_at = time.time() + float(timeout)
        self.expires_at = expires_at
        self._cancelled = False

    def remaining(self) -> float | None:
        """Seconds left, or None when there is no time limit."""
        if self.expires_at is None:
            return None
        return self.expires_at - time.time()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> None:
        self._cancelled = True

    def expired(self) -> bool:
        if self._cancelled:
            return True
        rem = self.remaining()
        return rem is not None and rem <= 0

    def check(self) -> None:
        if self._cancelled:
            raise DeadlineExceededError("query cancelled")
        rem = self.remaining()
        if rem is not None and rem <= 0:
            raise DeadlineExceededError()

    def rederive(self) -> "Deadline":
        """A fresh token with the same absolute expiry — what a
        receiving node builds from the wire timestamp. Cancellation
        state intentionally does NOT cross the boundary; the peer sees
        cancellation as expiry only (same as HTTP)."""
        return Deadline(expires_at=self.expires_at)


#: the active query deadline, carried across node boundaries via
#: DEADLINE_HEADER (the tracing-contextvar pattern, obs/tracing.py:25).
_current: contextvars.ContextVar[Deadline | None] = \
    contextvars.ContextVar("pilosa_deadline", default=None)


def current_deadline() -> Deadline | None:
    return _current.get()


def set_current_deadline(dl: Deadline | None):
    """Returns a token for contextvars reset."""
    return _current.set(dl)


def reset_current_deadline(token) -> None:
    _current.reset(token)


def check_current() -> None:
    """Raise DeadlineExceededError if the active deadline (if any) is
    spent — the per-plan-step guard the executor and cluster fan-out
    call between units of work."""
    dl = _current.get()
    if dl is not None:
        dl.check()


def inject_http_headers(headers: dict) -> dict:
    """Attach the active deadline to an outgoing node-to-node request
    as an absolute epoch timestamp."""
    dl = _current.get()
    if dl is not None and dl.expires_at is not None:
        headers[DEADLINE_HEADER] = f"{dl.expires_at:.6f}"
    return headers


def extract_http_headers(headers) -> Deadline | None:
    """Re-derive a Deadline from an incoming request's header; None when
    absent or unparseable (a malformed header must not 500 a query —
    it degrades to 'no deadline', the pre-QoS behavior)."""
    raw = headers.get(DEADLINE_HEADER)
    if not raw:
        return None
    try:
        return Deadline(expires_at=float(raw))
    except (TypeError, ValueError):
        return None
