"""Tracing: vendor-neutral Tracer/Span with a global singleton.

Reference: tracing/tracing.go (Tracer :32, Span :45, GlobalTracer :23,
StartSpanFromContext, InjectHTTPHeaders/ExtractHTTPHeaders for
cross-node propagation). SimpleTracer records spans in memory; a Jaeger/
OTLP exporter would implement the same two-method interface.

The port's copy of pilosa_tpu/obs/tracing.py.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Protocol

TRACE_HEADER = "X-Pilosa-Trace-Id"

#: the active trace correlation id, carried across node boundaries via
#: TRACE_HEADER (reference InjectHTTPHeaders/ExtractHTTPHeaders,
#: tracing.go:37-49 + the http client's span injection).
_current_trace: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("pilosa_trace", default=None)
_trace_seq = itertools.count(1)
_trace_prefix = f"{os.getpid():x}"


def current_trace_id() -> str | None:
    return _current_trace.get()


def new_trace_id() -> str:
    """Mint a fresh trace id (same scheme spans use: pid-hex + seq)."""
    return f"{_trace_prefix}-{next(_trace_seq)}"


def set_current_trace(trace_id: str | None):
    """Returns a token for contextvars reset."""
    return _current_trace.set(trace_id)


def reset_current_trace(token) -> None:
    _current_trace.reset(token)


def inject_http_headers(headers: dict) -> dict:
    """Attach the active trace id to outgoing node-to-node requests."""
    tid = _current_trace.get()
    if tid:
        headers[TRACE_HEADER] = tid
    return headers


def extract_http_headers(headers) -> str | None:
    """Read a propagated trace id from incoming request headers."""
    return headers.get(TRACE_HEADER)


class Span(Protocol):
    def finish(self) -> None: ...
    def set_tag(self, key: str, value) -> None: ...


class Tracer(Protocol):
    def start_span(self, operation: str, parent_id: str | None = None) -> Span: ...


class _NopSpan:
    def finish(self) -> None:
        pass

    def set_tag(self, key, value) -> None:
        pass


class NopTracer:
    """Reference NopTracer (tracing.go:52)."""

    def start_span(self, operation: str, parent_id: str | None = None):
        return _NopSpan()


@dataclass
class RecordedSpan:
    operation: str
    start: float
    parent_id: str | None = None
    end: float | None = None
    tags: dict = field(default_factory=dict)
    span_id: str = ""

    def finish(self) -> None:
        self.end = time.perf_counter()

    def set_tag(self, key, value) -> None:
        self.tags[key] = value

    @property
    def duration(self) -> float | None:
        return None if self.end is None else self.end - self.start


class SimpleTracer:
    """In-memory recording tracer (test + debugging backend)."""

    def __init__(self, max_spans: int = 10_000):
        self.spans: list[RecordedSpan] = []
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._next = 0

    def start_span(self, operation: str, parent_id: str | None = None):
        span = RecordedSpan(operation=operation, start=time.perf_counter(),
                            parent_id=parent_id)
        with self._lock:
            self._next += 1
            span.span_id = str(self._next)
            if len(self.spans) < self.max_spans:
                self.spans.append(span)
        return span


_global: Tracer = NopTracer()


def set_tracer(t: Tracer) -> None:
    global _global
    _global = t


def get_tracer() -> Tracer:
    return _global


@contextlib.contextmanager
def start_span(operation: str, parent_id: str | None = None):
    """with start_span("executor.Execute"): ... — the
    StartSpanFromContext analog used at executor/API boundaries. Spans
    join the active cross-node trace (starting one if absent) and tag
    themselves with its id, so a query's spans correlate across every
    node it touched."""
    tid = _current_trace.get()
    token = None
    if tid is None:
        tid = f"{_trace_prefix}-{next(_trace_seq)}"
        token = _current_trace.set(tid)
    span = _global.start_span(operation, parent_id)
    span.set_tag("trace.id", tid)
    try:
        yield span
    finally:
        span.finish()
        if token is not None:
            _current_trace.reset(token)
