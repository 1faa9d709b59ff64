"""OTLP/HTTP trace exporter -- a concrete backend for the Tracer protocol.

The port's copy of pilosa_tpu/obs/otlp.py: the same payload, byte for
byte, for the same spans.

Reference: tracing/opentracing/opentracing.go (the Jaeger glue behind the
reference's Tracer interface). Here the wire format is OTLP/HTTP JSON
(``/v1/traces`` on a standard collector, default port 4318) so any
OpenTelemetry collector/Jaeger-all-in-one ingests it without a client
dependency -- the payload is assembled by hand and POSTed with urllib.

Spans batch in memory and flush on a background ticker (or when the
batch fills); export failures drop the batch and never block or break
the traced code path.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import urllib.request


def _trace_id_hex(trace_id: str | None) -> str:
    """Map our string correlation ids onto OTLP's 16-byte hex ids."""
    if not trace_id:
        trace_id = os.urandom(8).hex()
    return hashlib.md5(trace_id.encode()).hexdigest()  # 32 hex chars


class _OTLPSpan:
    __slots__ = ("operation", "trace_id", "span_id", "parent_id",
                 "start_ns", "end_ns", "tags", "_tracer")

    def __init__(self, tracer: "OTLPTracer", operation: str,
                 trace_id: str | None, parent_id: str | None):
        self._tracer = tracer
        self.operation = operation
        # Fixed at span START (not serialization): a per-payload random
        # fallback would split one logical trace across trace ids.
        self.trace_id = _trace_id_hex(trace_id)
        self.parent_id = parent_id
        self.span_id = os.urandom(8).hex()
        self.start_ns = time.time_ns()
        self.end_ns: int | None = None
        self.tags: dict = {}

    def set_tag(self, key, value) -> None:
        self.tags[key] = value

    def finish(self) -> None:
        if self.end_ns is None:
            self.end_ns = time.time_ns()
            self._tracer._enqueue(self)


class OTLPTracer:
    """Tracer protocol implementation exporting to an OTLP collector."""

    def __init__(self, endpoint: str = "http://127.0.0.1:4318/v1/traces",
                 service_name: str = "pilosa-tpu",
                 batch_size: int = 128, flush_interval: float = 2.0,
                 timeout: float = 5.0):
        self.endpoint = endpoint
        self.service_name = service_name
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.timeout = timeout
        self._buf: list[_OTLPSpan] = []
        self._lock = threading.Lock()
        self._closed = False
        self.exported = 0
        self.dropped = 0
        self._ticker = threading.Thread(target=self._run, daemon=True,
                                        name="otlp-export")
        self._ticker.start()

    # -- Tracer protocol ---------------------------------------------------

    def start_span(self, operation: str, parent_id: str | None = None):
        from pilosa_tpu_torch.obs import tracing
        return _OTLPSpan(self, operation, tracing.current_trace_id(),
                         parent_id)

    # -- batching ----------------------------------------------------------

    def _enqueue(self, span: _OTLPSpan) -> None:
        flush = False
        with self._lock:
            if self._closed:
                return
            self._buf.append(span)
            flush = len(self._buf) >= self.batch_size
        if flush:
            self.flush()

    def _run(self) -> None:
        while not self._closed:
            time.sleep(self.flush_interval)
            self.flush()

    def _payload(self, spans: list[_OTLPSpan]) -> bytes:
        otlp_spans = []
        for s in spans:
            attrs = [{"key": str(k),
                      "value": {"stringValue": str(v)}}
                     for k, v in s.tags.items()]
            otlp_spans.append({
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "parentSpanId": s.parent_id or "",
                "name": s.operation,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(s.start_ns),
                "endTimeUnixNano": str(s.end_ns),
                "attributes": attrs,
            })
        return json.dumps({"resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": self.service_name}}]},
            "scopeSpans": [{"scope": {"name": "pilosa_tpu"},
                            "spans": otlp_spans}],
        }]}).encode()

    def flush(self) -> None:
        with self._lock:
            spans, self._buf = self._buf, []
        if not spans:
            return
        req = urllib.request.Request(
            self.endpoint, data=self._payload(spans), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
            self.exported += len(spans)
        except Exception:
            self.dropped += len(spans)  # never break the traced path

    def close(self) -> None:
        self._closed = True
        self.flush()
