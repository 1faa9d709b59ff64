"""Observability: stats, tracing, logging, query profiles.

The port's copy of pilosa_tpu/obs/ (``heap.py`` and ``runtime.py`` read
the codec's pool through the port's own loader, pilosa_tpu_torch.native),
with ``otlp.py``, the OTLP/HTTP trace exporter behind ``--trace-endpoint``.

Reference: stats/ (StatsClient stats.go:31, expvar default, statsd/,
prometheus/), tracing/ (Tracer/Span tracing.go:32, global singleton :23),
logger/ (logger.go).
"""

from pilosa_tpu_torch.obs.histogram import (
    SECONDS_BOUNDS,
    WIDTH_BOUNDS,
    LogHistogram,
)
from pilosa_tpu_torch.obs.logger import Logger, NopLogger, StandardLogger
from pilosa_tpu_torch.obs.otlp import OTLPTracer
from pilosa_tpu_torch.obs.profile import ProfileRing, QueryProfile
from pilosa_tpu_torch.obs.profiler import sample_profile
from pilosa_tpu_torch.obs.stats import (
    MemoryStats,
    NopStats,
    StatsClient,
    StatsdStats,
    prometheus_text,
)
from pilosa_tpu_torch.obs.tracing import (
    NopTracer,
    SimpleTracer,
    Span,
    Tracer,
    current_trace_id,
    get_tracer,
    new_trace_id,
    set_tracer,
    start_span,
)

__all__ = [
    "Logger", "NopLogger", "StandardLogger",
    "LogHistogram", "SECONDS_BOUNDS", "WIDTH_BOUNDS",
    "MemoryStats", "NopStats", "StatsClient", "StatsdStats",
    "ProfileRing", "QueryProfile",
    "prometheus_text",
    "NopTracer", "OTLPTracer", "SimpleTracer", "Span", "Tracer",
    "current_trace_id", "get_tracer", "new_trace_id", "sample_profile",
    "set_tracer", "start_span",
]
