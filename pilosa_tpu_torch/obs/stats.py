"""Stats: tagged counters/gauges/timings.

Reference: stats/stats.go:31 (StatsClient interface: WithTags, Count,
Gauge, Histogram, Timing, SetLogger), default expvar backend, and
prometheus/prometheus.go scraped at /metrics. Here MemoryStats is the
expvar analog and doubles as the Prometheus registry — prometheus_text()
renders the exposition format without a client library.

The port's copy of pilosa_tpu/obs/stats.py.
"""

from __future__ import annotations

import threading
from typing import Protocol

from pilosa_tpu_torch.obs.histogram import LogHistogram
from pilosa_tpu_torch.obs.tracing import current_trace_id


class StatsClient(Protocol):
    def with_tags(self, *tags: str) -> "StatsClient": ...
    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None: ...
    def gauge(self, name: str, value: float) -> None: ...
    def timing(self, name: str, seconds: float) -> None: ...


class NopStats:
    """Reference NopStatsClient."""

    def with_tags(self, *tags: str) -> "NopStats":
        return self

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def timing(self, name: str, seconds: float) -> None:
        pass


class MemoryStats:
    """In-memory tagged metrics (expvar analog + prometheus registry)."""

    def __init__(self, tags: tuple[str, ...] = (), _parent=None):
        self.tags = tags
        if _parent is None:
            self._lock = threading.Lock()
            self.counters: dict[tuple[str, tuple], float] = {}
            self.gauges: dict[tuple[str, tuple], float] = {}
            # Bounded log-bucket histograms, NOT lists: a list would
            # grow one float per observation per series forever on a
            # sustained-traffic node. Each value is O(buckets).
            self.timings: dict[tuple[str, tuple], LogHistogram] = {}
        else:
            self._lock = _parent._lock
            self.counters = _parent.counters
            self.gauges = _parent.gauges
            self.timings = _parent.timings

    def with_tags(self, *tags: str) -> "MemoryStats":
        return MemoryStats(tuple(sorted(set(self.tags) | set(tags))),
                           _parent=self)

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        with self._lock:
            key = (name, self.tags)
            self.counters[key] = self.counters.get(key, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[(name, self.tags)] = value

    def timing(self, name: str, seconds: float) -> None:
        # Exemplar = the active trace id, read OUTSIDE the lock (one
        # contextvar get; None when untraced).
        tid = current_trace_id()
        with self._lock:
            key = (name, self.tags)
            h = self.timings.get(key)
            if h is None:
                # The registry lock already serializes observes.
                h = self.timings[key] = LogHistogram(lock=False)
            h.observe(seconds, trace_id=tid)

    def counter_value(self, name: str, *tags: str) -> float:
        return self.counters.get((name, tuple(sorted(tags))), 0)

    def timing_count(self, name: str, *tags: str) -> int:
        h = self.timings.get((name, tuple(sorted(tags))))
        return 0 if h is None else h.count

    def timing_sum(self, name: str, *tags: str) -> float:
        h = self.timings.get((name, tuple(sorted(tags))))
        return 0.0 if h is None else h.sum

    def timing_quantile(self, name: str, q: float, *tags: str) -> float:
        h = self.timings.get((name, tuple(sorted(tags))))
        return 0.0 if h is None else h.quantile(q)


class StatsdStats:
    """Fire-and-forget UDP statsd backend (reference statsd/statsd.go;
    tags use the datadog-style ``|#k:v`` suffix). Wraps every send in a
    broad except — metrics must never take the node down — and shares
    one socket across tag children."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "pilosa.", tags: tuple[str, ...] = (),
                 _parent=None):
        self.tags = tags
        if _parent is None:
            import socket
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._addr = (host, int(port))
            self.prefix = prefix
        else:
            self._sock = _parent._sock
            self._addr = _parent._addr
            self.prefix = _parent.prefix

    def with_tags(self, *tags: str) -> "StatsdStats":
        return StatsdStats(tags=tuple(sorted(set(self.tags) | set(tags))),
                           _parent=self)

    def _send(self, payload: str) -> None:
        try:
            if self.tags:
                payload += "|#" + ",".join(self.tags)
            self._sock.sendto(payload.encode(), self._addr)
        except OSError:
            pass

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        self._send(f"{self.prefix}{name}:{value}|c")

    def gauge(self, name: str, value: float) -> None:
        self._send(f"{self.prefix}{name}:{value}|g")

    def timing(self, name: str, seconds: float) -> None:
        self._send(f"{self.prefix}{name}:{seconds * 1e3:.3f}|ms")


def _fmt_labels(tags: tuple[str, ...], extra: str = "") -> str:
    """Render ``{k="v",...}``; ``extra`` is a pre-formatted pair (the
    histogram ``le=...`` label) merged after the tag labels."""
    pairs = []
    for t in tags:
        k, _, v = t.partition(":")
        pairs.append(f'{_sanitize(k)}="{v or "true"}"')
    if extra:
        pairs.append(extra)
    if not pairs:
        return ""
    return "{" + ",".join(pairs) + "}"


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def prometheus_text(stats: MemoryStats) -> str:
    """Prometheus exposition format (the /metrics payload,
    prometheus/prometheus.go analog)."""
    lines = []
    with stats._lock:
        for (name, tags), v in sorted(stats.counters.items()):
            lines.append(f"# TYPE pilosa_{_sanitize(name)} counter")
            lines.append(f"pilosa_{_sanitize(name)}{_fmt_labels(tags)} {v}")
        for (name, tags), v in sorted(stats.gauges.items()):
            lines.append(f"# TYPE pilosa_{_sanitize(name)} gauge")
            lines.append(f"pilosa_{_sanitize(name)}{_fmt_labels(tags)} {v}")
        for (name, tags), h in sorted(stats.timings.items()):
            n = _sanitize(name)
            # Timing keys like "qos.waitSeconds" already name the unit;
            # don't render pilosa_qos_waitSeconds_seconds.
            if n.lower().endswith("seconds"):
                n = n[:-len("seconds")].rstrip("_")
            lines.append(f"# TYPE pilosa_{n}_seconds histogram")
            p99 = h.p99_bucket_index()
            for i, (le, cum) in enumerate(h.bucket_items()):
                le_label = f'le="{le}"'
                line = (f"pilosa_{n}_seconds_bucket"
                        f"{_fmt_labels(tags, le_label)} {cum}")
                # OpenMetrics exemplar on p99-and-above buckets only:
                # the slow tail links to a retained /debug/queries
                # profile; fast buckets stay exemplar-free (payload
                # size, and nobody clicks into a p50 bucket).
                ex = h.exemplar(i) if i >= p99 else None
                if ex is not None:
                    val, tid = ex
                    line += f' # {{trace_id="{tid}"}} {val:g}'
                lines.append(line)
            lines.append(f"pilosa_{n}_seconds_count{_fmt_labels(tags)} "
                         f"{h.count}")
            lines.append(f"pilosa_{n}_seconds_sum{_fmt_labels(tags)} "
                         f"{h.sum}")
    return "\n".join(lines) + "\n"
