"""Fixed log-bucket histograms: bounded memory, mergeable, quantiles.

Replaces unbounded per-key timing lists in MemoryStats (a
sustained-traffic memory leak) with O(buckets) state per series. The
bucket layout is FIXED at construction — log-spaced bounds — so two
histograms with the same bounds merge by adding counts, which is what
the cluster /metrics aggregation and the bench harness need.

Each bucket also retains the LAST observation's (value, trace_id) as an
exemplar; prometheus_text() emits exemplars only on p99-and-above
buckets, so a slow bucket in a Grafana heatmap links straight to a
retained profile at /debug/queries/<trace-id>.

The port's copy of pilosa_tpu/obs/histogram.py.
"""

from __future__ import annotations

import bisect
import threading

#: default bounds for latency-in-seconds series: 100 µs doubling up to
#: ~13 s (18 finite buckets + the implicit +Inf). One query's histogram
#: is ~20 machine words — the whole registry stays bounded no matter how
#: long the node serves.
SECONDS_BOUNDS: tuple[float, ...] = tuple(1e-4 * (2 ** i) for i in range(18))

#: bounds for small-integer width series (coalesce batch width,
#: TransferBatcher wave width, queue depth): exact powers of two.
WIDTH_BOUNDS: tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class LogHistogram:
    """Fixed-bound histogram with per-bucket exemplars.

    ``lock=False`` skips the internal lock for callers that already
    serialize observes (MemoryStats holds its registry lock around every
    ``timing()``), keeping the hot path to one bisect + three adds.
    """

    __slots__ = ("bounds", "counts", "sum", "count", "_exemplars", "_lock")

    def __init__(self, bounds: tuple[float, ...] = SECONDS_BOUNDS,
                 lock: bool = True):
        self.bounds = tuple(bounds)
        # counts[i] observations fell in (bounds[i-1], bounds[i]];
        # counts[-1] is the +Inf overflow bucket.
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self._exemplars: dict[int, tuple[float, str]] = {}
        self._lock = threading.Lock() if lock else None

    def observe(self, value: float, trace_id: str | None = None) -> None:
        i = bisect.bisect_left(self.bounds, value)
        if self._lock is not None:
            with self._lock:
                self._observe_at(i, value, trace_id)
        else:
            self._observe_at(i, value, trace_id)

    def _observe_at(self, i: int, value: float, trace_id) -> None:
        self.counts[i] += 1
        self.sum += value
        self.count += 1
        if trace_id:
            self._exemplars[i] = (value, trace_id)

    def merge(self, other: "LogHistogram") -> None:
        """Fold another histogram (same bounds) into this one."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        self._exemplars.update(other._exemplars)

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation inside the
        bucket the rank lands in (0 when empty; the last finite bound
        when the rank falls in +Inf — a floor, clearly marked bounded)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i >= len(self.bounds):        # +Inf bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.bounds[-1]

    def bucket_items(self) -> list[tuple[str, int]]:
        """Cumulative (le_label, count) pairs for Prometheus exposition,
        ending with ("+Inf", total)."""
        out = []
        cum = 0
        for i, b in enumerate(self.bounds):
            cum += self.counts[i]
            out.append((f"{b:g}", cum))
        out.append(("+Inf", self.count))
        return out

    def p99_bucket_index(self) -> int:
        """Index of the bucket containing p99 — exemplar emission is
        gated to buckets at or above this index."""
        if self.count == 0:
            return len(self.counts)
        rank = 0.99 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return i
        return len(self.counts) - 1

    def exemplar(self, i: int) -> tuple[float, str] | None:
        return self._exemplars.get(i)

    def snapshot(self) -> dict:
        """Plain-JSON view for the /debug endpoints."""
        return {
            "count": self.count,
            "sum": self.sum,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
            "buckets": [
                {"le": le, "count": c} for le, c in self.bucket_items()
                if c > 0 or le == "+Inf"
            ],
        }
