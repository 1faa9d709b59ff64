"""Adaptive concurrency limit: gradient/AIMD over measured admit latency.

The static ``qos-max-concurrent`` gate shipped in the QoS PR has to be
hand-tuned per accelerator generation: too low wastes the device, too
high queues work until deadlines blow. The fix (TCP Vegas, Netflix
concurrency-limits) is to *measure* — probe the limit up while admitted
latency holds near its historical floor, back off multiplicatively the
moment queue wait or service time grows. ``qos-max-concurrent`` becomes
the ceiling; the operative limit lives here.

Deliberately sample-windowed rather than wall-clocked: adjustments
happen every ``window`` completed requests, so tests drive the limit
deterministically by feeding observations — no clock injection, no
sleeps.

The port's copy of pilosa_tpu/qos/adaptive.py.
"""

from __future__ import annotations

import threading

#: Queue wait below this is noise, never congestion (5ms — thread
#: handoff + GIL scheduling jitter on a loaded host).
MIN_WAIT_FLOOR = 0.005


class AdaptiveLimit:
    """AIMD concurrency limit fed by (queue-wait, service-time) samples.

    Every ``window`` observations the window is judged: if mean queue
    wait exceeded the floor or median service time grew past
    ``latency_ratio`` × the no-load baseline, the limit backs off
    multiplicatively (× ``backoff``); otherwise it probes up by one,
    capped at ``ceiling``. The baseline tracks the window *minimum* via
    a slow EWMA so a legitimately heavier workload re-anchors it instead
    of pinning the limit at the floor forever.
    """

    def __init__(self, ceiling: int, floor: int = 1, window: int = 16,
                 backoff: float = 0.8, latency_ratio: float = 1.5,
                 stats=None):
        if ceiling < 1:
            raise ValueError("adaptive ceiling must be >= 1")
        self.ceiling = ceiling
        self.floor = max(1, min(floor, ceiling))
        self.window = max(1, window)
        self.backoff = backoff
        self.latency_ratio = latency_ratio
        self.stats = stats
        # Start in the middle: room to probe up on an idle system and
        # headroom to shed fast if the first window is already hot.
        self._limit = max(self.floor, ceiling // 2)
        self._waits: list[float] = []
        self._services: list[float] = []
        self._baseline: float = 0.0  # EWMA of window-min service time
        self._increases = 0
        self._decreases = 0
        self._lock = threading.Lock()

    @property
    def limit(self) -> int:
        return self._limit

    def observe(self, wait_s: float, service_s: float) -> None:
        """Record one admitted request's queue wait and service time."""
        with self._lock:
            self._waits.append(wait_s)
            self._services.append(service_s)
            if len(self._waits) >= self.window:
                self._adjust()

    def _adjust(self) -> None:
        waits, services = self._waits, self._services
        self._waits, self._services = [], []
        mean_wait = sum(waits) / len(waits)
        ordered = sorted(services)
        p50 = ordered[len(ordered) // 2]
        wmin = ordered[0]
        if self._baseline <= 0.0:
            self._baseline = wmin
        congested = mean_wait > max(MIN_WAIT_FLOOR, 0.5 * self._baseline)
        if not congested and self._baseline > 0.0:
            congested = p50 > self.latency_ratio * self._baseline
        if congested:
            new = max(self.floor, int(self._limit * self.backoff))
            if new == self._limit and new > self.floor:
                new -= 1  # backoff must always make progress
            if new != self._limit:
                self._decreases += 1
            self._limit = new
        elif self._limit < self.ceiling:
            self._limit += 1
            self._increases += 1
        # Track the achievable floor, not the congested value: EWMA
        # toward the window min so baseline follows real shifts slowly.
        self._baseline += 0.1 * (wmin - self._baseline)
        if self.stats is not None:
            self.stats.gauge("qos.adaptiveLimit", float(self._limit))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "limit": self._limit,
                "ceiling": self.ceiling,
                "floor": self.floor,
                "baselineMs": round(self._baseline * 1000.0, 3),
                "increases": self._increases,
                "decreases": self._decreases,
                "pending": len(self._waits),
            }
