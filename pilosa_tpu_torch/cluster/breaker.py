"""Per-peer circuit breakers and the hedged-read policy.

Replica failover already survives a *dead* peer; the expensive case is
the *sick* one — alive enough to accept connections, slow enough that
every leg burns its full socket timeout before the failover wave kicks
in. The breaker turns that repeated discovery into one cheap check:
consecutive connection failures / deadline overruns open it, an open
breaker fast-fails new legs straight into the existing failover path,
and after a cooldown a single half-open probe decides whether to
re-close.

``BreakerOpenError`` subclasses ``ConnectionError`` on purpose: every
failover catch in the executor already handles ConnectionError, so a
fast-fail routes to replicas with zero changes to the reduce loop.

``HedgePolicy`` (Dean & Barroso, *The Tail at Scale*) lives here too:
it decides when a replicated read leg earns a backup request — after a
p95-based delay, bounded so hedges stay ~``budget_pct``% of traffic.

The port's copy of pilosa_tpu/cluster/breaker.py.
"""

from __future__ import annotations

import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class BreakerOpenError(ConnectionError):
    """Fast-fail: the peer's breaker is open; use a replica instead."""

    def __init__(self, peer_id: str, remaining_s: float):
        super().__init__(
            f"node {peer_id} circuit breaker open "
            f"(retry in {remaining_s:.1f}s)")
        self.peer_id = peer_id
        self.remaining_s = remaining_s


class CircuitBreaker:
    """Closed → (``threshold`` consecutive failures) → open →
    (``cooldown``) → half-open single probe → closed or re-open."""

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 clock=time.monotonic):
        self.threshold = max(1, threshold)
        self.cooldown = cooldown
        self.clock = clock
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False
        self._probe_started = 0.0
        self._opens = 0
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return CLOSED
            if self._probing or \
                    self.clock() - self._opened_at >= self.cooldown:
                return HALF_OPEN
            return OPEN

    @property
    def opens(self) -> int:
        return self._opens

    def allow(self) -> tuple[bool, float]:
        """(admit?, seconds-until-next-probe). At most one in-flight
        probe while half-open; everyone else keeps fast-failing. A
        probe lease that was never resolved (its thread died without
        reaching record_success/record_failure/abort) expires after one
        cooldown, so a lost probe can't fast-fail the peer forever."""
        with self._lock:
            if self._opened_at is None:
                return True, 0.0
            now = self.clock()
            elapsed = now - self._opened_at
            if elapsed >= self.cooldown:
                if self._probing and \
                        now - self._probe_started < self.cooldown:
                    return False, 0.0
                self._probing = True
                self._probe_started = now
                return True, 0.0
            return False, max(0.0, self.cooldown - elapsed)

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def abort(self) -> None:
        """Release a claimed half-open probe WITHOUT recording an
        outcome: the probe never reached the peer (e.g. the caller's
        own deadline expired before dialing), so it proves nothing
        about peer health. The cooldown is not restarted — the next
        request may immediately claim a fresh probe."""
        with self._lock:
            self._probing = False

    def record_failure(self) -> bool:
        """Returns True when this failure *transitions* the breaker to
        open (for metrics/logging; repeats while open don't count)."""
        with self._lock:
            if self._probing:
                # Failed half-open probe: restart the cooldown.
                self._probing = False
                self._opened_at = self.clock()
                return False
            self._failures += 1
            if self._opened_at is None and \
                    self._failures >= self.threshold:
                self._opened_at = self.clock()
                self._opens += 1
                return True
            return False


class BreakerRegistry:
    """Lazy per-peer breakers; the inter-node clients consult this
    before dialing and report outcomes back."""

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 clock=time.monotonic, stats=None, logger=None):
        self.threshold = threshold
        self.cooldown = cooldown
        self.clock = clock
        self.stats = stats
        self.logger = logger
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def _breaker(self, peer_id: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(peer_id)
            if br is None:
                br = CircuitBreaker(self.threshold, self.cooldown,
                                    self.clock)
                self._breakers[peer_id] = br
            return br

    def check(self, peer_id: str) -> None:
        """Raise BreakerOpenError when the peer should be fast-failed."""
        ok, remaining = self._breaker(peer_id).allow()
        if not ok:
            raise BreakerOpenError(peer_id, remaining)

    def record_success(self, peer_id: str) -> None:
        self._breaker(peer_id).record_success()

    def abort(self, peer_id: str) -> None:
        """Release a probe claimed by check() without an outcome (the
        request never reached the peer)."""
        self._breaker(peer_id).abort()

    def record_failure(self, peer_id: str) -> None:
        if self._breaker(peer_id).record_failure():
            if self.stats is not None:
                self.stats.with_tags(
                    f"peer:{peer_id}").count("cluster.breakerOpen", 1)
            if self.logger is not None:
                self.logger.warning(
                    "circuit breaker opened for peer %s "
                    "(threshold=%d, cooldown=%.1fs)",
                    peer_id, self.threshold, self.cooldown)

    def state(self, peer_id: str) -> str:
        return self._breaker(peer_id).state

    def snapshot(self) -> dict:
        with self._lock:
            peers = dict(self._breakers)
        return {
            "threshold": self.threshold,
            "cooldown": self.cooldown,
            "peers": {pid: {"state": br.state, "opens": br.opens}
                      for pid, br in peers.items()},
        }


class HedgePolicy:
    """Budgeted hedging for replicated read legs.

    A primary leg that hasn't answered within ``delay()`` earns one
    backup request to the next replica; first success wins. ``delay``
    is the observed p95 of recent primary legs (or the fixed
    ``delay_s`` override), so hedges target the tail by construction.
    ``try_fire`` enforces the budget: hedges never exceed ``burst``
    plus ``budget_pct``% of primary legs, so a cluster-wide slowdown
    can't double traffic.
    """

    def __init__(self, delay_s: float = 0.0, budget_pct: float = 5.0,
                 burst: int = 16, window: int = 64, min_samples: int = 8,
                 clock=time.perf_counter, stats=None):
        self.delay_s = delay_s
        self.budget_pct = budget_pct
        self.burst = burst
        self.window = window
        self.min_samples = min_samples
        self.clock = clock
        self.stats = stats
        self._latencies: list[float] = []
        self._primaries = 0
        self._fired = 0
        self._won = 0
        self._lock = threading.Lock()

    def note_primary(self) -> None:
        with self._lock:
            self._primaries += 1

    def observe(self, latency_s: float) -> None:
        with self._lock:
            self._latencies.append(latency_s)
            if len(self._latencies) > self.window:
                del self._latencies[:-self.window]

    def delay(self) -> float | None:
        """Seconds to wait before hedging, or None when we can't tell
        yet (no fixed override and too few latency samples)."""
        if self.delay_s > 0:
            return self.delay_s
        with self._lock:
            if len(self._latencies) < self.min_samples:
                return None
            ordered = sorted(self._latencies)
            return ordered[min(len(ordered) - 1,
                               int(len(ordered) * 0.95))]

    def try_fire(self) -> bool:
        """Claim budget for one hedge; False when exhausted."""
        with self._lock:
            allowed = self.burst + self._primaries * self.budget_pct / 100.0
            if self._fired + 1 > allowed:
                return False
            self._fired += 1
        if self.stats is not None:
            self.stats.count("cluster.hedgeFired", 1)
        return True

    def record_win(self) -> None:
        with self._lock:
            self._won += 1
        if self.stats is not None:
            self.stats.count("cluster.hedgeWon", 1)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "delayMsFixed": round(self.delay_s * 1000.0, 3),
                "budgetPct": self.budget_pct,
                "burst": self.burst,
                "primaries": self._primaries,
                "fired": self._fired,
                "won": self._won,
                "samples": len(self._latencies),
            }
