"""Per-query cost profiles: where did these 2.8 ms go?

A QueryProfile is a contextvar-scoped ledger accumulated along the whole
read path: admission wait, parse + plan, result-cache lookup, per-step
dispatch count and device ms (fused vs stepped, coalesce batch width),
TransferBatcher wave membership, and one entry per remote leg (wire
bytes in/out, decode ms, rtt, hedge/breaker events) with the remote
node's own profile nested inside — a cluster query returns a complete
cross-node timeline.

Enablement is opt-in per query (``?profile=true``: the profile rides
inline in the response envelope and the query is exempt from the result
cache) and always-on for retention: the coordinator keeps the slowest N
profiles in a ProfileRing served at ``/debug/queries`` and
``/debug/queries/<trace-id>``. When no profile is active, every hook in
the hot path is one contextvar read returning None — the off path
allocates nothing (asserted by tests/test_obs.py equivalence test).

Threading: legs land from map_reduce pool threads and dispatch records
land from the coalescer's flusher thread (which the profile reaches by
captured reference, not contextvar), so mutation goes through one lock.

The port's copy of pilosa_tpu/obs/profile.py.
"""

from __future__ import annotations

import contextvars
import threading
import time

_current_profile: contextvars.ContextVar["QueryProfile | None"] = \
    contextvars.ContextVar("pilosa_profile", default=None)

#: per-query bounded detail lists (dispatch widths, wave widths, legs):
#: a pathological query cannot grow its own profile without bound.
MAX_DETAIL = 128


def current() -> "QueryProfile | None":
    """The active profile, or None (the entire cost of profiling-off)."""
    return _current_profile.get()


def activate(prof: "QueryProfile | None"):
    """Install ``prof`` as the active profile; returns a reset token."""
    return _current_profile.set(prof)


def deactivate(token) -> None:
    _current_profile.reset(token)


class QueryProfile:
    """One query's cost ledger. Cheap to create, locked to mutate."""

    __slots__ = ("trace_id", "query", "index", "node", "qos_class",
                 "remote", "start", "timings", "cache_hit", "fused_steps",
                 "dispatches", "dispatch_widths", "device_ms",
                 "transfer_waves", "wave_widths", "inline_steals",
                 "remote_legs", "events", "status", "_lock")

    def __init__(self, trace_id: str, query: str = "", index: str = "",
                 node: str = "", qos_class: str = "", remote: bool = False):
        self.trace_id = trace_id
        self.query = query[:512]
        self.index = index
        self.node = node
        self.qos_class = qos_class
        self.remote = remote
        self.start = time.perf_counter()
        self.timings: dict[str, float] = {}      # phase -> ms
        self.cache_hit = False
        self.fused_steps = 0
        self.dispatches = 0
        self.dispatch_widths: list[int] = []
        self.device_ms = 0.0
        self.transfer_waves = 0
        self.wave_widths: list[int] = []
        self.inline_steals = 0
        # Lazy: most queries never grow a leg or an event — allocating
        # these in the ctor would tax every profiled local query.
        self.remote_legs: list[dict] | None = None
        self.events: dict[str, int] | None = None
        self.status = "ok"
        self._lock = threading.Lock()

    # -- recording hooks (each guarded by `current() is None` upstream) --

    def add_ms(self, phase: str, ms: float) -> None:
        with self._lock:
            self.timings[phase] = self.timings.get(phase, 0.0) + ms

    def add_dispatch(self, width: int, device_ms: float = 0.0) -> None:
        with self._lock:
            self.dispatches += 1
            self.device_ms += device_ms
            if len(self.dispatch_widths) < MAX_DETAIL:
                self.dispatch_widths.append(int(width))

    def add_wave(self, width: int) -> None:
        with self._lock:
            self.transfer_waves += 1
            if len(self.wave_widths) < MAX_DETAIL:
                self.wave_widths.append(int(width))

    def add_inline_steal(self) -> None:
        with self._lock:
            self.inline_steals += 1

    def add_remote_leg(self, node: str, shards: int, bytes_out: int,
                       bytes_in: int, decode_ms: float, rtt_ms: float,
                       hedged: bool = False, error: str = "",
                       remote: dict | None = None) -> None:
        with self._lock:
            if self.remote_legs is None:
                self.remote_legs = []
            elif len(self.remote_legs) >= MAX_DETAIL:
                return
            leg = {"node": node, "shards": shards,
                   "bytesOut": int(bytes_out), "bytesIn": int(bytes_in),
                   "decodeMs": round(decode_ms, 4),
                   "rttMs": round(rtt_ms, 4), "hedged": bool(hedged)}
            if error:
                leg["error"] = error
            if remote:
                leg["remote"] = remote
            self.remote_legs.append(leg)

    def bump(self, event: str, n: int = 1) -> None:
        with self._lock:
            if self.events is None:
                self.events = {}
            self.events[event] = self.events.get(event, 0) + n

    # -- rendering -------------------------------------------------------

    def finish(self) -> dict:
        """Close the ledger and render it. The remote totals are SUMS of
        the per-leg entries by construction, so the acceptance invariant
        (per-peer bytes/decode-ms sum to the coordinator totals) holds
        exactly; the tests assert the legs themselves are each recorded
        once."""
        with self._lock:
            total_ms = (time.perf_counter() - self.start) * 1000.0
            self.timings.setdefault("totalMs", round(total_ms, 4))
            doc = {
                "traceId": self.trace_id,
                "node": self.node,
                "query": self.query,
                "index": self.index,
                "qosClass": self.qos_class,
                "status": self.status,
                "timings": {k: round(v, 4) for k, v in self.timings.items()},
                "cacheHit": self.cache_hit,
                "fusedSteps": self.fused_steps,
                "dispatch": {
                    "count": self.dispatches,
                    "deviceMs": round(self.device_ms, 4),
                    "widths": list(self.dispatch_widths),
                },
                "transfer": {
                    "waves": self.transfer_waves,
                    "widths": list(self.wave_widths),
                    "inlineSteals": self.inline_steals,
                },
            }
            if self.events:
                doc["events"] = dict(self.events)
            if self.remote_legs:
                legs = [dict(leg) for leg in self.remote_legs]
                doc["remoteLegs"] = legs
                doc["remoteTotals"] = {
                    "legs": len(legs),
                    "bytesOut": sum(leg["bytesOut"] for leg in legs),
                    "bytesIn": sum(leg["bytesIn"] for leg in legs),
                    "decodeMs": round(sum(leg["decodeMs"] for leg in legs),
                                      4),
                    "rttMs": round(sum(leg["rttMs"] for leg in legs), 4),
                    "hedgedLegs": sum(1 for leg in legs if leg["hedged"]),
                    "errorLegs": sum(1 for leg in legs if "error" in leg),
                }
            return doc


class ProfileRing:
    """Retain the slowest-N finished profiles, addressable by trace id.

    ``record()`` takes the dict ``QueryProfile.finish()`` produced —
    retention happens after response write, so keeping dicts (not live
    profiles) means /debug/queries never races an in-flight ledger.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}     # trace_id -> finished doc

    def record(self, doc: dict) -> None:
        tid = doc.get("traceId")
        if not tid:
            return
        ms = doc.get("timings", {}).get("totalMs", 0.0)
        with self._lock:
            prev = self._entries.get(tid)
            if prev is not None:
                # Same trace re-observed (retry): keep the slower run.
                if prev.get("timings", {}).get("totalMs", 0.0) >= ms:
                    return
            self._entries[tid] = doc
            if len(self._entries) > self.capacity:
                fastest = min(
                    self._entries,
                    key=lambda t: self._entries[t].get("timings", {})
                    .get("totalMs", 0.0))
                del self._entries[fastest]

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            return self._entries.get(trace_id)

    def snapshot(self) -> list[dict]:
        """Slowest-first listing for /debug/queries."""
        with self._lock:
            docs = list(self._entries.values())
        docs.sort(key=lambda d: d.get("timings", {}).get("totalMs", 0.0),
                  reverse=True)
        return docs

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
