"""Transport-level partition fault injection.

A :class:`PartitionFaults` table hangs off an internal client
(``HTTPInternalClient.faults`` / ``LocalClient.pair_faults``) and is
consulted before any request leaves this node for a peer. Two modes:

- ``drop``: the link is cut — the call fails immediately with
  ``ConnectionError``, exactly like a refused TCP connect.
- ``timeout``: the link is black-holed — the call blocks for
  ``delay_s`` (bounded; default one probe timeout) and then fails
  with ``ConnectionError``, like a SYN that never answers.

Faults are *outbound and per-direction*: blocking A→B says nothing
about B→A, which is what makes asymmetric-partition drills possible.
A symmetric split is just both sides configured (the harness and the
chaos drill do that for you).

Chaos-gated ``POST /internal/fault`` drives the HTTP table; the
``LocalCluster`` harness drives the in-process pair table directly.

The port's copy of pilosa_tpu/cluster/faults.py (host code: nothing here
touches the device).
"""

from __future__ import annotations

import threading
import time

#: ceiling for the ``timeout`` mode's sleep so a fat-fingered delayMs
#: can never wedge a server thread for minutes.
MAX_TIMEOUT_DELAY_S = 10.0


class PartitionFaults:
    """Thread-safe {peer_id: (mode, delay_s)} outbound fault table."""

    MODES = ("drop", "timeout")

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: dict[str, tuple[str, float]] = {}

    def set_fault(self, peer_id: str, mode: str = "drop",
                  delay_s: float = 0.0) -> None:
        if mode not in self.MODES:
            raise ValueError(f"unknown partition fault mode {mode!r} "
                             f"(want one of {self.MODES})")
        delay_s = min(max(0.0, float(delay_s)), MAX_TIMEOUT_DELAY_S)
        with self._lock:
            self._faults[peer_id] = (mode, delay_s)

    def clear(self, peer_id: str | None = None) -> None:
        """Heal one link (``peer_id``) or every link (``None``)."""
        with self._lock:
            if peer_id is None:
                self._faults.clear()
            else:
                self._faults.pop(peer_id, None)

    def blocked(self, peer_id: str) -> bool:
        with self._lock:
            return peer_id in self._faults

    def check(self, peer_id: str) -> None:
        """Raise ``ConnectionError`` if the link to ``peer_id`` is
        faulted, honoring the mode's delay first."""
        with self._lock:
            fault = self._faults.get(peer_id)
        if fault is None:
            return
        mode, delay_s = fault
        if mode == "timeout" and delay_s > 0.0:
            time.sleep(delay_s)
        raise ConnectionError(
            f"partition fault ({mode}): link to {peer_id} is down")

    def snapshot(self) -> dict:
        with self._lock:
            return {peer: {"mode": mode, "delayS": delay_s}
                    for peer, (mode, delay_s) in self._faults.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._faults)
