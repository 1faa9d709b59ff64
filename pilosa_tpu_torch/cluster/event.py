"""Node membership events.

Reference: event.go:18-31 (NodeEvent: Join/Leave/Update) — the typed
messages gossip delivers into cluster.ReceiveEvent (cluster.go:1754).
Here the sources are the failure detector (check_nodes) and the join
flow; ServerNode consumes the stream to log, count, and react (a peer
coming back triggers an immediate anti-entropy pass instead of waiting
out the ticker).

The port's copy of pilosa_tpu/cluster/event.py.
"""

from __future__ import annotations

from dataclasses import dataclass

# Distinct from the "node-join" CONTROL MESSAGE type (server.node's
# /internal/cluster/message dispatch) — these name membership events.
EVENT_JOIN = "join"
EVENT_LEAVE = "leave"
EVENT_UPDATE = "update"  # state change (DOWN <-> READY)


@dataclass
class NodeEvent:
    """Reference NodeEvent (event.go:18)."""

    type: str
    node_id: str
    state: str = ""
