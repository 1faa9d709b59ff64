"""Cluster layer: membership, shard placement, node fan-out, replicated
writes and failover.

The port's copy of pilosa_tpu/cluster/: placement is a pure function,
node transport is an ``InternalClient`` (``LocalClient`` in process for
tests, ``server.httpclient.HTTPInternalClient`` between processes), and
the per-node compute underneath is the planner. The serve-through resize
(``resize``, ``migration``, ``cleaner``), anti-entropy (``sync``), the
scrubber, coordinator-primary keys (``translate_sync``) and chaos faults
(``faults``) are host code over that transport.
"""

from pilosa_tpu_torch.cluster.cluster import (
    STATE_DEGRADED,
    STATE_NORMAL,
    STATE_RESIZING,
    STATE_STARTING,
    Cluster,
)
from pilosa_tpu_torch.cluster.client import InternalClient, LocalClient, NopClient
from pilosa_tpu_torch.cluster.node import Node
from pilosa_tpu_torch.cluster.placement import fnv1a64, jump_hash, partition

__all__ = [
    "Cluster", "InternalClient", "LocalClient", "NopClient", "Node",
    "fnv1a64", "jump_hash", "partition",
    "STATE_STARTING", "STATE_NORMAL", "STATE_DEGRADED", "STATE_RESIZING",
]
