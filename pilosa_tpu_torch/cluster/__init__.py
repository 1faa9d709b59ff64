"""Cluster layer: membership, shard placement, node fan-out, replicated
writes and failover.

The port's copy of pilosa_tpu/cluster/, serving half: placement is a pure
function, node transport is an ``InternalClient`` (``LocalClient`` in
process for tests, ``server.httpclient.HTTPInternalClient`` between
processes), and the per-node compute underneath is the planner. Resize,
anti-entropy, the scrubber, translate sync and chaos faults come with
ROADMAP.md Queue 1: cluster and operations.
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
