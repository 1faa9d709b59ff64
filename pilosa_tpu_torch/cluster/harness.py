"""In-process multi-node cluster: the analog of the reference's
``test.MustRunCluster(t, 3)`` (test/pilosa.go:343) — N fully-wired nodes
(holder + executor + cluster + transport) in one process, crossing a
PQL-string serialization boundary between nodes, no sockets.

Also the template a real deployment follows: swap LocalClient for the
HTTP client and each ClusterNode becomes one host's server process.

The port's copy of pilosa_tpu/cluster/harness.py: ``ClusterNode`` and
``LocalCluster`` with the schema and availability messages, index-dirty
broadcasts, failover, partitions and the liveness sweep. Nodes hold their
data on ``device`` (the card by default; the tests pass ``"cpu"``).
Resize (``add_node``, ``remove_node``, the resize messages) and data dirs
answer ``NotPortedError`` (ROADMAP.md Queue 1: cluster and operations), as
do keys on a cluster (the executor's).
"""

from __future__ import annotations

from typing import Any

from pilosa_tpu_torch.cluster.client import LocalClient
from pilosa_tpu_torch.cluster.cluster import STATE_NORMAL, Cluster
from pilosa_tpu_torch.cluster.node import URI, Node
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.errors import SLICE_CLUSTER, NotPortedError
from pilosa_tpu_torch.exec.executor import ExecOptions, Executor


def handle_cluster_message(holder: Holder, message: dict) -> None:
    """Apply a control-plane message to a node's holder (the 16 message
    types of broadcast.go:55-72; schema + shard availability subset)."""
    t = message.get("type")
    if t == "create-shard":
        f = holder.field(message["index"], message["field"])
        if f is not None:
            f.add_remote_available_shards([message["shard"]])
    elif t == "create-index":
        holder.create_index_if_not_exists(
            message["index"], IndexOptions.from_json(message.get("options", {})))
    elif t == "delete-index":
        if holder.index(message["index"]) is not None:
            holder.delete_index(message["index"])
    elif t == "create-field":
        idx = holder.index(message["index"])
        if idx is not None:
            idx.create_field_if_not_exists(
                message["field"],
                FieldOptions.from_json(message.get("options", {})))
    elif t == "delete-field":
        idx = holder.index(message["index"])
        if idx is not None and idx.field(message["field"]) is not None:
            idx.delete_field(message["field"])
    elif t == "delete-view":
        f = holder.field(message["index"], message["field"])
        if f is not None:
            # DeleteViewMessage (server.go:618): drop our copy of the
            # view; missing is fine — views don't exist on every node.
            f.delete_view(message["view"])


class ClusterNode:
    """One node: holder + executor + cluster view + request handlers
    (the handler surface LocalClient dispatches to — mirrors the
    /internal/* HTTP routes, http/handler.go:274)."""

    def __init__(self, node_id: str, cluster: Cluster, planner=None,
                 data_dir: str | None = None, store_factory=None,
                 device=None):
        if data_dir is not None:
            raise NotPortedError("a cluster node with a data dir", SLICE_CLUSTER)
        self.id = node_id
        from pilosa_tpu_torch.cluster.dirty import DirtyBroadcaster
        self.dirty = DirtyBroadcaster(cluster)
        # New local fragments broadcast CreateShardMessage so every node's
        # shard map stays complete (reference view.go:263-304); new
        # indexes wire their epoch to the cross-node dirty broadcaster.
        self.holder = Holder(device, fragment_listener=self._broadcast_shard,
                             index_listener=self.dirty.attach)
        self.cluster = cluster
        if callable(planner):
            planner = planner(self.holder)
        self.executor = Executor(self.holder, cluster=cluster, planner=planner)
        # Remote legs report their shard-epoch vectors back to the
        # coordinator's RemoteEpochTable (the cross-node half of result
        # cache stamps). The sink lives on the per-node Cluster because
        # the LocalClient transport is SHARED across harness nodes.
        cluster.epoch_sink = self.executor.remote_epochs.observe
        self.store = None
        self.scrubber = None

    def _broadcast_shard(self, index: str, field: str, view: str, shard: int):
        msg = {"type": "create-shard", "index": index, "field": field,
               "shard": shard}
        for node in self.cluster.nodes:
            if node.id == self.id or node.state == "DOWN":
                continue
            try:
                self.cluster.client.send_message(node, msg)
            except (ConnectionError, RuntimeError):
                pass  # best-effort, like the 50ms-timeout broadcast

    def handle_message(self, message: dict) -> None:
        t = message.get("type")
        if t == "index-dirty":
            if not self.cluster.check_fencing_token(message):
                return  # stale coordinator's dirty coordination
            from pilosa_tpu_torch.cluster.dirty import apply_index_dirty
            apply_index_dirty(self.holder, message,
                              self.executor.remote_epochs)
        elif t.startswith("resize-") or t in ("cluster-status", "cluster-state"):
            raise NotPortedError(f"the {t!r} message", SLICE_CLUSTER)
        else:
            handle_cluster_message(self.holder, message)

    def handle_import_request(self, index, field, rows=None, cols=None,
                              values=None, timestamps=None,
                              clear=False) -> None:
        from pilosa_tpu_torch.core.field import parse_stamps
        f = self.holder.field(index, field)
        if f is None:
            raise LookupError(f"field not found: {index}/{field}")
        if values is not None:
            f.import_values(cols, values, clear=clear)
        else:
            ts = parse_stamps(timestamps) if timestamps is not None else None
            f.import_bits(rows, cols, ts, clear=clear)
        # Owners track existence locally (executor.go:2096 analog).
        self.holder.index(index).add_existence(cols)

    # -- request handlers (the "server" surface) ---------------------------

    def handle_query(self, index: str, query: str,
                     shards: list[int] | None, remote: bool) -> list[Any]:
        opt = ExecOptions(remote=remote)
        return self.executor.execute(index, query, shards=shards, opt=opt)

    def handle_query_meta(self, index: str, query: str,
                          shards: list[int] | None,
                          remote: bool) -> tuple[list[Any], dict]:
        """handle_query plus this node's shard-epoch vector, read BEFORE
        the leg executes so the report is never fresher than the data in
        the result — a write landing mid-leg raises the next report and
        invalidates the coordinator's cached entry."""
        epochs: dict = {}
        idx = self.holder.index(index)
        if idx is not None and shards:
            epochs = idx.epoch.shard_vector(shards)
        return self.handle_query(index, query, shards, remote), epochs

    def handle_import_roaring(self, index, field, shard, data: bytes,
                              clear=False):
        f = self.holder.field(index, field)
        if f is None:
            raise LookupError(f"field not found: {index}/{field}")
        f.import_roaring(shard, data, clear=clear)

    def handle_nodes(self):
        return {"version": self.cluster.topology_version,
                "nodes": [n.to_json() for n in self.cluster.nodes],
                "state": self.cluster.state}

    def apply_schema(self, schema) -> None:
        self.holder.apply_schema(schema)

class LocalCluster:
    """N in-process nodes sharing a LocalClient transport."""

    def __init__(self, n: int, replica_n: int = 1, planner_factory=None,
                 data_dirs: list[str | None] | None = None,
                 store_factory=None, device=None):
        self.client = LocalClient()
        nodes = [Node(id=f"node{i}", uri=URI(host="localhost", port=10101 + i),
                      is_coordinator=(i == 0))
                 for i in range(n)]
        self.nodes: list[ClusterNode] = []
        for i in range(n):
            # Each node talks through a BOUND view of the shared
            # transport so directed pair faults (partition drills) apply
            # to its outbound traffic specifically.
            cluster = Cluster(local_id=f"node{i}",
                              nodes=[Node(id=m.id, uri=m.uri,
                                          is_coordinator=m.is_coordinator)
                                     for m in nodes],
                              replica_n=replica_n,
                              client=self.client.bind(f"node{i}"))
            cluster.set_state(STATE_NORMAL)
            # planner_factory(i) may return a planner, or a function of
            # the node's holder that makes one.
            planner = planner_factory(i) if planner_factory else None
            cn = ClusterNode(f"node{i}", cluster, planner=planner,
                             data_dir=(data_dirs[i] if data_dirs else None),
                             store_factory=store_factory, device=device)
            self.client.register(cn.id, cn)
            self.nodes.append(cn)

    def __getitem__(self, i: int) -> ClusterNode:
        return self.nodes[i]

    def create_index(self, name: str, options: IndexOptions | None = None):
        """Create the index + schema on every node (the reference
        broadcasts CreateIndexMessage, api.go:162)."""
        for cn in self.nodes:
            cn.holder.create_index_if_not_exists(name, options)

    def create_field(self, index: str, name: str, options=None):
        for cn in self.nodes:
            idx = cn.holder.index(index)
            idx.create_field_if_not_exists(name, options)

    def query(self, index: str, query: str, node: int = 0,
              cache: bool = True) -> list[Any]:
        """Run through one node as coordinator (Cluster.Query analog,
        test/pilosa.go:247). ``cache=False`` bypasses the coordinator's
        result cache (benchmarking the cold path)."""
        return self.nodes[node].executor.execute(index, query, cache=cache)

    def add_node(self, node_id: str | None = None,
                 coordinator: int = 0) -> "ClusterNode":
        raise NotPortedError("a cluster resize", SLICE_CLUSTER)

    def remove_node(self, node_id: str, coordinator: int = 0) -> None:
        raise NotPortedError("a cluster resize", SLICE_CLUSTER)

    def down(self, node_id: str) -> None:
        """Fault injection: the pumba 'pause container' analog
        (internal/clustertests/cluster_test.go:69)."""
        self.client.down.add(node_id)
        for cn in self.nodes:
            if cn.id != node_id:
                cn.cluster.node_leave(node_id)

    def up(self, node_id: str) -> None:
        self.client.down.discard(node_id)
        for cn in self.nodes:
            n = cn.cluster.node_by_id(node_id)
            if n is not None:
                n.state = "READY"
                cn.cluster._update_state()

    def slow(self, node_id: str, delay_s: float) -> None:
        """Fault injection: gray failure — the peer stays in the ring
        (membership probes still pass) but every query to it takes
        ``delay_s``. The breaker/hedge layer, not the failure detector,
        must route around it."""
        self.client.slow[node_id] = delay_s

    def fast(self, node_id: str) -> None:
        """Heal a slow-peer fault."""
        self.client.slow.pop(node_id, None)

    # -- partition faults --------------------------------------------------

    def _node_ids(self, group) -> set[str]:
        return {m if isinstance(m, str) else self.nodes[m].id
                for m in group}

    def partition(self, group, mode: str = "drop") -> None:
        """Symmetric network partition: every link between ``group``
        (node ids or indices) and the rest of the ring is cut, BOTH
        directions. Nodes inside a side still see each other — exactly
        the split-brain the quorum fence exists for. Unlike ``down``,
        membership state is untouched: each side's failure detector
        must discover the split itself."""
        side = self._node_ids(group)
        rest = {cn.id for cn in self.nodes} - side
        for a in side:
            for b in rest:
                self.client.set_pair_fault(a, b, mode)
                self.client.set_pair_fault(b, a, mode)

    def block_link(self, src, dst, mode: str = "drop") -> None:
        """Asymmetric fault: cut ONLY src->dst. dst can still reach
        src, and everyone else sees both — the case SWIM indirect
        probes keep from false-positiving into node-down churn."""
        (src_id,) = self._node_ids([src])
        (dst_id,) = self._node_ids([dst])
        self.client.set_pair_fault(src_id, dst_id, mode)

    def heal_partition(self) -> None:
        """Heal every partition fault (symmetric and asymmetric)."""
        self.client.clear_pair_faults()

    def check_all_nodes(self, discover: bool = False) -> None:
        """One failure-detector sweep on every node (deterministic
        drills run the detector by hand instead of on timers)."""
        from pilosa_tpu_torch.cluster.resize import check_nodes
        for cn in self.nodes:
            check_nodes(cn.cluster, cn.cluster.client, retries=1,
                        discover=discover)
