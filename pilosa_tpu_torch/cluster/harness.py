"""In-process multi-node cluster: the analog of the reference's
``test.MustRunCluster(t, 3)`` (test/pilosa.go:343) — N fully-wired nodes
(holder + executor + cluster + transport) in one process, crossing a
PQL-string serialization boundary between nodes, no sockets.

Also the template a real deployment follows: swap LocalClient for the
HTTP client and each ClusterNode becomes one host's server process.

The port's copy of pilosa_tpu/cluster/harness.py: ``ClusterNode`` and
``LocalCluster`` with the schema, availability, index-dirty, resize and
topology messages, failover, partitions, the liveness sweep, data dirs
(``data_dirs``/``store_factory``), the serve-through resize
(``add_node``/``remove_node``), anti-entropy and scrub handlers, and
coordinator-primary keys (``sync_translation``). Nodes hold their data on
``device`` (the card by default; the tests pass ``"cpu"``).
"""

from __future__ import annotations

from typing import Any

from pilosa_tpu_torch.cluster.client import LocalClient
from pilosa_tpu_torch.cluster.cluster import STATE_NORMAL, Cluster
from pilosa_tpu_torch.cluster.node import URI, Node
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import IndexOptions
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
        from pilosa_tpu_torch.cluster.translate_sync import ClusterKeyTranslator
        self.translator = ClusterKeyTranslator(self.holder, cluster,
                                               cluster.client)
        self.executor.translator = self.translator
        #: optional durability, exactly like a server process: open the
        #: store (reload + integrity verification), route quarantined
        #: shards to replicas, and give the coordinator the blocked-
        #: shard view. store_factory lets tests swap FaultyDiskStore in.
        self.store = None
        self.scrubber = None
        if data_dir is not None:
            from pilosa_tpu_torch.cluster.scrub import (
                Scrubber,
                route_quarantined_to_replicas,
            )
            from pilosa_tpu_torch.storage.diskstore import DiskStore
            factory = store_factory or DiskStore
            self.store = factory(data_dir, self.holder)
            self.store.open()
            cluster.blocked_shards_fn = self.store.quarantine.blocked_shards
            route_quarantined_to_replicas(self.holder, cluster, self.store)
            self.scrubber = Scrubber(self.holder, cluster, cluster.client,
                                     self.store)

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
        if t == "resize-instruction":
            from pilosa_tpu_torch.cluster.resize import handle_resize_instruction
            handle_resize_instruction(self.holder, self.cluster.client,
                                      self.cluster, message, self.id)
        elif t == "resize-instruction-complete":
            from pilosa_tpu_torch.cluster.resize import deliver_completion
            deliver_completion(message)
        elif t == "index-dirty":
            if not self.cluster.check_fencing_token(message):
                return  # stale coordinator's dirty coordination
            from pilosa_tpu_torch.cluster.dirty import apply_index_dirty
            apply_index_dirty(self.holder, message,
                              self.executor.remote_epochs)
        elif t == "cluster-status":
            from pilosa_tpu_torch.cluster.cleaner import clean_holder
            from pilosa_tpu_torch.cluster.resize import apply_cluster_status
            apply_cluster_status(self.cluster, message["nodes"],
                                 holder=self.holder,
                                 availability=message.get("availability"),
                                 version=message.get("version"))
            clean_holder(self.holder, self.cluster)
        elif t == "cluster-state":
            from pilosa_tpu_torch.cluster.resize import apply_cluster_state
            apply_cluster_state(self.cluster, message["state"])
        elif t == "resize-begin":
            from pilosa_tpu_torch.cluster.resize import apply_resize_begin
            apply_resize_begin(self.cluster, message, holder=self.holder)
        elif t == "resize-end":
            from pilosa_tpu_torch.cluster.resize import apply_resize_end
            apply_resize_end(self.cluster, message)
        elif t == "resize-push":
            from pilosa_tpu_torch.cluster.resize import handle_resize_push
            return handle_resize_push(self.holder, self.cluster.client,
                                      self.cluster, message)
        elif t == "resize-shard-cutover":
            from pilosa_tpu_torch.cluster.resize import deliver_cutover
            deliver_cutover(message, self.cluster)
        elif t == "resize-dual-write-failed":
            from pilosa_tpu_torch.cluster.resize import deliver_dual_write_failed
            deliver_dual_write_failed(message)
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

    def handle_fragment_blocks(self, index, field, view, shard):
        frag = self.holder.fragment(index, field, view, shard)
        return frag.checksum_blocks() if frag else {}

    def handle_fragment_block_data(self, index, field, view, shard, block):
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            import numpy as np
            return np.empty(0, np.uint64), np.empty(0, np.uint64)
        return frag.block_data(block)

    def handle_import(self, index, field, view, shard, rows, cols,
                      clear=False):
        f = self.holder.field(index, field)
        if f is None:
            # Schema drift must surface, not silently drop repair data.
            raise LookupError(f"field not found: {index}/{field}")
        v = f.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(shard)
        frag.bulk_import(rows, cols, clear=clear)

    def handle_import_roaring(self, index, field, shard, data: bytes,
                              clear=False):
        f = self.holder.field(index, field)
        if f is None:
            raise LookupError(f"field not found: {index}/{field}")
        f.import_roaring(shard, data, clear=clear)

    def handle_import_stream(self, reqs: list[dict]) -> int:
        """In-process PTS1 stream: apply each bounded request in order,
        returning the applied count (the HTTP wire's applied-prefix
        contract, so a killed stream resumes where it stopped).
        kind="fragment" requests target one specific fragment (resize
        migration); field-kind requests take the same path as
        send_import so stream and unary imports are equivalent."""
        applied = 0
        for r in reqs:
            if r.get("kind") == "fragment" or "view" in r:
                self.handle_import(r["index"], r["field"], r["view"],
                                   r["shard"], r["rowIDs"], r["columnIDs"],
                                   clear=bool(r.get("clear")))
            else:
                self.handle_import_request(
                    r["index"], r["field"], rows=r.get("rowIDs"),
                    cols=r.get("columnIDs"), values=r.get("values"),
                    timestamps=r.get("timestamps"),
                    clear=bool(r.get("clear")))
            applied += 1
        return applied

    def handle_schema(self):
        return self.holder.schema()

    def handle_nodes(self):
        return {"version": self.cluster.topology_version,
                "nodes": [n.to_json() for n in self.cluster.nodes],
                "state": self.cluster.state}

    def apply_schema(self, schema) -> None:
        self.holder.apply_schema(schema)

    def handle_translate_keys(self, index, field, keys) -> list[int]:
        """Coordinator-side allocation (http/translator.go analog); the
        translator short-circuits to local stores on the coordinator."""
        return self.translator(index, field, list(keys))

    def handle_translate_entries(self, index, field, after_id):
        from pilosa_tpu_torch.cluster.translate_sync import translate_entries
        return translate_entries(self.holder, index, field, after_id)

    def handle_backup_keys(self):
        """Fragment keys this node holds durable files for (the backup
        coordinator's cluster-wide enumeration)."""
        if self.store is None:
            return []
        return [list(k) for k in self.store.all_fragment_keys()]

    def handle_backup_fragment(self, index, field, view, shard):
        """One fragment's archived pair for the backup coordinator:
        raises ShardCorruptError when the local copy is quarantined or
        fails verification (the coordinator fails over to a replica)."""
        if self.store is None:
            raise LookupError("node has no durable store")
        from pilosa_tpu_torch.backup.writer import capture_fragment
        return capture_fragment(self.store, (index, field, view, shard))

    def _attr_store(self, index, field):
        idx = self.holder.index(index)
        if idx is None:
            raise LookupError(f"index not found: {index!r}")
        if field is None:
            return idx.column_attr_store
        f = idx.field(field)
        if f is None:
            raise LookupError(f"field not found: {index}/{field}")
        return f.row_attr_store

    def handle_attr_blocks(self, index, field):
        return self._attr_store(index, field).blocks()

    def handle_attr_block_data(self, index, field, block):
        return self._attr_store(index, field).block_data(block)


class LocalCluster:
    """N in-process nodes sharing a LocalClient transport."""

    def __init__(self, n: int, replica_n: int = 1, planner_factory=None,
                 data_dirs: list[str | None] | None = None,
                 store_factory=None, device=None):
        self.client = LocalClient()
        #: what ``add_node`` gives a joiner: the members' device and planner
        #: factory.
        self.device = device
        self.planner_factory = planner_factory
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

    def sync_translation(self) -> int:
        """Run the replica entry-stream pull on every node (the
        anti-entropy translation step); returns entries applied."""
        from pilosa_tpu_torch.cluster.translate_sync import sync_translation
        return sum(sync_translation(cn.holder, cn.cluster, self.client)
                   for cn in self.nodes)

    def add_node(self, node_id: str | None = None,
                 coordinator: int = 0) -> "ClusterNode":
        """Grow the ring by one node through the serve-through resize:
        boot a fresh in-process member (empty holder, STARTING joiner
        view of the current ring + itself), register it on the shared
        transport, and run a ResizeJob from ``coordinator``. Raises if
        the job does not commit. The chaos soak's act_add_node and the
        elasticity drills drive this."""
        from pilosa_tpu_torch.cluster.cluster import STATE_STARTING
        from pilosa_tpu_torch.cluster.resize import ResizeJob
        coord = self.nodes[coordinator]
        if node_id is None:
            taken = {cn.id for cn in self.nodes}
            i = len(self.nodes)
            while f"node{i}" in taken:
                i += 1
            node_id = f"node{i}"
        new_member = Node(id=node_id,
                          uri=URI(host="localhost",
                                  port=10101 + len(self.nodes) + 90))
        member_list = [Node(id=n.id, uri=n.uri,
                            is_coordinator=n.is_coordinator)
                       for n in coord.cluster.nodes]
        c = Cluster(node_id, member_list + [new_member],
                    replica_n=coord.cluster.replica_n,
                    client=self.client.bind(node_id))
        c.set_state(STATE_STARTING)
        planner = (self.planner_factory(len(self.nodes))
                   if self.planner_factory else None)
        cn = ClusterNode(node_id, c, planner=planner, device=self.device)
        cn.apply_schema(coord.holder.schema())
        self.client.register(node_id, cn)
        self.nodes.append(cn)
        job = ResizeJob(coord.cluster, coord.holder, coord.cluster.client)
        state = job.run([Node(id=n.id, uri=n.uri,
                              is_coordinator=n.is_coordinator)
                         for n in coord.cluster.nodes] + [new_member])
        if state != "DONE":
            self.nodes.remove(cn)
            self.client.peers.pop(node_id, None)
            raise RuntimeError(f"add_node resize ended {state}")
        return cn

    def remove_node(self, node_id: str, coordinator: int = 0) -> None:
        """Shrink the ring by one member via the serve-through resize
        (operator remove-node flow); raises if the job does not
        commit. The departed ClusterNode stays registered but is
        dropped from self.nodes."""
        from pilosa_tpu_torch.cluster.resize import ResizeJob
        coord = self.nodes[coordinator]
        keep = [Node(id=n.id, uri=n.uri, is_coordinator=n.is_coordinator)
                for n in coord.cluster.nodes if n.id != node_id]
        if len(keep) == len(coord.cluster.nodes):
            raise LookupError(f"{node_id} not in ring")
        job = ResizeJob(coord.cluster, coord.holder, coord.cluster.client)
        state = job.run(keep)
        if state != "DONE":
            raise RuntimeError(f"remove_node resize ended {state}")
        self.nodes = [cn for cn in self.nodes if cn.id != node_id]

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
