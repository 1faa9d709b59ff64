"""Node-to-node transport interface.

Reference: client.go (InternalClient interface :46-74) with the HTTP impl
in http/client.go:37. Three implementations here:

- ``NopClient`` — standalone nodes (reference nopInternalClient);
- ``LocalClient`` — in-process registry of peer servers, the transport of
  the multi-node test harness (analog of test.MustRunCluster's real-HTTP
  in-process nodes, test/pilosa.go:343 — we cross a serialization
  boundary by shipping PQL strings + JSON-able payloads, no sockets);
- ``server.httpclient.HTTPInternalClient`` over HTTP between processes.

The port's copy of pilosa_tpu/cluster/client.py.
"""

from __future__ import annotations

from typing import Any, Protocol

from pilosa_tpu_torch.cluster.node import Node


class InternalClient(Protocol):
    """What the executor/cluster need from a peer (client.go:46)."""

    def query_node(self, node: Node, index: str, query: str,
                   shards: list[int] | None, remote: bool) -> list[Any]:
        """Execute PQL on a peer (http: POST /index/{i}/query?remote=true)."""
        ...

    def query_node_meta(self, node: Node, index: str, query: str,
                        shards: list[int] | None,
                        remote: bool) -> tuple[list[Any], dict]:
        """query_node plus the peer's shard-epoch vector (read on the
        peer BEFORE its leg executed) — the coordinator result cache's
        cross-node freshness stamp."""
        ...

    def fragment_blocks(self, node: Node, index: str, field: str, view: str,
                        shard: int) -> dict[int, bytes]:
        """Checksum blocks of a peer fragment (anti-entropy)."""
        ...

    def fragment_block_data(self, node: Node, index: str, field: str,
                            view: str, shard: int, block: int):
        """(row_ids, column_ids) of one block on a peer."""
        ...

    def import_bits(self, node: Node, index: str, field: str, view: str,
                    shard: int, rows: list[int], cols: list[int],
                    clear: bool) -> None:
        """Push bits into one specific fragment of a peer (the diff-push
        half of anti-entropy, fragment.go:2986)."""
        ...

    def translate_keys(self, node: Node, index: str, field: str | None,
                       keys: list[str]) -> list[int]:
        """Allocate/look up keys on a peer — the coordinator-primary RPC
        (reference http/translator.go)."""
        ...

    def translate_entries(self, node: Node, index: str, field: str | None,
                          after_id: int) -> list[tuple[int, str]]:
        """Entry stream for replica catch-up (translate.go:93)."""
        ...

    def post_schema(self, node: Node, schema: list[dict]) -> None:
        """Push a whole schema to a peer (ApplySchema fan-out,
        api.go:747)."""
        ...


class NopClient:
    """Standalone stub: remote calls are errors (clusters of one never
    issue them)."""

    def query_node(self, node, index, query, shards, remote):
        raise RuntimeError("nop client cannot query remote nodes")

    def query_node_meta(self, node, index, query, shards, remote):
        raise RuntimeError("nop client cannot query remote nodes")

    def fragment_blocks(self, node, index, field, view, shard):
        raise RuntimeError("nop client cannot reach remote nodes")

    def fragment_block_data(self, node, index, field, view, shard, block):
        raise RuntimeError("nop client cannot reach remote nodes")

    def import_bits(self, node, index, field, view, shard, rows, cols, clear):
        raise RuntimeError("nop client cannot reach remote nodes")

    def translate_keys(self, node, index, field, keys):
        raise RuntimeError("nop client cannot reach remote nodes")

    def translate_entries(self, node, index, field, after_id):
        raise RuntimeError("nop client cannot reach remote nodes")


class LocalClient:
    """In-process peer registry: node id -> server-like object exposing
    ``handle_query`` / ``handle_fragment_*`` (pilosa_tpu_torch.cluster.harness
    wires these to real executors)."""

    def __init__(self):
        self.peers: dict[str, Any] = {}
        #: node ids currently "down" (fault injection — the pumba pause
        #: analog, internal/clustertests/cluster_test.go:69).
        self.down: set[str] = set()
        #: node id -> injected per-query latency in seconds (the
        #: slow-peer / gray-failure fault: alive, just sick).
        self.slow: dict[str, float] = {}
        #: optional BreakerRegistry, same contract as the HTTP client's.
        self.breakers = None
        #: directed partition faults: (src_id, dst_id) -> mode ("drop" |
        #: "timeout"). Unlike ``down`` (a node dead for EVERYONE), a
        #: pair fault cuts one link in one direction — the asymmetric-
        #: partition fault the SWIM indirect probes exist for. Enforced
        #: by the per-node bound views ``bind()`` hands out; the shared
        #: unbound client has no source identity and bypasses it.
        self.pair_faults: dict[tuple[str, str], str] = {}

    def bind(self, src_id: str) -> "BoundLocalClient":
        """A view of this client with a source identity, so outbound
        calls can honor (src, dst) pair faults."""
        return BoundLocalClient(self, src_id)

    def set_pair_fault(self, src_id: str, dst_id: str,
                       mode: str = "drop") -> None:
        if mode not in ("drop", "timeout"):
            raise ValueError(f"unknown pair fault mode {mode!r}")
        self.pair_faults[(src_id, dst_id)] = mode

    def clear_pair_faults(self) -> None:
        self.pair_faults.clear()

    def check_pair(self, src_id: str, dst_id: str) -> None:
        """Raise ConnectionError when the src->dst link is faulted.
        In-process "timeout" doesn't sleep (tests stay fast) — both
        modes surface as the ConnectionError a blown socket would."""
        mode = self.pair_faults.get((src_id, dst_id))
        if mode is not None:
            raise ConnectionError(
                f"partition fault ({mode}): link {src_id}->{dst_id} is down")

    def register(self, node_id: str, server: Any) -> None:
        self.peers[node_id] = server

    def _peer(self, node: Node):
        if node.id in self.down:
            raise ConnectionError(f"node {node.id} is down")
        peer = self.peers.get(node.id)
        if peer is None:
            raise ConnectionError(f"unknown node {node.id}")
        return peer

    def query_node(self, node, index, query, shards, remote=True):
        return self.query_node_meta(node, index, query, shards, remote)[0]

    def query_node_meta(self, node, index, query, shards, remote=True):
        if self.breakers is None:
            return self._query_node(node, index, query, shards, remote)
        self.breakers.check(node.id)
        # Mirror the HTTP client's bookkeeping exactly: EVERY outcome
        # resolves the breaker (a claimed half-open probe left
        # unresolved would fast-fail the peer forever). ConnectionError
        # (down peer, slow peer that blew the deadline) is a failure;
        # our own deadline expiring before/while dispatching proves
        # nothing, so it releases the probe without an outcome; any
        # other exception is an ALIVE peer answering with an
        # application error (query RuntimeError, ShardCorruptError,
        # QueryShedError) — a success, same as the HTTP path's 503.
        from pilosa_tpu_torch.qos.deadline import DeadlineExceededError
        try:
            result = self._query_node(node, index, query, shards, remote)
        except ConnectionError:
            self.breakers.record_failure(node.id)
            raise
        except DeadlineExceededError:
            self.breakers.abort(node.id)
            raise
        except BaseException:
            self.breakers.record_success(node.id)
            raise
        self.breakers.record_success(node.id)
        return result

    def _query_node(self, node, index, query, shards, remote=True):
        """Returns (results, shard-epoch vector) — the serialization
        boundary carries the peer's epochs like the HTTP wire does."""
        peer = self._peer(node)
        handle = getattr(peer, "handle_query_meta", None)
        if handle is None:  # bare test double: no epoch reporting
            handle = lambda *a: (peer.handle_query(*a), {})  # noqa: E731
        # Cross the serialization boundary the way the HTTP transport
        # does (X-Deadline, server/httpclient.py): don't dispatch an
        # already-expired query, and hand the peer a RE-DERIVED token
        # (absolute expiry only — the coordinator's local cancel flag
        # doesn't travel over the wire either).
        from pilosa_tpu_torch.qos import deadline as qos_deadline
        dl = qos_deadline.current_deadline()
        delay = self.slow.get(node.id, 0.0)
        if delay > 0.0:
            # The sick-peer fault: the request "takes" this long. With
            # a deadline in force this turns into the same timeout the
            # HTTP transport surfaces (ConnectionError), exercising the
            # breaker/hedge path; without one it's just slow.
            import time as _time
            if dl is not None:
                rem = dl.remaining()
                if rem is not None and rem <= delay:
                    _time.sleep(max(0.0, rem))
                    raise ConnectionError(
                        f"node {node.id} timed out (slow-peer fault)")
            _time.sleep(delay)
        if dl is None:
            return handle(index, query, shards, remote)
        dl.check()
        token = qos_deadline.set_current_deadline(dl.rederive())
        try:
            return handle(index, query, shards, remote)
        finally:
            qos_deadline.reset_current_deadline(token)

    def fragment_blocks(self, node, index, field, view, shard):
        return self._peer(node).handle_fragment_blocks(index, field, view, shard)

    def fragment_block_data(self, node, index, field, view, shard, block):
        return self._peer(node).handle_fragment_block_data(
            index, field, view, shard, block)

    def import_bits(self, node, index, field, view, shard, rows, cols,
                    clear=False):
        return self._peer(node).handle_import(index, field, view, shard,
                                              rows, cols, clear)

    def send_message(self, node, message: dict):
        """Control-plane broadcast (reference /internal/cluster/message,
        broadcast.go:55-72)."""
        return self._peer(node).handle_message(message)

    def send_import_roaring(self, node, index, field, shard, data: bytes,
                            clear=False):
        return self._peer(node).handle_import_roaring(index, field, shard,
                                                      data, clear)

    def send_import_stream(self, node, reqs, chunked=False, qos_class=None):
        """PTS1 bulk-import stream to a peer — the one wire for large
        data movement (user bulk loads AND resize fragment migration,
        which rides it with qos_class="internal"). Returns the number of
        applied requests (the applied prefix, for resume)."""
        return self._peer(node).handle_import_stream(list(reqs))

    def probe(self, node) -> None:
        """Liveness probe (the /version check of confirmNodeDown)."""
        self._peer(node)

    def indirect_probe(self, via, target) -> bool:
        """SWIM indirect confirmation: ask intermediary ``via`` whether
        IT can reach ``target``. Models the two hops the HTTP path
        takes: us->via (via must be up), then via->target (via's own
        link faults and target's liveness apply)."""
        try:
            self._peer(via)
            self.check_pair(via.id, target.id)
            self._peer(target)
        except ConnectionError:
            return False
        return True

    def send_import(self, node, index, field, shard, rows=None, cols=None,
                    values=None, timestamps=None, clear=False):
        """Field-level import routed to an owning node (api.go:967)."""
        return self._peer(node).handle_import_request(
            index, field, rows=rows, cols=cols, values=values,
            timestamps=timestamps, clear=clear)

    def translate_keys(self, node, index, field, keys):
        return self._peer(node).handle_translate_keys(index, field, keys)

    def translate_entries(self, node, index, field, after_id):
        return self._peer(node).handle_translate_entries(index, field,
                                                         after_id)

    def schema(self, node) -> list[dict]:
        return self._peer(node).handle_schema()

    def post_schema(self, node, schema: list[dict]) -> None:
        self._peer(node).apply_schema(schema)

    def nodes(self, node) -> list[dict]:
        return self._peer(node).handle_nodes()

    def backup_keys(self, node) -> list:
        """Fragment keys a peer holds durable files for (backup
        coordinator enumeration)."""
        return self._peer(node).handle_backup_keys()

    def backup_fragment(self, node, index, field, view, shard) -> dict:
        """One fragment's verified (snap, wal) pair from a peer; raises
        ShardCorruptError when that copy is unhealthy."""
        return self._peer(node).handle_backup_fragment(index, field, view,
                                                       shard)

    def attr_blocks(self, node, index, field):
        return self._peer(node).handle_attr_blocks(index, field)

    def attr_block_data(self, node, index, field, block):
        return self._peer(node).handle_attr_block_data(index, field, block)


class BoundLocalClient:
    """A LocalClient view carrying a source node identity. Every method
    whose first positional argument is a peer Node first checks the
    (src, dst) pair-fault table, then delegates — so the harness can
    cut individual links (symmetric or one-way) while the shared
    registry/down/slow state stays in one place.

    For ``indirect_probe(via, target)`` the checked link is src->via
    (reaching the INTERMEDIARY); the via->target hop is the base
    client's job — that is exactly what makes an asymmetric partition
    survivable: src can't see target, but via can."""

    def __init__(self, base: LocalClient, src_id: str):
        self._base = base
        self.src_id = src_id

    def __getattr__(self, name):
        attr = getattr(self._base, name)
        if not callable(attr):
            return attr

        def bound(*args, **kwargs):
            if args and isinstance(args[0], Node):
                self._base.check_pair(self.src_id, args[0].id)
            return attr(*args, **kwargs)

        return bound

    def __repr__(self):
        return f"BoundLocalClient({self.src_id!r})"
