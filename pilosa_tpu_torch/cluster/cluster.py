"""Cluster: membership + placement + distributed map/reduce + write fan-out.

Reference: cluster.go (struct :186, state machine :47-50, partitionNodes
:902-923) and the node-distribution half of executor.go (shardsByNode
:2435, mapReduce retry/failover :2455-2560, write replication
:2144-2168).

The port's copy of pilosa_tpu/cluster/cluster.py: membership, the state
machine, quorum fencing, placement, ``map_reduce`` (hedged legs,
merge-as-completed, failover onto replicas, the deferred row and register
folds), the write fan-out with a resize's dual writes, and the durable
topology hook.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from concurrent.futures import wait as futures_wait
from typing import Any, Callable

from pilosa_tpu_torch.config import DEFAULT_PARTITION_N
from pilosa_tpu_torch.cluster.client import InternalClient, NopClient
from pilosa_tpu_torch.cluster.event import (
    EVENT_JOIN,
    EVENT_LEAVE,
    EVENT_UPDATE,
    NodeEvent,
)
from pilosa_tpu_torch.cluster.node import Node
from pilosa_tpu_torch.cluster.placement import jump_hash, partition
from pilosa_tpu_torch.cluster.scrub import DirtyShards
from pilosa_tpu_torch.errors import PilosaError
from pilosa_tpu_torch.obs import profile as _profile
from pilosa_tpu_torch.obs.stats import NopStats
from pilosa_tpu_torch.storage.quarantine import ShardCorruptError

STATE_STARTING = "STARTING"
#: terminal state of a node removed from the ring by a committed resize:
#: its topology is stale by construction, so the API gate stays closed
#: until an operator re-joins or retires it (reference analog: a removed
#: node exits the memberlist and never re-enters NORMAL on its own).
STATE_REMOVED = "REMOVED"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"


class ShardUnavailableError(PilosaError):
    message = "shard unavailable"


class Cluster:
    """Reference cluster (cluster.go:186)."""

    def __init__(self, local_id: str, nodes: list[Node] | None = None,
                 replica_n: int = 1, partition_n: int = DEFAULT_PARTITION_N,
                 client: InternalClient | None = None):
        self.local_id = local_id
        self.nodes: list[Node] = sorted(nodes or [], key=lambda n: n.id)
        self.replica_n = replica_n
        self.partition_n = partition_n
        self.client = client or NopClient()
        self.state = STATE_STARTING
        #: monotonically increasing topology version, bumped by every
        #: committed resize and carried on cluster-status broadcasts and
        #: membership pulls: a peer's view is only adopted when its
        #: version is NEWER, so a stale node can never resurrect a
        #: removed member (ghost re-add -> wrong placement -> the GC
        #: deleting live data).
        self.topology_version = 0
        #: durable-topology hook (reference .topology file,
        #: cluster.go:1657): called after every committed
        #: nodes/version change so a restarted node resumes from the
        #: committed ring and version instead of version 0 — a reborn
        #: coordinator committing "version 1" again would be silently
        #: rejected as stale by every peer, forking the ring.
        self.save_hook: Callable | None = None
        self.stats = NopStats()
        #: shards the write fan-out skipped a DOWN replica for — the
        #: scrubber checks these first (cluster/scrub.py).
        self.dirty_shards = DirtyShards()
        #: quarantine hook: fn(index) -> set of shards this node must
        #: NOT serve locally (storage corruption); placement then skips
        #: the local owner so reads land on replicas.
        self.blocked_shards_fn: Callable[[str], set] | None = None
        self._lock = threading.RLock()
        #: NodeEvent consumers (cluster/event.py).
        self._listeners: list[Callable] = []
        #: shared fan-out pool for map_reduce (lazily created): a pool
        #: per query cost ~0.5 ms of thread spawn on a slow host and
        #: capped concurrency at one query's node count; sharing lets
        #: CONCURRENT cluster queries overlap all their remote hops.
        self._fanout_pool = None
        self._fanout_lock = threading.Lock()
        #: memoized shard placement: (ring token, {(index, shard): nodes}).
        #: Placement is a pure function of ring membership x replica_n x
        #: partition_n; recomputing fnv1a64+jump_hash for all shards on
        #: every query costs ~2 ms per 256-shard fan-out (~25% of an
        #: uncached cluster query). Swapped atomically, never mutated
        #: cross-token: a writer that raced a ring change fills only its
        #: own (now unreachable) memo dict.
        self._placement = (None, {})
        #: memoized shards_by_node groupings (same token discipline);
        #: the 256-iteration owner-walk costs ~0.7 ms per fan-out even
        #: with shard_nodes memoized, and the inputs repeat exactly on
        #: every stable-topology query.
        self._groups_memo = (None, {})
        #: optional HedgePolicy (cluster/breaker.py): when set and the
        #: index is replicated, remote read legs that outlast the p95
        #: delay fire one budgeted backup request to the next replica
        #: and the first success wins (Dean & Barroso hedged requests).
        self.hedge = None
        self._hedge_pool = None
        #: fn(index, node_id, {shard: epoch}) — remote query legs report
        #: the serving node's shard-epoch vector here (the executor's
        #: RemoteEpochTable.observe); the cross-node half of result
        #: cache stamps. None = nobody caches, skip the bookkeeping.
        self.epoch_sink = None
        #: MigrationTable (cluster/migration.py) while a serve-through
        #: resize is in flight, else None. The OLD ring (self.nodes)
        #: stays authoritative for routing the whole time; this only
        #: adds dual-apply write targets and (post-cutover) extra read
        #: candidates. Installed by resize-begin, cleared by resize-end
        #: / the commit / the stale-migration sweep.
        self.migration = None
        #: node id -> in-flight read legs dispatched BY this node, the
        #: load signal the replica-aware read-spread post-pass balances
        #: on. Observed load only — no coordination with peers.
        self._inflight: dict[str, int] = {}
        self._inflight_lock = threading.Lock()
        #: quorum self-fence: True while this node's liveness sweep
        #: cannot reach a strict majority of the ring. A fenced node
        #: 503s non-internal writes (reads too, unless the operator
        #: opts into staleness below) and suspends coordinator duties
        #: — the partitioned-minority half of split-brain safety.
        self.fenced = False
        #: explicit staleness knob: serve reads (query/export) while
        #: fenced. Off by default — a fenced minority's data may be
        #: arbitrarily stale, so the operator must opt in.
        self.fence_stale_reads = False
        #: fn() called on the fenced->unfenced transition (regained
        #: majority): ServerNode wires this to a dirty-sync so a
        #: rejoining minority repairs against the majority's writes.
        self.on_unfence: Callable | None = None
        #: per-peer failure-detector observations for /debug/membership:
        #: node id -> {"lastProbeOk", "lastProbeAt", "indirect", ...}.
        #: Written only by check_nodes (one sweep at a time), read by
        #: the debug handler; plain dict swaps keep it race-benign.
        self.membership_log: dict[str, dict] = {}

    #: shared fan-out pool size — bounds total in-flight remote
    #: sub-queries, not per-query fan-out.
    FANOUT_POOL_SIZE = 32

    def _pool(self):
        if self._fanout_pool is None:
            with self._fanout_lock:
                if self._fanout_pool is None:
                    self._fanout_pool = ThreadPoolExecutor(
                        max_workers=self.FANOUT_POOL_SIZE,
                        thread_name_prefix="fanout")
        return self._fanout_pool

    def _hedge_executor(self):
        """Separate pool for hedged legs: a hedged task occupies a
        fan-out slot while it awaits its primary/backup legs, so running
        those legs on the SAME bounded pool could deadlock (every slot
        waiting on a leg that cannot be scheduled)."""
        if self._hedge_pool is None:
            with self._fanout_lock:
                if self._hedge_pool is None:
                    self._hedge_pool = ThreadPoolExecutor(
                        max_workers=2 * self.FANOUT_POOL_SIZE,
                        thread_name_prefix="hedge")
        return self._hedge_pool

    def close(self) -> None:
        """Release the fan-out pools (idempotent)."""
        with self._fanout_lock:
            pool, self._fanout_pool = self._fanout_pool, None
            hpool, self._hedge_pool = self._hedge_pool, None
        for p in (pool, hpool):
            if p is not None:
                p.shutdown(wait=False, cancel_futures=True)

    # -- membership --------------------------------------------------------

    def node_by_id(self, node_id: str) -> Node | None:
        for n in self.nodes:
            if n.id == node_id:
                return n
        return None

    @property
    def local_node(self) -> Node | None:
        return self.node_by_id(self.local_id)

    def coordinator(self) -> Node | None:
        for n in self.nodes:
            if n.is_coordinator:
                return n
        return None

    def node_join(self, node: Node) -> None:
        """Membership-only join (reference nodeJoin cluster.go:1796).
        Data movement is the coordinator's job: ServerNode.handle_join
        runs a ResizeJob (stream fragments, per-target ACKs, topology
        broadcast) before peers adopt the new ring."""
        with self._lock:
            if self.node_by_id(node.id) is None:
                self.nodes = sorted(self.nodes + [node], key=lambda n: n.id)
                self._emit(EVENT_JOIN, node.id, node.state)
            self._update_state()

    def node_leave(self, node_id: str) -> None:
        with self._lock:
            n = self.node_by_id(node_id)
            if n is not None:
                n.state = "DOWN"
                self._emit(EVENT_LEAVE, node_id, "DOWN")
            self._update_state()

    def merge_membership(self, nodes_json: list[dict],
                         version: int) -> list[str]:
        """Transitive discovery (memberlist push/pull analog,
        gossip/gossip.go:295-443): adopt a peer's WHOLE member list —
        adds AND removals — but only when its topology version is
        strictly newer, so a node partitioned through a resize still
        learns the committed ring through any reachable member, while a
        STALE peer can never resurrect a removed ghost (which would
        shift jump-hash placement and let the holder GC delete live
        data)."""
        changed: list[str] = []
        with self._lock:
            if version <= self.topology_version:
                return changed
            old = {n.id: n for n in self.nodes}
            new_nodes = sorted((Node.from_json(d) for d in nodes_json),
                               key=lambda n: n.id)
            new_ids = {n.id for n in new_nodes}
            if self.local_id not in new_ids:
                # A newer topology that excludes US means we were
                # removed; adopt nothing here — the operator/rejoin flow
                # owns that transition.
                return changed
            for n in new_nodes:  # keep live probe state across merge
                if n.id in old:
                    n.state = old[n.id].state
            changed = sorted(set(old) ^ new_ids)
            self.nodes = new_nodes
            self.topology_version = version
            self._update_state()
        self.notify_topology()
        for nid in changed:
            self._emit(EVENT_UPDATE, nid, "MERGED")
        return changed

    def notify_topology(self) -> None:
        """Invoke the durable-topology hook (best-effort: persistence
        failure must not fail the membership change itself)."""
        hook = self.save_hook
        if hook is None:
            return
        try:
            hook()
        except Exception:
            pass

    def subscribe(self, listener: Callable) -> None:
        """Register a NodeEvent consumer (reference ReceiveEvent's
        inverse: we push instead of queue-poll; event.go:18-31)."""
        self._listeners.append(listener)

    def unsubscribe(self, listener: Callable) -> None:
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def _emit(self, type_: str, node_id: str, state: str) -> None:
        ev = NodeEvent(type=type_, node_id=node_id, state=state)
        for fn in self._listeners:
            try:
                fn(ev)
            except Exception:
                pass  # observers must never break membership handling

    def _update_state(self) -> None:
        """cluster.go:571-582: tolerate < replicaN losses (DEGRADED);
        beyond that, data is unavailable (STARTING)."""
        if self.state == STATE_RESIZING:
            # The resize job owns this state: a liveness sweep landing
            # mid-job must not flip the cluster back to NORMAL (which
            # would reopen the API gate while fragments are moving).
            # Commit/abort restore the steady state explicitly.
            return
        if self.state == STATE_REMOVED:
            return  # terminal: only operator action re-opens this node
        down = sum(1 for n in self.nodes if n.state == "DOWN")
        if down == 0:
            self.state = STATE_NORMAL
        elif down < self.replica_n:
            self.state = STATE_DEGRADED
        else:
            self.state = STATE_STARTING

    def set_state(self, state: str) -> None:
        self.state = state

    # -- quorum fencing ----------------------------------------------------

    def observe_quorum(self, reachable: int, total: int | None = None) -> bool:
        """Feed one liveness sweep's reachability tally (self + peers
        answering direct or indirect probes) into the fence. Fence when
        the reachable set is not a strict majority of the ring; un-fence
        (and fire ``on_unfence`` -> dirty-sync) when majority returns.

        Rings smaller than 3 are exempt: with 2 nodes a single peer loss
        would fence BOTH sides (no majority exists), turning every
        routine degraded-replica situation into an outage. Returns the
        new fenced state."""
        if total is None:
            total = len(self.nodes)
        has_quorum = total < 3 or 2 * reachable > total
        if self.fenced and has_quorum:
            self.fenced = False
            self.stats.count("cluster.unfenced")
            hook = self.on_unfence
            if hook is not None:
                try:
                    hook()
                except Exception:
                    pass  # rejoin repair is best-effort, never fatal
        elif not self.fenced and not has_quorum:
            self.fenced = True
            self.stats.count("cluster.fenced")
        return self.fenced

    def fencing_token(self) -> int:
        """Monotonic fencing token: the topology version. Every
        committed resize and every coordinator takeover bumps it, so a
        deposed coordinator's in-flight broadcasts carry a token older
        than what its peers have already adopted."""
        return self.topology_version

    def check_fencing_token(self, message: dict) -> bool:
        """Receiver-side token check for coordinator-initiated internal
        messages (resize-begin, index-dirty, ...). A token older than
        our topology version means the sender was coordinator of a ring
        we have since moved past — reject. Messages without a token are
        accepted (peer-to-peer traffic and old senders don't carry
        one)."""
        token = message.get("fencingToken")
        if token is None:
            return True
        if int(token) < self.topology_version:
            self.stats.count("cluster.staleTokenRejected")
            return False
        return True

    # -- placement ---------------------------------------------------------

    def partition(self, index: str, shard: int) -> int:
        return partition(index, shard, self.partition_n)

    def partition_nodes(self, partition_id: int) -> list[Node]:
        """Reference partitionNodes (cluster.go:902): jump-hash the
        partition onto the sorted ring, walk forward for replicas."""
        if not self.nodes:
            return []
        replica_n = min(self.replica_n, len(self.nodes)) or 1
        start = jump_hash(partition_id, len(self.nodes))
        return [self.nodes[(start + i) % len(self.nodes)]
                for i in range(replica_n)]

    def shard_nodes(self, index: str, shard: int) -> list[Node]:
        # id() of each Node (not just its id string) so a node object
        # replaced in-place under the same id still invalidates the memo.
        token = (tuple(map(id, self.nodes)), self.replica_n,
                 self.partition_n)
        tok, memo = self._placement
        if tok != token:
            memo = {}
            self._placement = (token, memo)
        key = (index, shard)
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = self.partition_nodes(
                self.partition(index, shard))
        return hit

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def shards_by_node(self, nodes: list[Node], index: str,
                       shards: list[int]) -> dict[str, list[int]]:
        """Reference shardsByNode (executor.go:2435): each shard goes to
        its first live owner among ``nodes``; the LOCAL owner is skipped
        for shards whose data is quarantined here (blocked_shards_fn),
        so reads route to a replica instead of serving corrupt/no data."""
        blocked: set = set()
        if self.blocked_shards_fn is not None:
            blocked = self.blocked_shards_fn(index) or set()
        ring = (tuple(map(id, self.nodes)), self.replica_n,
                self.partition_n)
        key = (tuple(n.id for n in nodes), index, tuple(shards),
               frozenset(blocked))
        tok, memo = self._groups_memo
        if tok != ring:
            memo = {}
            self._groups_memo = (ring, memo)
        hit = memo.get(key)
        if hit is not None:
            # Copy-on-hit: callers may hold the lists across failover
            # waves; never hand out aliased state. The read-spread
            # post-pass runs on the copy — load shifts between hits,
            # so the memo must stay the pure first-owner placement.
            return self._spread_read_legs(
                {nid: list(shs) for nid, shs in hit.items()},
                nodes, index, blocked)
        out: dict[str, list[int]] = {}
        live = {n.id for n in nodes}
        for shard in shards:
            skipped_blocked = False
            for owner in self.shard_nodes(index, shard):
                if owner.id not in live:
                    continue
                if owner.id == self.local_id and shard in blocked:
                    skipped_blocked = True
                    continue
                out.setdefault(owner.id, []).append(shard)
                break
            else:
                if skipped_blocked:
                    # Only the corrupt local copy remains: distinct
                    # error, the data exists but cannot be trusted.
                    raise ShardCorruptError()
                raise ShardUnavailableError()
        if len(memo) >= 64:
            memo.clear()
        memo[key] = out
        return self._spread_read_legs(
            {nid: list(shs) for nid, shs in out.items()},
            nodes, index, blocked)

    #: minimum observed in-flight-leg imbalance (max - min across live
    #: nodes) before the read-spread post-pass moves anything; below it
    #: the deterministic first-live-owner placement stands untouched.
    SPREAD_THRESHOLD = 2

    def _spread_read_legs(self, groups: dict[str, list[int]],
                          nodes: list[Node], index: str,
                          blocked: set) -> dict[str, list[int]]:
        """Replica-aware read scaling: rebalance a fan-out's legs across
        each shard's OTHER live replica owners by observed in-flight
        load, instead of touching replicas only on failure or hedge
        (the same owner knowledge _hedge_backup_groups uses). Shards of
        a mid-resize migration that already CUT OVER also admit their
        new owner as a candidate — dual-apply keeps that copy current.
        At idle (no in-flight legs, or imbalance under the threshold)
        this is the identity, so deterministic placement is preserved
        exactly when nothing would be gained by deviating from it."""
        with self._inflight_lock:
            load = dict(self._inflight)
        if not load:
            return groups
        live = {n.id for n in nodes}
        vals = [load.get(nid, 0) for nid in live]
        if not vals or max(vals) - min(vals) < self.SPREAD_THRESHOLD:
            return groups
        mig = self.migration
        virt = {nid: float(load.get(nid, 0)) for nid in live}
        out: dict[str, list[int]] = {}
        moves = 0
        for node_id, shs in groups.items():
            # Fractional virtual load: one leg serves the whole group,
            # so each moved/kept shard adds 1/len of a leg — moving a
            # few shards off a hot node shouldn't instantly flip the
            # imbalance the other way.
            weight = 1.0 / max(1, len(shs))
            for shard in shs:
                cands = [node_id]
                for owner in self.shard_nodes(index, shard):
                    if owner.id == node_id or owner.id not in live:
                        continue
                    if owner.id == self.local_id and shard in blocked:
                        continue
                    cands.append(owner.id)
                if mig is not None and mig.is_cutover(index, shard):
                    for t in mig.dual_targets(self, index, shard):
                        # Live-ring members only: a joiner outside
                        # self.nodes can't be failover-remapped, so it
                        # never serves ordinary reads pre-commit.
                        if t.id in live and t.id not in cands:
                            cands.append(t.id)
                best = min(cands, key=lambda nid: virt.get(nid, 0.0))
                tgt = node_id
                if (best != node_id
                        and virt.get(node_id, 0.0) - virt.get(best, 0.0)
                        >= self.SPREAD_THRESHOLD):
                    tgt = best
                    moves += 1
                virt[tgt] = virt.get(tgt, 0.0) + weight
                out.setdefault(tgt, []).append(shard)
        if moves:
            self.stats.count("cluster.read_spread", moves)
        return out

    def _inflight_inc(self, node_id: str) -> None:
        with self._inflight_lock:
            self._inflight[node_id] = self._inflight.get(node_id, 0) + 1

    def _inflight_dec(self, node_id: str) -> None:
        with self._inflight_lock:
            n = self._inflight.get(node_id, 0) - 1
            if n <= 0:
                self._inflight.pop(node_id, None)
            else:
                self._inflight[node_id] = n

    def _hedge_backup_groups(self, nodes: list[Node], index: str,
                             node_id: str,
                             shards: list[int]) -> dict[str | None, list[int]]:
        """Split one primary node's shard batch by each shard's next
        live replica (the hedge target). Shards without another live
        owner map under None — they still run, just unhedged."""
        live = {n.id for n in nodes}
        blocked: set = set()
        if self.blocked_shards_fn is not None:
            blocked = self.blocked_shards_fn(index) or set()
        groups: dict[str | None, list[int]] = {}
        for shard in shards:
            backup = None
            for owner in self.shard_nodes(index, shard):
                if owner.id == node_id or owner.id not in live:
                    continue
                if owner.id == self.local_id and shard in blocked:
                    continue  # our copy is quarantined: useless backup
                backup = owner.id
                break
            groups.setdefault(backup, []).append(shard)
        return groups

    # -- distributed map/reduce (reference mapReduce executor.go:2455) -----

    def map_reduce(self, executor, idx, shards: list[int], c, opt,
                   map_fn: Callable[[int], Any],
                   reduce_fn: Callable[[Any, Any], Any],
                   local_batch_fn: Callable[[list[int]], Any] | None = None) -> Any:
        """``local_batch_fn`` lets the mesh planner take this node's whole
        shard batch as one SPMD program instead of a per-shard loop.

        Node groups run CONCURRENTLY (the reference's per-node goroutines,
        executor.go:2517): the local device program and every remote HTTP
        query overlap, so cluster latency is max(node) not sum(nodes).

        The COORDINATOR THREAD IS DONATED to the local leg: a
        single-group plan runs inline with no pool at all, and a
        multi-group plan submits only the REMOTE legs to the fan-out
        pool, then runs the local device program on the calling thread
        while they fly — the local leg never pays a pool hop
        (submit/schedule/park, ~0.1 ms on a loaded node) and the
        coordinator never idles while its own device works. Only hedge
        backup legs hop pools (they exist to race a remote primary)."""
        nodes = [n for n in self.nodes if n.state != "DOWN"]
        result = None
        pending = list(shards)
        pql = str(c)  # serialize the node-boundary query once
        # Bitmap unions (reduce_fn tagged by the executor) defer: legs
        # collect and fold ONCE at the end — on device, one batched
        # program — instead of a host union chain per completion.
        from pilosa_tpu_torch.core.row import Row as _Row
        from pilosa_tpu_torch.sketch.hll import HLLSketch as _HLL
        row_accs: list = []
        defer_rows = getattr(reduce_fn, "reduce_kind", None) == "row_union"
        # HLL register partials (Count(Distinct) legs) defer the same
        # way: register-max is associative/commutative, so the deferred
        # batch folds in ONE stacked np.max instead of a pairwise chain.
        reg_accs: list = []
        defer_regs = (getattr(reduce_fn, "reduce_kind", None)
                      == "register_max")

        def fold(acc):
            nonlocal result
            if defer_rows and isinstance(acc, _Row):
                row_accs.append(acc)
                return
            if defer_regs and isinstance(acc, _HLL):
                reg_accs.append(acc)
                return
            result = acc if result is None else reduce_fn(result, acc)
        # The fan-out pool's threads don't inherit contextvars; carry
        # the active trace id, deadline AND query profile into them so
        # remote sub-queries join the trace, stay cancellable, and
        # charge their legs to the right ledger.
        from pilosa_tpu_torch.obs import tracing
        from pilosa_tpu_torch.qos import deadline as qos_deadline
        tid = tracing.current_trace_id()
        dl = qos_deadline.current_deadline()
        prof = _profile.current()

        def _with_trace(fn):
            tokens = []
            if tid is not None:
                tokens.append((tracing.reset_current_trace,
                               tracing.set_current_trace(tid)))
            if dl is not None:
                tokens.append((qos_deadline.reset_current_deadline,
                               qos_deadline.set_current_deadline(dl)))
            if prof is not None:
                tokens.append((_profile.deactivate,
                               _profile.activate(prof)))
            try:
                return fn()
            finally:
                for reset, token in reversed(tokens):
                    reset(token)

        def run_local(node_shards: list[int]):
            def go():
                if local_batch_fn is not None:
                    return local_batch_fn(node_shards)
                acc = None
                for shard in node_shards:
                    acc = reduce_fn(acc, map_fn(shard))
                return acc
            self._inflight_inc(self.local_id)
            try:
                return _with_trace(go)
            finally:
                self._inflight_dec(self.local_id)

        def _leg_wire() -> dict:
            """This thread's last wire accounting (the HTTP transport
            sets it just before returning; empty for other clients)."""
            nbytes = getattr(self.client, "leg_wire_bytes", None)
            b = nbytes() if nbytes is not None else None
            return b or {}

        def run_remote(node_id: str, node_shards: list[int],
                       hedged: bool = False):
            node = self.node_by_id(node_id)
            if node is None:
                # A resize commit can land between planning this leg and
                # running it, dropping the node from the ring; fail over
                # exactly like a dead peer so the retry wave remaps the
                # shards onto the committed placement's owners.
                raise ConnectionError(f"node {node_id} left the ring")
            t0 = time.perf_counter()

            def go():
                with tracing.start_span("cluster.remoteLeg") as span:
                    span.set_tag("node", node_id)
                    span.set_tag("shards", len(node_shards))
                    # The meta path carries the peer's shard-epoch vector
                    # for the coordinator's cache stamps — but
                    # instance-level query_node overrides (test
                    # fault-injection hooks) must keep intercepting the
                    # fan-out, so it only runs on a pristine client.
                    # Hooks land on the shared base when the client is a
                    # bound per-node view, so check there too.
                    meta = getattr(self.client, "query_node_meta", None)
                    hooked = getattr(self.client, "_base",
                                     self.client).__dict__
                    if meta is None or "query_node" in hooked:
                        return self.client.query_node(
                            node, idx.name, pql, node_shards, remote=True)[0]
                    results, epochs = meta(node, idx.name, pql, node_shards,
                                           remote=True)
                    if self.epoch_sink is not None and epochs:
                        self.epoch_sink(idx.name, node_id, epochs)
                    # HTTP transports expose the leg's wire payload sizes
                    # (thread-local, set just before returning).
                    b = _leg_wire()
                    if b:
                        span.set_tag("bytesOut", b.get("out", 0))
                        span.set_tag("bytesIn", b.get("in", 0))
                    return results[0]

            try:
                self._inflight_inc(node_id)
                try:
                    res = _with_trace(go)
                finally:
                    self._inflight_dec(node_id)
            except Exception as e:
                if prof is not None:
                    # Error legs are part of the timeline too (their
                    # bytes are unknowable: the transport may not have
                    # reached the stash point, and a stale value from
                    # this pool thread's PREVIOUS leg must not leak in).
                    prof.add_remote_leg(
                        node=node_id, shards=len(node_shards),
                        bytes_out=0, bytes_in=0, decode_ms=0.0,
                        rtt_ms=(time.perf_counter() - t0) * 1e3,
                        hedged=hedged, error=type(e).__name__)
                raise
            if prof is not None:
                # Same thread that ran the request: the thread-local
                # wire stash is THIS leg's. Exactly-once: recorded here
                # and nowhere else (hedge backups record as their own
                # hedged=True leg).
                b = _leg_wire()
                rprof = None
                rp = getattr(self.client, "leg_remote_profile", None)
                if rp is not None:
                    rprof = rp()
                prof.add_remote_leg(
                    node=node_id, shards=len(node_shards),
                    bytes_out=b.get("out", 0), bytes_in=b.get("in", 0),
                    decode_ms=b.get("decodeMs", 0.0),
                    rtt_ms=(time.perf_counter() - t0) * 1e3,
                    hedged=hedged, remote=rprof)
            if self.hedge is not None:
                # Successful remote legs feed the p95 the hedge delay
                # derives from.
                self.hedge.observe(time.perf_counter() - t0)
            return res

        def run_remote_hedged(node_id: str, backup_id: str | None,
                              node_shards: list[int]):
            """Primary leg with a budgeted backup to ``backup_id`` after
            the hedge delay; first success wins. Runs on the fan-out
            pool; both legs run on the dedicated hedge pool."""
            hedge = self.hedge
            hpool = self._hedge_executor()
            primary = hpool.submit(run_remote, node_id, node_shards)
            delay = hedge.delay()
            if delay is not None and backup_id is not None:
                # Only hedge-ELIGIBLE legs feed the budget: a leg with
                # no live backup or no delay estimate can never hedge,
                # and counting it would inflate the allowance past
                # ~budget_pct% of the traffic that actually can.
                hedge.note_primary()
                try:
                    return primary.result(timeout=delay)
                except FuturesTimeoutError:
                    pass  # primary is in the tail: consider hedging
                if hedge.try_fire():
                    if prof is not None:
                        prof.bump("hedgeFired")
                    backup = hpool.submit(
                        run_local if backup_id == self.local_id
                        else lambda s: run_remote(backup_id, s, True),
                        node_shards)
                    legs = {primary, backup}
                    while legs:
                        done, legs = futures_wait(
                            legs, return_when=FIRST_COMPLETED)
                        for fut in done:
                            if fut.exception() is None:
                                if fut is backup:
                                    hedge.record_win()
                                    if prof is not None:
                                        prof.bump("hedgeWins")
                                return fut.result()
                    # Both legs failed; surface the PRIMARY's error so
                    # the failover wave remaps off the primary node.
                    raise primary.exception()
            return primary.result()

        while pending:
            # Cancel the whole fan-out (including failover retry waves)
            # once the coordinator's deadline is spent: raising here
            # means no partial result can escape and no further peer
            # queries launch.
            if dl is not None:
                dl.check()
            groups = self.shards_by_node(nodes, idx.name, pending)
            failed: list[int] = []
            tasks: list[tuple[str, list[int], Any]] = []
            if len(groups) == 1:  # no thread-pool overhead single-node
                (node_id, node_shards), = groups.items()
                try:
                    acc = (run_local(node_shards)
                           if node_id == self.local_id
                           else run_remote(node_id, node_shards))
                    fold(acc)
                except (ConnectionError, ShardCorruptError):
                    # A corrupt-data refusal fails over exactly like a
                    # dead node: drop it, remap its shards to replicas.
                    nodes = [n for n in nodes if n.id != node_id]
                    failed.extend(node_shards)
                    if prof is not None:
                        prof.bump("failovers")
            else:
                # Remote hops dispatch as futures on the SHARED pool and
                # the LOCAL batch runs on this thread concurrently with
                # them — reduce consumes completions afterwards
                # (reference mapReduce's goroutine fan-in,
                # executor.go:2455).
                pool = self._pool()
                local_shards = None
                for node_id, node_shards in groups.items():
                    if node_id == self.local_id:
                        local_shards = node_shards
                    elif self.hedge is not None and self.replica_n > 1:
                        # Hedged legs group by common backup owner so
                        # a backup leg queries exactly the shards its
                        # node can actually serve.
                        subs = self._hedge_backup_groups(
                            nodes, idx.name, node_id, node_shards)
                        for backup_id, sub in subs.items():
                            fut = pool.submit(run_remote_hedged, node_id,
                                              backup_id, sub)
                            tasks.append((node_id, sub, fut))
                    else:
                        fut = pool.submit(run_remote, node_id, node_shards)
                        tasks.append((node_id, node_shards, fut))
                if local_shards is not None:
                    try:
                        acc = run_local(local_shards)
                        fold(acc)
                    except (ConnectionError, ShardCorruptError):
                        # Drop the local node too — otherwise its failed
                        # shards re-map straight back to it and the
                        # retry loop never terminates.
                        nodes = [n for n in nodes if n.id != self.local_id]
                        failed.extend(local_shards)
                # Merge-as-completed: each finished leg folds while the
                # stragglers are still in flight, so GroupBy/TopN merge
                # cost comes off the critical path (the old serial fold
                # paid every merge after the LAST leg returned).
                fut_info = {fut: (node_id, node_shards)
                            for node_id, node_shards, fut in tasks}
                pending_futs = set(fut_info)
                while pending_futs:
                    done, pending_futs = futures_wait(
                        pending_futs, return_when=FIRST_COMPLETED)
                    for fut in done:
                        node_id, node_shards = fut_info[fut]
                        try:
                            acc = fut.result()
                        except (ConnectionError, ShardCorruptError):
                            # Failover: drop the node, re-map its shards
                            # onto replicas (executor.go:2492-2503).
                            nodes = [n for n in nodes if n.id != node_id]
                            failed.extend(node_shards)
                            if prof is not None:
                                prof.bump("failovers")
                            continue
                        fold(acc)
            pending = failed
        if row_accs:
            # The deferred bitmap fold: disjoint shards merge for free,
            # contested shards OR-reduce in one batched device program
            # (host numpy below the measured threshold) — bit-identical
            # to the union chain this replaces.
            from pilosa_tpu_torch.exec import device_reduce
            acc = device_reduce.union_rows(row_accs)
            result = acc if result is None else reduce_fn(result, acc)
        if reg_accs:
            from pilosa_tpu_torch.sketch.hll import merge_all
            acc = merge_all(reg_accs)
            result = acc if result is None else reduce_fn(result, acc)
        return result

    # -- write fan-out (reference executeSetBitField executor.go:2144) -----

    def write_fanout(self, idx_name: str, shard: int, c, opt,
                     local_apply: Callable[[], bool]) -> bool:
        """Apply a single-column write on every replica: locally when this
        node owns it, forwarded otherwise. Returns changed-ness.

        While a resize is in flight the write ALSO dual-applies to the
        shard's future owners (after the old-ring replicas: the resize
        catch-up's epoch guard relies on source-before-target apply
        order). Dual legs never drive the return value — the old ring
        is what the caller's read-your-write lands on."""
        ret = False
        for _attempt in range(3):
            # Snapshot the migration table BEFORE resolving owners, and
            # re-check topology afterwards: a resize commit landing
            # mid-fanout would otherwise let this write apply to the
            # old owners yet skip the dual legs (migration cleared),
            # silently missing the committed placement's new owner.
            # Set/Clear are idempotent, so the retry pass just
            # re-applies under the settled topology.
            v0 = self.topology_version
            mig = self.migration
            for node in self.shard_nodes(idx_name, shard):
                if node.id == self.local_id:
                    if local_apply():
                        ret = True
                elif not opt.remote:
                    if node.state == "DOWN":
                        # Skip lost replicas; anti-entropy repairs them on
                        # rejoin (holder.go:911 SyncHolder) — and the
                        # scrubber gets first crack via the dirty mark.
                        self.stats.count("cluster.replica_write_skipped")
                        self.dirty_shards.mark(idx_name, shard)
                        continue
                    res = self.client.query_node(node, idx_name, str(c),
                                                 None, remote=True)
                    if res and res[0]:
                        ret = True
            if mig is not None and not opt.remote:
                for node in mig.dual_targets(self, idx_name, shard):
                    try:
                        if node.id == self.local_id:
                            local_apply()
                        else:
                            known = self.node_by_id(node.id)
                            if known is not None and known.state == "DOWN":
                                raise ConnectionError(
                                    f"node {node.id} is down")
                            self.client.query_node(node, idx_name, str(c),
                                                   None, remote=True)
                        self.stats.count("cluster.resize.dualWrites")
                    except (ConnectionError, RuntimeError, LookupError) as e:
                        # The new copy just missed a write: mark for scrub
                        # and tell the coordinator to fail this target —
                        # committing would route reads at a diverged copy.
                        self.dirty_shards.mark(idx_name, shard)
                        self.stats.count("cluster.resize.dualWriteFailed")
                        self._report_dual_write_failure(mig, node.id, e)
            if self.topology_version == v0 and self.migration is mig:
                break
        return ret

    def _report_dual_write_failure(self, mig, node_id: str, err) -> None:
        msg = {"type": "resize-dual-write-failed", "job": mig.job_id,
               "node": node_id, "error": f"{type(err).__name__}: {err}"}
        coord_id = mig.coordinator.get("id", "")
        if coord_id == self.local_id:
            from pilosa_tpu_torch.cluster.resize import deliver_dual_write_failed
            deliver_dual_write_failed(msg)
            return
        coord = self.node_by_id(coord_id)
        if coord is None and mig.coordinator.get("uri"):
            coord = Node.from_json(mig.coordinator)
        if coord is None:
            return
        try:
            self.client.send_message(coord, msg)
        except (ConnectionError, RuntimeError, LookupError):
            pass  # coordinator unreachable: its own job will fail soon
        # anyway (its ACK wait / begin broadcast shares the same link),
        # and the dirty mark keeps the scrubber on this shard.

    def broadcast_call(self, idx_name: str, c, opt) -> None:
        """Forward an attr-write to every other node (executor.go:2237)."""
        if opt.remote:
            return
        for node in self.nodes:
            if node.id != self.local_id and node.state != "DOWN":
                self.client.query_node(node, idx_name, str(c), None, remote=True)
