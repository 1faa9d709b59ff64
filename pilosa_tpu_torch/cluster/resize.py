"""Elastic resize: add/remove nodes while the ring keeps serving.

Reference: cluster.go resize machinery — `diff` (:745) computes
added/removed nodes, `fragSources` (:784-868) computes which node streams
which fragment to whom, `resizeJob` (:1447-1561) distributes
ResizeInstructions to nodes, `followResizeInstruction` (:1297-1411) makes
each node fetch its missing fragments from source nodes; one job at a
time; abortable (api.go:1250).

Unlike the reference (which closes the cluster behind a ring-wide
RESIZING state for the whole job), this resize SERVES THROUGHOUT:

- The old ring stays authoritative — ``Cluster.nodes`` doesn't change
  until the single commit broadcast at the end, so reads never route to
  a partial copy and any failure/abort needs no rollback at all.
- A ``resize-begin`` broadcast installs a MigrationTable
  (cluster/migration.py) on every member, after which writes dual-apply
  to each shard's future owners while fragments move.
- Fragments travel over the PTS1 import-stream wire (the same path as
  bulk ingest: chunked resume-from-applied-prefix, WAL group-commit,
  IngestGate byte budget, QoS internal class) — the coordinator's
  instruction still goes to the TARGET, which relays a synchronous
  ``resize-push`` to each source; the source streams.
- After the bulk copy, the target runs a per-shard directed catch-up
  sync against the source (block-checksum diff applying both sets and
  clears, guarded by the shard-epoch read-recheck loop), bumps the
  shard epoch, and announces the shard cut over — from then on the new
  owner is also an eligible READ leg (replica-aware read scaling).

Instructions travel as control-plane messages ("resize-instruction",
"resize-push", "resize-shard-cutover", …) so the same flow works over
the in-process LocalClient and real HTTP.

The port's copy of pilosa_tpu/cluster/resize.py: host code; the
fragments it moves land in the receiving node's holder, on that node's
device.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import asdict, dataclass

import numpy as np

from pilosa_tpu_torch.cluster.cluster import (
    STATE_NORMAL,
    STATE_RESIZING,
    STATE_STARTING,
    Cluster,
)
from pilosa_tpu_torch.cluster.event import EVENT_UPDATE
from pilosa_tpu_torch.cluster.node import Node

#: active jobs by id, so completion ACKs arriving as control-plane
#: messages can find their job (reference: the coordinator's resizeJob
#: map, cluster.go:1413).
_JOBS: dict[str, "ResizeJob"] = {}
_JOBS_LOCK = threading.Lock()
_JOB_SEQ = itertools.count(1)


def deliver_completion(message: dict) -> None:
    """Route a resize-instruction-complete message to its job
    (reference ResizeInstructionComplete, cluster.go:1413-1438)."""
    with _JOBS_LOCK:
        job = _JOBS.get(message.get("job", ""))
    if job is not None:
        job.complete(message.get("node", ""), message.get("error"))


def deliver_dual_write_failed(message: dict) -> None:
    """A member could not apply a write to a migration target: the new
    copy just diverged, so the coordinator must fail that target — the
    commit would otherwise route reads to a copy missing writes. The
    old ring was never not-authoritative, so failing is free."""
    with _JOBS_LOCK:
        job = _JOBS.get(message.get("job", ""))
    if job is not None:
        job.fail_target(
            message.get("node", ""),
            f"dual write failed: {message.get('error', 'unknown')}")


def deliver_cutover(message: dict, cluster: Cluster | None = None) -> None:
    """A target finished catch-up for one shard: record it on the
    coordinator's job (for /debug/resize) and on the local migration
    table (the shard's new owner becomes an eligible read leg)."""
    with _JOBS_LOCK:
        job = _JOBS.get(message.get("job", ""))
    if job is not None:
        job.note_cutover(message.get("index", ""),
                         int(message.get("shard", -1)),
                         message.get("node", ""))
    if cluster is not None:
        mig = getattr(cluster, "migration", None)
        if mig is not None and mig.job_id == message.get("job"):
            mig.mark_cutover(message["index"], int(message["shard"]))


def apply_resize_begin(cluster: Cluster, message: dict, holder=None) -> None:
    """Peer half of the serve-through handshake: install the migration
    table so every write fanned out by THIS member also lands on the
    shard's future owners. Replaces any stale table — one job at a time
    is enforced at the coordinator's resize gate, so a new begin means
    the previous job is dead. A begin carrying a STALE fencing token is
    from a coordinator deposed by a takeover/commit we already adopted:
    installing its table would dual-apply writes toward a ring that
    will never commit, so it is rejected outright. The begin's schema
    goes into ``holder`` first, so a joiner has every index before the
    first dual write reaches it."""
    if not cluster.check_fencing_token(message):
        return
    if holder is not None and message.get("schema"):
        holder.apply_schema(message["schema"])
    from pilosa_tpu_torch.cluster.migration import MigrationTable
    cluster.migration = MigrationTable.from_message(cluster, message)


def apply_resize_end(cluster: Cluster, message: dict) -> None:
    """Drop the migration table for an aborted/failed job. Always safe:
    the old ring never stopped being authoritative, so partially
    migrated shards simply keep routing to their old owners."""
    mig = getattr(cluster, "migration", None)
    if mig is not None and mig.job_id == message.get("job"):
        cluster.migration = None


def handle_resize_instruction(holder, client, cluster: Cluster,
                              message: dict, local_id: str) -> None:
    """Target-side entry point. When the instruction carries a job id,
    apply it in the BACKGROUND and ACK the coordinator with an explicit
    resize-instruction-complete message — the dispatch RPC returns
    immediately, so a large fragment stream can take arbitrarily longer
    than any HTTP client timeout (reference followResizeInstruction runs
    in a goroutine and POSTs ResizeInstructionComplete back,
    cluster.go:1297-1315). Without a job id (direct/legacy callers) the
    apply stays synchronous."""
    job_id = message.get("job")
    if job_id is None:
        apply_resize_instruction(holder, client, cluster,
                                 message["sources"],
                                 schema=message.get("schema"),
                                 local_id=local_id)
        return
    coord = message.get("coordinator") or {}

    def work():
        err = None
        try:
            apply_resize_instruction(holder, client, cluster,
                                     message["sources"],
                                     schema=message.get("schema"),
                                     local_id=local_id, job_id=job_id,
                                     coordinator=coord)
        except Exception as e:  # noqa: BLE001 — every failure must ACK
            err = f"{type(e).__name__}: {e}"
        node = cluster.node_by_id(coord.get("id", ""))
        if node is None and coord.get("uri"):
            node = Node.from_json(coord)
        if node is None:
            return
        try:
            client.send_message(node, {"type": "resize-instruction-complete",
                                       "job": job_id, "node": local_id,
                                       "error": err})
        except (ConnectionError, RuntimeError):
            pass  # coordinator's ACK deadline treats us as failed

    threading.Thread(target=work, name="resize-apply", daemon=True).start()


@dataclass
class ResizeSource:
    """One fragment a node must fetch (reference ResizeSource).

    Carries the source's address (host/port) so a JOINING node — which
    has no topology yet — can fetch without resolving ids against a
    cluster it hasn't learned."""

    source_node: str
    index: str
    field: str
    view: str
    shard: int
    source_host: str = ""
    source_port: int = 0
    source_scheme: str = "http"


def fragment_sources(old: Cluster, new: Cluster, schema_fragments) -> dict[str, list[ResizeSource]]:
    """Pure placement diff: target node id -> fragments to fetch.

    A node in the NEW owner set that wasn't an OLD owner fetches from an
    old owner that SURVIVES into the new view (reference fragSources
    cluster.go:784-868 skips removed nodes at :823-826) — a node being
    removed is usually dead, so it must never be chosen as a source.
    Raises ValueError when a fragment has no surviving replica (the
    reference's "not enough data to perform resize")."""
    out: dict[str, list[ResizeSource]] = {}
    new_ids = {n.id for n in new.nodes}
    for index, field, view, shard in schema_fragments:
        old_owners = old.shard_nodes(index, shard)
        if not old_owners:
            continue
        old_ids = [n.id for n in old_owners]
        new_owners = [n.id for n in new.shard_nodes(index, shard)]
        surviving = [n for n in old_owners if n.id in new_ids]
        for target in new_owners:
            if target in old_ids:
                continue
            if not surviving:
                raise ValueError(
                    f"resize: fragment {index}/{field}/{view}/{shard} has "
                    f"no surviving replica to stream from (replication "
                    f"factor too low to remove its owners)")
            src = surviving[0]
            out.setdefault(target, []).append(ResizeSource(
                source_node=src.id, index=index, field=field,
                view=view, shard=shard,
                source_host=src.uri.host, source_port=src.uri.port,
                source_scheme=src.uri.scheme))
    return out


def _resolve_source(cluster: Cluster, src: "ResizeSource") -> Node:
    node = cluster.node_by_id(src.source_node)
    if node is None and src.source_host:
        node = Node.from_json({
            "id": src.source_node,
            "uri": {"scheme": src.source_scheme or "http",
                    "host": src.source_host, "port": src.source_port}})
    if node is None:
        raise ConnectionError(
            f"resize source {src.source_node!r} unknown")
    return node


def _fragment_stream_reqs(frag, src: "ResizeSource") -> list[dict]:
    """Chunk one fragment's bits into PTS1 import requests: kind=
    "fragment" payloads (absolute column ids), each bounded by
    Fragment.TRANSFER_CHUNK_BITS, so the target applies bounded batches
    as they arrive and a killed stream resumes from the applied prefix
    (sets are idempotent). The JAX module's chunks, cut from uint64 arrays
    instead of Python lists."""
    from pilosa_tpu_torch.config import SHARD_WIDTH
    from pilosa_tpu_torch.core.fragment import Fragment
    snap = frag.rows_snapshot()
    if not snap:
        return []
    rows = np.concatenate([np.full(len(pos), rid, dtype=np.uint64)
                           for rid, pos in snap])
    cols = np.concatenate([np.asarray(pos, dtype=np.uint64) for _, pos in snap])
    cols += np.uint64(int(src.shard) * SHARD_WIDTH)
    limit = max(1, int(Fragment.TRANSFER_CHUNK_BITS))
    return [{"kind": "fragment", "index": src.index, "field": src.field,
             "view": src.view, "shard": int(src.shard),
             "rowIDs": rows[i:i + limit], "columnIDs": cols[i:i + limit]}
            for i in range(0, len(rows), limit)]


def handle_resize_push(holder, client, cluster: Cluster,
                       message: dict) -> int:
    """SOURCE-side fragment export for serve-through resize: stream the
    requested fragments to the target over the PTS1 import wire (QoS
    internal class — migrations must never starve interactive traffic;
    the target's IngestGate byte budget backpressures us through the
    stream's 429/applied-prefix protocol). Handled synchronously: the
    target's send_message blocks until the push finished (or raises),
    so stream failures surface at the target and fail its ACK."""
    target = Node.from_json(message["target"])
    reqs: list[dict] = []
    for s in message["sources"]:
        src = ResizeSource(**s)
        frag = holder.fragment(src.index, src.field, src.view, src.shard)
        if frag is None:
            continue  # nothing here to stream; catch-up verifies parity
        reqs.extend(_fragment_stream_reqs(frag, src))
    if not reqs:
        return 0
    applied = client.send_import_stream(target, reqs, qos_class="internal")
    stats = getattr(cluster, "stats", None)
    if stats is not None:
        # Logical payload bytes (16 per bit pair on the PTI1 wire).
        stats.count("cluster.resize.bytesStreamed",
                    sum(16 * len(r["rowIDs"]) for r in reqs))
    return applied


#: fragments a target asks a source to stream in one resize-push: the
#: relay is a synchronous RPC under the client's socket timeout, so it is
#: sent in batches whose streams stay short at any data volume (the JAX
#: module asks for a source's whole list in one push).
PUSH_BATCH_FRAGMENTS = 32

#: read-diff-recheck passes a catch-up sync attempts before concluding
#: sustained write pressure is outrunning it and failing the target
#: (safe: the job fails, the old ring stays authoritative).
CATCH_UP_ATTEMPTS = 16


def _catch_up_fragment(holder, client, node: Node,
                       src: "ResizeSource") -> None:
    """Directed (source-authoritative) per-fragment sync: after the bulk
    PTS1 copy, diff block checksums against the source and apply both
    the missing SETS and the stale CLEARS, so a Clear that raced the
    bulk copy is never resurrected. NOT the anti-entropy majority merge
    — with one source and one target, "majority" degenerates to union,
    which can't clear anything.

    Epoch guard (the same read-merge-write discipline as
    cluster/sync.py): snapshot the local shard epoch, read both sides,
    and only apply if the epoch is unchanged — a dual-applied write
    landing mid-read bumps it and forces a re-read. The guard is sound
    against writes racing the APPLY too, because write_fanout applies
    old owners (the source) before dual targets (this node): a write
    whose source-side apply predates our source read is already in the
    snapshot, and one that postdates it reaches this node only after
    bumping our epoch — the next pass sees it. Convergence requires one
    full pass with a stable epoch and ZERO diff."""
    f = holder.field(src.index, src.field)
    if f is None:
        raise LookupError(
            f"resize target field missing: {src.index}/{src.field}")
    v = f.create_view_if_not_exists(src.view)
    frag = v.create_fragment_if_not_exists(src.shard)
    idx = holder.index(src.index)
    epoch = idx.epoch if idx is not None else None

    def shard_epoch():
        if epoch is None:
            return None
        return epoch.shard_vector([src.shard])[int(src.shard)]
    for _ in range(CATCH_UP_ATTEMPTS):
        e0 = shard_epoch()
        remote_sums = client.fragment_blocks(node, src.index, src.field,
                                             src.view, src.shard)
        local_sums = frag.checksum_blocks()
        diff = sorted(b for b in set(remote_sums) | set(local_sums)
                      if remote_sums.get(b) != local_sums.get(b))
        ops: list[tuple[list[tuple[int, int]], bool]] = []
        for block in diff:
            try:
                r_rows, r_cols = client.fragment_block_data(
                    node, src.index, src.field, src.view, src.shard, block)
                remote_pairs = set(zip((int(x) for x in r_rows),
                                       (int(x) for x in r_cols)))
            except LookupError:
                remote_pairs = set()  # source block vanished: all clears
            l_rows, l_cols = frag.block_data(block)
            local_pairs = set(zip((int(x) for x in l_rows),
                                  (int(x) for x in l_cols)))
            sets = sorted(remote_pairs - local_pairs)
            clears = sorted(local_pairs - remote_pairs)
            if sets:
                ops.append((sets, False))
            if clears:
                ops.append((clears, True))
        if e0 is not None and shard_epoch() != e0:
            continue  # a write raced the reads: stale snapshot, re-read
        if not ops:
            return  # converged: zero diff over a stable epoch window
        for pairs, clear in ops:
            frag.bulk_import([r for r, _ in pairs],
                             [c for _, c in pairs], clear=clear)
    raise RuntimeError(
        f"resize catch-up did not converge for {src.index}/{src.field}/"
        f"{src.view}/{src.shard} after {CATCH_UP_ATTEMPTS} passes "
        f"(sustained write pressure); target fails, old ring stays "
        f"authoritative")


def apply_resize_instruction(holder, client, cluster: Cluster,
                             sources: list[dict],
                             schema: list[dict] | None = None,
                             local_id: str | None = None,
                             job_id: str | None = None,
                             coordinator: dict | None = None) -> None:
    """followResizeInstruction (cluster.go:1297), serve-through edition:
    adopt the sender's schema (a joiner starts empty), then — grouped by
    SOURCE node — relay a synchronous resize-push so each source streams
    its fragments here over the PTS1 import wire, then run the per-shard
    directed catch-up sync, bump the shard epoch, and announce the shard
    cut over. Any failure RAISES so the coordinator's completion
    tracking sees this target as failed (reference
    ResizeInstructionComplete, cluster.go:1315)."""
    if schema:
        holder.apply_schema(schema)
    if not sources:
        return
    local_id = local_id or cluster.local_id
    target = cluster.node_by_id(local_id)
    if target is None:
        raise ConnectionError(
            f"resize target {local_id!r} has no membership entry")
    srcs = [ResizeSource(**s) for s in sources]
    by_source: dict[str, list[ResizeSource]] = {}
    for src in srcs:
        by_source.setdefault(src.source_node, []).append(src)
    t_json = target.to_json()
    for _, frags in sorted(by_source.items()):
        node = _resolve_source(cluster, frags[0])
        # Synchronous relay: LocalClient returns the handler's value;
        # the HTTP POST blocks until the source's handler returned.
        # Either way an error raises here and fails this target's ACK.
        for i in range(0, len(frags), PUSH_BATCH_FRAGMENTS):
            client.send_message(node, {
                "type": "resize-push", "job": job_id, "target": t_json,
                "sources": [asdict(f) for f in frags[i:i + PUSH_BATCH_FRAGMENTS]]})
    by_shard: dict[tuple[str, int], list[ResizeSource]] = {}
    for src in srcs:
        by_shard.setdefault((src.index, int(src.shard)), []).append(src)
    stats = getattr(cluster, "stats", None)
    for (index, shard), frags in sorted(by_shard.items()):
        t0 = time.monotonic()
        for src in frags:
            _catch_up_fragment(holder, client,
                               _resolve_source(cluster, src), src)
        idx = holder.index(index)
        if idx is not None:
            # Cutover pairing invariant (analysis checker
            # resize_cutover): the shard-epoch bump must precede the
            # cutover mark/announce, so any result cached against the
            # pre-cutover epoch is invalid before the new owner can
            # serve a read leg.
            idx.epoch.bump(shard=shard)
        mig = getattr(cluster, "migration", None)
        if mig is not None and (job_id is None or mig.job_id == job_id):
            mig.mark_cutover(index, shard)
        if stats is not None:
            stats.timing("cluster.resize.cutover", time.monotonic() - t0)
            stats.count("cluster.resize.shardsMigrated")
        if job_id and coordinator:
            msg = {"type": "resize-shard-cutover", "job": job_id,
                   "index": index, "shard": shard, "node": local_id}
            if coordinator.get("id") == local_id:
                deliver_cutover(msg, cluster)
            else:
                coord = cluster.node_by_id(coordinator.get("id", ""))
                if coord is None and coordinator.get("uri"):
                    coord = Node.from_json(coordinator)
                if coord is not None:
                    try:  # best-effort: /debug + read-spread signal only
                        client.send_message(coord, msg)
                    except (ConnectionError, RuntimeError, LookupError):
                        pass


def apply_cluster_status(cluster: Cluster, nodes_json: list[dict],
                         holder=None, availability: dict | None = None,
                         replica_n: int | None = None,
                         partition_n: int | None = None,
                         version: int | None = None) -> None:
    """mergeClusterStatus (cluster.go:1943): adopt a broadcast topology
    and, like the reference's NodeStatus, the sender's per-field shard
    availability so new members can route queries for shards they don't
    hold locally. replica_n/partition_n ride along so a joiner booted
    with mismatched settings can't silently compute a different ring.

    The push path enforces the same strictly-newer version gate as the
    pull path (Cluster.merge_membership): a delayed or replayed
    broadcast carrying an OLDER committed topology must not roll the
    ring back — that would resurrect removed members, shift jump-hash
    placement, and let the holder GC delete live fragments. Unversioned
    statuses (version None) predate the version field and are adopted
    as before. Shard availability always merges: it is additive and
    harmless."""
    with cluster._lock:
        stale = (version is not None
                 and int(version) <= cluster.topology_version)
        if not stale:
            # Adopting a committed topology ends any in-flight
            # migration on this member: either this IS the resize's
            # commit (the new ring now owns every moved shard) or a
            # newer topology superseded the job. Clear before the
            # holder cleaner runs so commit-time GC isn't suppressed
            # by the mid-migration guard.
            cluster.migration = None
            if replica_n:
                cluster.replica_n = int(replica_n)
            if partition_n:
                cluster.partition_n = int(partition_n)
            cluster.nodes = sorted((Node.from_json(n) for n in nodes_json),
                                   key=lambda n: n.id)
            if version is not None:
                cluster.topology_version = int(version)
            if not any(n.id == cluster.local_id for n in cluster.nodes):
                # A committed topology that excludes THIS node is a
                # removal notice: enter the terminal REMOVED state so
                # the API gate stays closed — serving reads/writes under
                # a ring we are no longer part of would make them
                # invisible to the rest of the cluster (ADVICE r4 #1).
                from pilosa_tpu_torch.cluster.cluster import STATE_REMOVED
                cluster.set_state(STATE_REMOVED)
            else:
                from pilosa_tpu_torch.cluster.cluster import STATE_REMOVED
                if cluster.state in (STATE_RESIZING, STATE_REMOVED):
                    # The commit broadcast ends the resize on every
                    # peer: clear RESIZING so the recompute below can
                    # run (the _update_state guard defers to the resize
                    # owner). A REMOVED node that appears in a NEWER
                    # committed ring has been re-added by the operator —
                    # the terminal state ends with this commit, not with
                    # a process restart.
                    cluster.set_state(STATE_NORMAL)
                cluster._update_state()
    if not stale:
        cluster.notify_topology()
    if holder is not None and availability:
        for index, fields in availability.items():
            idx = holder.index(index)
            if idx is None:
                continue
            for field, shards in fields.items():
                f = idx.field(field)
                if f is not None:
                    f.add_remote_available_shards(shards)


def apply_cluster_state(cluster: Cluster, state: str) -> None:
    """Peer half of ResizeJob._broadcast_state: adopt a coordinator-
    announced state transition. Entering RESIZING closes this node's API
    gate; leaving it recomputes the steady state from node liveness."""
    from pilosa_tpu_torch.cluster.cluster import STATE_REMOVED
    if cluster.state == STATE_REMOVED:
        return  # terminal: a stray steady-state broadcast (e.g. the
        # abort path's union fan-out) must not reopen a removed node.
    if state == STATE_RESIZING:
        cluster.set_state(STATE_RESIZING)
    else:
        if cluster.state == STATE_RESIZING:
            cluster.set_state(state)
        cluster._update_state()


def holder_availability(holder) -> dict:
    """{index: {field: [shards]}} from a holder's point of view."""
    out: dict = {}
    for iname in holder.index_names():
        idx = holder.index(iname)
        out[iname] = {fname: sorted(f.available_shards())
                      for fname, f in idx.fields.items()}
    return out


class ResizeJob:
    """Coordinator-driven resize. Known limitation for this round: the
    fragment inventory is the coordinator's view (schema + broadcast
    shard availability); remote-only time views are re-synced by
    anti-entropy after the resize."""

    #: how long the coordinator waits for every target's completion ACK.
    #: Generous by design: fragment streaming is bounded by data volume,
    #: not RPC timeouts, now that apply runs off the dispatch request.
    #: A DOWN event fails a pending target's ACK immediately; the
    #: deadline covers the blind spot where a target restarts so fast
    #: the failure detector never sees it down (its in-flight apply is
    #: simply gone, and the job must fail and release the gate rather
    #: than hold it — found by the chaos soak). Operators on flappy
    #: fleets tune it down via PILOSA_TPU_RESIZE_ACK_TIMEOUT.
    try:
        ACK_TIMEOUT = float(
            os.environ.get("PILOSA_TPU_RESIZE_ACK_TIMEOUT", "600"))
    except ValueError:  # malformed env must not make this module (and
        # with it the whole membership control plane) unimportable
        import sys as _sys
        print("PILOSA_TPU_RESIZE_ACK_TIMEOUT is not a number; "
              "using 600s", file=_sys.stderr)
        ACK_TIMEOUT = 600.0

    def __init__(self, cluster: Cluster, holder, client, store=None):
        self.cluster = cluster
        self.holder = holder
        self.client = client
        #: DiskStore (optional) so the commit-time holderCleaner can
        #: unlink the files of fragments it drops.
        self.store = store
        #: the node's own post-commit cleaner (ServerNode runs it after a
        #: grace period), or None to clean in line at the commit.
        self.cleaner = None
        self.state = "RUNNING"
        self.job_id = f"resize-{next(_JOB_SEQ)}"
        self._cond = threading.Condition()
        self._pending: set[str] = set()
        self.completed: list[str] = []
        self.failed: list[str] = []
        self.started_at = time.monotonic()
        self._last_cutover = self.started_at
        #: (index, shard) -> "pending" | "migrated", for /debug/resize.
        self.shard_status: dict[tuple[str, int], str] = {}

    def abort(self) -> None:
        with self._cond:
            self.state = "ABORTED"
            self._cond.notify_all()

    def complete(self, node_id: str, error: str | None) -> None:
        """A target finished applying its instruction (ACK receiver)."""
        with self._cond:
            if node_id not in self._pending:
                return
            self._pending.discard(node_id)
            if error:
                self.failed.append(node_id)
            else:
                self.completed.append(node_id)
            self._cond.notify_all()

    def fail_target(self, node_id: str, error: str) -> None:
        """Force-fail a target even after it ACKed: a dual-write failure
        means its copy diverged, so a completed ACK no longer proves the
        copy is current and the commit must not happen."""
        with self._cond:
            if self.state != "RUNNING":
                return
            self._pending.discard(node_id)
            if node_id not in self.failed:
                self.failed.append(node_id)
            self._cond.notify_all()

    def note_cutover(self, index: str, shard: int, node_id: str) -> None:
        with self._cond:
            self.shard_status[(index, int(shard))] = "migrated"
            self._last_cutover = time.monotonic()

    def snapshot(self) -> dict:
        """Live job state for GET /debug/resize."""
        with self._cond:
            statuses = list(self.shard_status.values())
            migrated = sum(1 for s in statuses if s == "migrated")
            now = time.monotonic()
            return {
                "job": self.job_id,
                "state": self.state,
                "pending": sorted(self._pending),
                "completed": list(self.completed),
                "failed": list(self.failed),
                "shards": {"total": len(statuses),
                           "migrated": migrated,
                           "inFlight": len(statuses) - migrated},
                "runningSeconds": round(now - self.started_at, 3),
                "lastCutoverLagSeconds": round(now - self._last_cutover, 3),
            }

    def _schema_fragments(self):
        out = set()
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            for fname, f in idx.fields.items():
                views = set(f.views)
                shards = f.available_shards()
                for vname in views or set():
                    for shard in shards:
                        out.add((iname, fname, vname, shard))
        return sorted(out)

    def run(self, new_nodes: list[Node]) -> str:
        # Coordinator duty gate: a fenced coordinator is (by its own
        # failure detector's evidence) on the minority side of a
        # partition — the majority may be electing a successor right
        # now, and a resize begun here would race its commits.
        if getattr(self.cluster, "fenced", False):
            self.state = "FAILED"
            return self.state
        old_view = Cluster("_old", [Node(id=n.id, uri=n.uri)
                                    for n in self.cluster.nodes],
                           replica_n=self.cluster.replica_n,
                           partition_n=self.cluster.partition_n)
        new_view = Cluster("_new", [Node(id=n.id, uri=n.uri)
                                    for n in new_nodes],
                           replica_n=self.cluster.replica_n,
                           partition_n=self.cluster.partition_n)
        local = self.cluster.node_by_id(self.cluster.local_id)
        coord_json = local.to_json() if local is not None else {
            "id": self.cluster.local_id}
        # Serve-through: NO ring-wide RESIZING gate. The ring keeps
        # serving under the old (authoritative) topology; a resize-begin
        # broadcast installs a MigrationTable on every member so writes
        # dual-apply to each shard's future owners while fragments move,
        # and the single cluster-status commit at the end flips
        # placement atomically. (The reference instead broadcast
        # ClusterStateResizing and closed every node's API for the whole
        # job, cluster.go:1470.)
        begin = {"type": "resize-begin", "job": self.job_id,
                 "coordinator": coord_json,
                 "nodes": [n.to_json() for n in new_nodes],
                 "replicaN": self.cluster.replica_n,
                 "partitionN": self.cluster.partition_n,
                 # The schema, as the instruction carries it: a joiner
                 # takes dual writes from this broadcast on, and a write
                 # fanned out before its instruction must find its index
                 # (ROADMAP.md Queue 3, F2; the JAX begin carries none).
                 "schema": self.holder.schema(),
                 # Fencing token: peers reject this begin if they have
                 # already adopted a newer topology (deposed coordinator).
                 "fencingToken": self.cluster.fencing_token()}
        # Per-target completion tracking (reference
        # ResizeInstructionComplete + per-node map, cluster.go:1315,
        # :1413-1438): the new topology is committed ONLY after every
        # target acknowledged its instruction; any failure leaves the
        # old topology fully intact. Remote targets apply in the
        # background and ACK via an explicit resize-instruction-complete
        # message, so a long fragment stream never hits an RPC timeout.
        with _JOBS_LOCK:
            _JOBS[self.job_id] = self

        # A target that dies after accepting its dispatch would otherwise
        # stall the job for the full ACK deadline with the resize gate
        # held: let the failure detector's DOWN event fail its pending
        # ACK immediately (the reference aborts the job on node-failure
        # events, cluster.go:1754).
        def on_event(ev):
            if ev.state == "DOWN":
                self.complete(ev.node_id, "node down during resize")

        self.cluster.subscribe(on_event)
        try:
            if self.state == "ABORTED":
                return self.state
            apply_resize_begin(self.cluster, begin)
            # Every LIVE old-ring member must install the table before
            # any fragment moves: a member without it keeps single-
            # applying writes, silently diverging the new copies. A
            # member the failure detector already marked DOWN is skipped
            # (it serves nothing; if it resurrects mid-job its writes
            # are refused by peers' liveness view and it learns the
            # outcome from the commit/sweeps). Joiners are mandatory
            # too: without a table their API gate refuses the dual-write
            # legs about to be aimed at them.
            members = {n.id: n for v in (old_view, new_view)
                       for n in v.nodes}
            for node in members.values():
                if node.id == self.cluster.local_id:
                    continue
                known = self.cluster.node_by_id(node.id)
                if known is not None and known.state == "DOWN":
                    continue
                try:
                    self.client.send_message(node, begin)
                except (ConnectionError, RuntimeError, LookupError):
                    self.failed.append(node.id)
            if self.failed:
                self.state = "FAILED"
                return self.state
            schema = self.holder.schema()
            try:
                instructions = fragment_sources(old_view, new_view,
                                                self._schema_fragments())
            except ValueError:
                self.state = "FAILED"
                raise
            # Every ADDED node gets an instruction even with nothing to
            # fetch: the message carries the schema, which a fresh
            # joiner doesn't have yet.
            old_ids = {n.id for n in old_view.nodes}
            for n in new_view.nodes:
                if n.id not in old_ids:
                    instructions.setdefault(n.id, [])
            with self._cond:
                for sources in instructions.values():
                    for s in sources:
                        self.shard_status.setdefault(
                            (s.index, int(s.shard)), "pending")
            for target_id, sources in sorted(instructions.items()):
                if self.state == "ABORTED":
                    return self.state
                payload = [asdict(s) for s in sources]
                try:
                    if target_id == self.cluster.local_id:
                        apply_resize_instruction(
                            self.holder, self.client, self.cluster,
                            payload, local_id=self.cluster.local_id,
                            job_id=self.job_id, coordinator=coord_json)
                        self.completed.append(target_id)
                    else:
                        node = new_view.node_by_id(target_id)
                        with self._cond:
                            self._pending.add(target_id)
                        # Dispatch only: the target applies in the
                        # background and ACKs with
                        # resize-instruction-complete.
                        self.client.send_message(
                            node, {"type": "resize-instruction",
                                   "job": self.job_id,
                                   "coordinator": coord_json,
                                   "schema": schema,
                                   "sources": payload})
                except (ConnectionError, LookupError, RuntimeError):
                    with self._cond:
                        self._pending.discard(target_id)
                    self.failed.append(target_id)
            # Wait for every dispatched target's ACK (or abort/deadline).
            with self._cond:
                self._cond.wait_for(
                    lambda: not self._pending or self.state == "ABORTED",
                    timeout=self.ACK_TIMEOUT)
                if self.state == "ABORTED":
                    return self.state
                if self._pending:  # deadline: never-ACKed targets failed
                    self.failed.extend(sorted(self._pending))
                    self._pending.clear()
            if self.failed:
                # A target never confirmed its fragments: committing the
                # new topology would route reads to holes. Old topology
                # stays live; operator (or the next join attempt) retries.
                self.state = "FAILED"
                return self.state
            # Commit: broadcast the new topology + shard availability,
            # adopt it locally.
            status = {"type": "cluster-status",
                      "nodes": [n.to_json() for n in new_nodes],
                      "replicaN": self.cluster.replica_n,
                      "partitionN": self.cluster.partition_n,
                      "version": self.cluster.topology_version + 1,
                      "availability": holder_availability(self.holder)}
            # Removed nodes get the commit too (ADVICE r4: they are not
            # in new_nodes, so without this they sit in RESIZING until
            # _recover_stuck_resizing reopens their gate under the stale
            # pre-resize ring — a zombie accepting invisible writes).
            # Receiving a committed status that excludes them flips them
            # to the terminal REMOVED state (apply_cluster_status).
            new_ids = {node.id for node in new_nodes}
            removed = [n for n in self.cluster.nodes if n.id not in new_ids]
            for node in list(new_nodes) + removed:
                if node.id != self.cluster.local_id:
                    try:
                        self.client.send_message(node, status)
                    except (ConnectionError, RuntimeError):
                        pass
            apply_cluster_status(self.cluster, status["nodes"],
                                 version=status["version"])
            # Coordinator-side holderCleaner (holder.go:1126): peers GC
            # on receiving the status broadcast; the coordinator adopted
            # it directly, so GC here (disk half included when a store
            # was attached), or hand it to ``cleaner`` when one is set.
            if self.cleaner is not None:
                self.cleaner()
            else:
                from pilosa_tpu_torch.cluster.cleaner import clean_holder
                clean_holder(self.holder, self.cluster, store=self.store)
            self.state = "DONE"
            return self.state
        finally:
            self.cluster.unsubscribe(on_event)
            with _JOBS_LOCK:
                _JOBS.pop(self.job_id, None)
            if self.state != "DONE":
                # Non-commit exit (FAILED/ABORTED/exception): drop the
                # migration tables everywhere. The old ring never
                # stopped being authoritative and no shard was ever
                # routed away from its old owner, so this IS the whole
                # rollback — partially migrated copies become garbage
                # the holder cleaner GCs after the next committed
                # topology. Best-effort: a peer that misses the end
                # message drops its table via the stale-migration sweep
                # (_recover_stale_migration) or the next begin/commit.
                end = {"type": "resize-end", "job": self.job_id}
                apply_resize_end(self.cluster, end)
                for node in {n.id: n for v in (old_view, new_view)
                             for n in v.nodes}.values():
                    if node.id == self.cluster.local_id:
                        continue
                    try:
                        self.client.send_message(node, end)
                    except (ConnectionError, RuntimeError, LookupError):
                        pass
            if self.cluster.state == STATE_RESIZING:
                # Non-commit exit (FAILED/ABORTED/exception): reopen the
                # gate everywhere. set_state first (clears RESIZING so
                # _update_state's guard disengages), then RECOMPUTE from
                # node liveness — a peer that died mid-job must yield
                # DEGRADED/STARTING here, not a blind NORMAL.
                self.cluster.set_state(STATE_NORMAL)
                self.cluster._update_state()
                # Union of surviving ring + attempted targets: a FAILED
                # join must reopen the joiner's gate too, even though it
                # never made it into the committed ring.
                self._broadcast_state(
                    STATE_NORMAL,
                    {n.id: n for n in
                     list(self.cluster.nodes) + list(new_nodes)}.values())

    def _broadcast_state(self, state: str, nodes) -> None:
        """Push a cluster-state transition to peers (best-effort: an
        unreachable peer is either dead — its gate is moot — or will
        learn the steady state from the commit broadcast / sweeps)."""
        msg = {"type": "cluster-state", "state": state}
        for node in nodes:
            if node.id == self.cluster.local_id:
                continue
            try:
                self.client.send_message(node, msg)
            except (ConnectionError, RuntimeError, LookupError):
                pass


#: intermediaries asked to confirm an unreachable peer before DOWN
#: (memberlist IndirectChecks analog).
INDIRECT_PROBES = 2


def check_nodes(cluster: Cluster, client, retries: int = 2,
                discover: bool = True) -> list[str]:
    """Failure detector sweep: probe every peer, confirm before marking
    down (reference confirmNodeDown cluster.go:1724-1751: /version probe
    with retry), and — SWIM-style (gossip/gossip.go:43-443) — ask up to
    INDIRECT_PROBES other live members to probe an unreachable peer
    before declaring it down, so an asymmetric partition between THIS
    node and one member doesn't false-positive into node-down repair
    churn. Returns ids whose state changed. ``discover`` adds the
    membership push/pull (one GET per live peer) — callers on a tight
    sweep cadence can run it every few sweeps."""
    changed = []
    reachable = 1  # self
    for node in list(cluster.nodes):
        if node.id == cluster.local_id:
            continue
        alive = False
        for _ in range(retries):
            try:
                client.probe(node)
                alive = True
                break
            except ConnectionError:
                continue
        direct_alive = alive
        indirect_verdicts: dict[str, bool] = {}
        # Indirect confirmation only for a SUSPECT transition (a peer
        # we thought was up going unreachable) — confirming an
        # already-DOWN corpse every sweep would put constant probe load
        # on the intermediaries (memberlist also scopes indirect checks
        # to suspicion).
        if (not alive and node.state != "DOWN"
                and hasattr(client, "indirect_probe")):
            import random
            intermediaries = [n for n in cluster.nodes
                              if n.id not in (cluster.local_id, node.id)
                              and n.state != "DOWN"]
            # Random sample (memberlist's k-random-members): fixed
            # ring-order picks would concentrate confirm load on two
            # nodes and correlate their failure with the suspect's.
            picked = random.sample(intermediaries,
                                   min(INDIRECT_PROBES, len(intermediaries)))
            if len(picked) > 1:
                # Concurrent confirms: serialized probes would add their
                # timeouts to the sweep and delay detecting OTHER
                # failures behind this suspect.
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(len(picked)) as pool:
                    def ask(via, node=node):
                        try:
                            return client.indirect_probe(via, node)
                        except (ConnectionError, OSError, RuntimeError):
                            return False
                    verdicts = list(pool.map(ask, picked))
                indirect_verdicts = {via.id: ok
                                     for via, ok in zip(picked, verdicts)}
                alive = any(verdicts)
            elif picked:
                ok = False
                try:
                    ok = bool(client.indirect_probe(picked[0], node))
                except (ConnectionError, OSError, RuntimeError):
                    pass
                indirect_verdicts = {picked[0].id: ok}
                alive = alive or ok
        # Membership push/pull only over a DIRECTLY-reachable link: a
        # peer alive only via indirect probe is unreachable from here,
        # and a full-timeout GET at it would stall the whole sweep.
        if direct_alive and discover:
            # Transitive membership exchange rides the liveness sweep
            # (memberlist's push/pull, gossip.go:295): a peer holding a
            # STRICTLY NEWER committed topology hands us the whole ring,
            # so discovery doesn't depend on reaching the coordinator —
            # and stale peers can't resurrect removed members.
            try:
                resp = client.nodes(node)
            except (ConnectionError, RuntimeError, LookupError,
                    AttributeError):
                resp = None
            if isinstance(resp, dict) and resp.get("nodes"):
                changed.extend(cluster.merge_membership(
                    resp["nodes"], int(resp.get("version", 0))))
        # A merge_membership above may have REPLACED cluster.nodes with
        # fresh Node objects — re-resolve by id so the liveness
        # transition lands on the live entry, not an orphan of the old
        # list (and skip nodes the merge removed outright).
        live = next((n for n in cluster.nodes if n.id == node.id), None)
        if live is None:
            continue
        if alive:
            reachable += 1
        # Per-peer observation record for GET /debug/membership: what
        # THIS node's detector last saw, not a consensus view.
        cluster.membership_log[live.id] = {
            "state": live.state,
            "lastProbeOk": alive,
            "lastProbeDirect": direct_alive,
            "lastProbeAt": time.time(),
            "indirect": indirect_verdicts,
        }
        if alive and live.state == "DOWN":
            live.state = "READY"
            changed.append(live.id)
            cluster.stats.count("cluster.nodeUp")
            cluster._emit(EVENT_UPDATE, live.id, "READY")
        elif not alive and live.state != "DOWN":
            live.state = "DOWN"
            changed.append(live.id)
            cluster.stats.count("cluster.nodeDown")
            cluster._emit(EVENT_UPDATE, live.id, "DOWN")
    if changed:
        cluster._update_state()
    # Quorum self-fence: this sweep IS our view of the ring — fence
    # when the reachable set (self + direct/indirect-alive peers) is
    # not a strict majority, un-fence when majority returns.
    cluster.observe_quorum(reachable, len(cluster.nodes))
    _recover_stuck_resizing(cluster, client)
    return changed


#: consecutive failure-detector sweeps a coordinator must stay DOWN
#: before a peer concludes a phantom RESIZING state died with it.
RESIZING_COORD_DOWN_SWEEPS = 3


def _recover_stale_migration(cluster: Cluster) -> None:
    """Drop a migration table whose coordinator died mid-job: the
    coordinator's crash killed the only thread that would have sent
    resize-end (or the commit), so without this sweep every member
    dual-applies writes forever against a job that no longer exists.
    Debounced over the same consecutive-DOWN-sweeps window as the
    RESIZING recovery — a coordinator GC pause must not drop tables
    while fragments still move. Dropping is always safe (the old ring
    stayed authoritative); worst case a resurrected coordinator's job
    fails its targets' catch-up and retries."""
    mig = getattr(cluster, "migration", None)
    if mig is None:
        cluster._migration_coord_down_sweeps = 0
        return
    coord_id = mig.coordinator.get("id", "")
    if coord_id == cluster.local_id:
        return  # the local ResizeJob owns this table's lifecycle
    coord = cluster.node_by_id(coord_id)
    if coord is None:
        if cluster.state == STATE_STARTING:
            # A joiner doesn't know the ring yet — the coordinator being
            # unresolvable is expected, not evidence of death.
            return
        down = True  # not in our committed ring: no authority exists
    else:
        down = coord.state == "DOWN"
    if not down:
        cluster._migration_coord_down_sweeps = 0
        return
    sweeps = getattr(cluster, "_migration_coord_down_sweeps", 0) + 1
    cluster._migration_coord_down_sweeps = sweeps
    if sweeps >= RESIZING_COORD_DOWN_SWEEPS:
        cluster._migration_coord_down_sweeps = 0
        cluster.migration = None


def _recover_stuck_resizing(cluster: Cluster, client) -> None:
    """A non-coordinator stuck in RESIZING self-heals here: a removed
    node never receives the commit broadcast (it isn't in the new
    ring), and a coordinator crash mid-job kills the only thread that
    would have restored the state. The coordinator's own view is
    authoritative: if it reports any steady state — or is dead — the
    resize no longer exists and the gate must reopen."""
    _recover_stale_migration(cluster)
    if cluster.state != STATE_RESIZING:
        # Not resizing: clear any debounce left by a PREVIOUS job so the
        # next resize starts its DOWN count from zero.
        cluster._resizing_coord_down_sweeps = 0
        return
    local = cluster.node_by_id(cluster.local_id)
    if local is not None and local.is_coordinator:
        return  # the local ResizeJob owns this state
    coord = next((n for n in cluster.nodes
                  if n.is_coordinator and n.id != cluster.local_id), None)
    over = False
    removed = False
    if coord is None:
        over = True  # no resize authority exists at all
    elif coord.state == "DOWN":
        # A single failed sweep is a weak proxy for "the job died" — a
        # GC pause or blip would reopen the gate while fragments still
        # move, and a write accepted then could be GC'd at commit.
        # Require several consecutive DOWN sweeps before concluding the
        # coordinator (and its job) are gone.
        down = getattr(cluster, "_resizing_coord_down_sweeps", 0) + 1
        cluster._resizing_coord_down_sweeps = down
        over = down >= RESIZING_COORD_DOWN_SWEEPS
    else:
        cluster._resizing_coord_down_sweeps = 0
        try:
            resp = client.nodes(coord)
            if isinstance(resp, dict):
                # Only an AFFIRMATIVE steady-state report clears the
                # gate; errors/old peers keep it closed.
                over = (resp.get("state") is not None
                        and resp["state"] != STATE_RESIZING)
                # A steady-state ring that no longer contains this node
                # means the commit (whose broadcast we evidently missed)
                # removed us: terminal REMOVED, not a reopened zombie
                # serving the stale pre-resize ring (ADVICE r4 #1).
                peer_nodes = resp.get("nodes")
                if over and isinstance(peer_nodes, list) and peer_nodes:
                    removed = not any(
                        isinstance(n, dict) and n.get("id") == cluster.local_id
                        for n in peer_nodes)
        except (ConnectionError, RuntimeError, LookupError,
                AttributeError):
            over = False
    if over:
        from pilosa_tpu_torch.cluster.cluster import STATE_REMOVED
        cluster._resizing_coord_down_sweeps = 0
        if removed:
            cluster.set_state(STATE_REMOVED)
        else:
            cluster.set_state(STATE_NORMAL)
            cluster._update_state()
