"""The cluster's liveness sweep and shard availability.

The port's copy of the failure detector of pilosa_tpu/cluster/resize.py
(``check_nodes``, :890-1014) and of ``holder_availability``. The JAX
sweep also recovers a RESIZING state stranded by a dead coordinator; the
port never enters RESIZING, because resize itself (``ResizeJob``, the
migration table, fragment streaming) is not ported (ROADMAP.md Queue 1:
cluster and operations).
"""

from __future__ import annotations

import time

from pilosa_tpu_torch.cluster.cluster import Cluster
from pilosa_tpu_torch.cluster.event import EVENT_UPDATE

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
    return changed


def holder_availability(holder) -> dict:
    """{index: {field: [shards]}} from a holder's point of view."""
    out: dict = {}
    for iname in holder.index_names():
        idx = holder.index(iname)
        out[iname] = {fname: sorted(f.available_shards())
                      for fname, f in idx.fields.items()}
    return out
