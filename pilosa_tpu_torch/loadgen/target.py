"""Scenario targets: the live cluster a run drives, over real HTTP.

The port's copy of pilosa_tpu/loadgen/target.py; its ``ManagedTarget``
boots the port's ServerNodes on the card unless given ``device="cpu"``.

Two flavors behind one surface:

- ``ManagedTarget`` boots N in-process ServerNodes on loopback ports
  (full stack: QoS gate, quotas, breakers, hedge, result cache,
  profile ring, /metrics) and owns their lifecycle -- the CI/bench
  mode, and the only mode that can run the resize chaos actions.
- ``AttachedTarget`` points at already-running nodes by URL -- the
  "drive a real deployment" mode. Chaos actions degrade gracefully:
  slow_peer needs the node started with chaos faults enabled;
  add/remove_node are refused.

Either way the engine talks production HTTP -- the same admission,
cache, and profile paths a real client hits, not a bench backdoor.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request


def _free_ports(n: int) -> list[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class QueryOutcome:
    """One request's classification, from the HTTP status line."""

    __slots__ = ("status", "code")

    def __init__(self, status: str, code: int):
        self.status = status   # ok | shed | quota | deadline | error
        self.code = code


_STATUS_BY_CODE = {503: "shed", 429: "quota", 504: "deadline"}


class _HTTPTargetBase:
    """Shared HTTP plumbing over a list of node base URLs."""

    def __init__(self, base_urls: list[str], timeout: float = 30.0):
        self.base_urls = list(base_urls)
        self.timeout = timeout

    # -- raw I/O ------------------------------------------------------

    def _post(self, url: str, body: str = "",
              headers: dict | None = None) -> bytes:
        req = urllib.request.Request(url, data=body.encode(),
                                     headers=headers or {}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()

    def _get(self, url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return resp.read()

    # -- setup surface ------------------------------------------------

    def create_index(self, index: str, opts: dict | None = None) -> None:
        self._post(f"{self.base_urls[0]}/index/{index}",
                   json.dumps({"options": opts or {}}))

    def create_field(self, index: str, fld: str,
                     opts: dict | None = None) -> None:
        self._post(f"{self.base_urls[0]}/index/{index}/field/{fld}",
                   json.dumps({"options": opts or {}}))

    def import_bits(self, index: str, fld: str, rows, cols) -> None:
        self._post(f"{self.base_urls[0]}/index/{index}/field/{fld}/import",
                   json.dumps({"rowIDs": [int(r) for r in rows],
                               "columnIDs": [int(c) for c in cols]}))

    # -- query path ---------------------------------------------------

    def query(self, index: str, pql: str, *, qos_class: str = "",
              tenant: str = "", trace_id: str = "",
              no_cache: bool = False, node: int = 0) -> QueryOutcome:
        """One client query. Never retries -- an open-loop generator
        records the rejection instead of hiding it behind a retry."""
        url = f"{self.base_urls[node % len(self.base_urls)]}" \
              f"/index/{index}/query"
        params = []
        if qos_class:
            params.append(f"qosClass={qos_class}")
        if no_cache:
            params.append("noCache=true")
        if params:
            url += "?" + "&".join(params)
        headers = {}
        if trace_id:
            headers["X-Pilosa-Trace-Id"] = trace_id
        if tenant:
            headers["X-API-Key"] = tenant
        try:
            self._post(url, pql, headers)
            return QueryOutcome("ok", 200)
        except urllib.error.HTTPError as e:
            e.read()
            return QueryOutcome(_STATUS_BY_CODE.get(e.code, "error"), e.code)
        except (urllib.error.URLError, ConnectionError, OSError, TimeoutError):
            return QueryOutcome("error", 0)

    # -- observability surface ---------------------------------------

    def metrics_text(self, node: int = 0) -> str:
        return self._get(f"{self.base_urls[node]}/metrics").decode()

    def debug_vars(self, node: int = 0) -> dict:
        return json.loads(self._get(f"{self.base_urls[node]}/debug/vars"))

    def resolve_profile(self, trace_id: str, node: int = 0) -> dict | None:
        """Full nested cost profile for a trace id, or None. Any node
        answers -- a local ring miss fans out to the coordinator that
        retained the whole timeline."""
        try:
            return json.loads(self._get(
                f"{self.base_urls[node]}/debug/queries/{trace_id}"))
        except (urllib.error.URLError, OSError):
            return None

    # -- chaos surface ------------------------------------------------

    def slow_peer(self, node: int, delay_ms: float) -> bool:
        try:
            self._post(f"{self.base_urls[node]}/internal/fault",
                       json.dumps({"slowMs": delay_ms}))
            return True
        except (urllib.error.URLError, OSError):
            return False   # node without chaos faults mounted

    def heal_peer(self, node: int) -> bool:
        return self.slow_peer(node, 0.0)

    def _node_ids(self) -> list[str] | None:
        """Cluster node id per base URL (via /debug/membership), or
        None when any node can't answer -- partition faults address
        peers by id, not by URL."""
        ids = []
        for u in self.base_urls:
            try:
                doc = json.loads(self._get(f"{u}/debug/membership"))
            except (urllib.error.URLError, OSError, ValueError):
                return None
            if not doc.get("localId"):
                return None
            ids.append(doc["localId"])
        return ids

    def partition(self, group: list[int], mode: str = "drop",
                  delay_ms: float = 0.0) -> bool:
        """Cut the network between ``group`` (node indices) and the
        rest. ``drop``/``timeout`` fault both directions; ``oneway``
        faults only the group's outbound links -- the asymmetric case
        where A can't reach B but B still reaches A."""
        ids = self._node_ids()
        if ids is None:
            return False
        n = len(self.base_urls)
        side = {i % n for i in group}
        fault_mode = "drop" if mode == "oneway" else mode
        ok = True
        for i, url in enumerate(self.base_urls):
            if i in side:
                peers = [ids[j] for j in range(n) if j not in side]
            elif mode != "oneway":
                peers = [ids[j] for j in sorted(side)]
            else:
                continue
            if not peers:
                continue
            try:
                self._post(f"{url}/internal/fault",
                           json.dumps({"partition": {
                               "peers": peers, "mode": fault_mode,
                               "delayMs": delay_ms}}))
            except (urllib.error.URLError, OSError):
                ok = False
        return ok

    def heal_partition(self) -> bool:
        ok = True
        for url in self.base_urls:
            try:
                self._post(f"{url}/internal/fault",
                           json.dumps({"healPartition": True}))
            except (urllib.error.URLError, OSError):
                ok = False
        return ok

    def add_node(self) -> bool:
        return False

    def remove_node(self, node: int) -> bool:
        return False

    def dr_backup(self) -> bool:
        return False

    def dr_destroy_data(self, node: int) -> bool:
        return False

    def close(self) -> None:
        pass


class AttachedTarget(_HTTPTargetBase):
    """Drive an already-running node/cluster by URL."""

    def __init__(self, urls: list[str], timeout: float = 30.0):
        super().__init__([u.rstrip("/") for u in urls], timeout)
        self.mode = "attached"

    def import_stream(self, reqs: list[dict]) -> int:
        # Without a managed internal client, fall back to per-batch
        # JSON imports -- slower, same bits.
        for r in reqs:
            self._post(
                f"{self.base_urls[0]}/index/{r['index']}"
                f"/field/{r['field']}/import",
                json.dumps({"columnIDs": [int(c) for c in r["columnIDs"]],
                            "values": [int(v) for v in r["values"]]}))
        return len(reqs)


class ManagedTarget(_HTTPTargetBase):
    """Boot and own N in-process ServerNodes for one run, on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, n_nodes: int = 1, replica_n: int = 1,
                 node_opts: dict | None = None, timeout: float = 30.0,
                 data_root: str | None = None, device: str = "cuda"):
        from pilosa_tpu_torch.server.node import ServerNode
        from pilosa_tpu_torch.server.httpclient import HTTPInternalClient
        self.mode = "managed"
        # slow-log threshold stays high: the harness reads quantiles
        # and the profile ring, not a WARNING line per query.
        opts = {"use_planner": False, "anti_entropy_interval": 0.0,
                "check_nodes_interval": 0.0, "qos_slow_query_ms": 1000.0,
                "chaos_faults": True, "device": device}
        opts.update(node_opts or {})
        # data_root gives each node its own durable data dir (the DR
        # drill needs real stores to back up and destroy); without it
        # the nodes stay memory-only as before.
        self._data_root = data_root
        self._dir_seq = n_nodes
        self._node_opts = opts
        addrs = [f"127.0.0.1:{p}" for p in _free_ports(n_nodes)]
        self.nodes = [ServerNode(bind=a, peers=addrs if n_nodes > 1 else None,
                                 replica_n=replica_n,
                                 **self._opts_for(i))
                      for i, a in enumerate(addrs)]
        self._replica_n = replica_n
        self._lock = threading.Lock()
        for n in self.nodes:
            n.open()
        super().__init__([n.address for n in self.nodes], timeout)
        self._client = HTTPInternalClient(timeout=timeout)

    def _opts_for(self, i: int) -> dict:
        opts = dict(self._node_opts)
        if self._data_root:
            opts["data_dir"] = os.path.join(self._data_root, f"n{i}")
        return opts

    def _peer(self, node: int = 0):
        from pilosa_tpu_torch.cluster.node import URI, Node
        n = self.nodes[node]
        return Node(id=n.id, uri=URI(host=n.host, port=n.port))

    def import_stream(self, reqs: list[dict]) -> int:
        """One PTS1 stream a node: each shard's requests go to every owner
        of the shard under node 0's placement (the internal stream route
        applies what it receives, as a routed import's peer leg does). The
        JAX harness streams every shard to node 0, so an owner of a shard
        node 0 does not own never holds those bits, and a backup archives
        node 0's stray copy where the owners have none."""
        cluster = self.nodes[0].cluster
        if cluster is None:
            return self._client.send_import_stream(self._peer(0), reqs)
        by_owner: dict[str, tuple] = {}
        for r in reqs:
            for owner in cluster.shard_nodes(r["index"], int(r["shard"])):
                by_owner.setdefault(owner.id, (owner, []))[1].append(r)
        for owner, part in by_owner.values():
            self._client.send_import_stream(owner, part)
        return len(reqs)

    def add_node(self) -> bool:
        from pilosa_tpu_torch.server.node import ServerNode
        with self._lock:
            addr = f"127.0.0.1:{_free_ports(1)[0]}"
            opts = self._opts_for(self._dir_seq)
            self._dir_seq += 1
            joiner = ServerNode(bind=addr, join=self.nodes[0].id,
                                replica_n=self._replica_n, **opts)
            joiner.open()
            self.nodes.append(joiner)
            self.base_urls.append(joiner.address)
            return True

    def _coordinator(self):
        return next((n for n in self.nodes
                     if n.cluster.coordinator() is not None
                     and n.cluster.coordinator().id == n.id),
                    self.nodes[0])

    def _remove(self, node: int):
        """Resize a member out of the ring; returns the closed victim
        ServerNode, or None when removal isn't possible."""
        with self._lock:
            if node <= 0 or node >= len(self.nodes):
                return None   # never shoot node 0 (our setup anchor)
            # Removal is a coordinator-only request, and the coordinator
            # is elected by node-id order -- not necessarily nodes[0]. If
            # the named victim IS the coordinator, shoot another member
            # instead: the scenario asks for "a member leaves", not for
            # a coordinator handoff.
            coord = self._coordinator()
            victim = self.nodes[node]
            if victim is coord:
                others = [i for i in range(1, len(self.nodes))
                          if self.nodes[i] is not coord]
                if not others:
                    return None
                node = others[-1]
                victim = self.nodes[node]
            try:
                self._post(f"{coord.address}/cluster/resize/remove-node",
                           json.dumps({"id": victim.id}))
            except (urllib.error.URLError, OSError):
                return None
            self.nodes.pop(node)
            self.base_urls.pop(node)
            victim.close()
            return victim

    def remove_node(self, node: int) -> bool:
        return self._remove(node) is not None

    # -- DR drill surface ---------------------------------------------

    def dr_backup(self) -> bool:
        """Force one scheduled-backup cycle on the coordinator NOW
        (drills and tests; the timer path stays untouched). Retries a
        few times -- the drill's archive injects faults on purpose."""
        coord = self._coordinator()
        sched = getattr(coord, "backup_scheduler", None)
        if sched is None:
            return False
        deadline = time.time() + 30.0
        while time.time() < deadline:
            if not coord._backup_gate.acquire(blocking=False):
                # a timer-driven run is mid-capture; wait it out
                time.sleep(0.1)
                continue
            try:
                st = sched.run_once(force=True)
            finally:
                coord._backup_gate.release()
            if st in ("ran", "skipped-unchanged"):
                return True
            time.sleep(0.2)
        return False

    def dr_destroy_data(self, node: int) -> bool:
        """The drill's disaster: resize the member out of the ring
        (serving continues on the survivors), then destroy its data
        directory beyond recovery -- only the archive can bring those
        bytes back."""
        victim = self._remove(node)
        if victim is None:
            return False
        if victim.data_dir:
            shutil.rmtree(victim.data_dir, ignore_errors=True)
        return True

    def fragment_digest(self) -> dict[str, set[str]]:
        """Bit-level content fingerprint of every fragment this cluster
        owns: (index/field/view/shard) -> the set of per-replica block-
        checksum digests. Only placement owners contribute -- a resize
        leaves restorable-but-stale bytes on former owners, and those
        are not the cluster's state. The DR drill's equivalence check:
        every restored fragment's digest must appear in the live set
        (a backup captures exactly one healthy replica's bytes)."""
        out: dict[str, set[str]] = {}
        for n in self.nodes:
            if n.store is None:
                continue
            for iname, fld, view, shard in n.store.all_fragment_keys():
                if n.cluster is not None and n.id not in {
                        m.id for m in n.cluster.shard_nodes(iname, shard)}:
                    continue
                blocks = n.api.fragment_blocks(iname, fld, view, shard)
                digest = ";".join(f"{b}:{cs.hex()}"
                                  for b, cs in sorted(blocks.items()))
                out.setdefault(f"{iname}/{fld}/{view}/{shard}",
                               set()).add(digest)
        return out

    def close(self) -> None:
        self._client.close()
        for n in self.nodes:
            try:
                n.close()
            except Exception:
                pass
