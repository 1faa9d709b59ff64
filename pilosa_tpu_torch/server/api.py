"""API — the operation surface of a node.

The port's counterpart of pilosa_tpu/server/api.py. Reference: api.go (API
struct :42, Query :135, index/field CRUD :162-467, Import/ImportValue
:920-1127, ExportCSV :500, schema :726-758, Status :1129-1260). The HTTP
layer is a thin router over these methods.

On a cluster (``cluster=``) each method is gated on the cluster's state
and on its quorum fence (``_validate``); a remote query leg answers with
the typed wire frames (``server/wire.py``) stamped with this node's shard
epochs; schema changes broadcast to the peers; imports go to every owner
of each shard. A standalone node is always NORMAL. With a data dir, ``store`` is the node's
``storage.DiskStore``: creating an index or field writes ``schema.json``
at once, so the WAL records of a node killed before its first flush are
found again at boot (the JAX node writes the schema only when it flushes
or deletes: ROADMAP.md Queue 3); deleting an index, field or view
unlinks its files too. Imports by row and column keys allocate their ids
in the index's and field's translate stores, one batch each (on a
cluster through ``translator``, the coordinator allocating), and
``translate_keys``/``translate_entries`` serve the key routes. While a
resize runs, imports also go to each shard's future owners (the migration
table's dual writes), and routed imports ship to each peer as one PTS1
import stream.
"""

from __future__ import annotations

import io
from typing import Any, Iterable

import numpy as np

import pilosa_tpu_torch
from pilosa_tpu_torch.cluster.cluster import (
    STATE_DEGRADED,
    STATE_NORMAL,
    STATE_REMOVED,
    STATE_RESIZING,
)
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core.field import FieldOptions, parse_stamps
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.errors import (
    ApiMethodNotAllowedError,
    ClusterFencedError,
    FieldNotFoundError,
    FragmentNotFoundError,
)
from pilosa_tpu_torch.exec.executor import ExecOptions, Executor
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.obs import profile as _profile


class API:
    """Reference API (api.go:42)."""

    def __init__(self, holder: Holder, executor: Executor, cluster=None):
        self.holder = holder
        self.executor = executor
        self.cluster = cluster
        #: cluster key-allocation hook: (index, field or None, keys) -> ids
        #: (ClusterKeyTranslator); None allocates locally.
        self.translator = None
        #: the running or last ResizeJob (GET /debug/resize), and the
        #: node's resize entry point (action, node_id=, addr=) -> state.
        self.resize_job = None
        self.resize_handler = None
        #: the /internal/import-stream byte budget (qos.IngestGate), or None.
        self.ingest_gate = None
        #: chaos hooks: per-query latency injected by POST /internal/fault,
        #: a route mounted only when ``chaos_faults`` is set.
        self.fault_slow_s = 0.0
        self.chaos_faults = False
        #: the node's storage.DiskStore, or None without a data dir.
        self.store = None
        #: this server's own ring entry (cluster.node.Node), set by
        #: ServerNode once its listener has a port.
        self.local_node = None
        #: QoS front (qos.AdmissionController), set by ServerNode; None =
        #: no admission gate, no default deadline, no slow-query log.
        self.qos = None
        #: per-tenant token buckets (qos.TenantQuotas), or None.
        self.quotas = None
        #: slowest-N retained query profiles (obs.ProfileRing), or None.
        self.profile_ring = None
        #: profile every query into the ring, not only ?profile=true ones.
        self.profile_default = True
        #: set once a cluster member has merged its peers' schema and shard
        #: availability after boot (ServerNode.open); a query that is not
        #: a remote leg waits for it, at most PEER_MERGE_WAIT_S. None: no
        #: wait (a standalone node, a joiner).
        self.peers_merged = None

    #: how long a query waits on a member's first merge of its peers'
    #: shards before it runs on what the node knows.
    PEER_MERGE_WAIT_S = 60.0

    #: method-availability matrix per cluster state (reference
    #: api.go:99-105 validAPIMethods + :1379-1411 method sets): during
    #: STARTING only control-plane traffic flows; during RESIZING only
    #: control plane + abort.
    _METHODS_RESIZING = frozenset({"resize-abort"})

    #: read-only methods a FENCED node may keep serving when the operator
    #: opts into staleness (Cluster.fence_stale_reads).
    _METHODS_FENCED_READS = frozenset({"query", "export-csv"})

    def _validate(self, method: str, internal: bool = False) -> None:
        """The JAX API's state gate (api.py:69-120): a fenced node refuses
        client traffic (internal traffic is how the fence heals); outside
        NORMAL and DEGRADED only internal reads, while RESIZING the resize
        methods, and under a migration table the imports pass."""
        if self.cluster is None:
            return  # standalone node: always NORMAL
        if self.cluster.fenced and not internal:
            if not (self.cluster.fence_stale_reads
                    and method in self._METHODS_FENCED_READS):
                raise ClusterFencedError(
                    f"api method {method} refused: node is fenced (no quorum)")
        state = self.cluster.state
        if state in (STATE_NORMAL, STATE_DEGRADED):
            return
        if (internal and method in self._METHODS_FENCED_READS
                and state != STATE_REMOVED):
            # A partitioned minority sits in STARTING, but the majority's
            # detector may already be fanning read legs here again, and
            # this node's fragments are still their replica copies.
            return
        if state == STATE_RESIZING and method in self._METHODS_RESIZING:
            return
        if (method in ("import", "import-value", "import-roaring")
                and self.cluster.migration is not None
                and state != STATE_REMOVED):
            # A joiner sits in STARTING, but the migration table from
            # resize-begin is the coordinator's grant to receive the
            # dual writes and the bulk stream of the shards it will own.
            return
        raise ApiMethodNotAllowedError(
            f"api method {method} not allowed in state {state}")

    #: public alias for route handlers that serve holder state directly.
    validate_method = _validate

    # -- query (api.go:135) ------------------------------------------------

    def query(self, index: str, query: str,
              shards: list[int] | None = None, column_attrs: bool = False,
              exclude_row_attrs: bool = False, exclude_columns: bool = False,
              remote: bool = False, accept_frames: int | bool = False,
              cache: bool = True):
        """Execute PQL; returns the QueryResponse JSON dict
        ({"results": [...]}, handler.go:60-75) -- or, for a remote leg
        whose caller accepts them, binary frames (bytes) carrying Row
        results as roaring blobs (wire.encode_frames; ``accept_frames``
        2 asks for the v2 layout)."""
        # Remote legs are coordinator-internal: a fenced node still answers
        # the majority's fan-out (it may hold their replica).
        self._validate("query", internal=remote)
        merged = self.peers_merged
        if merged is not None and not remote:
            # A member just (re)started answers no query short of the
            # shards its peers created while it was down (ROADMAP.md
            # Queue 3, F1). Remote legs name their shards: no wait.
            merged.wait(self.PEER_MERGE_WAIT_S)
        opt = ExecOptions(remote=remote, column_attrs=column_attrs,
                          exclude_row_attrs=exclude_row_attrs,
                          exclude_columns=exclude_columns)
        epochs = None
        if remote and shards:
            # Read BEFORE executing: the reported vector is never fresher
            # than the data in the result (cache/remote.py).
            idx = self.holder.index(index)
            if idx is not None:
                epochs = idx.epoch.shard_vector(shards)
        results = self.executor.execute(index, query, shards=shards, opt=opt,
                                        cache=cache)
        if remote:
            from pilosa_tpu_torch.exec import fuse as _fuse
            from pilosa_tpu_torch.server import wire
            extra = ({"shardEpochs": {str(s): e for s, e in epochs.items()}}
                     if epochs else None)
            prof = _profile.current()
            if prof is not None:
                # The coordinator asked for a nested per-leg timeline: this
                # node's ledger rides home in the response header.
                prof.fused_steps = _fuse.fused_steps()
                extra = dict(extra or {})
                extra["profile"] = prof.finish()
            if accept_frames:
                return wire.encode_frames(
                    results, extra=extra, version=2 if accept_frames == 2 else 1)
            resp: dict[str, Any] = {"results": [wire.encode_result(r) for r in results]}
            if extra:
                resp.update(extra)
            return resp
        resp = {"results": [result_to_json(r) for r in results]}
        # After execution: Options(columnAttrs=true) sets the flag on opt.
        if opt.column_attrs:
            resp["columnAttrs"] = self._column_attr_sets(index, results)
        return resp

    def _column_attr_sets(self, index: str, results: list) -> list[dict]:
        """Attrs of every column of the Row results that has any
        (reference executor.go ColumnAttrSets assembly)."""
        idx = self.holder.index_or_raise(index)
        cols: set[int] = set()
        for r in results:
            if isinstance(r, Row):
                cols.update(int(c) for c in r.columns())
        out = []
        for c in sorted(cols):
            attrs = idx.column_attr_store.attrs(c)
            if attrs:
                out.append({"id": c, "attrs": attrs})
        return out

    # -- schema CRUD (api.go:162-467) --------------------------------------

    def create_index(self, name: str, options: dict | None = None):
        self._validate("create-index")
        idx = self.holder.create_index(name, IndexOptions.from_json(options or {}))
        self._save_schema()
        self._broadcast({"type": "create-index", "index": name,
                         "options": options or {}})
        return idx

    def _save_schema(self) -> None:
        if self.store is not None:
            self.store.save_schema()

    def delete_index(self, name: str) -> None:
        self._validate("delete-index")
        self.holder.delete_index(name)
        if self.store is not None:
            # Unlink the on-disk tree too: recreating the name must not
            # resurrect deleted data on the next restart.
            self.store.delete_subtree_files(name)
        self._broadcast({"type": "delete-index", "index": name})

    def create_field(self, index: str, field: str,
                     options: dict | None = None):
        self._validate("create-field")
        idx = self.holder.index_or_raise(index)
        f = idx.create_field(field, FieldOptions.from_json(options or {}))
        self._save_schema()
        self._broadcast({"type": "create-field", "index": index,
                         "field": field, "options": options or {}})
        return f

    def delete_field(self, index: str, field: str) -> None:
        self._validate("delete-field")
        self.holder.index_or_raise(index).delete_field(field)
        if self.store is not None:
            self.store.delete_subtree_files(index, field)
        self._broadcast({"type": "delete-field", "index": index,
                         "field": field})

    def views(self, index: str, field: str) -> list[str]:
        """Reference API.Views (api.go:760)."""
        return self._field_or_raise(index, field).view_names()

    def delete_view(self, index: str, field: str, view: str) -> None:
        """Reference API.DeleteView (api.go:779): dropped here, then
        broadcast so every node holding its shards follows."""
        self._validate("delete-view")
        self._field_or_raise(index, field).delete_view(view)
        if self.store is not None:
            self.store.delete_subtree_files(index, field, view)
        self._broadcast({"type": "delete-view", "index": index,
                         "field": field, "view": view})

    def _field_or_raise(self, index: str, field: str):
        f = self.holder.index_or_raise(index).field(field)
        if f is None:
            raise FieldNotFoundError(field)
        return f

    def schema(self) -> list[dict]:
        return self.holder.schema()

    def apply_schema(self, schema: list[dict], remote: bool = False) -> None:
        """Reference API.ApplySchema (api.go:738): applied here first, then
        (``remote=False``) fanned out to every live peer, best effort: an
        unreachable peer must not leave the origin node empty."""
        self._validate("apply-schema")
        self.holder.apply_schema(schema)
        self._save_schema()
        if not remote and self.cluster is not None:
            for node in self.cluster.nodes:
                if node.id == self.cluster.local_id or node.state == "DOWN":
                    continue
                try:
                    self.cluster.client.post_schema(node, schema)
                except (ConnectionError, RuntimeError, LookupError):
                    pass

    def index_info(self, index: str) -> dict:
        return self.holder.index_or_raise(index).info()

    # -- imports (api.go:920-1127) -----------------------------------------

    def import_bits(self, index: str, field: str, row_ids: Iterable[int],
                    column_ids: Iterable[int],
                    timestamps: Iterable[int | None] | None = None,
                    row_keys: Iterable[str] | None = None,
                    column_keys: Iterable[str] | None = None,
                    clear: bool = False) -> None:
        """Batch bit import (reference api.Import, the local branch); with
        ``timestamps`` (epoch seconds or time strings, 0 or empty for
        none) each stamped bit also lands in its time views. On a cluster
        each shard's batch goes to every owner of the shard."""
        self._validate("import")
        idx = self.holder.index_or_raise(index)
        f = idx.field(field)
        if f is None:
            raise FieldNotFoundError()
        if row_keys is not None:
            row_ids = self._xlate_keys(idx, f, row_keys)
        if column_keys is not None:
            column_ids = self._xlate_keys(idx, None, column_keys)
        ts = parse_stamps(timestamps) if timestamps is not None else None
        column_ids = list(column_ids)
        if self.cluster is not None:
            self._route_import(index, field, f, list(row_ids), column_ids, ts,
                               clear, values=None)
        else:
            f.import_bits(list(row_ids), column_ids, ts, clear=clear)
        idx.add_existence(column_ids)

    def import_values(self, index: str, field: str,
                      column_ids: Iterable[int], values: Iterable[int],
                      column_keys: Iterable[str] | None = None,
                      clear: bool = False) -> None:
        """Batch int-field value import (reference api.ImportValue, the
        local branch; on a cluster, routed as import_bits is)."""
        self._validate("import-value")
        idx = self.holder.index_or_raise(index)
        f = idx.field(field)
        if f is None:
            raise FieldNotFoundError()
        if column_keys is not None:
            column_ids = self._xlate_keys(idx, None, column_keys)
        column_ids = list(column_ids)
        if self.cluster is not None:
            self._route_import(index, field, f, None, column_ids, None, clear,
                               values=list(values))
        else:
            f.import_values(column_ids, list(values), clear=clear)
        idx.add_existence(column_ids)

    def _route_import(self, index, field, f, row_ids, column_ids, ts, clear,
                      values) -> None:
        """Group by shard and send each batch to every owning node
        (api.go:967-1030; the JAX API's ``_route_import``): a stable
        argsort and a boundary scan split the batch, local batches apply
        here, and each peer's batches go as one PTS1 import stream (one
        binary ``/internal/import`` request for a single batch), carrying
        epoch-second timestamps."""
        n = len(column_ids)
        if n == 0:
            return
        cols_arr = np.asarray(column_ids, dtype=np.uint64)
        shards = cols_arr // np.uint64(SHARD_WIDTH)
        order = np.argsort(shards, kind="stable")
        sorted_shards = shards[order]
        bounds = np.flatnonzero(np.diff(sorted_shards)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [n]))
        rows_arr = np.asarray(row_ids, dtype=np.uint64) if row_ids is not None else None
        vals_arr = np.asarray(values, dtype=np.int64) if values is not None else None
        epoch = None
        if ts is not None:
            # datetime64 stamps -> epoch seconds (None for NaT) on the wire.
            secs = ts.astype("datetime64[s]").astype(np.int64).tolist()
            epoch = [None if nat else s for s, nat in zip(secs, np.isnat(ts).tolist())]
        for _attempt in range(3):
            if self._route_import_pass(index, field, f, ts, clear, values, order,
                                       sorted_shards, starts, ends, cols_arr,
                                       rows_arr, vals_arr, epoch):
                return
        # The topology kept moving across every pass; the last idempotent
        # pass still applied under some complete placement and marked
        # dirty shards for the scrubber.

    def _route_import_pass(self, index, field, f, ts, clear, values, order,
                           sorted_shards, starts, ends, cols_arr, rows_arr,
                           vals_arr, epoch) -> bool:
        """One routing pass (the JAX API's ``_route_import_pass``); True when
        the topology held still through it. A resize commit landing
        mid-pass could strand a shard batch on the old owners with no dual
        leg (the commit clears the migration table), so the caller applies
        again -- imports are idempotent -- until owners and table were
        stable. Each peer's batches go out as one PTS1 import stream."""
        v0 = self.cluster.topology_version
        mig = self.cluster.migration
        remote: dict[str, tuple[Any, list[dict]]] = {}
        dual: dict[str, tuple[Any, list[dict]]] = {}

        def apply_local(sel, cols, rows_b, vals_b):
            if values is None:
                f.import_bits(rows_b, cols, ts[sel] if ts is not None else None,
                              clear=clear)
            else:
                f.import_values(cols, vals_b, clear=clear)

        for s, e in zip(starts.tolist(), ends.tolist()):
            shard = int(sorted_shards[s])
            sel = order[s:e]
            cols = cols_arr[sel]
            rows_b = rows_arr[sel] if rows_arr is not None else None
            vals_b = vals_arr[sel] if vals_arr is not None else None
            req = {"kind": "field", "index": index, "field": field, "shard": shard,
                   "rowIDs": rows_b, "columnIDs": cols, "values": vals_b,
                   "clear": clear}
            if epoch is not None:
                req["timestamps"] = [epoch[i] for i in sel.tolist()]
            for node in self.cluster.shard_nodes(index, shard):
                if node.id == self.cluster.local_id:
                    apply_local(sel, cols, rows_b, vals_b)
                else:
                    remote.setdefault(node.id, (node, []))[1].append(req)
            if mig is not None:
                # Serve-through resize: mirror each shard batch to the
                # shard's future owners, after its old owners above (the
                # catch-up's epoch guard relies on that order).
                for node in mig.dual_targets(self.cluster, index, shard):
                    if node.id != self.cluster.local_id:
                        dual.setdefault(node.id, (node, []))[1].append(req)
                        continue
                    try:  # a shrink: this node gains the shard
                        apply_local(sel, cols, rows_b, vals_b)
                        self.cluster.stats.count("cluster.resize.dualWrites")
                    except (RuntimeError, LookupError, ValueError) as ex:
                        self.cluster.dirty_shards.mark(index, shard)
                        self.cluster.stats.count("cluster.resize.dualWriteFailed")
                        self.cluster._report_dual_write_failure(mig, node.id, ex)

        def ship(node, reqs):
            if len(reqs) > 1:
                self.cluster.client.send_import_stream(node, reqs)
                return
            for r in reqs:
                self.cluster.client.send_import(
                    node, index, field, r["shard"], rows=r["rowIDs"],
                    cols=r["columnIDs"], values=r["values"],
                    timestamps=r.get("timestamps"), clear=clear)

        for node, reqs in remote.values():
            ship(node, reqs)
        for node, reqs in dual.values():
            # A dual leg never fails the user's import: the old ring's
            # writes above landed, so a target's failure is the target's
            # problem -- dirty-mark for the scrubber and tell the
            # coordinator to fail it out of the job.
            try:
                ship(node, reqs)
                self.cluster.stats.count("cluster.resize.dualWrites", len(reqs))
            except (ConnectionError, RuntimeError, LookupError) as ex:
                for r in reqs:
                    self.cluster.dirty_shards.mark(index, r["shard"])
                self.cluster.stats.count("cluster.resize.dualWriteFailed")
                self.cluster._report_dual_write_failure(mig, node.id, ex)
        return (self.cluster.topology_version == v0
                and self.cluster.migration is mig)

    def import_roaring(self, index: str, field: str, shard: int,
                       data: bytes, clear: bool = False) -> None:
        """Reference API.ImportRoaring (api.go:368): one shard's bits as a
        serialized roaring bitmap into the standard view; on a cluster into
        every owner's."""
        self._validate("import-roaring")
        f = self.holder.index_or_raise(index).field(field)
        if f is None:
            raise FieldNotFoundError()
        if self.cluster is None:
            f.import_roaring(shard, data, clear=clear)
            return
        for _attempt in range(3):
            # The routed import's mid-commit guard: snapshot the migration
            # table before resolving owners, and apply again (the roaring
            # import is idempotent) if a resize moved the topology under
            # this fan-out.
            v0 = self.cluster.topology_version
            mig = self.cluster.migration
            for node in self.cluster.shard_nodes(index, shard):
                if node.id == self.cluster.local_id:
                    f.import_roaring(shard, data, clear=clear)
                else:
                    self.cluster.client.send_import_roaring(node, index, field,
                                                            shard, data, clear)
            for node in (mig.dual_targets(self.cluster, index, shard)
                         if mig is not None else ()):
                try:
                    if node.id == self.cluster.local_id:
                        f.import_roaring(shard, data, clear=clear)
                    else:
                        self.cluster.client.send_import_roaring(
                            node, index, field, shard, data, clear)
                    self.cluster.stats.count("cluster.resize.dualWrites")
                except (ConnectionError, RuntimeError, LookupError, ValueError) as ex:
                    self.cluster.dirty_shards.mark(index, shard)
                    self.cluster.stats.count("cluster.resize.dualWriteFailed")
                    self.cluster._report_dual_write_failure(mig, node.id, ex)
            if self.cluster.topology_version == v0 and self.cluster.migration is mig:
                return

    # -- export (api.go:500) -----------------------------------------------

    def _xlate_keys(self, idx, f, keys: Iterable[str]) -> list[int]:
        """Ids of ``keys`` in the field's (or, for None, the index's)
        translate store, allocated where new: one lock, one epoch bump for
        the batch. On a cluster the translator sends them to the
        coordinator, which allocates for every node."""
        keys = list(keys)
        if self.translator is not None:
            return self.translator(idx.name, f.name if f is not None else None, keys)
        store = (f if f is not None else idx).translate_store
        return store.translate_keys(keys)

    def export_csv(self, index: str, field: str, shard: int) -> str:
        """CSV of row,col for one shard, keys in place of the ids of a keyed
        field or index (reference exportShard). Reverse translation is one
        snapshot pass per store over the shard's distinct ids."""
        self._validate("export-csv")
        idx = self.holder.index_or_raise(index)
        f = idx.field(field)
        if f is None:
            raise FieldNotFoundError()
        frag = self.holder.fragment(index, field, VIEW_STANDARD, shard)
        if frag is None:
            raise FragmentNotFoundError()
        rows = frag.rows_snapshot()
        base = shard * SHARD_WIDTH
        row_names: dict[int, str] = {}
        if f.keys:
            rids = [rid for rid, _ in rows]
            row_names = {rid: (name if name is not None else str(rid))
                         for rid, name in zip(rids, f.translate_store.translate_ids(rids))}
        col_names: dict[int, str] = {}
        if idx.options.keys:
            cols = sorted({int(pos) + base for _, positions in rows for pos in positions})
            col_names = {col: (name if name is not None else str(col))
                         for col, name in zip(cols, idx.translate_store.translate_ids(cols))}
        buf = io.StringIO()
        for rid, positions in rows:
            rk = row_names.get(rid) if f.keys else str(rid)
            for pos in positions:
                col = int(pos) + base
                ck = col_names.get(col) if idx.options.keys else str(col)
                buf.write(f"{rk},{ck}\n")
        return buf.getvalue()

    # -- status (api.go:726-1260) ------------------------------------------

    def status(self) -> dict:
        if self.cluster is None:
            return {"state": STATE_NORMAL, "nodes": [], "localID": "standalone"}
        return {"state": self.cluster.state,
                "nodes": [n.to_json() for n in self.cluster.nodes],
                "localID": self.cluster.local_id}

    def hosts(self) -> dict:
        if self.cluster is None:
            return {"version": 0, "nodes": [], "state": STATE_NORMAL}
        return {"version": self.cluster.topology_version,
                "nodes": [n.to_json() for n in self.cluster.nodes],
                "state": self.cluster.state}

    def info(self) -> dict:
        return {"shardWidth": SHARD_WIDTH,
                "version": pilosa_tpu_torch.__version__}

    def fragment_nodes(self, index: str, shard: int) -> list[dict]:
        """Nodes owning (index, shard) under the current ring; on a
        standalone node, this one (reference handleGetFragmentNodes,
        http/handler.go:1290)."""
        if self.cluster is not None:
            return [n.to_json() for n in self.cluster.shard_nodes(index, shard)]
        if self.local_node is not None:
            return [self.local_node.to_json()]
        return [{"id": "standalone", "uri": {}, "isCoordinator": True}]

    def delete_available_shard(self, index: str, field: str, shard: int) -> None:
        """Reference api.DeleteAvailableShard (DELETE
        /internal/index/{i}/field/{f}/remote-available-shards/{s})."""
        self._validate("delete-available-shard")
        self._field_or_raise(index, field).remove_remote_available_shard(shard)

    def max_shards(self) -> dict:
        return {name: max(self.holder.index(name).available_shards())
                for name in self.holder.index_names()}

    def translate_keys(self, index: str, field: str | None,
                       keys: list[str]) -> list[int]:
        """The public and /internal/translate/keys surface: the keys' ids in
        the field's (or the index's) store, allocated where new (a
        standalone node is its own id authority)."""
        idx = self.holder.index_or_raise(index)
        f = None
        if field:
            f = idx.field(field)
            if f is None:
                raise FieldNotFoundError()
        return self._xlate_keys(idx, f, keys)

    def translate_entries(self, index: str, field: str | None,
                          after_id: int) -> list[tuple[int, str]]:
        """/internal/translate/entries: the store's (id, key) entries with
        ids past ``after_id``, id-ascending (reference translate.go:93
        MultiTranslateEntryReader)."""
        idx = self.holder.index_or_raise(index)
        if field:
            f = idx.field(field)
            if f is None:
                raise FieldNotFoundError()
            return f.translate_store.entries_since(after_id)
        return idx.translate_store.entries_since(after_id)

    def fragment_blocks(self, index, field, view, shard) -> dict[int, bytes]:
        """One fragment's anti-entropy block checksums."""
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            raise FragmentNotFoundError()
        return frag.checksum_blocks()

    def fragment_block_data(self, index, field, view, shard, block):
        """(row ids, column ids) of one checksum block of a fragment."""
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            raise FragmentNotFoundError()
        return frag.block_data(block)

    def _attr_store(self, index: str, field: str | None):
        """Column attrs (field=None) or a field's row attrs (reference
        api.go:817-918 attr-diff surface)."""
        idx = self.holder.index_or_raise(index)
        if field is None:
            return idx.column_attr_store
        f = idx.field(field)
        if f is None:
            raise FieldNotFoundError()
        return f.row_attr_store

    def attr_blocks(self, index: str, field: str | None) -> list:
        return self._attr_store(index, field).blocks()

    def attr_block_data(self, index: str, field: str | None,
                        block: int) -> dict:
        return self._attr_store(index, field).block_data(block)

    def recalculate_caches(self) -> None:
        """Row counts are maintained exactly; nothing to rebuild. Kept for
        route parity (api.go RecalculateCaches)."""
        self._validate("recalculate-caches")

    def _broadcast(self, message: dict) -> None:
        """A schema change to every live peer, best effort (reference
        broadcast.go:55-72)."""
        if self.cluster is None:
            return
        for node in self.cluster.nodes:
            if node.id == self.cluster.local_id or node.state == "DOWN":
                continue
            try:
                self.cluster.client.send_message(node, message)
            except (ConnectionError, RuntimeError):
                pass
