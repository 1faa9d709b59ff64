"""API — the operation surface of a standalone node.

The port's counterpart of pilosa_tpu/server/api.py with ``cluster=None``
only. Reference: api.go (API struct :42, Query :135, index/field CRUD
:162-467, Import/ImportValue :920-1127, ExportCSV :500, schema :726-758,
Status :1129-1260). The HTTP layer is a thin router over these methods.

A standalone node is always in the NORMAL state, so no method is gated
on the cluster's state. With a data dir, ``store`` is the node's
``storage.DiskStore``: creating an index or field writes ``schema.json``
at once, so the WAL records of a node killed before its first flush are
found again at boot (the JAX node writes the schema only when it flushes
or deletes: ROADMAP.md Queue 3); deleting an index, field or view
unlinks its files too. Imports by row and column keys allocate their ids
in the index's and field's translate stores, one batch each, and
``translate_keys``/``translate_entries`` serve the key routes. Remote
(cluster-leg) queries raise ``NotPortedError`` naming the ROADMAP.md slice
that brings them; fragment block sync has no method yet (its routes
answer 501).
"""

from __future__ import annotations

import io
from typing import Iterable

import pilosa_tpu_torch
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core.field import FieldOptions, parse_stamps
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.errors import (
    SLICE_CLUSTER,
    FieldNotFoundError,
    FragmentNotFoundError,
    NotPortedError,
)
from pilosa_tpu_torch.exec.executor import ExecOptions, Executor
from pilosa_tpu_torch.exec.result import result_to_json

#: the cluster state a standalone node always reports (reference
#: ClusterStateNormal, cluster.go).
STATE_NORMAL = "NORMAL"


class API:
    """Reference API (api.go:42), standalone."""

    def __init__(self, holder: Holder, executor: Executor):
        self.holder = holder
        self.executor = executor
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

    # -- query (api.go:135) ------------------------------------------------

    def query(self, index: str, query: str,
              shards: list[int] | None = None, column_attrs: bool = False,
              exclude_row_attrs: bool = False, exclude_columns: bool = False,
              remote: bool = False, cache: bool = True) -> dict:
        """Execute PQL; returns the QueryResponse JSON dict
        ({"results": [...]}, handler.go:60-75)."""
        if remote:
            raise NotPortedError("a remote query leg", SLICE_CLUSTER)
        opt = ExecOptions(column_attrs=column_attrs,
                          exclude_row_attrs=exclude_row_attrs,
                          exclude_columns=exclude_columns)
        results = self.executor.execute(index, query, shards=shards, opt=opt,
                                        cache=cache)
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
        idx = self.holder.create_index(name, IndexOptions.from_json(options or {}))
        self._save_schema()
        return idx

    def _save_schema(self) -> None:
        if self.store is not None:
            self.store.save_schema()

    def delete_index(self, name: str) -> None:
        self.holder.delete_index(name)
        if self.store is not None:
            # Unlink the on-disk tree too: recreating the name must not
            # resurrect deleted data on the next restart.
            self.store.delete_subtree_files(name)

    def create_field(self, index: str, field: str,
                     options: dict | None = None):
        idx = self.holder.index_or_raise(index)
        f = idx.create_field(field, FieldOptions.from_json(options or {}))
        self._save_schema()
        return f

    def delete_field(self, index: str, field: str) -> None:
        self.holder.index_or_raise(index).delete_field(field)
        if self.store is not None:
            self.store.delete_subtree_files(index, field)

    def views(self, index: str, field: str) -> list[str]:
        """Reference API.Views (api.go:760)."""
        return self._field_or_raise(index, field).view_names()

    def delete_view(self, index: str, field: str, view: str) -> None:
        """Reference API.DeleteView (api.go:779)."""
        self._field_or_raise(index, field).delete_view(view)
        if self.store is not None:
            self.store.delete_subtree_files(index, field, view)

    def _field_or_raise(self, index: str, field: str):
        f = self.holder.index_or_raise(index).field(field)
        if f is None:
            raise FieldNotFoundError(field)
        return f

    def schema(self) -> list[dict]:
        return self.holder.schema()

    def apply_schema(self, schema: list[dict]) -> None:
        """Reference API.ApplySchema (api.go:738); standalone there are no
        peers to fan the schema out to."""
        self.holder.apply_schema(schema)
        self._save_schema()

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
        none) each stamped bit also lands in its time views."""
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
        f.import_bits(list(row_ids), column_ids, ts, clear=clear)
        idx.add_existence(column_ids)

    def import_values(self, index: str, field: str,
                      column_ids: Iterable[int], values: Iterable[int],
                      column_keys: Iterable[str] | None = None,
                      clear: bool = False) -> None:
        """Batch int-field value import (reference api.ImportValue, the
        local branch)."""
        idx = self.holder.index_or_raise(index)
        f = idx.field(field)
        if f is None:
            raise FieldNotFoundError()
        if column_keys is not None:
            column_ids = self._xlate_keys(idx, None, column_keys)
        column_ids = list(column_ids)
        f.import_values(column_ids, list(values), clear=clear)
        idx.add_existence(column_ids)

    def import_roaring(self, index: str, field: str, shard: int,
                       data: bytes, clear: bool = False) -> None:
        """Reference API.ImportRoaring (api.go:368): one shard's bits as a
        serialized roaring bitmap into the standard view."""
        f = self.holder.index_or_raise(index).field(field)
        if f is None:
            raise FieldNotFoundError()
        f.import_roaring(shard, data, clear=clear)

    # -- export (api.go:500) -----------------------------------------------

    def _xlate_keys(self, idx, f, keys: Iterable[str]) -> list[int]:
        """Ids of ``keys`` in the field's (or, for None, the index's)
        translate store, allocated where new: one lock, one epoch bump for
        the batch."""
        store = (f if f is not None else idx).translate_store
        return store.translate_keys(list(keys))

    def export_csv(self, index: str, field: str, shard: int) -> str:
        """CSV of row,col for one shard, keys in place of the ids of a keyed
        field or index (reference exportShard). Reverse translation is one
        snapshot pass per store over the shard's distinct ids."""
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
        return {"state": STATE_NORMAL, "nodes": [], "localID": "standalone"}

    def hosts(self) -> dict:
        return {"version": 0, "nodes": [], "state": STATE_NORMAL}

    def info(self) -> dict:
        return {"shardWidth": SHARD_WIDTH,
                "version": pilosa_tpu_torch.__version__}

    def fragment_nodes(self, index: str, shard: int) -> list[dict]:
        """Nodes owning (index, shard): on a standalone node, this one
        (reference handleGetFragmentNodes, http/handler.go:1290)."""
        if self.local_node is not None:
            return [self.local_node.to_json()]
        return [{"id": "standalone", "uri": {}, "isCoordinator": True}]

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
