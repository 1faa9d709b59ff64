"""HTTP layer: REST router over the API facade of a standalone node.

The port's counterpart of pilosa_tpu/server/httpd.py. Reference:
http/handler.go (newRouter :274-318). Implemented on the stdlib
ThreadingHTTPServer, one thread per connection. Every route of the JAX
node's table is mounted in the same order and matched by the same
pattern; the routes a standalone node does not serve (cluster RPC)
answer 501 with a body that names the ROADMAP.md slice that brings them.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.cache.tenant import reset_current_tenant, set_current_tenant
from pilosa_tpu_torch.errors import (
    SLICE_CLUSTER,
    ApiMethodNotAllowedError,
    FieldExistsError,
    FieldNotFoundError,
    FragmentNotFoundError,
    IndexExistsError,
    IndexNotFoundError,
    NotPortedError,
    PilosaError,
    QueryError,
)
from pilosa_tpu_torch.exec import fuse as _fuse
from pilosa_tpu_torch.obs import profile as _profile
from pilosa_tpu_torch.obs import tracing as _tr
from pilosa_tpu_torch.pql import ParseError
from pilosa_tpu_torch.qos import (
    CLASS_INTERNAL,
    DeadlineExceededError,
    QueryShedError,
    QuotaExceededError,
    normalize_class,
)
from pilosa_tpu_torch.qos import deadline as qos_deadline
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.storage.quarantine import ShardCorruptError

_CONFLICTS = (IndexExistsError, FieldExistsError)
_NOT_FOUND = (IndexNotFoundError, FieldNotFoundError, FragmentNotFoundError)


class _Server(ThreadingHTTPServer):
    """TLS wraps PER CONNECTION with a deferred handshake: wrapping the
    listening socket would run every handshake inside the single accept
    loop, letting one silent client block the whole server."""

    ssl_ctx = None

    def get_request(self):
        sock, addr = self.socket.accept()
        if self.ssl_ctx is not None:
            sock = self.ssl_ctx.wrap_socket(sock, server_side=True,
                                            do_handshake_on_connect=False)
        return sock, addr


class HTTPServer:
    """One node's HTTP front end (reference http/handler.go:46).

    ``tls_cert``/``tls_key`` wrap the listener in TLS (the reference's
    server/tlsconfig.go; ``https://`` scheme in ``.address``)."""

    def __init__(self, api: API, host: str = "127.0.0.1", port: int = 10101,
                 tls_cert: str | None = None, tls_key: str | None = None):
        self.api = api
        self.host = host
        if bool(tls_cert) != bool(tls_key):
            # A half-specified TLS config must never silently serve
            # plaintext while the operator believes TLS is on.
            raise ValueError("tls_cert and tls_key must be set together")
        self.tls = bool(tls_cert)
        # Load the cert BEFORE binding: a bad path must not leak a bound
        # listening socket.
        ctx = None
        if tls_cert:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
        self._httpd = _Server((host, port), _make_handler(api))
        self._httpd.ssl_ctx = ctx
        self.port = self._httpd.server_address[1]  # resolved if port=0
        self._thread: threading.Thread | None = None
        self._serving = False

    def serve_background(self) -> None:
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http-serve", daemon=True)
        self._thread.start()

    def close(self) -> None:
        # shutdown() blocks forever if serve_forever never ran.
        if self._serving:
            self._httpd.shutdown()
            self._thread.join()
        self._httpd.server_close()

    @property
    def address(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.host}:{self.port}"


def _make_handler(api: API):
    routes = _build_routes(api)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Nagle + delayed-ACK costs ~40ms per small response (status
        # line, headers, and body are separate writes).
        disable_nagle_algorithm = True
        # Bound how long a silent/stalled connection (incl. a deferred
        # TLS handshake) can pin a handler thread.
        timeout = 120

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _dispatch(self, method: str):
            parsed = urlparse(self.path)
            params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            params["_qos_class"] = self.headers.get("X-Qos-Class", "")
            params["_api_key"] = self.headers.get("X-API-Key", "")
            if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
                # Only the JAX node's import stream sends a chunked body
                # (501 here): leave it unread and drop the connection.
                self.close_connection = True
                body = b""
            else:
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
            for pattern, methods in routes:
                m = pattern.match(parsed.path)
                if not m:
                    continue
                fn = methods.get(method)
                if fn is None:
                    continue
                headers = None
                # Join a propagated trace and deadline.
                tid = _tr.extract_http_headers(self.headers)
                token = _tr.set_current_trace(tid) if tid else None
                dl = qos_deadline.extract_http_headers(self.headers)
                dtoken = (qos_deadline.set_current_deadline(dl)
                          if dl is not None else None)
                try:
                    out = fn(m.groupdict(), params, body)
                    if len(out) == 3:  # optional extra response headers
                        status, payload, headers = out
                    else:
                        status, payload = out
                except QueryShedError as e:
                    # Load shed: tell the client when to come back.
                    status, payload = 503, {"error": str(e)}
                    headers = {"Retry-After": str(int(e.retry_after))}
                except QuotaExceededError as e:
                    # 429, NOT 503: the tenant is over its own budget.
                    status, payload = 429, {"error": str(e)}
                    headers = {"Retry-After":
                               str(max(1, int(e.retry_after + 0.5)))}
                except DeadlineExceededError as e:
                    status, payload = 504, {"error": str(e)}
                except _CONFLICTS as e:
                    status, payload = 409, {"error": str(e)}
                except _NOT_FOUND as e:
                    status, payload = 404, {"error": str(e)}
                except ApiMethodNotAllowedError as e:
                    status, payload = 405, {"error": str(e)}
                except ShardCorruptError as e:
                    # 503, NOT 400 (before the PilosaError catch-all): the
                    # data exists but this node's copy is quarantined.
                    status, payload = 503, {"error": str(e)}
                # The JAX ladder's 503 clauses for ClusterFencedError and
                # ShardUnavailableError come with the cluster slice.
                except NotPortedError as e:
                    # Before the PilosaError catch-all: a feature of a
                    # later slice is not a bad request.
                    status, payload = 501, {"error": str(e)}
                except (QueryError, ParseError, ValueError, PilosaError) as e:
                    status, payload = 400, {"error": str(e)}
                except Exception as e:  # pragma: no cover
                    status, payload = 500, {"error": f"internal: {e}"}
                finally:
                    if dtoken is not None:
                        qos_deadline.reset_current_deadline(dtoken)
                    if token is not None:
                        _tr.reset_current_trace(token)
                return self._reply(status, payload, headers)
            return self._reply(404, {"error": "not found"})

        def _reply(self, status: int, payload, headers=None):
            if isinstance(payload, (dict, list)):
                data = (json.dumps(payload) + "\n").encode()
                ctype = "application/json"
            elif isinstance(payload, bytes):
                data = payload
                ctype = "application/octet-stream"
            else:
                data = str(payload).encode()
                ctype = "text/plain"
            if headers and "Content-Type" in headers:
                headers = dict(headers)
                ctype = headers.pop("Content-Type")
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_DELETE(self):
            self._dispatch("DELETE")

    return Handler


def _not_ported(what: str, slice_name: str):
    """A route of a later slice: 501 naming the slice."""

    def handler(pv, params, body):
        raise NotPortedError(what, slice_name)

    return handler


def _build_routes(api: API):
    """[(compiled_pattern, {method: fn(path_vars, params, body)})] in the
    JAX node's route order (pilosa_tpu/server/httpd.py:1306-1376)."""

    def jbody(body: bytes) -> dict:
        if not body:
            return {}
        return json.loads(body)

    def home(pv, params, body):
        return 200, "pilosa-tpu-torch: a GPU-native bitmap index\n"

    def get_indexes(pv, params, body):
        return 200, {"indexes": api.schema()}

    def post_index(pv, params, body):
        api.create_index(pv["index"], jbody(body).get("options", {}))
        return 200, {}

    def get_index(pv, params, body):
        return 200, api.index_info(pv["index"])

    def delete_index(pv, params, body):
        api.delete_index(pv["index"])
        return 200, {}

    def post_field(pv, params, body):
        api.create_field(pv["index"], pv["field"],
                         jbody(body).get("options", {}))
        return 200, {}

    def delete_field(pv, params, body):
        api.delete_field(pv["index"], pv["field"])
        return 200, {}

    def post_import(pv, params, body):
        req = jbody(body)
        clear = params.get("clear") in ("1", "true")
        # A typo'd payload (wrong key names) must 400, not silently
        # import nothing.
        known = {"values", "columnIDs", "columnKeys", "rowIDs", "rowKeys",
                 "timestamps"}
        if not (known & req.keys()):
            raise QueryError(
                "import payload needs rowIDs/columnIDs (or values)")
        if "values" in req:
            api.import_values(pv["index"], pv["field"],
                              req.get("columnIDs") or [], req["values"],
                              column_keys=req.get("columnKeys"), clear=clear)
        else:
            api.import_bits(pv["index"], pv["field"],
                            req.get("rowIDs") or [],
                            req.get("columnIDs") or [],
                            timestamps=req.get("timestamps"),
                            row_keys=req.get("rowKeys"),
                            column_keys=req.get("columnKeys"),
                            clear=clear)
        return 200, {}

    def post_query(pv, params, body):
        shards = None
        if params.get("shards"):
            shards = [int(s) for s in params["shards"].split(",")]
        remote = params.get("remote") == "true"
        # QoS front: classify, apply the node default deadline when the
        # client sent none, gate on admission, and feed the slow log.
        # Shed/deadline errors propagate to _dispatch's 503/504 mapping.
        qos_ctl = api.qos
        cls = normalize_class(params.get("qosClass")
                              or params.get("_qos_class"), remote=remote)
        dtoken = None
        if (qos_ctl is not None and qos_ctl.default_deadline > 0
                and qos_deadline.current_deadline() is None):
            dtoken = qos_deadline.set_current_deadline(
                qos_deadline.Deadline(timeout=qos_ctl.default_deadline))
        want_inline_profile = params.get("profile") == "true"
        # Result-cache gate: noCache bypasses explicitly; INTERNAL-class
        # requests (maintenance sweeps) must not churn interactive
        # tenants' partitions; an explicitly profiled query is exempt too,
        # since a hit would profile the lookup, not the cost asked for.
        use_cache = (params.get("noCache") != "true"
                     and not want_inline_profile and cls != CLASS_INTERNAL)
        # Tenant: the identity the quota table charges (X-API-Key,
        # falling back to the index name).
        ttoken = set_current_tenant(params.get("_api_key") or pv["index"])
        # Per-query cost profile: armed by ?profile=true (inline in the
        # response) or by the node's always-on slowest-N ring.
        ring = api.profile_ring
        want_profile = want_inline_profile or (
            ring is not None and api.profile_default)
        prof = None
        ptoken = trace_token = None
        prof_doc = None
        if want_profile:
            tid = _tr.current_trace_id()
            if not tid:
                tid = _tr.new_trace_id()
                trace_token = _tr.set_current_trace(tid)
            node_id = getattr(api.local_node, "id", "") or "standalone"
            prof = _profile.QueryProfile(
                tid, query=body.decode(errors="replace"),
                index=pv["index"], node=node_id, qos_class=cls,
                remote=remote)
            ptoken = _profile.activate(prof)
        status = "ok"
        t0 = time.perf_counter()
        try:
            try:
                # An already-expired deadline 504s before any work.
                qos_deadline.check_current()
                # Per-tenant quota BEFORE admission: an over-budget
                # tenant must not occupy a queue slot.
                if api.quotas is not None:
                    api.quotas.check(params.get("_api_key") or pv["index"])
                kwargs = dict(
                    shards=shards,
                    column_attrs=params.get("columnAttrs") == "true",
                    exclude_row_attrs=params.get("excludeRowAttrs") == "true",
                    exclude_columns=params.get("excludeColumns") == "true",
                    remote=remote, cache=use_cache)
                if qos_ctl is not None:
                    with qos_ctl.admit(cls):
                        resp = api.query(pv["index"], body.decode(), **kwargs)
                else:
                    resp = api.query(pv["index"], body.decode(), **kwargs)
            except _NOT_FOUND + (ApiMethodNotAllowedError, NotPortedError,
                                 ShardCorruptError):
                # Past the PilosaError catch below: the dispatch ladder
                # maps each to its own status (503 for a quarantined shard).
                status = "error"
                raise
            except (QueryShedError, DeadlineExceededError,
                    QuotaExceededError) as e:
                if isinstance(e, QueryShedError):
                    status = "shed"
                elif isinstance(e, QuotaExceededError):
                    status = "quota"
                else:
                    status = "deadline"
                raise
            except (QueryError, ParseError, PilosaError, ValueError) as e:
                status = "error"
                return 400, {"error": str(e)}
        finally:
            reset_current_tenant(ttoken)
            if dtoken is not None:
                qos_deadline.reset_current_deadline(dtoken)
            if prof is not None:
                _profile.deactivate(ptoken)
                if trace_token is not None:
                    _tr.reset_current_trace(trace_token)
                prof.status = status
                prof.fused_steps = _fuse.fused_steps()
                prof_doc = prof.finish()
                if ring is not None:
                    ring.record(prof_doc)
            if status not in ("shed", "quota"):
                # Per-QoS-class service latency (admission wait +
                # execution), exemplar'd with the active trace id.
                # Shed/quota rejections never executed.
                api.executor.stats.with_tags(f"class:{cls}").timing(
                    "qos.serviceSeconds", time.perf_counter() - t0)
            slow_log = getattr(qos_ctl, "slow_log", None)
            if slow_log is not None and status not in ("shed", "quota"):
                slow_log.observe(pv["index"], body.decode(errors="replace"),
                                 (time.perf_counter() - t0) * 1000.0,
                                 qos_class=cls, status=status,
                                 fused_steps=_fuse.fused_steps(),
                                 trace_id=(prof.trace_id
                                           if prof is not None else ""))
        if want_inline_profile and prof_doc is not None:
            resp["profile"] = prof_doc
        return 200, resp

    def post_import_roaring(pv, params, body):
        clear = params.get("clear") == "true"
        # remote=true marks a forwarded replica write: apply locally only.
        if params.get("remote") == "true":
            f = api.holder.field(pv["index"], pv["field"])
            if f is None:
                raise FieldNotFoundError()
            f.import_roaring(int(pv["shard"]), body, clear=clear)
        else:
            api.import_roaring(pv["index"], pv["field"], int(pv["shard"]),
                               body, clear=clear)
        return 200, {}

    def get_export(pv, params, body):
        return 200, api.export_csv(params["index"], params["field"],
                                   int(params["shard"]))

    def get_schema(pv, params, body):
        return 200, {"indexes": api.schema()}

    def post_schema(pv, params, body):
        api.apply_schema(jbody(body).get("indexes", []))
        return 200, {}

    def get_status(pv, params, body):
        return 200, api.status()

    def get_info(pv, params, body):
        return 200, api.info()

    def get_version(pv, params, body):
        return 200, {"version": api.info()["version"]}

    def get_metrics(pv, params, body):
        from pilosa_tpu_torch.obs import MemoryStats, prometheus_text
        stats = api.executor.stats
        if isinstance(stats, MemoryStats):
            return 200, prometheus_text(stats)
        return 200, "# no stats backend configured\n"

    def get_debug_vars(pv, params, body):
        """expvar analog (reference /debug/vars): raw counters/gauges."""
        from pilosa_tpu_torch.obs import MemoryStats
        stats = api.executor.stats
        if not isinstance(stats, MemoryStats):
            return 200, {}
        with stats._lock:
            return 200, {
                "counters": {f"{n}{list(t) or ''}": v
                             for (n, t), v in sorted(stats.counters.items())},
                "gauges": {f"{n}{list(t) or ''}": v
                           for (n, t), v in sorted(stats.gauges.items())},
            }

    def get_debug_device(pv, params, body):
        """Device telemetry in one view (reference httpd.py:862): the
        stack cache's residency and churn, the coalescer's batch-width
        histogram and queue depth, the batcher's wave widths and inline
        steals, and the prefetch pipeline."""
        planner = getattr(api.executor, "planner", None)
        if planner is None:
            return 200, {"enabled": False}
        out = planner.device_debug()
        out["enabled"] = True
        return 200, out

    def get_debug_translate(pv, params, body):
        """Key-translation telemetry (reference httpd.py:873): the device
        key-plane cache (builds, device batches, collision-bucket hits,
        stale serves, async rebuilds) and each non-empty store's size,
        watermark and version. A standalone node is its own coordinator."""
        planes = getattr(api.executor, "keyplanes", None)
        stores = {}
        for name in api.holder.index_names():
            idx = api.holder.index(name)
            if idx is None:
                continue
            targets = [("", idx.translate_store)]
            targets += [(fname, f.translate_store) for fname, f in sorted(idx.fields.items())]
            for fname, store in targets:
                if store.max_id() == 0:
                    continue
                stores[f"{name}/{fname}" if fname else name] = {
                    "maxId": store.max_id(),
                    "watermark": store.replication_watermark(),
                    "version": store.version,
                }
        return 200, {"coordinator": None,
                     "planes": planes.debug() if planes is not None else None,
                     "stores": stores}

    def post_translate_keys(pv, params, body):
        req = jbody(body)
        ids = api.translate_keys(req["index"], req.get("field"), req.get("keys", []))
        return 200, {"ids": ids}

    def get_translate_entries(pv, params, body):
        entries = api.translate_entries(params["index"], params.get("field"),
                                        int(params.get("after", 0)))
        return 200, {"entries": [[i, k] for i, k in entries]}

    def get_debug_slow_queries(pv, params, body):
        """The QoS slow-query ring plus an admission snapshot."""
        qos_ctl = api.qos
        if qos_ctl is None:
            return 200, {"queries": [], "admission": None}
        slow_log = qos_ctl.slow_log
        return 200, {
            "queries": slow_log.entries() if slow_log is not None else [],
            "thresholdMs": (slow_log.threshold_ms
                            if slow_log is not None else None),
            "admission": qos_ctl.snapshot(),
        }

    def get_debug_queries(pv, params, body):
        """Slowest-N retained query profiles, slowest first."""
        ring = api.profile_ring
        if ring is None:
            return 200, {"queries": [], "capacity": 0}
        return 200, {"queries": ring.snapshot(), "capacity": ring.capacity}

    def get_debug_query_profile(pv, params, body):
        """One retained profile by trace id. A standalone node has no
        peers to ask on a miss."""
        ring = api.profile_ring
        doc = ring.get(pv["trace"]) if ring is not None else None
        if doc is None:
            return 404, {"error": f"no retained profile for {pv['trace']}"}
        return 200, doc

    def get_debug_overload(pv, params, body):
        """Adaptive admission limit, per-tenant quota buckets and the
        result cache's occupancy; a standalone node has no breakers or
        hedges."""
        qos_ctl = api.qos
        rcache = api.executor.result_cache
        return 200, {
            "admission": qos_ctl.snapshot() if qos_ctl is not None else None,
            "adaptive": (qos_ctl.adaptive.snapshot()
                         if qos_ctl is not None
                         and qos_ctl.adaptive is not None else None),
            "quotas": (api.quotas.snapshot()
                       if api.quotas is not None else None),
            "breakers": None,
            "hedge": None,
            "cache": rcache.snapshot() if rcache is not None else None,
        }

    def get_debug_cache(pv, params, body):
        """Result-cache snapshot: byte/entry occupancy, hit and eviction
        counters, per-tenant partitions. A standalone node observes no
        remote query legs, so its table of remote shard epochs (the JAX
        node's RemoteEpochTable) is always empty."""
        rcache = api.executor.result_cache
        if rcache is None:
            return 200, {"enabled": False}
        snap = rcache.snapshot()
        snap["enabled"] = True
        snap["remoteEpochs"] = {"entries": 0}
        return 200, snap

    def get_attr_blocks(pv, params, body):
        blocks = api.attr_blocks(params["index"], params.get("field"))
        return 200, {"blocks": [{"id": b, "checksum": cs.hex()}
                                for b, cs in blocks]}

    def get_attr_block_data(pv, params, body):
        data = api.attr_block_data(params["index"], params.get("field"),
                                   int(params["block"]))
        return 200, {"attrs": {str(i): a for i, a in data.items()}}

    def get_debug_quarantine(pv, params, body):
        """Corruption quarantine view: which fragments failed integrity
        verification, their serving state, and the preserved evidence
        files (``*.quarantine``)."""
        q = api.store.quarantine if api.store is not None else None
        if q is None:
            return 200, {"entries": [], "count": 0}
        entries = q.entries()
        return 200, {"entries": entries, "count": len(entries)}

    def get_debug_heap(pv, params, body):
        """One-stop memory accounting: tracemalloc top sites, the native
        pool, the planner's device stack cache, per-index host-row bytes
        (reference /debug/pprof heap, http/handler.go:281)."""
        from pilosa_tpu_torch.obs.heap import heap_stats
        top_n = min(max(int(params.get("top", 25)), 1), 200)
        return 200, heap_stats(api.holder, planner=api.executor.planner,
                               top_n=top_n)

    def get_debug_threads(pv, params, body):
        """Thread stack dump (reference /debug/pprof goroutines)."""
        import sys
        import traceback
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for tid, frame in frames.items():
            out.append(f"--- {names.get(tid, '?')} ({tid}) ---\n"
                       + "".join(traceback.format_stack(frame)))
        return 200, "\n".join(out)

    def get_debug_profile(pv, params, body):
        """Whole-process sampling CPU profile for N seconds, as a
        pstats-loadable marshal blob (reference /debug/pprof/profile)."""
        from pilosa_tpu_torch.obs.profiler import sample_profile
        seconds = min(max(float(params.get("seconds", 2)), 0.1), 60.0)
        return 200, sample_profile(seconds), {
            "Content-Type": "application/octet-stream",
            "Content-Disposition": 'attachment; filename="profile.pstats"'}

    def post_recalculate(pv, params, body):
        api.recalculate_caches()
        return 200, {}

    def get_shards_max(pv, params, body):
        return 200, {"standard": api.max_shards()}

    def get_fragment_nodes(pv, params, body):
        index = params.get("index")
        shard = params.get("shard")
        if index is None or shard is None:
            return 400, {"error": "index and shard params required"}
        return 200, api.fragment_nodes(index, int(shard))

    # backup / restore (operator surface + the capture RPC; reference
    # httpd.py:1224-1290)
    def post_backup(pv, params, body):
        handler = getattr(api, "backup_handler", None)
        if handler is None:
            return 400, {"error": "backup not configured on this node "
                                  "(no data dir)"}
        req = jbody(body)
        if params.get("archive"):
            req.setdefault("archive", params["archive"])
        if params.get("parent"):
            req.setdefault("parent", params["parent"])
        return 200, handler(req)

    def get_backup_status(pv, params, body):
        handler = getattr(api, "backup_status_handler", None)
        if handler is None:
            return 200, {"state": "idle"}
        return 200, handler()

    def post_restore(pv, params, body):
        handler = getattr(api, "restore_handler", None)
        if handler is None:
            return 400, {"error": "restore not configured on this node "
                                  "(no data dir)"}
        req = jbody(body)
        if params.get("archive"):
            req.setdefault("archive", params["archive"])
        if params.get("id"):
            req.setdefault("id", params["id"])
        if params.get("force") in ("1", "true"):
            req.setdefault("force", True)
        return 200, handler(req)

    def get_restore_status(pv, params, body):
        handler = getattr(api, "restore_status_handler", None)
        if handler is None:
            return 200, {"state": "idle"}
        return 200, handler()

    def get_backup_keys(pv, params, body):
        """Fragment keys this node holds durable files for."""
        store = getattr(api, "store", None)
        if store is None:
            return 200, {"keys": []}
        return 200, {"keys": [list(k) for k in store.all_fragment_keys()]}

    def get_backup_fragment(pv, params, body):
        """One fragment's verified (snap, wal) pair, base64-wrapped in
        JSON. ShardCorruptError propagates to the dispatch ladder's 503."""
        store = getattr(api, "store", None)
        if store is None:
            raise FragmentNotFoundError()
        from pilosa_tpu_torch.backup.writer import capture_fragment
        key = (params["index"], params["field"], params["view"],
               int(params["shard"]))
        try:
            pair = capture_fragment(store, key)
        except LookupError:
            raise FragmentNotFoundError() from None
        import base64
        return 200, {
            "snap": (base64.b64encode(pair["snap"]).decode()
                     if pair["snap"] is not None else None),
            "wal": (base64.b64encode(pair["wal"]).decode()
                    if pair["wal"] is not None else None),
            "ops": pair["ops"],
        }

    def get_debug_backup(pv, params, body):
        """Unattended-backup health: the BackupScheduler's status doc, or
        {"enabled": false} when no scheduler runs on this node."""
        handler = getattr(api, "backup_debug_handler", None)
        if handler is None:
            return 200, {"enabled": False}
        return 200, handler()

    def get_views(pv, params, body):
        return 200, {"views": api.views(pv["index"], pv["field"])}

    def delete_view(pv, params, body):
        api.delete_view(pv["index"], pv["field"], pv["view"])
        return 200, {}

    cluster = SLICE_CLUSTER
    table = [
        (r"/", {"GET": home}),
        (r"/index", {"GET": get_indexes}),
        (r"/index/(?P<index>[^/]+)/query", {"POST": post_query}),
        (r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import",
         {"POST": post_import}),
        (r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import-roaring/"
         r"(?P<shard>[0-9]+)",
         {"POST": post_import_roaring}),
        (r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/views",
         {"GET": get_views}),
        (r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/view/"
         r"(?P<view>[^/]+)",
         {"DELETE": delete_view}),
        (r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)",
         {"POST": post_field, "DELETE": delete_field}),
        (r"/index/(?P<index>[^/]+)",
         {"GET": get_index, "POST": post_index, "DELETE": delete_index}),
        (r"/export", {"GET": get_export}),
        (r"/schema", {"GET": get_schema, "POST": post_schema}),
        (r"/status", {"GET": get_status}),
        (r"/info", {"GET": get_info}),
        (r"/version", {"GET": get_version}),
        (r"/metrics", {"GET": get_metrics}),
        (r"/debug/vars", {"GET": get_debug_vars}),
        (r"/debug/membership",
         {"GET": _not_ported("GET /debug/membership", cluster)}),
        (r"/debug/queries/(?P<trace>[^/]+)",
         {"GET": get_debug_query_profile}),
        (r"/debug/queries", {"GET": get_debug_queries}),
        (r"/debug/device", {"GET": get_debug_device}),
        (r"/debug/translate", {"GET": get_debug_translate}),
        (r"/debug/slow-queries", {"GET": get_debug_slow_queries}),
        (r"/debug/overload", {"GET": get_debug_overload}),
        (r"/debug/cache", {"GET": get_debug_cache}),
        (r"/debug/quarantine", {"GET": get_debug_quarantine}),
        (r"/debug/threads", {"GET": get_debug_threads}),
        (r"/debug/profile", {"GET": get_debug_profile}),
        (r"/debug/heap", {"GET": get_debug_heap}),
        (r"/recalculate-caches", {"POST": post_recalculate}),
        (r"/backup", {"POST": post_backup}),
        (r"/backup/status", {"GET": get_backup_status}),
        (r"/restore", {"POST": post_restore}),
        (r"/restore/status", {"GET": get_restore_status}),
        (r"/internal/backup/keys", {"GET": get_backup_keys}),
        (r"/internal/backup/fragment", {"GET": get_backup_fragment}),
        (r"/internal/shards/max", {"GET": get_shards_max}),
        (r"/internal/availability",
         {"GET": _not_ported("GET /internal/availability", cluster)}),
        (r"/internal/translate/keys", {"POST": post_translate_keys}),
        (r"/internal/translate/entries", {"GET": get_translate_entries}),
        (r"/internal/cluster/message",
         {"POST": _not_ported("POST /internal/cluster/message", cluster)}),
        (r"/internal/fragment/blocks",
         {"GET": _not_ported("GET /internal/fragment/blocks", cluster)}),
        (r"/internal/fragment/nodes", {"GET": get_fragment_nodes}),
        (r"/debug/resize",
         {"GET": _not_ported("GET /debug/resize", cluster)}),
        (r"/debug/backup", {"GET": get_debug_backup}),
        (r"/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)"
         r"/remote-available-shards/(?P<shard>[0-9]+)",
         {"DELETE": _not_ported("remote available shards", cluster)}),
        (r"/cluster/resize/abort",
         {"POST": _not_ported("POST /cluster/resize/abort", cluster)}),
        (r"/cluster/resize/remove-node",
         {"POST": _not_ported("POST /cluster/resize/remove-node", cluster)}),
        (r"/cluster/resize/set-coordinator",
         {"POST": _not_ported("POST /cluster/resize/set-coordinator",
                              cluster)}),
        (r"/internal/fragment/block/data",
         {"GET": _not_ported("GET /internal/fragment/block/data", cluster)}),
        (r"/internal/attr/blocks", {"GET": get_attr_blocks}),
        (r"/internal/attr/data", {"GET": get_attr_block_data}),
        (r"/internal/import",
         {"POST": _not_ported("POST /internal/import", cluster)}),
        (r"/internal/nodes",
         {"GET": _not_ported("GET /internal/nodes", cluster)}),
        (r"/internal/probe",
         {"GET": _not_ported("GET /internal/probe", cluster)}),
        (r"/internal/query-mux",
         {"POST": _not_ported("POST /internal/query-mux", cluster)}),
        # The JAX node serves this one ahead of its table, streaming.
        (r"/internal/import-stream",
         {"POST": _not_ported("POST /internal/import-stream", cluster)}),
    ]
    return [(re.compile("^" + p + "$"), methods) for p, methods in table]
