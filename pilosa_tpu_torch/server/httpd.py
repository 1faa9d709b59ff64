"""HTTP layer: REST router over the API facade of a node.

The port's counterpart of pilosa_tpu/server/httpd.py. Reference:
http/handler.go (newRouter :274-318). Implemented on the stdlib
ThreadingHTTPServer, one thread per connection. Every route of the JAX
node's table is mounted in the same order and matched by the same
pattern, the cluster's internal RPC among them (remote query legs in
binary frames, the PTM1 query mux, routed imports and the PTS1 import
stream, control messages, probes, fragment block sync, the resize routes,
the backup RPC, and, on a node started with chaos faults, ``POST
/internal/fault``). ``/debug/queries/<trace>`` asks the peers on a local
miss. A ``NotPortedError`` from a later slice's entry point answers 501
with a body that names the ROADMAP.md slice that brings it.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.cache.tenant import reset_current_tenant, set_current_tenant
from pilosa_tpu_torch.cluster.cluster import ShardUnavailableError
from pilosa_tpu_torch.errors import (
    ApiMethodNotAllowedError,
    ClusterFencedError,
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
    CLASS_BATCH,
    CLASS_INTERNAL,
    DeadlineExceededError,
    IngestBackpressureError,
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
            params["_accept"] = self.headers.get("Accept", "")
            params["_qos_class"] = self.headers.get("X-Qos-Class", "")
            params["_api_key"] = self.headers.get("X-API-Key", "")
            if method == "POST" and parsed.path == "/internal/import-stream":
                # Streaming route: decode and apply chunk by chunk while
                # the client is still sending -- before the whole-body
                # read below.
                return self._handle_import_stream()
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
                except IngestBackpressureError as e:
                    # The quota's shape: the import stream must slow down,
                    # the node is otherwise healthy.
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
                except ClusterFencedError as e:
                    # 503 + Retry-After (before the catch-all): the node
                    # fenced itself off a minority partition -- retryable
                    # server-side unavailability, not a client error.
                    status, payload = 503, {"error": str(e)}
                    headers = {"Retry-After": str(int(e.retry_after))}
                except ShardUnavailableError as e:
                    # Every live owner of some shard is unreachable from
                    # here: transient membership trouble, retryable.
                    status, payload = 503, {"error": str(e)}
                    headers = {"Retry-After": "1"}
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

        def _handle_import_stream(self):
            """POST /internal/import-stream: length-prefixed PTI1 frames
            (wire.STREAM_CONTENT_TYPE), applied as they arrive — decode,
            WAL append (group-committed), device upload per chunk. Bulk
            work rides the BATCH admission class so interactive queries
            keep their weighted share of the node. On backpressure (the
            ingest gate's byte budget, an admission shed, or a tenant
            quota) the server STOPS APPLYING but keeps draining the
            stream, then answers 429 + Retry-After + how many chunks
            were applied — replying mid-send would just break the pipe
            and mask the signal; the client resumes from ``applied``."""
            from pilosa_tpu_torch.server import wire

            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                read = _chunked_body_reader(self.rfile)
            else:
                read = _bounded_body_reader(
                    self.rfile, int(self.headers.get("Content-Length") or 0))
            server = getattr(api, "import_handler", None)
            if server is None:
                self.close_connection = True
                return self._reply(400, {"error": "no import handler"})
            qos_ctl = getattr(api, "qos", None)
            gate = getattr(api, "ingest_gate", None)
            # Raw route (bypasses _dispatch's params): read the QoS
            # class header directly. Resize fragment migration streams
            # as "internal" so it never starves interactive traffic;
            # user bulk loads stay BATCH.
            hdr = self.headers.get("X-Qos-Class") or ""
            cls = normalize_class(hdr) if hdr else CLASS_BATCH
            applied = 0
            pressure = None
            fatal = None
            try:
                for frame in wire.iter_stream_frames(read):
                    if pressure is not None or fatal is not None:
                        continue  # draining: count nothing, apply nothing
                    try:
                        if gate is not None:
                            with gate.admit(len(frame)):
                                self._apply_import_chunk(
                                    wire.decode_import(frame), server,
                                    qos_ctl, cls)
                        else:
                            self._apply_import_chunk(
                                wire.decode_import(frame), server, qos_ctl,
                                cls)
                        applied += 1
                    except (IngestBackpressureError, QueryShedError,
                            QuotaExceededError) as e:
                        pressure = e
                    except Exception as e:  # bad chunk: drain, then report
                        fatal = e
            except ValueError as e:
                # Malformed stream framing: the tail is unreadable, so
                # the connection can't be reused.
                self.close_connection = True
                return self._reply(400, {"error": str(e),
                                         "applied": applied})
            if fatal is not None:
                status = 404 if isinstance(fatal, _NOT_FOUND + (LookupError,)) \
                    else 400 if isinstance(fatal, (ValueError, KeyError,
                                                   PilosaError)) else 500
                return self._reply(status, {"error": str(fatal),
                                            "applied": applied})
            if pressure is not None:
                return self._reply(
                    429, {"error": str(pressure), "applied": applied},
                    {"Retry-After":
                     str(max(1, int(pressure.retry_after + 0.5)))})
            return self._reply(200, {"applied": applied})

        def _apply_import_chunk(self, req, server, qos_ctl,
                                cls=CLASS_BATCH):
            if qos_ctl is not None:
                with qos_ctl.admit(cls):
                    server(req)
            else:
                server(req)

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


def _bounded_body_reader(rfile, length: int):
    """read(n) over a Content-Length body that never reads past it (the
    socket would block waiting for bytes that aren't coming)."""
    remaining = [length]

    def read(n: int) -> bytes:
        if remaining[0] <= 0:
            return b""
        b = rfile.read(min(n, remaining[0]))
        remaining[0] -= len(b)
        return b

    return read


def _chunked_body_reader(rfile):
    """read(n) over a chunked transfer-encoded body (hex-length lines,
    RFC 9112 §7.1) — what http.client sends for an iterator body, which
    is how the import client pipelines an unbounded stream."""
    state = {"left": 0, "eof": False}

    def read(n: int) -> bytes:
        if state["eof"]:
            return b""
        if state["left"] == 0:
            line = rfile.readline(130)
            if not line:
                state["eof"] = True
                return b""
            try:
                size = int(line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                state["eof"] = True
                return b""
            if size == 0:
                # consume optional trailers up to the blank line
                while True:
                    t = rfile.readline(1024)
                    if not t or t in (b"\r\n", b"\n"):
                        break
                state["eof"] = True
                return b""
            state["left"] = size
        b = rfile.read(min(n, state["left"]))
        state["left"] -= len(b)
        if state["left"] == 0:
            rfile.read(2)  # chunk-terminating CRLF
        return b

    return read


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
        from pilosa_tpu_torch.server import wire
        remote = params.get("remote") == "true"
        # v2 frames carry aggregates as typed array blobs too; a v1 client's
        # bare content type gets the v1 layout (JSON aggregate metas).
        accept = params.get("_accept", "")
        frames: int | bool = False
        if remote and wire.FRAMES_CONTENT_TYPE in accept:
            frames = 2 if "v=2" in accept else True
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
        # Chaos fault hook: a "slow peer" serves every query late but
        # stays alive to membership probes (a gray failure the breaker and
        # hedge layer must route around). Set by POST /internal/fault.
        if api.fault_slow_s > 0:
            time.sleep(api.fault_slow_s)
        want_inline_profile = params.get("profile") == "true"
        # Result-cache gate: noCache bypasses explicitly; non-remote
        # INTERNAL-class requests (maintenance sweeps) must not churn
        # interactive tenants' partitions (remote fan-out legs keep
        # caching); an explicitly profiled query is exempt too, since a
        # hit would profile the lookup, not the cost asked for.
        use_cache = (params.get("noCache") != "true"
                     and not want_inline_profile
                     and (remote or cls != CLASS_INTERNAL))
        # Tenant: the identity the quota table charges (X-API-Key,
        # falling back to the index name); remote legs run under the
        # default tenant, the coordinator having charged the query once.
        ttoken = set_current_tenant(
            "" if remote else (params.get("_api_key") or pv["index"]))
        # Per-query cost profile: armed by ?profile=true (inline in the
        # response; a remote leg sends it home in the frames header) or by
        # the node's always-on slowest-N ring.
        ring = api.profile_ring
        want_profile = want_inline_profile or (
            not remote and ring is not None and api.profile_default)
        prof = None
        ptoken = trace_token = None
        prof_doc = None
        if want_profile:
            tid = _tr.current_trace_id()
            if not tid:
                tid = _tr.new_trace_id()
                trace_token = _tr.set_current_trace(tid)
            node_id = (api.cluster.local_id if api.cluster is not None
                       else getattr(api.local_node, "id", "") or "standalone")
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
                # tenant must not occupy a queue slot. Remote legs are
                # exempt: the coordinator charged the tenant once.
                if api.quotas is not None and not remote:
                    api.quotas.check(params.get("_api_key") or pv["index"])
                kwargs = dict(
                    shards=shards,
                    column_attrs=params.get("columnAttrs") == "true",
                    exclude_row_attrs=params.get("excludeRowAttrs") == "true",
                    exclude_columns=params.get("excludeColumns") == "true",
                    remote=remote, accept_frames=frames, cache=use_cache)
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
            except (ClusterFencedError, ShardUnavailableError):
                # Also past the PilosaError catch: 503 + Retry-After
                # (partition-era unavailability, not a bad query).
                status = "shed"
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
                if not remote:
                    # A remote leg's ledger already went home in its
                    # response header (api.query).
                    prof_doc = prof.finish()
                    if ring is not None:
                        ring.record(prof_doc)
            if not remote and status not in ("shed", "quota"):
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
        if isinstance(resp, bytes):
            return 200, resp, {"Content-Type": wire.FRAMES_CONTENT_TYPE}
        if want_inline_profile and prof_doc is not None and isinstance(resp, dict):
            resp["profile"] = prof_doc
        return 200, resp

    def post_query_mux(pv, params, body):
        """Multiplexed peer-leg batch (POST /internal/query-mux): one
        request carrying N independent query legs, answered with N binary
        frames (wire.encode_mux_response). Transport failures stay
        whole-request; everything application-level -- shed, deadline,
        quarantine, missing index, parse error -- is a per-leg outcome
        inside the envelope. Each leg restores its own trace id and
        deadline from the envelope."""
        from pilosa_tpu_torch.server import wire
        legs = wire.decode_mux_request(body)  # ValueError -> 400
        qos_ctl = api.qos
        cls = normalize_class("", remote=True)
        outcomes: list[dict] = []
        for leg in legs:
            token = None
            trace = leg.get("trace")
            if trace:
                token = _tr.set_current_trace(trace)
            tms = leg.get("timeoutMs")
            if tms is not None:
                dl = qos_deadline.Deadline(timeout=float(tms) / 1000.0)
            elif qos_ctl is not None and qos_ctl.default_deadline > 0:
                dl = qos_deadline.Deadline(timeout=qos_ctl.default_deadline)
            else:
                dl = None
            dtoken = (qos_deadline.set_current_deadline(dl)
                      if dl is not None else None)
            # Remote legs run under the default tenant.
            ttoken = set_current_tenant("")
            # A profiled leg ledgers this node's own costs; api.query
            # ships the finished doc home in the leg's frames header.
            ptoken = None
            use_cache = not leg.get("profile")
            if leg.get("profile"):
                node_id = (api.cluster.local_id if api.cluster is not None
                           else "standalone")
                ptoken = _profile.activate(_profile.QueryProfile(
                    trace or "", query=leg["query"], index=leg["index"],
                    node=node_id, qos_class=cls, remote=True))
            try:
                if api.fault_slow_s > 0:
                    time.sleep(api.fault_slow_s)
                qos_deadline.check_current()
                kwargs = dict(shards=leg.get("shards"), remote=True,
                              accept_frames=2, cache=use_cache)
                if qos_ctl is not None:
                    with qos_ctl.admit(cls):
                        frame = api.query(leg["index"], leg["query"], **kwargs)
                else:
                    frame = api.query(leg["index"], leg["query"], **kwargs)
                outcomes.append({"frame": frame})
            except QueryShedError as e:
                outcomes.append({"status": 503, "error": str(e),
                                 "retryAfter": float(e.retry_after)})
            except ShardCorruptError as e:
                # str() carries "quarantined": the client's typed
                # ShardCorruptError mapping keys on it.
                outcomes.append({"status": 503, "error": str(e)})
            except DeadlineExceededError as e:
                outcomes.append({"status": 504, "error": str(e)})
            except _NOT_FOUND as e:
                outcomes.append({"status": 404, "error": str(e)})
            except (QueryError, ParseError, ValueError, PilosaError) as e:
                outcomes.append({"status": 400, "error": str(e)})
            finally:
                if ptoken is not None:
                    _profile.deactivate(ptoken)
                reset_current_tenant(ttoken)
                if dtoken is not None:
                    qos_deadline.reset_current_deadline(dtoken)
                if token is not None:
                    _tr.reset_current_trace(token)
        return (200, wire.encode_mux_response(outcomes),
                {"Content-Type": wire.MUX_CONTENT_TYPE})

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
        api.apply_schema(jbody(body).get("indexes", []),
                         remote=params.get("remote") == "true")
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
        from pilosa_tpu_torch.ops import kernels
        out = planner.device_debug()
        out["enabled"] = True
        # The port's own key: each kernel's launches since the process
        # started (or the last reset_launches).
        out["launches"] = dict(kernels.LAUNCHES)
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
        coord = None
        if api.cluster is not None:
            c = api.cluster.coordinator()
            coord = c is not None and c.id == api.cluster.local_id
        return 200, {"coordinator": coord,
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
        """One retained profile by trace id -- the target of /metrics
        exemplars and slow-query-log ``profile`` pointers.

        Remote fan-out legs never record into the serving node's ring
        (the coordinator retains the whole nested ledger), so a trace id
        scraped off a *remote* node's exemplars would 404 there. On a
        local miss, ask the peers -- whichever node coordinated the query
        answers with the full nested profile. ``local=true`` bounds the
        search to one hop."""
        ring = api.profile_ring
        doc = ring.get(pv["trace"]) if ring is not None else None
        if doc is None and params.get("local") != "true":
            doc = _peer_query_profile(pv["trace"])
        if doc is None:
            return 404, {"error": f"no retained profile for {pv['trace']}"}
        return 200, doc

    def _peer_query_profile(trace):
        cluster = api.cluster
        if cluster is None:
            return None
        fetch = getattr(cluster.client, "debug_query_profile", None)
        if fetch is None:
            return None
        me = cluster.local_node
        best = None
        for node in list(cluster.nodes):
            if (me is not None and node.id == me.id) or node.state == "DOWN":
                continue
            try:
                doc = fetch(node, trace)
            except Exception:
                continue
            if not doc:
                continue
            # Prefer the coordinator's copy: it nests every remote leg.
            if best is None or (doc.get("remoteLegs")
                                and not best.get("remoteLegs")):
                best = doc
        return best

    def get_debug_overload(pv, params, body):
        """Adaptive admission limit, per-tenant quota buckets, per-peer
        breaker states, the hedge budget and the result cache's
        occupancy."""
        qos_ctl = api.qos
        rcache = api.executor.result_cache
        breakers = hedge = None
        if api.cluster is not None:
            breakers = getattr(api.cluster.client, "breakers", None)
            hedge = api.cluster.hedge
        return 200, {
            "admission": qos_ctl.snapshot() if qos_ctl is not None else None,
            "adaptive": (qos_ctl.adaptive.snapshot()
                         if qos_ctl is not None
                         and qos_ctl.adaptive is not None else None),
            "quotas": (api.quotas.snapshot()
                       if api.quotas is not None else None),
            "breakers": breakers.snapshot() if breakers is not None else None,
            "hedge": hedge.snapshot() if hedge is not None else None,
            "cache": rcache.snapshot() if rcache is not None else None,
        }

    def get_debug_cache(pv, params, body):
        """Result-cache snapshot: byte/entry occupancy, hit and eviction
        counters, per-tenant partitions, and the remote shard epochs the
        node observed from remote legs and peers' broadcasts."""
        rcache = api.executor.result_cache
        if rcache is None:
            return 200, {"enabled": False}
        snap = rcache.snapshot()
        snap["enabled"] = True
        snap["remoteEpochs"] = api.executor.remote_epochs.snapshot()
        return 200, snap

    def get_debug_membership(pv, params, body):
        """What THIS node thinks of the ring: per-peer state with the
        failure detector's last probe outcome and indirect-probe verdicts,
        per-peer breaker state, and the quorum fence."""
        cluster = api.cluster
        if cluster is None:
            return 200, {"cluster": False}
        breakers = getattr(cluster.client, "breakers", None)
        bpeers = breakers.snapshot().get("peers", {}) if breakers is not None else {}
        log = cluster.membership_log or {}
        peers = []
        for n in list(cluster.nodes):
            obs = log.get(n.id, {})
            peers.append({
                "id": n.id,
                "state": n.state,
                "isCoordinator": bool(n.is_coordinator),
                "self": n.id == cluster.local_id,
                "lastProbeOk": obs.get("lastProbeOk"),
                "lastProbeDirect": obs.get("lastProbeDirect"),
                "lastProbeEpoch": obs.get("lastProbeAt"),
                "indirect": obs.get("indirect", {}),
                "breaker": bpeers.get(n.id),
            })
        return 200, {
            "cluster": True,
            "localId": cluster.local_id,
            "state": cluster.state,
            "topologyVersion": cluster.topology_version,
            "fenced": bool(cluster.fenced),
            "fenceStaleReads": bool(cluster.fence_stale_reads),
            "fencingToken": cluster.fencing_token(),
            "injectedFaults": (cluster.client.faults.snapshot()
                               if cluster.client.faults is not None else {}),
            "peers": peers,
        }

    def post_fault(pv, params, body):
        """Chaos fault injection. {"slowMs": N} delays every subsequent
        /query on this node by N ms (0 heals); {"partition": {"peers":
        [...ids...], "mode": "drop"|"timeout", "delayMs": N}} cuts this
        node's OUTBOUND links to the named peers (asymmetric by
        construction — the chaos drill faults both sides for a
        symmetric split); {"healPartition": true} clears every link
        fault. Only mounted when the node was started with chaos faults
        enabled (--chaos-faults / PILOSA_TPU_CHAOS_FAULTS) — a
        one-request degradation lever must not ship armed."""
        req = jbody(body)
        if "slowMs" in req:
            api.fault_slow_s = max(0.0, float(req["slowMs"]) / 1000.0)
        faults = api.cluster.client.faults if api.cluster is not None else None
        part = req.get("partition")
        if part is not None or req.get("healPartition"):
            if faults is None:
                return 400, {"error": "node has no partition fault table "
                                      "(standalone?)"}
            if req.get("healPartition"):
                faults.clear()
            if part is not None:
                mode = part.get("mode", "drop")
                delay_s = float(part.get("delayMs", 0.0)) / 1000.0
                for peer in part.get("peers", []):
                    faults.set_fault(str(peer), mode=mode, delay_s=delay_s)
        return 200, {"slowMs": api.fault_slow_s * 1000.0,
                     "partition": (faults.snapshot()
                                   if faults is not None else {})}

    def get_availability(pv, params, body):
        """Per-field shard availability (the additive NodeStatus half,
        reference server.go:640)."""
        from pilosa_tpu_torch.cluster.resize import holder_availability
        return 200, holder_availability(api.holder)

    def get_debug_resize(pv, params, body):
        """Live serve-through resize state: the coordinator's job (per-
        shard migrated/in-flight counts, cutover lag) and/or this
        member's migration table. {"job": null, "migration": null} at
        rest — the probe a drill/operator polls while the ring moves."""
        job = api.resize_job
        mig = api.cluster.migration if api.cluster is not None else None
        return 200, {
            "job": job.snapshot() if job is not None else None,
            "migration": mig.snapshot() if mig is not None else None,
        }

    def post_resize_abort(pv, params, body):
        job = api.resize_job
        if job is not None:
            job.abort()
        return 200, {}

    def post_resize_remove_node(pv, params, body):
        req = jbody(body)
        handler = api.resize_handler
        if handler is None:
            return 400, {"error": "resize not supported on this node"}
        handler("remove", req.get("id"))
        return 200, {}

    def post_set_coordinator(pv, params, body):
        req = jbody(body)
        if api.cluster is not None:
            for n in api.cluster.nodes:
                n.is_coordinator = (n.id == req.get("id"))
            # Persist the handoff: a restart must not resurrect the OLD
            # coordinator flag from topology.json (resizes would consult
            # the wrong node as the resize authority).
            api.cluster.notify_topology()
        return 200, {}

    def get_fragment_blocks(pv, params, body):
        blocks = api.fragment_blocks(params["index"], params["field"],
                                     params["view"], int(params["shard"]))
        return 200, {"blocks": [{"id": b, "checksum": cs.hex()}
                                for b, cs in sorted(blocks.items())]}

    def get_fragment_block_data(pv, params, body):
        rows, cols = api.fragment_block_data(
            params["index"], params["field"], params["view"],
            int(params["shard"]), int(params["block"]))
        return 200, {"rowIDs": [int(r) for r in rows],
                     "columnIDs": [int(c) for c in cols]}

    def post_cluster_message(pv, params, body):
        handler = getattr(api, "message_handler", None)
        if handler is not None:
            handler(jbody(body))
        return 200, {}

    def post_internal_import(pv, params, body):
        """A routed import batch: binary PTI1 frames (wire.encode_import)
        or JSON, sniffed by magic."""
        from pilosa_tpu_torch.server import wire
        req = wire.decode_import(body) if wire.is_import_frame(body) else jbody(body)
        handler = getattr(api, "import_handler", None)
        if handler is None:
            return 400, {"error": "no import handler"}
        handler(req)
        return 200, {}

    def get_nodes(pv, params, body):
        return 200, api.hosts()

    def get_internal_probe(pv, params, body):
        """Probe a member on a caller's behalf (memberlist's indirect
        ping): an asymmetric partition between the caller and the target
        must not read as target-down when this node can still reach it.
        Only ring members are probed."""
        cluster = api.cluster
        host = params.get("host", "")
        port = str(params.get("port", ""))
        target = None
        if cluster is not None:
            target = next((n for n in cluster.nodes
                           if n.uri.host == host and str(n.uri.port) == port), None)
        if target is None:
            return 200, {"ok": False}
        try:
            cluster.client.probe(target)
            return 200, {"ok": True}
        except (ConnectionError, OSError, RuntimeError):
            return 200, {"ok": False}

    def delete_remote_available_shard(pv, params, body):
        api.delete_available_shard(pv["index"], pv["field"], int(pv["shard"]))
        return 200, {}

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
        (r"/debug/membership", {"GET": get_debug_membership}),
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
        (r"/internal/availability", {"GET": get_availability}),
        (r"/internal/translate/keys", {"POST": post_translate_keys}),
        (r"/internal/translate/entries", {"GET": get_translate_entries}),
        (r"/internal/cluster/message", {"POST": post_cluster_message}),
        (r"/internal/fragment/blocks", {"GET": get_fragment_blocks}),
        (r"/internal/fragment/nodes", {"GET": get_fragment_nodes}),
        (r"/debug/resize", {"GET": get_debug_resize}),
        (r"/debug/backup", {"GET": get_debug_backup}),
        (r"/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)"
         r"/remote-available-shards/(?P<shard>[0-9]+)",
         {"DELETE": delete_remote_available_shard}),
        (r"/cluster/resize/abort", {"POST": post_resize_abort}),
        (r"/cluster/resize/remove-node", {"POST": post_resize_remove_node}),
        (r"/cluster/resize/set-coordinator", {"POST": post_set_coordinator}),
        (r"/internal/fragment/block/data", {"GET": get_fragment_block_data}),
        (r"/internal/attr/blocks", {"GET": get_attr_blocks}),
        (r"/internal/attr/data", {"GET": get_attr_block_data}),
        (r"/internal/import", {"POST": post_internal_import}),
        (r"/internal/nodes", {"GET": get_nodes}),
        (r"/internal/probe", {"GET": get_internal_probe}),
        (r"/internal/query-mux", {"POST": post_query_mux}),
    ]
    if api.chaos_faults:
        table.append((r"/internal/fault", {"POST": post_fault}))
    return [(re.compile("^" + p + "$"), methods) for p, methods in table]
