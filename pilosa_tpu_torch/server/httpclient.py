"""InternalClient over HTTP — the real-cluster transport.

Reference: http/client.go:37 (queries via POST /index/{i}/query with
remote=true, fragment sync via /internal/fragment/*, messages via
/internal/cluster/message). JSON bodies; stdlib http.client, no
dependencies.

Connections are persistent (HTTP/1.1 keep-alive) and pooled per
(scheme, host, port): the per-request TCP handshake + slow-start was a
fixed tax on every cluster leg (the reference uses Go's pooling
http.Transport for the same reason). The pool is shared across threads
behind one short-critical-section lock so the failure detector can
invalidate a peer's idle sockets for EVERY thread; a reused socket that
the peer closed while idle gets ONE transparent retry on a fresh
connection — only when the failure proves the request never reached
application code.

Liveness probes never ride the pool: a probe must test the peer's
ability to ACCEPT connections, and a cached socket only proves the
socket itself still works. A peer whose listener died (crash, restart,
failover to a new process on the same address) can keep old sockets
half-alive long after it stopped being the node at that address — so a
failed probe also bumps the peer's pool epoch, closing its idle
connections and preventing in-flight ones from being returned.

The port's copy of pilosa_tpu/server/httpclient.py, with the PTM1 peer
channel, TLS client options, the PTS1 import stream, the anti-entropy
and key-translation RPCs, and chaos partition faults. Row legs decode onto
the client's ``device`` (the node's holder device).
"""

from __future__ import annotations

import http.client
import json
import os
import random
import socket
import threading
import time
import urllib.parse
from typing import Any

import numpy as np

from pilosa_tpu_torch.cluster.node import Node
from pilosa_tpu_torch.obs import profile as _profile
from pilosa_tpu_torch.qos.deadline import DeadlineExceededError
from pilosa_tpu_torch.qos.deadline import inject_http_headers as _inject_deadline
from pilosa_tpu_torch.qos.deadline import current_deadline as _current_deadline


class NodeHTTPError(RuntimeError):
    """A live peer rejected the request (HTTP status attached). Stays a
    RuntimeError so existing 'alive but refused' handling keeps working;
    failover paths must keep catching ConnectionError only.

    ``retry_after`` carries the peer's Retry-After hint (seconds) when
    it shed the request (QoS 503); None otherwise."""

    def __init__(self, code: int, message: str,
                 retry_after: float | None = None):
        super().__init__(message)
        self.code = code
        self.retry_after = retry_after


#: bounded exponential backoff for idempotent requests a peer shed
#: (503). Full jitter (AWS-style) so a synchronized burst of retries
#: doesn't re-overload the node that just told everyone to back off.
RETRY_503_ATTEMPTS = 3
RETRY_BASE_DELAY = 0.1
RETRY_MAX_DELAY = 5.0

def _epoch_vector(raw: dict | None) -> dict:
    """Normalize a wire shardEpochs payload (JSON string keys) back to
    the {int shard: int epoch} shape RemoteEpochTable.observe expects."""
    if not raw:
        return {}
    return {int(s): int(e) for s, e in raw.items()}


#: connection failures that, on a REUSED socket, mean the peer closed it
#: while idle — the request never reached application code, so one
#: transparent retry on a fresh connection is safe for any method.
_STALE_CONN_ERRORS = (http.client.RemoteDisconnected,
                      http.client.BadStatusLine,
                      http.client.CannotSendRequest,
                      ConnectionResetError,
                      BrokenPipeError)


class _RewindableChunks:
    """Iterable-only body: http.client sees no length and sends chunked
    transfer-encoding. Unlike a generator, iteration restarts from the
    top, so _http's one stale-connection retry re-sends the whole
    stream instead of a truncated tail."""

    def __init__(self, chunks: list[bytes]):
        self._chunks = chunks

    def __iter__(self):
        return iter(self._chunks)


class _ConnPool:
    """Shared keep-alive pool: {(scheme, host, port): idle connections}.

    A checked-out connection is owned exclusively by the borrowing
    thread (http.client serializes one request at a time), so the lock
    only guards the idle lists — a dict pop/append, nanoseconds next to
    a network round-trip.

    Each peer key carries an *epoch*. ``invalidate`` bumps it and closes
    the idle connections; a connection checked out under an older epoch
    is closed instead of returned, so a socket that was mid-request to a
    dead listener can never re-enter the pool.
    """

    #: idle connections kept per peer — enough for the handful of
    #: threads (executor legs, syncer, prober) that talk to one peer
    #: concurrently without hoarding sockets.
    MAX_IDLE_PER_PEER = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: dict[tuple, list[http.client.HTTPConnection]] = {}
        self._epoch: dict[tuple, int] = {}

    def get(self, key: tuple):
        """-> (idle connection or None, current epoch for the key)."""
        with self._lock:
            epoch = self._epoch.get(key, 0)
            conns = self._idle.get(key)
            return (conns.pop() if conns else None), epoch

    def put(self, key: tuple, conn, epoch: int) -> None:
        with self._lock:
            if epoch == self._epoch.get(key, 0):
                lst = self._idle.setdefault(key, [])
                if len(lst) < self.MAX_IDLE_PER_PEER:
                    lst.append(conn)
                    return
        # Epoch advanced while this connection was in flight (the peer
        # failed a liveness probe), or the peer's idle list is full.
        try:
            conn.close()
        except Exception:
            pass

    def invalidate(self, key: tuple) -> None:
        with self._lock:
            self._epoch[key] = self._epoch.get(key, 0) + 1
            conns = self._idle.pop(key, [])
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, {}
            for key in idle:
                self._epoch[key] = self._epoch.get(key, 0) + 1
        for conns in idle.values():
            for conn in conns:
                try:
                    conn.close()
                except Exception:
                    pass


def _split_url(url: str) -> tuple[str, str, int, str]:
    parts = urllib.parse.urlsplit(url)
    scheme = parts.scheme or "http"
    port = parts.port or (443 if scheme == "https" else 80)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    return scheme, parts.hostname or "", port, path


class _MuxLeg:
    """One outbound query leg riding a multiplexed peer channel."""

    __slots__ = ("index", "query", "shards", "timeout_ms", "trace",
                 "profile", "done", "frame", "error", "bytes_out")

    def __init__(self, index: str, query: str, shards, timeout_ms,
                 trace: str | None, profile: bool = False):
        self.index = index
        self.query = query
        self.shards = shards
        self.timeout_ms = timeout_ms
        self.trace = trace
        self.profile = profile
        self.done = False
        self.frame: bytes | None = None
        self.error: BaseException | None = None
        self.bytes_out = len(query)

    def to_json(self) -> dict:
        d: dict = {"index": self.index, "query": self.query}
        if self.shards:
            d["shards"] = list(self.shards)
        if self.timeout_ms is not None:
            d["timeoutMs"] = self.timeout_ms
        if self.trace:
            d["trace"] = self.trace
        if self.profile:
            d["profile"] = True
        return d


class _MuxUnsupportedError(Exception):
    """Sentinel: the peer doesn't speak the mux envelope (old version);
    the submitting leg falls back to a per-query request."""


class _PeerChannel:
    """Per-peer request multiplexer (group commit).

    The first leg to a free channel dispatches immediately — batching
    adds ZERO latency to an idle peer. Legs arriving while a batch is
    in flight queue up; when the wire frees, one of their threads
    drains the whole queue as the next batch. Under concurrent load
    the coordinator therefore sends one pipelined request per peer per
    congestion window instead of one per query.

    Every leg keeps its own deadline, trace id, epoch stamp, and error
    status (the envelope carries them per leg); only transport-level
    outcomes — connection failure, breaker state — are shared, exactly
    as they would be on one physical connection.
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._queue: list[_MuxLeg] = []
        self._busy = False

    def submit(self, client: "HTTPInternalClient", node: Node,
               leg: _MuxLeg) -> _MuxLeg:
        """Blocks until the leg is resolved (frame or error set)."""
        with self._cv:
            self._queue.append(leg)
            batch = None
            while not leg.done:
                if not self._busy:
                    # Become the dispatcher for everything queued
                    # (including our own leg — nobody drained it yet).
                    batch, self._queue = self._queue, []
                    self._busy = True
                    break
                self._cv.wait(timeout=0.1)
                if leg.done:
                    break
                # A queued (not yet in-flight) leg whose deadline died
                # while another batch holds the wire gives up its slot;
                # an in-flight leg must wait for its outcome.
                dl = _current_deadline()
                rem = dl.remaining() if dl is not None else None
                if (rem is not None and rem <= 0) and leg in self._queue:
                    self._queue.remove(leg)
                    leg.error = DeadlineExceededError(
                        "deadline expired before remote call")
                    leg.done = True
        if batch is not None:
            try:
                client._send_mux_batch(node, batch)
            finally:
                with self._cv:
                    for b in batch:
                        b.done = True
                    self._busy = False
                    self._cv.notify_all()
        return leg


class HTTPInternalClient:
    """Implements the InternalClient protocol against peer HTTP servers."""

    def __init__(self, timeout: float = 30.0, ca_cert: str | None = None,
                 skip_verify: bool | None = None, device: str = "cpu"):
        #: where decoded Row legs' segments live (the holder's device).
        self.device = device
        self._ssl_ctx = None
        self._pool = _ConnPool()
        self.timeout = timeout
        self.ca_cert = ca_cert
        #: Optional BreakerRegistry (cluster.breaker). When set, every
        #: request consults the peer's breaker first — an open breaker
        #: fast-fails with BreakerOpenError (a ConnectionError) so the
        #: executor's replica failover kicks in without burning a
        #: socket timeout on a known-sick peer.
        self.breakers = None
        #: Optional StatsClient: wire-level counters (cluster.wireBytesIn/
        #: wireBytesOut/wireDecodeMs) land on /debug/vars when set.
        self.stats = None
        #: Coalesce concurrent outbound query legs to the same peer into
        #: one multiplexed request (POST /internal/query-mux). Peers that
        #: 404/400 the envelope (older version) are remembered and get
        #: per-query requests instead — see _mux_allowed.
        self.multiplex = True
        self._channels: dict[str, _PeerChannel] = {}
        self._channels_lock = threading.Lock()
        self._mux_unsupported: set[str] = set()
        #: Peers that rejected the PTS1 import stream (older version);
        #: they get per-batch /internal/import requests instead.
        self._stream_unsupported: set[str] = set()
        #: Optional PartitionFaults (cluster.faults): chaos-injected
        #: outbound link cuts, consulted before any wire traffic so a
        #: drill's "partition" behaves like the network it models —
        #: drop fails the dial, timeout burns the delay first.
        self.faults = None
        self._leg_local = threading.local()
        # Verification policy (reference tls.skip-verify,
        # server/config.go): with a CA bundle, verify by default; the
        # CERT_NONE fallback is only for CA-less (self-signed) clusters
        # or an explicit skip_verify=True.
        self.skip_verify = (skip_verify if skip_verify is not None
                            else ca_cert is None)
        if ca_cert is not None:
            # Fail fast at startup: a typo'd CA path raising lazily on
            # the first HTTPS request would kill background threads
            # (join/announce, anti-entropy) with an uncaught error.
            import ssl
            ssl.create_default_context(cafile=ca_cert)

    def _url(self, node: Node, path: str) -> str:
        return f"{node.uri}{path}"

    def _check_fault(self, node: Node) -> None:
        """Injected-partition gate: raise ConnectionError (feeding the
        breaker, like any real connection failure) when the link to
        this peer is faulted."""
        if self.faults is None:
            return
        try:
            self.faults.check(node.id)
        except ConnectionError:
            if self.breakers is not None:
                self.breakers.record_failure(node.id)
            raise

    def _ctx(self, url: str):
        """SSL context for https peers. Plain http gets None."""
        if not url.startswith("https:"):
            return None
        ctx = self._ssl_ctx
        if ctx is None:
            import ssl
            ctx = ssl.create_default_context(cafile=self.ca_cert)
            if self.skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ssl_ctx = ctx
        return ctx

    def _deadline_timeout(self) -> float:
        """Per-request socket timeout capped to the active deadline's
        remaining budget; raises instead of sending a request that
        cannot finish in time."""
        dl = _current_deadline()
        if dl is None:
            return self.timeout
        rem = dl.remaining()
        if rem is None:
            dl.check()  # cancel-only token
            return self.timeout
        if rem <= 0 or dl.cancelled:
            raise DeadlineExceededError("deadline expired before remote call")
        return max(0.05, min(self.timeout, rem))

    def _http(self, url: str, method: str = "GET",
              body: bytes | None = None, headers: dict | None = None,
              timeout: float | None = None):
        """One request over a pooled keep-alive connection.

        Returns (status, response-headers Message, body bytes). Raises
        the OSError family on connection problems (socket timeouts
        included) — callers map those to ConnectionError with the peer
        id attached. A reused socket the peer closed while idle gets one
        transparent fresh-connection retry; a fresh connection's failure
        is real and propagates.
        """
        scheme, host, port, path = _split_url(url)
        key = (scheme, host, port)
        if timeout is None:
            timeout = self.timeout
        while True:
            conn, epoch = self._pool.get(key)
            reused = conn is not None
            if conn is None:
                if scheme == "https":
                    conn = http.client.HTTPSConnection(
                        host, port, timeout=timeout, context=self._ctx(url))
                else:
                    conn = http.client.HTTPConnection(host, port,
                                                      timeout=timeout)
            else:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
            except _STALE_CONN_ERRORS:
                conn.close()
                if reused:
                    continue  # idle socket died under us; retry fresh
                raise
            except BaseException:
                # Timeouts and dial failures are real; so is any error
                # mid-response. Never return a half-used connection to
                # the pool.
                conn.close()
                raise
            if resp.will_close:
                conn.close()
            else:
                try:
                    # Cluster legs are latency-bound small messages:
                    # never let Nagle hold a reply back (~40 ms).
                    conn.sock.setsockopt(socket.IPPROTO_TCP,
                                         socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                self._pool.put(key, conn, epoch)
            return resp.status, resp.msg, data

    def close(self) -> None:
        """Close every pooled idle connection; in-flight checkouts are
        closed on return (their epoch is stale)."""
        self._pool.close_all()

    def _request_raw(self, node: Node, method: str, path: str,
                     body: bytes | None = None,
                     accept: str | None = None,
                     content_type: str = "application/json",
                     retry_503: bool = False) -> tuple[bytes, str]:
        """Returns (body, content-type).

        ``retry_503=True`` (idempotent requests only): when the peer
        sheds with 503, retry up to RETRY_503_ATTEMPTS times with
        bounded exponential backoff + full jitter, honoring the peer's
        Retry-After hint as the floor — and never sleeping past the
        active deadline.
        """
        if self.breakers is not None:
            self.breakers.check(node.id)
        self._check_fault(node)
        attempt = 0
        try:
            while True:
                headers: dict = {}
                if body is not None:
                    headers["Content-Type"] = content_type
                if accept is not None:
                    headers["Accept"] = accept
                from pilosa_tpu_torch.obs.tracing import inject_http_headers
                inject_http_headers(headers)
                _inject_deadline(headers)
                try:
                    status, msg, data = self._http(
                        self._url(node, path), method, body, headers,
                        timeout=self._deadline_timeout())
                except OSError as e:
                    # Connection failures AND deadline overruns (socket
                    # timeout surfaces as OSError) both feed the breaker:
                    # a peer too slow to answer within budget is as
                    # useless as one that refuses the dial.
                    if self.breakers is not None:
                        self.breakers.record_failure(node.id)
                    raise ConnectionError(
                        f"node {node.id} unreachable: {e}") from e
                if status < 400:
                    if self.breakers is not None:
                        self.breakers.record_success(node.id)
                    return data, msg.get("Content-Type", "") or ""
                # The peer is alive but rejected the request —
                # application error, NOT a connection failure
                # (failover must not trigger, and the breaker must
                # not feed: a shedding peer is healthy, just busy).
                if self.breakers is not None:
                    self.breakers.record_success(node.id)
                detail = data.decode(errors="replace")
                if status == 404:
                    raise LookupError(f"{node.id}: {detail}")
                retry_after = None
                if status == 503:
                    try:
                        retry_after = float(msg.get("Retry-After"))
                    except (TypeError, ValueError):
                        retry_after = None
                    if retry_503 and attempt < RETRY_503_ATTEMPTS:
                        delay = self._backoff_delay(attempt, retry_after)
                        if delay is not None:
                            time.sleep(delay)
                            attempt += 1
                            continue
                raise NodeHTTPError(
                    status, f"node {node.id} HTTP {status}: {detail}",
                    retry_after=retry_after)
        except (ConnectionError, NodeHTTPError, LookupError):
            raise  # breaker outcome already recorded above
        except BaseException:
            # Escaped before any outcome was recorded — e.g. the active
            # deadline expired before dialing (DeadlineExceededError
            # from _deadline_timeout). That proves nothing about the
            # peer, so release a claimed half-open probe instead of
            # leaving it wedged (a stuck lease would fast-fail the peer
            # until process restart).
            if self.breakers is not None:
                self.breakers.abort(node.id)
            raise

    @staticmethod
    def _backoff_delay(attempt: int, retry_after: float | None) -> float | None:
        """Jittered, bounded delay before re-sending a shed request, or
        None when the active deadline can't afford the wait (give the
        remaining budget back to the caller's failover logic instead of
        sleeping it away)."""
        cap = min(RETRY_MAX_DELAY, RETRY_BASE_DELAY * (2 ** attempt))
        delay = random.uniform(0, cap)
        if retry_after is not None:
            # The shedding node knows its queue better than our curve
            # does; keep jitter on top so retries don't synchronize.
            delay = retry_after + random.uniform(0, cap)
        dl = _current_deadline()
        if dl is not None:
            rem = dl.remaining()
            if rem is not None and rem <= delay:
                return None
        return delay

    def _request(self, node: Node, method: str, path: str,
                 body: bytes | None = None,
                 content_type: str = "application/json",
                 retry_503: bool | None = None) -> Any:
        # GETs are idempotent by contract and always retry a shed;
        # POST callers must opt in explicitly (reads like /query and
        # key translation are safe, imports and messages are not).
        if retry_503 is None:
            retry_503 = method == "GET"
        data, _ = self._request_raw(node, method, path, body,
                                    content_type=content_type,
                                    retry_503=retry_503)
        return json.loads(data) if data else {}

    def _post_import(self, node: Node, req: dict,
                     json_only: bool = False) -> None:
        """POST /internal/import, binary frames first (wire
        .encode_import: raw arrays, ~µs to produce vs a Python json
        walk of millions of ints), falling back to the JSON body once
        if the peer rejects the frame — a not-yet-upgraded node in a
        mixed-version cluster 400s on the magic, and a replicated
        write must not be lost to a rolling upgrade (imports are
        idempotent, so the retry is safe)."""
        if not json_only:
            from pilosa_tpu_torch.server import wire
            try:
                self._request(node, "POST", "/internal/import",
                              wire.encode_import(req),
                              content_type="application/octet-stream")
                return
            except NodeHTTPError as e:
                # Only a 400 can mean "peer doesn't speak the frame
                # format" (an old node's JSON parse fails before any
                # application logic). A 5xx may have PARTIALLY applied —
                # re-sending silently would double-apply clears — and
                # carries no hope that a different encoding succeeds.
                if e.code != 400:
                    raise
        body = dict(req)
        for k in ("rowIDs", "columnIDs", "values"):
            if body.get(k) is not None:
                body[k] = np.asarray(body[k]).tolist()
        self._request(node, "POST", "/internal/import",
                      json.dumps(body).encode())

    # -- multiplexed peer channel --------------------------------------------

    def leg_wire_bytes(self) -> dict | None:
        """Wire bytes of the LAST query leg this thread sent — read by
        the coordinator's per-leg tracing span right after the call."""
        return getattr(self._leg_local, "bytes", None)

    def leg_remote_profile(self) -> dict | None:
        """The remote node's own QueryProfile for the LAST leg this
        thread sent (carried in the frames header when the coordinator
        asked for profiling), or None. Read by map_reduce's per-leg
        profile recorder right after the call returns — remote calls
        are synchronous on the pool thread, so the thread-local stash
        always belongs to the leg just completed."""
        return getattr(self._leg_local, "remote_profile", None)

    def _count_wire(self, n_out: int, n_in: int, decode_ms: float = 0.0):
        st = self.stats
        if st is not None:
            st.count("cluster.wireBytesOut", n_out)
            st.count("cluster.wireBytesIn", n_in)
            if decode_ms:
                st.count("cluster.wireDecodeMs", decode_ms)

    def _mux_allowed(self, node: Node) -> bool:
        env = os.environ.get("PILOSA_TPU_MULTIPLEX", "").strip().lower()
        if env in ("off", "0", "false"):
            return False
        if env in ("on", "1", "true"):
            return node.id not in self._mux_unsupported
        return self.multiplex and node.id not in self._mux_unsupported

    def _channel(self, node: Node) -> _PeerChannel:
        with self._channels_lock:
            ch = self._channels.get(node.id)
            if ch is None:
                ch = self._channels[node.id] = _PeerChannel()
            return ch

    def _send_mux_batch(self, node: Node, batch: list[_MuxLeg]) -> None:
        """Dispatch one multiplexed request carrying every queued leg.

        Runs on ONE submitter thread (the channel's current dispatcher);
        resolves every leg with a frame or an error and never raises —
        a transport failure is every leg's failure, exactly as if each
        had dialed and hit the same dead peer. Per-leg application
        outcomes (503 shed, 404, quarantine) come back inside the
        envelope and are mapped by each leg's own submitter.
        """
        from pilosa_tpu_torch.server import wire
        try:
            if self.breakers is not None:
                self.breakers.check(node.id)
            try:
                self._check_fault(node)
            except ConnectionError as err:
                for leg in batch:
                    leg.error = err
                return
            body = wire.encode_mux_request([leg.to_json() for leg in batch])
            # The envelope waits for its slowest leg: socket timeout is
            # the largest per-leg budget (deadline-capped by callers).
            budget = max((leg.timeout_ms or int(self.timeout * 1000))
                         for leg in batch) / 1000.0
            try:
                status, msg, data = self._http(
                    self._url(node, "/internal/query-mux"), "POST", body,
                    {"Content-Type": wire.MUX_CONTENT_TYPE},
                    timeout=max(0.05, min(self.timeout, budget)))
            except OSError as e:
                if self.breakers is not None:
                    self.breakers.record_failure(node.id)
                err = ConnectionError(f"node {node.id} unreachable: {e}")
                err.__cause__ = e
                for leg in batch:
                    leg.error = err
                return
            if self.breakers is not None:
                # Any HTTP status proves the peer is alive (same rule as
                # _request_raw) — shedding and rejections are app-level.
                self.breakers.record_success(node.id)
            self._count_wire(len(body), len(data))
            if status in (400, 404, 405):
                # The peer predates the mux envelope (no route, or its
                # parser rejects the magic). Remember and fall back to
                # per-query requests — mixed-version clusters must keep
                # answering (same contract as _post_import's 400 rule).
                self._mux_unsupported.add(node.id)
                for leg in batch:
                    leg.error = _MuxUnsupportedError()
                return
            if status >= 400:
                err = NodeHTTPError(
                    status,
                    f"node {node.id} HTTP {status}: "
                    f"{data.decode(errors='replace')}")
                for leg in batch:
                    leg.error = err
                return
            outcomes = wire.decode_mux_response(data)
            if len(outcomes) != len(batch):
                raise ValueError(
                    f"mux response has {len(outcomes)} legs, sent "
                    f"{len(batch)}")
            for leg, o in zip(batch, outcomes):
                if "frame" in o:
                    leg.frame = o["frame"]
                else:
                    leg.error = NodeHTTPError(
                        o["status"],
                        f"node {node.id} HTTP {o['status']}: {o['error']}",
                        retry_after=o.get("retryAfter"))
        except BaseException as e:  # noqa: BLE001 — every leg must resolve
            if self.breakers is not None:
                self.breakers.abort(node.id)
            for leg in batch:
                if leg.frame is None and leg.error is None:
                    leg.error = e

    def _mux_query(self, node: Node, index: str, query: str,
                   shards: list[int] | None):
        """One query leg over the peer's multiplexed channel. Same
        outcome mapping as the per-query path: quarantine -> typed
        ShardCorruptError, shed (503) -> bounded jittered retry, 404 ->
        LookupError. Raises _MuxUnsupportedError for old peers (caller
        falls back per-query)."""
        from pilosa_tpu_torch.obs import tracing
        from pilosa_tpu_torch.server import wire
        want_profile = _profile.current() is not None
        attempt = 0
        while True:
            # Deadline-capped per-leg budget; raises if already expired.
            timeout_ms = int(self._deadline_timeout() * 1000)
            leg = _MuxLeg(index, query, shards, timeout_ms,
                          tracing.current_trace_id(),
                          profile=want_profile)
            self._channel(node).submit(self, node, leg)
            if leg.error is not None:
                e = leg.error
                if isinstance(e, NodeHTTPError) and e.code == 503:
                    if "quarantined" in str(e):
                        from pilosa_tpu_torch.storage.quarantine import (
                            ShardCorruptError,
                        )
                        raise ShardCorruptError() from e
                    if attempt < RETRY_503_ATTEMPTS:
                        delay = self._backoff_delay(attempt, e.retry_after)
                        if delay is not None:
                            time.sleep(delay)
                            attempt += 1
                            continue
                if isinstance(e, NodeHTTPError) and e.code == 404:
                    raise LookupError(f"node {node.id}: {e}") from e
                raise e
            frame = leg.frame
            t0 = time.perf_counter()
            results, header = wire.decode_frames_meta(frame, self.device)
            decode_ms = (time.perf_counter() - t0) * 1000.0
            st = self.stats
            if st is not None:
                st.count("cluster.wireDecodeMs", decode_ms)
            self._leg_local.bytes = {"out": leg.bytes_out,
                                     "in": len(frame),
                                     "decodeMs": decode_ms}
            self._leg_local.remote_profile = header.get("profile")
            return results, _epoch_vector(header.get("shardEpochs"))

    # -- InternalClient protocol -------------------------------------------

    def query_node(self, node: Node, index: str, query: str,
                   shards: list[int] | None, remote: bool = True):
        return self.query_node_meta(node, index, query, shards, remote)[0]

    def query_node_meta(self, node: Node, index: str, query: str,
                        shards: list[int] | None, remote: bool = True):
        """(results, shard-epoch vector): the peer stamps its response
        with the epochs it read before executing (api.py query), which
        feed the coordinator's RemoteEpochTable for cache stamps. Peers
        predating the stamp report {} — the cache just misses."""
        path = f"/index/{index}/query?remote={'true' if remote else 'false'}"
        if shards:
            path += "&shards=" + ",".join(str(s) for s in shards)
        if _profile.current() is not None:
            # The coordinator is profiling: ask the peer to send its own
            # ledger back in the frames header (nested per-leg timeline).
            path += "&profile=true"
        from pilosa_tpu_torch.server import wire
        if remote:
            if self._mux_allowed(node):
                try:
                    return self._mux_query(node, index, query, shards)
                except _MuxUnsupportedError:
                    pass  # old peer; the per-query path below still works
            return self._query_node_frames(node, path, query)
        # Forwarded reads are idempotent POSTs: a shed leg may back off
        # and retry within the deadline budget, same as the remote path.
        resp = self._request(node, "POST", path, query.encode(),
                             retry_503=True)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp["results"], _epoch_vector(resp.get("shardEpochs"))

    def _query_node_frames(self, node: Node, path: str, query: str):
        """Per-query remote leg. Advertises binary-frame support (v2:
        aggregate results ship as typed array blobs too — TopN pairs,
        GroupBy tables, rowid lists; wire.encode_frames): Row results
        come back as roaring blobs instead of JSON int lists (~10-100x
        smaller for large rows). Reads are idempotent, so a shed (503)
        leg may back off and retry."""
        from pilosa_tpu_torch.server import wire
        body = query.encode()
        try:
            data, ctype = self._request_raw(
                node, "POST", path, body,
                accept=wire.FRAMES_ACCEPT_V2, retry_503=True)
        except NodeHTTPError as e:
            if e.code == 503 and "quarantined" in str(e):
                # The peer refused because ITS copy of a shard is
                # corrupt: surface the typed error so the
                # coordinator fails this leg over to a replica.
                from pilosa_tpu_torch.storage.quarantine import ShardCorruptError
                raise ShardCorruptError() from e
            raise
        self._leg_local.bytes = {"out": len(body), "in": len(data)}
        self._leg_local.remote_profile = None
        if ctype.startswith(wire.FRAMES_CONTENT_TYPE):
            t0 = time.perf_counter()
            results, header = wire.decode_frames_meta(data, self.device)
            decode_ms = (time.perf_counter() - t0) * 1000.0
            self._count_wire(len(body), len(data), decode_ms)
            self._leg_local.bytes["decodeMs"] = decode_ms
            self._leg_local.remote_profile = header.get("profile")
            return results, _epoch_vector(header.get("shardEpochs"))
        self._count_wire(len(body), len(data))
        resp = json.loads(data) if data else {}
        if "error" in resp:
            raise RuntimeError(resp["error"])
        self._leg_local.remote_profile = resp.get("profile")
        return ([wire.decode_result(r) for r in resp["results"]],
                _epoch_vector(resp.get("shardEpochs")))

    def fragment_blocks(self, node, index, field, view, shard):
        resp = self._request(
            node, "GET",
            f"/internal/fragment/blocks?index={index}&field={field}"
            f"&view={view}&shard={shard}")
        return {b["id"]: bytes.fromhex(b["checksum"])
                for b in resp.get("blocks", [])}

    def fragment_block_data(self, node, index, field, view, shard, block):
        resp = self._request(
            node, "GET",
            f"/internal/fragment/block/data?index={index}&field={field}"
            f"&view={view}&shard={shard}&block={block}")
        return (np.asarray(resp["rowIDs"], dtype=np.uint64),
                np.asarray(resp["columnIDs"], dtype=np.uint64))

    def import_bits(self, node, index, field, view, shard, rows, cols,
                    clear=False):
        self._post_import(node, {
            "kind": "fragment", "index": index, "field": field,
            "view": view, "shard": shard, "rowIDs": rows,
            "columnIDs": cols, "clear": clear,
        })

    def send_import(self, node, index, field, shard, rows=None, cols=None,
                    values=None, timestamps=None, clear=False):
        req = {"kind": "field", "index": index, "field": field,
               "shard": shard, "rowIDs": rows,
               "columnIDs": cols if cols is not None else [],
               "values": values, "clear": clear}
        if timestamps is not None:
            # Epoch-second ints (or None per element); the wire encoder
            # packs them as a u64 blob with a sentinel for None. An old
            # peer's binary decoder hands the raw array to its timestamp
            # parser, which rejects it (400) before any mutation — the
            # JSON fallback below then carries the ints, which every
            # version's parse_time accepts.
            req["timestamps"] = timestamps
        self._post_import(node, req)

    def send_import_stream(self, node, reqs, chunked: bool = False,
                           qos_class: str | None = None) -> int:
        """POST many shard-batch import requests as ONE pipelined PTS1
        stream (/internal/import-stream): the peer decodes, WAL-appends,
        and device-uploads chunk k while chunk k+1 is still on the wire,
        so the per-request round-trip stops gating bulk ingest.

        Backpressure contract: a 429 reply carries ``{"applied": k}``
        (the server applied a strict prefix and drained the rest) plus
        Retry-After — sleep, then resume from chunk k. Peers that
        400/404/405 the stream (older version: no route, or the parser
        rejects the magic) are remembered and replayed per-batch through
        _post_import — nothing was applied, and imports are idempotent,
        so the replay is safe (same contract as the mux envelope).

        ``chunked=True`` sends chunked transfer-encoding instead of one
        Content-Length body; the server pipelines either way (it reads
        length-prefixed frames incrementally off the socket).

        Returns the number of requests applied (== len(reqs)).
        """
        from pilosa_tpu_torch.server import wire
        reqs = list(reqs)
        if not reqs:
            return 0
        if node.id in self._stream_unsupported:
            for r in reqs:
                self._post_import(node, r)
            return len(reqs)
        start = 0
        stalls = 0
        while start < len(reqs):
            chunks = ([wire.stream_preamble()]
                      + [wire.stream_chunk(r) for r in reqs[start:]]
                      + [wire.stream_end()])
            body = _RewindableChunks(chunks) if chunked else b"".join(chunks)
            if self.breakers is not None:
                self.breakers.check(node.id)
            self._check_fault(node)
            hdrs = {"Content-Type": wire.STREAM_CONTENT_TYPE}
            if qos_class:
                hdrs["X-Qos-Class"] = qos_class
            try:
                status, msg, data = self._http(
                    self._url(node, "/internal/import-stream"), "POST",
                    body, hdrs)
            except OSError as e:
                if self.breakers is not None:
                    self.breakers.record_failure(node.id)
                raise ConnectionError(
                    f"node {node.id} unreachable: {e}") from e
            if self.breakers is not None:
                self.breakers.record_success(node.id)
            self._count_wire(sum(len(c) for c in chunks), len(data))
            if status < 400:
                return len(reqs)
            if status in (400, 404, 405):
                # "applied" in the body means the ROUTE answered: a new
                # server reporting a chunk that failed to apply — not an
                # old peer missing the route. Surface it; only a bare
                # rejection triggers the per-batch fallback.
                try:
                    payload = json.loads(data)
                except (ValueError, TypeError):
                    payload = {}
                if isinstance(payload, dict) and "applied" in payload:
                    raise NodeHTTPError(
                        status, f"node {node.id} HTTP {status}: "
                                f"{data.decode(errors='replace')}")
                self._stream_unsupported.add(node.id)
                for r in reqs[start:]:
                    self._post_import(node, r)
                return len(reqs)
            if status == 429:
                applied = 0
                try:
                    applied = int(json.loads(data).get("applied", 0))
                except (ValueError, TypeError, AttributeError):
                    pass
                start += applied
                # A saturated-but-draining gate makes progress between
                # rounds; zero progress several rounds running means the
                # pipeline is wedged on something else — surface it.
                stalls = 0 if applied else stalls + 1
                if stalls > RETRY_503_ATTEMPTS:
                    raise NodeHTTPError(
                        status,
                        f"node {node.id} ingest backpressure made no "
                        f"progress after {stalls} retries",
                        retry_after=None)
                try:
                    delay = float(msg.get("Retry-After"))
                except (TypeError, ValueError):
                    delay = 1.0
                time.sleep(min(max(delay, 0.0), RETRY_MAX_DELAY))
                continue
            raise NodeHTTPError(
                status, f"node {node.id} HTTP {status}: "
                        f"{data.decode(errors='replace')}")
        return len(reqs)

    def send_message(self, node: Node, message: dict):
        self._request(node, "POST", "/internal/cluster/message",
                      json.dumps(message).encode())

    def send_import_roaring(self, node, index, field, shard, data: bytes,
                            clear=False):
        path = (f"/index/{index}/field/{field}/import-roaring/{shard}"
                f"?remote=true" + ("&clear=true" if clear else ""))
        self._request(node, "POST", path, data)

    # Fragment movement now rides the PTS1 import stream
    # (send_import_stream with qos_class="internal") — the old
    # /internal/fragment/data pull path (fetch_fragment /
    # fetch_fragment_chunks) is gone.

    #: liveness probes use their own short timeout — the general 30s
    #: request timeout would make a blackholed peer stall every
    #: failure-detector sweep for minutes (memberlist probes are
    #: sub-second; confirmNodeDown cluster.go:1724 retries fast).
    PROBE_TIMEOUT = 2.0

    def probe(self, node) -> None:
        """Liveness probe on a FRESH connection, never a pooled one.

        A pooled socket only proves that one socket still works — the
        probe's job is to prove the peer still *accepts* connections. A
        crashed-or-restarted listener can leave old keep-alive sockets
        talking to a stale process on the same address; on probe failure
        the peer's pooled connections are invalidated so data legs can't
        keep riding them either.
        """
        self._check_fault(node)
        url = self._url(node, "/version")
        scheme, host, port, path = _split_url(url)
        timeout = min(self.PROBE_TIMEOUT, self.timeout)
        if scheme == "https":
            conn = http.client.HTTPSConnection(
                host, port, timeout=timeout, context=self._ctx(url))
        else:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            # Any HTTP status counts: alive but unhappy is still alive.
            conn.request("GET", path)
            resp = conn.getresponse()
            resp.read()
        except OSError as e:
            self._pool.invalidate((scheme, host, port))
            raise ConnectionError(f"node {node.id} unreachable: {e}") from e
        finally:
            conn.close()

    def indirect_probe(self, via, target) -> bool:
        """Ask ``via`` to probe ``target`` on our behalf (memberlist's
        indirect ping, gossip/gossip.go:43-443): distinguishes "target
        is dead" from "the link between US and target is down".  True
        iff the intermediary reached the target."""
        try:
            self._check_fault(via)
        except ConnectionError:
            return False  # can't even reach the intermediary
        q = urllib.parse.urlencode({"scheme": target.uri.scheme,
                                    "host": target.uri.host,
                                    "port": target.uri.port})
        url = self._url(via, f"/internal/probe?{q}")
        try:
            status, _, data = self._http(
                url, timeout=min(2 * self.PROBE_TIMEOUT, self.timeout))
            if status >= 400:
                return False
            return bool(json.loads(data or b"{}").get("ok"))
        except (OSError, ValueError):
            return False

    def translate_keys(self, node, index, field, keys):
        # Key translation creates-or-returns the same ids on every
        # call: idempotent, so a shed may back off and retry.
        body = json.dumps({"index": index, "field": field,
                           "keys": list(keys)}).encode()
        resp = self._request(node, "POST", "/internal/translate/keys", body,
                             retry_503=True)
        return resp["ids"]

    def translate_entries(self, node, index, field, after_id):
        path = (f"/internal/translate/entries?index={index}"
                f"&after={int(after_id)}")
        if field:
            path += f"&field={field}"
        resp = self._request(node, "GET", path)
        return [(int(i), k) for i, k in resp["entries"]]

    def nodes(self, node) -> dict:
        """Peer membership pull: {"version", "nodes"} (transitive
        discovery — the memberlist LocalState/MergeRemoteState analog,
        gossip/gossip.go:295-443)."""
        return self._request(node, "GET", "/internal/nodes")

    def availability(self, node) -> dict:
        """Peer per-field shard availability ({index: {field: [shards]}}
        — the additive NodeStatus half, server.go:640)."""
        return self._request(node, "GET", "/internal/availability")

    def debug_query_profile(self, node, trace: str) -> dict | None:
        """One peer's retained profile for ``trace``, or None when that
        peer's ring doesn't have it. ``local=true`` stops the peer from
        fanning out in turn (resolution is one hop, never a cycle)."""
        try:
            return self._request(
                node, "GET", f"/debug/queries/{trace}?local=true")
        except LookupError:
            return None

    def post_schema(self, node, schema: list[dict]) -> None:
        """Push a schema to one peer (reference PostSchema fan-out from
        API.ApplySchema, api.go:747; remote=true stops re-fan-out)."""
        self._request(node, "POST", "/schema?remote=true",
                      json.dumps({"indexes": schema}).encode())

    def schema(self, node) -> list[dict]:
        """Peer schema pull (reference NodeStatus carries Schema;
        server.go:640 handles it on receive)."""
        resp = self._request(node, "GET", "/schema")
        return resp["indexes"]

    def backup_keys(self, node) -> list:
        """Fragment keys a peer holds durable files for (backup
        coordinator enumeration)."""
        resp = self._request(node, "GET", "/internal/backup/keys")
        return resp.get("keys", [])

    def backup_fragment(self, node, index, field, view, shard) -> dict:
        """One fragment's verified (snap, wal) pair from a peer. A 503
        means that copy is quarantined -- surface the typed error so the
        coordinator fails over to a replica."""
        import base64
        q = urllib.parse.urlencode({"index": index, "field": field,
                                    "view": view, "shard": shard})
        try:
            resp = self._request(node, "GET",
                                 f"/internal/backup/fragment?{q}")
        except NodeHTTPError as e:
            if e.code == 503 and "quarantined" in str(e):
                from pilosa_tpu_torch.storage.quarantine import ShardCorruptError
                raise ShardCorruptError() from e
            raise
        return {
            "snap": (base64.b64decode(resp["snap"])
                     if resp.get("snap") else None),
            "wal": (base64.b64decode(resp["wal"])
                    if resp.get("wal") else None),
            "ops": int(resp.get("ops") or 0),
        }

    def attr_blocks(self, node, index, field):
        path = f"/internal/attr/blocks?index={index}"
        if field:
            path += f"&field={field}"
        resp = self._request(node, "GET", path)
        return [(int(b["id"]), bytes.fromhex(b["checksum"]))
                for b in resp["blocks"]]

    def attr_block_data(self, node, index, field, block):
        path = f"/internal/attr/data?index={index}&block={int(block)}"
        if field:
            path += f"&field={field}"
        resp = self._request(node, "GET", path)
        return {int(i): a for i, a in resp["attrs"].items()}
