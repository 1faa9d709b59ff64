"""Test-only archive fault injection (``storage/faults.py`` style).

The port's counterpart of pilosa_tpu/backup/faults.py, the same module.

Two layers, matching where real archives fail:

- ``FakeObjectServer`` — an in-process S3-compatible object server
  (stdlib http.server) with injectable *wire* faults: latency, 5xx
  error storms with Retry-After, probabilistic per-request failures,
  torn uploads (half the body lands, the connection dies), and
  corrupted downloads (bytes change, the CRC metadata doesn't). The
  dr_drill scenario and the objstore tests run against it.
- ``FaultyArchive`` — a wrapper over any ArchiveStore injecting
  *interface-level* faults (one-shot armed or probabilistic), for
  scheduler-backoff and retention tests that don't need a wire.

Deterministic: every probabilistic knob draws from a seeded
``random.Random``. Production code never imports this module.
"""

from __future__ import annotations

import random
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pilosa_tpu_torch.backup.archive import ArchiveStore, BackupError


class _ObjHandler(BaseHTTPRequestHandler):
    """S3-ish surface: PUT (incl. x-amz-copy-source), GET, HEAD,
    DELETE on /bucket/key; GET /bucket?list-type=2 for listing."""

    protocol_version = "HTTP/1.1"
    server: "FakeObjectServer"

    def log_message(self, fmt, *args):  # noqa: ARG002 - quiet by design
        pass

    # -- helpers ------------------------------------------------------------

    def _key(self) -> tuple[str, str]:
        """(key-within-bucket, raw query) — any bucket name accepted."""
        path, _, query = self.path.partition("?")
        path = urllib.parse.unquote(path).lstrip("/")
        _bucket, _, key = path.partition("/")
        return key, query

    def _reply(self, status: int, body: bytes = b"",
               headers: dict | None = None) -> None:
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        # A HEAD reply has no body: one left on a keep-alive connection
        # would be read as the start of the next reply's status line.
        if self.command != "HEAD":
            self.wfile.write(body)

    def _faulted(self) -> bool:
        """Apply the server's armed wire faults; True when this request
        was consumed by one (a response — or its absence — went out)."""
        srv = self.server
        with srv.lock:
            if srv.latency_s:
                delay = srv.latency_s
            else:
                delay = 0.0
            if srv.error_burst_left > 0:
                srv.error_burst_left -= 1
                srv.injected += 1
                status = srv.error_burst_status
            elif srv.fail_rate and srv.rng.random() < srv.fail_rate:
                srv.injected += 1
                status = 503
            else:
                status = 0
        if delay:
            time.sleep(delay)
        if status:
            # Drain any request body first: an unread PUT body would be
            # parsed as the next request line on this keep-alive
            # connection and turn the injected 5xx into a bogus 501.
            length = int(self.headers.get("Content-Length", 0))
            if length:
                self.rfile.read(length)
            self._reply(status, b"injected fault",
                        {"Retry-After": "0.01"})
            return True
        return False

    # -- methods ------------------------------------------------------------

    def do_PUT(self):  # noqa: N802 - http.server API
        srv = self.server
        srv.requests += 1
        if self._faulted():
            return
        key, _ = self._key()
        src = self.headers.get("x-amz-copy-source")
        if src is not None:
            src_key = urllib.parse.unquote(src).lstrip("/") \
                .partition("/")[2]
            with srv.lock:
                if src_key not in srv.objects:
                    self._reply(404, b"no such copy source")
                    return
                srv.objects[key] = srv.objects[src_key]
            self._reply(200, b"<CopyObjectResult/>")
            return
        length = int(self.headers.get("Content-Length", 0))
        meta = {k.lower(): v for k, v in self.headers.items()
                if k.lower().startswith("x-amz-meta-")}
        with srv.lock:
            torn = srv.torn_next_put > 0
            if torn:
                srv.torn_next_put -= 1
                srv.torn += 1
        if torn:
            # Half the body lands, then the connection dies without a
            # response — the classic torn upload. The half-object is
            # stored (a real store would keep the received bytes too);
            # only the tmp-key+finalize protocol keeps it invisible.
            half = self.rfile.read(length // 2)
            with srv.lock:
                srv.objects[key] = (half, meta)
            self.close_connection = True
            return
        body = self.rfile.read(length)
        with srv.lock:
            srv.objects[key] = (body, meta)
        self._reply(200)

    def do_GET(self):  # noqa: N802
        srv = self.server
        srv.requests += 1
        if self._faulted():
            return
        key, query = self._key()
        params = urllib.parse.parse_qs(query)
        if "list-type" in params:
            self._reply(200, srv.render_listing(
                params.get("prefix", [""])[0],
                params.get("continuation-token", [None])[0]),
                {"Content-Type": "application/xml"})
            return
        with srv.lock:
            obj = srv.objects.get(key)
            corrupt = srv.corrupt_next_get > 0
            if obj is not None and corrupt:
                srv.corrupt_next_get -= 1
                srv.injected += 1
        if obj is None:
            self._reply(404, b"no such key")
            return
        data, meta = obj
        if corrupt and data:
            # Flip one bit; the stored CRC metadata still describes the
            # original — the client-side verify must catch this.
            i = srv.rng.randrange(len(data))
            data = data[:i] + bytes([data[i] ^ 0x40]) + data[i + 1:]
        self._reply(200, data, dict(meta))

    def do_HEAD(self):  # noqa: N802
        srv = self.server
        srv.requests += 1
        if self._faulted():
            return
        key, _ = self._key()
        with srv.lock:
            obj = srv.objects.get(key)
        if obj is None:
            self._reply(404)
            return
        # HEAD: headers only; Content-Length advertises the body size.
        self.send_response(200)
        for k, v in obj[1].items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(obj[0])))
        self.end_headers()

    def do_DELETE(self):  # noqa: N802
        srv = self.server
        srv.requests += 1
        if self._faulted():
            return
        key, _ = self._key()
        with srv.lock:
            existed = srv.objects.pop(key, None) is not None
        self._reply(204 if existed else 404)


class FakeObjectServer(ThreadingHTTPServer):
    """In-process object store on a loopback port.

    Fault knobs (all safe to flip while serving):
      fail_rate        probability any request 503s (seeded rng)
      error_burst(n)   next n requests fail with the given status
      latency_s        added per-request delay
      torn_next_put    next n PUTs store half the body and drop the line
      corrupt_next_get next n GETs serve flipped bytes under a stale CRC
    """

    daemon_threads = True

    def __init__(self, seed: int = 0):
        super().__init__(("127.0.0.1", 0), _ObjHandler)
        self.lock = threading.Lock()
        self.objects: dict[str, tuple[bytes, dict]] = {}
        self.rng = random.Random(seed)
        self.fail_rate = 0.0
        self.error_burst_left = 0
        self.error_burst_status = 500
        self.latency_s = 0.0
        self.torn_next_put = 0
        self.corrupt_next_get = 0
        self.max_keys_page = 1000
        self.requests = 0
        self.injected = 0
        self.torn = 0
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="fake-objstore", daemon=True)
        self._thread.start()

    def url(self, bucket: str = "drill", prefix: str = "") -> str:
        host, port = self.server_address[:2]
        u = f"http://{host}:{port}/{bucket}"
        return f"{u}/{prefix}" if prefix else u

    def error_burst(self, n: int, status: int = 500) -> None:
        with self.lock:
            self.error_burst_left = n
            self.error_burst_status = status

    def render_listing(self, prefix: str, token: str | None) -> bytes:
        """ListObjectsV2 XML, paged at ``max_keys_page`` keys with
        start-after continuation semantics."""
        with self.lock:
            keys = sorted(k for k in self.objects if k.startswith(prefix))
            page = self.max_keys_page
        if token:
            keys = [k for k in keys if k > token]
        batch, rest = keys[:page], keys[page:]
        parts = ["<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
                 "<ListBucketResult>",
                 f"<IsTruncated>{'true' if rest else 'false'}"
                 f"</IsTruncated>"]
        if rest:
            parts.append(f"<NextContinuationToken>{batch[-1]}"
                         f"</NextContinuationToken>")
        for k in batch:
            parts.append(f"<Contents><Key>{k}</Key></Contents>")
        parts.append("</ListBucketResult>")
        return "".join(parts).encode()

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        self._thread.join(timeout=10)


class FaultyArchive(ArchiveStore):
    """ArchiveStore wrapper injecting interface-level faults: arm
    ``fail_next_ops`` for a deterministic burst (one-shot, counts
    down) or set ``fail_rate`` for a seeded probabilistic storm."""

    def __init__(self, inner: ArchiveStore, seed: int = 42):
        self.inner = inner
        self.fail_next_ops = 0
        self.fail_rate = 0.0
        self.faults_injected = 0
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def _maybe_fail(self, op: str) -> None:
        with self._lock:
            if self.fail_next_ops > 0:
                self.fail_next_ops -= 1
            elif not (self.fail_rate
                      and self._rng.random() < self.fail_rate):
                return
            self.faults_injected += 1
        raise BackupError(f"injected archive fault: {op}")

    def write(self, backup_id, rel_path, data):
        self._maybe_fail(f"write {rel_path}")
        return self.inner.write(backup_id, rel_path, data)

    def read(self, backup_id, rel_path):
        self._maybe_fail(f"read {rel_path}")
        return self.inner.read(backup_id, rel_path)

    def exists(self, backup_id, rel_path):
        self._maybe_fail(f"exists {rel_path}")
        return self.inner.exists(backup_id, rel_path)

    def list_backups(self):
        self._maybe_fail("list_backups")
        return self.inner.list_backups()

    def delete(self, backup_id, rel_path):
        self._maybe_fail(f"delete {rel_path}")
        return self.inner.delete(backup_id, rel_path)

    def delete_backup(self, backup_id):
        self._maybe_fail(f"delete_backup {backup_id}")
        return self.inner.delete_backup(backup_id)
