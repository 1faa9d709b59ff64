"""ObjectArchiveStore — S3-compatible HTTP backend for ArchiveStore.

The port's counterpart of pilosa_tpu/backup/objstore.py, the same module.

The remote archive is the first dependency that fails *partially*:
timeouts, 5xx storms, torn uploads. This backend gives the backup path
the same discipline the query path already has:

- every operation runs under a per-op timeout and a bounded full-jitter
  retry loop (the ``httpclient`` 503 curve, honoring Retry-After) so a
  transient storm costs latency, not a failed backup;
- every object carries its content CRC as metadata, verified on read —
  a damaged or torn download is retried, then refused, never trusted;
- writes go to a *tmp key* first and are finalized with a server-side
  copy to the real key, so a torn upload is never visible as a real
  object (``list_backups`` and reads only ever see finalized keys),
  preserving the manifest-written-last completeness contract end to
  end.

Key layout inside the bucket mirrors ``LocalDirArchive``::

    <prefix><backup_id>/manifest.json
    <prefix><backup_id>/data/<index>/<field>/<view>/<shard>.snap
    ...

URL scheme (also accepted by ``--archive-url``, ``check --archive``
and ``backup-verify``)::

    http://host:port/bucket[/prefix]    -> ObjectArchiveStore
    https://host:port/bucket[/prefix]   -> ObjectArchiveStore
    file:///path  or  /plain/path       -> LocalDirArchive
"""

from __future__ import annotations

import http.client
import random
import socket
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from pilosa_tpu_torch.backup.archive import (
    MANIFEST_NAME,
    ArchiveStore,
    BackupError,
    LocalDirArchive,
    file_crc,
)

#: the retry curve of the JAX package's query path
#: (pilosa_tpu/server/httpclient.py; its inter-node client comes to the
#: port with ROADMAP.md Queue 1 item 6): full jitter over an exponential
#: cap, base and cap in seconds.
RETRY_BASE_DELAY = 0.1
RETRY_MAX_DELAY = 5.0

#: metadata header carrying the object's content CRC (S3 user metadata)
CRC_HEADER = "x-amz-meta-crc32"
#: marker segment in tmp keys; anything carrying it is an unfinalized
#: upload and invisible to read/exists/list.
TMP_MARKER = ".tmp-"

#: default attempts per operation (first try + retries)
DEFAULT_ATTEMPTS = 6
#: default per-op socket timeout, seconds
DEFAULT_TIMEOUT = 10.0

#: statuses worth retrying: server-side trouble or explicit backpressure
_RETRY_STATUSES = frozenset({429, 500, 502, 503, 504})

_CONN_ERRORS = (ConnectionError, socket.timeout, TimeoutError, OSError,
                http.client.HTTPException)


class _RetryableDamage(Exception):
    """A read came back bytes-complete but wrong (CRC/length mismatch):
    could be a torn transfer, worth the remaining retry budget."""


def parse_archive_url(url: str) -> tuple[str, str, int, str, str]:
    """-> (scheme, host, port, bucket, key_prefix).

    The first path segment is the bucket; the rest is an optional key
    prefix ('' or 'a/b/'). Raises BackupError for anything that isn't
    http(s) with a bucket."""
    u = urllib.parse.urlsplit(url)
    if u.scheme not in ("http", "https"):
        raise BackupError(f"archive url {url!r}: want http(s)://host/bucket")
    if not u.hostname:
        raise BackupError(f"archive url {url!r}: missing host")
    path = u.path.strip("/")
    if not path:
        raise BackupError(f"archive url {url!r}: missing bucket")
    bucket, _, prefix = path.partition("/")
    port = u.port or (443 if u.scheme == "https" else 80)
    return u.scheme, u.hostname, port, bucket, \
        (prefix + "/" if prefix else "")


def open_archive(root, stats=None, **kwargs) -> ArchiveStore:
    """Archive factory behind every operator knob (``--archive-url``,
    ``check --archive``, ``backup-verify``, POST /backup): an http(s)
    URL opens an object store, anything else a local directory. An
    ArchiveStore instance passes through untouched."""
    if isinstance(root, ArchiveStore):
        return root
    if not isinstance(root, str) or not root:
        raise BackupError("archive: path or http(s) URL required")
    if root.startswith(("http://", "https://")):
        return ObjectArchiveStore(root, stats=stats, **kwargs)
    if root.startswith("file://"):
        root = urllib.parse.urlsplit(root).path
    return LocalDirArchive(root)


class ObjectArchiveStore(ArchiveStore):
    """S3-compatible object store behind the ArchiveStore interface.

    One persistent connection (serialized behind a lock), re-dialed on
    failure; every op is bounded by ``timeout`` and retried up to
    ``attempts`` times with full jitter. Counters (``archive.retries``,
    ``archive.bytesOut``, ``archive.bytesIn``) surface on /debug/vars
    and /metrics when a stats registry is attached."""

    def __init__(self, url: str, stats=None, timeout: float = DEFAULT_TIMEOUT,
                 attempts: int = DEFAULT_ATTEMPTS, rng=None):
        self.url = url.rstrip("/")
        (self.scheme, self.host, self.port,
         self.bucket, self.prefix) = parse_archive_url(url)
        self.stats = stats
        self.timeout = timeout
        self.attempts = max(1, attempts)
        self._rng = rng or random.Random()
        self._conn: http.client.HTTPConnection | None = None
        self._lock = threading.Lock()

    # -- plumbing -----------------------------------------------------------

    def _count(self, name: str, value: int = 1) -> None:
        if self.stats is not None:
            self.stats.count(name, value)

    def _obj_key(self, backup_id: str, rel_path: str) -> str:
        # Ids and paths come from manifests and operators: refuse
        # anything that could escape the prefix (mirrors the
        # LocalDirArchive traversal guard).
        if ("/" in backup_id or backup_id in ("", ".", "..")
                or rel_path.startswith("/")
                or ".." in rel_path.split("/")):
            raise BackupError(f"archive path escapes root: "
                              f"{backup_id!r}/{rel_path!r}")
        return f"{self.prefix}{backup_id}/{rel_path}"

    def _obj_path(self, key: str) -> str:
        return f"/{self.bucket}/" + urllib.parse.quote(key)

    def _dial(self) -> http.client.HTTPConnection:
        cls = (http.client.HTTPSConnection if self.scheme == "https"
               else http.client.HTTPConnection)
        return cls(self.host, self.port, timeout=self.timeout)

    def _backoff(self, attempt: int, retry_after: float | None) -> float:
        cap = min(RETRY_MAX_DELAY, RETRY_BASE_DELAY * (2 ** attempt))
        delay = self._rng.uniform(0, cap)
        if retry_after is not None:
            # The server knows its queue better than our curve does;
            # keep jitter on top so retries don't synchronize.
            delay = retry_after + self._rng.uniform(0, cap)
        return delay

    def _request(self, method: str, path: str, body: bytes | None = None,
                 headers: dict | None = None,
                 ok_statuses: tuple = (200,),
                 not_found_ok: bool = False):
        """One logical op = up to ``attempts`` wire tries. Returns
        (status, lowercased response headers, body bytes); 404 comes
        back (instead of raising) only when ``not_found_ok``. Raises
        BackupError on exhaustion or a non-retryable status."""
        last_err = "unknown"
        with self._lock:
            for attempt in range(self.attempts):
                if attempt:
                    self._count("archive.retries")
                conn, self._conn = self._conn or self._dial(), None
                try:
                    conn.request(method, path, body=body,
                                 headers=headers or {})
                    resp = conn.getresponse()
                    data = resp.read()
                    status = resp.status
                    resp_headers = {k.lower(): v
                                    for k, v in resp.getheaders()}
                except _CONN_ERRORS as e:
                    conn.close()
                    last_err = f"{type(e).__name__}: {e}"
                    time.sleep(self._backoff(attempt, None))
                    continue
                self._conn = conn
                if status in ok_statuses or (status == 404 and not_found_ok):
                    return status, resp_headers, data
                last_err = (f"HTTP {status}: "
                            f"{data[:200].decode(errors='replace')}")
                if status not in _RETRY_STATUSES:
                    break  # other 4xx: retrying won't change the answer
                ra = resp_headers.get("retry-after")
                try:
                    retry_after = float(ra) if ra is not None else None
                except ValueError:
                    retry_after = None
                time.sleep(self._backoff(attempt, retry_after))
        raise BackupError(
            f"object store {method} {path!r} failed after "
            f"{self.attempts} attempt(s): {last_err}")

    # -- ArchiveStore interface ---------------------------------------------

    def write(self, backup_id: str, rel_path: str, data: bytes) -> None:
        key = self._obj_key(backup_id, rel_path)
        crc = file_crc(data)
        headers = {"Content-Length": str(len(data)), CRC_HEADER: str(crc)}
        # tmp-key + finalize: a torn upload leaves only an unfinalized
        # tmp object that read/exists/list never surface; the object
        # becomes real only through the server-side copy, which starts
        # from a fully-received tmp body.
        tmp = f"{key}{TMP_MARKER}{uuid.uuid4().hex[:8]}"
        self._request("PUT", self._obj_path(tmp), body=data, headers=headers)
        self._request("PUT", self._obj_path(key), body=b"", headers={
            "Content-Length": "0",
            "x-amz-copy-source": self._obj_path(tmp),
        })
        self._count("archive.bytesOut", len(data))
        try:
            self._request("DELETE", self._obj_path(tmp),
                          ok_statuses=(200, 204), not_found_ok=True)
        except BackupError:
            pass  # orphaned tmp key: invisible to reads and listings

    def read(self, backup_id: str, rel_path: str) -> bytes:
        key = self._obj_key(backup_id, rel_path)
        last = "unknown"
        for attempt in range(self.attempts):
            _, resp_headers, data = self._request("GET", self._obj_path(key))
            try:
                self._verify_read(resp_headers, data)
            except _RetryableDamage as e:
                last = str(e)
                self._count("archive.retries")
                time.sleep(self._backoff(attempt, None))
                continue
            self._count("archive.bytesIn", len(data))
            return data
        raise BackupError(f"object store GET {key!r}: {last}")

    def _verify_read(self, resp_headers: dict, data: bytes) -> None:
        want_len = resp_headers.get("content-length")
        if want_len is not None and int(want_len) != len(data):
            raise _RetryableDamage(
                f"torn download: got {len(data)} of {want_len} bytes")
        want_crc = resp_headers.get(CRC_HEADER)
        if want_crc is not None and int(want_crc) != file_crc(data):
            raise _RetryableDamage(
                f"content CRC mismatch (want {want_crc}, "
                f"got {file_crc(data)})")

    def exists(self, backup_id: str, rel_path: str) -> bool:
        key = self._obj_key(backup_id, rel_path)
        status, _, _ = self._request("HEAD", self._obj_path(key),
                                     not_found_ok=True)
        return status == 200

    def delete(self, backup_id: str, rel_path: str) -> None:
        key = self._obj_key(backup_id, rel_path)
        self._request("DELETE", self._obj_path(key),
                      ok_statuses=(200, 204), not_found_ok=True)

    def list_backups(self) -> list[str]:
        out = []
        for key in self._list_keys(self.prefix):
            # A backup is real iff its FINALIZED manifest object exists
            # directly under <prefix><id>/ — the completeness contract.
            rest = key[len(self.prefix):]
            parts = rest.split("/")
            if len(parts) == 2 and parts[1] == MANIFEST_NAME:
                out.append(parts[0])
        return sorted(out)

    def delete_backup(self, backup_id: str) -> None:
        """Remove every object of a backup, manifest FIRST: the backup
        drops out of list_backups before any payload byte goes, so a
        crash mid-delete leaves only complete, restorable listings."""
        prefix = self._obj_key(backup_id, "x")[:-1]
        keys = self._list_keys(prefix)
        keys.sort(key=lambda k: (not k.endswith("/" + MANIFEST_NAME), k))
        for key in keys:
            self._request("DELETE", self._obj_path(key),
                          ok_statuses=(200, 204), not_found_ok=True)

    # -- listing ------------------------------------------------------------

    def _list_keys(self, prefix: str) -> list[str]:
        """All finalized keys under ``prefix`` (ListObjectsV2, paged)."""
        keys: list[str] = []
        token = None
        while True:
            q = f"list-type=2&prefix={urllib.parse.quote(prefix)}"
            if token:
                q += f"&continuation-token={urllib.parse.quote(token)}"
            _, _, body = self._request("GET", f"/{self.bucket}?{q}")
            try:
                root = ET.fromstring(body.decode())
            except ET.ParseError as e:
                raise BackupError(
                    f"object store list: unparseable response: {e}") from e
            for el in root.iter():
                if el.tag.endswith("Key") and el.text \
                        and TMP_MARKER not in el.text:
                    keys.append(el.text)
            truncated = next((el.text for el in root.iter()
                              if el.tag.endswith("IsTruncated")), "false")
            token = next((el.text for el in root.iter()
                          if el.tag.endswith("NextContinuationToken")), None)
            if truncated != "true" or not token:
                return keys

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
