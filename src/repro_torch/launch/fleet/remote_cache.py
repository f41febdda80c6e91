"""Mirrors ``src/repro/launch/fleet/remote_cache.py``; besides the
imports, the wire form follows the port's disk tier: an entry's URL is
the port's :func:`~repro_torch.core.passes.diskcache.entry_digest`,
which hashes the package name in, and :func:`decode_entry` unpickles
through :func:`~repro_torch.core.passes.diskcache.loads_report`, so a
blob that names a class outside ``repro_torch`` is a miss, never an
import.  One :class:`CacheTierServer` (which stores opaque blobs) can
serve both packages' replicas, and they keep disjoint entries.

Network cache tier: client + server for fleet-wide amortization.

Replicas without a shared filesystem still amortize symbolic emulation:
a :class:`RemoteCache` slots under the disk tier of
:class:`~repro_torch.core.passes.cache.CompileCache` (memory → disk → remote
→ compile) and speaks to a small stdlib :class:`CacheTierServer`.

Wire schema (the same schema-versioned entry form as
:class:`~repro_torch.core.passes.diskcache.DiskCache`, flattened to one JSON
document)::

    GET /entry/<digest>   -> 200 entry JSON | 404
    PUT /entry/<digest>   -> 204 (stored or already present)
    GET /stats            -> server counters (entries, bytes, gets, ...)
    GET /healthz          -> {"ok": true}

    entry JSON = {"schema": <diskcache.SCHEMA_VERSION>,
                  "key":    <logical CompileCache key, debug only>,
                  "ptx":    <printed synthesized kernel>,
                  "report_b64": <base64 pickled KernelReport>}

``<digest>`` is :func:`repro_torch.core.passes.diskcache.entry_digest` —
sha256 over ``schema_version ':' logical_key`` — so a schema bump
changes every URL and stale-format entries miss cleanly instead of
mis-deserializing.  The server stores opaque blobs (it never unpickles
anything); the *client* validates schema and shape on load, and any
corruption or transport failure is a miss, never an exception — a dead
cache server degrades the fleet to local caching.

Trust model: entries carry pickled reports, so point replicas only at
a cache server you run yourself (same trust domain as a shared
``cache_dir``); the server binds loopback by default.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import pickle
import threading
import time
from collections import OrderedDict
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import urlparse

from repro_torch.core.passes.diskcache import (
    SCHEMA_VERSION,
    entry_digest,
    loads_report,
)
from repro_torch.core.ptx.printer import print_kernel

#: default size budget of the in-memory server store (LRU by bytes)
DEFAULT_MAX_BYTES = 256 * 1024 * 1024

#: largest entry blob the server accepts (and the client sends)
MAX_ENTRY_BYTES = 16 * 1024 * 1024


# ---------------------------------------------------------------------------
# wire form
# ---------------------------------------------------------------------------

def encode_entry(key: str, kernel, report) -> bytes:
    """Serialize one cache entry to its wire blob.

    Mirrors ``DiskCache.store``: the pristine (``cached=False``) report
    is stored; the reader re-stamps ``cached=True`` exactly like a
    memory hit.
    """
    if getattr(report, "cached", False):
        report = dataclasses.replace(report, cached=False)
    return json.dumps({
        "schema": SCHEMA_VERSION,
        "key": key,
        "ptx": print_kernel(kernel),
        "report_b64": base64.b64encode(
            pickle.dumps(report,
                         protocol=pickle.HIGHEST_PROTOCOL)).decode(),
    }).encode()


def decode_entry(blob: bytes) -> Optional[Tuple[object, object]]:
    """Deserialize a wire blob to ``(kernel, report)``, or ``None``.

    Anything short of a well-formed current-schema entry — malformed
    JSON, schema drift, unparsable PTX, a non-dataclass report, a report
    that names a class outside ``repro_torch`` — is a miss, never an
    exception (same contract as ``DiskCache.load``).
    """
    try:
        obj = json.loads(blob)
        if obj.get("schema") != SCHEMA_VERSION:
            return None
        from repro_torch.core.ptx.parser import parse
        module = parse(obj["ptx"])
        if len(module.kernels) != 1:
            return None
        report = loads_report(base64.b64decode(obj["report_b64"]))
        if not dataclasses.is_dataclass(report) or isinstance(report, type):
            return None
    except Exception:  # noqa: BLE001 — any corruption is a miss
        return None
    return module.kernels[0], report


# ---------------------------------------------------------------------------
# client (the CompileCache remote= tier)
# ---------------------------------------------------------------------------

def _parse_url(url: str) -> Tuple[str, int]:
    """``http://host:port`` (or bare ``host:port``) -> (host, port)."""
    parsed = urlparse(url if "//" in url else f"http://{url}")
    if parsed.scheme not in ("", "http"):
        raise ValueError(
            f"remote cache URL must be http://, got {url!r}")
    if not parsed.hostname or not parsed.port:
        raise ValueError(
            f"remote cache URL needs host and port, got {url!r}")
    return parsed.hostname, parsed.port


class RemoteCache:
    """Stdlib HTTP client with the ``DiskCache`` ``load``/``store``
    signature, pluggable as ``CompileCache(remote=...)``.

    Every failure mode degrades: transport errors on ``load`` are
    misses, on ``store`` they are silently dropped — both are counted
    (``errors``) so ``/stats`` shows a flapping cache server instead of
    hiding it.
    """

    def __init__(self, url: str, *, timeout: float = 10.0) -> None:
        self.url = url
        self.host, self.port = _parse_url(url)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._counters = {"gets": 0, "hits": 0, "misses": 0,
                          "puts": 0, "errors": 0}

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    @property
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # -- tier interface -------------------------------------------------
    def load(self, key: str) -> Optional[Tuple[object, object]]:
        self._count("gets")
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request("GET", f"/entry/{entry_digest(key)}")
            resp = conn.getresponse()
            blob = resp.read()
            if resp.status != 200:
                self._count("misses")
                return None
        except OSError:
            self._count("errors")
            self._count("misses")
            return None
        finally:
            conn.close()
        loaded = decode_entry(blob)
        self._count("hits" if loaded is not None else "misses")
        return loaded

    def store(self, key: str, kernel, report) -> int:
        """Best-effort write-through; returns 0 (the tier-interface
        eviction count — the server GCs on its own budget)."""
        try:
            blob = encode_entry(key, kernel, report)
        except Exception:  # noqa: BLE001 — unpicklable report: skip
            self._count("errors")
            return 0
        if len(blob) > MAX_ENTRY_BYTES:
            self._count("errors")
            return 0
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request("PUT", f"/entry/{entry_digest(key)}", body=blob,
                         headers={"Content-Type": "application/json",
                                  "Content-Length": str(len(blob))})
            resp = conn.getresponse()
            resp.read()
            if resp.status in (200, 201, 204):
                self._count("puts")
            else:
                self._count("errors")
        except OSError:
            self._count("errors")
        finally:
            conn.close()
        return 0

    # -- observability helpers (tests, smoke) ---------------------------
    def _get_json(self, path: str) -> Dict:
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            payload = json.loads(resp.read() or b"{}")
            if resp.status != 200:
                raise RuntimeError(f"GET {path} -> HTTP {resp.status}: "
                                   f"{payload.get('error', payload)}")
            return payload
        finally:
            conn.close()

    def server_stats(self) -> Dict:
        return self._get_json("/stats")

    def healthz(self) -> bool:
        try:
            return bool(self._get_json("/healthz").get("ok"))
        except OSError:
            return False


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _CacheHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def store(self) -> "CacheTierServer":
        return self.server.tier          # type: ignore[attr-defined]

    def log_message(self, fmt, *args) -> None:  # noqa: A003
        if self.store.verbose:
            super().log_message(fmt, *args)

    def _send(self, status: int, body: bytes,
              content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload: Dict) -> None:
        self._send(status, json.dumps(payload).encode())

    def _digest(self) -> Optional[str]:
        if not self.path.startswith("/entry/"):
            return None
        digest = self.path[len("/entry/"):]
        if len(digest) == 64 and all(c in "0123456789abcdef"
                                     for c in digest):
            return digest
        return None

    def do_GET(self) -> None:  # noqa: N802
        if self.path == "/healthz":
            self._send_json(200, {"ok": True})
            return
        if self.path == "/stats":
            self._send_json(200, self.store.stats_payload())
            return
        digest = self._digest()
        if digest is None:
            self._send_json(404, {"error": f"no such endpoint {self.path};"
                                           " try /entry/<sha256>, /stats,"
                                           " /healthz"})
            return
        blob = self.store.get(digest)
        if blob is None:
            self._send_json(404, {"error": "no such entry"})
        else:
            self._send(200, blob)

    def do_PUT(self) -> None:  # noqa: N802
        digest = self._digest()
        if digest is None:
            self._send_json(404, {"error": "PUT targets /entry/<sha256>"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self._send_json(400, {"error": "bad Content-Length"})
            return
        if length <= 0:
            self._send_json(400, {"error": "missing request body"})
            return
        if length > MAX_ENTRY_BYTES:
            self.close_connection = True   # don't read a huge body
            self._send_json(413, {"error": f"entry exceeds "
                                           f"{MAX_ENTRY_BYTES} bytes"})
            return
        self.store.put(digest, self.rfile.read(length))
        self._send(204, b"")


class CacheTierServer:
    """The fleet's shared in-memory blob store behind HTTP.

    Content-addressed and opaque: keys are digests, values are entry
    blobs it never deserializes.  The store is LRU-bounded by bytes
    (``max_bytes``); a GET refreshes recency, so hot kernels survive a
    scan of cold ones — the same policy as the memory/disk tiers.

    With ``cache_dir`` the store also spills to disk: every PUT is
    written through to ``<cache_dir>/<digest>.entry`` (atomic
    tmp+rename, so a crashed writer never leaves a torn blob), and a
    memory miss reads through the directory and promotes the blob back
    into the LRU.  Memory stays the bounded hot set; the directory is
    the durable superset, so a restarted server answers from a warm
    floor instead of forcing the whole fleet to recompile.  Disk I/O
    failures are counted (``disk_errors``) and degrade to the
    in-memory-only behaviour, never an HTTP error.

    ``port=0`` binds an ephemeral port; ``start()`` serves on a daemon
    thread; ``serve_forever()`` blocks (the CLI).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 cache_dir: Optional[str] = None,
                 verbose: bool = False) -> None:
        self.max_bytes = max_bytes
        self.cache_dir = cache_dir
        self.verbose = verbose
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
        self._entries: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._gets = 0
        self._hits = 0
        self._puts = 0
        self._evictions = 0
        self._disk_hits = 0
        self._disk_puts = 0
        self._disk_errors = 0
        self._started = time.time()
        self._httpd = ThreadingHTTPServer((host, port), _CacheHandler)
        self._httpd.daemon_threads = True
        self._httpd.tier = self              # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    # -- store ----------------------------------------------------------
    def _disk_path(self, digest: str) -> str:
        return os.path.join(self.cache_dir, f"{digest}.entry")

    def _insert_locked(self, digest: str, blob: bytes) -> None:
        old = self._entries.pop(digest, None)
        if old is not None:
            self._bytes -= len(old)
        self._entries[digest] = blob
        self._bytes += len(blob)
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            _, evicted = self._entries.popitem(last=False)
            self._bytes -= len(evicted)
            self._evictions += 1

    def get(self, digest: str) -> Optional[bytes]:
        with self._lock:
            self._gets += 1
            blob = self._entries.get(digest)
            if blob is not None:
                self._hits += 1
                self._entries.move_to_end(digest)    # a hit is a touch
                return blob
            if self.cache_dir is None:
                return None
            try:
                with open(self._disk_path(digest), "rb") as f:
                    blob = f.read()
            except FileNotFoundError:
                return None
            except OSError:
                self._disk_errors += 1
                return None
            self._hits += 1
            self._disk_hits += 1
            self._insert_locked(digest, blob)        # promote to hot set
            return blob

    def put(self, digest: str, blob: bytes) -> None:
        with self._lock:
            self._puts += 1
            self._insert_locked(digest, blob)
            if self.cache_dir is None:
                return
            path = self._disk_path(digest)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)
                self._disk_puts += 1
            except OSError:
                self._disk_errors += 1
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats_payload(self) -> Dict:
        with self._lock:
            payload = {
                "ok": True,
                "uptime_s": round(time.time() - self._started, 3),
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "gets": self._gets,
                "hits": self._hits,
                "puts": self._puts,
                "evictions": self._evictions,
            }
            if self.cache_dir is not None:
                try:
                    n_disk = sum(1 for f in os.listdir(self.cache_dir)
                                 if f.endswith(".entry"))
                except OSError:
                    n_disk = -1
                payload.update(cache_dir=self.cache_dir,
                               disk_entries=n_disk,
                               disk_hits=self._disk_hits,
                               disk_puts=self._disk_puts,
                               disk_errors=self._disk_errors)
            return payload

    # -- lifecycle (mirrors PtxServiceServer) ---------------------------
    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "CacheTierServer":
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="cache-tier", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever()

    def close(self) -> None:
        if self._serving:
            self._httpd.shutdown()
            self._serving = False
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "CacheTierServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
