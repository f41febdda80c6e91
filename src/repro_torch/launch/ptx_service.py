"""Mirrors ``src/repro/launch/ptx_service.py`` (only the imports differ).

PTX compile service: the driver facade behind an HTTP front-end.

The serving shape the ROADMAP's north star needs, stdlib-only: one
:class:`repro_torch.core.driver.Compiler` session fronting a
``ThreadingHTTPServer``.  Replica processes pointed at one shared
``--cache-dir`` amortize symbolic emulation through the disk-backed
cache tier — the second replica serves every repeated kernel warm from
disk with **zero** re-emulations.

Endpoints
---------

``POST /compile``
    JSON body with exactly one of ``{"ptx": "<text>"}`` or
    ``{"bench": "<kernelgen name>"}``, plus optional per-request
    pipeline ``"options"`` (``max_delta``/``target``/``selection``/
    ``mode``/``lane``).  Responds with the
    :meth:`~repro.core.driver.CompileResult.to_json_dict` payload —
    the PTX is byte-identical to an in-process ``Compiler.compile``.

``POST /lint``
    Same ``{"ptx" | "bench"}`` request shape, but runs only the
    ``verify-ptx`` static analyzer (no compilation, no cache):
    responds with ``{"findings": [...], "counts": {...},
    "clean": bool, "n_kernels": N}`` where ``clean`` means no
    WARNING-or-worse finding.  Optional ``"options"`` take the same
    pipeline fields as ``/compile`` (``lane`` steers the race
    detector's affine addresses).

``GET /stats``
    Session + cache observability: request/error counters, two-tier
    cache stats (memory and ``disk_*``), aggregated pass times, and
    per-code ``lint_*`` finding counters from both compile-path
    ``verify-ptx`` runs and ``/lint`` requests.

``GET /healthz``
    Liveness: ``{"ok": true}``.

CLI modes
---------

::

  # network-facing service (shared disk cache for the replica fleet)
  PYTHONPATH=src python -m repro_torch.launch.ptx_service \
      --serve --port 8080 --cache-dir /var/cache/ptxasw

  # self-hosted throughput benchmark: starts a server, drives N client
  # threads against it over HTTP, reports req/s and cache tiers
  PYTHONPATH=src python -m repro_torch.launch.ptx_service \
      --bench --requests 64 --clients 8 --cache-dir /tmp/ptx-cache

  # legacy in-process demo (submit()/compile_many on one session)
  PYTHONPATH=src python -m repro_torch.launch.ptx_service --requests 64 --jobs 8
"""

from __future__ import annotations

import argparse
import json
import random
import threading
import time
from http.client import BadStatusLine, HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

DEFAULT_BENCHES = ("jacobi,laplacian,gradient,divergence,vecadd,wave13pt")

#: largest request body accepted before answering 413 (a compile
#: request is PTX text plus options; real kernels are kilobytes —
#: anything beyond this is a mistake or a memory-exhaustion attempt)
DEFAULT_MAX_BODY_BYTES = 8 * 1024 * 1024


# ---------------------------------------------------------------------------
# bench-list parsing (shared by CLI and POST /compile)
# ---------------------------------------------------------------------------

def parse_bench_list(spec: str) -> List[str]:
    """Parse a comma list of KernelGen bench names, tolerantly.

    Whitespace around names and empty items (trailing/double commas)
    are dropped; an unknown name fails loudly, naming both the bad
    name and the valid set — the error surfaces at argument time, not
    as a ``KeyError`` deep inside ``get_bench``.
    """
    from repro_torch.core.frontend.kernelgen import APPLICATIONS, SUITE

    names = [part.strip() for part in spec.split(",")]
    names = [n for n in names if n]
    if not names:
        raise ValueError(f"no benchmark names in {spec!r}")
    valid = sorted(set(SUITE) | set(APPLICATIONS))
    unknown = sorted(set(names) - set(valid))
    if unknown:
        raise ValueError(
            f"unknown bench(es) {', '.join(unknown)}; valid: "
            f"{', '.join(valid)}")
    return names


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _ServiceError(Exception):
    """A client-visible request failure (HTTP status + message).

    ``headers`` ride onto the error response — the backpressure path
    uses it for ``Retry-After`` on 503.
    """

    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None) -> None:
        super().__init__(message)
        self.status = status
        self.headers = headers or {}


class _Handler(BaseHTTPRequestHandler):
    # one PtxServiceServer per HTTP server instance
    protocol_version = "HTTP/1.1"

    @property
    def service(self) -> "PtxServiceServer":
        return self.server.service  # type: ignore[attr-defined]

    def log_message(self, fmt, *args) -> None:  # noqa: A003
        if self.service.verbose:
            super().log_message(fmt, *args)

    def _send_json(self, status: int, payload: Dict,
                   headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802
        if self.path == "/healthz":
            self._send_json(200, {"ok": True})
        elif self.path == "/stats":
            self._send_json(200, self.service.stats_payload())
        else:
            self._send_json(404, {"error": f"no such endpoint {self.path};"
                                           " try /compile, /stats, /healthz"})

    def do_POST(self) -> None:  # noqa: N802
        handlers = {"/compile": lambda p: self.service.handle_compile(p),
                    "/lint": lambda p: self.service.handle_lint(p)}
        handler = handlers.get(self.path)
        if handler is None:
            self._send_json(404, {"error": f"no such endpoint {self.path};"
                                           " try /compile, /lint"})
            return
        try:
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                raise _ServiceError(400, "Content-Length is not an integer")
            if length < 0:
                raise _ServiceError(400, "Content-Length is negative")
            if length > self.service.max_body_bytes:
                # refuse *before* buffering: reading an arbitrary body
                # into memory is exactly the attack this cap prevents —
                # and since the body stays unread, the connection cannot
                # be reused
                self.close_connection = True
                raise _ServiceError(
                    413, f"request body of {length} bytes exceeds the "
                         f"{self.service.max_body_bytes}-byte limit")
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                raise _ServiceError(400, f"request body is not JSON: {e}")
            result = handler(payload)
        except _ServiceError as e:
            self.service.count_error()
            self._send_json(e.status, {"error": str(e)}, headers=e.headers)
        except Exception as e:  # noqa: BLE001 — a request must not kill us
            self.service.count_error()
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
        else:
            self._send_json(200, result)


class PtxServiceServer:
    """One compile session behind a threading HTTP server.

    ``port=0`` binds an ephemeral port (``.port`` tells you which).
    ``start()`` serves on a daemon thread (tests/benchmarks);
    ``serve_forever()`` blocks (the ``--serve`` CLI).  Closing shuts
    both the HTTP server and the owned compiler session down.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 compiler=None, cache_dir: Optional[str] = None,
                 remote_cache: Optional[str] = None,
                 jobs: Optional[int] = None, selection: str = "all",
                 max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
                 verbose: bool = False) -> None:
        from repro_torch.core.driver import Compiler

        self.verbose = verbose
        self.max_body_bytes = max_body_bytes
        self._owns_compiler = compiler is None
        if compiler is not None:
            if cache_dir is not None or remote_cache is not None:
                raise ValueError(
                    "pass either compiler= or cache_dir=/remote_cache=, "
                    "not both — the cache tiers belong to the session")
            self.compiler = compiler
        elif remote_cache is not None:
            # tiered fleet cache: memory -> disk (optional) -> remote.
            # Built here rather than inside Compiler so the core stays
            # ignorant of the serving subsystem's network tier.
            from repro_torch.core.passes.cache import CompileCache
            from repro_torch.core.passes.diskcache import DiskCache
            from repro_torch.launch.fleet.remote_cache import RemoteCache
            tiered = CompileCache(
                disk=DiskCache(cache_dir) if cache_dir is not None else None,
                remote=RemoteCache(remote_cache))
            self.compiler = Compiler(jobs=jobs, selection=selection,
                                     cache=tiered)
        else:
            self.compiler = Compiler(jobs=jobs, selection=selection,
                                     cache_dir=cache_dir)
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.service = self          # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._lint_totals: Dict[str, int] = {}   # /lint finding counters
        self._started = time.time()

    # ------------------------------------------------------------------
    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "PtxServiceServer":
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="ptx-service", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever()

    def _shutdown_http(self) -> None:
        """Stop accepting connections (the first half of ``close``;
        the fleet subclass drains its queue between the two halves)."""
        # shutdown() blocks on an event only serve_forever() sets, so
        # calling it on a server whose loop never ran would hang forever
        # (e.g. a `with` body that raises before start())
        if self._serving:
            self._httpd.shutdown()
            self._serving = False
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def close(self) -> None:
        self._shutdown_http()
        if self._owns_compiler:
            self.compiler.close()

    def __enter__(self) -> "PtxServiceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def count_error(self) -> None:
        with self._stats_lock:
            self._errors += 1

    @staticmethod
    def _request_input(payload: Dict) -> Dict:
        """Shared ``/compile`` + ``/lint`` request validation: returns
        ``{"ptx": text | None, "bench": name | None, "options": {...}}``
        with exactly one source set and options field-checked."""
        if not isinstance(payload, dict):
            raise _ServiceError(400, "request body must be a JSON object")
        ptx = payload.get("ptx")
        bench = payload.get("bench")
        if (ptx is None) == (bench is None):
            raise _ServiceError(
                400, 'pass exactly one of "ptx" or "bench"')
        if bench is not None:
            try:
                [bench] = parse_bench_list(str(bench))
            except ValueError as e:
                raise _ServiceError(400, str(e))
        options = payload.get("options") or {}
        if not isinstance(options, dict):
            raise _ServiceError(400, '"options" must be a JSON object')
        from repro_torch.core.driver.options import PIPELINE_FIELDS
        unknown = sorted(set(options) - set(PIPELINE_FIELDS))
        if unknown:
            raise _ServiceError(
                400, f"unknown option(s) {unknown}; requests may set "
                     f"{sorted(PIPELINE_FIELDS)}")
        return {"ptx": ptx, "bench": bench, "options": options}

    def handle_compile(self, payload: Dict) -> Dict:
        """Compile one request payload; raises ``_ServiceError`` on bad
        input so the handler can answer 4xx instead of 500."""
        req = self._request_input(payload)
        if req["bench"] is not None:
            from repro_torch.core.frontend.kernelgen import get_bench
            src = get_bench(req["bench"])
        else:
            src = req["ptx"]
        options = req["options"]
        try:
            result = self.compiler.compile(src, **options)
        except (ValueError, TypeError, KeyError, SyntaxError) as e:
            # bad PTX / bad option values are the client's fault
            raise _ServiceError(400, f"{type(e).__name__}: {e}")
        if not result.reports:
            # the parser is lenient (garbage text yields a kernel-less
            # module); a compile request with nothing to compile is a
            # client error, not an empty success
            raise _ServiceError(400, "input contained no kernels")
        with self._stats_lock:
            self._requests += 1
        return result.to_json_dict()

    def handle_lint(self, payload: Dict) -> Dict:
        """Run the ``verify-ptx`` static analyzer over one request.

        No compilation, no cache: the request's kernels are linted
        directly and the per-code finding counters fold into the
        session totals ``GET /stats`` reports."""
        from repro_torch.core.analysis.findings import Severity, finding_counters
        from repro_torch.core.analysis.lint import lint_kernel
        from repro_torch.core.driver.options import CompilerOptions

        req = self._request_input(payload)
        try:
            config = CompilerOptions().replace(
                **req["options"]).pipeline_config()
        except (ValueError, TypeError) as e:
            raise _ServiceError(400, f"{type(e).__name__}: {e}")
        try:
            if req["bench"] is not None:
                from repro_torch.core.frontend.kernelgen import get_bench
                from repro_torch.core.frontend.stencil import lower_to_ptx
                kernel = lower_to_ptx(get_bench(req["bench"]).program)
                findings = lint_kernel(kernel, config=config,
                                       kernel_name=req["bench"])
                n_kernels = 1
            else:
                from repro_torch.core.ptx.parser import parse
                module = parse(req["ptx"])
                if not module.kernels:
                    raise _ServiceError(400, "input contained no kernels")
                findings = []
                for kernel in module.kernels:
                    findings.extend(lint_kernel(kernel, config=config))
                n_kernels = len(module.kernels)
        except _ServiceError:
            raise
        except (ValueError, TypeError, KeyError, SyntaxError) as e:
            raise _ServiceError(400, f"{type(e).__name__}: {e}")
        counts = finding_counters(findings)
        with self._stats_lock:
            self._requests += 1
            for key, n in counts.items():
                self._lint_totals[key] = self._lint_totals.get(key, 0) + n
        return {
            "findings": [f.to_dict() for f in findings],
            "counts": counts,
            "clean": not any(f.severity >= Severity.WARNING
                             for f in findings),
            "n_kernels": n_kernels,
        }

    def stats_payload(self) -> Dict:
        cc = self.compiler
        disk = cc.cache.disk if cc.cache is not None else None
        remote = getattr(cc.cache, "remote", None) \
            if cc.cache is not None else None
        with self._stats_lock:
            requests, errors = self._requests, self._errors
            lint_totals = dict(self._lint_totals)
        # compile-path verify-ptx counters + /lint endpoint tallies
        for k, v in cc.counters.items():
            if k.startswith("lint_"):
                lint_totals[k] = lint_totals.get(k, 0) + v
        return {
            "ok": True,
            "uptime_s": round(time.time() - self._started, 3),
            "requests": requests,
            "errors": errors,
            "n_runs": cc.n_runs,
            "cache": cc.cache_stats.to_dict(),
            # NB: "entries" walks the cache tree (a few syscalls per
            # entry); "approx_bytes" is the free estimate for pollers
            "disk": None if disk is None else {
                "dir": str(disk.root),
                "entries": len(disk),
                "approx_bytes": disk.approx_bytes,
                "max_bytes": disk.max_bytes,
            },
            # client-side counters of the network tier (gets/hits/
            # misses/puts/errors); the cache server's own totals live
            # on its /stats endpoint
            "remote": None if remote is None else {
                "url": getattr(remote, "url", None),
                **getattr(remote, "counters", {}),
            },
            "pass_times": {k: round(v, 6)
                           for k, v in cc.pass_times.items()},
            # session-aggregated per-kernel report counters: the
            # emulator counters and the equality-saturation middle-end's
            # sat_* counters (empty until a saturate=on compile runs)
            "emulator_counters": {
                k: v for k, v in cc.counters.items()
                if not k.startswith(("sat_", "lint_"))},
            "saturation_counters": {
                k: v for k, v in cc.counters.items()
                if k.startswith("sat_")},
            # verify-ptx findings per code/severity (compile + /lint)
            "lint_counters": lint_totals,
        }


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class BackpressureError(RuntimeError):
    """The service answered 503: its bounded queue is full.

    ``retry_after`` carries the server's ``Retry-After`` hint in
    seconds — callers back off that long and retry instead of piling
    on (the fleet drivers do exactly that).
    """

    def __init__(self, message: str, retry_after: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after = retry_after


#: transport failures that are safe to retry: the request either never
#: reached the server or the connection died before/while the response
#: travelled.  GETs are read-only and POST /compile is content-
#: addressed (recompiling the same source is idempotent by
#: construction), so a duplicate delivery costs a cache hit, not a
#: wrong answer.
_RETRYABLE = (ConnectionRefusedError, ConnectionResetError,
              BrokenPipeError, BadStatusLine, TimeoutError)


class PtxServiceClient:
    """Minimal stdlib client for the service endpoints.

    Transport errors are retried up to ``retries`` times with jittered
    exponential backoff (see ``_RETRYABLE`` for the rationale); HTTP
    error *responses* are never retried here — 503 surfaces as
    :class:`BackpressureError` with the server's ``Retry-After`` so the
    caller owns the pacing decision.  ``counters`` tallies what the
    transport did (``requests`` / ``retries`` / ``backpressure``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 timeout: float = 300.0, *, retries: int = 2,
                 backoff_s: float = 0.05,
                 rng: Optional[random.Random] = None) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self._rng = rng if rng is not None else random.Random()
        self._counter_lock = threading.Lock()
        self._counters = {"requests": 0, "retries": 0, "backpressure": 0}

    @property
    def counters(self) -> Dict[str, int]:
        with self._counter_lock:
            return dict(self._counters)

    def _count(self, name: str) -> None:
        with self._counter_lock:
            self._counters[name] += 1

    def _request_once(self, method: str, path: str,
                      body: Optional[bytes]) -> Dict:
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"}
                         if body else {})
            resp = conn.getresponse()
            data = json.loads(resp.read() or b"{}")
            if resp.status == 503:
                self._count("backpressure")
                try:
                    retry_after = float(
                        resp.getheader("Retry-After") or 1.0)
                except ValueError:
                    retry_after = 1.0
                raise BackpressureError(
                    f"{method} {path} -> HTTP 503: "
                    f"{data.get('error', data)}", retry_after=retry_after)
            if resp.status != 200:
                raise RuntimeError(
                    f"{method} {path} -> HTTP {resp.status}: "
                    f"{data.get('error', data)}")
            return data
        finally:
            conn.close()

    def _request(self, method: str, path: str,
                 payload: Optional[Dict] = None) -> Dict:
        self._count("requests")
        body = json.dumps(payload).encode() if payload is not None else None
        attempt = 0
        while True:
            try:
                return self._request_once(method, path, body)
            except _RETRYABLE as e:
                # a timed-out POST may have been *executed* server-side;
                # /compile and /lint are pure functions of their body
                # (content-addressed / read-only) so replaying is safe —
                # any other POST path must not be replayed blind
                replayable = method != "POST" \
                    or path in ("/compile", "/lint") \
                    or not isinstance(e, TimeoutError)
                if attempt >= self.retries or not replayable:
                    raise
                # full jitter: sleep U(0, backoff · 2^attempt) so a
                # thundering herd of clients retrying a restarted
                # replica spreads out instead of re-colliding
                time.sleep(self._rng.uniform(
                    0, self.backoff_s * (2 ** attempt)))
                attempt += 1
                self._count("retries")

    def compile(self, ptx: Optional[str] = None,
                bench: Optional[str] = None, **options) -> Dict:
        """``POST /compile``; returns the raw result payload dict."""
        payload: Dict = {}
        if ptx is not None:
            payload["ptx"] = ptx
        if bench is not None:
            payload["bench"] = bench
        if options:
            payload["options"] = options
        return self._request("POST", "/compile", payload)

    def compile_result(self, ptx: Optional[str] = None,
                       bench: Optional[str] = None, **options):
        """``POST /compile`` rebuilt into a ``CompileResult``."""
        from repro_torch.core.driver import CompileResult
        return CompileResult.from_json_dict(
            self.compile(ptx=ptx, bench=bench, **options))

    def lint(self, ptx: Optional[str] = None,
             bench: Optional[str] = None, **options) -> Dict:
        """``POST /lint``; returns ``{"findings", "counts", "clean",
        "n_kernels"}``."""
        payload: Dict = {}
        if ptx is not None:
            payload["ptx"] = ptx
        if bench is not None:
            payload["bench"] = bench
        if options:
            payload["options"] = options
        return self._request("POST", "/lint", payload)

    def stats(self) -> Dict:
        return self._request("GET", "/stats")

    def healthz(self) -> bool:
        return bool(self._request("GET", "/healthz").get("ok"))


# ---------------------------------------------------------------------------
# CLI modes
# ---------------------------------------------------------------------------

def drive_requests(client: PtxServiceClient, plan: Sequence[str],
                   clients: int, *,
                   retry_backpressure: bool = False) -> float:
    """Serve every bench name in ``plan`` through ``clients`` concurrent
    client threads; returns wall seconds.  The first worker failure is
    re-raised (shared by the ``--bench`` CLI and benchmark suite E9).
    With ``retry_backpressure`` a 503 is obeyed (sleep ``Retry-After``,
    resubmit) instead of failing the run — the fleet load drivers use
    this to measure a saturated-but-correct server."""
    errors: List[BaseException] = []
    lock = threading.Lock()
    queue = list(plan)
    served = 0

    def worker() -> None:
        nonlocal served
        while True:
            with lock:
                if not queue:
                    return
                name = queue.pop()
            try:
                while True:
                    try:
                        resp = client.compile(bench=name)
                        break
                    except BackpressureError as e:
                        if not retry_backpressure:
                            raise
                        time.sleep(e.retry_after)
                assert resp["reports"][0]["name"] == name
                with lock:
                    served += 1
            except BaseException as e:  # noqa: BLE001
                with lock:
                    errors.append(e)
                return

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, name=f"client-{i}")
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert served == len(plan)
    return wall_s


def _bench_mode(args) -> dict:
    """Self-hosted throughput run: a server plus N HTTP client threads."""
    names = parse_bench_list(args.benches)
    rng = random.Random(args.seed)
    plan = [rng.choice(names) for _ in range(args.requests)]
    with PtxServiceServer(port=args.port, cache_dir=args.cache_dir,
                          jobs=args.jobs, selection=args.selection) as server:
        server.start()
        client = PtxServiceClient(server.host, server.port)
        assert client.healthz(), "service failed /healthz"
        wall_s = drive_requests(client, plan, args.clients)
        stats = client.stats()
        summary = {
            "requests": args.requests,
            "clients": args.clients,
            "distinct_benches": len(set(plan)),
            "wall_s": round(wall_s, 3),
            "req_per_s": round(args.requests / wall_s, 2),
            "cache": stats["cache"],
            "pass_times": stats["pass_times"],
        }
        print(f"served {args.requests} HTTP requests with {args.clients} "
              f"client threads in {wall_s:.3f}s "
              f"({summary['req_per_s']:.1f} req/s)")
        print(f"  cache: {server.compiler.cache_stats.summary}")
        if args.expect_warm_disk:
            _check_warm_disk(server.compiler)
        print("ptx_service bench OK")
        return summary


def _serve_mode(args) -> None:
    server = PtxServiceServer(host=args.host, port=args.port,
                              cache_dir=args.cache_dir,
                              remote_cache=args.remote_cache,
                              jobs=args.jobs, selection=args.selection,
                              max_body_bytes=args.max_body_bytes,
                              verbose=True)
    print(f"ptx_service listening on http://{server.host}:{server.port} "
          f"(cache_dir={args.cache_dir or 'off'})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def _check_warm_disk(compiler) -> None:
    """Assert this process re-emulated nothing: every kernel came from
    the shared disk tier (the two-process acceptance criterion)."""
    emulate_s = compiler.pass_times.get("emulate-flows", 0.0)
    stats = compiler.cache_stats
    assert emulate_s == 0.0, (
        "expected a disk-warm run with zero symbolic emulation, but "
        f"emulate-flows consumed {emulate_s:.3f}s this process")
    assert stats.disk_hits > 0, (
        "expected disk-tier hits in a warm run", stats.summary)
    print(f"  warm-from-disk verified: {stats.disk_hits} disk hit(s), "
          "0 emulations this process")


def _demo_mode(args) -> dict:
    """Legacy in-process demo of the session serving path."""
    from repro_torch.core.driver import Compiler
    from repro_torch.core.frontend.kernelgen import get_bench

    names = parse_bench_list(args.benches)
    rng = random.Random(args.seed)
    requests = [get_bench(rng.choice(names)) for _ in range(args.requests)]

    with Compiler(jobs=args.jobs, selection=args.selection,
                  cache_dir=args.cache_dir) as compiler:
        # async path: every request is its own future on the session pool
        t0 = time.perf_counter()
        futures = [compiler.submit(req) for req in requests[: len(names)]]
        for fut in futures:
            fut.result()
        warm_s = time.perf_counter() - t0

        # batched path: dedup guarantees one emulate/detect per distinct
        # kernel even for a cold cache full of repeats
        t0 = time.perf_counter()
        results = compiler.compile_many(requests)
        batch_s = time.perf_counter() - t0

        stats = compiler.cache_stats
        n_shuffles = sum(r.n_shuffles for r in results)
        distinct = len({r.ptx for r in results})
        summary = {
            "requests": len(requests),
            "distinct_kernels": distinct,
            "shuffles_total": n_shuffles,
            "warm_s": round(warm_s, 3),
            "batch_s": round(batch_s, 3),
            "cache": stats.summary,
            "pass_times": {k: round(v, 4)
                           for k, v in compiler.pass_times.items()},
        }
        print(f"served {len(requests)} requests over {distinct} distinct "
              f"kernels in {batch_s:.3f}s (warm-up {warm_s:.3f}s)")
        print(f"  cache: {stats.summary}")
        print(f"  session pass times: "
              + " ".join(f"{k}={v * 1e3:.1f}ms"
                         for k, v in compiler.pass_times.items()))
        assert stats.misses <= 2 * distinct + len(names), (
            "dedup failed: more cache misses than distinct compile units",
            stats.summary)
        if args.expect_warm_disk:
            _check_warm_disk(compiler)
        else:
            assert compiler.pass_times.get("emulate-flows") is not None \
                or stats.disk_hits > 0, "no emulation and no disk tier?"
        print("ptx_service OK")
        return summary


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(
        description="PTX compile service: HTTP front-end over one "
                    "Compiler session with an optional shared disk cache")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--serve", action="store_true",
                      help="run the HTTP service until interrupted")
    mode.add_argument("--bench", action="store_true",
                      help="self-host a server and drive client threads "
                           "against it over HTTP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral)")
    ap.add_argument("--requests", type=int, default=64,
                    help="total compile requests to serve")
    ap.add_argument("--clients", type=int, default=8,
                    help="client threads for --bench")
    ap.add_argument("--jobs", type=int, default=8,
                    help="session worker threads")
    ap.add_argument("--benches", default=DEFAULT_BENCHES,
                    help="comma list of KernelGen benches to draw from")
    ap.add_argument("--selection", default="all", choices=("all", "cost"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dir", default=None,
                    help="directory of the shared disk cache tier "
                         "(replica fleets point every process here)")
    ap.add_argument("--remote-cache", default=None, metavar="URL",
                    help="http://host:port of a fleet cache server "
                         "(network tier below disk; see "
                         "repro_torch.launch.fleet)")
    ap.add_argument("--max-body-bytes", type=int,
                    default=DEFAULT_MAX_BODY_BYTES,
                    help="largest request body accepted before 413")
    ap.add_argument("--expect-warm-disk", action="store_true",
                    help="assert every kernel came from the disk tier "
                         "with zero emulations (two-process smoke)")
    args = ap.parse_args(argv)

    if not args.serve:
        # validate the bench list at argument time — only this check is
        # a usage error; failures inside the modes keep their traceback
        try:
            parse_bench_list(args.benches)
        except ValueError as e:
            ap.error(str(e))
    if args.serve:
        return _serve_mode(args)
    if args.bench:
        return _bench_mode(args)
    return _demo_mode(args)


if __name__ == "__main__":
    main()
