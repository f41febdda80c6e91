"""Mirrors ``src/repro/launch/fleet/__main__.py`` (only the imports and
the CLI's program name differ).

CLI for the fleet serving subsystem.

Three subcommands::

  # the shared network cache tier (one per fleet; --cache-dir makes
  # the store restart-warm by spilling entries to disk)
  python -m repro_torch.launch.fleet cache-server --port 8790 \
      --cache-dir /tmp/fleet-cache

  # a replica front-end (as many as you like)
  python -m repro_torch.launch.fleet serve --port 8080 \
      --remote-cache http://127.0.0.1:8790 --cache-dir /tmp/ptx-cache

  # self-contained smoke: 1 cache server + 2 replica subprocesses,
  # load-driven over HTTP; exits non-zero on any failure (CI runs this)
  python -m repro_torch.launch.fleet smoke --requests 24 --clients 6

``--port-file PATH`` (serve / cache-server) writes ``{"host", "port",
"pid"}`` JSON once the socket is bound — with ``--port 0`` that is how
a supervisor (or the smoke driver) discovers the ephemeral port.  The
file is written atomically so a poller never sees a partial document.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from typing import Optional, Sequence

from repro_torch.launch.ptx_service import DEFAULT_BENCHES, DEFAULT_MAX_BODY_BYTES


def _write_port_file(path: str, host: str, port: int) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"host": host, "port": port, "pid": os.getpid()}, f)
    os.replace(tmp, path)


def _run_until_interrupted(server, port_file: Optional[str],
                           banner: str) -> None:
    """Serve until SIGINT/SIGTERM, then close (a graceful drain for
    :class:`FleetServer` — queued jobs finish before the compiler
    session shuts down)."""
    def _sigterm(signum, frame):  # noqa: ARG001
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, _sigterm)
    if port_file:
        _write_port_file(port_file, server.host, server.port)
    print(banner, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def _serve_cmd(args) -> None:
    from .frontend import FleetServer

    server = FleetServer(
        host=args.host, port=args.port, cache_dir=args.cache_dir,
        remote_cache=args.remote_cache, jobs=args.jobs,
        selection=args.selection, max_body_bytes=args.max_body_bytes,
        workers=args.workers, queue_capacity=args.queue_capacity,
        batch_window_s=args.batch_window_s, batch_max=args.batch_max,
        deadline_s=args.deadline_s, verbose=args.verbose)
    _run_until_interrupted(
        server, args.port_file,
        f"fleet replica listening on http://{server.host}:{server.port} "
        f"(workers={args.workers} queue={args.queue_capacity} "
        f"disk={args.cache_dir or 'off'} "
        f"remote={args.remote_cache or 'off'})")


def _cache_server_cmd(args) -> None:
    from .remote_cache import CacheTierServer

    server = CacheTierServer(host=args.host, port=args.port,
                             max_bytes=args.max_bytes,
                             cache_dir=args.cache_dir,
                             verbose=args.verbose)
    _run_until_interrupted(
        server, args.port_file,
        f"fleet cache tier listening on {server.url} "
        f"(budget {args.max_bytes} bytes, "
        f"disk={args.cache_dir or 'off'})")


def _smoke_cmd(args) -> None:
    from .smoke import run_smoke

    summary = run_smoke(requests=args.requests, clients=args.clients,
                        benches=args.benches, seed=args.seed,
                        verbose=args.verbose)
    print(json.dumps(summary, indent=2))
    print("fleet smoke OK")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fleet",
        description="Multi-replica PTX compile serving: coalescing "
                    "replica front-ends over a shared network cache "
                    "tier")
    sub = ap.add_subparsers(dest="cmd", required=True)

    serve = sub.add_parser(
        "serve", help="run one replica front-end until interrupted")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=0,
                       help="TCP port (0 = ephemeral; see --port-file)")
    serve.add_argument("--cache-dir", default=None,
                       help="local disk cache tier directory")
    serve.add_argument("--remote-cache", default=None, metavar="URL",
                       help="http://host:port of the fleet cache server")
    serve.add_argument("--jobs", type=int, default=None,
                       help="compiler session pool threads")
    serve.add_argument("--selection", default="all",
                       choices=("all", "cost"))
    serve.add_argument("--workers", type=int, default=4,
                       help="queue-draining worker threads")
    serve.add_argument("--queue-capacity", type=int, default=64,
                       help="bounded queue size (503 when full)")
    serve.add_argument("--batch-window-s", type=float, default=0.005,
                       help="burst-collection window per worker batch")
    serve.add_argument("--batch-max", type=int, default=8,
                       help="max jobs one worker batch absorbs")
    serve.add_argument("--deadline-s", type=float, default=120.0,
                       help="per-request wall budget (504 beyond it)")
    serve.add_argument("--max-body-bytes", type=int,
                       default=DEFAULT_MAX_BODY_BYTES,
                       help="largest request body accepted before 413")
    serve.add_argument("--port-file", default=None,
                       help="write {host, port, pid} JSON here once bound")
    serve.add_argument("--verbose", action="store_true")
    serve.set_defaults(func=_serve_cmd)

    cache = sub.add_parser(
        "cache-server", help="run the shared network cache tier")
    cache.add_argument("--host", default="127.0.0.1")
    cache.add_argument("--port", type=int, default=0,
                       help="TCP port (0 = ephemeral; see --port-file)")
    cache.add_argument("--max-bytes", type=int, default=None,
                       help="LRU byte budget of the in-memory store")
    cache.add_argument("--cache-dir", default=None,
                       help="spill entries to this directory (atomic "
                            "write-through; restart-warm)")
    cache.add_argument("--port-file", default=None,
                       help="write {host, port, pid} JSON here once bound")
    cache.add_argument("--verbose", action="store_true")
    cache.set_defaults(func=_cache_server_cmd)

    smoke = sub.add_parser(
        "smoke", help="boot 1 cache server + 2 replicas as subprocesses "
                      "and load-test them (CI gate)")
    smoke.add_argument("--requests", type=int, default=24,
                       help="requests per load phase")
    smoke.add_argument("--clients", type=int, default=6,
                       help="concurrent client threads")
    smoke.add_argument("--benches", default=DEFAULT_BENCHES)
    smoke.add_argument("--seed", type=int, default=0)
    smoke.add_argument("--verbose", action="store_true")
    smoke.set_defaults(func=_smoke_cmd)

    args = ap.parse_args(argv)
    if args.cmd == "cache-server" and args.max_bytes is None:
        from .remote_cache import DEFAULT_MAX_BYTES
        args.max_bytes = DEFAULT_MAX_BYTES
    args.func(args)


if __name__ == "__main__":
    main()
