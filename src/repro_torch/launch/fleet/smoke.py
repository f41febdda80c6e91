"""Mirrors ``src/repro/launch/fleet/smoke.py``; besides the imports, the
children run ``python -m repro_torch.launch.fleet`` with the parent of
``repro_torch`` on their ``PYTHONPATH``, and the summary carries more of
what the assertions read, so a caller can hold the contracts itself:
req/s and the total latency of every load phase (the coalesce phase's
from its own requests' times), and the warm-remote phase's distinct
sources and ``emulate-flows`` seconds.

Subprocess fleet smoke: the PR's acceptance load test, runnable
anywhere (CI runs ``python -m repro_torch.launch.fleet smoke``).

Boots real OS processes — one :class:`CacheTierServer` and two
:class:`FleetServer` replicas with *separate* disk caches — then
drives load over HTTP and asserts the fleet contracts:

* **cold** — replica A serves a randomized bench plan; no 5xx at all
  (the driver raises on any non-503 error status, and A's queue is
  sized so no deliberate 503 happens either);
* **coalesce** — K concurrent identical requests for a bench A has
  never seen: exactly one new cache miss (one ``emulate-flows`` run)
  and K byte-identical response payloads;
* **warm-remote** — replica B (own empty disk!) serves the same plan
  with **zero** local emulation: every kernel arrives through the
  network cache tier;
* **backpressure** — a deliberately tiny replica C (1 worker, queue
  capacity 1) under concurrent load answers 503 + ``Retry-After``;
  obeying clients still get every request served;
* **drain** — SIGTERM on every process exits 0 (graceful shutdown).

Returns the summary dict the benchmark snapshot stores (req/s and
latency percentiles per phase, plus the counters the assertions used).
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.launch.ptx_service import (
    DEFAULT_BENCHES,
    PtxServiceClient,
    drive_requests,
    parse_bench_list,
)

from .stats import LatencyHistogram


def _src_root() -> str:
    """The directory to put on the children's PYTHONPATH (the parent
    of the ``repro_torch`` package — works from a checkout or an install)."""
    import repro_torch
    if getattr(repro_torch, "__file__", None):    # regular package
        return str(Path(repro_torch.__file__).resolve().parents[1])
    return str(Path(list(repro_torch.__path__)[0]).resolve().parent)


class _Proc:
    """One supervised child process with a port file."""

    def __init__(self, name: str, argv: Sequence[str], cwd: str,
                 port_file: str) -> None:
        self.name = name
        self.port_file = port_file
        self.log_path = os.path.join(cwd, f"{name}.log")
        env = dict(os.environ)
        env["PYTHONPATH"] = _src_root() + os.pathsep + \
            env.get("PYTHONPATH", "")
        self._log = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            list(argv), cwd=cwd, env=env,
            stdout=self._log, stderr=subprocess.STDOUT)
        self.host: Optional[str] = None
        self.port: Optional[int] = None

    def wait_ready(self, timeout: float = 180.0) -> "_Proc":
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"{self.name} exited with {self.proc.returncode} "
                    f"before binding; log:\n{self._tail()}")
            if os.path.exists(self.port_file):
                with open(self.port_file) as f:
                    doc = json.load(f)
                self.host, self.port = doc["host"], doc["port"]
                return self
            time.sleep(0.1)
        raise RuntimeError(f"{self.name} did not bind within {timeout}s; "
                           f"log:\n{self._tail()}")

    def _tail(self, n: int = 40) -> str:
        self._log.flush()
        try:
            lines = Path(self.log_path).read_text(
                errors="replace").splitlines()
        except OSError:
            return "<no log>"
        return "\n".join(lines[-n:])

    def terminate(self, timeout: float = 60.0) -> int:
        """SIGTERM and wait; the replicas drain gracefully on it."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self._log.close()
        return self.proc.returncode

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self._log.close()


def _fleet_argv(cmd: str, *extra: str) -> List[str]:
    return [sys.executable, "-m", "repro_torch.launch.fleet", cmd, *extra]


def _coalesce_phase(client: PtxServiceClient, bench: str,
                    k: int) -> Dict:
    """Fire ``k`` concurrent identical requests for a never-seen bench
    and return the payloads' serialized forms (the caller asserts
    byte-identity and the single-miss invariant)."""
    import threading

    payloads: List[Optional[bytes]] = [None] * k
    errors: List[BaseException] = []
    latency = LatencyHistogram()

    def worker(i: int) -> None:
        try:
            t0 = time.perf_counter()
            resp = client.compile(bench=bench)
            latency.record(time.perf_counter() - t0)
            payloads[i] = json.dumps(resp, sort_keys=True).encode()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(k)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert all(p is not None for p in payloads)
    return {"k": k, "wall_s": round(wall_s, 3),
            "req_per_s": round(k / wall_s, 2),
            "distinct_payloads": len(set(payloads)),
            "latency": latency.to_dict()}


def run_smoke(requests: int = 24, clients: int = 6,
              benches: str = DEFAULT_BENCHES, seed: int = 0,
              verbose: bool = False) -> Dict:
    names = parse_bench_list(benches)
    if len(names) < 2:
        raise ValueError("the smoke needs >= 2 benches (one is held "
                         "back for the coalesce phase)")
    # hold the last bench back: the coalesce phase needs a kernel
    # replica A has never compiled
    plan_names, held_back = names[:-1], names[-1]
    rng = random.Random(seed)
    plan = [rng.choice(plan_names) for _ in range(requests)]

    summary: Dict = {"requests": requests, "clients": clients,
                     "benches": len(names), "phases": {}}
    procs: List[_Proc] = []
    with tempfile.TemporaryDirectory(prefix="fleet-smoke-") as tmp:
        try:
            cache = _Proc("cache", _fleet_argv(
                "cache-server", "--port-file",
                os.path.join(tmp, "cache.json")),
                tmp, os.path.join(tmp, "cache.json"))
            procs.append(cache)
            cache.wait_ready()
            cache_url = f"http://{cache.host}:{cache.port}"

            def replica(name: str, *extra: str) -> _Proc:
                pf = os.path.join(tmp, f"{name}.json")
                p = _Proc(name, _fleet_argv(
                    "serve", "--port-file", pf, "--cache-dir",
                    os.path.join(tmp, f"disk-{name}"), *extra),
                    tmp, pf)
                procs.append(p)
                return p

            rep_a = replica("rep-a", "--remote-cache", cache_url)
            rep_b = replica("rep-b", "--remote-cache", cache_url)
            # deliberately starved: the backpressure phase's subject
            # (no remote tier, so every compile is cold and slow)
            rep_c = replica("rep-c", "--workers", "1", "--jobs", "1",
                            "--queue-capacity", "1", "--batch-max", "1")
            for p in (rep_a, rep_b, rep_c):
                p.wait_ready()

            client_a = PtxServiceClient(rep_a.host, rep_a.port)
            client_b = PtxServiceClient(rep_b.host, rep_b.port)
            client_c = PtxServiceClient(rep_c.host, rep_c.port)
            for c in (client_a, client_b, client_c):
                assert c.healthz(), "replica failed /healthz"

            # -- phase: cold --------------------------------------------
            wall_s = drive_requests(client_a, plan, clients)
            stats_a = client_a.stats()
            assert stats_a["errors"] == 0, \
                f"cold phase produced server errors: {stats_a['errors']}"
            summary["phases"]["cold"] = {
                "wall_s": round(wall_s, 3),
                "req_per_s": round(requests / wall_s, 2),
                "latency": stats_a["fleet"]["latency"]["total"],
            }

            # -- phase: coalesce ----------------------------------------
            misses_before = stats_a["cache"]["misses"]
            phase = _coalesce_phase(client_a, held_back, k=clients)
            stats_a = client_a.stats()
            new_misses = stats_a["cache"]["misses"] - misses_before
            assert phase["distinct_payloads"] == 1, \
                f"coalesced responses diverged: {phase}"
            assert new_misses == 1, (
                f"{clients} identical concurrent requests should cost "
                f"exactly 1 compile, saw {new_misses} cache misses")
            phase["new_misses"] = new_misses
            phase["coalesce"] = stats_a["fleet"]["coalesce"]
            summary["phases"]["coalesce"] = phase

            # -- phase: warm-remote -------------------------------------
            warm_plan = plan + [held_back]
            wall_s = drive_requests(client_b, warm_plan, clients)
            stats_b = client_b.stats()
            emulate_s = stats_b["pass_times"].get("emulate-flows", 0.0)
            assert emulate_s == 0.0, (
                "warm replica re-emulated despite the remote tier: "
                f"{emulate_s:.3f}s of emulate-flows")
            assert stats_b["cache"]["remote_hits"] == len(set(warm_plan)), \
                f"unexpected remote tier traffic: {stats_b['cache']}"
            assert stats_b["errors"] == 0
            summary["phases"]["warm_remote"] = {
                "wall_s": round(wall_s, 3),
                "req_per_s": round(len(warm_plan) / wall_s, 2),
                "remote_hits": stats_b["cache"]["remote_hits"],
                "distinct_sources": len(set(warm_plan)),
                "emulate_flows_s": emulate_s,
                "latency": stats_b["fleet"]["latency"]["total"],
            }

            # -- phase: backpressure ------------------------------------
            bp_plan = list(names) * 2
            wall_s = drive_requests(client_c, bp_plan, clients,
                                    retry_backpressure=True)
            rejected = client_c.counters["backpressure"]
            stats_c = client_c.stats()
            assert rejected >= 1, (
                "a 1-worker/1-slot replica under concurrent load never "
                "pushed back — backpressure is not firing")
            assert stats_c["fleet"]["queue"]["rejected"] == rejected \
                or stats_c["fleet"]["queue"]["rejected"] >= 1
            summary["phases"]["backpressure"] = {
                "wall_s": round(wall_s, 3),
                "req_per_s": round(len(bp_plan) / wall_s, 2),
                "served": len(bp_plan),
                "rejected_503": rejected,
                "queue": stats_c["fleet"]["queue"],
                "latency": stats_c["fleet"]["latency"]["total"],
            }

            # -- phase: drain -------------------------------------------
            from repro_torch.launch.fleet.remote_cache import RemoteCache
            summary["cache_server"] = RemoteCache(cache_url).server_stats()
            exit_codes = {p.name: p.terminate() for p in reversed(procs)}
            assert all(code == 0 for code in exit_codes.values()), \
                f"non-zero exit on graceful shutdown: {exit_codes}"
            summary["phases"]["drain"] = {"exit_codes": exit_codes}
        finally:
            for p in procs:
                p.kill()
    if verbose:
        print(json.dumps(summary, indent=2))
    return summary
