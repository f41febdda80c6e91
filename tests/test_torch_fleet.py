"""Parity of the port's replica fleet (``repro_torch.launch.fleet``) with the
JAX package's: the latency histogram, the bounded queue and the coalescer
give equal answers on the same seeded inputs and scripts; the wire form
reads like the port's disk tier (a blob that names a class outside
``repro_torch`` is a miss); the cache tier server, the remote client and
the ``CompileCache`` remote tier; the port's ``FleetServer`` (coalescing,
two replicas on one tier, 503, 504, drain) with the reference's ``/stats``
fleet tree and byte-equal PTX for the 19 KernelGen sources; one tier
shared by both packages with disjoint entries; and the subprocess smoke."""

import base64
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from test_fleet import _gate_compiles, _poll

import repro.launch.fleet as ref_fleet
from repro.core.driver import Compiler as RefCompiler
from repro.core.frontend.kernelgen import get_bench as ref_get_bench
from repro.core.passes.cache import CompileCache as RefCompileCache
from repro.core.passes.diskcache import entry_digest as ref_entry_digest
from repro.launch.fleet import remote_cache as ref_remote
from repro.launch.fleet.__main__ import main as ref_main
from repro.launch.ptx_service import PtxServiceClient as RefClient
from repro_torch.core.driver import Compiler
from repro_torch.core.frontend.kernelgen import APPLICATIONS, SUITE, get_bench
from repro_torch.core.passes.cache import CompileCache
from repro_torch.core.passes.diskcache import entry_digest
from repro_torch.core.ptx import print_kernel
from repro_torch.launch import fleet
from repro_torch.launch.fleet import (
    CacheTierServer,
    FleetServer,
    RemoteCache,
)
from repro_torch.launch.fleet import remote_cache
from repro_torch.launch.fleet.__main__ import main as port_main
from repro_torch.launch.ptx_service import BackpressureError, PtxServiceClient

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
PACKAGES = {"port": fleet, "reference": ref_fleet}
CLIENTS = {"port": PtxServiceClient, "reference": RefClient}
SOURCES = [*SUITE, *APPLICATIONS]


@dataclasses.dataclass
class FakeReport:
    name: str
    cached: bool = False


@pytest.fixture(scope="module")
def jacobi():
    """``(kernel, report)`` of Jacobi's compile in each package."""
    out = {}
    for which, (compiler, bench) in {"port": (Compiler, get_bench),
                                     "reference": (RefCompiler, ref_get_bench)}.items():
        with compiler(jobs=1) as cc:
            res = cc.compile(bench("jacobi"))
        out[which] = (res.module.kernels[0], res.reports[0])
    return out


def _pairs(report):
    return [(p.dst_uid, p.src_uid, p.delta) for p in report.detection.pairs]


# ---------------------------------------------------------------------------
# latency histogram, bounded queue, coalescer: equal answers on equal scripts
# ---------------------------------------------------------------------------

HIST_CASES = {
    "empty": (0, 0),
    "seed0_small": (0, 10),
    "seed1_many": (1, 2000),
    "seed2_with_edges": (2, 300),
}


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_histogram_matches_reference(case):
    seed, n = HIST_CASES[case]
    rng = np.random.default_rng(seed)
    samples = list(rng.lognormal(mean=-5.0, sigma=2.5, size=n))
    if case.endswith("edges"):
        samples += [-1.0, 0.0, 1e-4, 2e-4, 1e5]      # clamp, bucket bounds, overflow
    out = {}
    for which, mod in PACKAGES.items():
        h = mod.LatencyHistogram()
        for s in samples:
            h.record(float(s))
        with pytest.raises(ValueError) as exc:
            h.percentile(101)
        out[which] = (h.to_dict(), h.count, str(exc.value),
                      [h.percentile(p) for p in (0, 1, 50, 90, 99, 100)])
    assert out["port"] == out["reference"]
    assert out["port"][1] == len(samples)


def _queue_script(mod):
    out = []
    now = time.monotonic()
    jobs = [mod.Job(prepared=i, flight=None, deadline=d)
            for i, d in enumerate([None, now - 1.0, now + 60.0, None, None])]
    q = mod.JobQueue(capacity=2)
    q.put(jobs[0])
    q.put(jobs[1])
    try:
        q.put(jobs[2])
    except mod.QueueFull as e:
        out.append(("full", str(e)))
    batch = q.take_batch(max_items=8, window_s=0.0)
    out.append([j.prepared for j in batch])
    expired = [j.expired(now) for j in batch]
    out.append(expired)
    q.count_expired(sum(expired))
    q.put(jobs[2])
    q.put(jobs[3])
    out.append([j.prepared for j in q.take_batch(max_items=1, window_s=0.05)])
    # the window lingers for company, then gives what it holds
    out.append([j.prepared for j in q.take_batch(max_items=4, window_s=0.05)])
    late = []
    t = threading.Thread(target=lambda: late.append(q.take_batch(max_items=4,
                                                                 window_s=5.0)))
    q.put(jobs[4])
    t.start()
    time.sleep(0.05)
    q.close()                   # ends the lingering window
    t.join(timeout=10)
    out.append([j.prepared for j in late[0]])
    try:
        q.put(jobs[0])
    except mod.QueueClosed as e:
        out.append(("closed", str(e)))
    out.append(q.take_batch())
    out.append((q.counters(), q.closed, q.depth))
    try:
        mod.JobQueue(capacity=0)
    except ValueError as e:
        out.append(("capacity", str(e)))
    return out


def test_queue_script_matches_reference():
    got, ref = (_queue_script(mod) for mod in PACKAGES.values())
    assert got == ref
    assert got[-2][0] == {"depth": 0, "capacity": 2, "enqueued": 5, "rejected": 1,
                          "expired": 1, "max_depth": 2}
    assert got[-3] is None


def _coalescer_script(mod):
    out = []
    co = mod.RequestCoalescer()
    f1, c1 = co.join("k")
    f2, c2 = co.join("k")
    out.append((c1, c2, f2 is f1, f1.n_waiters))
    co.finish(f1)
    f3, c3 = co.join("k")
    out.append((c3, f3 is f1))
    f1.resolve({"x": 1})
    out.append(f1.wait(1.0))
    g, _ = co.join("g")
    co.join("g")
    co.abandon(g, ValueError("boom"))
    for _ in range(2):
        try:
            g.wait(1.0)
        except ValueError as e:
            out.append(("abandoned", str(e)))
    f3.fail(KeyError("gone"))
    co.finish(f3)
    try:
        f3.wait(1.0)
    except KeyError as e:
        out.append(("failed", str(e)))
    try:
        mod.Flight("t").wait(0.01)
    except mod.FlightTimeout as e:
        out.append(("timeout", str(e)))
    out.append(co.counters())
    return out


def test_coalescer_script_matches_reference():
    got, ref = (_coalescer_script(mod) for mod in PACKAGES.values())
    assert got == ref
    assert got[-1] == {"open": 0, "flights": 3, "joined": 2, "abandoned": 1}


# ---------------------------------------------------------------------------
# wire form
# ---------------------------------------------------------------------------

def test_wire_round_trip_of_a_port_report(jacobi):
    kernel, report = jacobi["port"]
    blob = remote_cache.encode_entry("k", kernel, dataclasses.replace(report, cached=True))
    loaded = remote_cache.decode_entry(blob)
    assert loaded is not None
    k2, r2 = loaded
    assert print_kernel(k2) == print_kernel(kernel)
    assert r2.cached is False, "the wire form stores the pristine report"
    # every class in the detection came back through the port's unpickler
    assert _pairs(r2) == _pairs(report) and len(_pairs(r2)) == 6
    assert type(r2.detection.pairs[0]).__module__.startswith("repro_torch.")


def _with_report(blob, payload):
    obj = json.loads(blob)
    obj["report_b64"] = base64.b64encode(payload).decode()
    return json.dumps(obj).encode()


def _bad_blob(case, jacobi):
    kernel, report = jacobi["port"]
    blob = remote_cache.encode_entry("k", kernel, report)
    if case == "not_json":
        return b"not json at all"
    if case == "schema_drift":
        obj = json.loads(blob)
        obj["schema"] = -1
        return json.dumps(obj).encode()
    if case == "corrupt_report":
        return _with_report(blob, b"\x00\x01")
    if case == "two_kernels":
        obj = json.loads(blob)
        obj["ptx"] = obj["ptx"] + "\n" + obj["ptx"].replace("jacobi", "jacobi_b")
        return json.dumps(obj).encode()
    if case == "foreign_class":
        return _with_report(blob, pickle.dumps(FakeReport("jacobi")))
    if case == "builtin_callable":
        return _with_report(blob, pickle.dumps(eval))
    if case == "not_a_dataclass":
        return _with_report(blob, pickle.dumps({"name": "jacobi"}))
    if case == "reference_entry":
        ref_kernel, ref_report = jacobi["reference"]
        return ref_remote.encode_entry("k", ref_kernel, ref_report)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["not_json", "schema_drift", "corrupt_report", "two_kernels",
                                  "foreign_class", "builtin_callable", "not_a_dataclass",
                                  "reference_entry"])
def test_bad_blob_is_a_miss(case, jacobi):
    blob = _bad_blob(case, jacobi)
    assert remote_cache.decode_entry(blob) is None
    if case in ("foreign_class", "reference_entry"):
        # the reference unpickles any class: the refusal is the port's own
        assert ref_remote.decode_entry(blob) is not None


def test_same_key_gives_different_digests():
    for key in ("k", "a" * 64, "jacobi:hopper"):
        assert entry_digest(key) != ref_entry_digest(key)
        assert len(entry_digest(key)) == 64


# ---------------------------------------------------------------------------
# cache tier server and remote client, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", list(PACKAGES))
def test_cache_tier_server_lru_by_bytes(which):
    srv = PACKAGES[which].CacheTierServer(max_bytes=100)
    try:
        srv.put("a" * 64, b"x" * 60)
        srv.put("b" * 64, b"y" * 60)              # evicts a (120 > 100)
        assert srv.get("a" * 64) is None
        assert srv.get("b" * 64) == b"y" * 60
        st = srv.stats_payload()
        assert (st["evictions"], st["entries"], st["gets"], st["hits"]) == (1, 1, 2, 1)
        assert len(srv) == 1
    finally:
        srv.close()


@pytest.mark.parametrize("which", list(PACKAGES))
def test_cache_tier_disk_spill_survives_restart(which, tmp_path, jacobi):
    mod = PACKAGES[which]
    spill = str(tmp_path / "tier")
    kernel, report = jacobi[which]
    with mod.CacheTierServer(cache_dir=spill) as tier:
        tier.start()
        mod.RemoteCache(tier.url).store("warm", kernel, report)
        st = tier.stats_payload()
        assert (st["disk_puts"], st["disk_entries"], st["disk_errors"]) == (1, 1, 0)
    with mod.CacheTierServer(cache_dir=spill) as tier:
        tier.start()
        rc = mod.RemoteCache(tier.url)
        loaded = rc.load("warm")
        assert loaded is not None and _pairs(loaded[1]) == _pairs(report)
        st = tier.stats_payload()
        assert st["disk_hits"] == 1 and st["cache_dir"] == spill and st["entries"] == 1
        assert rc.load("warm") is not None            # second hit: memory
        assert tier.stats_payload()["disk_hits"] == 1


@pytest.mark.parametrize("which", list(PACKAGES))
def test_cache_tier_eviction_keeps_disk_superset(which, tmp_path):
    srv = PACKAGES[which].CacheTierServer(max_bytes=100, cache_dir=str(tmp_path / "tier"))
    try:
        srv.put("a" * 64, b"x" * 60)
        srv.put("b" * 64, b"y" * 60)              # evicts a from memory
        assert srv.stats_payload()["evictions"] == 1
        assert srv.get("a" * 64) == b"x" * 60     # the disk still has it
        st = srv.stats_payload()
        assert st["disk_hits"] == 1 and st["disk_entries"] == 2
    finally:
        srv.close()


def test_remote_cache_http_round_trip_and_counters(jacobi):
    kernel, report = jacobi["port"]
    with CacheTierServer() as tier:
        tier.start()
        rc = RemoteCache(tier.url)
        assert rc.healthz()
        assert rc.load("k1") is None
        rc.store("k1", kernel, report)
        loaded = rc.load("k1")
        assert loaded is not None
        assert print_kernel(loaded[0]) == print_kernel(kernel)
        assert _pairs(loaded[1]) == _pairs(report)
        assert rc.counters == {"gets": 2, "hits": 1, "misses": 1, "puts": 1, "errors": 0}
        st = rc.server_stats()
        assert st["entries"] == 1 and st["puts"] == 1


def test_remote_cache_dead_server_degrades_like_reference(jacobi):
    out = {}
    for which, mod in PACKAGES.items():
        rc = mod.RemoteCache("http://127.0.0.1:9", timeout=0.2)   # nothing there
        assert rc.load("k") is None
        assert rc.store("k", *jacobi[which]) == 0
        assert rc.healthz() is False
        out[which] = rc.counters
    assert out["port"] == out["reference"]
    assert out["port"]["errors"] == 2 and out["port"]["misses"] == 1


@pytest.mark.parametrize("url", ["https://example.com:443", "http://nohost", "ftp://h:1",
                                 "127.0.0.1:8790", "http://localhost:8790/"])
def test_remote_cache_url_validation_matches_reference(url):
    out = {}
    for which, mod in PACKAGES.items():
        try:
            rc = mod.RemoteCache(url)
            out[which] = (rc.host, rc.port)
        except ValueError as e:
            out[which] = ("ValueError", str(e))
    assert out["port"] == out["reference"]


def test_one_tier_serves_both_packages_with_disjoint_entries(jacobi):
    """A reference tier holds each package's entry for one logical key;
    each package reads back its own and misses the other's."""
    with ref_fleet.CacheTierServer() as tier:
        tier.start()
        clients = {w: PACKAGES[w].RemoteCache(tier.url) for w in PACKAGES}
        for which, rc in clients.items():
            rc.store("vecadd-key", *jacobi[which])
        assert len(tier) == 2 and tier.stats_payload()["puts"] == 2
        for which, rc in clients.items():
            loaded = rc.load("vecadd-key")
            assert loaded is not None
            assert type(loaded[1]).__module__.split(".")[0] == \
                {"port": "repro_torch", "reference": "repro"}[which]
        # the other package's blob, fetched by its own digest, is refused
        ref_blob = tier.get(ref_entry_digest("vecadd-key"))
        assert remote_cache.decode_entry(ref_blob) is None
        assert clients["port"].load("other-key") is None
        assert clients["port"].counters == {"gets": 2, "hits": 1, "misses": 1, "puts": 1,
                                            "errors": 0}


# ---------------------------------------------------------------------------
# CompileCache(remote=...): write-through, then warm from the remote
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["compile", "analyze"])
def test_compile_cache_remote_tier_write_through_and_warm_hit(method):
    out = {}
    for which, (compiler, cache_cls, bench) in {
            "port": (Compiler, CompileCache, get_bench),
            "reference": (RefCompiler, RefCompileCache, ref_get_bench)}.items():
        mod = PACKAGES[which]
        with mod.CacheTierServer() as tier:
            tier.start()
            first = mod.RemoteCache(tier.url)
            with compiler(jobs=1, cache=cache_cls(remote=first)) as c1:
                cold = getattr(c1, method)(bench("jacobi"))
            assert first.counters["puts"] == 1 and len(tier) == 1
            with compiler(jobs=1, cache=cache_cls(remote=mod.RemoteCache(tier.url))) as c2:
                warm = getattr(c2, method)(bench("jacobi"))
                stats = c2.cache_stats
                assert stats.remote_hits == 1 and stats.misses == 1
                assert warm.reports[0].cached
                assert "emulate-flows" not in c2.pass_times, \
                    "a remote hit must skip symbolic emulation"
            assert warm.ptx == cold.ptx
            assert _pairs(warm.reports[0]) == _pairs(cold.reports[0])
            out[which] = (warm.ptx, _pairs(warm.reports[0]), stats.to_dict())
    assert out["port"] == out["reference"]


# ---------------------------------------------------------------------------
# FleetServer
# ---------------------------------------------------------------------------

def test_coalescer_hammer_one_compile_k_identical_responses():
    k = 6
    with FleetServer(workers=1, jobs=2) as srv:
        srv.start()
        release, calls = _gate_compiles(srv)
        client = PtxServiceClient(srv.host, srv.port)
        payloads, errors = [], []
        lock = threading.Lock()

        def hammer():
            try:
                resp = client.compile(bench="vecadd")
                with lock:
                    payloads.append(json.dumps(resp, sort_keys=True))
            except BaseException as e:  # noqa: BLE001
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(k)]
        for t in threads:
            t.start()
        try:
            _poll(lambda: srv.coalescer.counters()["joined"] == k - 1,
                  what=f"{k - 1} joins (got {srv.coalescer.counters()})")
            assert len(calls) <= 1
        finally:
            release.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[0]
        assert len(calls) == 1, "exactly one compile for K identical requests"
        assert len(set(payloads)) == 1 and len(payloads) == k
        st = srv.stats_payload()
        assert st["cache"]["misses"] == 1
        assert st["fleet"]["coalesce"]["joined"] == k - 1
        assert st["fleet"]["latency"]["total"]["count"] == k


def test_two_replicas_share_the_remote_tier(tmp_path):
    with CacheTierServer() as tier:
        tier.start()
        with FleetServer(remote_cache=tier.url, cache_dir=str(tmp_path / "a"),
                         workers=2, jobs=2) as a:
            a.start()
            cold = PtxServiceClient(a.host, a.port).compile(bench="jacobi")
        with FleetServer(remote_cache=tier.url, cache_dir=str(tmp_path / "b"),
                         workers=2, jobs=2) as b:
            b.start()
            cb = PtxServiceClient(b.host, b.port)
            warm = cb.compile(bench="jacobi")
            st = cb.stats()
        assert warm["ptx"] == cold["ptx"]
        assert st["cache"]["remote_hits"] == 1 and st["cache"]["disk_misses"] == 1
        assert st["pass_times"].get("emulate-flows", 0.0) == 0.0
        assert st["remote"]["hits"] == 1 and st["remote"]["url"] == tier.url
        assert tier.stats_payload()["hits"] == 1


def test_backpressure_503_with_retry_after_hint():
    with FleetServer(workers=1, jobs=1, queue_capacity=1, batch_max=1) as srv:
        srv.start()
        release, calls = _gate_compiles(srv)
        client = PtxServiceClient(srv.host, srv.port)
        done = []

        def post(name):
            done.append(client.compile(bench=name))

        t1 = threading.Thread(target=post, args=("vecadd",))
        t1.start()
        _poll(lambda: len(calls) == 1, what="worker holding job 1")
        t2 = threading.Thread(target=post, args=("jacobi",))
        t2.start()
        _poll(lambda: srv.queue.depth == 1, what="job 2 queued")
        try:
            with pytest.raises(BackpressureError) as exc:
                client.compile(bench="laplacian")    # queue full: 503
            assert exc.value.retry_after >= 1
            assert client.counters["backpressure"] == 1
            assert srv.queue.counters()["rejected"] == 1
            assert srv.coalescer.counters()["abandoned"] == 1
        finally:
            release.set()
        t1.join(timeout=60)
        t2.join(timeout=60)
        assert len(done) == 2, "obeying the 503 must not lose the others"


def test_deadline_times_out_both_in_flight_and_in_queue():
    with FleetServer(workers=1, jobs=1, queue_capacity=4, batch_max=1,
                     deadline_s=0.3) as srv:
        srv.start()
        release, calls = _gate_compiles(srv)
        client = PtxServiceClient(srv.host, srv.port)
        errors = []

        def post(name):
            try:
                client.compile(bench=name)
            except RuntimeError as e:
                errors.append(str(e))

        t1 = threading.Thread(target=post, args=("vecadd",))
        t1.start()
        _poll(lambda: len(calls) == 1, what="worker holding job 1")
        t2 = threading.Thread(target=post, args=("jacobi",))
        t2.start()
        t1.join(timeout=60)
        t2.join(timeout=60)
        assert len(errors) == 2 and all("504" in e for e in errors), errors
        release.set()
        _poll(lambda: srv.queue.counters()["expired"] == 1,
              what="expired job skipped by the worker")


def test_fleet_close_unstarted():
    srv = FleetServer(workers=2)
    assert srv.stats_payload()["fleet"]["workers"] == 2
    srv.close()                       # must not hang on idle workers
    assert srv.queue.closed
    with pytest.raises(ValueError, match="workers"):
        FleetServer(workers=0)


def _fleet_tree(stats):
    """The ``/stats`` ``"fleet"`` section with its times stripped (each
    latency histogram down to its count)."""
    tree = dict(stats["fleet"])
    tree["latency"] = {k: {"count": v["count"]} for k, v in tree["latency"].items()}
    return tree


def test_stats_fleet_tree_matches_reference():
    trees = {}
    for which, mod in PACKAGES.items():
        with mod.FleetServer(workers=2, jobs=2, deadline_s=30.0) as srv:
            srv.start()
            client = CLIENTS[which](srv.host, srv.port)
            for name in ("vecadd", "vecadd", "jacobi"):
                client.compile(bench=name)
            stats = client.stats()
            trees[which] = (_fleet_tree(stats), stats["cache"]["misses"],
                            stats["cache"]["hits"], stats["requests"])
    assert trees["port"] == trees["reference"]
    tree = trees["port"][0]
    assert tree["coalesce"] == {"open": 0, "flights": 3, "joined": 0, "abandoned": 0}
    assert tree["queue"]["enqueued"] == 3 and tree["latency"]["total"]["count"] == 3


@pytest.fixture(scope="module")
def fleet_pair():
    """A port ``FleetServer`` and a reference one, no disk tier."""
    out = {}
    try:
        for which, mod in PACKAGES.items():
            srv = mod.FleetServer(workers=2, jobs=2)
            srv.start()
            out[which] = srv
        yield out
    finally:
        for srv in out.values():
            srv.close()


def _reports(payload):
    """Each report's name, detection and emulator counters, but the size
    of the process's term table, which depends on what the process
    compiled before."""
    return [(r["name"], r["detection"],
             {k: v for k, v in r["counters"].items() if k != "terms_interned"})
            for r in payload["reports"]]


@pytest.mark.parametrize("name", SOURCES)
def test_compile_of_kernelgen_sources_matches_reference(fleet_pair, name):
    got = PtxServiceClient(fleet_pair["port"].host, fleet_pair["port"].port).compile(bench=name)
    ref = RefClient(fleet_pair["reference"].host, fleet_pair["reference"].port).compile(
        bench=name)
    assert got["ptx"] == ref["ptx"]
    assert _reports(got) == _reports(ref)


# ---------------------------------------------------------------------------
# CLI and subprocesses
# ---------------------------------------------------------------------------

def test_cli_help_and_refusal_match_reference(capsys):
    helps = {}
    for which, main in {"port": port_main, "reference": ref_main}.items():
        with pytest.raises(SystemExit) as exc:
            main(["--help"])
        assert exc.value.code == 0
        helps[which] = capsys.readouterr().out.replace("repro_torch.", "repro.")
        with pytest.raises(ValueError, match="needs >= 2 benches"):
            main(["smoke", "--benches", "jacobi"])
    assert helps["port"] == helps["reference"]


def test_fleet_modules_import_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.launch.fleet as fleet\n"
        "names = [m.name for m in pkgutil.walk_packages(fleet.__path__, fleet.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "from repro_torch.launch.fleet import CacheTierServer, FleetServer\n"
        "from repro_torch.launch.ptx_service import PtxServiceClient\n"
        "with CacheTierServer() as tier:\n"
        "    tier.start()\n"
        "    with FleetServer(remote_cache=tier.url, workers=1, jobs=1) as srv:\n"
        "        srv.start()\n"
        "        PtxServiceClient(srv.host, srv.port).compile(bench='vecadd')\n"
        "    assert len(tier) == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('repro', 'jax'))\n"
        "assert not bad, bad\n"
        "print(len(names), 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr
    n, torch_loaded = out.stdout.split()
    assert int(n) == 7 and torch_loaded == "False"


def test_fleet_smoke_subprocess():
    """``python -m repro_torch.launch.fleet smoke``: a cache tier and three
    replicas in processes of their own, the five phases."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", "smoke", "--requests", "8",
         "--clients", "4"],
        capture_output=True, text=True, timeout=180, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert out.stdout.rstrip().endswith("fleet smoke OK")
    summary = json.loads(out.stdout[:out.stdout.rindex("}") + 1])
    ph = summary["phases"]
    assert ph["coalesce"]["new_misses"] == 1 and ph["coalesce"]["distinct_payloads"] == 1
    assert ph["warm_remote"]["remote_hits"] == ph["warm_remote"]["distinct_sources"]
    assert ph["warm_remote"]["emulate_flows_s"] == 0.0
    assert ph["backpressure"]["rejected_503"] >= 1
    assert set(ph["drain"]["exit_codes"].values()) == {0}
