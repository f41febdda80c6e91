"""Parity of the port's compile service (``repro_torch.launch.ptx_service``)
with the JAX package's: both servers answer the same ``/compile``,
``/lint``, ``/stats`` and ``/healthz`` requests with equal payloads (times
stripped), the same 400/404/413 refusals, the clients' retry and
backpressure (503) counters, the ``--bench`` and demo modes, the fleet's
network cache tier behind ``remote_cache=``, and the port's service in a
subprocess that cannot import ``repro``."""

import json
import os
import subprocess
import sys
from http.client import HTTPConnection

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from test_ptx_service import _http_response, _one_shot_server

from repro.launch import ptx_service as ref_service
from repro_torch.core.driver import Compiler
from repro_torch.core.frontend.kernelgen import get_bench
from repro_torch.launch import ptx_service as service

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "lint_corpus")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
PACKAGES = {"port": service, "reference": ref_service}
#: what differs between two equal answers: times, the process's term
#: tables, each server's own cache directory, and the size of its entries
#: (their pickles name each package's classes)
UNSTABLE = ("uptime_s", "terms_interned", "cache_dir", "dir", "approx_bytes")


def _corpus(name):
    with open(os.path.join(CORPUS_DIR, name), encoding="utf-8") as fh:
        return fh.read()


def stable(obj):
    if isinstance(obj, dict):
        return {k: (sorted(v) if k == "pass_times" else stable(v))
                for k, v in obj.items()
                if not k.endswith("time_s") and k not in UNSTABLE}
    if isinstance(obj, list):
        return [stable(x) for x in obj]
    return obj


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A port server and a reference server, each with its own disk tier."""
    out = {}
    try:
        for which, mod in PACKAGES.items():
            srv = mod.PtxServiceServer(port=0, jobs=2,
                                       cache_dir=str(tmp_path_factory.mktemp(which)))
            srv.start()
            out[which] = srv
        yield out
    finally:
        for srv in out.values():
            srv.close()


@pytest.fixture(scope="module")
def clients(servers):
    return {which: PACKAGES[which].PtxServiceClient(srv.host, srv.port)
            for which, srv in servers.items()}


def ask(clients, method, *args, **kwargs):
    """The same call on both clients; returns (port's, reference's)."""
    return tuple(getattr(clients[w], method)(*args, **kwargs) for w in PACKAGES)


COMPILE_CASES = {
    "vecadd": dict(bench="vecadd"),
    "jacobi_hopper": dict(bench="jacobi", target="hopper"),
    "hypterm_all_knobs": dict(bench="hypterm", target="hopper", saturate=True,
                              widen=True, lint="strict"),
    "wave13pt_cost_kepler": dict(bench="wave13pt", target="kepler", selection="cost"),
    "tricubic_saturate_volta": dict(bench="tricubic", target="volta", saturate=True),
    "divergence_repeat": dict(bench="divergence"),
    "ptx_corpus_lint_warn": dict(ptx=_corpus("width_mismatch.ptx"), lint="warn"),
    "ptx_gated": dict(ptx=_corpus("shared_synced.ptx"), max_delta=1),
}


@pytest.mark.parametrize("case", list(COMPILE_CASES))
def test_compile_payloads_match_reference(clients, case):
    """``POST /compile``: equal payloads, and the PTX byte-equal to an
    in-process compile of the port."""
    req = dict(COMPILE_CASES[case])
    got, ref = ask(clients, "compile", **req)
    assert stable(got) == stable(ref)
    src = get_bench(req.pop("bench")) if "bench" in req else req.pop("ptx")
    assert got["ptx"] == Compiler().compile(src, **req).ptx
    if case == "divergence_repeat":
        again, ref_again = ask(clients, "compile", bench="divergence")
        assert again["reports"][0]["cached"] and stable(again) == stable(ref_again)


LINT_CASES = {
    "bench_jacobi": dict(bench="jacobi"),
    "bench_whispering": dict(bench="whispering"),
    **{f"corpus_{f[:-4]}": dict(ptx=_corpus(f))
       for f in sorted(os.listdir(CORPUS_DIR)) if f.endswith(".ptx")},
    "two_kernels": dict(ptx=_corpus("div_shfl.ptx") + _corpus("undef_use.ptx")),
    "lane_option": dict(ptx=_corpus("shared_race.ptx"), lane="tid.x"),
}


@pytest.mark.parametrize("case", list(LINT_CASES))
def test_lint_payloads_match_reference(clients, case):
    got, ref = ask(clients, "lint", **LINT_CASES[case])
    assert got == ref
    name = case.split("_", 1)[1]
    if case.startswith("bench") or name in ("shared_synced", "mask_reg_full",
                                            "mask_guarded_covering"):
        assert got["clean"] is True
    else:
        assert got["clean"] is False and got["findings"]


def test_stats_and_healthz_match_reference(clients):
    """After the same requests, ``/stats`` reads the same requests, errors,
    cache tiers, counter families and pass names."""
    ask(clients, "compile", bench="laplacian", saturate=True)
    ask(clients, "lint", bench="laplacian")
    got, ref = ask(clients, "stats")
    assert stable(got) == stable(ref)
    assert got["requests"] >= 2 and got["disk"]["entries"] >= 1
    assert not any(k.startswith(("sat_", "lint_")) for k in got["emulator_counters"])
    assert all(k.startswith("sat_") for k in got["saturation_counters"])
    assert ask(clients, "healthz") == (True, True)


def _raw(server, method, path, body=b"", content_length=None):
    conn = HTTPConnection(server.host, server.port, timeout=60)
    try:
        headers = {"Content-Type": "application/json"}
        if content_length is not None:
            headers["Content-Length"] = str(content_length)
        conn.request(method, path, body=body if method == "POST" else None, headers=headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


ERROR_CASES = {
    "neither_source": ("POST", "/compile", b"{}", None, 400),
    "both_sources": ("POST", "/compile", b'{"ptx": "x", "bench": "jacobi"}', None, 400),
    "unknown_bench": ("POST", "/compile", b'{"bench": "nope"}', None, 400),
    "session_knob": ("POST", "/compile", b'{"bench": "jacobi", "options": {"jobs": 3}}',
                     None, 400),
    "bad_option_value": ("POST", "/compile", b'{"bench": "jacobi", "options": {"lint": "x"}}',
                         None, 400),
    "not_json": ("POST", "/compile", b"{not json", None, 400),
    "not_ptx": ("POST", "/compile", b'{"ptx": "this is not ptx at all"}', None, 400),
    "lint_both": ("POST", "/lint", b'{"ptx": "x", "bench": "jacobi"}', None, 400),
    "lint_no_kernels": ("POST", "/lint", b'{"ptx": "no kernels here"}', None, 400),
    "get_unknown": ("GET", "/nope", b"", None, 404),
    "post_unknown": ("POST", "/nope", b"{}", None, 404),
    "declared_oversized": ("POST", "/compile", b"x", service.DEFAULT_MAX_BODY_BYTES + 1, 413),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_refusals_match_reference(servers, case):
    method, path, body, length, status = ERROR_CASES[case]
    got = _raw(servers["port"], method, path, body, length)
    ref = _raw(servers["reference"], method, path, body, length)
    assert got == ref
    assert got[0] == status and got[1]["error"]


def test_oversized_body_is_413_like_reference():
    body = json.dumps({"ptx": "x" * 200}).encode()
    out = {}
    for which, mod in PACKAGES.items():
        with mod.PtxServiceServer(max_body_bytes=64) as srv:
            srv.start()
            out[which] = _raw(srv, "POST", "/compile", body)
            assert mod.PtxServiceClient(srv.host, srv.port).healthz()
    assert out["port"] == out["reference"]
    assert out["port"][0] == 413 and "64-byte limit" in out["port"][1]["error"]


def test_close_without_start_does_not_hang():
    with service.PtxServiceServer():
        pass
    service.PtxServiceServer().close()


def test_client_retries_transport_errors_like_reference():
    counters = {}
    for which, mod in PACKAGES.items():
        ok = _http_response("HTTP/1.1 200 OK", body=b'{"ok": true}')
        port, t = _one_shot_server([None, ok])       # the first connection dies
        client = mod.PtxServiceClient("127.0.0.1", port, retries=2, backoff_s=0.001)
        assert client.healthz() is True
        t.join(timeout=10)
        counters[which] = client.counters
    assert counters["port"] == counters["reference"] == \
        {"requests": 1, "retries": 1, "backpressure": 0}


def test_client_gives_up_after_retry_budget_like_reference():
    for mod in PACKAGES.values():
        client = mod.PtxServiceClient("127.0.0.1", 9, retries=2, backoff_s=0.001)
        with pytest.raises(ConnectionRefusedError):
            client.healthz()
        assert client.counters["retries"] == 2


def test_503_surfaces_backpressure_like_reference():
    out = {}
    for which, mod in PACKAGES.items():
        resp = _http_response("HTTP/1.1 503 Service Unavailable",
                              body=b'{"error": "queue full"}',
                              extra_headers=("Retry-After: 7",))
        port, t = _one_shot_server([resp])
        client = mod.PtxServiceClient("127.0.0.1", port, retries=3, backoff_s=0.001)
        with pytest.raises(mod.BackpressureError) as exc:
            client.compile(bench="vecadd")
        t.join(timeout=10)
        out[which] = (exc.value.retry_after, str(exc.value), client.counters)
    assert out["port"] == out["reference"]
    assert out["port"][2] == {"requests": 1, "retries": 0, "backpressure": 1}


@pytest.mark.parametrize("spec", ["jacobi, laplacian,", "  vecadd ", "jacobi,,gradient",
                                  "jacobi, nope", " ,, "])
def test_parse_bench_list_matches_reference(spec):
    out = {}
    for which, mod in PACKAGES.items():
        try:
            out[which] = mod.parse_bench_list(spec)
        except ValueError as e:
            out[which] = ("ValueError", str(e))
    assert out["port"] == out["reference"]


def test_drive_requests_matches_reference(servers, clients):
    """The service's own load driver: every request served, on one client
    thread (the reference's tiers moved exactly alike) and on three."""
    plan = ["jacobi", "vecadd", "jacobi", "gradient", "vecadd", "laplacian", "jacobi"]
    for n_clients in (1, 3):
        before = {w: c.stats()["cache"] for w, c in clients.items()}
        for which, mod in PACKAGES.items():
            assert mod.drive_requests(clients[which], plan, n_clients) > 0
        after = {w: c.stats()["cache"] for w, c in clients.items()}
        moved = {w: {k: after[w][k] - before[w][k] for k in ("hits", "misses")}
                 for w in PACKAGES}
        assert sum(moved["port"].values()) == sum(moved["reference"].values()) == len(plan)
        if n_clients == 1:
            assert moved["port"] == moved["reference"]


def test_bench_mode_and_warm_replica(tmp_path, capsys):
    """``--bench`` over HTTP, then the demo on the same directory in a
    second session with no emulation, as the reference's test."""
    out = {}
    for which, mod in PACKAGES.items():
        cache = str(tmp_path / which)
        summary = mod.main(["--bench", "--requests", "8", "--clients", "2",
                            "--benches", "vecadd, divergence,", "--cache-dir", cache])
        assert "ptx_service bench OK" in capsys.readouterr().out
        warm = mod.main(["--requests", "6", "--jobs", "2", "--benches", "vecadd,divergence",
                         "--cache-dir", cache, "--expect-warm-disk"])
        assert "warm-from-disk verified" in capsys.readouterr().out
        assert "emulate-flows" not in warm["pass_times"]
        # the cache tiers' split depends on how the client threads and
        # the session's workers interleave, so only the totals are held
        out[which] = ({k: summary[k] for k in ("requests", "clients", "distinct_benches")},
                      {k: warm[k] for k in ("requests", "distinct_kernels", "shuffles_total")},
                      summary["cache"]["hits"] + summary["cache"]["misses"])
    assert out["port"] == out["reference"]
    assert out["port"][0]["requests"] == 8 and out["port"][2] == 8


def test_cli_rejects_bad_bench_list_like_reference(capsys):
    errs = {}
    for which, mod in PACKAGES.items():
        with pytest.raises(SystemExit):
            mod.main(["--requests", "1", "--benches", "jacobi,nope"])
        errs[which] = capsys.readouterr().err.splitlines()[-1]
    assert errs["port"].split(": ", 1)[1] == errs["reference"].split(": ", 1)[1]
    assert "unknown bench(es) nope" in errs["port"]


def test_remote_cache_serves_a_second_replica_warm(tmp_path):
    """Two servers, each with a disk directory of its own, on one fleet
    cache tier: the second serves a source from the remote tier with no
    emulation, and its ``/stats`` ``"remote"`` section names the tier."""
    from repro_torch.launch.fleet import CacheTierServer

    with CacheTierServer() as tier:
        tier.start()
        payloads = []
        for name in ("first", "second"):
            with service.PtxServiceServer(remote_cache=tier.url, jobs=1,
                                          cache_dir=str(tmp_path / name)) as srv:
                srv.start()
                client = service.PtxServiceClient(srv.host, srv.port)
                payloads.append(client.compile(bench="wave13pt"))
                stats = client.stats()
        assert payloads[0]["ptx"] == payloads[1]["ptx"]
        assert payloads[1]["reports"][0]["cached"]
        assert stats["cache"]["remote_hits"] == 1 and stats["cache"]["disk_misses"] == 1
        assert "emulate-flows" not in stats["pass_times"]
        remote = stats["remote"]
        assert remote["url"] == tier.url
        assert {k: remote[k] for k in ("gets", "hits", "misses", "puts", "errors")} == \
            {"gets": 1, "hits": 1, "misses": 0, "puts": 0, "errors": 0}
        assert len(tier) == 1


def test_compiler_and_remote_cache_are_exclusive():
    with pytest.raises(ValueError, match="not both"):
        service.PtxServiceServer(compiler=Compiler(), remote_cache="http://127.0.0.1:9")


def test_service_runs_without_the_reference(tmp_path):
    """``python -m repro_torch.launch.ptx_service --bench`` in a subprocess
    that cannot import ``jax`` or ``repro``."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.argv = ['ptx_service', '--bench', '--requests', '6', '--clients', '2',\n"
        f"            '--benches', 'vecadd,jacobi', '--cache-dir', {str(tmp_path)!r}]\n"
        "runpy.run_module('repro_torch.launch.ptx_service', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('repro', 'jax')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=180, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr
    assert "ptx_service bench OK" in out.stdout
