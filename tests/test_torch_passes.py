"""Parity of the port's pass manager and cache tiers
(``repro_torch.core.passes``) with the JAX package's: the registries, the
memoized analyses, the content-addressed cache keys, a scripted session's
counters, and the disk tier (shared by processes, bounded by GC, a torn
entry a miss, and never a reader of the reference package's entries)."""

import dataclasses
import enum
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import driver as ref_driver
from repro.core import passes as ref_passes
from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.frontend.stencil import lower_to_ptx as ref_lower
from repro.core.passes import diskcache as ref_diskcache
from repro_torch.core import driver, passes
from repro_torch.core.frontend import kernelgen
from repro_torch.core.frontend.stencil import lower_to_ptx
from repro_torch.core.passes import diskcache
from repro_torch.core.ptx import print_kernel

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def view(obj):
    """Package-independent structure: class names, fields and values."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            (f.name, view(getattr(obj, f.name))) for f in dataclasses.fields(obj)
            if not f.name.endswith("time_s"))
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return tuple(sorted((view(k), view(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(view(x) for x in obj)
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted(view(x) for x in obj))
    if type(obj).__module__.split(".")[0] in ("repro", "repro_torch"):
        # a symbolic term or fact: its class and its printed form
        return (type(obj).__name__, repr(obj))
    return obj


def test_registries_match_reference():
    # the uniformity analyses register when ``core.analysis`` is first
    # imported, which a pipeline does at its first run, and the relational
    # ones when a lint or widened run first needs them: import both here
    import repro.core.analysis.relational  # noqa: F401
    import repro_torch.core.analysis.relational  # noqa: F401

    assert sorted(passes.PASS_REGISTRY) == sorted(ref_passes.PASS_REGISTRY)
    assert sorted(passes.ANALYSIS_REGISTRY) == sorted(ref_passes.ANALYSIS_REGISTRY)
    for name in ("ANALYSIS_PASSES", "SYNTHESIS_PASSES", "DEFAULT_PASSES"):
        assert getattr(passes, name) == getattr(ref_passes, name)


@pytest.mark.parametrize("name", ["jacobi", "whispering", "tricubic", "matvec", "hypterm"])
def test_analyses_match_reference(name):
    """Every analysis the port registers, on one kernel context each."""
    import repro.core.analysis.relational  # noqa: F401
    import repro_torch.core.analysis.relational  # noqa: F401

    ctx = passes.KernelContext(lower_to_ptx(kernelgen.get_bench(name).program))
    ref_ctx = ref_passes.KernelContext(ref_lower(ref_kernelgen.get_bench(name).program))
    for analysis in sorted(passes.ANALYSIS_REGISTRY):
        if analysis in ("decoded", "flows"):
            continue             # emulator internals, held through detection
        assert view(ctx.get(analysis)) == view(ref_ctx.get(analysis)), analysis
    assert ctx.stats["computed"] == len(ctx._analyses)
    before = ctx.stats["computed"]
    ctx.get("cfg")
    assert ctx.stats["computed"] == before          # memoized


CONFIGS = [dict(), dict(target="sm_61", selection="cost"),
           dict(mode="noload", max_delta=1, max_flows=64)]


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: "-".join(map(str, c.values())) or "default")
@pytest.mark.parametrize("name", ["jacobi", "tricubic", "hypterm"])
def test_cache_keys_match_reference(name, config):
    text = print_kernel(lower_to_ptx(kernelgen.get_bench(name).program))
    for pass_list in (passes.DEFAULT_PASSES, passes.ANALYSIS_PASSES):
        key = passes.CompileCache.key(text, passes.PipelineConfig(**config), pass_list)
        ref_key = ref_passes.CompileCache.key(text, ref_passes.PipelineConfig(**config),
                                              pass_list)
        assert key == ref_key
        # the disk tier's entry names differ, so the packages never share one
        assert diskcache.entry_digest(key) != ref_diskcache.entry_digest(key)


def _script(drv, kg):
    """A session's calls, with its counters read after each."""
    cc = drv.Compiler()
    steps = [
        lambda: cc.compile(kg.get_bench("jacobi")),
        lambda: cc.compile(kg.get_bench("jacobi")),
        lambda: cc.analyze(kg.get_bench("jacobi")),
        lambda: cc.analyze(kg.get_bench("jacobi").program),
        lambda: cc.compile(kg.get_bench("jacobi"), target="hopper"),
        lambda: cc.variants(kg.get_bench("laplacian"), targets=["pascal", "volta"]),
        lambda: cc.compile(kg.get_bench("laplacian"), target="sm_61"),
        lambda: cc.compile(kg.get_bench("hypterm"), max_delta=31),
        lambda: cc.compile(kg.get_bench("hypterm")),
        lambda: cc.compile(kg.get_bench("hypterm"), cache=None),
        lambda: cc.compile_many([kg.get_bench("sincos"), kg.get_bench("jacobi"),
                                 kg.get_bench("sincos")]),
    ]
    out = []
    for step in steps:
        step()
        out.append(view(cc.cache_stats.snapshot()))
    # less the one counter that reads the growth of the process-wide term
    # intern tables, which depends on what the process emulated before
    out.append((cc.n_runs, sorted(cc.pass_times),
                view({k: v for k, v in cc.counters.items() if k != "terms_interned"})))
    cc.close()
    return out


def test_session_counters_sequence_matches_reference():
    assert _script(driver, kernelgen) == _script(ref_driver, ref_kernelgen)


def test_memory_tier_lru_and_isolation():
    cache = passes.CompileCache(max_entries=2)
    ref_cache = ref_passes.CompileCache(max_entries=2)
    for c, pk, lower, kg in ((cache, passes, lower_to_ptx, kernelgen),
                             (ref_cache, ref_passes, ref_lower, ref_kernelgen)):
        for name in ("jacobi", "laplacian", "jacobi", "vecadd", "laplacian"):
            kernel = lower(kg.get_bench(name).program)
            key = pk.CompileCache.key(name, pk.PipelineConfig(), ("t",))
            if c.get(key) is None:
                c.put(key, kernel, pk.KernelReport(name=name))
        hit = c.get(pk.CompileCache.key("laplacian", pk.PipelineConfig(), ("t",)))
        hit[1].counters["poison"] = 1
        again = c.get(pk.CompileCache.key("laplacian", pk.PipelineConfig(), ("t",)))
        assert again[1].cached and "poison" not in again[1].counters
    assert view(cache.stats.snapshot()) == view(ref_cache.stats.snapshot())


# ---------------------------------------------------------------------------
# the disk tier
# ---------------------------------------------------------------------------

def _entry(tag="t", name="vecadd"):
    kernel = lower_to_ptx(kernelgen.get_bench(name).program)
    key = passes.CompileCache.key(print_kernel(kernel), passes.PipelineConfig(), (tag,))
    return key, kernel, passes.KernelReport(name=name, pass_times={"emulate-flows": 0.01})


def test_disk_round_trip_and_promotion(tmp_path):
    key, kernel, report = _entry()
    disk = diskcache.DiskCache(tmp_path)
    passes.CompileCache(disk=disk).put(key, kernel, report)
    second = passes.CompileCache(disk=disk)
    got_kernel, got = second.get(key)
    assert print_kernel(got_kernel) == print_kernel(kernel) and got.cached
    assert second.get(key) is not None
    s = second.stats.snapshot()
    assert (s.hits, s.misses, s.disk_hits, s.disk_misses) == (1, 1, 1, 0)
    meta = json.loads((disk.path_for(key) / "meta.json").read_text())
    assert meta == {"package": "repro_torch", "schema": diskcache.SCHEMA_VERSION,
                    "key": key}


@pytest.mark.parametrize("victim", ["report.pkl", "kernel.ptx", "meta.json", "whole",
                                    "not-a-dataclass", "foreign-class"])
def test_torn_or_foreign_entry_is_a_miss(tmp_path, victim):
    key, kernel, report = _entry(tag=victim)
    disk = diskcache.DiskCache(tmp_path)
    disk.store(key, kernel, report)
    entry = disk.path_for(key)
    if victim == "whole":
        shutil.rmtree(entry)
    elif victim == "not-a-dataclass":
        (entry / "report.pkl").write_bytes(pickle.dumps({"not": "a dataclass"}))
    elif victim == "foreign-class":
        # a report naming a class outside the package is refused unread
        (entry / "report.pkl").write_bytes(pickle.dumps(ref_passes.KernelReport(name="x")))
    else:
        blob = (entry / victim).read_bytes()
        (entry / victim).write_bytes(blob[: len(blob) // 2])
    cache = passes.CompileCache(disk=disk)
    got = cache.get(key)
    if victim == "meta.json":
        assert got is not None          # the reader needs only the kernel and report
        return
    assert got is None
    assert cache.stats.snapshot().disk_misses == 1


def test_disk_gc_by_size_evicts_oldest(tmp_path):
    keys = []
    big = diskcache.DiskCache(tmp_path, max_bytes=1 << 30)
    for i in range(3):
        key, kernel, report = _entry(tag=f"gc{i}")
        big.store(key, kernel, report)
        os.utime(big.path_for(key), (1000 + i, 1000 + i))
        keys.append(key)
    entry_bytes = sum(f.stat().st_size for f in big.path_for(keys[0]).iterdir())
    bounded = diskcache.DiskCache(tmp_path, max_bytes=entry_bytes)
    assert bounded.gc() == 2 and len(bounded) == 1
    assert bounded.load(keys[2]) is not None
    assert bounded.load(keys[0]) is None and bounded.load(keys[1]) is None
    cache = passes.CompileCache(disk=diskcache.DiskCache(tmp_path, max_bytes=1))
    key, kernel, report = _entry(tag="over")
    cache.put(key, kernel, report)
    assert cache.stats.snapshot().disk_evictions >= 1


_CHILD = textwrap.dedent("""
    import json, shutil, sys
    from pathlib import Path
    from repro_torch.core.driver import Compiler
    from repro_torch.core.frontend.kernelgen import get_bench
    from repro_torch.core.passes import diskcache

    cache_dir, forge = sys.argv[1], sys.argv[2] == "forge"
    names = sys.argv[3:]
    if forge:
        # put each of the reference's entries where the port would look
        # for the same key
        for meta in list(Path(cache_dir).glob("*/*/meta.json")):
            key = json.loads(meta.read_text())["key"]
            dst = diskcache.DiskCache(cache_dir).path_for(key)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copytree(meta.parent, dst)
    cc = Compiler(cache_dir=cache_dir)
    res = [cc.compile(get_bench(n)) for n in names]
    print(json.dumps({
        "cached": [r.cached for r in res], "ptx": [r.ptx for r in res],
        "pass_times": sorted(cc.pass_times), "stats": cc.cache_stats.to_dict(),
        "reference_imported": sorted(m for m in sys.modules
                                     if m == "repro" or m.startswith("repro.")),
    }))
""")


def _spawn(cache_dir, names, forge=False):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", _CHILD, str(cache_dir),
                          "forge" if forge else "plain", *names],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_two_processes_share_a_directory_with_no_reemulation(tmp_path):
    names = ["jacobi", "hypterm"]
    first = _spawn(tmp_path, names)
    assert first["cached"] == [False, False] and "emulate-flows" in first["pass_times"]
    second = _spawn(tmp_path, names)
    assert second["cached"] == [True, True]
    assert (second["stats"]["disk_hits"], second["stats"]["disk_misses"]) == (2, 0)
    assert second["pass_times"] == [], "a disk-served compile ran a pass"
    ref = [ref_driver.Compiler().compile(ref_kernelgen.get_bench(n)).ptx for n in names]
    assert second["ptx"] == first["ptx"] == ref
    assert first["reference_imported"] == second["reference_imported"] == []


@pytest.mark.parametrize("forge", [False, True], ids=["shared", "forged"])
def test_reference_written_directory_reads_as_misses(tmp_path, forge):
    """A directory the reference filled is all misses for the port, even
    with the reference's entries copied under the port's own names, and
    the port never imports the reference to find that out."""
    names = ["jacobi", "laplacian", "vecadd"]
    with ref_driver.Compiler(cache_dir=str(tmp_path)) as cc:
        ref = [cc.compile(ref_kernelgen.get_bench(n)).ptx for n in names]
    assert len(list(tmp_path.glob("*/*/meta.json"))) == 3
    got = _spawn(tmp_path, names, forge=forge)
    assert got["reference_imported"] == []
    assert got["cached"] == [False] * 3 and "emulate-flows" in got["pass_times"]
    assert (got["stats"]["disk_hits"], got["stats"]["disk_misses"]) == (0, 3)
    assert got["ptx"] == ref
