"""Parity of the port's equality-saturation middle-end (the ``saturate``
and ``extract`` passes over ``repro_torch.core.egraph``) and of the whole
middle-end's knobs with the JAX package's: the 19 KernelGen sources for
``hopper`` under ``saturate``, ``widen`` and ``lint`` each alone and all
together, 5 sources under every target with all three, the differential
soundness gate (a true rewrite accepted, the planted miscompile caught, a
rejected rewrite dropped with a warning), and the off/on cache split."""

import copy
import dataclasses

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import driver as ref_driver
from repro.core.egraph import verify as ref_verify
from repro.core.egraph.extract import extract_kernel as ref_extract_kernel
from repro.core.egraph.saturate import run_saturate as ref_run_saturate
from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.frontend.stencil import lower_to_ptx as ref_lower
from repro.core.passes.context import KernelContext as RefContext
from repro.core.passes.context import PipelineConfig as RefConfig
from repro.core.ptx import print_kernel as ref_print_kernel
from repro.core.targets import resolve_target as ref_resolve_target
from repro.core.targets import target_names as ref_target_names
from repro_torch.core import driver
from repro_torch.core.driver import Severity
from repro_torch.core.egraph import verify
from repro_torch.core.egraph.extract import extract_kernel
from repro_torch.core.egraph.saturate import run_saturate
from repro_torch.core.frontend import kernelgen
from repro_torch.core.frontend.stencil import lower_to_ptx
from repro_torch.core.passes.context import KernelContext, PipelineConfig
from repro_torch.core.ptx import print_kernel
from repro_torch.core.targets import resolve_target

SOURCES = sorted(ref_kernelgen.all_benches(include_apps=True))
TARGETS = ref_target_names()
#: the driver tests' mode sources: 2-D and 3-D stencils, wide deltas, a
#: negative case and an application
TARGET_SOURCES = ["jacobi", "tricubic", "wave13pt", "matmul", "hypterm"]
ALL_KNOBS = dict(saturate=True, widen=True, lint="strict")
KNOBS = {"saturate": dict(saturate=True), "widen": dict(widen=True),
         "lint-warn": dict(lint="warn"), "lint-strict": dict(lint="strict"),
         "all": ALL_KNOBS}


def outcome(res):
    """A result in package-free terms: PTX, per-kernel pairs and counters
    (less the process-history counter), findings, diagnostics."""
    return {
        "ptx": res.ptx,
        "pairs": [[(p.dst_uid, p.src_uid, p.delta) for p in r.detection.pairs]
                  for r in res.reports],
        "counters": [{k: v for k, v in r.counters.items() if k != "terms_interned"}
                     for r in res.reports],
        "saturation": res.saturation_counters,
        "lint": res.lint_counters,
        "findings": [f.to_dict() for f in res.findings],
        "diagnostics": [(d.severity.name, d.message, d.source, d.kernel, d.code, d.location)
                        for d in res.diagnostics],
        "passes": sorted(res.pass_times),
    }


def both(name, **opts):
    with driver.Compiler(jobs=0, **opts) as cc:
        res = cc.compile(kernelgen.get_bench(name), cache=None)
    with ref_driver.Compiler(jobs=0, **opts) as cc:
        ref = cc.compile(ref_kernelgen.get_bench(name), cache=None)
    return res, ref


def _no_gate_failure(res):
    assert res.saturation_counters.get("sat_soundness_failures", 0) == 0
    assert not res.diagnostics_at(Severity.ERROR)
    assert not [d for d in res.diagnostics if "soundness gate" in d.message]


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("name", SOURCES)
def test_knobs_on_sources_match_reference(name, knobs):
    """Byte-equal PTX and equal reports, ``sat_*``/``lint_*`` counters,
    findings and diagnostics for ``hopper``."""
    res, ref = both(name, target="hopper", **KNOBS[knobs])
    assert outcome(res) == outcome(ref)
    _no_gate_failure(res)
    assert bool(res.saturation_counters) == ("saturate" in KNOBS[knobs])
    if KNOBS[knobs].get("saturate"):
        assert res.saturation_counters["sat_eclasses"] > 0


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", TARGET_SOURCES)
def test_all_knobs_under_every_target_match_reference(name, target):
    res, ref = both(name, target=target, **ALL_KNOBS)
    assert outcome(res) == outcome(ref)
    assert res.reports[0].target == target
    _no_gate_failure(res)


def test_saturated_suite_module_matches_reference():
    """The 16 suite kernels as one module (the reference test's soundness
    sweep): equal output, zero gate failures."""
    module = "".join(print_kernel(lower_to_ptx(b.program))
                     for _, b in sorted(kernelgen.all_benches().items()))
    with driver.Compiler(jobs=0, saturate=True) as cc:
        res = cc.compile(module, cache=None)
    with ref_driver.Compiler(jobs=0, saturate=True) as cc:
        ref = cc.compile(module, cache=None)
    assert outcome(res) == outcome(ref)
    _no_gate_failure(res)
    assert len(res.reports) == 16


# ---------------------------------------------------------------------------
# the differential soundness gate
# ---------------------------------------------------------------------------

def test_differential_gate_accepts_true_rewrite_like_reference():
    ctx = KernelContext(lower_to_ptx(kernelgen.get_bench("vecadd").program),
                        PipelineConfig(saturate=True))
    ref_ctx = RefContext(ref_lower(ref_kernelgen.get_bench("vecadd").program),
                         RefConfig(saturate=True))
    run_saturate(ctx)
    ref_run_saturate(ref_ctx)
    res = extract_kernel(ctx.kernel, ctx.products.pop("_egraph_state"), resolve_target(None))
    ref = ref_extract_kernel(ref_ctx.kernel, ref_ctx.products.pop("_egraph_state"),
                             ref_resolve_target(None))
    assert (res.rewrites, res.deleted, res.cycle_delta) == \
        (ref.rewrites, ref.deleted, ref.cycle_delta)
    assert res.rewrites > 0
    assert print_kernel(res.kernel) == ref_print_kernel(ref.kernel)
    assert verify.differential_check(ctx.kernel, res.kernel) is None
    assert ref_verify.differential_check(ref_ctx.kernel, ref.kernel) is None


def _miscompiled(lower, name="vecadd"):
    """The reference test's planted miscompile: vecadd's add.f32 made a
    sub.f32."""
    bench = (kernelgen if lower is lower_to_ptx else ref_kernelgen).get_bench(name)
    k = lower(bench.program)
    broken = copy.copy(k)
    body = list(k.body)
    [i] = [i for i, s in enumerate(body) if getattr(s, "opcode", "") == "add.f32"][:1]
    body[i] = dataclasses.replace(body[i], opcode="sub.f32")
    broken.body = body
    return k, broken


def test_differential_gate_catches_planted_miscompile_like_reference():
    reason = verify.differential_check(*_miscompiled(lower_to_ptx))
    ref_reason = ref_verify.differential_check(*_miscompiled(ref_lower))
    assert reason is not None
    assert reason == ref_reason


def test_gate_failure_drops_rewrite_and_warns_like_reference(monkeypatch):
    """A gate that rejects: the original kernel ships, the failure is
    counted and a WARNING names the gate, in both packages."""
    for mod in (verify, ref_verify):
        monkeypatch.setattr(mod, "differential_check",
                            lambda *a, **k: "planted gate failure")
    off, _ = both("vecadd")
    res, ref = both("vecadd", saturate=True)
    assert outcome(res) == outcome(ref)
    assert res.ptx == off.ptx
    assert res.saturation_counters["sat_soundness_failures"] == 1
    assert any("soundness gate" in d.message for d in res.diagnostics_at(Severity.WARNING))


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_off_then_on_not_cross_served():
    """off and on are distinct entries in one session, as in the
    reference; the off entry still serves after the on compile."""
    with driver.Compiler(jobs=0) as cc:
        r_off = cc.compile(kernelgen.get_bench("vecadd"))
        r_on = cc.compile(kernelgen.get_bench("vecadd"), saturate=True)
        assert not r_on.reports[0].cached
        assert r_on.ptx != r_off.ptx
        assert cc.compile(kernelgen.get_bench("vecadd")).reports[0].cached
        assert cc.compile(kernelgen.get_bench("vecadd"), saturate=True).reports[0].cached
    assert PipelineConfig(saturate=True).cache_token() == \
        RefConfig(saturate=True).cache_token()
    assert PipelineConfig().cache_token() != PipelineConfig(saturate=True).cache_token()


def test_saturated_entry_round_trips_from_disk(tmp_path):
    """A saturated, linted, widened entry read back by a fresh session:
    no pass runs, and the result equals the cold one."""
    with driver.Compiler(jobs=0, cache_dir=str(tmp_path), **ALL_KNOBS) as cc:
        cold = cc.compile(kernelgen.get_bench("hypterm"), target="hopper")
    with driver.Compiler(jobs=0, cache_dir=str(tmp_path), **ALL_KNOBS) as cc:
        warm = cc.compile(kernelgen.get_bench("hypterm"), target="hopper")
        assert cc.cache_stats.disk_hits == 1 and not cc.pass_times
    assert warm.reports[0].cached
    assert outcome(warm) == outcome(cold)
