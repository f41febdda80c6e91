"""Parity of the port's compiler driver (``repro_torch.core.driver``) with
the JAX package's: the printed PTX and the reports of every KernelGen
source under every target, the codegen modes and cost selection, the five
source forms, ``compile_many``'s dedup, the legacy shims, and the knobs
that run the e-graph and the static analyzer."""

import dataclasses
import enum
import warnings

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

import repro.core.passes.analyses as ref_analyses
from repro.core import driver as ref_driver
from repro.core import passes as ref_passes
from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.frontend.stencil import lower_to_ptx as ref_lower
from repro.core.ptx import parse as ref_parse
from repro.core.ptx import print_kernel as ref_print_kernel
from repro.core.synthesis import pipeline as ref_pipeline
from repro.core.targets import target_names as ref_target_names
from repro_torch.core import driver, passes
from repro_torch.core.frontend import kernelgen
from repro_torch.core.frontend.stencil import lower_to_ptx
from repro_torch.core.ptx import parse, print_kernel
from repro_torch.core.synthesis import pipeline
from repro_torch.core.targets import target_names

SOURCES = sorted(ref_kernelgen.all_benches(include_apps=True))
TARGETS = ref_target_names()
#: the sources the modes and cost selection are held on: a 2-D and a 3-D
#: stencil, a 3-D one with wide deltas, a negative case and an application
#: under the paper's |N| <= 1
MODE_SOURCES = ["jacobi", "tricubic", "wave13pt", "matmul", "hypterm"]
MODE_CASES = [dict(mode="ptxasw"), dict(mode="nocorner"), dict(mode="noload"),
              dict(selection="cost")]


#: an emulator counter that reads the growth of the process-wide term
#: intern tables, so it depends on what the process emulated before
HISTORY_COUNTERS = ("terms_interned",)


def counters(c):
    return {k: v for k, v in c.items() if k not in HISTORY_COUNTERS}


def view(obj):
    """Package-independent structure of a result, timings left out."""
    if dataclasses.is_dataclass(obj):
        out = [type(obj).__name__]
        for f in dataclasses.fields(obj):
            if f.name.endswith("time_s") or f.name == "module":
                continue
            v = getattr(obj, f.name)
            if f.name == "pass_times":
                v = sorted(v)
            elif f.name == "counters":
                v = counters(v)
            out.append((f.name, view(v)))
        return tuple(out)
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return tuple(sorted((k, view(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(view(x) for x in obj)
    return obj


def pairs(rep):
    return [(p.dst_uid, p.src_uid, p.delta) for p in rep.detection.pairs]


def assert_same_result(res, ref):
    assert res.ptx == ref.ptx
    assert [pairs(r) for r in res.reports] == [pairs(r) for r in ref.reports]
    assert [counters(r.counters) for r in res.reports] == \
        [counters(r.counters) for r in ref.reports]
    assert view(res) == view(ref)


def test_targets_and_sources_are_the_reference_s():
    assert target_names() == TARGETS and len(TARGETS) == 6
    assert sorted(kernelgen.all_benches(include_apps=True)) == SOURCES
    assert len(SOURCES) == 19


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", SOURCES)
def test_compile_matches_reference(name, target):
    """Default options: byte-equal PTX and equal reports, diagnostics and
    cache counters for every source under every target."""
    res = driver.Compiler().compile(kernelgen.get_bench(name), target=target)
    ref = ref_driver.Compiler().compile(ref_kernelgen.get_bench(name), target=target)
    assert_same_result(res, ref)
    assert res.reports[0].target == target


@pytest.mark.parametrize("case", MODE_CASES, ids=lambda c: "-".join(map(str, c.values())))
@pytest.mark.parametrize("name", MODE_SOURCES)
def test_modes_and_cost_selection_match_reference(name, case):
    """Each codegen mode, and cost selection with its per-pair scores,
    under the default target and under one that drops pairs (Kepler)."""
    for target in (None, "kepler"):
        res = driver.Compiler().compile(kernelgen.get_bench(name), target=target, **case)
        ref = ref_driver.Compiler().compile(ref_kernelgen.get_bench(name),
                                            target=target, **case)
        assert_same_result(res, ref)
        sel, ref_sel = res.reports[0].selection, ref.reports[0].selection
        assert (sel is None) == (ref_sel is None) == ("selection" not in case)
        if sel is not None:
            assert [(s.profit, s.profitable) for s in sel.scores] == \
                [(s.profit, s.profitable) for s in ref_sel.scores]


@pytest.mark.parametrize("name", SOURCES)
def test_analyze_matches_reference(name):
    """The analysis-only path the stencil kernels are built from."""
    res = driver.Compiler().analyze(kernelgen.get_bench(name))
    ref = ref_driver.Compiler().analyze(ref_kernelgen.get_bench(name))
    assert res.analysis_only and ref.analysis_only
    assert_same_result(res, ref)


@pytest.mark.parametrize("mode", ["ptxasw", "nocorner", "noload"])
def test_compile_bench_matches_reference(mode):
    b, kernel, rep = kernelgen.compile_bench("wave13pt", mode, compiler=driver.Compiler())
    rb, ref_kernel, ref_rep = ref_kernelgen.compile_bench("wave13pt", mode,
                                                          compiler=ref_driver.Compiler())
    assert repr(b.program) == repr(rb.program)
    assert print_kernel(kernel) == ref_print_kernel(ref_kernel)
    assert view(rep) == view(ref_rep)


def _forms(kg, lower, parse_):
    bench = kg.get_bench("jacobi")
    kernel = lower(bench.program)
    text = print_kernel(lower_to_ptx(kernelgen.get_bench("jacobi").program))
    return {"ptx": text, "module": parse_(text), "kernel": kernel,
            "stencil": bench.program, "kernelgen": bench}


@pytest.mark.parametrize("form", ["ptx", "module", "kernel", "stencil", "kernelgen"])
def test_source_forms_match_reference(form):
    src = _forms(kernelgen, lower_to_ptx, parse)[form]
    ref_src = _forms(ref_kernelgen, ref_lower, ref_parse)[form]
    res = driver.Compiler().compile(src)
    ref = ref_driver.Compiler().compile(ref_src)
    assert res.frontend == ref.frontend == form
    assert_same_result(res, ref)
    assert res.ptx == driver.Compiler().compile(kernelgen.get_bench("jacobi")).ptx


def _count_emulate(monkeypatch, module):
    calls = []
    real = module.emulate

    def counting(kernel, **kw):
        calls.append(kernel.name)
        return real(kernel, **kw)

    monkeypatch.setattr(module, "emulate", counting)
    return calls


def test_compile_many_emulates_as_often_as_reference(monkeypatch):
    port_calls = _count_emulate(monkeypatch, passes.analyses)
    ref_calls = _count_emulate(monkeypatch, ref_analyses)
    batch = ["jacobi", "laplacian", "jacobi", "jacobi", "laplacian", "jacobi",
             "hypterm"]
    with driver.Compiler(jobs=4) as cc:
        res = cc.compile_many([kernelgen.get_bench(n) for n in batch])
        stats = cc.cache_stats
    with ref_driver.Compiler(jobs=4) as cc:
        ref = cc.compile_many([ref_kernelgen.get_bench(n) for n in batch])
        ref_stats = cc.cache_stats
    assert sorted(port_calls) == sorted(ref_calls) == ["hypterm", "jacobi", "laplacian"]
    assert [r.ptx for r in res] == [r.ptx for r in ref]
    assert [r.cached for r in res] == [r.cached for r in ref]
    assert view(stats) == view(ref_stats)


def test_variants_match_reference():
    """Per-target variants over one shared detection, with cost selection."""
    cc, ref_cc = driver.Compiler(), ref_driver.Compiler()
    res = cc.variants(kernelgen.get_bench("tricubic"), selection="cost")
    ref = ref_cc.variants(ref_kernelgen.get_bench("tricubic"), selection="cost")
    assert list(res) == list(ref) == list(TARGETS)
    for name in TARGETS:
        # the targets run on threads, so each result's snapshot of the
        # session's counters depends on their order; the session's own
        # counters are held after the call
        assert_same_result(dataclasses.replace(res[name], cache_stats=None),
                           dataclasses.replace(ref[name], cache_stats=None))
    assert view(cc.cache_stats) == view(ref_cc.cache_stats)


def test_legacy_shims_match_reference():
    text = print_kernel(lower_to_ptx(kernelgen.get_bench("laplacian").program))
    out, reps = passes.compile_ptx(text, cache=None)
    ref_out, ref_reps = ref_passes.compile_ptx(text, cache=None)
    assert out == ref_out and view(reps) == view(ref_reps)
    kernel = parse(text).kernels[0]
    ref_kernel = ref_parse(text).kernels[0]
    k, rep = passes.compile_kernel(kernel, passes.PipelineConfig(target="pascal"), cache=None)
    rk, ref_rep = ref_passes.compile_kernel(ref_kernel, ref_passes.PipelineConfig(target="pascal"),
                                            cache=None)
    assert print_kernel(k) == ref_print_kernel(rk) and view(rep) == view(ref_rep)
    assert view(passes.analyze_kernel(kernel, cache=None)) == \
        view(ref_passes.analyze_kernel(ref_kernel, cache=None))
    per = passes.compile_for_targets(text, selection="cost", cache=None)
    ref_per = ref_passes.compile_for_targets(text, selection="cost", cache=None)
    assert {n: v.ptx for n, v in per.items()} == {n: v.ptx for n, v in ref_per.items()}
    assert {n: v.n_shuffles for n, v in per.items()} == \
        {n: v.n_shuffles for n, v in ref_per.items()}


def test_ptxasw_wrappers_warn_once_and_match_reference(monkeypatch):
    monkeypatch.setattr(pipeline, "_warned", False)
    monkeypatch.setattr(ref_pipeline, "_warned", False)
    text = print_kernel(lower_to_ptx(kernelgen.get_bench("jacobi").program))
    with pytest.warns(DeprecationWarning, match="repro_torch.core.driver.Compiler"):
        out, reps = pipeline.ptxasw(text, target="hopper")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        pipeline.ptxasw(text)               # one-shot: the second call is silent
        warnings.simplefilter("ignore", DeprecationWarning)
        ref_out, ref_reps = ref_pipeline.ptxasw(text, target="hopper")
    assert out == ref_out and view(reps) == view(ref_reps)


def test_json_wire_form_matches_reference():
    res = driver.Compiler().compile(kernelgen.get_bench("wave13pt"))
    ref = ref_driver.Compiler().compile(ref_kernelgen.get_bench("wave13pt"))
    wire, ref_wire = res.to_json_dict(), ref.to_json_dict()
    assert _strip_times(wire) == _strip_times(ref_wire)
    back = driver.CompileResult.from_json_dict(wire)
    assert back.ptx == res.ptx and back.n_shuffles == res.n_shuffles == 4


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: (sorted(v) if k == "pass_times" else _strip_times(v))
                for k, v in obj.items()
                if not k.endswith("time_s") and k not in HISTORY_COUNTERS}
    if isinstance(obj, list):
        return [_strip_times(x) for x in obj]
    return obj


#: each knob that runs ``egraph``, ``analysis.lint`` or ``analysis.relational``
KNOBS = [dict(saturate=True), dict(lint="warn"), dict(lint="strict"), dict(widen=True),
         dict(passes=("emulate-flows", "saturate", "extract", "detect-shuffles")),
         dict(passes=("emulate-flows", "verify-ptx", "detect-shuffles"))]


def _outcome(call):
    """A call's result, or its error's type and message."""
    try:
        return call()
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: "-".join(map(str, k.values())))
def test_knobs_match_reference(knob):
    """``compile``/``analyze``/``variants``/``prepare`` with the knob per
    call and per session, and a hand-built ``PassPipeline``, as the
    reference's."""
    src, ref_src = kernelgen.get_bench("tricubic"), ref_kernelgen.get_bench("tricubic")
    for cc, ref_cc, kw in ((driver.Compiler(), ref_driver.Compiler(), knob),
                           (driver.Compiler(**knob), ref_driver.Compiler(**knob), {})):
        for method in ("compile", "analyze"):
            res = getattr(cc, method)(src, target="hopper", **kw)
            ref = getattr(ref_cc, method)(ref_src, target="hopper", **kw)
            assert_same_result(res, ref)
            assert [f.to_dict() for f in res.findings] == [f.to_dict() for f in ref.findings]
        got = _outcome(lambda: cc.variants(src, targets=("pascal", "hopper"), **kw))
        want = _outcome(lambda: ref_cc.variants(ref_src, targets=("pascal", "hopper"), **kw))
        if isinstance(want, tuple):
            assert got == want and "passes=" in got[1]
        else:
            assert list(got) == list(want) == ["pascal", "hopper"]
            for name in got:
                assert_same_result(dataclasses.replace(got[name], cache_stats=None),
                                   dataclasses.replace(want[name], cache_stats=None))
        prep, ref_prep = cc.prepare(src, **kw), ref_cc.prepare(ref_src, **kw)
        assert prep.key == ref_prep.key
        assert view(prep.opts) == view(ref_prep.opts)
        assert cc.cache_stats.misses == ref_cc.cache_stats.misses > 0
    fields = {k: v for k, v in knob.items() if k != "passes"}
    pipe = passes.PassPipeline(passes=knob.get("passes"), config=passes.PipelineConfig(**fields))
    ref_pipe = ref_passes.PassPipeline(passes=knob.get("passes"),
                                       config=ref_passes.PipelineConfig(**fields))
    assert pipe.pass_names == ref_pipe.pass_names
    k, rep = pipe.run_kernel(lower_to_ptx(src.program))
    ref_k, ref_rep = ref_pipe.run_kernel(ref_lower(ref_src.program))
    assert print_kernel(k) == ref_print_kernel(ref_k)
    assert view(rep) == view(ref_rep)
