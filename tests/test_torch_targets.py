"""Parity of the port's target profiles, cost model, cycle model and
calibration (``repro_torch.core.targets``, ``core.emulator.cycles``) with
the JAX package's, and the paper's Fig. 2 keep/drop split through the
port's ``Compiler.variants``."""

import numpy as np
import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core.driver import Compiler as RefCompiler
from repro.core.emulator import concrete as ref_concrete
from repro.core.emulator import cycles as ref_cycles
from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.frontend.stencil import lower_to_ptx as ref_lower
from repro.core.passes import analyze_kernel as ref_analyze_kernel
from repro.core.synthesis.codegen import synthesize as ref_synthesize
from repro.core.targets import calibrate as ref_calibrate
from repro.core.targets import cost as ref_cost
from repro.core import targets as ref_targets
from repro_torch.core import targets
from repro_torch.core.driver import Compiler
from repro_torch.core.emulator import concrete, cycles
from repro_torch.core.frontend import kernelgen
from repro_torch.core.frontend.stencil import lower_to_ptx
from repro_torch.core.passes import analyze_kernel
from repro_torch.core.synthesis.codegen import synthesize
from repro_torch.core.targets import calibrate, cost

TARGETS = ref_targets.target_names()
TABLE1 = ("kepler", "maxwell", "pascal", "volta")
#: the benches with shuffle pairs whose scores are held
SCORED = ["jacobi", "gaussblur", "laplacian", "wave13pt", "whispering", "uxx1",
          "tricubic", "hypterm"]
SPECS = ["kepler", "volta", "HOPPER", "sm_30", "sm_35", "sm_52", "sm_61", "sm_70",
         "sm_75", "sm_80", "sm_86", "sm_90", "sm_90a", "sm_999",
         "sm_90a, texmode_independent", " sm_61 ", "sm_20", "sm_3", "turing-ish", ""]


@pytest.mark.parametrize("name", TARGETS)
def test_profiles_match_reference(name):
    prof, ref = targets.get_target(name), ref_targets.get_target(name)
    assert prof.to_dict() == ref.to_dict()
    for attr in ("sm_name", "full_membermask", "shfl_hide", "l1_over_shuffle"):
        assert getattr(prof, attr) == getattr(ref, attr)
    assert targets.TargetProfile.from_dict(ref.to_dict()) == prof
    assert targets.default_target().name == ref_targets.default_target().name == "volta"


def _resolve(module, spec):
    try:
        return module.resolve_target(spec).name
    except KeyError as e:
        return ("KeyError", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_resolution_matches_reference(spec):
    """Names, ``sm_XX`` strings and ``.target`` directives, and the errors."""
    assert _resolve(targets, spec) == _resolve(ref_targets, spec)


@pytest.mark.parametrize("target", TARGETS)
def test_score_pair_and_select_match_reference(target):
    for name in SCORED:
        b, rb = kernelgen.get_bench(name), ref_kernelgen.get_bench(name)
        det = analyze_kernel(lower_to_ptx(b.program), cache=None).detection
        ref_det = ref_analyze_kernel(ref_lower(rb.program), cache=None).detection
        for mode in ("ptxasw", "nocorner", "noload"):
            got = [cost.score_pair(p, target, mode=mode) for p in det.pairs]
            want = [ref_cost.score_pair(p, target, mode=mode) for p in ref_det.pairs]
            assert [(s.keep_load_cycles, s.shuffled_cycles) for s in got] == \
                [(s.keep_load_cycles, s.shuffled_cycles) for s in want], (name, mode)
            sel = cost.select(det, target, mode=mode)
            ref_sel = ref_cost.select(ref_det, target, mode=mode)
            assert (sel.target, sel.mode, sel.n_kept, sel.n_dropped, sel.summary) == \
                (ref_sel.target, ref_sel.mode, ref_sel.n_kept, ref_sel.n_dropped,
                 ref_sel.summary)
            assert [(p.dst_uid, p.src_uid, p.delta) for p in sel.selected.pairs] == \
                [(p.dst_uid, p.src_uid, p.delta) for p in ref_sel.selected.pairs]


def _jacobi_stats(conc, lower, kg, analyze, synth, synthesized):
    kernel = lower(kg.get_bench("jacobi").program)
    if synthesized:
        kernel = synth(kernel, analyze(kernel, cache=None).detection)
    rng = np.random.default_rng(0)
    ny, nx = 4, 1026
    params = {"w0": rng.standard_normal((ny, nx)).astype(np.float32),
              "w1": np.zeros((ny, nx), np.float32), "n0": nx, "n1": ny,
              "c0": conc.f32_bits(.5), "c1": conc.f32_bits(.25), "c2": conc.f32_bits(.125)}
    stats = conc.run_concrete(kernel, params, ntid=(512, 1, 1), nctaid=(2, ny - 2, 1))
    return stats, params["w1"]


@pytest.mark.parametrize("target", TARGETS)
def test_estimate_cycles_and_measured_profit_match_reference(target):
    port = [_jacobi_stats(concrete, lower_to_ptx, kernelgen, analyze_kernel, synthesize, s)
            for s in (False, True)]
    ref = [_jacobi_stats(ref_concrete, ref_lower, ref_kernelgen, ref_analyze_kernel,
                         ref_synthesize, s) for s in (False, True)]
    for (stats, out), (ref_stats, ref_out) in zip(port, ref):
        assert stats.counts == ref_stats.counts
        assert np.array_equal(out.view(np.uint32), ref_out.view(np.uint32))
        rep = cycles.estimate_cycles(stats, target)
        ref_rep = ref_cycles.estimate_cycles(ref_stats, target)
        assert (rep.arch, rep.cycles, rep.breakdown) == \
            (ref_rep.arch, ref_rep.cycles, ref_rep.breakdown)
    assert cost.measured_profit(port[0][0], port[1][0], target) == \
        ref_cost.measured_profit(ref[0][0], ref[1][0], target)
    table = cycles.speedup_table({"original": port[0][0], "ptxasw": port[1][0]}, [target])
    assert table == ref_cycles.speedup_table(
        {"original": ref[0][0], "ptxasw": ref[1][0]}, [target])


@pytest.mark.parametrize("gen", TABLE1)
def test_calibration_matches_reference(gen):
    """The fit on the concrete-emulator backend, and its registration undone."""
    tuned = f"{gen}-tuned"
    try:
        fit = calibrate.calibrate(gen)
        assert targets.resolve_target(tuned) is fit.profile
        ref_fit = ref_calibrate.calibrate(gen, register=False)
    finally:
        targets.unregister_target(tuned)
    with pytest.raises(KeyError):
        targets.resolve_target(tuned)
    assert tuned not in targets.target_names()
    got, want = fit.fitted_params(), ref_fit.fitted_params()
    assert set(got) == set(want) == set(calibrate.FITTED_PARAMS)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=0), k
    assert fit.quality == pytest.approx(ref_fit.quality, rel=1e-9)
    fitted = ("latency", "mlp", "shfl_ilp")
    assert {k: v for k, v in fit.profile.to_dict().items() if k not in fitted} == \
        {k: v for k, v in ref_fit.profile.to_dict().items() if k not in fitted}
    assert fit.max_rel_error(gen) <= 0.01


def test_fig2_split_and_hopper_encoding_through_variants():
    """Jacobi under cost selection: Pascal and Maxwell keep all 6 pairs,
    Kepler and Volta drop some (the paper's Fig. 2), equal to the
    reference target by target; every shuffle line of Hopper's PTX is
    ``shfl.sync`` with the full membermask, and the pre-Volta targets use
    the legacy encoding."""
    res = Compiler().variants(kernelgen.get_bench("jacobi"), selection="cost")
    ref = RefCompiler().variants(ref_kernelgen.get_bench("jacobi"), selection="cost")
    kept = {t: r.reports[0].selection.n_kept for t, r in res.items()}
    assert kept == {t: r.reports[0].selection.n_kept for t, r in ref.items()}
    assert kept["pascal"] == kept["maxwell"] == 6
    assert kept["kepler"] < 6 and kept["volta"] < 6
    for t in TARGETS:
        assert res[t].ptx == ref[t].ptx
    all_pairs = Compiler().compile(kernelgen.get_bench("jacobi"), target="hopper").ptx
    for text, name in ((all_pairs, "hopper"), (res["pascal"].ptx, "pascal")):
        lines = [ln for ln in text.splitlines() if "shfl." in ln]
        assert lines, name
        if name == "hopper":
            assert all("shfl.sync." in ln and ln.rstrip(";").endswith("0xffffffff")
                       for ln in lines)
        else:
            assert all("sync" not in ln and "0xffffffff" not in ln for ln in lines)
