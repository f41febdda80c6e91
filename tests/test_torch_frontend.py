"""Parity of the port's middle-end (``repro_torch.core``) with the JAX
package's: PTX lowering, symbolic emulation + shuffle detection, and the
CUDA shuffle schedule, on every KernelGen benchmark."""

import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core.driver import Compiler
from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.frontend import stencil as ref_dsl
from repro.core.frontend.pallas_lower import synthesize_tpu
from repro_torch.core.driver import Compiler as PortCompiler
from repro_torch.core.frontend import cuda_lower, kernelgen
from repro_torch.core.frontend import stencil as dsl
from repro_torch.core.frontend.cuda_lower import synthesize_cuda
from repro_torch.interop import program_from_reference

BENCHES = sorted(ref_kernelgen.all_benches(include_apps=True))
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _norm(obj):
    """Package-independent structure: class names and field values."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            _norm(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(_norm(x) for x in obj)
    return obj


def test_bench_catalog_matches_reference():
    assert sorted(kernelgen.all_benches(include_apps=True)) == BENCHES
    assert len(BENCHES) == 19


@pytest.mark.parametrize("name", BENCHES)
def test_programs_carry_over(name):
    """The port's catalog program equals the reference's, and
    ``program_from_reference`` rebuilds it field for field."""
    ref_prog = ref_kernelgen.get_bench(name).program
    port_prog = kernelgen.get_bench(name).program
    assert repr(port_prog) == repr(ref_prog)
    carried = program_from_reference(ref_prog)
    assert isinstance(carried, dsl.Program)
    assert repr(carried) == repr(ref_prog)


@pytest.mark.parametrize("name", BENCHES)
def test_lowering_and_detection_match_reference(name):
    ref_b = ref_kernelgen.get_bench(name)
    b = kernelgen.get_bench(name)
    assert b.max_delta == ref_b.max_delta

    ref_kernel = ref_dsl.lower_to_ptx(ref_b.program)
    kernel = dsl.lower_to_ptx(b.program)
    assert _norm(kernel) == _norm(ref_kernel)

    ref_det = Compiler().analyze(
        ref_b.program, max_delta=ref_b.max_delta).reports[0].detection
    det = synthesize_cuda(b.program, max_delta=b.max_delta).detection
    pairs = [(p.dst_uid, p.src_uid, p.delta) for p in det.pairs]
    assert pairs == [(p.dst_uid, p.src_uid, p.delta) for p in ref_det.pairs]
    assert (det.n_loads, det.n_flows) == (ref_det.n_loads, ref_det.n_flows)
    # and both reproduce the paper's Table 2 row
    assert (det.n_shuffles, det.n_loads) == (b.expect_shuffles, b.expect_loads)


@pytest.mark.parametrize("name", BENCHES)
def test_cuda_schedule_consistent_with_detection(name):
    b = kernelgen.get_bench(name)
    plan = synthesize_cuda(b.program, max_delta=b.max_delta)
    assert plan.consistent
    ref = synthesize_tpu(ref_kernelgen.get_bench(name).program,
                         max_delta=b.max_delta)
    assert (plan.n_shuffles, plan.n_taps, plan.n_row_covered) == \
        (ref.n_shuffles, ref.n_taps, ref.n_row_covered)
    for row in plan.schedule:
        for dst, src, delta in row.covered:
            assert src in row.sources and delta == dst - src
            assert 0 < abs(delta) <= min(b.max_delta, 31)


@pytest.mark.parametrize("mutation", ["negate", "rotate"])
def test_cuda_plan_refuses_detection_that_moves_other_taps(monkeypatch, mutation):
    """A detection with as many pairs as the schedule, but other deltas
    (``negate``) or the same deltas on other taps (``rotate``), is not
    ``consistent``, and no kernel is built from it."""
    from repro_torch.kernels.stencil import ops

    b = kernelgen.get_bench("jacobi")
    det = PortCompiler().analyze(b.program, max_delta=b.max_delta).reports[0].detection
    deltas = [p.delta for p in det.pairs]
    if mutation == "negate":
        deltas[0] = -deltas[0]
    else:
        deltas = deltas[1:] + deltas[:1]
    assert deltas != [p.delta for p in det.pairs]
    wrong = dataclasses.replace(det, pairs=[
        dataclasses.replace(p, delta=d) for p, d in zip(det.pairs, deltas)])

    class WrongSession:
        def analyze(self, src, max_delta):
            return types.SimpleNamespace(
                reports=[types.SimpleNamespace(detection=wrong)])

    monkeypatch.setattr(cuda_lower, "default_compiler", WrongSession)

    plan = synthesize_cuda(b.program, max_delta=b.max_delta)
    assert plan.n_shuffles == plan.n_row_covered and not plan.consistent
    with pytest.raises(ValueError, match="disagrees"):
        ops.build_kernels([(b.program, "paper", b.max_delta)])


def test_detection_finds_conv_deltas():
    """The port's counterpart of the reference's conv1d test: a width-4
    causal 1-D stencil yields 3 shuffles with deltas {1, 2, 3}."""
    x = dsl.Array("x")
    expr = (0.1 * x[dsl.I(-3)] + 0.2 * x[dsl.I(-2)] + 0.3 * x[dsl.I(-1)]
            + 0.4 * x[dsl.I(0)])
    prog = dsl.Program(name="conv1d", ndim=1, out=dsl.Array("y")[dsl.I()],
                       expr=expr)
    det = PortCompiler().analyze(prog).reports[0].detection
    assert sorted(p.delta for p in det.pairs) == [1, 2, 3]
    plan = synthesize_cuda(prog)
    assert plan.consistent
    assert sorted(d for r in plan.schedule for _, _, d in r.covered) == [1, 2, 3]


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any import of jax now fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro.")
                     or ((m == "jax" or m.startswith("jax.")) and sys.modules[m] is not None))
        assert not bad, bad
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    for pkg in ("configs", "models", "data", "serve", "launch", "train", "checkpoint",
                "runtime", "kernels.conv1d", "kernels.ssd", "kernels.flash_attention"):
        assert f"repro_torch.{pkg}" in names, pkg
    for mod in ("configs.mamba2_1_3b", "configs.zamba2_1_2b", "configs.olmo_1b",
                "configs.yi_9b", "configs.starcoder2_3b", "configs.deepseek_67b",
                "configs.granite_moe_1b_a400m", "configs.kimi_k2_1t_a32b",
                "configs.seamless_m4t_large_v2", "configs.llama_3_2_vision_90b",
                "models.moe", "models.accounting",
                "interop", "models.mamba2",
                "models.attention", "models.mlp", "models.lm",
                "data.pipeline", "serve.step", "launch.serve",
                "kernels.conv1d.ops", "kernels.ssd.ops",
                "kernels.flash_attention.ops", "kernels.flash_attention.ref",
                "kernels.autograd", "train.optim", "train.step", "checkpoint.store",
                "runtime.health", "launch.train", "launch.ptx_service",
                "core.egraph", "core.egraph.extract", "core.egraph.verify",
                "core.analysis.lint", "core.analysis.relational",
                "launch.fleet", "launch.fleet.__main__", "launch.fleet.coalesce",
                "launch.fleet.frontend", "launch.fleet.queue", "launch.fleet.remote_cache",
                "launch.fleet.smoke", "launch.fleet.stats"):
        assert f"repro_torch.{mod}" in names, mod
