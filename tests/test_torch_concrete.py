"""The port's concrete warp emulator, PTX parser/printer and codegen
(``repro_torch.core.emulator.concrete``, ``core.ptx``,
``core.synthesis.codegen``) against the JAX package's: the original and
the synthesized PTX of each stencil bench run bit for bit as the
reference's do, synthesis changes no output (also over random 2-D
stencils), and the outputs agree with the port's plain stencil version."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:               # degrade: property tests skip
    from _hypothesis_stub import given, settings, st

from repro.core.driver import Compiler as RefCompiler
from repro.core.emulator import concrete as ref_concrete
from repro.core.emulator.observe import extract_features as ref_extract_features
from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.frontend.stencil import lower_to_ptx as ref_lower
from repro.core.ptx import parse as ref_parse
from repro.core.ptx import parse_instr as ref_parse_instr
from repro.core.ptx import print_kernel as ref_print_kernel
from repro_torch.core.driver import Compiler
from repro_torch.core.emulator import concrete
from repro_torch.core.emulator.observe import extract_features
from repro_torch.core.frontend import kernelgen
from repro_torch.core.frontend.stencil import Array, I, J, Program, lower_to_ptx
from repro_torch.core.ptx import parse, parse_instr, print_kernel, print_module
from repro_torch.kernels.stencil import reference

#: the benches whose ``paper`` kernel the card builds, the second tricubic
#: and an application stencil under the paper's |N| <= 1
CONCRETE = ["jacobi", "gaussblur", "laplacian", "wave13pt", "whispering", "gradient",
            "divergence", "gameoflife", "lapgsrb", "uxx1", "tricubic", "sincos",
            "vecadd", "tricubic2", "hypterm"]
SOURCES = sorted(ref_kernelgen.all_benches(include_apps=True))
TOL = 2e-4                        # the stencil kernel's tolerance


def run_versions(conc, lower, compiler, prog, max_delta=31, nx=70, ny=6, nz=5,
                 block_x=64):
    """``tests/test_core_pipeline.py::_run_versions`` for either package:
    the original and the synthesized kernel on the same inputs, drawn
    from ``default_rng(0)``.  Returns the outputs, the inputs and the
    ``RunStats`` of each run."""
    kernel = lower(prog)
    syn = compiler.compile(kernel, max_delta=max_delta).module.kernels[0]
    nd = prog.ndim
    shape = {1: (nx,), 2: (ny, nx), 3: (nz, ny, nx)}[nd]
    h = prog.halo
    nbx = -(-(shape[-1] - 2 * h[0]) // block_x)
    if nd == 1:
        grid = (nbx, 1, 1)
    elif nd == 2:
        grid = (nbx, shape[0] - 2 * h[1], 1)
    else:
        grid = (nbx, shape[1] - 2 * h[1], shape[0] - 2 * h[2])
    outs, stats = [], []
    for k in (kernel, syn):
        rng = np.random.default_rng(0)            # same inputs for both versions
        params = {arr: (np.zeros(shape[-adim:], np.float32) if arr == prog.out.array
                        else rng.standard_normal(shape[-adim:]).astype(np.float32))
                  for arr, adim in prog.arrays.items()}
        inputs = {a: v.copy() for a, v in params.items() if a != prog.out.array}
        for d in range(nd):
            params[f"n{d}"] = shape[::-1][d]
        for s in prog.scalars:
            params[s] = conc.f32_bits(0.3)
        stats.append(conc.run_concrete(k, params, ntid=(block_x, 1, 1), nctaid=grid))
        outs.append(params[prog.out.array].copy())
    return outs, inputs, stats


def plain_gap(prog, out, inputs) -> float:
    """Largest gap between the emulated output's interior and the port's
    plain stencil version on the same inputs."""
    interior = tuple(slice(h, out.shape[ax] - h)
                     for ax, h in enumerate(reversed(prog.halo[:prog.ndim])))
    want = reference(prog, {a: torch.from_numpy(v) for a, v in inputs.items()},
                     {s: 0.3 for s in prog.scalars})
    return float((torch.from_numpy(out[interior]) - want).abs().max())


def bits(a):
    return a.view(np.uint32)


@pytest.mark.parametrize("name", CONCRETE)
def test_run_concrete_matches_reference(name):
    b, rb = kernelgen.get_bench(name), ref_kernelgen.get_bench(name)
    outs, inputs, stats = run_versions(concrete, lower_to_ptx, Compiler(), b.program,
                                       b.max_delta)
    ref_outs, _, ref_stats = run_versions(ref_concrete, ref_lower, RefCompiler(),
                                          rb.program, rb.max_delta)
    assert np.array_equal(bits(outs[0]), bits(outs[1])), "synthesis changed the output"
    for got, want in zip(outs, ref_outs):
        assert np.array_equal(bits(got), bits(want))
    for got, want in zip(stats, ref_stats):
        assert got.counts == want.counts
        assert extract_features(got) == ref_extract_features(want)
    shuffled = stats[1].get("shfl")
    assert (shuffled > 0) == (b.expect_shuffles > 0)
    assert plain_gap(b.program, outs[0], inputs) <= TOL


@settings(max_examples=12, deadline=None, database=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(-3, 3), st.integers(-2, 2)),
                min_size=2, max_size=8, unique=True),
       st.integers(0, 2**31 - 1))
def test_random_stencil_bit_exact(taps, seed):
    """Property: for any 2-D stencil program the port's synthesized PTX
    computes what the original does, bit for bit, and both are the plain
    version's within the stencil tolerance."""
    w = Array("w0")
    expr = None
    rng = np.random.default_rng(seed)
    for (di, dj) in taps:
        term = float(rng.uniform(0.1, 1.0)) * w[I(di), J(dj)]
        expr = term if expr is None else expr + term
    prog = Program(name="rand", ndim=2, out=Array("w1")[I(), J()], expr=expr)
    outs, inputs, _ = run_versions(concrete, lower_to_ptx, Compiler(), prog,
                                   nx=68 + 2 * prog.halo[0], ny=4 + 2 * prog.halo[1])
    assert np.array_equal(bits(outs[0]), bits(outs[1]))
    assert plain_gap(prog, outs[0], inputs) <= TOL


def _norm(obj):
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            _norm(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(_norm(x) for x in obj)
    return obj


@pytest.mark.parametrize("name", SOURCES)
def test_parse_print_round_trip_matches_reference(name):
    """The lowered and the synthesized kernel print as the reference's,
    parse back to the same statements and print again byte for byte."""
    for text in (print_kernel(lower_to_ptx(kernelgen.get_bench(name).program)),
                 Compiler().compile(kernelgen.get_bench(name), target="hopper").ptx):
        module, ref_module = parse(text), ref_parse(text)
        assert _norm(module) == _norm(ref_module)
        again = print_module(module)
        if text.startswith("//"):
            assert again == text
        else:
            assert print_kernel(module.kernels[0]) == text == \
                ref_print_kernel(ref_module.kernels[0])
    assert print_kernel(lower_to_ptx(kernelgen.get_bench(name).program)) == \
        ref_print_kernel(ref_lower(ref_kernelgen.get_bench(name).program))


INSTRS = ["ld.global.nc.f32 %f1, [%rd4+-4]", "ld.global.f32 %f1, [%rd4-8]",
          "@%p1 bra $EXIT", "@!%p2 bra $L3",
          "shfl.sync.down.b32 %r1, %r2, 1, 31, 0xffffffff",
          "shfl.up.b32 %r1|%p1, %r2, 3, 0", "mad.lo.s32 %r3, %r1, %r2, 7",
          "mov.f32 %f2, 0f3E99999A", "setp.ge.s32 %p1, %r4, %r5",
          "st.global.f32 [%rd2], %f9", "cvta.to.global.u64 %rd2, %rd1", "ret"]


@pytest.mark.parametrize("line", INSTRS)
def test_parse_instr_matches_reference(line):
    assert _norm(parse_instr(line)) == _norm(ref_parse_instr(line))


def test_f32_bits_matches_reference():
    for v in (0.0, -0.0, 0.3, 1.0, -2.5, 1e-45, 3.4e38, float("inf"), float("nan")):
        assert concrete.f32_bits(v) == ref_concrete.f32_bits(v)
