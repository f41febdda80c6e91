"""The port's stencil kernel module against the JAX package's: fetch
plans, the plain PyTorch version, the warp's shuffle schedule, the CUDA
source it generates, and the slice end to end on quickstart's Jacobi."""

import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core.frontend import kernelgen as ref_kernelgen
from repro.core.frontend import stencil as ref_dsl
from repro.core.frontend.pallas_lower import synthesize_tpu
from repro.kernels import stencil as ref_stencil
from repro_torch.core.frontend import kernelgen
from repro_torch.core.frontend.cuda_lower import synthesize_cuda
from repro_torch.interop import arrays_from_numpy, program_from_reference
from repro_torch.kernels.stencil import (
    CTA_BLOCKS,
    MODES,
    cuda_source,
    hbm_bytes_per_block,
    make_plan,
    stencil_apply,
    traffic_report,
)
from repro_torch.kernels.stencil.ops import _spec
from repro_torch.kernels.stencil.ref import interior_shape

# the reference's kernel benches and shapes (tests/test_kernels.py)
STENCIL_BENCHES = ["jacobi", "gaussblur", "laplacian", "wave13pt",
                   "whispering", "gradient", "divergence", "gameoflife",
                   "lapgsrb", "uxx1", "tricubic", "sincos", "vecadd"]
SHAPES = {1: (300,), 2: (20, 140), 3: (6, 20, 140)}
TOL = dict(rtol=2e-4, atol=2e-4)     # the reference's own tolerance


def _inputs(prog, shape, seed):
    """Inputs and scalars from one numpy generator, fed to both packages."""
    rng = np.random.default_rng(seed)
    arrays = {a: rng.standard_normal(shape[-d:]).astype(np.float32)
              for a, d in sorted(prog.arrays.items()) if a != prog.out.array}
    scalars = {s: float(rng.uniform(0.1, 1.0)) for s in prog.scalars}
    return arrays, scalars


def _quickstart_jacobi():
    """examples/quickstart.py's Jacobi, written with the reference DSL."""
    I, J = ref_dsl.I, ref_dsl.J
    w0 = ref_dsl.Array("w0")
    c0, c1, c2 = (ref_dsl.Scalar(c) for c in ("c0", "c1", "c2"))
    expr = (c0 * w0[I(), J()]
            + c1 * (w0[I(-1), J()] + w0[I(), J(-1)]
                    + w0[I(1), J()] + w0[I(), J(1)])
            + c2 * (w0[I(-1), J(-1)] + w0[I(-1), J(1)]
                    + w0[I(1), J(-1)] + w0[I(1), J(1)]))
    return ref_dsl.Program(name="jacobi", ndim=2, out=ref_dsl.Array("w1")[I(), J()],
                           expr=expr, scalars=["c0", "c1", "c2"], lang="F")


# ---------------------------------------------------------------------------
# fetch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STENCIL_BENCHES)
@pytest.mark.parametrize("mode", MODES)
def test_plans_match_reference(name, mode):
    ref_prog = ref_kernelgen.get_bench(name).program
    prog = kernelgen.get_bench(name).program
    ref_plan = ref_stencil.make_plan(ref_prog, mode)
    plan = make_plan(prog, mode)
    assert plan.mode == ref_plan.mode
    assert [(f.array, f.lo, f.hi, f.taps) for f in plan.fetches] == \
        [(f.array, f.lo, f.hi, f.taps) for f in ref_plan.fetches]
    for block in (ref_stencil.DEFAULT_BLOCKS[prog.ndim], CTA_BLOCKS[prog.ndim]):
        assert hbm_bytes_per_block(prog, mode, block) == \
            ref_stencil.hbm_bytes_per_block(ref_prog, mode, block)


@pytest.mark.parametrize("name", ["jacobi", "gaussblur", "tricubic", "lapgsrb",
                                  "wave13pt"])
def test_traffic_report_matches_reference(name):
    ref_prog = ref_kernelgen.get_bench(name).program
    prog = kernelgen.get_bench(name).program
    shape = {2: (32768, 32768), 3: (512, 1024, 1024)}[prog.ndim]
    block = ref_stencil.DEFAULT_BLOCKS[prog.ndim]
    ref_t = ref_stencil.traffic_report(ref_prog, shape)
    t = traffic_report(prog, shape, block)
    for key in ref_t:
        assert t[key] == ref_t[key], key
    n_in = len([a for a in prog.arrays if a != prog.out.array])
    interior = interior_shape(shape, prog.halo)
    assert t["compulsory"] == 4 * (n_in * np.prod(shape) + np.prod(interior))
    assert t["tile"] <= t["paper"] <= t["naive"]


# ---------------------------------------------------------------------------
# the plain version on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STENCIL_BENCHES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax_reference(name, mode):
    ref_prog = ref_kernelgen.get_bench(name).program
    prog = kernelgen.get_bench(name).program
    shape = SHAPES[prog.ndim]
    arrays, scalars = _inputs(prog, shape, seed=STENCIL_BENCHES.index(name))
    want = ref_stencil.reference(
        ref_prog, {a: jnp.asarray(x) for a, x in arrays.items()}, scalars)
    got = stencil_apply(prog, arrays, scalars, mode=mode, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == interior_shape(shape, prog.halo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["vecadd", "jacobi", "laplacian"])
def test_plain_matches_pallas_interpret(name):
    """Against the Pallas kernel itself (interpret mode), one bench per
    rank; the reference's ragged-shape padding included."""
    ref_prog = ref_kernelgen.get_bench(name).program
    prog = kernelgen.get_bench(name).program
    shape = SHAPES[prog.ndim]
    arrays, scalars = _inputs(prog, shape, seed=100)
    block = {1: (64,), 2: (8, 32), 3: (1, 8, 32)}[prog.ndim]
    want = ref_stencil.stencil_apply(
        ref_prog, {a: jnp.asarray(x) for a, x in arrays.items()}, scalars,
        mode="paper", block=block, interpret=True)
    got = stencil_apply(prog, arrays, scalars, mode="paper", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs the kernel")
    prog = kernelgen.get_bench("jacobi").program
    arrays, scalars = _inputs(prog, SHAPES[2], seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stencil_apply(prog, arrays, scalars)
    with pytest.raises(ValueError, match="unknown mode"):
        stencil_apply(prog, arrays, scalars, mode="warp", device="cpu")


# ---------------------------------------------------------------------------
# the warp's shuffle schedule and the generated source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STENCIL_BENCHES)
def test_paper_schedule_replays_taps(name):
    """Replay the paper mode lane by lane as the kernel runs it: 32-lane
    warps along i over a ragged interior, loads clamped at the array's
    end, ``__shfl_down/up_sync`` semantics, corner lanes reloading.
    Every valid lane must end up with exactly its own tap."""
    b = kernelgen.get_bench(name)
    prog = b.program
    rng = np.random.default_rng(7)
    h0 = prog.halo[0]
    n0 = 2 * h0 + 77                              # 77 interior lanes: ragged
    x = rng.standard_normal(n0).astype(np.float32)
    bx = CTA_BLOCKS[prog.ndim][-1]
    n_threads = -(-77 // bx) * bx
    i = h0 + np.arange(n_threads)                 # each thread's output i
    lane = np.arange(n_threads) % 32
    valid = i < n0 - h0

    def load(off):
        return x[np.minimum(i + off, n0 - 1)]

    for row in synthesize_cuda(prog, b.max_delta).schedule:
        held = {s: load(s) for s in row.sources}
        for dst, src, delta in row.covered:
            src_lane = lane + delta
            inside = (src_lane >= 0) & (src_lane <= 31)
            from_lane = np.arange(n_threads) + np.where(inside, delta, 0)
            got = np.where(inside, held[src][from_lane], load(dst))
            np.testing.assert_array_equal(got[valid], x[i[valid] + dst])


@pytest.mark.parametrize("name", STENCIL_BENCHES)
def test_generated_source(name):
    b = kernelgen.get_bench(name)
    prog = b.program
    plan = synthesize_cuda(prog, b.max_delta)
    specs = [_spec(prog, m, b.max_delta) for m in MODES]
    src = cuda_source(specs)
    assert src.count('#include "stencil_common.cuh"') == 1
    bodies = {s.mode: src.split(s.symbol + "(", 1)[1].split("extern", 1)[0]
              for s in specs}
    assert bodies["naive"].count("rs::load(") == plan.n_taps
    assert "shfl" not in bodies["naive"] and "tile" not in bodies["naive"]
    assert bodies["paper"].count("rs::shuffled(") == plan.n_row_covered
    assert bodies["paper"].count("rs::load(") == plan.n_taps - plan.n_row_covered
    assert bodies["tile"].count("rs::stage<") == len(make_plan(prog, "tile").fetches)
    words = int(re.search(r"__shared__ float tile\[(\d+)\]", bodies["tile"]).group(1))
    assert 4 * words <= 48 * 1024
    # the expression code is the same text in every mode
    exprs = {m: [ln for ln in body.splitlines() if re.match(r"\s+const float (e\d+|r) =", ln)]
             for m, body in bodies.items()}
    assert exprs["naive"] == exprs["paper"] == exprs["tile"]
    assert "__fmul_rn" in src or "__fadd_rn" in src


def test_reduce_program_has_no_kernel():
    prog = kernelgen.get_bench("matmul").program
    plan = synthesize_cuda(prog)
    assert plan.consistent and plan.n_taps == 0 and plan.schedule == []
    with pytest.raises(ValueError, match="non-parallel index"):
        cuda_source([_spec(prog, "naive", 31)])
    arrays = {"a": np.ones((4, 4), np.float32), "b": np.ones((4, 4), np.float32)}
    with pytest.raises(NotImplementedError):
        stencil_apply(prog, arrays, device="cpu")


# ---------------------------------------------------------------------------
# carrying state across, and the slice end to end
# ---------------------------------------------------------------------------

def test_program_from_reference_round_trips_quickstart_jacobi():
    ref_prog = _quickstart_jacobi()
    prog = program_from_reference(ref_prog)
    assert repr(prog) == repr(ref_prog)
    assert repr(prog) == repr(kernelgen.get_bench("jacobi").program)
    with pytest.raises(TypeError):
        program_from_reference(ref_prog.expr)
    arrays = arrays_from_numpy({"w0": np.arange(12.0).reshape(3, 4)}, "cpu")
    assert arrays["w0"].dtype == torch.float32
    assert arrays["w0"].shape == (3, 4) and arrays["w0"][1, 2] == 6.0


def test_slice_end_to_end_quickstart_jacobi():
    """DSL program (reference) -> port program -> PTX -> emulation ->
    detection -> shuffle schedule -> stencil, against the reference's
    synthesize_tpu + Pallas stencil."""
    ref_prog = _quickstart_jacobi()
    prog = program_from_reference(ref_prog)
    plan = synthesize_cuda(prog)
    ref_plan = synthesize_tpu(ref_prog)
    assert plan.consistent and ref_plan.consistent
    assert (plan.n_shuffles, plan.n_taps, plan.n_row_covered) == \
        (ref_plan.n_shuffles, ref_plan.n_taps, ref_plan.n_row_covered) == (6, 9, 6)
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((20, 140)).astype(np.float32)
    scal = {"c0": .5, "c1": .25, "c2": .125}
    for mode in MODES:
        want = ref_stencil.stencil_apply(ref_prog, {"w0": jnp.asarray(w0)}, scal,
                                         mode=mode, block=(8, 32))
        got = stencil_apply(prog, arrays_from_numpy({"w0": w0}, "cpu"), scal,
                            mode=mode, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
