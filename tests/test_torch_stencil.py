"""The port's stencil kernel module against the JAX package's: fetch
plans, the plain PyTorch version, the warp's shuffle schedule, the CUDA
source it generates, and the slice end to end on quickstart's Jacobi."""

import re
from dataclasses import replace

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
from repro_torch.build import SASS_CLASSES, parse_res_usage, parse_sass
from repro_torch.kernels.stencil import (
    CTA_BLOCKS,
    MARCH,
    MODES,
    cuda_source,
    hbm_bytes_per_block,
    make_plan,
    march,
    stencil_apply,
    traffic_report,
)
from repro_torch.kernels.stencil.ops import _spec
from repro_torch.kernels.stencil.ref import interior_shape
from repro_torch.kernels.stencil.stencil import (
    RowShuffles,
    _unique_taps,
    input_arrays,
    kernel_source,
    tap_at,
    tile_stages,
    tiles,
)

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

def _replay(spec, interior):
    """Run the kernel's march thread by thread as the generated CUDA does
    (``csrc/stencil_common.cuh``): the grid of CTAs, 32-lane warps along
    i, ``steps`` outputs per thread along the march, planes and (3-D) j
    clamped to the array, i clamped per tap only in edge warps,
    ``__shfl_down/up_sync`` semantics with corner lanes reloading, and in
    ``tile`` mode the staged boxes and the 3-D plane ring.  Checks that no
    load leaves the arrays, that every valid output receives exactly its
    own taps at every step, and that the outputs cover the interior once."""
    prog = spec.prog
    nd, R = prog.ndim, spec.steps
    h0, h1, h2 = tuple(prog.halo) + (0,) * (3 - nd)
    m0, m1, m2 = tuple(reversed(interior)) + (1,) * (3 - nd)
    n0, n1, n2 = m0 + 2 * h0, m1 + 2 * h1, m2 + 2 * h2
    rng = np.random.default_rng(7)
    full = tuple(reversed((n0, n1, n2)[:nd]))
    x = {a: rng.standard_normal(full).astype(np.float32) for a in input_arrays(prog)}
    bx = CTA_BLOCKS[nd][-1]
    by = CTA_BLOCKS[nd][-2] if nd > 1 else 1
    gx = -(-m0 // bx)
    gy = {1: 1, 2: -(-m1 // (by * R)), 3: -(-m1 // by)}[nd]
    gz = -(-m2 // R) if nd == 3 else 1
    bz_, by_, bx_, ty, tx = (g.ravel() for g in np.meshgrid(
        np.arange(gz), np.arange(gy), np.arange(gx), np.arange(by), np.arange(bx),
        indexing="ij"))
    t = np.arange(tx.size)
    i = bx_ * bx + tx + h0
    lane = tx % 32
    j = by_ * by + ty + h1 if nd == 3 else np.zeros_like(i)
    first = {1: np.zeros_like(i), 2: (by_ * by + ty) * R + h1, 3: bz_ * R + h2}[nd]
    n_out, h_out = {1: (1, 0), 2: (n1, h1), 3: (n2, h2)}[nd]
    valid = (i < n0 - h0) & (j < n1 - h1 if nd == 3 else True)
    steps = np.where(valid, np.clip(n_out - h_out - first, 0, R), 0)
    pmax = n_out - 1 - first
    lim = n0 - 1 - i
    edge = (i - lane) + 31 + h0 > n0 - 1
    jc = np.minimum(j, n1 - h1 - 1)

    def at(array, plane, row, col):
        for v, n in ((plane, n_out), (row, n1 if nd == 3 else 1), (col, n0)):
            assert np.all((v >= 0) & (v < n)), "a load leaves the array"
        a = x[array]
        return a[col] if nd == 1 else a[plane, col] if nd == 2 else a[plane, row, col]

    def load(f):
        col = i + np.where(edge, np.minimum(f.oi, lim), f.oi)
        return at(f.array, first + np.minimum(f.plane, pmax), jc + f.oj, col)

    bufs = {b.array: b for b in tiles(prog)}
    stages = tile_stages(spec) if spec.mode == "tile" else [[]] * R
    ring, last_read = {}, {}
    held = {}
    stored = np.zeros((n2, n1, n0), np.int64)
    for step, fetches in enumerate(march(spec)):
        for b, plane in stages[step]:
            slot = (b.array, b.slot(plane))
            assert last_read.get(slot, -2) < step - 1, "a plane overwritten while read"
            ring[slot] = plane
        for f in fetches:
            if f.how == "load":
                v = load(f)
            elif f.how == "shfl":
                src = held[(f.array, f.src, f.oj, f.plane)]
                inside = (lane + f.delta >= 0) & (lane + f.delta <= 31)
                v = np.where(inside, src[np.where(inside, t + f.delta, t)], load(f))
            else:
                b = bufs[f.array]
                y = {1: 0, 2: ty * R + f.plane - b.lj, 3: ty + f.oj - b.lj}[nd]
                assert np.all((y >= 0) & (y < b.tj))
                assert ((tx + f.oi - b.li >= 0) & (tx + f.oi - b.li < b.ti)).all()
                if nd == 3:
                    slot = (f.array, b.slot(f.plane))
                    assert ring[slot] == f.plane, "read a plane the ring no longer holds"
                    last_read[slot] = step
                row = np.minimum(j + f.oj, n1 - 1) if nd == 3 else 0
                plane = first + np.minimum(f.plane, pmax) if nd == 3 else \
                    np.minimum(first + f.plane, n_out - 1)
                v = at(f.array, plane, row, np.minimum(i + f.oi, n0 - 1))
            held[(f.array, f.oi, f.oj, f.plane)] = v
        live = step < steps
        for array, off in _unique_taps(prog):
            oi, oj, ok = tuple(off) + (0,) * (3 - nd)
            got = held[tap_at(array, off, step)]
            plane = first + step + (oj if nd == 2 else ok)
            row = j + oj if nd == 3 else 0
            want = at(array, np.where(live, plane, 0), np.where(live, row, 0),
                      np.where(live, i + oi, 0))
            np.testing.assert_array_equal(got[live], want[live])
        k = first + step if nd == 3 else 0
        jj = first + step if nd == 2 else j
        np.add.at(stored, (np.where(live, k, 0), np.where(live, jj, 0), i * live), live)
    inner = (slice(h2, n2 - h2), slice(h1, n1 - h1), slice(h0, n0 - h0))
    assert (stored[inner] == 1).all() and stored.sum() == m0 * m1 * m2


def _ragged(name):
    """Interiors ragged along i (31, 33 and 77 lanes) and along the march
    (1, R - 1 and R + 1 outputs; j interior 11 in 3-D)."""
    nd = kernelgen.get_bench(name).program.ndim
    R = MARCH[nd]
    return [{1: (wi,), 2: (outer, wi), 3: (outer, 11, wi)}[nd]
            for wi, outer in ((31, 1), (33, R - 1), (77, R + 1))]


@pytest.mark.parametrize("name", STENCIL_BENCHES)
def test_paper_schedule_replays_taps(name):
    """The paper mode lane by lane, at interiors ragged along i and along
    the march: every valid output receives exactly its own taps."""
    b = kernelgen.get_bench(name)
    for interior in _ragged(name):
        _replay(_spec(b.program, "paper", b.max_delta), interior)


@pytest.mark.parametrize("name,mode,interior",
                         [(n, m, i) for n in STENCIL_BENCHES for m in ("naive", "tile")
                          for i in _ragged(n)])
def test_march_replays_taps(name, mode, interior):
    b = kernelgen.get_bench(name)
    _replay(_spec(b.program, mode, b.max_delta), interior)


def test_replay_sees_a_shuffle_by_a_wrong_delta():
    """The replay is not blind: a schedule whose deltas are one lane off
    hands valid lanes their neighbour's column."""
    b = kernelgen.get_bench("jacobi")
    spec = _spec(b.program, "paper", b.max_delta)
    sched = [RowShuffles(r.array, r.rest, r.sources,
                         tuple((d, s, dl + 1) for d, s, dl in r.covered))
             for r in spec.rows]
    with pytest.raises(AssertionError):
        _replay(replace(spec, rows=tuple(sched)), (9, 33))


def _new_taps(prog, steps):
    """Per step, the taps (array, oi, oj, plane) its output needs that no
    earlier step needed: the entering plane's."""
    seen, out = set(), []
    for step in range(steps):
        need = {tap_at(a, off, step) for a, off in _unique_taps(prog)}
        out.append(need - seen)
        seen |= need
    return out


def _roles(spec, step):
    """(array, oi, oj, plane) -> "load"/"shfl", its role in the paper
    schedule's row at this step."""
    roles = {}
    for row in spec.rows:
        for li in row.sources:
            roles[tap_at(row.array, (li,) + row.rest, step)] = "load"
        for dst, _, _ in row.covered:
            roles[tap_at(row.array, (dst,) + row.rest, step)] = "shfl"
    return roles


# fetches per output once the window is full (naive; paper loads +
# shuffles): Jacobi 3 / 1 + 2; tricubic 16 + 3 / (4 + 3) + 12
STEADY = {"jacobi": (3, 1, 2), "tricubic": (19, 7, 12)}


@pytest.mark.parametrize("name", STENCIL_BENCHES)
def test_generated_source(name):
    b = kernelgen.get_bench(name)
    prog = b.program
    plan = synthesize_cuda(prog, b.max_delta)
    specs = {m: _spec(prog, m, b.max_delta) for m in MODES}
    src = cuda_source(list(specs.values()))
    assert src.count('#include "stencil_common.cuh"') == 1
    R = MARCH[prog.ndim]
    entering = _new_taps(prog, R)
    texts = {m: kernel_source(s) for m, s in specs.items()}
    for m, text in texts.items():
        assert specs[m].steps == R and text.count("rs::point<") == 1
        body = text.split("// step 0", 1)[1]
        per_step = body.split("// step ")
        assert len(per_step) == R
        for step, part in enumerate(per_step):
            roles = _roles(specs["paper"], step)
            loads = len(re.findall(r"rs::load<kEdge>\(r\d+, p, -?\d+\)", part))
            shuffles = len(re.findall(r"rs::shuffled<kEdge>\(v\d+, r\d+, p, -?\d+, -?\d+\)",
                                      part))
            reads = len(re.findall(r"= r\d+\[-?\d+\];", part))
            assert part.count("rs::load<") == loads and part.count("rs::shuffled<") == shuffles
            if m == "naive":
                assert (loads, shuffles, reads) == (len(entering[step]), 0, 0)
            elif m == "paper":
                assert loads == sum(roles[k] == "load" for k in entering[step])
                assert shuffles == sum(roles[k] == "shfl" for k in entering[step])
                assert reads == 0
            else:
                assert (loads, shuffles, reads) == (0, 0, len(entering[step]))
                stages = part.count(".store(sm_")
                assert stages == len(tile_stages(specs[m])[step])
                assert part.count("__syncthreads();") == (1 if stages else 0)
            assert part.count("rs::store(") == 1
        if m != "tile":
            assert "__shared__" not in text and "__syncthreads" not in text
    # all taps once at step 0; the shuffles of step 0 are the schedule's
    assert len(entering[0]) == plan.n_taps
    assert texts["paper"].split("// step 1")[0].count("rs::shuffled<") == plan.n_row_covered
    assert "shfl" not in texts["naive"] and "Stager" not in texts["naive"]
    if name in STEADY:
        last = [len(entering[-1]),
                sum(_roles(specs["paper"], R - 1)[k] == "load" for k in entering[-1]),
                sum(_roles(specs["paper"], R - 1)[k] == "shfl" for k in entering[-1])]
        assert tuple(last) == STEADY[name]
    words = [int(w) for w in re.findall(r"__shared__ float sm_a\d+\[(\d+)\]", texts["tile"])]
    assert len(words) == len(make_plan(prog, "tile").fetches)
    assert 0 < 4 * sum(words) <= 48 * 1024
    # the expression code is the same text in every mode
    exprs = {m: [ln for ln in text.split(") {", 1)[1].split("}", 1)[0].splitlines()
                 if re.match(r"\s+const float (e\d+|r) =", ln)]
             for m, text in texts.items()}
    assert exprs["naive"] == exprs["paper"] == exprs["tile"]
    assert "__fmul_rn" in src or "__fadd_rn" in src


def test_parse_sass_counts_classes():
    sass = """
\tcode for sm_90a
\t\tFunction : stencil_k
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                          /* 0x0000000000007919 */
        /*0020*/                   IMAD.WIDE R2, R0, 0x4, R2 ;                 /* 0x0000000400027825 */
        /*0030*/              @!P0 IADD3 R4, P1, R2, 0x80, RZ ;                /* 0x0000008002048810 */
        /*0040*/                   LDG.E.CONSTANT R5, desc[UR4][R2.64+-0x4] ;  /* 0x000ffc0402057981 */
        /*0050*/                   SHFL.DOWN PT, R6, R5, 0x1, 0x1f ;           /* 0x08201f0005067f89 */
        /*0060*/                   FFMA R7, R5, R6, RZ ;                       /* 0x0000000605077223 */
        /*0070*/                   FADD R7, R7, R7 ;                           /* 0x0000000707077221 */
        /*0080*/                   STS [R0], R7 ;                              /* 0x0000000700007388 */
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;               /* 0x0000000000007b1d */
        /*00a0*/                   LDS R8, [R0+0x4] ;                          /* 0x0000040000087984 */
        /*00b0*/                   VIMNMX R9, R0, 0x7, PT ;                    /* 0x0000000700097848 */
        /*00c0*/                   EXIT ;                                      /* 0x000000000000794d */
        /*00d0*/                   BRA 0xd0;                                   /* 0xfffffffc00fc7947 */
        /*00e0*/                   NOP;                                        /* 0x0000000000007918 */
\t\tFunction : other
        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;  /* 0x00000000041879f0 */
"""
    counts = parse_sass(sass)
    assert counts["stencil_k"] == {"shfl": 1, "ldg": 1, "hgmma": 0, "hmma": 0,
                                   "int": 3, "float": 2, "lds_sts": 2, "bar": 1,
                                   "total": 14}
    assert counts["other"]["hgmma"] == 1 and counts["other"]["total"] == 1
    assert set(SASS_CLASSES) == {"int", "float", "lds_sts", "bar"}
    usage = """Resource usage:
 Common:
  GLOBAL:0
 Function stencil_k:
  REG:60 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:648 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function other:
  REG:255 STACK:24 SHARED:13844 LOCAL:24 CONSTANT[0]:580 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    assert parse_res_usage(usage) == {"stencil_k": {"regs": 60, "local": 0},
                                      "other": {"regs": 255, "local": 24}}


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
