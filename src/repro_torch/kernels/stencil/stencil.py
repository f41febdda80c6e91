"""The stencil kernel for Hopper: fetch plans, the shuffle schedule and
the CUDA code generator.

Mirrors ``src/repro/kernels/stencil/stencil.py``: ``MODES``, ``Fetch``,
``FetchPlan``, ``make_plan`` and ``hbm_bytes_per_block`` are the
reference's, field for field.  Where the TPU kernel imitated
``shfl.sync`` with a shifted slice of a VMEM tile, the CUDA kernel
issues the instruction itself: a warp's lanes run along ``i`` (as
``lower_to_ptx`` puts ``tid.x`` on ``i``), and each thread marches
``MARCH[ndim]`` outputs along the outer axis (k in 3-D, j in 2-D),
keeping in registers the taps it already holds, so that each step
fetches only the taps of the entering plane (:func:`march`).  The three
modes differ only in how such a tap reaches the thread:

``naive``   one ``__ldg`` (the paper's *Original*);
``paper``   per row of the ``paper`` plan, only the row's source taps
            are loaded; every covered tap arrives through
            ``__shfl_down_sync``/``__shfl_up_sync`` by the schedule's
            delta, which ``synthesize_cuda`` requires to equal the
            emulator's detection tap by tap; corner lanes reload from
            global memory;
``tile``    from one shared-memory buffer per array (:func:`tiles`): a
            ring of planes in 3-D, one box in 1-D and 2-D.

The device code shared by all kernels is ``csrc/stencil_common.cuh``;
this module emits, per (program, mode), the program's expression as a
function of its taps and the march that calls it, then
:mod:`repro_torch.build` compiles them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.build import Library
from repro_torch.core.frontend.stencil import (
    Bin,
    Call,
    Const,
    Expr,
    Load,
    Program,
    Scalar,
    collect_loads,
    f32_bits,
)
from .ref import interior_shape, tap_offsets

MODES = ("naive", "paper", "tile")

#: CTA shape per ndim, in array-axis order (…, j, i): a warp spans 32
#: consecutive i; 2-D and 3-D CTAs stack 8 warps along j.
CTA_BLOCKS = {1: (256,), 2: (8, 32), 3: (1, 8, 32)}

#: outputs per thread along the march axis (j in 2-D, k in 3-D), by ndim
MARCH = {1: 1, 2: 8, 3: 16}

#: CTAs each SM must fit (``__launch_bounds__``): at most 128 registers a
#: thread.  Left alone, ptxas gives 3-D paper and tile kernels 136 and more,
#: one CTA per SM, and starves 2-D paper of registers (34)
MIN_CTAS_PER_SM = 2

#: static shared memory a CTA may declare without opting in
_SMEM_LIMIT = 48 * 1024


# ---------------------------------------------------------------------------
# fetch planning (the reference's, unchanged)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Fetch:
    """One HBM->VMEM transfer: per-dim (lo, hi) tap extents around the
    output block, ordered (i, j, k).  Serves ``taps`` (offset tuples)."""

    array: str
    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    taps: Tuple[Tuple[int, ...], ...]

    def shape(self, block: Sequence[int]) -> Tuple[int, ...]:
        """VMEM buffer shape, axis order = array order (k, j, i); ``block``
        is given in the same array-axis order, lo/hi in dim order (i,j,k)."""
        nd = len(self.lo)
        return tuple(block[a] + self.hi[nd - 1 - a] - self.lo[nd - 1 - a]
                     for a in range(nd))


@dataclass
class FetchPlan:
    mode: str
    fetches: List[Fetch]

    def bytes_per_block(self, block: Sequence[int], itemsize: int = 4) -> int:
        total = 0
        for f in self.fetches:
            n = 1
            for s in f.shape(block):
                n *= s
            total += n * itemsize
        return total


def _unique_taps(prog: Program) -> List[Tuple[str, Tuple[int, ...]]]:
    seen = []
    for ld in collect_loads(prog.expr):
        key = (ld.array, tap_offsets(ld, prog.ndim))
        if key not in seen:
            seen.append(key)
    return seen


def make_plan(prog: Program, mode: str) -> FetchPlan:
    assert mode in MODES
    taps = _unique_taps(prog)
    nd = prog.ndim
    fetches: List[Fetch] = []
    if mode == "naive":
        for arr, off in taps:
            fetches.append(Fetch(arr, off, off, (off,)))
    elif mode == "paper":
        # group by (array, non-leading offsets): the emulator's shuffle rows
        rows: Dict[Tuple, List[Tuple[int, ...]]] = {}
        for arr, off in taps:
            rows.setdefault((arr, off[1:]), []).append(off)
        for (arr, _rest), offs in rows.items():
            lo = (min(o[0] for o in offs),) + offs[0][1:]
            hi = (max(o[0] for o in offs),) + offs[0][1:]
            fetches.append(Fetch(arr, lo, hi, tuple(offs)))
    else:  # tile
        per_array: Dict[str, List[Tuple[int, ...]]] = {}
        for arr, off in taps:
            per_array.setdefault(arr, []).append(off)
        for arr, offs in per_array.items():
            lo = tuple(min(o[d] for o in offs) for d in range(nd))
            hi = tuple(max(o[d] for o in offs) for d in range(nd))
            fetches.append(Fetch(arr, lo, hi, tuple(offs)))
    return FetchPlan(mode, fetches)


def hbm_bytes_per_block(prog: Program, mode: str,
                        block: Sequence[int], itemsize: int = 4) -> int:
    return make_plan(prog, mode).bytes_per_block(block, itemsize)


# ---------------------------------------------------------------------------
# the per-row shuffle schedule
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RowShuffles:
    """One row of the ``paper`` plan as the warp executes it.

    ``sources`` are the lane offsets each lane loads itself; each
    ``(dst, src, delta)`` in ``covered`` is the tap at lane offset
    ``dst``, taken from the lane ``delta = dst - src`` away, which holds
    the source tap ``src``.
    """

    array: str
    rest: Tuple[int, ...]                  # the row's j/k offsets
    sources: Tuple[int, ...]
    covered: Tuple[Tuple[int, int, int], ...]


def shuffle_schedule(plan: FetchPlan, max_delta: int = 31) -> List[RowShuffles]:
    """The greedy rule the reference uses to count row-covered taps
    (``pallas_lower.synthesize_tpu``): taps are visited in ascending lane
    order and a tap is covered iff an *uncovered* earlier tap of its row
    lies within ``max_delta`` (and within a warp); covered taps never
    source another.  Of the eligible sources the nearest is taken, as
    the detector prefers the smallest ``|N|``."""
    bound = min(max_delta, 31)
    rows = []
    for f in plan.fetches:
        sources: List[int] = []
        covered: List[Tuple[int, int, int]] = []
        for li in sorted(o[0] for o in f.taps):
            near = [s for s in sources if abs(li - s) <= bound]
            if near:
                src = min(near, key=lambda s: (abs(li - s), s))
                covered.append((li, src, li - src))
            else:
                sources.append(li)
        rows.append(RowShuffles(f.array, f.lo[1:], tuple(sources),
                                tuple(covered)))
    return rows


# ---------------------------------------------------------------------------
# CUDA code generation
# ---------------------------------------------------------------------------

_BIN_FN = {"+": "__fadd_rn", "-": "__fsub_rn", "*": "__fmul_rn",
           "/": "__fdiv_rn"}
_CALL_FN = {"sin": "sinf", "cos": "cosf", "sqrt": "__fsqrt_rn",
            "ex2": "exp2f", "lg2": "log2f"}


@dataclass(frozen=True)
class KernelSpec:
    """What the generator needs for one (program, mode) kernel.  ``rows``
    is the shuffle schedule, required in ``paper`` mode only."""

    symbol: str
    prog: Program
    mode: str
    rows: Tuple[RowShuffles, ...] = ()

    @property
    def steps(self) -> int:
        """Outputs per thread along the march."""
        return MARCH[self.prog.ndim]


def input_arrays(prog: Program) -> List[str]:
    """Kernel input order: ``sorted`` names, the output excluded."""
    return sorted(a for a in prog.arrays if a != prog.out.array)


def _pad3(off: Tuple[int, ...]) -> Tuple[int, int, int]:
    return tuple(off) + (0,) * (3 - len(off))


def cta_outputs(ndim: int) -> Tuple[int, ...]:
    """The output box of one CTA, in array-axis order (…, j, i)."""
    block = CTA_BLOCKS[ndim]
    if ndim == 1:
        return block
    if ndim == 2:
        return (block[0] * MARCH[2], block[1])
    return (MARCH[3],) + block[1:]


def _expression(prog: Program, tap_var: Dict[Tuple, str]) -> List[str]:
    """SSA statements for ``prog.expr``; the last defines ``r``.  The
    text is identical in every mode and every operation is a rounded
    intrinsic, so no mode can contract differently: the three modes'
    outputs are bitwise equal."""
    lines: List[str] = []
    scalar_idx = {s: n for n, s in enumerate(prog.scalars)}

    def ev(e: Expr) -> str:
        if isinstance(e, Load):
            return tap_var[(e.array, tap_offsets(e, prog.ndim))]
        if isinstance(e, Const):
            return f"__int_as_float(0x{f32_bits(e.value):08x})"
        if isinstance(e, Scalar):
            return f"s{scalar_idx[e.name]}"
        if isinstance(e, Bin):
            a, b = ev(e.a), ev(e.b)
            v = f"e{len(lines)}"
            lines.append(f"const float {v} = {_BIN_FN[e.op]}({a}, {b});")
            return v
        if isinstance(e, Call):
            a = ev(e.arg)
            v = f"e{len(lines)}"
            lines.append(f"const float {v} = {_CALL_FN[e.fn]}({a});")
            return v
        raise NotImplementedError(
            f"{type(e).__name__} has no stencil kernel (the paper's "
            "negative cases)")

    lines.append(f"const float r = {ev(prog.expr)};")
    return lines


# ---------------------------------------------------------------------------
# the march: which taps each step fetches, and how
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TapFetch:
    """One tap a step of the march fetches.  A tap is named by its array,
    its i and (3-D) j offsets from the thread's point, and its ``plane``
    along the march, relative to the thread's first output (0 in 1-D).
    ``how`` is ``load`` (a global load), ``shfl`` (from the lane
    ``delta`` away, which holds the tap ``src`` of the same row) or
    ``smem`` (from the CTA's shared-memory tile)."""

    array: str
    oi: int
    oj: int
    plane: int
    how: str
    src: int = 0
    delta: int = 0


def tap_at(array: str, off: Tuple[int, ...], step: int) -> Tuple[str, int, int, int]:
    """(array, oi, oj, plane) of the program's tap ``off`` at a step."""
    if len(off) == 1:
        return (array, off[0], 0, 0)
    if len(off) == 2:
        return (array, off[0], 0, step + off[1])
    return (array, off[0], off[1], step + off[2])


def march(spec: KernelSpec) -> List[List[TapFetch]]:
    """Per step, the taps the thread fetches, in order: every tap of the
    step's output that it does not hold from an earlier step.  ``paper``
    visits the schedule's rows, each row's sources (loads) before its
    covered taps (shuffles by the detected delta); the others visit the
    program's taps."""
    prog = spec.prog
    held = set()
    steps = []
    for step in range(spec.steps):
        fetches = []

        def need(array, off, how, src=0, delta=0):
            key = tap_at(array, off, step)
            if key not in held:
                held.add(key)
                fetches.append(TapFetch(*key, how, src, delta))

        if spec.mode == "paper":
            for row in spec.rows:
                for li in row.sources:
                    need(row.array, (li,) + row.rest, "load")
                for dst, src, delta in row.covered:
                    need(row.array, (dst,) + row.rest, "shfl", src, delta)
        else:
            how = "load" if spec.mode == "naive" else "smem"
            for array, off in _unique_taps(prog):
                need(array, off, how)
        steps.append(fetches)
    return steps


@dataclass(frozen=True)
class Tile:
    """One array's shared-memory buffer in ``tile`` mode: a box of
    ``ti`` x ``tj`` words whose corner is (li, lj) from the CTA's first
    point; in 3-D a ring of ``slots`` such planes."""

    array: str
    li: int
    lj: int
    lk: int
    hk: int
    ti: int
    tj: int
    slots: int

    @property
    def words(self) -> int:
        return self.ti * self.tj * self.slots

    def slot(self, plane: int) -> int:
        """Offset in the buffer of the ring slot that holds ``plane``."""
        return (plane - self.lk) % self.slots * self.ti * self.tj


def tiles(prog: Program) -> List[Tile]:
    """The ``tile`` mode's buffers, one per array of the tile plan.  In
    3-D the ring holds the hk - lk + 1 planes a step reads and the plane
    read a step before, so the plane entering at a step overwrites one
    last read two steps back: one barrier per step orders the two."""
    nd = prog.ndim
    bx, by = CTA_BLOCKS[nd][-1], (CTA_BLOCKS[nd][-2] if nd > 1 else 1)
    out = []
    for f in make_plan(prog, "tile").fetches:
        li, lj, lk = _pad3(f.lo)
        hi, hj, hk = _pad3(f.hi)
        if nd == 3:
            out.append(Tile(f.array, li, lj, lk, hk, bx + hi - li, by + hj - lj,
                            hk - lk + 2))
        elif nd == 2:
            out.append(Tile(f.array, li, lj, 0, 0, bx + hi - li,
                            by * MARCH[2] + hj - lj, 1))
        else:
            out.append(Tile(f.array, li, 0, 0, 0, bx + hi - li, 1, 1))
    return out


def tile_stages(spec: KernelSpec) -> List[List[Tuple[Tile, int]]]:
    """Per step, the (buffer, plane) pairs the CTA stages before its
    barrier: every plane a tap of step 0 reads, then in 3-D the entering
    plane of each array; 1-D and 2-D stage their one box at step 0."""
    ts = tiles(spec.prog)
    if spec.prog.ndim < 3:
        return [[(t, 0) for t in ts]] + [[] for _ in range(spec.steps - 1)]
    return [[(t, p) for t in ts for p in range(t.lk, t.hk + 1)]] + \
        [[(t, step + t.hk) for t in ts] for step in range(1, spec.steps)]


# ---------------------------------------------------------------------------
# emitting the march
# ---------------------------------------------------------------------------

def _plane_offset(nd: int, steps: int, plane: int) -> str:
    return f"rs::tile_plane<{steps}>(d, p, {plane})" if nd == 3 else "0"


class _Emitter:
    """Names the march's values as the generator emits them: a plane
    offset, a row pointer and a tap value once each, at first use."""

    def __init__(self):
        self.lines: List[str] = []
        self.names: Dict[Tuple, str] = {}

    def name(self, key: Tuple, prefix: str, definition: str) -> str:
        if key not in self.names:
            self.names[key] = f"{prefix}{len(self.names)}"
            self.lines.append(definition.format(self.names[key]))
        return self.names[key]


def _march_body(spec: KernelSpec, arg_of: Dict[str, str], fn: str,
                scalars: List[str], head: Tuple[int, int, int, int]) -> List[str]:
    """The march as statements: per step, the fetches, then the store."""
    prog = spec.prog
    nd = prog.ndim
    taps = _unique_taps(prog)
    stages = tile_stages(spec) if spec.mode == "tile" else []
    buffers = {t.array: t for t in tiles(prog)}
    em = _Emitter()
    for step, fetches in enumerate(march(spec)):
        em.lines.append(f"// step {step}")
        if stages and stages[step]:
            # a plane is fetched into registers a step ahead (3-D; at step 0
            # every plane it reads) and stored before the step's barrier
            for t, plane in stages[step]:
                a = arg_of[t.array]
                if step == 0:
                    em.lines.append(f"st_{a}.fetch({a}, {_plane_offset(nd, spec.steps, plane)});")
                em.lines.append(f"st_{a}.store(sm_{a} + {t.slot(plane)});")
            em.lines.append("__syncthreads();")
            for t, plane in (stages[step + 1] if step + 1 < len(stages) else []):
                a = arg_of[t.array]
                em.lines.append(f"st_{a}.fetch({a}, {_plane_offset(nd, spec.steps, plane)});")
        for f in fetches:
            a = arg_of[f.array]
            if f.how == "smem":
                t = buffers[f.array]
                row = em.name(("row", f.array, f.oj, f.plane), "r",
                              f"const float* const {{}} = rs::tile_row<{t.ti}, "
                              f"{spec.steps}, {nd}>(sm_{a} + {t.slot(f.plane)}, "
                              f"{f.plane}, {f.oj}, {t.li}, {t.lj});")
                value = f"{row}[{f.oi}]"
            else:
                q = em.name(("plane", f.plane), "q",
                            f"const long long {{}} = rs::plane(d, p, {f.plane});")
                row = em.name(("row", f.array, f.oj, f.plane), "r",
                              f"const float* const {{}} = rs::row({a}, d, {q}, {f.oj});")
                if f.how == "load":
                    value = f"rs::load<kEdge>({row}, p, {f.oi})"
                else:
                    src = em.names[("tap", f.array, f.src, f.oj, f.plane)]
                    value = (f"rs::shuffled<kEdge>({src}, {row}, p, {f.oi}, "
                             f"{f.delta})")
            em.name(("tap", f.array, f.oi, f.oj, f.plane), "v",
                    f"const float {{}} = {value};")
        args = [em.names[("tap",) + tap_at(arr, off, step)] for arr, off in taps]
        em.lines.append(f"rs::store(out, d, p, {step}, "
                        f"{fn}({', '.join(args + scalars)}));")
    return em.lines


def kernel_source(spec: KernelSpec) -> str:
    """CUDA source of one kernel and its ``extern "C"`` launcher: the
    expression as a function of the taps, the march (in ``naive`` and
    ``paper`` twice, for full warps and for the edge warp of a row), the
    kernel and the launcher."""
    prog = spec.prog
    nd = prog.ndim
    if spec.mode not in MODES:
        raise ValueError(f"unknown mode {spec.mode!r}")
    if spec.mode == "paper" and not spec.rows:
        raise ValueError(f"{spec.symbol}: paper mode needs a shuffle schedule")
    block = CTA_BLOCKS[nd]
    bx, by = block[-1], (block[-2] if nd > 1 else 1)
    head = (bx, by, spec.steps, nd)
    names = input_arrays(prog)
    arg_of = {a: f"a{n}" for n, a in enumerate(names)}
    taps = _unique_taps(prog)
    tap_var = {key: f"t{n}" for n, key in enumerate(taps)}
    scalars = [f"s{n}" for n in range(len(prog.scalars))]
    h = _pad3(prog.halo)
    fn = f"{spec.symbol}_f"
    ind = "\n  "

    params = [f"const float* __restrict__ {arg_of[a]}" for a in names]
    params += ["float* __restrict__ out"]
    params += [f"const float {s}" for s in scalars]
    args = [arg_of[a] for a in names] + ["out"] + scalars
    body = _march_body(spec, arg_of, fn, scalars, head)

    src = (f"// {prog.name}, mode {spec.mode}, {spec.steps} outputs per thread\n"
           f"__device__ __forceinline__ float {fn}(\n    "
           + ", ".join([f"const float {v}" for v in tap_var.values()]
                       + [f"const float {s}" for s in scalars])
           + f") {{\n  {ind.join(_expression(prog, tap_var))}\n  return r;\n}}\n\n")
    if spec.mode == "tile":
        ts = tiles(prog)
        words = sum(t.words for t in ts)
        if 4 * words > _SMEM_LIMIT:
            raise ValueError(f"{spec.symbol}: {4 * words} bytes of tiles exceed "
                             f"{_SMEM_LIMIT} bytes of static shared memory")
        smem = [f"__shared__ float sm_{arg_of[t.array]}[{t.words}];" for t in ts]
        stagers = [f"rs::Stager<{', '.join(map(str, head))}, {t.ti}, {t.tj}> "
                   f"st_{arg_of[t.array]}(d, {t.li}, {t.lj});" for t in ts]
        kernel = smem + stagers + body
    else:
        src += (f"template <bool kEdge>\n__device__ __forceinline__ void "
                f"{spec.symbol}_march(\n    const rs::Dims& d, const rs::Point& p, "
                f"{', '.join(params)}) {{\n  {ind.join(body)}\n}}\n\n")
        call = f"{spec.symbol}_march<{{}}>(d, p, {', '.join(args)});"
        kernel = [f"if (p.edge) {call.format('true')}",
                  f"else {call.format('false')}"]
    launch_args = [f"(const float*)in[{n}]" for n in range(len(names))]
    launch_args += ["(float*)out"] + [f"sc[{n}]" for n in range(len(scalars))]
    return src + (
        f"extern \"C\" __global__ void __launch_bounds__({bx * by}, {MIN_CTAS_PER_SM}) "
        f"{spec.symbol}(\n    const rs::Dims d, {', '.join(params)}) {{\n"
        f"  const rs::Point p = rs::point<{', '.join(map(str, head))}>(d);\n"
        f"  {ind.join(kernel)}\n}}\n\n"
        f"extern \"C\" int launch_{spec.symbol}(const void* const* in, "
        f"void* out, const long long* shape, const float* sc, "
        f"void* stream) {{\n"
        f"  const rs::Dims d = rs::make_dims(shape, {h[0]}, {h[1]}, {h[2]}, {nd});\n"
        f"  return rs::launch<{', '.join(map(str, head))}>({spec.symbol}, d, stream, "
        f"{', '.join(launch_args)});\n}}\n")


def cuda_source(specs: Sequence[KernelSpec]) -> str:
    """One translation unit holding every requested kernel."""
    parts = ['#include "stencil_common.cuh"\n']
    parts += [kernel_source(s) for s in specs]
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# the launch wrapper
# ---------------------------------------------------------------------------

class StencilKernel:
    """A built (program, mode) kernel.  Calling it launches the kernel on
    the current stream and adds one to ``launches``; nothing else
    touches the count."""

    def __init__(self, spec: KernelSpec, library: Library):
        self.spec = spec
        self.symbol = spec.symbol
        self.library = library
        self.launches = 0
        self._names = input_arrays(spec.prog)
        self._fn = getattr(library.lib, f"launch_{spec.symbol}")
        self._fn.argtypes = [ctypes.c_void_p] * 5
        self._fn.restype = ctypes.c_int

    def __call__(self, arrays: Dict[str, torch.Tensor],
                 scalars: Dict[str, float]) -> torch.Tensor:
        prog = self.spec.prog
        xs = [arrays[a] for a in self._names]
        shape = tuple(xs[0].shape)
        dev = xs[0].device
        for a, x in zip(self._names, xs):
            if x.device.type != "cuda" or x.device != dev:
                raise ValueError(f"{a}: expected a tensor on {dev}, got {x.device}")
            if x.dtype != torch.float32:
                raise TypeError(f"{a}: expected float32, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{a}: expected a contiguous tensor")
            if tuple(x.shape) != shape or x.ndim != prog.ndim:
                raise ValueError(f"{a}: shape {tuple(x.shape)}, expected "
                                 f"{shape} with {prog.ndim} dims")
        interior = interior_shape(shape, prog.halo)
        if min(interior) < 0:
            raise ValueError(f"shape {shape} is smaller than the halo {prog.halo}")
        box = cta_outputs(prog.ndim)
        grid_yz = [-(-interior[a] // box[a]) for a in range(prog.ndim - 1)]
        if any(g > 65535 for g in grid_yz):
            raise ValueError(f"interior {interior} needs more than 65535 "
                             "CTAs along j or k")
        out = torch.empty(interior, dtype=torch.float32, device=dev)
        if out.numel() == 0:
            return out
        ptrs = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
        full = tuple(reversed(shape)) + (1,) * (3 - prog.ndim)   # (i, j, k)
        dims = (ctypes.c_longlong * 3)(*full)
        sc = (ctypes.c_float * max(1, len(prog.scalars)))(
            *[float(scalars[s]) for s in prog.scalars])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(ptrs, out.data_ptr(), dims, sc, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed "
                               f"(cudaError {rc})")
        self.launches += 1
        return out
