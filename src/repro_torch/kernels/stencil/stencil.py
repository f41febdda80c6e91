"""The stencil kernel for Hopper: fetch plans, the shuffle schedule and
the CUDA code generator.

Mirrors ``src/repro/kernels/stencil/stencil.py``: ``MODES``, ``Fetch``,
``FetchPlan``, ``make_plan`` and ``hbm_bytes_per_block`` are the
reference's, field for field.  Where the TPU kernel imitated
``shfl.sync`` with a shifted slice of a VMEM tile, the CUDA kernel
issues the instruction itself: a warp's lanes run along ``i`` (as
``lower_to_ptx`` puts ``tid.x`` on ``i``), each thread computes one
output point, and the three modes differ only in how each tap reaches
the thread:

``naive``   one ``__ldg`` per unique tap (the paper's *Original*);
``paper``   per row of the ``paper`` plan, only the row's source taps
            are loaded; every covered tap arrives through
            ``__shfl_down_sync``/``__shfl_up_sync`` by the schedule's
            delta, which ``synthesize_cuda`` requires to equal the
            emulator's detection tap by tap; corner lanes reload from
            global memory;
``tile``    one halo tile per array staged in shared memory.

The device code shared by all kernels is ``csrc/stencil_common.cuh``;
this module emits, per (program, mode), the tap fetches and the
program's expression, then :mod:`repro_torch.build` compiles them.
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


def input_arrays(prog: Program) -> List[str]:
    """Kernel input order: ``sorted`` names, the output excluded."""
    return sorted(a for a in prog.arrays if a != prog.out.array)


def _pad3(off: Tuple[int, ...]) -> Tuple[int, int, int]:
    return tuple(off) + (0,) * (3 - len(off))


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


def _fetches(spec: KernelSpec, arg_of: Dict[str, str],
             tap_var: Dict[Tuple, str], bx: int, by: int) -> List[str]:
    """Statements that define every tap variable, per the mode."""

    def offs(off: Tuple[int, ...]) -> str:
        return ", ".join(str(v) for v in _pad3(off))

    lines: List[str] = []
    if spec.mode == "naive":
        for (arr, off), v in tap_var.items():
            lines.append(f"const float {v} = rs::load({arg_of[arr]}, d, p, {offs(off)});")
    elif spec.mode == "paper":
        for row in spec.rows:
            a = arg_of[row.array]
            for li in row.sources:
                off = (li,) + row.rest
                lines.append(f"const float {tap_var[(row.array, off)]} = "
                             f"rs::load({a}, d, p, {offs(off)});")
            for dst, src, delta in row.covered:
                off = (dst,) + row.rest
                s = tap_var[(row.array, (src,) + row.rest)]
                lines.append(f"const float {tap_var[(row.array, off)]} = "
                             f"rs::shuffled({s}, {a}, d, p, {offs(off)}, {delta});")
    else:  # tile
        sizes = []
        for f in make_plan(spec.prog, "tile").fetches:
            li, lj, lk = _pad3(f.lo)
            hi_, hj, hk = _pad3(f.hi)
            # the CTA covers bx x by x 1 points, widened by the taps' extent
            ti, tj, tk = bx + hi_ - li, by + hj - lj, 1 + hk - lk
            sizes.append(ti * tj * tk)
            lines.append(f"rs::stage<{bx}, {by}>(tile, {arg_of[f.array]}, d, "
                         f"{li}, {lj}, {lk}, {ti}, {tj}, {tk});")
            for off in f.taps:
                lines.append(f"const float {tap_var[(f.array, off)]} = "
                             f"rs::from_tile(tile, {offs(off)}, "
                             f"{li}, {lj}, {lk}, {ti}, {tj});")
        words = max(sizes)
        if 4 * words > _SMEM_LIMIT:
            raise ValueError(f"{spec.symbol}: a {4 * words}-byte tile exceeds "
                             f"{_SMEM_LIMIT} bytes of static shared memory")
        lines.insert(0, f"__shared__ float tile[{words}];")
    return lines


def kernel_source(spec: KernelSpec) -> str:
    """CUDA source of one kernel and its ``extern "C"`` launcher."""
    prog = spec.prog
    if spec.mode not in MODES:
        raise ValueError(f"unknown mode {spec.mode!r}")
    if spec.mode == "paper" and not spec.rows:
        raise ValueError(f"{spec.symbol}: paper mode needs a shuffle schedule")
    block = CTA_BLOCKS[prog.ndim]
    bx, by = block[-1], (block[-2] if prog.ndim > 1 else 1)
    names = input_arrays(prog)
    arg_of = {a: f"a{n}" for n, a in enumerate(names)}
    tap_var = {key: f"t{n}" for n, key in enumerate(_unique_taps(prog))}
    h = _pad3(prog.halo)

    params = ["const rs::Dims d"]
    params += [f"const float* __restrict__ {arg_of[a]}" for a in names]
    params += ["float* __restrict__ out"]
    params += [f"const float s{n}" for n in range(len(prog.scalars))]
    body = _fetches(spec, arg_of, tap_var, bx, by) + _expression(prog, tap_var)

    args = [f"(const float*)in[{n}]" for n in range(len(names))]
    args += ["(float*)out"]
    args += [f"sc[{n}]" for n in range(len(prog.scalars))]
    ind = "\n  "
    return (
        f"// {prog.name}, mode {spec.mode}\n"
        f"extern \"C\" __global__ void __launch_bounds__({bx * by}) "
        f"{spec.symbol}(\n    {', '.join(params)}) {{\n"
        f"  const rs::Point p = rs::point<{bx}, {by}>(d);\n"
        f"  {ind.join(body)}\n"
        f"  rs::store(out, d, p, r);\n}}\n\n"
        f"extern \"C\" int launch_{spec.symbol}(const void* const* in, "
        f"void* out, const long long* shape, const float* sc, "
        f"void* stream) {{\n"
        f"  const rs::Dims d = rs::make_dims(shape, {h[0]}, {h[1]}, {h[2]});\n"
        f"  return rs::launch<{bx}, {by}>({spec.symbol}, d, stream, "
        f"{', '.join(args)});\n}}\n")


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
        block = CTA_BLOCKS[prog.ndim]
        grid_yz = [-(-interior[a] // block[a]) for a in range(prog.ndim - 1)]
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
