"""Plain PyTorch version of the stencil kernel (mirrors
``src/repro/kernels/stencil/ref.py``).

Evaluates a :class:`repro_torch.core.frontend.stencil.Program` over
tensors by interior slicing.  Array layout convention, as in the
reference: the DSL index tuple is ``(i, j, k)`` with ``i`` the leading
(contiguous / thread) dimension; tensors are stored with ``i`` as the
*last* axis, i.e. a 3-dim array has shape ``(nk, nj, ni)``.  The result
covers the interior (full shape minus the per-dim halo on each side).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.frontend.stencil import (
    Bin,
    Call,
    Const,
    Expr,
    Load,
    Program,
    Reduce,
    Scalar,
)

_CALLS = {
    "sin": torch.sin,
    "cos": torch.cos,
    "sqrt": torch.sqrt,
    "ex2": torch.exp2,
    "lg2": torch.log2,
}

_BINS = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div}


def tap_offsets(ld: Load, ndim: int) -> Tuple[int, ...]:
    """Constant offsets of a load along the parallel dims (i, j, k)."""
    out = []
    for d in range(ndim):
        ix = ld.idx[d] if d < len(ld.idx) else None
        if ix is None:
            out.append(0)
            continue
        for v, c in ix.coeffs:
            if v not in ("i", "j", "k"):
                raise ValueError(f"non-parallel index var {v!r} in {ld}")
            if c != 1:
                raise ValueError(f"non-unit stride {c} in {ld}")
        out.append(ix.const)
    return tuple(out)


def interior_shape(shape: Tuple[int, ...], halo: Tuple[int, ...]) -> Tuple[int, ...]:
    """Interior of an array stored (…, nj, ni) with halo ordered (i, j, k)."""
    ndim = len(shape)
    return tuple(shape[a] - 2 * halo[ndim - 1 - a] for a in range(ndim))


def _tap(x: torch.Tensor, offs: Tuple[int, ...], halo: Tuple[int, ...]) -> torch.Tensor:
    """Interior view of ``x`` shifted by per-dim constant offsets."""
    nd = x.ndim
    slices = []
    for axis in range(nd):
        d = nd - 1 - axis           # parallel-dim index for this axis
        h, c = halo[d], offs[d]
        slices.append(slice(h + c, x.shape[axis] - h + c))
    return x[tuple(slices)]


def evaluate(prog: Program, arrays: Dict[str, torch.Tensor],
             scalars: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Evaluate the program; returns the interior-shaped float32 output.

    Constants and scalars are rounded to float32 first, and every
    operation is a separate float32 tensor op, so nothing is fused.
    """
    scalars = scalars or {}
    halo = prog.halo
    device = next(iter(arrays.values())).device

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=device)

    def ev(e: Expr) -> torch.Tensor:
        if isinstance(e, Load):
            x = arrays[e.array]
            return _tap(x, tap_offsets(e, x.ndim), halo)
        if isinstance(e, Const):
            return f32(e.value)
        if isinstance(e, Scalar):
            return f32(scalars[e.name])
        if isinstance(e, Bin):
            return _BINS[e.op](ev(e.a), ev(e.b))
        if isinstance(e, Call):
            return _CALLS[e.fn](ev(e.arg))
        if isinstance(e, Reduce):
            raise NotImplementedError(
                "Reduce programs (matmul/matvec) have no stencil kernel; "
                "they are the paper's negative cases")
        raise TypeError(e)

    return ev(prog.expr).to(torch.float32)
