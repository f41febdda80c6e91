"""Public entry points for the CUDA stencil kernel (mirrors
``src/repro/kernels/stencil/ops.py``).

``stencil_apply`` returns the interior-shaped output, as the reference
does, but masks the ragged edge inside the kernel instead of padding the
inputs up to a block grid: at the paper's sizes the reference's padding
would be a 4 GiB copy.  Tensors on the CPU take the kernel's plain
version (:mod:`.ref`); tensors on the card launch the kernel.  Kernels
are generated and compiled at first use, or in bulk by
:func:`build_kernels`.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.build import build_library
from repro_torch.core.frontend.stencil import Program
from . import ref as stencil_ref
from .stencil import (
    CTA_BLOCKS,
    MODES,
    KernelSpec,
    StencilKernel,
    cuda_source,
    hbm_bytes_per_block,
    input_arrays,
)

CSRC = Path(__file__).resolve().parent / "csrc"

#: built kernels by (program, mode, max_delta); max_delta only shapes the
#: paper mode's schedule and is None for the others
_KERNELS: Dict[Tuple[str, str, Optional[int]], StencilKernel] = {}


def _key(prog: Program, mode: str, max_delta: int):
    return (repr(prog), mode, max_delta if mode == "paper" else None)


def _spec(prog: Program, mode: str, max_delta: int) -> KernelSpec:
    tag = hashlib.sha256(repr(_key(prog, mode, max_delta)).encode()).hexdigest()[:8]
    symbol = f"stencil_{prog.name}_{mode}_{tag}"
    rows: Tuple = ()
    if mode == "paper":
        # imported here: cuda_lower imports this package's plans
        from repro_torch.core.frontend.cuda_lower import synthesize_cuda

        cp = synthesize_cuda(prog, max_delta)
        if not cp.consistent:
            raise ValueError(
                f"{prog.name}: the shuffle schedule ({cp.n_row_covered} "
                f"covered taps) disagrees with the emulator's detection "
                f"({cp.n_shuffles} pairs) on which taps move, from where or "
                f"by how far; refusing to build")
        rows = tuple(cp.schedule)
    return KernelSpec(symbol, prog, mode, rows)


def build_kernels(items: Iterable[Tuple[Program, str, int]]) -> List[StencilKernel]:
    """Build every ``(program, mode, max_delta)`` not built yet with one
    ``nvcc`` call; returns the kernels in the order given."""
    items = list(items)
    todo: Dict = {}
    for prog, mode, max_delta in items:
        key = _key(prog, mode, max_delta)
        if key not in _KERNELS and key not in todo:
            todo[key] = _spec(prog, mode, max_delta)
    if todo:
        lib = build_library(cuda_source(list(todo.values())), [CSRC])
        for key, spec in todo.items():
            _KERNELS[key] = StencilKernel(spec, lib)
    return [_KERNELS[_key(p, m, d)] for p, m, d in items]


def launch_counts() -> Dict[str, int]:
    """Launches per built kernel symbol since the last reset."""
    return {k.symbol: k.launches for k in _KERNELS.values()}


def reset_launch_counts() -> None:
    for k in _KERNELS.values():
        k.launches = 0


def _on_device(arrays: Dict[str, object], device: str) -> Dict[str, torch.Tensor]:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch version")
    return {a: torch.as_tensor(x, dtype=torch.float32, device=dev)
            for a, x in arrays.items()}


def stencil_apply(prog: Program, arrays: Dict[str, object],
                  scalars: Optional[Dict[str, float]] = None,
                  mode: str = "tile", max_delta: int = 31,
                  device: str = "cuda") -> torch.Tensor:
    """Run the stencil program; returns the interior-shaped output.

    ``arrays`` (tensors or numpy arrays, ``i`` as the last axis) are
    moved to ``device``; on the CPU the plain version runs, on the card
    the (program, mode) kernel, built at first use.  ``max_delta``
    bounds the paper mode's shuffle deltas, as it bounds detection.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    tensors = _on_device(arrays, device)
    scalars = dict(scalars or {})
    if torch.device(device).type == "cpu":
        return stencil_ref.evaluate(prog, tensors, scalars)
    (kernel,) = build_kernels([(prog, mode, max_delta)])
    return kernel({a: tensors[a].contiguous() for a in input_arrays(prog)},
                  scalars)


def reference(prog: Program, arrays: Dict[str, torch.Tensor],
              scalars: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """The plain PyTorch version (same interior-shaped output)."""
    return stencil_ref.evaluate(prog, arrays, scalars)


def traffic_report(prog: Program, shape: Tuple[int, ...],
                   block: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Analytic global-memory read traffic per mode for a full problem, in
    bytes: the reference's fetch-plan model evaluated at the CUDA
    kernel's CTA shape (``block`` in array-axis order).  ``compulsory``
    is each input array read once plus the interior output written once.
    """
    block = tuple(block) if block else CTA_BLOCKS[prog.ndim]
    nd = prog.ndim
    interior = stencil_ref.interior_shape(tuple(shape), prog.halo)
    n_blocks = 1
    for a in range(nd):
        n_blocks *= -(-interior[a] // block[a])
    out = {}
    for mode in MODES:
        out[mode] = float(hbm_bytes_per_block(prog, mode, block) * n_blocks)
    out["reduction_paper"] = out["naive"] / out["paper"]
    out["reduction_tile"] = out["naive"] / out["tile"]
    out["compulsory"] = float(4 * (len(input_arrays(prog)) * np.prod(shape)
                                   + np.prod(interior)))
    return out
