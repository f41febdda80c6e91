"""Public entry point for the CUDA conv1d kernel (mirrors
``src/repro/kernels/conv1d/ops.py``).

``causal_conv1d`` takes the reference's arguments without its blocking
and ``interpret`` knobs.  A tensor on the CPU takes the kernel's plain
version (:mod:`.ref`); a tensor on the card launches the (mode, W)
kernel, built at first use or in bulk by :func:`build_kernels`, or
raises.  Neither the causal halo nor the ragged edge is padded: the
reference's padding would copy the whole (B, L, C) input.  x may be a
view with contiguous channels (a column range of a wider tensor): the
kernel reads it in place.  On inputs that need a gradient the kernel
runs through :class:`~repro_torch.kernels.autograd.PlainGrad`, whose
backward is autograd of the plain version; x's gradient then reaches the
tensor x views.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

from repro_torch.build import build_library
from repro_torch.tracing import count
from ..autograd import PLAIN_DEVICES, with_plain_grad
from . import ref as conv_ref
from .conv1d import MODES, Conv1dKernel, cuda_source, make_spec

CSRC = Path(__file__).resolve().parent / "csrc"

#: built kernels by (mode, W)
_KERNELS: Dict[Tuple[str, int], Conv1dKernel] = {}


def build_kernels(items: Iterable[Tuple[str, int]]) -> List[Conv1dKernel]:
    """Build every ``(mode, W)`` not built yet with one ``nvcc`` call;
    returns the kernels in the order given.  Each schedule's detection
    (:func:`make_spec`) is counted as ``kernels.synthesize``."""
    items = list(items)
    todo = {}
    for mode, W in items:
        if (mode, W) not in _KERNELS and (mode, W) not in todo:
            t0 = time.perf_counter()
            todo[(mode, W)] = make_spec(mode, W)
            count("kernels.synthesize", time.perf_counter() - t0)
    if todo:
        lib = build_library(cuda_source(list(todo.values())), [CSRC])
        for key, spec in todo.items():
            _KERNELS[key] = Conv1dKernel(spec, lib)
    return [_KERNELS[k] for k in items]


def launch_counts() -> Dict[str, int]:
    """Launches per built kernel symbol since the last reset."""
    return {k.symbol: k.launches for k in _KERNELS.values()}


def reset_launch_counts() -> None:
    for k in _KERNELS.values():
        k.launches = 0


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  mode: str = "shuffle", activation: bool = True) -> torch.Tensor:
    """x: (B, L, C); w: (W, C); b: (C,).  Returns (B, L, C) in x's dtype.

    On the CPU (and on ``meta``, shapes only) the plain version runs; on
    the card the (mode, W) kernel,
    differentiable through its plain version.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if x.device.type in PLAIN_DEVICES:
        return conv_ref.causal_conv1d(x, w, b, activation=activation)
    (kernel,) = build_kernels([(mode, w.shape[0])])
    return with_plain_grad("conv1d", lambda *a: kernel(*a, activation=activation),
                           lambda *a: conv_ref.causal_conv1d(*a, activation=activation),
                           x, w, b)
