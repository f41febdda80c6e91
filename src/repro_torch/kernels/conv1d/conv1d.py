"""The depthwise causal conv1d kernel for Hopper: the conv as a stencil
program, the shuffle schedule from the emulator's detection, and the
CUDA code generator and launch wrapper.

Replaces ``src/repro/kernels/conv1d/conv1d.py`` (the Pallas kernel).  The
TPU kernel staged one halo tile and imitated the register shuffle with
shifted slices of it; here the ``shuffle`` mode issues
``__shfl_down_sync`` itself.  Which taps move, from where and by how far
is not chosen by hand: the width-W conv is written as the stencil program
``y[i] = sum_t c_t * x[i - W + 1 + t]`` (the reference's
``tests/test_kernels.py::test_ptxasw_finds_conv_deltas``), lowered to
PTX, emulated symbolically and searched for shuffle pairs; the kernel is
generated from the resulting row schedule (one source tap, the other
W - 1 taps covered with deltas 1..W-1) and is built only if that
schedule equals the detection tap by tap (``synthesize_cuda``'s
``consistent``).  ``csrc/conv1d_common.cuh`` holds the layout (a warp is
8 positions x 4 channel groups, so a position delta d is a lane delta
4d), the masked loads, the shuffles and the launcher.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from repro_torch.build import Library
from repro_torch.core.frontend import stencil as dsl

MODES = ("naive", "shuffle")

#: sequence positions per CTA (``kWarpsL * kPos`` in ``conv1d_common.cuh``)
CTA_POSITIONS = 16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def hbm_bytes(L: int, C: int, W: int, mode: str,
              block_seq: int = 256, block_ch: int = 128,
              itemsize: int = 2) -> int:
    """Analytic HBM read traffic for the x operand of the reference's
    Pallas kernel (its blocking, its fetch plans)."""
    nb_s = -(-L // block_seq)
    nb_c = -(-C // block_ch)
    per_block = (block_seq + W - 1 if mode == "shuffle"
                 else W * block_seq) * block_ch
    return per_block * nb_s * nb_c * itemsize


def conv_program(W: int) -> dsl.Program:
    """The width-W causal conv as a 1-D stencil program: tap t reads
    ``x[i - W + 1 + t]`` (the coefficients do not affect detection)."""
    x = dsl.Array("x")
    terms = [0.1 * (t + 1) * x[dsl.I(t - W + 1)] for t in range(W)]
    expr = terms[0]
    for term in terms[1:]:
        expr = expr + term
    return dsl.Program(name=f"conv1d_w{W}", ndim=1,
                       out=dsl.Array("y")[dsl.I()], expr=expr)


@dataclass(frozen=True)
class KernelSpec:
    """One (mode, W) kernel.  ``sources`` are the tap offsets each lane
    loads; each ``(dst, src, delta)`` of ``covered`` is the tap at offset
    ``dst``, taken from the lane ``delta`` positions later, which loaded
    the source tap ``src`` (empty in ``naive`` mode)."""

    mode: str
    W: int
    sources: Tuple[int, ...]
    covered: Tuple[Tuple[int, int, int], ...]

    @property
    def symbol(self) -> str:
        return f"conv1d_{self.mode}_w{self.W}"


def make_spec(mode: str, W: int) -> KernelSpec:
    """The kernel's tap schedule; in ``shuffle`` mode the emulator's
    detection on :func:`conv_program` decides it, and a schedule that
    disagrees with the detection is refused."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if W < 1:
        raise ValueError(f"conv width {W} < 1")
    if mode == "naive" or W == 1:
        return KernelSpec(mode, W, tuple(range(1 - W, 1)), ())
    # imported here: cuda_lower imports the stencil kernel package
    from repro_torch.core.frontend.cuda_lower import synthesize_cuda

    plan = synthesize_cuda(conv_program(W))
    if not plan.consistent or len(plan.schedule) != 1:
        raise ValueError(
            f"conv width {W}: the shuffle schedule ({plan.n_row_covered} "
            f"covered taps) disagrees with the emulator's detection "
            f"({plan.n_shuffles} pairs); refusing to build")
    row = plan.schedule[0]
    return KernelSpec(mode, W, tuple(row.sources), tuple(row.covered))


def _var(off: int) -> str:
    return f"v_m{-off}" if off < 0 else f"v_{off}"


def kernel_source(spec: KernelSpec) -> str:
    """CUDA source of one (mode, W) kernel template and its launcher."""
    pack = "rc::Pack<T, VEC>"
    body = []
    for off in spec.sources:
        body.append(f"const {pack} {_var(off)} = rc::load_tap<T, VEC>(x, s, {off});")
    for dst, src, delta in spec.covered:
        body.append(f"const {pack} {_var(dst)} = rc::shfl_or_reload<T, VEC>("
                    f"{_var(src)}, {delta}, x, s, {dst});")
    for t in range(spec.W):
        body.append(f"rc::tap<T, VEC>(acc, {_var(t - spec.W + 1)}, w, s, {t});")
    ind = "\n  "
    return (
        f"// mode {spec.mode}, width {spec.W}; sources {list(spec.sources)}, "
        f"covered (dst, src, delta) {[list(c) for c in spec.covered]}\n"
        f"template <typename T, int VEC>\n"
        f"__global__ void __launch_bounds__(rc::kThreads) {spec.symbol}(\n"
        f"    const T* __restrict__ x, const T* __restrict__ w,\n"
        f"    const T* __restrict__ b, T* __restrict__ out, int L, int C, int act) {{\n"
        f"  const rc::Site s = rc::site<VEC>(L, C);\n"
        f"  float acc[VEC];\n"
        f"  rc::init<T, VEC>(acc, b, s);\n"
        f"  {ind.join(body)}\n"
        f"  rc::finish<T, VEC>(out, acc, s, act);\n}}\n"
        f"RC_LAUNCHER({spec.symbol})\n")


def cuda_source(specs: Sequence[KernelSpec]) -> str:
    """One translation unit holding every requested kernel."""
    return "\n".join(['#include "conv1d_common.cuh"\n']
                     + [kernel_source(s) for s in specs])


def _vec_width(tensors: Sequence[torch.Tensor], C: int) -> int:
    """The widest vector (at most 16 bytes) that divides C and to which
    every base address is aligned."""
    itemsize = tensors[0].element_size()
    vec = 16 // itemsize
    while vec > 1 and (C % vec or any(t.data_ptr() % (vec * itemsize)
                                      for t in tensors)):
        vec //= 2
    return vec


class Conv1dKernel:
    """A built (mode, W) kernel.  Calling it launches the kernel on the
    current stream and adds one to ``launches``; nothing else touches
    the count."""

    def __init__(self, spec: KernelSpec, library: Library):
        self.spec = spec
        self.symbol = spec.symbol
        self.library = library
        self.launches = 0
        self._fn = getattr(library.lib, f"launch_{spec.symbol}")
        self._fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p])
        self._fn.restype = ctypes.c_int

    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 activation: bool = True) -> torch.Tensor:
        W = self.spec.W
        dev = x.device
        for name, t in (("x", x), ("w", w), ("b", b)):
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
            if t.dtype not in _DTYPE_CODE or t.dtype != x.dtype:
                raise TypeError(f"{name}: expected float32 or bfloat16 like x, "
                                f"got {t.dtype} (x is {x.dtype})")
            if not t.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous tensor")
        if x.ndim != 3:
            raise ValueError(f"x: expected (B, L, C), got shape {tuple(x.shape)}")
        B, L, C = x.shape
        if tuple(w.shape) != (W, C) or tuple(b.shape) != (C,):
            raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)}: "
                             f"expected ({W}, {C}) / ({C},)")
        if B > 65535 or -(-L // CTA_POSITIONS) > 65535 or B * L * C >= 2 ** 62:
            raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
        out = torch.empty_like(x)
        if out.numel() == 0:
            return out
        vec = _vec_width((x, w, b, out), C)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                          out.data_ptr(), B, L, C, _DTYPE_CODE[x.dtype], vec,
                          int(bool(activation)), stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed "
                               f"(cudaError {rc})")
        self.launches += 1
        return out
