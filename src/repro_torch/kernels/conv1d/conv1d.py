"""The depthwise causal conv1d kernel for Hopper: the conv as a stencil
program, the shuffle schedule from the emulator's detection, and the
CUDA code generator and launch wrapper.

Replaces ``src/repro/kernels/conv1d/conv1d.py`` (the Pallas kernel).  The
TPU kernel staged one halo tile per grid step and imitated the register
shuffle with shifted slices of it; here a warp marches along the sequence
and the ``shuffle`` mode issues ``__shfl_down_sync``/``__shfl_up_sync``
itself.  Which taps move, from where and by how far is not chosen by
hand: the width-W conv is written as the stencil program
``y[i] = sum_t c_t * x[i - W + 1 + t]`` (the reference's
``tests/test_kernels.py::test_ptxasw_finds_conv_deltas``), lowered to
PTX, emulated symbolically and searched for shuffle pairs; the kernel is
generated from the resulting row schedule (one source tap, the other
W - 1 taps covered with deltas 1..W-1) and is built only if that
schedule equals the detection tap by tap (``synthesize_cuda``'s
``consistent``).  ``csrc/conv1d_common.cuh`` holds the layout (a warp is
8 positions x 4 channel groups, so a position delta d is a lane delta
4d), the march, the masked loads, the shuffles and the launcher.

x may be a row-strided view (the model passes its in-projection's
columns in place); :func:`vec_width` picks the widest vector that C,
the strides and every base address allow.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.build import Library
from repro_torch.core.frontend import stencil as dsl

MODES = ("naive", "shuffle")

#: the warp's layout and the CTA's shape (``kPos``, ``kGroups``,
#: ``kWarpsC``, ``kWarpsL`` in ``conv1d_common.cuh``)
POSITIONS, GROUPS, WARPS_C, WARPS_L = 8, 4, 4, 2
#: 8-position segments each warp marches over, and how many steps before
#: its use a segment's source row is fetched: the best of a sweep on the
#: served inputs, though every march of 2-8 segments came within a few
#: per cent of it (PERF.md)
STEPS, AHEAD = 4, 2

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
    if len(row.sources) != 1 or any(src != row.sources[0] or not 0 < d < POSITIONS
                                    for _, src, d in row.covered):
        raise ValueError(f"conv width {W}: the schedule {row} is not one source "
                         f"row with covered taps less than a segment away")
    return KernelSpec(mode, W, tuple(row.sources), tuple(row.covered))


def _var(off: int) -> str:
    return f"v_m{-off}" if off < 0 else f"v_{off}"


def kernel_source(spec: KernelSpec) -> str:
    """CUDA source of one (mode, W) kernel template and its launcher: per
    step of the march of ``STEPS`` segments, the fetches (``naive``: one
    load per tap; ``shuffle``: the segment's source row from the ring
    fetched ``AHEAD`` steps early, each covered tap by ``rc::covered``),
    then the W multiply-adds."""
    W, S, A = spec.W, STEPS, AHEAD
    pack = "rc::Pack<T, VEC>"
    prologue, body = [], []
    if spec.mode == "shuffle":
        (src,) = spec.sources
        fetch = f"rc::source_row<T, VEC, {W}, S>(x, s, {{}}, {src})"
        prologue = [
            f"{pack} row[S + 1];   // segment i's source row, fetched AHEAD steps early",
            "#pragma unroll",
            f"for (int i = 0; i <= AHEAD && i <= S; ++i) row[i] = {fetch.format('i')};"]
        body.append(f"if (i + AHEAD + 1 <= S) row[i + AHEAD + 1] = "
                    f"{fetch.format('i + AHEAD + 1')};")
        body.append(f"const {pack} {_var(src)} = row[i];")
        for dst, _, delta in spec.covered:
            body.append(f"const {pack} {_var(dst)} = "
                        f"rc::covered<T, VEC>(row[i], row[i + 1], {delta}, s);")
    else:
        for off in spec.sources:
            body.append(f"const {pack} {_var(off)} = rc::load_tap<T, VEC>(x, s, i, {off});")
    body += ["float acc[VEC];", "wb.init(acc);"]
    body += [f"wb.tap(acc, {_var(t - W + 1)}, {t});" for t in range(W)]
    body.append("rc::finish<T, VEC>(a, acc, s, i);")
    i6 = "\n      "
    return (
        f"// mode {spec.mode}, width {W}, a march of {S} segments fetched {A} ahead; "
        f"sources {list(spec.sources)}, covered (dst, src, delta) "
        f"{[list(c) for c in spec.covered]}\n"
        f"template <typename T, int VEC>\n"
        f"__global__ void __launch_bounds__(rc::kThreads) {spec.symbol}(const rc::Args a) {{\n"
        f"  constexpr int S = {S}, AHEAD = {A};\n"
        f"  const T* __restrict__ x = static_cast<const T*>(a.x);\n"
        f"  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {{\n"
        f"    const rc::Site s = rc::site<VEC, S>(a, item);\n"
        f"    const rc::Weights<T, VEC, {W}> wb(a, s);\n"
        + "".join(f"{'' if line[0] == '#' else '    '}{line}\n" for line in prologue)
        + f"#pragma unroll\n"
        f"    for (int i = 0; i < S; ++i) {{\n"
        f"      if (rc::past_end(s, i)) break;{i6}{i6.join(body)}\n"
        f"    }}\n"
        f"  }}\n}}\n"
        f"RC_LAUNCHER({spec.symbol}, {S})\n")


def cuda_source(specs: Sequence[KernelSpec]) -> str:
    """One translation unit holding every requested kernel."""
    return "\n".join(['#include "conv1d_common.cuh"\n']
                     + [kernel_source(s) for s in specs])


def vec_width(itemsize: int, C: int, strides: Sequence[int],
              addresses: Sequence[int]) -> int:
    """The widest vector of elements (at most 16 bytes) that divides C and
    every element stride in ``strides`` and to which every byte address in
    ``addresses`` is aligned: a stride or base that breaks 16-byte
    alignment gets a narrower vector, not an error."""
    vec = 16 // itemsize
    while vec > 1 and (C % vec or any(st % vec for st in strides)
                       or any(ad % (vec * itemsize) for ad in addresses)):
        vec //= 2
    return vec


class Conv1dKernel:
    """A built (mode, W) kernel.  Calling it launches the kernel on the
    current stream, as many CTAs as fit on the card at once walking the
    items (or one per item where there are fewer), and adds one to
    ``launches``; nothing else touches the count."""

    def __init__(self, spec: KernelSpec, library: Library):
        self.spec = spec
        self.symbol = spec.symbol
        self.library = library
        self.launches = 0
        self._fn = getattr(library.lib, f"launch_{spec.symbol}")
        self._fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p])
        self._fn.restype = ctypes.c_int
        self._resident = getattr(library.lib, f"resident_{spec.symbol}")
        self._resident.argtypes = [ctypes.c_int, ctypes.c_int]
        self._resident.restype = ctypes.c_int
        self._ctas: Dict[Tuple[torch.device, int, int], int] = {}

    def resident_ctas(self, device: torch.device, dtype: torch.dtype, vec: int) -> int:
        """CTAs of the (dtype, vec) instance that fit on ``device`` at once."""
        key = (device, _DTYPE_CODE[dtype], vec)
        if key not in self._ctas:
            with torch.cuda.device(device):
                n = self._resident(key[1], vec)
            if n <= 0:
                raise RuntimeError(f"{self.symbol}: occupancy query failed ({n})")
            self._ctas[key] = n
        return self._ctas[key]

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
        if not (w.is_contiguous() and b.is_contiguous()):
            raise ValueError("w, b: expected contiguous tensors")
        if x.ndim != 3:
            raise ValueError(f"x: expected (B, L, C), got shape {tuple(x.shape)}")
        B, L, C = x.shape
        if C > 1 and x.stride(2) != 1:
            raise ValueError(f"x: expected contiguous channels, got strides {x.stride()}")
        if tuple(w.shape) != (W, C) or tuple(b.shape) != (C,):
            raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)}: "
                             f"expected ({W}, {C}) / ({C},)")
        out = torch.empty((B, L, C), dtype=x.dtype, device=dev)
        if out.numel() == 0:
            return out
        strides = [st for st, n in zip(x.stride()[:2], (B, L)) if n > 1]
        vec = vec_width(x.element_size(), C, strides,
                        [t.data_ptr() for t in (x, w, b, out)])
        tiles_c = -(-C // (WARPS_C * GROUPS * vec))
        if tiles_c * -(-L // (WARPS_L * POSITIONS * STEPS)) * B >= 2 ** 31 \
                or B * L * C >= 2 ** 62:
            raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
        ctas = self.resident_ctas(dev, x.dtype, vec)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
                          b.data_ptr(), out.data_ptr(), B, L, C, _DTYPE_CODE[x.dtype],
                          vec, int(bool(activation)), ctas, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed "
                               f"(cudaError {rc})")
        self.launches += 1
        return out
