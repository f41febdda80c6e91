"""Public entry point for the CUDA SSD chunked-scan kernel (counterpart
of ``src/repro/kernels/ssd/ssd.py::ssd_pallas``).

``ssd`` returns ``(y, final_state)``: the Pallas kernel returns y only,
but the serving path carries the final state into decode.  A tensor on
the CPU takes the plain version (:mod:`.ref`); a tensor on the card
launches the kernel, built at first use, or raises: its bf16 tensor-core
instance (three CUDA kernels) or its float32-arithmetic one, as
:func:`select_instance` says.  x, B and C may be
views with any batch and position strides (the model passes slices of
the conv output without copying them); their last dimensions must be
contiguous.  B and C hold G groups (Mamba-2 one, Zamba2-7B two); head h
reads group h // (H / G).  On inputs that need a gradient, a call on the
tensor-core instance with one group runs through :class:`SSDFunction`,
whose backward is :class:`SSDBwdKernel` (``csrc/ssd_bwd.cu``: eight CUDA
kernels on the tensor cores, the factoring of :func:`ref.ssd_passes_bwd`,
which sums dB and dC over all the heads); any other call, G > 1
included, runs through :class:`~repro_torch.kernels.autograd.PlainGrad`,
whose backward is autograd of :func:`ref.ssd_chunked`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.build import Library, build_library
from repro_torch.tracing import span
from ..autograd import PLAIN_DEVICES, with_plain_grad
from ..instances import InstanceCounts, tma_ready
from . import ref as ssd_ref

CSRC = Path(__file__).resolve().parent / "csrc"
COMMON_CSRC = Path(__file__).resolve().parents[1] / "csrc"     # hopper.cuh
SOURCE = CSRC / "ssd.cu"
#: the gradient of the tensor-core instance, compiled after :data:`SOURCE`
#: in the same library (it launches that file's pass a)
BWD_SOURCE = CSRC / "ssd_bwd.cu"

#: what the kernel takes (``kMaxQ``, ``kMaxN``, ``kMaxP`` in ``ssd.cu``)
MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 256, 128, 64

#: the kernel's instances: bf16 on the tensor cores (three passes: chunk
#: states, state passing, chunk scan) and the float32-arithmetic instance on
#: the CUDA cores (float32, and bf16 shapes the first does not take)
INSTANCES = ("tensor_core", "cuda_core")
#: CUDA kernels one call of each instance launches
KERNELS_PER_CALL = {"tensor_core": 3, "cuda_core": 1}
#: CUDA kernels one call of the tensor-core instance's backward launches
BWD_KERNELS_PER_CALL = 8
#: state sizes the tensor-core instance takes (it also needs P 64 and a
#: chunk that is a multiple of 64 up to 256)
TENSOR_CORE_STATES = (64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def select_instance(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    chunk: int) -> str:
    """The instance a call runs, from dtype, shape and layout alone:
    ``tensor_core`` for bf16 with P 64, N in :data:`TENSOR_CORE_STATES`, a
    chunk that is a multiple of 64 up to 256 and x, B, C that a bulk tensor
    copy can read; else ``cuda_core``."""
    if (xh.dtype == torch.bfloat16 and xh.shape[-1] == 64
            and Bm.shape[-1] in TENSOR_CORE_STATES
            and chunk % 64 == 0 and 64 <= chunk <= MAX_CHUNK
            and all(tma_ready(t) for t in (xh, Bm, Cm))):
        return "tensor_core"
    return "cuda_core"


class SSDKernel(InstanceCounts):
    """The built kernel.  Calling it launches the instance that
    :func:`select_instance` picks on the current stream and adds one to
    ``launches`` and to that instance's count in ``instance_launches``;
    nothing else touches the counts."""

    symbol = "ssd"
    instances = INSTANCES

    def __init__(self, library: Library):
        super().__init__()
        self.library = library
        self._fn = library.lib.launch_ssd
        self._fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int]
                             + [ctypes.c_void_p])
        self._fn.restype = ctypes.c_int
        self._fn_tc = library.lib.launch_ssd_wgmma
        self._fn_tc.argtypes = [ctypes.c_void_p] * 14
        self._fn_tc.restype = ctypes.c_int
        #: the tensor-core instance's gradient, from the same library
        self.backward = SSDBwdKernel(library)

    def __call__(self, xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = xh.device
        for name, t in (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        if xh.dtype not in _DTYPE_CODE or Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
            raise TypeError(f"xh, Bm, Cm: expected one dtype, float32 or bfloat16; "
                            f"got {xh.dtype}, {Bm.dtype}, {Cm.dtype}")
        if dt.dtype != torch.float32 or A.dtype != torch.float32:
            raise TypeError(f"dt, A: expected float32, got {dt.dtype}, {A.dtype}")
        if xh.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 or Cm.ndim != 4:
            raise ValueError("expected xh (B,L,H,P), dt (B,L,H), A (H,), "
                             "Bm and Cm (B,L,G,N)")
        B, L, H, P = xh.shape
        G, N = Bm.shape[2], Bm.shape[3]
        if G < 1 or H % G:
            raise ValueError(f"{H} heads are not a multiple of {G} B/C groups")
        if (tuple(dt.shape) != (B, L, H) or tuple(A.shape) != (H,)
                or tuple(Bm.shape) != (B, L, G, N) or tuple(Cm.shape) != (B, L, G, N)):
            raise ValueError(f"shapes xh {tuple(xh.shape)}, dt {tuple(dt.shape)}, "
                             f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
                             f"Cm {tuple(Cm.shape)} do not agree")
        if L % chunk:
            raise ValueError(f"sequence length {L} is not a multiple of the "
                             f"chunk {chunk}")
        if not (1 <= chunk <= MAX_CHUNK and 1 <= N <= MAX_STATE
                and 4 <= P <= MAX_HEAD_DIM and P % 4 == 0):
            raise ValueError(f"chunk {chunk}, N {N}, P {P}: the kernel takes "
                             f"chunk <= {MAX_CHUNK}, N <= {MAX_STATE} and P a "
                             f"multiple of 4 up to {MAX_HEAD_DIM}")
        if B > 65535:
            raise ValueError(f"batch {B} exceeds the launch grid")
        if (xh.stride(3) != 1 or xh.stride(2) != P or dt.stride(2) != 1
                or not A.is_contiguous() or Bm.stride(3) != 1 or Cm.stride(3) != 1
                or (G > 1 and (Bm.stride(2) != N or Cm.stride(2) != N))):
            raise ValueError("xh's (H, P), dt's H, A, and Bm's and Cm's (G, N) "
                             "must be contiguous")
        y = torch.empty((B, L, H, P), dtype=xh.dtype, device=dev)
        state = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
        if y.numel() == 0:
            return y, state.zero_()
        strides = (ctypes.c_longlong * 10)(
            xh.stride(0), xh.stride(1), dt.stride(0), dt.stride(1),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            Bm.stride(2), Cm.stride(2))
        dims = (ctypes.c_int * 7)(B, L, H, P, N, chunk, G)
        instance = select_instance(xh, Bm, Cm, chunk)
        ptrs = (xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if instance == "tensor_core":
                nc = L // chunk
                cum, dtc = torch.empty((2, B, H, nc, chunk), dtype=torch.float32,
                                       device=dev)
                dS = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=dev)
                # the state's term of every chunk but the first, which has none
                y_state = torch.empty((B, nc - 1, H, chunk, P), dtype=torch.float32,
                                      device=dev)
                rc = self._fn_tc(*ptrs, cum.data_ptr(), dtc.data_ptr(), dS.data_ptr(),
                                 y_state.data_ptr(), strides, dims, stream)
            else:
                rc = self._fn(*ptrs, strides, dims, _DTYPE_CODE[xh.dtype], stream)
        if rc != 0:
            raise RuntimeError(f"ssd ({instance}): kernel launch failed "
                               f"(cudaError {rc})")
        self.count(instance)
        return y, state


class SSDBwdKernel(InstanceCounts):
    """The tensor-core instance's gradient.  Calling it with y's cotangent
    ``dy`` and the final state's ``d_final`` (or None) launches
    :data:`BWD_KERNELS_PER_CALL` CUDA kernels on the current stream and
    returns (dx, ddt, dA, dB, dC) in their inputs' dtypes; each call adds
    one to ``launches`` and to ``instance_launches["tensor_core"]``."""

    symbol = "ssd_bwd"
    instances = ("tensor_core",)

    def __init__(self, library: Library):
        super().__init__()
        self._fn = library.lib.launch_ssd_bwd
        self._fn.argtypes = [ctypes.c_void_p] * 16
        self._fn.restype = ctypes.c_int
        self._scratch = library.lib.ssd_bwd_scratch
        self._scratch.argtypes = [ctypes.c_void_p]
        self._scratch.restype = ctypes.c_longlong

    def __call__(self, xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int, dy: torch.Tensor,
                 d_final: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        if select_instance(xh, Bm, Cm, chunk) != "tensor_core":
            raise ValueError("the backward kernel takes the tensor-core instance's "
                             "inputs (ssd.select_instance)")
        B, L, H, P = xh.shape
        N = Bm.shape[-1]
        if (Bm.shape[2] != 1 or Cm.shape != Bm.shape or Bm.dtype != xh.dtype
                or Cm.dtype != xh.dtype or tuple(dt.shape) != (B, L, H) or tuple(A.shape) != (H,)
                or dt.dtype != torch.float32 or A.dtype != torch.float32
                or dt.stride(2) != 1 or not A.is_contiguous()
                or xh.stride(2) != P or L % chunk):
            raise ValueError("the backward kernel takes the forward kernel's inputs")
        if tuple(dy.shape) != (B, L, H, P):
            raise ValueError(f"dy: expected {(B, L, H, P)}, got {tuple(dy.shape)}")
        dev = xh.device
        dy = dy.to(torch.bfloat16).contiguous()
        if d_final is not None:
            if tuple(d_final.shape) != (B, H, N, P):
                raise ValueError(f"d_final: expected {(B, H, N, P)}, got "
                                 f"{tuple(d_final.shape)}")
            d_final = d_final.to(torch.float32).contiguous()
        dims = (ctypes.c_int * 6)(B, L, H, P, N, chunk)
        strides = (ctypes.c_longlong * 8)(
            xh.stride(0), xh.stride(1), dt.stride(0), dt.stride(1),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
        dx = torch.empty((B, L, H, P), dtype=xh.dtype, device=dev)
        ddt = torch.empty((B, L, H), dtype=torch.float32, device=dev)
        dA = torch.empty((H,), dtype=torch.float32, device=dev)
        dB = torch.empty((B, L, 1, N), dtype=Bm.dtype, device=dev)
        dC = torch.empty((B, L, 1, N), dtype=Cm.dtype, device=dev)
        scratch = torch.empty((self._scratch(dims),), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                          Cm.data_ptr(), dy.data_ptr(),
                          None if d_final is None else d_final.data_ptr(),
                          dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                          dC.data_ptr(), scratch.data_ptr(), strides, dims, stream)
        if rc != 0:
            raise RuntimeError(f"ssd backward: kernel launch failed (cudaError {rc})")
        self.count("tensor_core")
        return dx, ddt, dA, dB, dC


class SSDFunction(torch.autograd.Function):
    """The tensor-core instance with its own backward:
    ``forward(ctx, chunk, xh, dt, A, Bm, Cm)`` returns the forward kernel's
    (y, final_state); the backward runs :class:`SSDBwdKernel` on the saved
    inputs in an ``autograd.backward`` span (kernel ``ssd``), as
    :class:`~repro_torch.kernels.autograd.PlainGrad` does."""

    @staticmethod
    def forward(ctx, chunk: int, xh, dt, A, Bm, Cm):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        return build_kernel()(xh, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy, d_final):
        with span("autograd.backward", kernel="ssd"):
            xh, dt, A, Bm, Cm = ctx.saved_tensors
            if dy is None:
                dy = torch.zeros_like(xh)
            grads = _KERNEL.backward(xh, dt, A, Bm, Cm, ctx.chunk, dy, d_final)
        return (None, *[g if n else None for g, n in zip(grads, ctx.needs_input_grad[1:])])


_KERNEL: Optional[SSDKernel] = None


def build_kernel() -> SSDKernel:
    """Build (once, with one ``nvcc`` call, the forward and its backward
    in one library) and return the kernel; its backward is ``.backward``."""
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = SSDKernel(build_library(SOURCE.read_text() + "\n" + BWD_SOURCE.read_text(),
                                          [CSRC, COMMON_CSRC]))
    return _KERNEL


def launch_counts():
    """Calls of the kernel and of its backward since the last reset ({}
    before they are built)."""
    if _KERNEL is None:
        return {}
    return {_KERNEL.symbol: _KERNEL.launches, _KERNEL.backward.symbol: _KERNEL.backward.launches}


def instance_counts():
    """Calls per instance since the last reset, keyed ``ssd/<instance>`` and
    ``ssd_bwd/tensor_core`` ({} before the kernel is built); a call of
    ``tensor_core`` launches :data:`KERNELS_PER_CALL` CUDA kernels, one of
    its backward :data:`BWD_KERNELS_PER_CALL`."""
    if _KERNEL is None:
        return {}
    return {**_KERNEL.instance_counts(), **_KERNEL.backward.instance_counts()}


def reset_launch_counts() -> None:
    if _KERNEL is not None:
        _KERNEL.reset()
        _KERNEL.backward.reset()


def ssd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.  xh: (B, L, H, P); dt: (B, L, H) float32 post-softplus;
    A: (H,) float32 negative; Bm, Cm: (B, L, G, N), H % G == 0.  L % chunk
    == 0.

    Returns (y (B, L, H, P), final_state (B, H, N, P) float32); on the card
    differentiable through the backward kernel (tensor-core instance, one
    group) or the plain version (any other).
    """
    if xh.device.type in PLAIN_DEVICES:
        return ssd_ref.ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    kernel = build_kernel()
    if (torch.is_grad_enabled() and any(t.requires_grad for t in (xh, dt, A, Bm, Cm))
            and Bm.shape[2] == 1 and select_instance(xh, Bm, Cm, chunk) == "tensor_core"):
        return SSDFunction.apply(chunk, xh, dt, A, Bm, Cm)
    return with_plain_grad("ssd", lambda *a: kernel(*a, chunk),
                           lambda *a: ssd_ref.ssd_chunked(*a, chunk),
                           xh, dt, A, Bm, Cm)
