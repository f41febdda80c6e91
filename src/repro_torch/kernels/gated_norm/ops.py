"""Public entry point for the CUDA kernel of the Mamba-2 mixer's tail.

``gated_norm_tail`` takes the SSD's output y and input xh (B, L, H, P),
the gate z (B, L, H P), the skip D (H,) and the norm's scale, and returns
``RMSNorm_G(T(y + D xh) * silu(z)) * scale`` (:func:`ref.gated_norm_tail`).
A tensor on the CPU or ``meta`` takes the plain version (:mod:`.ref`); a
tensor on the card launches the kernel, built at first use, or raises on
what it does not take (:func:`check_operands`).  On inputs that need a
gradient the kernel runs through
:class:`~repro_torch.kernels.autograd.PlainGrad`, whose backward is
autograd of the plain version, as conv1d's does.

xh and z may be column ranges of wider tensors (the conv output and the
in-projection): the kernel reads them in place.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.build import Library, build_library
from ..autograd import PLAIN_DEVICES, with_plain_grad
from . import ref as gn_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gated_norm.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: CTA threads and the most 16-byte vectors a thread takes (``kThreads``,
#: ``kMaxVpt`` in ``gated_norm.cu``): the widest group the kernel takes
THREADS, MAX_VPT = 128, 8


def check_operands(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                   d_skip: torch.Tensor, scale: torch.Tensor, groups: int,
                   dtype: torch.dtype) -> None:
    """Raises ``TypeError`` or ``ValueError`` on operands the kernel does not
    take; needs no device.  The kernel takes y and xh (B, L, H, P) and z
    (B, L, H P) of one dtype, float32 or bfloat16, with the scale and the
    output in it too; d_skip (H,) float32; channels in 16-byte vectors: unit
    channel stride, H P contiguous in y and xh, and bases, batch and position
    strides and P on 16-byte boundaries; G dividing H P in groups of whole
    vectors, each at most :data:`THREADS` x :data:`MAX_VPT` vectors."""
    if y.dtype not in _DTYPE_CODE or any(t.dtype != y.dtype for t in (xh, z, scale)) \
            or dtype != y.dtype:
        raise TypeError(f"y, xh, z, scale and the output: expected one dtype, float32 "
                        f"or bfloat16; got {y.dtype}, {xh.dtype}, {z.dtype}, "
                        f"{scale.dtype} and {dtype}")
    if d_skip.dtype != torch.float32:
        raise TypeError(f"d_skip: expected float32, got {d_skip.dtype}")
    if y.ndim != 4 or xh.ndim != 4 or z.ndim != 3:
        raise ValueError("expected y and xh (B, L, H, P) and z (B, L, H P)")
    B, L, H, P = xh.shape
    C = H * P
    if (tuple(y.shape) != (B, L, H, P) or tuple(z.shape) != (B, L, C)
            or tuple(d_skip.shape) != (H,) or tuple(scale.shape) != (C,)):
        raise ValueError(f"shapes y {tuple(y.shape)}, xh {tuple(xh.shape)}, z "
                         f"{tuple(z.shape)}, d_skip {tuple(d_skip.shape)}, scale "
                         f"{tuple(scale.shape)} do not agree")
    vec = 16 // y.element_size()
    if groups < 1 or C % groups or (C // groups) % vec:
        raise ValueError(f"{groups} groups do not divide {C} channels into whole "
                         f"{vec}-element vectors")
    if C // groups > THREADS * MAX_VPT * vec:
        raise ValueError(f"a group of {C // groups} channels exceeds the kernel's "
                         f"{THREADS * MAX_VPT * vec}")
    if P % vec:
        raise ValueError(f"head size {P} is not a multiple of {vec} elements")
    for name, t in (("y", y), ("xh", xh)):
        if t.stride(3) != 1 or t.stride(2) != P:
            raise ValueError(f"{name}: its (H, P) must be contiguous")
    if z.stride(2) != 1 or not scale.is_contiguous() or not d_skip.is_contiguous():
        raise ValueError("z's channels, scale and d_skip must be contiguous")
    for name, t in (("y", y), ("xh", xh), ("z", z), ("scale", scale)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: base address not 16-byte aligned")
    for name, t in (("y", y), ("xh", xh), ("z", z)):
        if any(t.stride(d) % vec and t.shape[d] > 1 for d in (0, 1)):
            raise ValueError(f"{name}: batch and position strides {t.stride()[:2]} "
                             f"are not multiples of 16 bytes")
    if B * L > 2 ** 31 - 1 or groups > 65535:
        raise ValueError(f"{B * L} rows and {groups} groups exceed the launch grid")


class GatedNormKernel:
    """The built kernel.  Calling it checks its operands, launches one CUDA
    kernel on the current stream and adds one to ``launches``."""

    symbol = "gated_norm"

    def __init__(self, library: Library):
        self.library = library
        self.launches = 0
        self._fn = library.lib.launch_gated_norm
        self._fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float] * 2
                             + [ctypes.c_int, ctypes.c_void_p])
        self._fn.restype = ctypes.c_int

    def __call__(self, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                 d_skip: torch.Tensor, scale: torch.Tensor, groups: int,
                 eps: float, dtype: torch.dtype) -> torch.Tensor:
        dev = y.device
        for name, t in (("y", y), ("xh", xh), ("z", z), ("d_skip", d_skip),
                        ("scale", scale)):
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        check_operands(y, xh, z, d_skip, scale, groups, dtype)
        B, L, H, P = xh.shape
        C = H * P
        out = torch.empty((B, L, C), dtype=dtype, device=dev)
        if out.numel() == 0:
            return out
        strides = (ctypes.c_longlong * 6)(y.stride(0), y.stride(1), xh.stride(0),
                                          xh.stride(1), z.stride(0), z.stride(1))
        dims = (ctypes.c_int * 5)(B, L, C, groups, P)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(y.data_ptr(), xh.data_ptr(), z.data_ptr(), d_skip.data_ptr(),
                          scale.data_ptr(), out.data_ptr(), strides, dims,
                          1.0 / (C // groups), eps, _DTYPE_CODE[dtype], stream)
        if rc != 0:
            raise RuntimeError(f"gated_norm: kernel launch failed (cudaError {rc})")
        self.launches += 1
        return out


_KERNEL: Optional[GatedNormKernel] = None


def build_kernel() -> GatedNormKernel:
    """Build (once, with one ``nvcc`` call) and return the kernel."""
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = GatedNormKernel(build_library(SOURCE.read_text(), []))
    return _KERNEL


def launch_counts() -> Dict[str, int]:
    """Launches since the last reset (empty before the kernel is built)."""
    return {} if _KERNEL is None else {_KERNEL.symbol: _KERNEL.launches}


def reset_launch_counts() -> None:
    if _KERNEL is not None:
        _KERNEL.launches = 0


def gated_norm_tail(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                    d_skip: torch.Tensor, scale: torch.Tensor, groups: int,
                    eps: float, dtype: torch.dtype) -> torch.Tensor:
    """The mixer's tail.  y, xh: (B, L, H, P); z: (B, L, H P); d_skip: (H,)
    float32; scale: (H P,); ``groups`` equal groups of channels, each
    normalised on its own; the result (B, L, H P) in ``dtype``.  Plain on the
    CPU and on ``meta``; else the kernel, differentiable through its plain
    version."""
    if y.device.type in PLAIN_DEVICES:
        return gn_ref.gated_norm_tail(y, xh, z, d_skip, scale, groups, eps, dtype)
    kernel = build_kernel()
    return with_plain_grad(
        "gated_norm", lambda *a: kernel(*a, groups, eps, dtype),
        lambda *a: gn_ref.gated_norm_tail(*a, groups, eps, dtype), y, xh, z, d_skip, scale)
