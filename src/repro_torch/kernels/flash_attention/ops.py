"""Public entry point for the CUDA flash-attention kernel (counterpart of
``src/repro/kernels/flash_attention/flash_attention.py::flash_attention``).

``flash_attention(q, k, v, causal)`` keeps the reference's contract: q is
(B, Sq, H, Dh), k and v are (B, Sk, KV, Dh) with H % KV == 0, the result
is (B, Sq, H, Dh) in q's dtype, and a non-causal call whose Sk is ragged
against the key tile is refused (the reference asserts
``Sk % block_k == 0`` there; the port's key tile is :data:`KEY_TILE`).
The reference pads Sq and Sk to its blocks; the kernel masks them
instead.  A tensor on the CPU takes the plain version (:mod:`.ref`), and
a ``meta`` tensor its shapes (the dry run's); a
tensor on the card launches the kernel, built at first use, or raises:
its bf16 tensor-core instance or its float32-arithmetic one, as
:func:`select_instance` says.  On inputs that need a gradient the kernel
runs through :class:`~repro_torch.kernels.autograd.PlainGrad`, whose
backward is autograd of :func:`ref.attention_ref`.
q, k and v may be views with any batch and position strides; each
position's (heads, Dh) must be contiguous.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.build import Library, build_library
from ..autograd import PLAIN_DEVICES, with_plain_grad
from ..instances import InstanceCounts, tma_ready
from . import ref as attn_ref

CSRC = Path(__file__).resolve().parent / "csrc"
COMMON_CSRC = Path(__file__).resolve().parents[1] / "csrc"     # hopper.cuh
SOURCE = CSRC / "flash_attention.cu"

#: rows of the kernel's query and key tiles (``kTile`` in the source)
KEY_TILE = 64
#: the head dims the kernel is instantiated for (224: Zamba2-7B's shared
#: attention)
HEAD_DIMS = (8, 16, 32, 64, 128, 224)

#: the head dims of the bf16 tensor-core instance, and the key tile it
#: walks at each (``flash_tc::launch<Dh, kN>`` in the source)
TENSOR_CORE_KEY_TILE = {16: 128, 32: 128, 64: 128, 128: 64, 224: 64}
TENSOR_CORE_HEAD_DIMS = tuple(TENSOR_CORE_KEY_TILE)
#: the kernel's instances: bf16 on the tensor cores (wgmma, TMA-fed tiles)
#: and the float32-arithmetic instance on the CUDA cores (float32, and bf16
#: where the tensor-core instance does not apply)
INSTANCES = ("tensor_core", "cuda_core")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def select_instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The instance a call runs, from dtype, head dim and layout alone:
    ``tensor_core`` for bf16 with Dh in :data:`TENSOR_CORE_HEAD_DIMS` and
    operands a bulk tensor copy can read, else ``cuda_core``."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TENSOR_CORE_HEAD_DIMS
            and all(tma_ready(t) for t in (q, k, v))):
        return "tensor_core"
    return "cuda_core"


def check_contract(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> None:
    """The reference's shape contract, on either device."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected q (B, Sq, H, Dh) and k, v (B, Sk, KV, Dh)")
    B, _, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if not causal and Sk % min(KEY_TILE, max(Sk, 1)):
        raise ValueError(f"non-causal flash attention requires Sk ({Sk}) to be "
                         f"a multiple of the key tile {KEY_TILE}")


class FlashAttentionKernel(InstanceCounts):
    """The built kernel.  Calling it launches the instance that
    :func:`select_instance` picks on the current stream and adds one to
    ``launches`` and to that instance's count in ``instance_launches``;
    nothing else touches the counts."""

    symbol = "flash_attention"
    instances = INSTANCES

    def __init__(self, library: Library):
        super().__init__()
        self.library = library
        self._fn = library.lib.launch_flash_attention
        self._fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                             + [ctypes.c_float, ctypes.c_void_p])
        self._fn.restype = ctypes.c_int
        self._fn_tc = library.lib.launch_flash_attention_wgmma
        self._fn_tc.argtypes = ([ctypes.c_void_p] * 6
                                + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        self._fn_tc.restype = ctypes.c_int

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
        dev = q.device
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"q, k, v: expected one dtype, float32 or bfloat16; "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        check_contract(q, k, v, causal)
        B, Sq, H, Dh = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        if Dh not in HEAD_DIMS:
            raise ValueError(f"head dim {Dh}: the kernel takes {HEAD_DIMS}")
        if B * H > 65535:
            raise ValueError(f"batch x heads {B * H} exceeds the launch grid")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1 or t.stride(2) != Dh:
                raise ValueError(f"{name}: each position's (heads, Dh) must be "
                                 f"contiguous")
        out = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=dev)
        if out.numel() == 0:
            return out
        if Sk == 0:
            raise ValueError("attention over zero keys")
        if scale is not None and not scale > 0:
            raise ValueError(f"scale {scale}: expected a positive factor")
        strides = (ctypes.c_longlong * 6)(q.stride(0), q.stride(1), k.stride(0),
                                          k.stride(1), v.stride(0), v.stride(1))
        dims = (ctypes.c_int * 6)(B, Sq, Sk, H, KV, Dh)
        instance = select_instance(q, k, v)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, dims)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            # 0 asks the kernel for its own 1/sqrt(Dh), the default's bits
            factor = 0.0 if scale is None else scale
            if instance == "tensor_core":
                rc = self._fn_tc(*ptrs, int(causal), factor, stream)
            else:
                rc = self._fn(*ptrs, _DTYPE_CODE[q.dtype], int(causal), factor, stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention ({instance}): kernel launch "
                               f"failed (cudaError {rc})")
        self.count(instance)
        return out


_KERNEL: Optional[FlashAttentionKernel] = None


def build_kernel() -> FlashAttentionKernel:
    """Build (once, with one ``nvcc`` call) and return the kernel."""
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = FlashAttentionKernel(build_library(SOURCE.read_text(),
                                                        [CSRC, COMMON_CSRC]))
    return _KERNEL


def launch_counts():
    """Launches of the kernel since the last reset ({} before it is built)."""
    return {} if _KERNEL is None else {_KERNEL.symbol: _KERNEL.launches}


def instance_counts():
    """Launches per instance since the last reset, keyed
    ``flash_attention/<instance>`` ({} before the kernel is built)."""
    return {} if _KERNEL is None else _KERNEL.instance_counts()


def reset_launch_counts() -> None:
    if _KERNEL is not None:
        _KERNEL.reset()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); H % KV == 0.  ``scale``
    multiplies the scores, 1/sqrt(Dh) if None.  Returns (B, Sq, H, Dh) in
    q's dtype; on the card differentiable through the plain version."""
    if q.device.type in PLAIN_DEVICES:
        check_contract(q, k, v, causal)
        return attn_ref.attention_ref(q, k, v, causal=causal, scale=scale)
    kernel = build_kernel()
    return with_plain_grad("flash", lambda *a: kernel(*a, causal, scale),
                           lambda *a: attn_ref.attention_ref(*a, causal=causal, scale=scale),
                           q, k, v)
