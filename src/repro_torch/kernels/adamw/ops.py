"""Public entry point for the CUDA AdamW update over many tensors.

:class:`AdamWKernel` takes a list of ``(g, p, m, v, decay)`` tensors on the
card: each gradient and parameter in float32 or bfloat16, each moment in
float32, all of one shape per tensor and contiguous.  It clips the whole
gradient by its global norm and applies :func:`ref.adamw_tensor` to every
tensor, in three launches (norm, finalize, update; four on a mesh, whose
per-tensor sums are all-reduced between two finalize launches), and
returns the norm as a float32 tensor of one element on the card.  Nothing
waits on the host.  :func:`repro_torch.train.optim.adamw_update` calls it
for parameters on the card and runs the plain version (:mod:`.ref`) on
the CPU and ``meta``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.build import Library, build_library
from repro_torch.tracing import count

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"

#: elements a chunk, CTA threads and int64 fields of a table row
#: (``kChunk``, ``kThreads``, ``kFields`` in ``adamw.cu``)
CHUNK, THREADS, FIELDS = 16384, 256, 8
#: a row's flags (``Flags`` in ``adamw.cu``)
GRAD_BF16, PARAM_BF16, DECAY = 1, 2, 4

_DTYPES = (torch.float32, torch.bfloat16)

Entry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, bool]


def check_operands(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor) -> None:
    """Raises ``TypeError`` or ``ValueError`` on one tensor's operands that
    the kernel does not take; needs no device.  The kernel takes g and p in
    float32 or bfloat16, m and v in float32, the four on one device, of one
    shape and contiguous.  Written without loops: it runs for every tensor
    of every step."""
    if g.dtype not in _DTYPES or p.dtype not in _DTYPES:
        raise TypeError(f"gradient and parameter: expected float32 or bfloat16, got "
                        f"{g.dtype} and {p.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"moments: expected float32, got {m.dtype} and {v.dtype}")
    dev, shape = p.device, p.shape
    if g.device != dev or m.device != dev or v.device != dev:
        raise ValueError(f"expected one device, got g {g.device}, p {p.device}, "
                         f"m {m.device}, v {v.device}")
    if g.shape != shape or m.shape != shape or v.shape != shape:
        raise ValueError(f"shapes g {tuple(g.shape)}, p {tuple(p.shape)}, m "
                         f"{tuple(m.shape)}, v {tuple(v.shape)} do not agree")
    if not (g.is_contiguous() and p.is_contiguous() and m.is_contiguous()
            and v.is_contiguous()):
        name, t = next((n, t) for n, t in (("g", g), ("p", p), ("m", m), ("v", v))
                       if not t.is_contiguous())
        raise ValueError(f"{name}: expected a contiguous tensor, strides {t.stride()}")


def work_table(entries: Sequence[Entry]) -> Tuple[List[List[int]], int]:
    """The kernel's table, a row of :data:`FIELDS` integers a tensor (the
    pointers of g, p, m and v, its length, its first chunk, its flags, 0),
    and the chunks of all the tensors; each tensor's operands checked
    (:func:`check_operands`)."""
    rows, total = [], 0
    for g, p, m, v, decay in entries:
        check_operands(g, p, m, v)
        n = p.numel()
        rows.append([g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), n, total,
                     (GRAD_BF16 if g.dtype == torch.bfloat16 else 0)
                     | (PARAM_BF16 if p.dtype == torch.bfloat16 else 0)
                     | (DECAY if decay else 0), 0])
        total += -(-n // CHUNK)
    return rows, total


class AdamWKernel:
    """The built kernels.  Calling it checks its operands, launches on the
    current stream and adds one to ``launches`` a launch."""

    symbol = "adamw"

    def __init__(self, library: Library):
        self.library = library
        self.launches = 0
        lib = library.lib
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        self._norm = lib.launch_adamw_norm
        self._norm.argtypes = [ptr, i32, i64, ptr, ptr]
        self._finalize = lib.launch_adamw_finalize
        self._finalize.argtypes = [ptr, i32, i64, ptr, ptr, ptr, f32, i32, ptr]
        self._update = lib.launch_adamw_update
        self._update.argtypes = [ptr, i32, i64] + [ptr] * 4 + [f32] * 6 + [ptr]
        for fn in (self._norm, self._finalize, self._update):
            fn.restype = ctypes.c_int

    def _launched(self, what: str, rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"adamw: {what} launch failed (cudaError {rc})")
        self.launches += 1
        count("adamw.kernel")

    def __call__(self, entries: Sequence[Entry], cfg, lr: torch.Tensor, b1c: torch.Tensor,
                 b2c: torch.Tensor,
                 sum_shards: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> torch.Tensor:
        """AdamW over ``entries`` with ``cfg``'s ``b1``, ``b2``, ``eps``,
        ``weight_decay`` and ``clip_norm``, the step's ``lr`` and bias
        corrections (float32, one element each, on the card).
        ``sum_shards``, on a mesh, adds each tensor's sum of squares over
        the ranks that split it.  Returns the gradient's norm before
        clipping."""
        if not entries:
            raise ValueError("adamw: no tensors")
        dev = entries[0][1].device
        if dev.type != "cuda" or any(e[1].device != dev for e in entries):
            raise ValueError(f"expected every tensor on one card, got "
                             f"{sorted({str(e[1].device) for e in entries})}")
        for name, t in (("lr", lr), ("b1c", b1c), ("b2c", b2c)):
            if t.dtype != torch.float32 or t.numel() != 1 or t.device != dev:
                raise ValueError(f"{name}: expected one float32 on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        rows, chunks = work_table(entries)
        T = len(rows)
        f32 = dict(dtype=torch.float32, device=dev)
        table = torch.tensor(rows, dtype=torch.int64, pin_memory=True).to(dev, non_blocking=True)
        partials = torch.empty(max(chunks, 1), **f32)
        sums = torch.empty(T, **f32)
        out = torch.empty(2, **f32)            # gnorm, scale
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if chunks:
                self._launched("norm", self._norm(table.data_ptr(), T, chunks,
                                                  partials.data_ptr(), stream))
            for mode in ((1, 2) if sum_shards is not None else (3,)):
                if mode == 2:
                    sums = sum_shards(sums)
                self._launched("finalize", self._finalize(
                    table.data_ptr(), T, chunks, partials.data_ptr(), sums.data_ptr(),
                    out.data_ptr(), cfg.clip_norm, mode, stream))
            if chunks:
                self._launched("update", self._update(
                    table.data_ptr(), T, chunks, out[1].data_ptr(), lr.data_ptr(),
                    b1c.data_ptr(), b2c.data_ptr(), cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2,
                    cfg.eps, cfg.weight_decay, stream))
        return out[0]


_KERNEL: Optional[AdamWKernel] = None


def build_kernel() -> AdamWKernel:
    """Build (once, with one ``nvcc`` call) and return the kernel."""
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = AdamWKernel(build_library(SOURCE.read_text(), []))
    return _KERNEL


def launch_counts() -> Dict[str, int]:
    """Launches since the last reset (empty before the kernel is built)."""
    return {} if _KERNEL is None else {_KERNEL.symbol: _KERNEL.launches}


def reset_launch_counts() -> None:
    if _KERNEL is not None:
        _KERNEL.launches = 0
