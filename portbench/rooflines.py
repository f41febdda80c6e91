"""The card's peaks and the least time each kernel call could take.

A call's bound is max(bytes / HBM rate, work / peak of its input type):
each input byte read once, each output byte written once, and the
function's products, whatever implements it.  Every function takes shapes
and dtypes only, so the bound of a call does not depend on the program.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, card at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
#: the bf16 dense peak, the denominator of every ``mfu``
MFU_PEAK = PEAK_FLOPS["bfloat16"]
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ---------------------------------------------------------------------------
# conv1d: depthwise causal conv + SiLU, x (B, L, C), w (W, C), b (C,)
# ---------------------------------------------------------------------------

def conv1d_bytes(B: int, L: int, C: int, W: int, dtype: str) -> float:
    return ITEMSIZE[dtype] * (2 * B * L * C + W * C + C)


def conv1d_flops(B: int, L: int, C: int, W: int) -> float:
    return 2.0 * W * B * L * C


def conv1d_bound_s(B: int, L: int, C: int, W: int, dtype: str) -> float:
    return bound_s(conv1d_bytes(B, L, C, W, dtype), conv1d_flops(B, L, C, W), dtype)


# ---------------------------------------------------------------------------
# SSD: x (B, L, H, P), dt (B, L, H) f32, A (H,) f32, B/C (B, L, 1, N);
# y (B, L, H, P), final state (B, H, N, P) f32
# ---------------------------------------------------------------------------

def ssd_input_bytes(B: int, L: int, H: int, P: int, N: int, dtype: str) -> float:
    it = ITEMSIZE[dtype]
    return it * B * L * H * P + 4 * B * L * H + 4 * H + 2 * it * B * L * N


def ssd_bytes(B: int, L: int, H: int, P: int, N: int, dtype: str) -> float:
    return (ssd_input_bytes(B, L, H, P, N, dtype) + ITEMSIZE[dtype] * B * L * H * P
            + 4 * B * H * N * P)


def ssd_flops(B: int, L: int, H: int, P: int, N: int, chunk: int) -> float:
    """The products of the chunked dual form: C B^T within a chunk (shared
    by the heads), the masked product with x, the chunk states and their
    term in y."""
    per_chunk = 2.0 * chunk * chunk * N + H * (2.0 * chunk * chunk * P + 4.0 * chunk * N * P)
    return B * (L // chunk) * per_chunk


def ssd_bound_s(B: int, L: int, H: int, P: int, N: int, chunk: int, dtype: str) -> float:
    return bound_s(ssd_bytes(B, L, H, P, N, dtype), ssd_flops(B, L, H, P, N, chunk), dtype)


def ssd_bwd_bound_s(B: int, L: int, H: int, P: int, N: int, chunk: int, dtype: str) -> float:
    """The SSD's gradient: x, dt, A, B, C and dy read once, their gradients
    written once; each forward product gives two products back."""
    nbytes = 2 * ssd_input_bytes(B, L, H, P, N, dtype) + ITEMSIZE[dtype] * B * L * H * P
    return bound_s(nbytes, 2 * ssd_flops(B, L, H, P, N, chunk), dtype)
