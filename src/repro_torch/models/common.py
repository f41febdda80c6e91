"""Shared model components: norms, initializers and rotary position
embeddings (mirrors ``src/repro/models/common.py``).

The reference annotates every parameter with logical axis names for its
sharding layer; one card shards nothing, so parameters here are plain
tensors.  Initializers draw from an explicit ``torch.Generator`` on the
parameters' device; a build on the ``meta`` device, where no generator
can live, passes :class:`NoDraw` instead and draws nothing.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

class NoDraw:
    """The generator of a build on the ``meta`` device: :func:`randn` and
    :func:`rand` given it return meta tensors of the shape asked for, so
    the parameters have their shapes and dtypes and hold no memory."""
    device = torch.device("meta")


def randn(gen, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` on its device."""
    if isinstance(gen, NoDraw):
        return torch.empty(tuple(shape), device=gen.device)
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def rand(gen, shape: Sequence[int]) -> torch.Tensor:
    """Uniform [0, 1) float32 draws from ``gen`` on its device."""
    if isinstance(gen, NoDraw):
        return torch.empty(tuple(shape), device=gen.device)
    return torch.rand(tuple(shape), generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    std = shape[in_axis] ** -0.5
    return (randn(gen, shape) * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (randn(gen, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6,
            impl: str = "lean") -> torch.Tensor:
    """RMSNorm.  ``impl="lean"`` computes float32 statistics only and keeps
    every full-width tensor in the input dtype; ``impl="f32"`` upcasts."""
    if impl == "f32":
        dtype = x.dtype
        xf = x.float()
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + eps)
        if scale is not None:
            xf = xf * scale.float()
        return xf.to(dtype)
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = x * inv
    if scale is not None:
        out = out * scale.to(x.dtype)
    return out


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5,
              impl: str = "lean") -> torch.Tensor:
    """LayerNorm (see :func:`rmsnorm` for the lean/f32 distinction)."""
    if impl == "f32":
        dtype = x.dtype
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if scale is not None:
            xf = xf * scale.float()
        if bias is not None:
            xf = xf + bias.float()
        return xf.to(dtype)
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = (x - mu.to(x.dtype)) * inv
    if scale is not None:
        out = out * scale.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def init_norm(d: int, kind: str, dtype: torch.dtype,
              device: torch.device) -> Params:
    """kind: rmsnorm | layernorm | nonparametric (OLMo-1b)."""
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)


def apply_norm(params: Mapping[str, torch.Tensor], x: torch.Tensor, kind: str,
               impl: str = "lean", eps: float = 1e-6) -> torch.Tensor:
    """``eps`` is the RMSNorm's; a LayerNorm keeps 1e-5."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps, impl)
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"], impl=impl)
    if kind == "nonparametric":
        return layernorm(x, None, None, impl=impl)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 1e4,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two halves of the head dim in float32 and returns x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
