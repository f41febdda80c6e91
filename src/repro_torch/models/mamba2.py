"""Mamba-2 (SSD, state-space duality) block (mirrors
``src/repro/models/mamba2.py``).

The chunked SSD algorithm of Dao & Gu (arXiv:2405.21060) for the full
sequence, and an O(1) recurrent ``decode_step``.  Where the reference
calls the jnp oracles of its Pallas kernels (``causal_conv1d_ref`` and
``ssd_chunked``), ``Mamba2.forward`` calls the port's kernels: on a CUDA
tensor the hand-written CUDA conv1d (its ``shuffle`` mode, the paper's
technique) and SSD scan, on a CPU tensor their plain PyTorch versions.
The conv reads its input, xin|B|C, in place as the in-projection's
column range, where the reference concatenates the three; the conv state
kept for decode is a copy of that range's last W - 1 rows.  Decode is
plain PyTorch, as it is plain jnp in the reference.  The projections are
``torch.matmul``.  The mixer's tail (the D skip, the SiLU gate and the
grouped RMSNorm) is ``kernels.gated_norm.gated_norm_tail``: one CUDA
kernel on the card, on the CPU the plain expression.  On the card a
loss carries its gradient through the three kernels to the
in-projection, ``conv_w``, ``a_log`` and ``dt_bias``: the SSD's bf16
tensor-core instance with one B/C group has a gradient kernel of its
own (``kernels/ssd/ops.py::SSDFunction``); conv1d, the tail and every
other SSD call differentiate through their plain versions
(``PlainGrad``, ``kernels/autograd.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.conv1d import causal_conv1d
from repro_torch.kernels.gated_norm import gated_norm_tail
from repro_torch.kernels.gated_norm.ref import gated_norm
from repro_torch.kernels.ssd import ssd
from repro_torch.tracing import span
from .common import Params, dense_init, rand


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    dt_min: float = 1e-3
    dt_max: float = 1e-1
    norm_eps: float = 1e-6         # the gated RMSNorm's epsilon

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def init_mamba2(gen: torch.Generator, cfg: SSMConfig,
                dtype: torch.dtype = torch.float32) -> Params:
    """Parameters drawn from ``gen`` on its device, with the reference's
    distributions (the numbers differ: a torch generator is not a JAX key)."""
    d, di, ng, ns = cfg.d_model, cfg.d_inner, cfg.n_groups, cfg.d_state
    H = cfg.n_heads
    dev = gen.device
    d_in_proj = 2 * di + 2 * ng * ns + H     # z, x, B, C, dt
    dt = torch.exp(rand(gen, (H,))
                   * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                   + math.log(cfg.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))   # inverse softplus
    return {
        "w_in": dense_init(gen, (d, d_in_proj), dtype=dtype),
        "conv_w": dense_init(gen, (cfg.conv_width, cfg.conv_dim), dtype=dtype) * 0.5,
        "conv_b": torch.zeros(cfg.conv_dim, dtype=dtype, device=dev),
        "a_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev)),
        "dt_bias": dt_bias.float(),
        "d_skip": torch.ones(H, dtype=torch.float32, device=dev),
        "norm_scale": torch.ones(di, dtype=dtype, device=dev),
        "w_out": dense_init(gen, (di, d), dtype=dtype),
    }


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor):
    """Decode: x_t (B, C); conv_state (B, W-1, C) last inputs."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)         # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window, w) + b
    return F.silu(y), window[:, 1:]


def conv_state_after(conv_in: torch.Tensor, W: int) -> torch.Tensor:
    """The decode conv state after a prefill: the last W - 1 rows of the
    conv input (B, L, C), zeros on the left only when L < W - 1; a copy
    of those rows alone, so the in-projection it views is not kept."""
    L = conv_in.shape[1]
    if L >= W - 1:
        return conv_in[:, L - (W - 1):].clone(memory_format=torch.contiguous_format)
    return F.pad(conv_in, (0, 0, W - 1 - L, 0))


def _split_proj(params: Params, x: torch.Tensor, cfg: SSMConfig):
    """(z, conv input, dt): views of the in-projection's columns; the conv
    input is xin|B|C, one contiguous column range."""
    di = cfg.d_inner
    proj = torch.matmul(x, params["w_in"])
    return torch.split(proj, [di, cfg.conv_dim, cfg.n_heads], dim=-1)


class Mamba2(nn.Module):
    """One Mamba-2 mixer; its parameters carry the reference's names and
    layouts (``w_in`` is (d_model, d_in_proj), as the reference's einsum
    reads it)."""

    def __init__(self, cfg: SSMConfig, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        for name, value in init_mamba2(gen, cfg, dtype).items():
            self.register_parameter(name, nn.Parameter(value))

    def _params(self) -> Params:
        return dict(self.named_parameters())

    def forward(self, x: torch.Tensor, return_state: bool = False):
        """Full-sequence forward.  x: (B, L, D)."""
        cfg, p = self.cfg, self._params()
        Bsz, L, D = x.shape
        H, P, ng, ns = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
        W, chunk = cfg.conv_width, min(cfg.chunk, L)
        with span("mamba2.in_proj", M=Bsz * L, K=D, N=p["w_in"].shape[1], dtype=x.dtype):
            z, conv_in, dt = _split_proj(p, x, cfg)       # views: read in place
        with span("mamba2.conv1d", B=Bsz, L=L, C=conv_in.shape[2], W=W, dtype=conv_in.dtype):
            conv_out = causal_conv1d(conv_in, p["conv_w"], p["conv_b"])
        xin, Bc, Cc = torch.split(conv_out, [cfg.d_inner, ng * ns, ng * ns], dim=-1)
        A = -torch.exp(p["a_log"])                               # (H,) negative
        dt = F.softplus(dt.float() + p["dt_bias"])
        xh = xin.reshape(Bsz, L, H, P)
        Bm = Bc.reshape(Bsz, L, ng, ns)
        Cm = Cc.reshape(Bsz, L, ng, ns)
        with span("mamba2.ssd", B=Bsz, L=L, H=H, P=P, N=ns, chunk=chunk, dtype=xh.dtype):
            y, s_final = ssd(xh, dt, A, Bm, Cm, chunk)
        with span("mamba2.gated_norm", B=Bsz, L=L, C=cfg.d_inner, G=ng, dtype=x.dtype):
            y = gated_norm_tail(y, xh, z, p["d_skip"], p["norm_scale"], ng,
                                cfg.norm_eps, x.dtype)
        with span("mamba2.out_proj", M=Bsz * L, K=y.shape[2], N=D, dtype=y.dtype):
            out = torch.matmul(y, p["w_out"]).to(x.dtype)
        if return_state:
            return out, (conv_state_after(conv_in, cfg.conv_width), s_final)
        return out

    def decode_step(self, x_t: torch.Tensor, state):
        """O(1) recurrent step.  x_t: (B, D); state = (conv_state, ssm_state)."""
        cfg, p = self.cfg, self._params()
        conv_state, ssm_state = state
        Bsz = x_t.shape[0]
        H, P, ng, ns = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
        z, conv_in, dt = _split_proj(p, x_t, cfg)                # (B, conv_dim)
        conv_out, conv_state = conv1d_step(conv_in, conv_state,
                                           p["conv_w"], p["conv_b"])
        xin, Bc, Cc = torch.split(conv_out, [cfg.d_inner, ng * ns, ng * ns], dim=-1)
        A = -torch.exp(p["a_log"])
        dt = F.softplus(dt.float() + p["dt_bias"])               # (B,H)
        xh = xin.reshape(Bsz, H, P).float()
        Bm = torch.repeat_interleave(Bc.reshape(Bsz, ng, ns), H // ng, dim=1)
        Cm = torch.repeat_interleave(Cc.reshape(Bsz, ng, ns), H // ng, dim=1)
        da = torch.exp(dt * A[None, :])                           # (B,H)
        ssm_state = (ssm_state * da[:, :, None, None]
                     + torch.einsum("bhn,bhp->bhnp", Bm.float(), xh * dt[..., None]))
        y = torch.einsum("bhn,bhnp->bhp", Cm.float(), ssm_state)
        y = y + p["d_skip"][None, :, None] * xh
        y = y.reshape(Bsz, cfg.d_inner).to(x_t.dtype)
        y = gated_norm(y, z, p["norm_scale"], ng, cfg.norm_eps)
        out = torch.matmul(y, p["w_out"]).to(x_t.dtype)
        return out, (conv_state, ssm_state)
