"""Zyphra's Zamba2: Mamba-2 mixers with shared attention blocks (the
port's own model family; the JAX package has none).

The equations are those of ``Zamba2ForCausalLM`` (arXiv:2411.15242, and
the published ``modeling_zamba2.py``).  With e the embedding and x = e,
layer l of ``n_layers`` is, when it is the j-th of ``hybrid_layer_ids``
(shared block b = j mod ``n_shared_blocks``),

  u = RMSNorm_b,in([x, e])                       (2 d_model wide)
  q, k, v = u W_b,q, u W_b,k, u W_b,v            (heads of attn_width / n_heads)
  q, k = rope(q), rope(k)                         (over the whole head)
  a = RMSNorm_b,ff(softmax(q k^T (Dh / 2)^-1/2, causal) v W_b,o)
  g | up = a W_b,gu + (a A_j) B_j                 (A_j, B_j: the adapter of j)
  t = ((GELU(g) * up) W_b,down) Lin_j             (GELU exact, with erf)
  x = x + Mamba_l(RMSNorm_l(x + t))

and otherwise x = x + Mamba_l(RMSNorm_l(x)); the logits are RMSNorm_f(x)
against the tied embedding.  Every RMSNorm has eps ``cfg.norm_eps``.
Mamba_l is :class:`~repro_torch.models.mamba2.Mamba2` with ``ssm_groups``
B/C groups and its gated norm taken per group.

Prefill runs the card's kernels: conv1d and the SSD in every mixer, the
flash-attention kernel at the 224-wide heads of Zamba2-7B with the scale
above, once per application.  Decode is plain PyTorch, as for the other
families; each application keeps its own K/V cache, written at ``pos``.
Spans: ``zamba2.shared`` around each application (:func:`shared`, a
module global a caller may wrap), and inside it ``zamba2.attention``
around :func:`flash_attention` and ``zamba2.mlp`` around
:func:`gated_mlp`.  One device only: no mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.tracing import span
from .common import apply_rope, dense_init, rmsnorm
from .lm import SSMModel, _device, _fill_kv, _generator, _slots


def attn_head_dim(cfg: ModelConfig) -> int:
    return cfg.attn_width // cfg.n_heads


def attn_scale(cfg: ModelConfig) -> float:
    """The shared attention's score scale, (Dh / 2)^-1/2 (``Zamba2Attention.scaling``)."""
    return (attn_head_dim(cfg) / 2) ** -0.5


class SharedBlock(nn.Module):
    """One shared block's weights, the same for each of its applications."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype):
        super().__init__()
        d, A, ff = cfg.d_model, cfg.attn_width, cfg.d_ff
        ones = lambda n: nn.Parameter(torch.ones(n, dtype=dtype, device=gen.device))  # noqa: E731
        self.ln_in = ones(2 * d)
        self.w_qkv = nn.Parameter(dense_init(gen, (2 * d, 3 * A), dtype=dtype))
        self.w_o = nn.Parameter(dense_init(gen, (A, d), dtype=dtype))
        self.ln_ff = ones(d)
        self.w_gate_up = nn.Parameter(dense_init(gen, (d, 2 * ff), dtype=dtype))
        self.w_down = nn.Parameter(dense_init(gen, (ff, d), dtype=dtype))


class Application(nn.Module):
    """What one application of a shared block has of its own: the MLP
    adapter (``adapter_a`` d x r, ``adapter_b`` r x 2 d_ff) and the linear
    (d x d) between the block and the mixer."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype):
        super().__init__()
        d, r = cfg.d_model, cfg.adapter_rank
        self.adapter_a = nn.Parameter(dense_init(gen, (d, r), dtype=dtype))
        self.adapter_b = nn.Parameter(dense_init(gen, (r, 2 * cfg.d_ff), dtype=dtype))
        self.linear = nn.Parameter(dense_init(gen, (d, d), dtype=dtype))


def gated_mlp(blk: SharedBlock, app: Application, a: torch.Tensor) -> torch.Tensor:
    """(GELU(g) * up) W_down with g | up = a W_gu + (a A_j) B_j; exact GELU."""
    gu = torch.matmul(a, blk.w_gate_up) + torch.matmul(torch.matmul(a, app.adapter_a),
                                                       app.adapter_b)
    g, up = gu.chunk(2, dim=-1)
    return torch.matmul(F.gelu(g) * up, blk.w_down)


def _qkv(blk: SharedBlock, x: torch.Tensor, e: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig):
    """q, k (rope applied) and v of [x, e]: (B, S, H, Dh) each."""
    u = rmsnorm(torch.cat([x, e], dim=-1), blk.ln_in, cfg.norm_eps, cfg.norm_impl)
    qkv = torch.matmul(u, blk.w_qkv).unflatten(-1, (3, cfg.n_heads, attn_head_dim(cfg)))
    q, k, v = qkv.unbind(-3)
    return (apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta),
            v)


def _finish(blk: SharedBlock, app: Application, o: torch.Tensor, cfg: ModelConfig):
    """The attention's output heads (..., H, Dh) -> t, the block's term."""
    a = rmsnorm(torch.matmul(o.flatten(-2), blk.w_o), blk.ln_ff, cfg.norm_eps, cfg.norm_impl)
    M, K = a.numel() // a.shape[-1], a.shape[-1]
    with span("zamba2.mlp", M=M, K=K, N=blk.w_gate_up.shape[1], rank=app.adapter_a.shape[1]):
        t = gated_mlp(blk, app, a)
    return torch.matmul(t, app.linear)


def shared(blk: SharedBlock, app: Application, x: torch.Tensor, e: torch.Tensor,
           cfg: ModelConfig) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One application over the full sequence: x, e (B, S, d) -> (t, (k, v)),
    t (B, S, d) the term the mixer's input gains and k, v its cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(blk, x, e, positions, cfg)
    with span("zamba2.attention", B=B, S=S, H=q.shape[2], Dh=q.shape[3], dtype=q.dtype):
        o = flash_attention(q, k, v, causal=True, scale=attn_scale(cfg))
    return _finish(blk, app, o, cfg), (k, v)


def shared_decode(blk: SharedBlock, app: Application, x: torch.Tensor, e: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """One application for one token: x, e (B, d); the cache ck, cv
    (B, S, H, Dh) is written at ``pos`` (B,) in place and read up to it."""
    B, S = ck.shape[:2]
    q, k, v = _qkv(blk, x[:, None], e[:, None], pos[:, None], cfg)
    rows, pos = torch.arange(B, device=x.device), pos.long()
    ck[rows, pos] = k[:, 0]
    cv[rows, pos] = v[:, 0]
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), ck.float()) * attn_scale(cfg)
    valid = torch.arange(S, device=x.device)[None] <= pos[:, None]         # (B, S)
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, dim=-1), cv.float()).to(x.dtype)
    return _finish(blk, app, o, cfg)


class Zamba2Model(SSMModel):
    """Embedding, ``n_layers`` Mamba-2 blocks (``blocks``), the shared
    blocks (``shared``) and one :class:`Application` for each hybrid layer
    (``apps``), a final norm; the unembedding is the tied embedding."""

    def __init__(self, cfg: ModelConfig, device: str = "cuda",
                 generator: Optional[torch.Generator] = None, mesh=None):
        if mesh is not None:
            raise ValueError("the zamba2 family runs on one device; got a mesh")
        if len(cfg.hybrid_layer_ids) and not cfg.n_shared_blocks:
            raise ValueError("hybrid layers need at least one shared block")
        if cfg.attn_width % cfg.n_heads or cfg.n_kv_heads != cfg.n_heads:
            raise ValueError("the shared attention has n_heads heads of attn_width / "
                             "n_heads, one kv head each")
        gen = _generator(_device(device), generator)
        super().__init__(cfg, device=device, generator=gen)
        self.shared = nn.ModuleList([SharedBlock(cfg, gen, self.dtype)
                                     for _ in range(cfg.n_shared_blocks)])
        self.apps = nn.ModuleList([Application(cfg, gen, self.dtype)
                                   for _ in cfg.hybrid_layer_ids])
        #: layer -> its application's index
        self.app_of = {l: j for j, l in enumerate(cfg.hybrid_layer_ids)}

    def _shared_parts(self, i: int):
        """Hybrid layer i's shared block, application and their indices."""
        j = self.app_of[i]
        b = j % len(self.shared)
        return self.shared[b], self.apps[j], b, j

    def _layer(self, i: int, x: torch.Tensor, e: torch.Tensor, cache) -> torch.Tensor:
        """Layer i: its application of a shared block, if it has one, whose
        term t the block's norm reads, then its block.  With a cache, a
        prompt x (B, S, d) writes the application's k/v into its slot, one
        token x (B, d) at ``pos`` (:meth:`SSMModel._layers`)."""
        t = None
        if i in self.app_of:
            blk, app, b, j = self._shared_parts(i)
            with span("zamba2.shared", layer=i, block=b, application=j):
                if x.dim() == 2:
                    t = shared_decode(blk, app, x, e, cache["attn_k"][j], cache["attn_v"][j],
                                      cache["pos"], self.cfg)
                else:
                    t, kv = shared(blk, app, x, e, self.cfg)
            if cache is not None and x.dim() == 3:
                _fill_kv(cache, j, kv)
        return self._mamba(i, x, t=t, states=_slots(cache, i))

    def _layers(self, x: torch.Tensor, cache: Optional[Dict[str, Any]] = None,
                gb: Optional[int] = None) -> torch.Tensor:
        e = x
        for i in range(self.cfg.n_layers):
            x = self._remat(self._layer, i, x, e, cache)
        return x

    def _kv_shape(self, batch_size: int, seq_len: int) -> tuple:
        cfg = self.cfg
        return (len(cfg.hybrid_layer_ids), batch_size, seq_len, cfg.n_heads, attn_head_dim(cfg))
