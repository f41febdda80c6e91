"""IBM's Granite-4.0-H: Mamba-2 and attention layers, each followed by a
mixture of experts with a shared expert (the port's own model family; the
JAX package has none).

The equations are those of ``GraniteMoeHybridForCausalLM`` (the published
``modeling_granitemoehybrid.py``).  With m_e, m_r, m_a and s the
embedding, residual and attention multipliers and the logits' scaling,
x = m_e embed(tokens), and layer l of ``n_layers`` is

  x = x + m_r Mixer_l(RMSNorm_l(x))
  u = RMSNorm'_l(x)
  x = x + m_r (MoE_l(u) + Shared_l(u))

where Mixer_l is, as ``layer_types[l]`` says, a Mamba-2 mixer
(:class:`~repro_torch.models.mamba2.Mamba2` inside an
:class:`~repro_torch.models.lm.SSMBlock`) or grouped-query attention with
no position embedding and the scores scaled by m_a; MoE_l is the top
``moe_top_k`` of ``n_experts`` SwiGLU experts of ``d_ff`` (a softmax over
the k best router logits, which is the top k of the softmax renormalised)
and Shared_l a SwiGLU of ``shared_ff``.  The logits are
RMSNorm_f(x) E^T / s against the tied embedding E.  Every RMSNorm has eps
``cfg.norm_eps``.

Prefill runs the card's kernels: conv1d, the SSD and the mixer's tail in
every Mamba-2 layer, the flash-attention kernel in every attention layer;
the experts run the dropless dispatch (``moe.apply_moe_dropless``:
grouped products over the experts' row ranges on the card), or the dense
one with ``moe_impl="dense"``.  The cache holds the Mamba-2 layers'
conv and SSM states (slot j for the j-th Mamba-2 layer) and the
attention layers' k/v (slot j for the j-th attention layer); decode reads
and writes them in place.  Spans: ``granite.attention`` around an
attention layer's prefill, and inside :func:`moe_ffn` (a module global a
caller may wrap) ``granite.moe`` around the routed experts and
``granite.shared_mlp`` around the shared one.  One device only: no mesh.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.tracing import span
from . import attention as attn
from . import mlp as mlpm
from . import moe as moem
from .common import init_norm
from .lm import Block, SSMModel, _attn_cfg, _device, _fill_kv, _generator, _norm, _slots

KINDS = ("mamba", "attention")


def moe_ffn(ffn: Block, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One layer's feed-forward over x (..., D), without the residual: its
    norm, then the routed experts plus the shared expert.  The norm and the final sum run outside the two spans,
    so that a caller's device range spans the whole feed-forward."""
    D = x.shape[-1]
    T = x.numel() // D
    u = _norm(ffn.ln, x, cfg)
    with span("granite.moe", T=T, E=cfg.n_experts, k=cfg.moe_top_k, F=cfg.d_ff):
        if cfg.moe_impl == "dense":
            y = moem.apply_moe_dense(ffn.moe, u.reshape(1, T, D), cfg.moe_top_k,
                                     cfg.n_experts)[0].view(u.shape)
        else:
            y = moem.apply_moe_dropless(ffn.moe, u, cfg.moe_top_k, cfg.n_experts,
                                        with_aux=False)[0]
    with span("granite.shared_mlp", M=T, K=D, N=cfg.shared_ff):
        s = mlpm.apply_mlp(ffn.shared, u, "swiglu")
    return y + s


class GraniteHybridModel(SSMModel):
    """Embedding, the Mamba-2 layers' :class:`SSMBlock` (``blocks``, in
    layer order), the attention layers (``attn``: ``ln`` and ``attn``), one
    feed-forward per layer (``ffn``: ``ln``, ``moe`` and ``shared``) and a
    final norm; the unembedding is the tied embedding."""

    def __init__(self, cfg: ModelConfig, device: str = "cuda",
                 generator: Optional[torch.Generator] = None, mesh=None):
        if mesh is not None:
            raise ValueError("the granite_hybrid family runs on one device; got a mesh")
        if len(cfg.layer_types) != cfg.n_layers or not set(cfg.layer_types) <= set(KINDS):
            raise ValueError(f"layer_types must name {cfg.n_layers} mixers of {KINDS}; "
                             f"got {cfg.layer_types}")
        if not (cfg.n_experts and cfg.moe_top_k and cfg.shared_ff):
            raise ValueError("every granite_hybrid layer has routed experts and a shared one")
        gen = _generator(_device(device), generator)
        super().__init__(cfg, device=device, generator=gen)
        dev, d = gen.device, cfg.d_model
        self.attn = nn.ModuleList([
            Block({"ln": init_norm(d, cfg.norm, self.dtype, dev),
                   "attn": attn.init_attention(gen, _attn_cfg(cfg), self.dtype)})
            for _ in range(cfg.layer_types.count("attention"))])
        self.ffn = nn.ModuleList([
            Block({"ln": init_norm(d, cfg.norm, self.dtype, dev),
                   "moe": moem.init_moe(gen, d, cfg.d_ff, cfg.n_experts, cfg.moe_top_k,
                                        self.dtype),
                   "shared": mlpm.init_mlp(gen, d, cfg.shared_ff, "swiglu", self.dtype)})
            for _ in range(cfg.n_layers)])
        #: layer -> (its mixer's kind, its index among the layers of that kind)
        self.slot: List[Tuple[str, int]] = [
            (kind, cfg.layer_types[:i].count(kind)) for i, kind in enumerate(cfg.layer_types)]

    def _n_blocks(self) -> int:
        return self.cfg.layer_types.count("mamba")

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return super()._logits(h) / self.cfg.logits_scaling

    def _attention(self, j: int, x: torch.Tensor, cache) -> torch.Tensor:
        """Attention layer j with its residual.  With a cache, a prompt x
        (B, S, d) writes its k/v into slot j, one token x (B, d) at ``pos``."""
        blk, cfg = self.attn[j], self.cfg
        h = _norm(blk.ln, x, cfg)
        if x.dim() == 2:
            kv = (cache["attn_k"][j], cache["attn_v"][j])
            a = attn.decode_attention(blk.attn, h[:, None], kv, cache["pos"], _attn_cfg(cfg),
                                      scale=cfg.attention_multiplier or None)[0][:, 0]
        else:
            B, S, _ = x.shape
            with span("granite.attention", B=B, S=S, H=cfg.n_heads, KV=cfg.n_kv_heads,
                      Dh=cfg.head_dim):
                a, kv = attn.prefill_attention(blk.attn, h, _attn_cfg(cfg),
                                               scale=cfg.attention_multiplier or None)
            if cache is not None:
                _fill_kv(cache, j, kv)
        return torch.add(x, a, alpha=cfg.residual_multiplier)

    def _layer(self, i: int, x: torch.Tensor, cache) -> torch.Tensor:
        """Layer i: its mixer, then its feed-forward, each with its residual."""
        kind, j = self.slot[i]
        if kind == "mamba":
            x = self._mamba(j, x, None, None, _slots(cache, j))
        else:
            x = self._attention(j, x, cache)
        return torch.add(x, moe_ffn(self.ffn[i], x, self.cfg), alpha=self.cfg.residual_multiplier)

    def _layers(self, x: torch.Tensor, cache: Optional[Dict[str, Any]] = None,
                gb: Optional[int] = None) -> torch.Tensor:
        x = x * self.cfg.embedding_multiplier
        for i in range(self.cfg.n_layers):
            x = self._remat(self._layer, i, x, cache)
        return x

    def _kv_shape(self, batch_size: int, seq_len: int) -> tuple:
        cfg = self.cfg
        return (cfg.layer_types.count("attention"), batch_size, seq_len, cfg.n_kv_heads,
                cfg.head_dim)
