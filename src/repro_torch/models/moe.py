"""Mixture-of-Experts FFN: the top-k router and the dense dispatch
(mirrors ``src/repro/models/moe.py:43-103``).

``apply_moe_dense`` is the reference's semantics: exact top-k of the
softmax, renormalised, no capacity and no drops; every expert runs over
all tokens with the unchosen ones masked to zero, and the combine weighs
each expert's output by its gate weight.  That is E / k times the expert
work the chosen pairs need (4x for Granite's top-8 of 32).  The expert
products are plain batched matmuls, as the reference leaves its einsums
to XLA.  The sharded dispatch across cards (``apply_moe_sharded``) is
not ported; a config asking for it runs this one, as the reference does
without a mesh.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .common import Params, dense_init


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             top_k: int, dtype: torch.dtype = torch.float32) -> Params:
    """The router is float32 whatever ``dtype`` is, as in the reference."""
    return {
        "router": dense_init(gen, (d_model, n_experts), dtype=torch.float32),
        "w_gate": dense_init(gen, (n_experts, d_model, d_ff), in_axis=1, dtype=dtype),
        "w_up": dense_init(gen, (n_experts, d_model, d_ff), in_axis=1, dtype=dtype),
        "w_down": dense_init(gen, (n_experts, d_ff, d_model), in_axis=1, dtype=dtype),
    }


def router_probs(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (..., D).  Returns (indices (..., k), weights (..., k) in x's
    dtype, float32 logits (..., E)): the top k of the softmax, then
    renormalised over those k."""
    logits = torch.matmul(x.float(), router.float())
    weights, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return idx, weights.to(x.dtype), logits


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e (mean router probability
    of e) * (share of tokens that chose e)."""
    probs = torch.softmax(logits, dim=-1)
    me = torch.mean(probs.reshape(-1, n_experts), dim=0)
    chosen = torch.zeros((idx[..., 0].numel(), n_experts), dtype=torch.float32,
                         device=idx.device)
    chosen.scatter_(1, idx.reshape(-1, idx.shape[-1]), 1.0)
    ce = torch.mean(chosen, dim=0)
    return n_experts * torch.sum(me * ce)


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """x: (E, T, D) grouped tokens -> (E, T, D), a SwiGLU per expert."""
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
    return torch.bmm(h, w_down)


def apply_moe_dense(params: Params, x: torch.Tensor, top_k: int,
                    n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dispatch, no drops.  x: (B, S, D) -> (y, aux)."""
    B, S, D = x.shape
    idx, w, logits = router_probs(params["router"], x, top_k)        # (B, S, k)
    combine = torch.zeros((B, S, n_experts), dtype=x.dtype, device=x.device)
    combine = combine.scatter(-1, idx, w)                             # (B, S, E)
    mask = (combine != 0).to(x.dtype)
    xe = x.reshape(1, B * S, D) * mask.reshape(B * S, n_experts).t()[..., None]
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xe)
    y = torch.einsum("etd,te->td", ye, combine.reshape(B * S, n_experts))
    return y.reshape(B, S, D), aux_load_balance_loss(logits, idx, n_experts)
