"""Mixture-of-Experts FFN: the top-k router, the dense dispatch and the
sharded dispatch's schedule choice (mirrors ``src/repro/models/moe.py:43-131``).

``apply_moe_dense`` is the reference's semantics: exact top-k of the
softmax, renormalised, no capacity and no drops; every expert runs over
all tokens with the unchosen ones masked to zero, and the combine weighs
each expert's output by its gate weight.  That is E / k times the expert
work the chosen pairs need (4x for Granite's top-8 of 32).  The expert
products are plain batched matmuls, as the reference leaves its einsums
to XLA.  The sharded dispatch across cards (``apply_moe_sharded``) is
not ported yet; a config asking for it runs this one without a mesh, as
the reference does, and raises on a mesh of more than one device
(``models.lm._apply_ffn``).  ``choose_schedule``, which the sharding
rules read, is.

On a mesh the load-balancing loss is the reference's over the global
batch: the token counts per expert are summed over the batch shards, and
each rank's loss is its share, whose sum over the shards is the global
loss (:func:`aux_load_balance_loss`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import mesh_axes
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
                          n_experts: int, mesh=None) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e (mean router probability
    of e) * (share of tokens that chose e).  On a mesh both means are over
    the global batch: the shares come from counts summed over the batch
    shards, and the probabilities' sum over this rank's tokens is divided
    by the global token count, so the loss returned is this rank's share
    of the global one."""
    probs = torch.softmax(logits, dim=-1)
    chosen = torch.zeros((idx[..., 0].numel(), n_experts), dtype=torch.float32,
                         device=idx.device)
    chosen.scatter_(1, idx.reshape(-1, idx.shape[-1]), 1.0)
    if mesh is None:
        me = torch.mean(probs.reshape(-1, n_experts), dim=0)
        ce = torch.mean(chosen, dim=0)
        return n_experts * torch.sum(me * ce)
    from repro_torch.distributed.collectives import batch_sum
    counts = torch.cat([chosen.sum(dim=0), chosen.new_full((1,), chosen.shape[0])])
    counts = batch_sum(counts, mesh)
    n = counts[-1]
    me_share = torch.sum(probs.reshape(-1, n_experts), dim=0) / n
    return n_experts * torch.sum(me_share * (counts[:-1] / n))


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """x: (E, T, D) grouped tokens -> (E, T, D), a SwiGLU per expert."""
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
    return torch.bmm(h, w_down)


def apply_moe_dense(params: Params, x: torch.Tensor, top_k: int,
                    n_experts: int, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dispatch, no drops.  x: (B, S, D) -> (y, aux); on a mesh x is
    this rank's batch shard and aux its share (:func:`aux_load_balance_loss`)."""
    B, S, D = x.shape
    idx, w, logits = router_probs(params["router"], x, top_k)        # (B, S, k)
    combine = torch.zeros((B, S, n_experts), dtype=x.dtype, device=x.device)
    combine = combine.scatter(-1, idx, w)                             # (B, S, E)
    mask = (combine != 0).to(x.dtype)
    xe = x.reshape(1, B * S, D) * mask.reshape(B * S, n_experts).t()[..., None]
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xe)
    y = torch.einsum("etd,te->td", ye, combine.reshape(B * S, n_experts))
    return y.reshape(B, S, D), aux_load_balance_loss(logits, idx, n_experts, mesh)


# ---------------------------------------------------------------------------
# sharded (production) dispatch
# ---------------------------------------------------------------------------

def choose_schedule(n_experts: int, d_model: int, d_ff: int, mesh,
                    ep_axis: str = "data", tp_axis: str = "model",
                    budget_bytes: int = 64 * 2**20) -> str:
    """Pick the sharded dispatch's schedule.

    ``ep_tp`` (experts sharded over the tensor axis, full-width FFN, no
    token all-gather) wins when the per-device expert weights it implies
    -- total expert params / |tp|, replicated over the data axis -- fit a
    modest budget.  Small-expert models (granite: 6 MB/layer) qualify;
    kimi-k2 (2.1 GB/layer) must keep the 2D schedule.  When experts are
    narrower than d_model, ``2d_dshard`` dispatches D/tp slices and sums
    only the (tokens, F) hidden over the tensor axis."""
    tp = mesh_axes(mesh).get(tp_axis, 1)
    if n_experts % tp == 0:
        per_dev = 3 * n_experts * d_model * d_ff * 2 // tp
        if per_dev <= budget_bytes:
            return "ep_tp"
    if d_ff < d_model and d_model % tp == 0:
        return "2d_dshard"
    return "2d"
