"""Plain PyTorch reference of Granite-4.0-H (Granite-4.0-H-Small's equations).

Written from the published description (the equations of
``GraniteMoeHybridForCausalLM`` in ``transformers``'
``modeling_granitemoehybrid.py``), not from the program: it imports
nothing of the program and reads only the parameters the benchmark drew
(``portbench.granite.draw``), keyed by name.  With m_e, m_r and m_a the
embedding, residual and attention multipliers and s the logits' scaling,
x = m_e embed(tokens), each layer l adds
m_r Mixer_l(RMSNorm_l(x)) and then m_r (MoE_l(u) + Shared_l(u)) with
u = RMSNorm'_l(x), and the logits are RMSNorm_f(x) E^T / s.

Every product runs in float32 with TF32 off (:func:`exact`).  The
parameters may be held as drawn (bf16): each layer's are taken to float32
as the layer runs, so the whole model's float32 copy is never held.  The
Mamba-2 mixer is ``reference/zamba2.py``'s (Listing 1 of
arXiv:2405.21060; with one B/C group its gated RMSNorm runs over all of
d_inner, as ``GraniteMoeHybridRMSNormGated`` does); attention runs in
blocks of query rows, each query head reading KV head h // (H / KV); the
experts run one at a time over the rows routed to them, a token's gates
the softmax of its k largest router logits.

Departures from the published code: none in the equations.  The
published Mamba-2 layer clamps dt to ``time_step_limit`` (0, inf), which
a softplus never leaves, so no clamp is written here.

Stand-ins for the limits of the check (``precision``): ``fp8`` rounds
every product's operands to float8 e4m3 (one scale per operand, its
largest magnitude mapped to 448); ``top8`` routes each token to its 8
best experts, their gates the softmax over those 8 logits; ``no_shared``
leaves the shared expert out; ``rope`` rotates q and k by RoPE with
theta 1e4 (``rotate_half``'s layout), as a ``position_embedding_type``
"rope" Granite would; ``scale_dh`` scales the scores by Dh^-1/2 in place
of ``attention_multiplier``.  ``bf16`` rounds every product's operands
to bfloat16 and is no fault: it reads what rounding alone gives a bf16
program.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from . import zamba2 as zref
from .model import exact  # noqa: F401  (the kind's)

Params = Mapping[str, torch.Tensor]

PRECISIONS = ("f32", "fp8", "top8", "no_shared", "rope", "scale_dh", "bf16")
#: experts a token reads under ``top8``
TOP8 = 8
#: RoPE's base under ``rope``
ROPE_THETA = 1e4


def _mm(precision: str) -> str:
    """The rounding a stand-in gives the products."""
    return precision if precision in ("fp8", "bf16") else "f32"


def layer(p: Params, prefix: str) -> Dict[str, torch.Tensor]:
    """The parameters under ``prefix``, the prefix dropped, in float32."""
    return {k[len(prefix):]: v.float() for k, v in p.items() if k.startswith(prefix)}


def rmsnorm(x: torch.Tensor, w, eps: float) -> torch.Tensor:
    return zref.rmsnorm(x, w, eps)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def attention(lp: Params, x: torch.Tensor, cfg: Mapping, precision: str) -> torch.Tensor:
    """``GraniteMoeHybridAttention`` over x (b, s, d), its norm applied:
    q, k, v projections, no position embedding (but under ``rope``), the
    causal softmax of q k^T m_a, the output projection."""
    mm = _mm(precision)
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    q = zref.prod("bsd,dhk->bshk", x, lp["wq"], precision=mm)
    k = zref.prod("bsd,dhk->bshk", x, lp["wk"], precision=mm)
    v = zref.prod("bsd,dhk->bshk", x, lp["wv"], precision=mm)
    if precision == "rope":
        pos = torch.arange(x.shape[1], device=x.device)
        q, k = zref.rope(q, pos, ROPE_THETA), zref.rope(k, pos, ROPE_THETA)
    k, v = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
    Dh = q.shape[-1]
    scale = Dh ** -0.5 if precision == "scale_dh" else cfg["attention_multiplier"]
    o = zref.attention(q, k, v, scale, mm)
    return zref.prod("bshk,hkd->bsd", o, lp["wo"], precision=mm)


def mixer(p: Params, kind: str, j: int, x: torch.Tensor, cfg: Mapping,
          precision: str) -> torch.Tensor:
    """The j-th layer of ``kind`` ("mamba" or "attention"): its pre-norm
    and mixer over x (b, s, d), without the residual."""
    if kind == "mamba":
        lp = layer(p, f"blocks.{j}.")
        return zref.mixer(lp, "mamba.", rmsnorm(x, lp["ln.scale"], cfg["norm_eps"]), cfg,
                          precision)
    lp = layer(p, f"attn.{j}.")
    return attention(layer(lp, "attn."), rmsnorm(x, lp["ln.scale"], cfg["norm_eps"]), cfg,
                     precision)


# ---------------------------------------------------------------------------
# the feed-forward: routed experts and the shared expert
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           precision: str) -> torch.Tensor:
    mm = _mm(precision)
    h = F.silu(zref.prod("td,df->tf", x, w_gate, precision=mm)) \
        * zref.prod("td,df->tf", x, w_up, precision=mm)
    return zref.prod("tf,fd->td", h, w_down, precision=mm)


def route(router: torch.Tensor, u: torch.Tensor, top_k: int, precision: str):
    """u (t, d) -> (experts (t, k), gates (t, k)): the k largest router
    logits of each token and their softmax (``GraniteMoeHybridTopKGating``)."""
    logits = zref.prod("td,de->te", u, router, precision=_mm(precision))
    k = TOP8 if precision == "top8" else top_k
    top, experts = logits.topk(k, dim=-1)
    return experts, torch.softmax(top, dim=-1)


def feed_forward(p: Params, i: int, x: torch.Tensor, cfg: Mapping,
                 precision: str) -> torch.Tensor:
    """Layer i's pre-norm, routed experts and shared expert over x
    (b, s, d), without the residual."""
    lp = layer(p, f"ffn.{i}.")
    u = rmsnorm(x, lp["ln.scale"], cfg["norm_eps"]).reshape(-1, x.shape[-1])
    experts, gates = route(lp["moe.router"], u, cfg["moe_top_k"], precision)
    y = torch.zeros_like(u)
    for e in range(cfg["n_experts"]):
        rows, slot = (experts == e).nonzero(as_tuple=True)
        if rows.numel():
            out = swiglu(u[rows], lp["moe.w_gate"][e], lp["moe.w_up"][e], lp["moe.w_down"][e],
                         precision)
            y.index_add_(0, rows, out * gates[rows, slot, None])
    if precision != "no_shared":
        y = y + swiglu(u, lp["shared.w_gate"], lp["shared.w_up"], lp["shared.w_down"],
                       precision)
    return y.reshape(x.shape)


# ---------------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------------

def hidden(p: Params, cfg: Mapping, tokens: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """tokens (b, s) -> final-norm hidden states (b, s, d), float32."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected {PRECISIONS}")
    m = cfg["residual_multiplier"]
    x = p["embed.table"][tokens.long()].float() * cfg["embedding_multiplier"]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"][:cfg["n_layers"]]):
        x = x + m * mixer(p, kind, seen[kind], x, cfg, precision)
        seen[kind] += 1
        x = x + m * feed_forward(p, i, x, cfg, precision)
    return rmsnorm(x, p["ln_f.scale"].float(), cfg["norm_eps"])


def logits(p: Params, cfg: Mapping, h: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(..., d) -> (..., vocab) against the tied embedding, over the
    logits' scaling."""
    out = zref.prod("...d,vd->...v", h, p["embed.table"][:cfg["vocab"]], precision=_mm(precision))
    return out / cfg["logits_scaling"]


def last_logits(p: Params, cfg: Mapping, tokens: torch.Tensor,
                precision: str = "f32") -> torch.Tensor:
    """Logits after the last position of each row: (b, vocab)."""
    return logits(p, cfg, hidden(p, cfg, tokens, precision)[:, -1], precision)
