"""Plain PyTorch reference of Zamba2 (Zamba2-7B-Instruct's equations).

Written from the published description (arXiv:2411.15242; the equations
of ``Zamba2ForCausalLM`` in ``transformers``' ``modeling_zamba2.py``),
not from the program: it imports nothing of the program and reads only
the parameters the benchmark drew (``portbench.zamba2.draw``), keyed by
name.  Every product runs in float32 with TF32 off (:func:`exact`); the
SSD is Listing 1 of arXiv:2405.21060 with B and C in ``ssm_groups``
groups, head h reading group h // (H / G).  Attention runs in blocks of
query rows, so that 32,768 tokens fit in float32 beside the float32
weights.

One departure from the published code, which has two paths: its plain
fallback (``torch_forward``) clamps dt below at ``time_step_min``; its
kernel path, which a deployment on a GPU runs, passes
``time_step_limit`` = None, so no clamp.  This reference follows the
kernel path.

Stand-ins for the limits of the check (``precision``): ``fp8`` rounds
every product's operands to float8 e4m3 (one scale per operand, its
largest magnitude mapped to 448); ``scale_dh`` scores the attention with
Dh^-1/2 in place of (Dh / 2)^-1/2; ``no_adapter`` drops the MLP adapters;
``one_group`` has every head of a mixer read B/C group 0.  ``bf16``
rounds every product's operands to bfloat16 and is no fault: it reads
what rounding alone gives a bf16 program.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from .model import as_f32, exact, segsum  # noqa: F401  (as_f32, exact: the kind's)
from .model import prod as _prod

Params = Mapping[str, torch.Tensor]

PRECISIONS = ("f32", "fp8", "scale_dh", "no_adapter", "one_group", "bf16")
#: query rows of one block of the attention
Q_BLOCK = 512


def _mm(precision: str) -> str:
    """The rounding a stand-in gives the products."""
    return precision if precision in ("fp8", "bf16") else "f32"


def prod(eq: str, *ops: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """``model.prod``; at ``bf16`` each operand rounded to bfloat16 first."""
    if precision == "bf16":
        return _prod(eq, *[o.to(torch.bfloat16) for o in ops])
    return _prod(eq, *ops, precision=precision)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


# ---------------------------------------------------------------------------
# the Mamba-2 mixer with B/C groups
# ---------------------------------------------------------------------------

def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int, precision: str = "f32") -> torch.Tensor:
    """The SSD from a zero state.  x (b, l, h, p); dt (b, l, h) after the
    softplus; A (h,) negative; Bm, Cm (b, l, g, n), head i reading group
    i // (h / g).  Listing 1 of arXiv:2405.21060, chunk by chunk; a ragged
    last chunk is padded after the sequence."""
    b, l, h, p = x.shape
    pad = -l % chunk
    if pad:
        grow = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))   # noqa: E731
        return ssd(grow(x), grow(dt), A, grow(Bm), grow(Cm), chunk, precision)[:, :l]
    g, n, c = Bm.shape[2], Bm.shape[3], l // chunk
    group = torch.arange(h, device=x.device) // (h // g)                # head -> group
    mm = dict(precision=precision)
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Adt = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # b h c q
    Bh = Bm.reshape(b, c, chunk, g, n)[:, :, :, group]                 # b c q h n
    Ch = Cm.reshape(b, c, chunk, g, n)[:, :, :, group]
    A_cum = torch.cumsum(Adt, dim=-1)
    decay = torch.exp(segsum(Adt))                                     # b h c q s
    CB = prod("bclgn,bcsgn->bcgls", Cm.reshape(b, c, chunk, g, n),
              Bm.reshape(b, c, chunk, g, n), **mm)[:, :, group]        # b c h l s
    y_diag = prod("bhcls,bcshp->bclhp", decay * CB.permute(0, 2, 1, 3, 4), X, **mm)
    del decay, CB
    to_end = torch.exp(A_cum[..., -1:] - A_cum).permute(0, 2, 3, 1)   # b c q h
    states = prod("bclhn,bclhp->bchpn", Bh, X * to_end[..., None], **mm)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))          # b h c+1 c+1
    states = prod("bhzc,bchpn->bzhpn", across, states, **mm)[:, :-1]
    from_start = torch.exp(A_cum).permute(0, 2, 3, 1)                  # b c q h
    y_off = prod("bclhn,bchpn->bclhp", Ch, states, **mm) * from_start[..., None]
    return (y_diag + y_off).reshape(b, l, h, p)


def mixer(p: Params, pre: str, x: torch.Tensor, cfg: Mapping, precision: str) -> torch.Tensor:
    """``Zamba2MambaMixer`` over x (b, l, d): the in-projection to z, x|B|C
    and dt; the depthwise causal conv1d and SiLU over x|B|C; the SSD with
    the skip D x; RMSNorm(y silu(z)) over each group's channels; the
    out-projection."""
    d, N, P, G = cfg["d_model"], cfg["ssm_state"], cfg["ssm_head_dim"], cfg["ssm_groups"]
    di = cfg["ssm_expand"] * d
    H = di // P
    b, l, _ = x.shape
    mm = _mm(precision)
    zxbcdt = prod("bld,de->ble", x, p[pre + "w_in"], precision=mm)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    w = p[pre + "conv_w"]
    W = w.shape[0]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = p[pre + "conv_b"] + sum(xp[:, t:t + l] * w[t] for t in range(W))
    xs, Bm, Cm = torch.split(F.silu(conv), [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p[pre + "dt_bias"])
    A = -torch.exp(p[pre + "a_log"])
    xh = xs.reshape(b, l, H, P)
    Bm, Cm = Bm.reshape(b, l, G, N), Cm.reshape(b, l, G, N)
    if precision == "one_group":
        Bm, Cm = Bm[:, :, :1].expand_as(Bm), Cm[:, :, :1].expand_as(Cm)
    y = ssd(xh, dt, A, Bm, Cm, min(cfg["ssm_chunk"], l), mm)
    y = (y + p[pre + "d_skip"][:, None] * xh).reshape(b, l, G, di // G)
    gate = F.silu(z).reshape(b, l, G, di // G)
    y = rmsnorm(y * gate, 1.0, cfg["norm_eps"]).reshape(b, l, di) * p[pre + "norm_scale"]
    return prod("ble,ed->bld", y, p[pre + "w_out"], precision=mm)


# ---------------------------------------------------------------------------
# the shared block
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, s, h, dh) rotated over all dh dimensions, ``rotate_half``'s
    layout: x cos + rotate_half(x) sin with the frequencies repeated."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = positions.float()[:, None] * inv[None]                       # s, dh/2
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]                  # s, 1, dh
    half = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], dim=-1)
    return x * cos + half * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              precision: str) -> torch.Tensor:
    """Causal softmax(q k^T scale) v over (b, s, h, dh), ``Q_BLOCK`` query
    rows at a time."""
    s = q.shape[1]
    out = []
    for i in range(0, s, Q_BLOCK):
        qb = q[:, i:i + Q_BLOCK]
        sc = prod("bqhd,bkhd->bhqk", qb, k[:, :i + qb.shape[1]], precision=precision) * scale
        rows = i + torch.arange(qb.shape[1], device=q.device)
        keep = rows[:, None] >= torch.arange(sc.shape[-1], device=q.device)[None]
        sc = sc.masked_fill(~keep, -math.inf)
        out.append(prod("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v[:, :sc.shape[-1]],
                        precision=precision))
    return torch.cat(out, dim=1)


def shared_term(p: Params, blk: int, app: int, x: torch.Tensor, e: torch.Tensor,
                cfg: Mapping, precision: str) -> torch.Tensor:
    """``Zamba2AttentionDecoderLayer`` with the application's adapter, then
    its linear: the term the mixer's input gains, (b, s, d)."""
    pre, own = f"shared.{blk}.", f"apps.{app}."
    d, H, eps = cfg["d_model"], cfg["n_heads"], cfg["norm_eps"]
    A = cfg["attn_width"]
    Dh = A // H
    mm = _mm(precision)
    b, s, _ = x.shape
    u = rmsnorm(torch.cat([x, e], dim=-1), p[pre + "ln_in"], eps)
    qkv = prod("bsd,de->bse", u, p[pre + "w_qkv"], precision=mm).reshape(b, s, 3, H, Dh)
    pos = torch.arange(s, device=x.device)
    q, k = rope(qkv[:, :, 0], pos, cfg["rope_theta"]), rope(qkv[:, :, 1], pos, cfg["rope_theta"])
    scale = Dh ** -0.5 if precision == "scale_dh" else (Dh / 2) ** -0.5
    o = attention(q, k, qkv[:, :, 2], scale, mm).reshape(b, s, A)
    a = rmsnorm(prod("bsa,ad->bsd", o, p[pre + "w_o"], precision=mm), p[pre + "ln_ff"], eps)
    gu = prod("bsd,df->bsf", a, p[pre + "w_gate_up"], precision=mm)
    if precision != "no_adapter":
        low = prod("bsd,dr->bsr", a, p[own + "adapter_a"], precision=mm)
        gu = gu + prod("bsr,rf->bsf", low, p[own + "adapter_b"], precision=mm)
    g, up = gu.chunk(2, dim=-1)
    t = prod("bsf,fd->bsd", F.gelu(g) * up, p[pre + "w_down"], precision=mm)
    return prod("bsd,de->bse", t, p[own + "linear"], precision=mm)


# ---------------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------------

def hidden(p: Params, cfg: Mapping, tokens: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """tokens (b, s) -> final-norm hidden states (b, s, d), float32."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected {PRECISIONS}")
    e = x = p["embed.table"][tokens.long()].float()
    apps = {layer: j for j, layer in enumerate(cfg["hybrid_layer_ids"])}
    for i in range(cfg["n_layers"]):
        pre = f"blocks.{i}."
        h = x
        if i in apps:
            j = apps[i]
            h = x + shared_term(p, j % cfg["n_shared_blocks"], j, x, e, cfg, precision)
        x = x + mixer(p, pre + "mamba.", rmsnorm(h, p[pre + "ln.scale"], cfg["norm_eps"]),
                      cfg, precision)
    return rmsnorm(x, p["ln_f.scale"], cfg["norm_eps"])


def logits(p: Params, cfg: Mapping, h: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(..., d) -> (..., vocab) against the tied embedding."""
    return prod("...d,vd->...v", h, p["embed.table"][:cfg["vocab"]], precision=_mm(precision))


def last_logits(p: Params, cfg: Mapping, tokens: torch.Tensor,
                precision: str = "f32") -> torch.Tensor:
    """Logits after the last position of each row: (b, vocab)."""
    return logits(p, cfg, hidden(p, cfg, tokens, precision)[:, -1], precision)
