"""Plain PyTorch attention, the oracle of the flash-attention kernel
(mirrors ``src/repro/kernels/flash_attention/ref.py``, which re-exports
``src/repro/models/attention.py::naive_attention``).

The CPU path of :func:`repro_torch.kernels.flash_attention.flash_attention`,
and the version the CUDA kernel is held against on the card: float32
scores scaled by Dh^-1/2 (or by a given ``scale``), masked with -1e30, a
softmax, then P.V, with the O(S^2) score tensor materialized.  ``models.attention.naive_attention``
is this function.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30          # the reference's mask value (not -inf)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); H % KV == 0.  The causal
    mask keeps key j for query i when q_offset + i >= j; the scores are
    scaled by ``scale``, Dh^-1/2 if None.  Returns (B, Sq, H, Dh) in q's
    dtype."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float())
    s = s / math.sqrt(Dh) if scale is None else s * scale
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        mask = qp[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, key_tile: int = 64,
                    round_p: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """The online softmax over tiles of ``key_tile`` keys, in the order and
    base of the bf16 tensor-core instance: raw scores q.k in float32, the
    mask (-1e30) before the exponential, p = 2^(s c - m c) with c =
    scale log2(e) (scale Dh^-1/2 if None) against the running max m, l the
    sum of the float32 p.
    With ``round_p`` each tile's p enters P V rounded to bf16, the one
    operand the kernel rounds.  Same arguments and result as
    :func:`attention_ref`; a plain version used by no main path."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    c = math.log2(math.e) / math.sqrt(Dh) if scale is None else math.log2(math.e) * scale
    qf = q.reshape(B, Sq, KV, G, Dh).float()
    rows = torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Sq, Dh), dtype=torch.float32, device=q.device)
    for j0 in range(0, Sk, key_tile):
        kt, vt = k[:, j0:j0 + key_tile].float(), v[:, j0:j0 + key_tile].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt)
        if causal:
            cols = j0 + torch.arange(kt.shape[1], device=q.device)
            s = torch.where(rows[:, None] >= cols[None, :], s, torch.full_like(s, NEG_INF))
        mx = torch.maximum(m, s.amax(dim=-1))
        mc = torch.where(mx == NEG_INF, torch.zeros_like(mx), mx * c)
        corr = torch.exp2(m * c - mc)
        p = torch.exp2(s * c - mc[..., None])
        l = l * corr + p.sum(dim=-1)
        if round_p:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vt)
        m = mx
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)
