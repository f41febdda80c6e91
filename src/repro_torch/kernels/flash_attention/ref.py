"""Plain PyTorch attention, the oracle of the flash-attention kernel
(mirrors ``src/repro/kernels/flash_attention/ref.py``, which re-exports
``src/repro/models/attention.py::naive_attention``).

The CPU path of :func:`repro_torch.kernels.flash_attention.flash_attention`,
and the version the CUDA kernel is held against on the card: float32
scores scaled by Dh^-1/2, masked with -1e30, a softmax, then P.V, with
the O(S^2) score tensor materialized.  ``models.attention.naive_attention``
is this function.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30          # the reference's mask value (not -inf)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); H % KV == 0.  The causal
    mask keeps key j for query i when q_offset + i >= j.  Returns
    (B, Sq, H, Dh) in q's dtype."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) / math.sqrt(Dh)
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        mask = qp[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)
