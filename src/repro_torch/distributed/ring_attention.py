"""Ring attention: sequence-parallel attention by a rotation of the k/v
blocks around a mesh axis (mirrors ``src/repro/distributed/ring_attention.py``).

This is the paper's shuffle at *mesh* granularity: on a warp,
``shfl.up`` hands a register to the neighbouring lane; on a mesh, a
point-to-point send hands a KV block to the neighbouring rank.  Both
replace a redundant gather with nearest-neighbour communication.

Every rank of the ``axis`` group holds the full (B, S, ., Dh) q, k and v
(they come from replicated activations).  Each takes its own sequence
block of q, k and v; each of the |axis| steps computes the local q
block's partial attention against the resident k/v block (the
reference's online-softmax merge, positions and -1e30 mask, in float32)
and then hands the k/v block one hop along the ring.  The output blocks
are all-gathered along the sequence.  The gradient flows back through
the same steps: a hop's backward is the reverse hop, the block split's is
an all-gather and the output gather's is the block split, so the
replicated inputs get whole, equal gradients on every rank
(``distributed.collectives``).  The partial attention is the plain
float32 einsum, not the flash kernel, whose epilogue writes no
log-sum-exp to merge.
"""

from __future__ import annotations

import math

import torch

from .collectives import gather, hop, split

_NEG_INF = -1e30


def _partial_attn(q, k, v, q_pos, k_pos, causal):
    """Blockwise partial attention with explicit positions.

    q: (B, Sq, KV, G, Dh); k, v: (B, Sk, KV, Dh).
    Returns (scores-max m, normalizer l, weighted accum acc).
    """
    Dh = q.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) / math.sqrt(Dh)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None, None], s, torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return m, l, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "model", causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, Dh); k, v: (B, S, KV, Dh), the same on every rank of
    ``axis``, S divisible by its size.  Returns (B, S, H, Dh) attention
    output, the same on every rank of ``axis``."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    group = mesh.get_group(axis)
    tp, idx = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    if S % tp:
        raise ValueError(f"sequence {S} does not split over {axis} of size {tp}")
    Sl = S // tp
    dev = q.device
    qg = split(q, group, 1).reshape(B, Sl, KV, G, Dh)
    kb, vb = split(k, group, 1), split(v, group, 1)
    q_pos = idx * Sl + torch.arange(Sl, device=dev)
    m = torch.full((B, KV, G, Sl), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sl), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sl, Dh), dtype=torch.float32, device=dev)
    for i in range(tp):
        src = (idx - i) % tp                           # owner of the resident kv
        k_pos = src * Sl + torch.arange(Sl, device=dev)
        m2, l2, acc2 = _partial_attn(qg, kb, vb, q_pos, k_pos, causal)
        m_new = torch.maximum(m, m2)
        c1 = torch.exp(m - m_new)
        c2 = torch.exp(m2 - m_new)
        l = l * c1 + l2 * c2
        acc = acc * c1[..., None] + acc2 * c2[..., None]
        m = m_new
        if i < tp - 1:                                 # the mesh "shuffle"
            kb, vb = hop(kb, group), hop(vb, group)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sl, H, Dh).to(q.dtype)
    return gather(out, group, 1)
