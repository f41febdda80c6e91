"""Grouped-query attention: full-sequence, prefill, decode and cross
attention (mirrors ``src/repro/models/attention.py``).

Where the reference calls its jnp ``blockwise_attention`` (the point at
which a real TPU would run the Pallas flash kernel), ``self_attention``
and ``prefill_attention`` call the port's
:func:`~repro_torch.kernels.flash_attention.flash_attention`: on a CUDA
tensor the hand-written CUDA kernel, on a CPU tensor its plain version.
With ``impl="ring"`` and a mesh whose ``model`` axis divides the sequence
they run ``distributed.ring_attention`` instead, as the reference does.
``blockwise_attention`` is the reference's flash-style algorithm in
plain PyTorch, kept for parity with the JAX package; decode is plain
PyTorch, as it is plain jnp in the reference.  Cross attention never
reaches the kernel, as the reference never reaches its Pallas kernel
there: :func:`naive_attention` up to S * M = 4096^2 scores, else
:func:`blockwise_attention`.  The projections are ``torch.matmul``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
from .common import Params, apply_rope, dense_init


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    causal: bool = True
    q_block: int = 512
    kv_block: int = 512


def init_attention(gen: torch.Generator, cfg: AttnConfig,
                   dtype: torch.dtype = torch.float32) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, h, hd), dtype=dtype),
        "wk": dense_init(gen, (d, kv, hd), dtype=dtype),
        "wv": dense_init(gen, (d, kv, hd), dtype=dtype),
        "wo": dense_init(gen, (h, hd, d), in_axis=0, dtype=dtype),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _output(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(out.reshape(*out.shape[:-2], h * k), wo.reshape(h * k, d))


def qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
        cfg: AttnConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: AttnConfig, q_offset: int = 0) -> torch.Tensor:
    """Reference O(S^2)-memory attention: the flash kernel's plain version."""
    return attention_ref(q, k, v, causal=cfg.causal, q_offset=q_offset)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cfg: AttnConfig, q_offset: int = 0) -> torch.Tensor:
    """Causal (or full) attention without materializing S x S scores: the
    reference's two-level loop (query blocks, then key blocks with an
    online softmax).  q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh).  Padded
    keys get position 2**30, so every mask excludes them."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qb, kb = min(cfg.q_block, Sq), min(cfg.kv_block, Sk)
    Sq_p, Sk_p = -(-Sq // qb) * qb, -(-Sk // kb) * kb
    f32, dev = torch.float32, q.device
    qf = torch.zeros((B, Sq_p, H, Dh), dtype=f32, device=dev)
    qf[:, :Sq] = q.float() * (1.0 / math.sqrt(Dh))
    kf = torch.zeros((B, Sk_p, H, Dh), dtype=f32, device=dev)
    vf = torch.zeros((B, Sk_p, H, Dh), dtype=f32, device=dev)
    kf[:, :Sk] = torch.repeat_interleave(k.float(), G, dim=2)
    vf[:, :Sk] = torch.repeat_interleave(v.float(), G, dim=2)
    q_pos = q_offset + torch.arange(Sq_p, device=dev)
    k_pos = torch.arange(Sk_p, device=dev)
    k_pos = torch.where(k_pos < Sk, k_pos, torch.full_like(k_pos, 2 ** 30))
    force_mask = cfg.causal or Sk_p != Sk

    out = torch.empty((B, Sq_p, H, Dh), dtype=f32, device=dev)
    for i0 in range(0, Sq_p, qb):
        qblk, qp = qf[:, i0:i0 + qb], q_pos[i0:i0 + qb]
        m = torch.full((B, H, qb), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, H, qb), dtype=f32, device=dev)
        acc = torch.zeros((B, H, qb, Dh), dtype=f32, device=dev)
        for j0 in range(0, Sk_p, kb):
            kp = k_pos[j0:j0 + kb]
            s = torch.einsum("bqhd,bkhd->bhqk", qblk, kf[:, j0:j0 + kb])
            if force_mask:
                if cfg.causal:
                    mask = qp[:, None] >= kp[None, :]
                else:
                    mask = (kp[None, :] < 2 ** 30).expand(qb, kb)
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vf[:, j0:j0 + kb])
            m = m_new
        blk = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,H,qb,Dh)
        out[:, i0:i0 + qb] = blk.transpose(1, 2)
    return out[:, :Sq].to(q.dtype)


def _ring_applies(impl: str, mesh, S: int) -> bool:
    """The reference's condition for ring attention: ``impl="ring"``, a
    mesh with a ``model`` axis, and S divisible by that axis."""
    if impl != "ring" or mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return False
    return S % mesh.size(mesh.mesh_dim_names.index("model")) == 0


def self_attention(params: Params, x: torch.Tensor, cfg: AttnConfig,
                   impl: str = "blockwise", mesh=None) -> torch.Tensor:
    """Full-sequence self-attention with no cache (the training and
    full-forward compute).  x: (B, S, D).

    ``impl="ring"`` runs sequence-parallel ring attention over the mesh's
    ``model`` axis (``distributed.ring_attention``): the right choice when
    heads cannot shard over |model|.  Otherwise ``impl`` does not change
    the function: the reference falls back to ``blockwise_attention`` for
    "blockwise" and to ``naive_attention`` for anything else (no mesh, or
    S not divisible by |model|), and both compute what the flash kernel
    computes."""
    return prefill_attention(params, x, cfg, impl=impl, mesh=mesh)[0]


def prefill_attention(params: Params, x: torch.Tensor, cfg: AttnConfig,
                      impl: str = "blockwise", mesh=None, scale: Optional[float] = None):
    """:func:`self_attention` that also returns the (k, v) cache.
    x: (B, S, D).  ``scale`` multiplies the scores, Dh^-1/2 if None (ring
    attention takes None only)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = qkv(params, x, positions, cfg)
    if _ring_applies(impl, mesh, S):
        from repro_torch.distributed.ring_attention import ring_attention
        if scale is not None:
            raise ValueError("ring attention scores with Dh^-1/2 only")
        out = ring_attention(q, k, v, mesh, axis="model", causal=cfg.causal)
    else:
        out = flash_attention(q, k, v, causal=cfg.causal, scale=scale)
    return _output(out, params["wo"]), (k, v)


def decode_attention(params: Params, x: torch.Tensor,
                     cache: Tuple[torch.Tensor, torch.Tensor],
                     pos: torch.Tensor, cfg: AttnConfig, scale: Optional[float] = None):
    """Single-token decode: x (B, 1, D); cache k/v (B, S, KV, Dh); pos (B,)
    current absolute position; ``scale`` as :func:`prefill_attention`'s.
    Returns (out, (k, v)).

    The reference blends the new k/v in with a one-hot over S and returns
    new arrays; here they are written at ``pos`` by an index write into
    the cache tensors themselves, which are returned.  A ``pos`` at or
    past S raises here, where the one-hot would drop the write."""
    ck, cv = cache
    B, S, KV, Dh = ck.shape
    q, k_new, v_new = qkv(params, x, pos[:, None], cfg)
    rows, pos = torch.arange(B, device=x.device), pos.long()
    ck[rows, pos] = k_new[:, 0]
    cv[rows, pos] = v_new[:, 0]
    H = q.shape[2]
    qr = q.reshape(B, 1, KV, H // KV, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, ck.float())
    s = s / math.sqrt(Dh) if scale is None else s * scale
    valid = torch.arange(S, device=x.device)[None] <= pos[:, None]       # (B, S)
    s = torch.where(valid[:, None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
    out = out.reshape(B, 1, H, Dh).to(x.dtype)
    return _output(out, params["wo"]), (ck, cv)


# ---------------------------------------------------------------------------
# cross attention (VLM image layers, enc-dec decoder)
# ---------------------------------------------------------------------------

def cross_attention(params: Params, x: torch.Tensor, memory: torch.Tensor,
                    cfg: AttnConfig) -> torch.Tensor:
    """x: (B, S, D) queries; memory: (B, M, D).  Not causal, no rope
    (positions encode nothing across modalities)."""
    S, M = x.shape[1], memory.shape[1]
    q = _project(x, params["wq"])
    k = _project(memory, params["wk"])
    v = _project(memory, params["wv"])
    nc_cfg = cfg._replace(causal=False, rope_theta=0.0)
    if S * M <= 4096 * 4096:
        out = naive_attention(q, k, v, nc_cfg)
    else:
        out = blockwise_attention(q, k, v, nc_cfg)
    return _output(out, params["wo"])
