"""Plain PyTorch version of the SSD chunked scan (mirrors
``src/repro/models/mamba2.py::ssd_chunked``, the oracle of the Pallas
kernel ``src/repro/kernels/ssd/ssd.py``).

The CPU path of :func:`repro_torch.kernels.ssd.ssd`, and the version the
CUDA kernel is held against on the card.  Like the Pallas kernel, it
multiplies in float32 whatever the input dtype (the reference's
``mm_dtype="float32"``); the scan starts from a zero state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD core.  xh: (B, L, H, P); dt: (B, L, H) (post-softplus);
    A: (H,) negative decay rates; Bm, Cm: (B, L, G, N).

    Returns (y: (B, L, H, P) in xh's dtype, final_state: (B, H, N, P)
    float32).
    """
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc, Q = L // chunk, chunk
    rep = H // G
    f32 = torch.float32
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))

    # chunk-major layout: leading axis = chunk index
    xq = xh.reshape(Bsz, nc, Q, H, P).transpose(0, 1).to(f32)
    dtq = dt.reshape(Bsz, nc, Q, H).transpose(0, 1).to(f32)
    Bq = Bm.reshape(Bsz, nc, Q, G, N).transpose(0, 1).to(f32)
    Cq = Cm.reshape(Bsz, nc, Q, G, N).transpose(0, 1).to(f32)
    A = A.to(f32)

    s = torch.zeros((Bsz, H, N, P), dtype=f32, device=xh.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xq[c], dtq[c], Bq[c], Cq[c]      # (B,Q,...)
        dA = dtc * A[None, None, :]                        # (B,Q,H) negative
        cum = torch.cumsum(dA, dim=1)
        total = cum[:, -1]                                 # (B,H)
        # intra-chunk: M[i,j] = exp(cum_i - cum_j), i >= j (masked before
        # the exponential, which overflows above the diagonal)
        diff = cum[:, :, None, :] - cum[:, None, :, :]     # (B,Qi,Qj,H)
        m4 = mask[None, :, :, None]
        decay = torch.exp(torch.where(m4, diff, torch.zeros_like(diff)))
        decay = torch.where(m4, decay, torch.zeros_like(decay))
        cb = torch.einsum("bign,bjgn->bijg", Cc, Bc)       # (B,Q,Q,G)
        cb = torch.repeat_interleave(cb, rep, dim=3)       # (B,Q,Q,H)
        xdt = xc * dtc[..., None]                          # (B,Q,H,P)
        y_intra = torch.einsum("bijh,bjhp->bihp", cb * decay, xdt)
        # inter-chunk: y_i += exp(cum_i) C_i . S_prev
        Ch = torch.repeat_interleave(Cc, rep, dim=2)       # (B,Q,H,N)
        y_inter = torch.einsum("bqhn,bhnp->bqhp",
                               Ch * torch.exp(cum)[..., None], s)
        # state: S = S_prev * exp(total) + sum_j exp(total-cum_j) B_j xdt_j
        sdecay = torch.exp(total[:, None, :] - cum)        # (B,Q,H)
        Bh = torch.repeat_interleave(Bc, rep, dim=2)       # (B,Q,H,N)
        s = (s * torch.exp(total)[:, :, None, None]
             + torch.einsum("bqhn,bqhp->bhnp", Bh * sdecay[..., None], xdt))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, L, H, P)
    return y.to(xh.dtype), s


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _split(t: torch.Tensor) -> torch.Tensor:
    """t as two bf16 MMA operands, hi + lo: about 16 significant bits."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def ssd_passes(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
               round_operands: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD as three passes, in the order and factoring of the bf16
    tensor-core instance:

    a. chunk states: dS_c = B_c^T (w x_c), w_j = exp(total_c - cum_j) dt_j;
    b. state passing: S_0 = 0, S_c = exp(total_{c-1}) S_{c-1} + dS_{c-1}
       (float32), and the final state S_nc;
    c. chunk scan, per 64-row tile I of a chunk (the whole chunk when it is
       not a multiple of 64), with e = 64 I - 1 the row before the tile:
       y_I = (C_I B_I^T * exp(cum_i - cum_j) dt_j, causal) x_I
           + exp(cum_i - cum_e) (C_I B_<I^T) (g x_<I),
             g_j = exp(cum_e - cum_j) dt_j
           + exp(cum_i) C_I S_c.

    With ``round_operands`` every float32 operand of a bf16 product is
    rounded as the kernel rounds it: w x and g x to one bf16; the diagonal
    tile's decayed scores, C_I B_<I^T and the entering state S_c to bf16
    hi + lo.  Same arguments and results as :func:`ssd_chunked`; a plain
    version used by no main path.
    """
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc, Q, rep = L // chunk, chunk, H // G
    T = 64 if Q % 64 == 0 else Q
    f32 = torch.float32
    rnd = _bf16 if round_operands else (lambda t: t)
    op = _split if round_operands else (lambda t: t)
    x = xh.to(f32).reshape(Bsz, nc, Q, H, P)
    dtq = dt.to(f32).reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtq * A.to(f32), dim=2)                  # (B,nc,Q,H)
    total = cum[:, :, -1]                                       # (B,nc,H)
    Bh = torch.repeat_interleave(Bm.to(f32).reshape(Bsz, nc, Q, G, N), rep, dim=3)
    Ch = torch.repeat_interleave(Cm.to(f32).reshape(Bsz, nc, Q, G, N), rep, dim=3)

    # a. chunk states
    w = torch.exp(total[:, :, None] - cum) * dtq                # (B,nc,Q,H)
    dS = torch.einsum("bcqhn,bcqhp->bchnp", Bh, rnd(x * w[..., None]))

    # b. state passing, float32
    S = torch.zeros((Bsz, H, N, P), dtype=f32, device=xh.device)
    entering = []
    for c in range(nc):
        entering.append(S)
        S = torch.exp(total[:, c])[:, :, None, None] * S + dS[:, c]

    # c. chunk scan, tile by tile; the mask before the exponential
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=xh.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        S_c = op(entering[c])
        for i0 in range(0, Q, T):
            r = slice(i0, i0 + T)
            ci = cum[:, c, r]                                   # (B,T,H)
            diff = ci[:, :, None] - ci[:, None]                 # (B,Ti,Tj,H)
            decay = torch.where(mask, torch.exp(torch.where(mask, diff, torch.zeros_like(diff))),
                                torch.zeros_like(diff))
            cb = torch.einsum("bihn,bjhn->bijh", Ch[:, c, r], Bh[:, c, r])
            y = torch.einsum("bijh,bjhp->bihp", op(cb * decay * dtq[:, c, r][:, None]),
                             x[:, c, r])
            if i0:
                ce = cum[:, c, i0 - 1]                          # (B,H)
                g = torch.exp(ce[:, None] - cum[:, c, :i0]) * dtq[:, c, :i0]
                cbo = torch.einsum("bihn,bjhn->bijh", Ch[:, c, r], Bh[:, c, :i0])
                y = y + torch.exp(ci - ce[:, None])[..., None] * torch.einsum(
                    "bijh,bjhp->bihp", op(cbo), rnd(g[..., None] * x[:, c, :i0]))
            y = y + torch.exp(ci)[..., None] * torch.einsum("bihn,bhnp->bihp",
                                                            Ch[:, c, r], S_c)
            ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, L, H, P)
    return y.to(xh.dtype), S


def ssd_passes_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int, dy: torch.Tensor,
                   d_final: Optional[torch.Tensor] = None, round_operands: bool = False
                   ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_chunked` in the factoring of the CUDA
    backward (``csrc/ssd_bwd.cu``): ``dy`` is y's cotangent, ``d_final`` the
    final state's (None: zero).  Returns (dx, ddt, dA, dB, dC) in their
    inputs' dtypes.  Per chunk c, with cum the inclusive prefix sum of dt A,
    total its last row, S_c the state entering the chunk and G_{c+1} the
    cotangent of the state leaving it:

    a. the entering states, as the forward's passes a and b form them;
    b. dG_c = sum_i exp(cum_i) C_i^T dy_i, and the reverse carry over the
       chunks G_c = exp(total_c) G_{c+1} + dG_c, G_nc = d_final;
    c. per chunk, with decay_ij = exp(cum_i - cum_j) (i >= j, else 0),
       P_ij = C_i . B_j, R_ij = dy_i . x_j and BG_j = B_j G_{c+1}:
       dx_j = dt_j [sum_i P_ij decay_ij dy_i + exp(total - cum_j) BG_j];
       ddt's direct term sum_i P_ij decay_ij R_ij + exp(total - cum_j) BG_j . x_j;
       W_ij = R_ij decay_ij dt_j summed over the group's heads, then
       dB_j = sum_i W_ij C_i + sum_h exp(total - cum_j) dt_j G_{c+1} x_j and
       dC_i = sum_j W_ij B_j + sum_h exp(cum_i) S_c dy_i;
    d. dcum_k = sum_j T_kj + U_k - dt_k ddt_k (T_ij = P_ij decay_ij R_ij dt_j,
       U_i = exp(cum_i) C_i S_c dy_i), plus <G_{c+1}, S_{c+1}> at the
       chunk's last row (total's term); its reverse prefix sum over the
       chunk is d(dt A), which adds A (...) to ddt and sum dt (...) to dA.

    With ``round_operands`` every float32 operand of a bf16 product is
    rounded as the kernels round it: w x in the chunk states (the forward's
    pass a) to one bf16; the decayed scores, W, G, S and exp(cum) dy to
    bf16 hi + lo.  Float32 otherwise; a plain version used by no main path.
    """
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc, Q, rep = L // chunk, chunk, H // G
    f32 = torch.float32
    rnd = _bf16 if round_operands else (lambda t: t)
    op = _split if round_operands else (lambda t: t)
    x = xh.to(f32).reshape(Bsz, nc, Q, H, P)
    g = dy.to(f32).reshape(Bsz, nc, Q, H, P)
    dtq = dt.to(f32).reshape(Bsz, nc, Q, H)
    Af = A.to(f32)
    cum = torch.cumsum(dtq * Af, dim=2)                          # (B,nc,Q,H)
    total = cum[:, :, -1]                                        # (B,nc,H)
    Bg = Bm.to(f32).reshape(Bsz, nc, Q, G, N)
    Cg = Cm.to(f32).reshape(Bsz, nc, Q, G, N)
    Bh = torch.repeat_interleave(Bg, rep, dim=3)                 # (B,nc,Q,H,N)
    Ch = torch.repeat_interleave(Cg, rep, dim=3)

    # a. entering states S_c, and S_{c+1}
    w = torch.exp(total[:, :, None] - cum) * dtq
    dS = torch.einsum("bcqhn,bcqhp->bchnp", Bh, rnd(x * w[..., None]))
    S = torch.zeros((Bsz, H, N, P), dtype=f32, device=xh.device)
    entering = []
    for c in range(nc):
        entering.append(S)
        S = torch.exp(total[:, c])[:, :, None, None] * S + dS[:, c]
    S_in = op(torch.stack(entering, dim=1))                      # (B,nc,H,N,P)
    S_out = torch.cat([S_in[:, 1:], S[:, None]], dim=1)

    # b. the state's cotangent, a reverse pass over the chunks
    dG = torch.einsum("bcqhn,bcqhp->bchnp", Ch, op(torch.exp(cum)[..., None] * g))
    Gc = (torch.zeros_like(S) if d_final is None else d_final.to(f32))
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = Gc
        Gc = torch.exp(total[:, c])[:, :, None, None] * Gc + dG[:, c]
    G_out = torch.stack(leaving, dim=1)                          # G_{c+1}
    dot = (G_out * S_out).sum(dim=(-2, -1))                      # (B,nc,H)
    G_out = op(G_out)                     # the products read G as bf16 hi + lo

    # c. per chunk; the mask before the exponential
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))[..., None]
    diff = cum[:, :, :, None] - cum[:, :, None]                  # (B,nc,Qi,Qj,H)
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, torch.zeros_like(diff))),
                        torch.zeros_like(diff))
    Pm = torch.einsum("bcign,bcjgn->bcijg", Cg, Bg).repeat_interleave(rep, dim=-1)
    R = torch.einsum("bcihp,bcjhp->bcijh", g, x)
    E = Pm * decay * R
    sd = op(Pm * decay)
    eb = torch.exp(total[:, :, None] - cum)                      # (B,nc,Q,H)
    BG = torch.einsum("bcjhn,bchnp->bcjhp", Bh, G_out)
    dx = dtq[..., None] * (torch.einsum("bcijh,bcihp->bcjhp", sd, g) + eb[..., None] * BG)
    ddt = E.sum(dim=2) + eb * (BG * x).sum(dim=-1)               # direct term
    rowT = (E * dtq[:, :, None]).sum(dim=3)                      # (B,nc,Qi,H)
    U = torch.exp(cum) * torch.einsum("bcihn,bchnp,bcihp->bcih", Ch, S_in, g)
    W = op((R * decay * dtq[:, :, None]).reshape(Bsz, nc, Q, Q, G, rep).sum(dim=-1))
    dBh = (eb * dtq)[..., None] * torch.einsum("bchnp,bcjhp->bcjhn", G_out, x)
    dCh = torch.exp(cum)[..., None] * torch.einsum("bchnp,bcihp->bcihn", S_in, g)
    dB = (torch.einsum("bcijg,bcign->bcjgn", W, Cg)
          + dBh.reshape(Bsz, nc, Q, G, rep, N).sum(dim=4))
    dC = (torch.einsum("bcijg,bcjgn->bcign", W, Bg)
          + dCh.reshape(Bsz, nc, Q, G, rep, N).sum(dim=4))

    # d. d(dt A) from dcum, a reverse prefix sum over each chunk
    dcum = rowT + U - dtq * ddt
    dcum[:, :, -1] += dot
    rc = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt + Af * rc
    dA = (dtq * rc).sum(dim=(0, 1, 2))
    return (dx.reshape(Bsz, L, H, P).to(xh.dtype), ddt.reshape(Bsz, L, H).to(dt.dtype),
            dA.to(A.dtype), dB.reshape(Bsz, L, G, N).to(Bm.dtype),
            dC.reshape(Bsz, L, G, N).to(Cm.dtype))
