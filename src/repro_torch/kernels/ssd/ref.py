"""Plain PyTorch version of the SSD chunked scan (mirrors
``src/repro/models/mamba2.py::ssd_chunked``, the oracle of the Pallas
kernel ``src/repro/kernels/ssd/ssd.py``).

The CPU path of :func:`repro_torch.kernels.ssd.ssd`, and the version the
CUDA kernel is held against on the card.  Like the Pallas kernel, it
multiplies in float32 whatever the input dtype (the reference's
``mm_dtype="float32"``); the scan starts from a zero state.
"""

from __future__ import annotations

from typing import Tuple

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
