"""Plain PyTorch version of the Mamba-2 mixer's tail: the D skip, the SiLU
gate and the grouped RMSNorm.

The CPU path of :func:`repro_torch.kernels.gated_norm.gated_norm_tail`,
the backward of every call on the card whose inputs need a gradient, and
the version the CUDA kernel is held against on the card.  It is the
mixer's own expression (``Mamba2.forward`` and ``decode_step``), with the
lean ``models.common.rmsnorm``: each elementwise operation computes in
float32 and rounds to its result's type, and the kernel rounds at the
same points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """RMSNorm(y * silu(z)) with its statistics taken over each of
    ``groups`` equal parts of the last axis (Zamba2's ``Zamba2RMSNormGated``
    normalises each B/C group's channels on its own); one group is the
    RMSNorm over all of d_inner."""
    # imported here: the models package imports this one through mamba2
    from repro_torch.models.common import rmsnorm

    h = y * F.silu(z)
    if groups == 1:
        return rmsnorm(h, scale, eps)
    h = rmsnorm(h.unflatten(-1, (groups, -1)), None, eps).flatten(-2)
    return h * scale.to(h.dtype)


def gated_norm_tail(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                    d_skip: torch.Tensor, scale: torch.Tensor, groups: int,
                    eps: float, dtype: torch.dtype) -> torch.Tensor:
    """y, xh: (B, L, H, P), the SSD's output and input; z: (B, L, H P);
    d_skip: (H,); scale: (H P,).  Returns
    ``gated_norm((y + d_skip xh) as dtype, z, scale, groups, eps)``, (B, L, H P)."""
    B, L, H, P = xh.shape
    y = y + d_skip[None, None, :, None] * xh
    y = y.reshape(B, L, H * P).to(dtype)
    return gated_norm(y, z, scale, groups, eps)


#: float32 ulps of the statistic rsqrt(mean v^2 + eps) within which another
#: order of its float32 sum may round it to the neighbouring bf16 value
TIE_ULPS = 64
#: bf16 ulps an output moves when its group's bf16 statistic moves by one:
#: v r rounds to within 3 of its former value, times the scale to within 7
TIE_MOVE_ULPS = 7


def compare_bf16(got: torch.Tensor, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                 d_skip: torch.Tensor, scale: torch.Tensor, groups: int,
                 eps: float) -> dict:
    """``got`` (a bf16 tail of these operands computed elsewhere, the CUDA
    kernel) against :func:`gated_norm_tail`.  Every element rounds at the
    plain version's points, so the two differ only in (row, group)s whose
    float32 statistic lies within :data:`TIE_ULPS` of a bf16 rounding
    midpoint, where the sum's order decides its rounding, and there by at
    most :data:`TIE_MOVE_ULPS`.  Returns ``max_ulps``, ``bit_identical``
    (the share of equal elements), ``groups`` (row-groups), ``near_tie``,
    ``differ`` and ``differ_off_tie`` (row-groups that differ away from a
    tie: 0 when the kernel rounds as the plain version does)."""
    want = gated_norm_tail(y, xh, z, d_skip, scale, groups, eps, torch.bfloat16)
    B, L, H, P = xh.shape
    u = (y + d_skip[None, None, :, None] * xh).reshape(B, L, H * P).to(torch.bfloat16)
    h = (u * F.silu(z)).unflatten(-1, (groups, -1))
    r = torch.rsqrt(torch.mean(torch.square(h.float()), dim=-1) + eps)
    tie = ((r.view(torch.int32) & 0xFFFF) - 0x8000).abs() <= TIE_ULPS
    ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    differ = ulps.unflatten(-1, (groups, -1)).amax(-1) > 0
    return {"max_ulps": int(ulps.max()), "bit_identical": float((ulps == 0).double().mean()),
            "groups": differ.numel(), "near_tie": int(tie.sum()), "differ": int(differ.sum()),
            "differ_off_tie": int((differ & ~tie).sum()),
            "sign_flips": int((got.sign() != want.sign()).sum())}
