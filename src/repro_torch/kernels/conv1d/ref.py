"""Plain PyTorch version of the depthwise causal conv1d (+ SiLU) kernel
(mirrors ``src/repro/kernels/conv1d/ref.py``).

The CPU path of :func:`repro_torch.kernels.conv1d.causal_conv1d`, and the
version the CUDA kernel is held against on the card.  It does the
kernel's float32 operations in the kernel's order (bias first, then the
taps in order, each an unfused multiply and add), so without the SiLU
the two agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  activation: bool = True) -> torch.Tensor:
    """x: (B, L, C); w: (W, C); b: (C,).  Zero left-padding (fresh seq).

    Depthwise: out[b, l, c] = act( b[c] + sum_t w[t, c] * x[b, l-W+1+t, c] ).
    """
    W = w.shape[0]
    L = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    acc = b.float().expand(x.shape)
    for t in range(W):
        acc = acc + xp[:, t:t + L].float() * w[t].float()
    if activation:
        acc = F.silu(acc)
    return acc.to(x.dtype)
