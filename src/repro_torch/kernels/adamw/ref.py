"""Plain PyTorch version of the AdamW update of one tensor.

The CPU path of :func:`repro_torch.train.optim.adamw_update`, and the
version the CUDA kernel (:mod:`.ops`) is held against on the card.  It is
the per-tensor expression ``adamw_update`` ran before the kernel, moved
unchanged: each elementwise operation computes in float32 and rounds to
float32, the new parameter is rounded once to the parameter's dtype, and
the kernel rounds at the same points.
"""

from __future__ import annotations

import torch


def adamw_tensor(cfg, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
                 b2c: torch.Tensor, decay: bool) -> None:
    """One AdamW step of the parameter ``p`` with gradient ``g`` and the
    float32 moments ``m`` and ``v``, all updated in place.  ``cfg`` holds
    ``b1``, ``b2``, ``eps`` and ``weight_decay`` (an ``OptConfig``);
    ``scale`` is the clip factor, ``lr`` the step's learning rate and
    ``b1c``, ``b2c`` the bias corrections, float32 tensors of one element;
    ``decay``: decoupled weight decay applies."""
    g = g.float() * scale
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
    step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if decay:   # decoupled decay
        step = step + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * step)
