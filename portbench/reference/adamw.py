"""The program's AdamW, restated for the reference.

float32 moments; the whole gradient clipped by its global norm; the count
incremented before the schedule reads it (linear warm-up to ``lr``, then a
cosine to ``min_lr_frac`` of it); bias corrections 1 - b**count; the
step mhat / (sqrt(vhat) + eps) plus ``weight_decay`` x p where the
parameter decays; the new parameter computed in float32 and stored in the
dtype the configuration gives the parameter.  Decay falls on every block
parameter, vectors included, and on any other parameter of two or more
dimensions: the layout whose leaves stack each block parameter on a
layer axis decays every leaf of two or more dimensions.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

DEFAULTS = dict(lr=3e-4, warmup_steps=100, total_steps=10_000, min_lr_frac=0.1,
                b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)


def decays(name: str, ndim: int) -> bool:
    return name.startswith("blocks.") or ndim >= 2


def lr_at(opt: Mapping, count: torch.Tensor) -> torch.Tensor:
    step = count.float()
    warm = opt["lr"] * step / max(opt["warmup_steps"], 1)
    prog = torch.clamp((step - opt["warmup_steps"])
                       / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0, 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < opt["warmup_steps"], warm, opt["lr"] * cos)


class AdamW:
    """The optimizer over float32 parameter values ``params`` (updated in
    place), each stored back in ``dtypes[name]``."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 dtypes: Mapping[str, torch.dtype], opt: Mapping = DEFAULTS):
        self.opt = dict(opt)
        self.dtypes = dict(dtypes)
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=next(iter(params.values())).device)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor]
             ) -> Dict[str, float]:
        """One update; returns each gradient's norm as the update read it
        (after clipping)."""
        o = self.opt
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k])) for k in params))
        scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-12), max=1.0)
        self.count = self.count + 1
        lr = lr_at(o, self.count)
        b1c = 1 - o["b1"] ** self.count.float()
        b2c = 1 - o["b2"] ** self.count.float()
        norms = {}
        for k, p in params.items():
            g = grads[k] * scale
            norms[k] = float(torch.linalg.vector_norm(g))
            m, v = self.mu[k], self.nu[k]
            m.copy_(o["b1"] * m + (1 - o["b1"]) * g)
            v.copy_(o["b2"] * v + (1 - o["b2"]) * torch.square(g))
            step = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
            if decays(k, p.ndim):
                step = step + o["weight_decay"] * p
            p.copy_((p - lr * step).to(self.dtypes[k]).float())
        return norms
