"""AdamW + global-norm clipping + cosine schedule (mirrors
``src/repro/train/optim.py``).

The reference's arithmetic, over a dict of named tensors (the model's
``named_parameters()``) instead of a pytree: first and second moments in
float32 whatever the parameter's dtype; the whole gradient clipped by its
global norm; ``count`` incremented before the schedule reads it; bias
corrections ``1 - b**count``; the step ``mhat / (sqrt(vhat) + eps)``
plus ``weight_decay * p`` for leaves of two or more dimensions; the new
parameter computed in float32 and cast to the parameter's dtype.  The
reference's leaves stack each block parameter on a layer axis, so it
decays every block parameter, vectors included: ``ndims`` carries those
dimensions (``interop.reference_ndims``).
``torch.optim.AdamW`` differs on each of these points.  The reference
returns new arrays; here the parameters and moments are updated in place,
which saves a copy of each on the card.

On the card the update is one hand-written multi-tensor CUDA update
(:mod:`repro_torch.kernels.adamw`: the norm, the clip scale and every
tensor's step in three launches, with this arithmetic rounded at the same
points); on the CPU and ``meta`` it is the plain version, tensor by
tensor (:func:`repro_torch.kernels.adamw.ref.adamw_tensor`).

On a mesh the parameters, their gradients and the moments are DTensors
of the same placements: the update is elementwise, so it runs on each
rank's shards, and the global norm that clipping reads is taken over the
whole tensors (each element once, whatever shard holds it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.kernels import adamw as adamw_kernel
from repro_torch.kernels.adamw import ref as adamw_ref
from repro_torch.kernels.autograd import PLAIN_DEVICES

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Tensors              # first moment, float32, keyed like the params
    nu: Tensors              # second moment, float32
    count: torch.Tensor      # int32 scalar: updates taken


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``; float32."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros of ``p``'s shape (a DTensor of its placements for one)."""
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=torch.float32).detach()
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    return OptState(
        mu={k: _zeros_f32(p) for k, p in params.items()},
        nu={k: _zeros_f32(p) for k, p in params.items()},
        count=torch.zeros((), dtype=torch.int32,
                          device=next(iter(params.values())).device))


def _split(t: torch.Tensor) -> Tuple[Optional[object], Tuple[int, ...]]:
    """A DTensor's mesh and the mesh dimensions that split it with more
    than one rank; (None, ()) for a plain tensor."""
    if not isinstance(t, DTensor):
        return None, ()
    if any(pl.is_partial() for pl in t.placements):
        raise ValueError(f"global_norm of a partial DTensor {t.placements}")
    mesh = t.device_mesh
    return mesh, tuple(i for i, pl in enumerate(t.placements)
                       if pl.is_shard() and mesh.size(i) > 1)


def _sum_shards(v: torch.Tensor, split) -> torch.Tensor:
    """Each tensor's local sum of squares in ``v`` added over the mesh
    dimensions that split it (``split``, :func:`_split` of each): one
    all-reduce per mesh dimension, for all the tensors it splits."""
    groups = {(id(m), i): (m, i) for m, dims in split for i in dims}
    for (mid, i), (mesh, _) in groups.items():
        mask = torch.tensor([id(m) == mid and i in dims for m, dims in split],
                            device=v.device)
        part = torch.where(mask, v, torch.zeros_like(v))
        dist.all_reduce(part, group=mesh.get_group(i))
        v = torch.where(mask, part, v)
    return v


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32, summed
    tensor by tensor in order.  A DTensor's elements count once each: its
    local sum is added over the mesh dimensions that split it (one
    all-reduce per mesh dimension, for all the tensors it splits), so a
    mesh of one rank sums exactly as one device does."""
    sums, split = [], []
    for t in tensors:
        split.append(_split(t))
        sums.append(torch.sum(torch.square(_local(t).float())))
    if any(dims for _, dims in split):
        sums = list(_sum_shards(torch.stack(sums), split).unbind())
    return torch.sqrt(sum(sums))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself, so writes land in it)."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Mapping[str, torch.Tensor], state: OptState,
                 params: Mapping[str, torch.Tensor],
                 ndims: Optional[Mapping[str, int]] = None
                 ) -> Tuple[Mapping[str, torch.Tensor], OptState, Tensors]:
    """One AdamW step.  ``params``, ``state.mu`` and ``state.nu`` are
    updated in place; returns (params, new state, {"grad_norm", "lr"})
    with the gradient norm taken before clipping.  A parameter is decayed
    where ``ndims`` (its own dimensions if None) is 2 or more.  DTensor
    parameters take gradients and moments of their placements.  On the
    card the whole update is :mod:`repro_torch.kernels.adamw`'s kernel;
    on the CPU and ``meta`` its plain version, tensor by tensor."""
    count = state.count + 1
    steps = count.float()
    lr = lr_schedule(cfg, steps)
    b1c = 1 - cfg.b1 ** steps
    b2c = 1 - cfg.b2 ** steps
    entries = []
    for k, p in params.items():
        if isinstance(p, DTensor) and grads[k].placements != p.placements:
            raise ValueError(f"{k}: gradient placed {grads[k].placements}, "
                             f"parameter {p.placements}")
        decay = (p.ndim if ndims is None else ndims[k]) >= 2     # decoupled decay
        entries.append((_local(grads[k]), _local(p), _local(state.mu[k]),
                        _local(state.nu[k]), decay))
    if entries[0][1].device.type in PLAIN_DEVICES:
        gnorm = global_norm(grads[k] for k in params)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        for g, p, m, v, decay in entries:
            adamw_ref.adamw_tensor(cfg, p, g, m, v, scale, lr, b1c, b2c, decay)
    else:
        split = [_split(grads[k]) for k in params]
        sum_shards = ((lambda v: _sum_shards(v, split))
                      if any(dims for _, dims in split) else None)
        # a gradient autograd left as a strided view is made dense first
        entries = [(g.contiguous(), *rest) for g, *rest in entries]
        gnorm = adamw_kernel.build_kernel()(entries, cfg, lr, b1c, b2c, sum_shards)
    return params, OptState(state.mu, state.nu, count), {"grad_norm": gnorm, "lr": lr}


def first_step_bound(old: torch.Tensor, new: torch.Tensor, grad: torch.Tensor,
                     scale: float, lr: float, delta_rel: float,
                     eps: float = OptConfig.eps) -> torch.Tensor:
    """Per element (float64), how far two AdamW first steps may put a
    parameter apart when their gradients agree to ``delta_rel`` of the
    leaf's largest |g|, the gradient clipped by ``scale``; ``old`` and
    ``new`` are one side's parameter before and after.  The first update
    is lr g / (|g| + eps) plus a decay term equal on both sides: an error
    delta in g moves it by at most lr eps delta / (|g| - delta)^2 where
    |g| > delta, and by at most 2 lr where not; plus float32 rounding of
    the parameter before and after.  A checking helper for the tests and
    the card's smoke run, which compare train steps across devices and
    packages."""
    g = grad.double().abs() * scale
    delta = delta_rel * float(g.max())
    far = torch.where(g > delta, eps * delta / (g - delta).clamp(min=1e-300) ** 2,
                      torch.full_like(g, 2.0))
    return lr * far.clamp(max=2.0) + 1e-6 * (old.double().abs() + new.double().abs())
