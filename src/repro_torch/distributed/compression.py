"""Gradient compression for the cross-pod data-parallel reduce (mirrors
``src/repro/distributed/compression.py``).

The ``pod`` axis is pure DP over the slowest links, the canonical target
for compression.  Two schemes:

``pod_compressed_mean``
    stateless int8 quantization (per-leaf max-abs scale) + all_gather
    over ``pod`` + local dequant-mean: 4x less cross-pod traffic than a
    float32 ring all-reduce.

``ef_compressed_mean``
    the same with *error feedback*: the quantization residual is carried
    to the next step and added before quantizing, which restores
    convergence for contractive compressors.  The residual is a
    gradient-shaped dict the caller threads through training.

Each takes ``{name: gradient}``; a gradient may be a DTensor, whose
scale is the max-abs over the whole tensor (as the reference's, which
quantizes each leaf whole) and whose shards are quantized and gathered
where they lie.  No gradient flows through either.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _like(t: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` laid out as ``t``: a DTensor of its placements, or as it is."""
    if isinstance(t, DTensor):
        return DTensor.from_local(local, t.device_mesh, t.placements,
                                  shape=t.shape, stride=t.stride())
    return local


def _global_absmax(t: torch.Tensor) -> torch.Tensor:
    """max |t| over the whole tensor: the local shard's, then over the mesh
    dimensions that split it."""
    m = torch.amax(torch.abs(_local(t).float()))
    if isinstance(t, DTensor):
        for i, pl in enumerate(t.placements):
            if pl.is_shard() and t.device_mesh.size(i) > 1:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=t.device_mesh.get_group(i))
    return m


def _quantize(g: torch.Tensor, absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _mean_over_pod(q: torch.Tensor, scale: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    qg = [torch.empty_like(q) for _ in range(n)]
    sg = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qg, q.contiguous(), group=group)          # (pods, ...) int8
    dist.all_gather(sg, scale.reshape(()).contiguous(), group=group)
    deq = torch.stack(qg).float() * torch.stack(sg).reshape((-1,) + (1,) * q.ndim)
    return torch.mean(deq, dim=0)


@torch.no_grad()
def pod_compressed_mean(grads: Mapping[str, torch.Tensor], mesh,
                        axis: str = "pod") -> Dict[str, torch.Tensor]:
    """Mean-reduce grads over the pod axis with int8 on the wire."""
    group = mesh.get_group(axis)
    out = {}
    for k, g in grads.items():
        q, s = _quantize(_local(g).float(), _global_absmax(g))
        out[k] = _like(g, _mean_over_pod(q, s, group))
    return out


@torch.no_grad()
def ef_compressed_mean(grads: Mapping[str, torch.Tensor],
                       residual: Mapping[str, torch.Tensor], mesh,
                       axis: str = "pod") -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, torch.Tensor]]:
    """Error-feedback variant: returns (mean grads, new residual)."""
    group = mesh.get_group(axis)
    means, resid = {}, {}
    for k, g in grads.items():
        corrected = _like(g, _local(g).float() + _local(residual[k]))
        q, s = _quantize(_local(corrected), _global_absmax(corrected))
        sent = q.float() * s
        means[k] = _like(g, _mean_over_pod(q, s, group))
        resid[k] = _like(g, _local(corrected) - sent)
    return means, resid
