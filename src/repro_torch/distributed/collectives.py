"""The collectives the port's mesh path is built from, each differentiable
where a gradient crosses it.

The port runs SPMD over ranks, one per mesh coordinate.  A value that
every rank of a group computes alike is *replicated*: its gradient is
the same on every rank of the group, not a part of a sum.  So:

* :func:`split` takes a replicated tensor's block for this rank; its
  backward all-gathers the blocks' gradients, which makes the
  replicated input's gradient whole again on every rank;
* :func:`gather` all-gathers the blocks into a replicated tensor; its
  backward takes this rank's block of the (replicated) gradient and
  multiplies nothing by the group's size;
* :func:`hop` sends a tensor ``shift`` ranks along a ring and receives
  from the other side (a ``ppermute``); its backward is the reverse hop;
* :func:`broadcast` hands rank ``src``'s tensor to the group; its
  backward keeps the gradient on ``src`` only (and reaches the graphs of
  the tensors it is told to keep, with no gradient);
* :func:`gather_param` gathers a DTensor parameter whole before a block
  runs (ZeRO-3).  Its backward sums the gradients over the batch axes,
  where each rank saw its own batch shard, and takes the replicated
  gradient as it is on every other axis; the sum comes back
  reduce-scattered onto the parameter's shards;
* :func:`batch_sum` sums a value without a gradient (counts, a loss to
  report) over the batch axes.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.sharding.rules import BATCH_AXES


def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, _ = _size_rank(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = _size_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    return x.chunk(n, dim=dim)[r].contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_cat(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


def _p2p(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n, r = _size_rank(group)
    if shift % n == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _p2p(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _p2p(g, ctx.group, -ctx.shift), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src, *keep):
        ctx.keep_grad = dist.get_rank(group) == src
        ctx.n_keep = len(keep)
        out = x.detach().clone().contiguous()
        dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return ((g if ctx.keep_grad else torch.zeros_like(g)), None, None,
                *([None] * ctx.n_keep))


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of replicated ``x`` along ``dim``."""
    return _Split.apply(x, group, dim)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in rank order."""
    return _Gather.apply(x, group, dim)


def hop(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` further along the group's ring; the
    tensor returned is the one from ``shift`` ranks back."""
    return _Hop.apply(x, group, shift)


def broadcast(x: torch.Tensor, group, src: int, *keep: torch.Tensor) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group.  ``keep``:
    tensors that get no gradient but whose graphs the backward must reach
    on every rank, so that the point-to-point ops behind them run their
    backward on every rank, paired with their peers'."""
    return _Broadcast.apply(x, group, src, *keep)


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter whole, as a plain tensor (any other tensor as it
    is); see the module docstring for its gradient."""
    if not isinstance(p, DTensor):
        return p
    names = p.device_mesh.mesh_dim_names
    grads = [Partial() if n in BATCH_AXES else Replicate() for n in names]
    return p.redistribute(placements=[Replicate()] * len(names)).to_local(
        grad_placements=grads)


@torch.no_grad()
def batch_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's batch axes (pod, data); no gradient."""
    x = x.detach().clone()
    for axis in BATCH_AXES:
        if axis in (mesh.mesh_dim_names or ()) and mesh.size(
                mesh.mesh_dim_names.index(axis)) > 1:
            dist.all_reduce(x, group=mesh.get_group(axis))
    return x
