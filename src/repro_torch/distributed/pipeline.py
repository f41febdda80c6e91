"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (mirrors
``src/repro/distributed/pipeline.py``).

Microbatches flow through the stages by point-to-point sends (the
inter-rank shuffle); each rank applies its stage's parameters.  The
schedule is the classic (n_micro + n_stages - 1)-step wavefront; bubbles
shrink as n_micro grows.  The last stage's outputs are broadcast to every
rank.  The rotation and the broadcast are differentiable
(``distributed.collectives``): each rank's stage parameters get their
stage's gradient, and the input's gradient lands on stage 0's rank.
Every activation a rank received goes to the broadcast as a tensor to
keep, so that every rank's backward runs each rotation's reverse hop,
stage 0's unused ones included, paired with its neighbours'.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .collectives import broadcast, hop


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, axis: str = "stage") -> torch.Tensor:
    """Apply ``n_stages`` stages to ``n_micro`` microbatches.

    stage_fn(params_i, x) -> x        (one stage's computation)
    stage_params: tree with leading dim = n_stages, whole on every rank
    x: (n_micro, micro_batch, ...) microbatched input (the same on every rank)

    Returns (n_micro, micro_batch, ...) outputs after all stages, on every
    rank of ``axis``.
    """
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    n_micro = x.shape[0]
    T = n_micro + n_stages - 1
    params = _tree_map(lambda p: p[idx], stage_params)
    last = idx == n_stages - 1
    buf = torch.zeros_like(x[0])                       # resident activation
    outs, received = [None] * n_micro, []
    for t in range(T):
        # stage 0 ingests microbatch t (clipped past the last)
        cur = x[min(t, n_micro - 1)] if idx == 0 else buf
        y = stage_fn(params, cur)
        out_idx = t - (n_stages - 1)                   # what the last stage emits
        if last and 0 <= out_idx < n_micro:
            outs[out_idx] = y
        if t < T - 1:
            buf = hop(y, group)                        # the wavefront shuffle
            received.append(buf)
    local = torch.stack(outs) if last else torch.zeros_like(x)
    return broadcast(local, group, n_stages - 1, *received)
