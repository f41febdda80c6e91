"""Gradients through the CUDA kernels.

The JAX package trains by differentiating the jnp oracles of its Pallas
kernels; no Pallas kernel has a backward kernel or a ``custom_vjp``.  The
port runs its kernels where the JAX model calls those oracles, so a kernel
called on inputs that need a gradient goes through :class:`PlainGrad`: the
forward is the kernel, and the backward is PyTorch autograd of the
kernel's plain version recomputed on the saved inputs, the counterpart of
``jax.grad`` through the oracle.  The plain version never stands in for
the kernel in the forward, and the backward launches no kernel, so a
kernel's launch count moves once per forward call.  The backward runs in
an ``autograd.backward`` span (:mod:`repro_torch.tracing`) that names the
kernel.

:data:`PLAIN_DEVICES` are the device types whose tensors take a kernel's
plain version at its entry point: the CPU, and ``meta``, where the plain
version gives the shapes the dry run needs (``launch.dryrun``).  A tensor
on the card launches the kernel or raises.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tracing import span

PLAIN_DEVICES = ("cpu", "meta")


class PlainGrad(torch.autograd.Function):
    """``forward(ctx, name, kernel, plain, *inputs)`` returns
    ``kernel(*inputs)`` (a tensor or a tuple of tensors); the backward
    returns the gradient of ``plain(*inputs)`` for the inputs that need
    one.  An output whose cotangent is None (an unused final state) adds
    nothing.  ``name`` is the kernel's, for the backward's span."""

    @staticmethod
    def forward(ctx, name: str, kernel: Callable, plain: Callable, *inputs: torch.Tensor):
        ctx.name = name
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *cotangents):
        with span("autograd.backward", kernel=ctx.name):
            inputs = ctx.saved_tensors
            needs = ctx.needs_input_grad[3:]
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
                outs = ctx.plain(*leaves)
                outs = outs if isinstance(outs, tuple) else (outs,)
                pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
                wrt = [t for t, n in zip(leaves, needs) if n]
                grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                                 [g for _, g in pairs], allow_unused=True,
                                                 materialize_grads=True)
                             if pairs else [None] * len(wrt))
        return (None, None, None, *[next(grads) if n else None for n in needs])


def with_plain_grad(name: str, kernel: Callable, plain: Callable, *inputs: torch.Tensor):
    """``kernel(*inputs)``; through :class:`PlainGrad` when grad mode is on
    and an input requires a gradient.  ``name`` names the kernel
    (``conv1d``, ``ssd``, ``flash``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return PlainGrad.apply(name, kernel, plain, *inputs)
    return kernel(*inputs)
