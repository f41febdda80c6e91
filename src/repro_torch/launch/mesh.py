"""Device meshes (mirrors ``src/repro/launch/mesh.py``).

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the ranks of
the default process group, one rank per mesh coordinate: ``"cuda"``
meshes run over NCCL, ``"cpu"`` meshes over gloo, and neither falls back
to the other.  ``make_mesh`` requires a default process group of exactly
``prod(shape)`` ranks (``torchrun``, or ``torch.multiprocessing`` in the
tests) and never builds a smaller mesh.  ``make_production_mesh`` is a
function, never a module-level constant, so importing this module
touches no process group: the single-pod mesh is (16, 16) ``("data",
"model")`` and the multi-pod one prepends a ``pod`` axis, (2, 16, 16).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A ``shape`` mesh named ``axes`` over the default process group,
    which must hold ``prod(shape)`` ranks on ``device_type``'s backend."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: have {', '.join(BACKENDS)}")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a default process group of {n} "
                           f"ranks (torchrun --nproc-per-node {n}, or "
                           f"torch.distributed.init_process_group); none is initialized")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process group "
                           f"has {dist.get_world_size()}")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise RuntimeError(f"a {device_type} mesh runs over {BACKENDS[device_type]}; "
                           f"the process group's backend is {backend}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh() -> DeviceMesh:
    """The (1, 1) ``("data", "model")`` CPU mesh.  Without a process group
    it starts a one-rank gloo group of its own, so it works standalone."""
    if not dist.is_initialized():
        store = dist.HashStore()
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), "cpu")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: 256 or 512 cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, "cuda")
