"""Feed-forward blocks: SwiGLU (llama family) and GELU (starcoder2)
(mirrors ``src/repro/models/mlp.py``).  The products are
``torch.matmul``, as the reference leaves its einsums to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Params, dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", dtype: torch.dtype = torch.float32) -> Params:
    p = {"w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
         "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype)}
    if kind == "swiglu":
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype=dtype)
    return p


def apply_mlp(params: Params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    up = torch.matmul(x, params["w_up"])
    if kind == "swiglu":
        h = F.silu(torch.matmul(x, params["w_gate"])) * up
    elif kind == "gelu":
        h = F.gelu(up, approximate="tanh")        # jax.nn.gelu's default
    else:
        raise ValueError(kind)
    return torch.matmul(h, params["w_down"])
