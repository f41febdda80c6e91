"""Zamba2-1.2B — Mamba2 backbone + shared attention block (mirrors
``src/repro/configs/zamba2_1_2b.py``).

[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=32000, ssm_state=64.

The hybrid pattern: a single *shared* transformer block (attention +
MLP, one set of weights) is applied every ``attn_every`` Mamba2 blocks —
Zamba's parameter-sharing trick.  38 = 6 supercells of (shared-attn +
6 mamba) + 2 trailing mamba blocks, so a prefill runs the shared block 6
times (the notes below, copied from the reference, say 7).  On the card
its attention runs the CUDA kernel of :mod:`repro_torch.kernels.flash_attention`.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    attn_every=6,
    norm="rmsnorm",
    rope_theta=1e4,
    ssm_mm_dtype="compute",
    source="arXiv:2411.15242",
    notes="shared attention block (single weight set, applied 7x); "
          "long_500k runs (SSM state + windowed KV for the shared attn)",
))
