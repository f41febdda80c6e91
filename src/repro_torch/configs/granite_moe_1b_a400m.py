"""IBM Granite 3.0 1B-a400m base — 32-expert top-8 MoE (mirrors
``src/repro/configs/granite_moe_1b_a400m.py``).

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf tier]  24L d_model=1024
16H (GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 32e top-8.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    moe_top_k=8,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1e4,
    moe_schedule="auto",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="vocab 49155 is not lane-aligned (padded to multiples of the "
          "tensor axis by the sharding layer).",
))
