"""Kimi K2 — trillion-parameter MoE (paper-table config) (mirrors
``src/repro/configs/kimi_k2_1t_a32b.py``).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8)
d_ff=2048 (per expert) vocab=163840, MoE 384 experts top-8.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    moe_top_k=8,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=5e4,
    moe_schedule="auto",
    source="arXiv:2501.kimi2 (paper-table); unverified tier",
    notes="trillion-param MoE; active ~32B/token. d_ff is per-expert. "
          "EP requires n_experts % ep_axis == 0 (384 % 16 == 0).",
))
