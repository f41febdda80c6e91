"""Llama-3.2-Vision-90B — cross-attention image layers (mirrors
``src/repro/configs/llama_3_2_vision_90b.py``).

[hf:meta-llama/Llama-3.2-11B-Vision (family); unverified]
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

The 100 layers are 80 self-attention + 20 cross-attention (every 5th
layer cross-attends to vision tokens), following the released
11B/90B-Vision layout.  The vision frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed patch embeddings
(B, n_media_tokens, d_model).
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_every=5,             # 20 cross-attn layers of 100
    n_media_tokens=1601,       # one image tile (stubbed embeddings)
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-*-Vision",
    notes="vision frontend stubbed: media tokens arrive as embeddings",
))
