"""DeepSeek-67B — llama-architecture dense (mirrors
``src/repro/configs/deepseek_67b.py``).  [arXiv:2401.02954; hf]

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1e4,
    source="arXiv:2401.02954",
))
