"""Yi-9B — llama-architecture dense GQA (mirrors
``src/repro/configs/yi_9b.py``).  [arXiv:2403.04652; hf]

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1e4,
    source="arXiv:2403.04652",
))
