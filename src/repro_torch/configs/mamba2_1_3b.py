"""Mamba2-1.3B — SSD (state-space duality), attention-free (mirrors
``src/repro/configs/mamba2_1_3b.py``).

[arXiv:2405.21060]  48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128;
d_inner = 2*d_model = 4096, head_dim 64 -> 64 heads.

The width-4 depthwise causal conv1d is a sequence stencil: on the card it
runs as the CUDA kernel of :mod:`repro_torch.kernels.conv1d`, whose shuffle
deltas come from the emulator's detection.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    norm="rmsnorm",
    rope_theta=0.0,
    ssm_mm_dtype="compute",
    source="arXiv:2405.21060",
    notes="attention-free; O(1) decode state",
))
