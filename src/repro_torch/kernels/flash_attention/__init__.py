from .ops import (  # noqa: F401
    HEAD_DIMS,
    KEY_TILE,
    FlashAttentionKernel,
    build_kernel,
    check_contract,
    flash_attention,
    launch_counts,
    reset_launch_counts,
)
from . import ref  # noqa: F401
