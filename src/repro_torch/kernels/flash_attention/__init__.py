from .ops import (  # noqa: F401
    HEAD_DIMS,
    INSTANCES,
    TENSOR_CORE_HEAD_DIMS,
    TENSOR_CORE_KEY_TILE,
    KEY_TILE,
    FlashAttentionKernel,
    build_kernel,
    check_contract,
    flash_attention,
    instance_counts,
    launch_counts,
    reset_launch_counts,
    select_instance,
)
from . import ref  # noqa: F401
