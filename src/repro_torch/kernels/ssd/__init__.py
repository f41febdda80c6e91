from .ops import (  # noqa: F401
    BWD_KERNELS_PER_CALL,
    INSTANCES,
    KERNELS_PER_CALL,
    TENSOR_CORE_STATES,
    SSDBwdKernel,
    SSDFunction,
    SSDKernel,
    build_kernel,
    instance_counts,
    launch_counts,
    reset_launch_counts,
    select_instance,
    ssd,
)
from . import ref  # noqa: F401
