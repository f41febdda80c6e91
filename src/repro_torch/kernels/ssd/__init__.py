from .ops import (  # noqa: F401
    INSTANCES,
    KERNELS_PER_CALL,
    TENSOR_CORE_STATES,
    SSDKernel,
    build_kernel,
    instance_counts,
    launch_counts,
    reset_launch_counts,
    select_instance,
    ssd,
)
from . import ref  # noqa: F401
