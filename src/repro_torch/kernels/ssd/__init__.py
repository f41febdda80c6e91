from .ops import (  # noqa: F401
    SSDKernel,
    build_kernel,
    launch_counts,
    reset_launch_counts,
    ssd,
)
from . import ref  # noqa: F401
