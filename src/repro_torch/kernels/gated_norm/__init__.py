from .ops import (  # noqa: F401
    GatedNormKernel,
    build_kernel,
    check_operands,
    gated_norm_tail,
    launch_counts,
    reset_launch_counts,
)
from . import ref  # noqa: F401
