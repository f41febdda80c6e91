from .ops import (  # noqa: F401
    AdamWKernel,
    build_kernel,
    check_operands,
    launch_counts,
    reset_launch_counts,
    work_table,
)
from . import ref  # noqa: F401
