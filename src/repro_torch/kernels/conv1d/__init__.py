from .conv1d import (  # noqa: F401
    MODES,
    Conv1dKernel,
    conv_program,
    cuda_source,
    hbm_bytes,
    kernel_source,
    make_spec,
)
from .ops import (  # noqa: F401
    build_kernels,
    causal_conv1d,
    launch_counts,
    reset_launch_counts,
)
from . import ref  # noqa: F401
