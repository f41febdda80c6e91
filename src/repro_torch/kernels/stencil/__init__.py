from .ops import (  # noqa: F401
    build_kernels,
    launch_counts,
    reference,
    reset_launch_counts,
    stencil_apply,
    traffic_report,
)
from .stencil import (  # noqa: F401
    CTA_BLOCKS,
    MODES,
    FetchPlan,
    StencilKernel,
    cuda_source,
    hbm_bytes_per_block,
    make_plan,
    shuffle_schedule,
)
