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
    MARCH,
    MODES,
    FetchPlan,
    StencilKernel,
    cta_outputs,
    cuda_source,
    hbm_bytes_per_block,
    make_plan,
    march,
    shuffle_schedule,
)
