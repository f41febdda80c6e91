from .base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeSpec,
    all_configs,
    cell_applicable,
    get_config,
    reduced,
    register,
)

# side-effect registration of every architecture
from . import yi_9b  # noqa: F401
from . import olmo_1b  # noqa: F401
from . import starcoder2_3b  # noqa: F401
from . import deepseek_67b  # noqa: F401
from . import mamba2_1_3b  # noqa: F401
from . import zamba2_1_2b  # noqa: F401
from . import granite_moe_1b_a400m  # noqa: F401
from . import kimi_k2_1t_a32b  # noqa: F401
from . import seamless_m4t_large_v2  # noqa: F401
from . import llama_3_2_vision_90b  # noqa: F401

#: the architectures the JAX package registers too (the tests hold each to
#: its counterpart there)
ARCHS = sorted(all_configs())

# architectures of the port alone
from . import zamba2_7b  # noqa: E402,F401
from . import granite_4_0_h_small  # noqa: E402,F401

#: every registered architecture
PORT_ARCHS = sorted(all_configs())
