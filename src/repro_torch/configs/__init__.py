from .base import (  # noqa: F401
    ModelConfig,
    all_configs,
    get_config,
    reduced,
    register,
)

# side-effect registration of every architecture whose path is ported
from . import yi_9b  # noqa: F401
from . import olmo_1b  # noqa: F401
from . import starcoder2_3b  # noqa: F401
from . import deepseek_67b  # noqa: F401
from . import mamba2_1_3b  # noqa: F401
from . import zamba2_1_2b  # noqa: F401

ARCHS = sorted(all_configs())
