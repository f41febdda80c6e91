from .lm import HybridModel, SSMModel, build_model  # noqa: F401
from .mamba2 import Mamba2, SSMConfig  # noqa: F401
