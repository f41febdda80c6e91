from .lm import HybridModel, Model, SSMModel, build_model, chunked_ce_loss  # noqa: F401
from .mamba2 import Mamba2, SSMConfig  # noqa: F401
