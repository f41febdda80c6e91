from .lm import (  # noqa: F401
    EncDecModel,
    HybridModel,
    Model,
    SSMModel,
    VLMModel,
    build_model,
    chunked_ce_loss,
)
from .mamba2 import Mamba2, SSMConfig  # noqa: F401
