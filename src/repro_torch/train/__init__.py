from .optim import OptConfig, OptState, adamw_update, init_opt_state  # noqa: F401
from .step import make_train_step  # noqa: F401
