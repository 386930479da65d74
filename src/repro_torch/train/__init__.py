"""Training: the DFXP train step, its state, and scale calibration."""
from .state import TrainState, init_train_state, param_group_shapes  # noqa: F401
from .step import make_train_step, quantize_param  # noqa: F401
