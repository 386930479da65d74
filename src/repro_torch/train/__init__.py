"""Training: DFXP train step, state, supervised loop, fault injection."""
from .faults import (CkptTear, FaultHarness, GradNaN, Kill,  # noqa: F401
                     LossSpike, ParamBitFlip, chaos_plan)
from .resilience import StepOutcome, TrainSupervisor  # noqa: F401
from .state import TrainState, init_train_state, param_group_shapes  # noqa: F401
from .step import benign_injection, make_train_step, quantize_param  # noqa: F401
