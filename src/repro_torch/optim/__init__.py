"""Optimizers and schedules over dicts of tensors, as in ``repro.optim``."""
from .opt import (  # noqa: F401
    AdamWState,
    OptConfig,
    SGDState,
    adamw_init,
    adamw_update,
    apply_max_norm,
    clip_by_global_norm,
    global_norm,
    lr_at,
    momentum_at,
    sgd_init,
    sgd_update,
)
