"""Optimizers and learning-rate schedules on tensor trees: the port of
`repro/optim/`."""
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import constant_lr, warmup_cosine

__all__ = ["adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
           "clip_by_global_norm", "global_norm", "constant_lr", "warmup_cosine"]
