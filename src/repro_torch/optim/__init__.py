"""Optimizers and schedules of the port (counterpart of ``repro.optim``)."""
from .optimizer import (adafactor_init, adamw_init, clip_by_global_norm,
                        global_norm, make_optimizer, sgdm_init)
from .schedule import cosine_warmup

__all__ = ["adafactor_init", "adamw_init", "clip_by_global_norm",
           "cosine_warmup", "global_norm", "make_optimizer", "sgdm_init"]
