"""Optimizer: AdamW and learning-rate schedules — port of ``repro.optim``."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup_cosine"]
