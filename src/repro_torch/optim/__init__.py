"""Optimizers and learning-rate schedules (counterpart of
``repro.optim``; ``compression`` comes with the sharding pieces)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_warmup"]
