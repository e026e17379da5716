"""Optimizers, schedules and PSO as an optimizer (the port of
``repro.optim``)."""
from .optimizers import (OptState, adafactor_init, adafactor_update,
                         adam_init, adam_update, get_optimizer, sgd_init,
                         sgd_update)
from .schedules import cosine_schedule, linear_warmup
from .pso_optimizer import PSOOptimizer

__all__ = ["OptState", "adam_init", "adam_update", "adafactor_init",
           "adafactor_update", "sgd_init", "sgd_update", "get_optimizer",
           "cosine_schedule", "linear_warmup", "PSOOptimizer"]
